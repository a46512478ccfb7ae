"""Training and validation steps on static inputs, replayed as CUDA graphs.

Counterpart of the JAX trainer's compiled steps and of its
`steps_per_dispatch` scan (weasal_tpu/train/trainer.py:370-404): there
one jitted program runs K steps per dispatch; here one replay of a
captured CUDA graph does. For each bucket's plan and K:

- `StepGraph` owns static input tensors [K, ...] (the host pack is copied
  into them by `data/loader.copy_batch`), the resident tensors, and
  static outputs [K, ...] that each step writes (`train/step.step_body`);
- on its first pack it warms up one step on a side stream on the pack's
  first batch (kernel libraries, shared-memory attributes, cuBLAS
  workspaces), restores the parameters, the momentum and the BatchNorm
  statistics from a snapshot with `copy_`, so that the warm-up leaves no
  trace, and captures the K steps with `torch.cuda.graph`; every pack
  after that is one replay;
- `EvalGraph` does the same for one validation batch (`infer.eval_body`),
  with no state to restore.

Capture failures raise with the reason; nothing falls back to eager
steps. Without `graphed` (the CPU, or `ModelTrainer(graphs=False)`) the
same bodies run eagerly on the same static tensors, which is the
reference the graphs are held to.

The kernel wrappers count their launches in Python, which a replay does
not run: each graph records the counts its capture added, takes them out
again (the capture launched nothing), and adds them at each replay. The
warm-up's launches ran on the card and stay counted (`warmup_steps`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from weasal_tpu_torch.data.loader import copy_batch
from weasal_tpu_torch.ops.cuda.inverse_lists import (build_inverse_lists,
                                                     inverse_sum)
from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd
from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd
from weasal_tpu_torch.ops.cuda.maxpool_bwd import maxpool_bwd
from weasal_tpu_torch.ops.cuda.radius_search import radius_search

# The kernel wrappers whose `launches` a replay adds to
COUNTED = (radius_search, kpconv_fwd, kpconv_bwd, maxpool_bwd,
           build_inverse_lists, inverse_sum)


def launch_counts() -> Dict[str, int]:
    """The wrappers' launch counters, by name."""
    return {fn.__name__: fn.launches for fn in COUNTED}


def _set_counts(counts: Mapping[str, int]) -> None:
    for fn in COUNTED:
        fn.launches = counts[fn.__name__]


class _Graphed:
    """Static inputs [K, ...] on `device`, K slot views merged with the
    resident tensors, and the capture / replay machinery."""

    def __init__(self, name: str, example: Mapping[str, torch.Tensor],
                 steps: int, device, extra: Optional[Mapping] = None,
                 graphed: bool = False):
        self.name = name
        self.steps = steps
        self.device = torch.device(device)
        self.graphed = graphed
        self.inputs = {k: torch.empty((steps, *v.shape[1:]), dtype=v.dtype,
                                      device=self.device)
                       for k, v in example.items()}
        self.extra = dict(extra or {})
        self.slots: List[Dict[str, torch.Tensor]] = [
            {**{k: v[i] for k, v in self.inputs.items()}, **self.extra}
            for i in range(steps)]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.per_replay: Dict[str, int] = {}
        self.runs = 0       # eager or replayed
        self.replays = 0
        self.warmup_steps = 0

    def load(self, host: Mapping[str, torch.Tensor],
             index: Optional[int] = None) -> None:
        """Copy a host pack [K, ...] (or, with `index`, its step `index`
        into a one-step graph's inputs) into the static inputs."""
        if index is not None:
            host = {k: v[index:index + 1] for k, v in host.items()}
        copy_batch(self.inputs, host)

    def _run_all(self) -> None:
        raise NotImplementedError

    def _before_warm_up(self) -> None:
        """On the current stream, before the warm-up."""

    def _warm_up(self) -> None:
        raise NotImplementedError

    def _after_warm_up(self) -> None:
        """On the current stream, after the warm-up."""

    def run(self) -> None:
        """Run the loaded steps: eagerly, or as one replay (capturing the
        graph first, on its first call)."""
        self.runs += 1
        if not self.graphed:
            self._run_all()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        self.replays += 1
        counts = launch_counts()
        _set_counts({k: counts[k] + self.per_replay.get(k, 0)
                     for k in counts})

    def _capture(self) -> None:
        self._before_warm_up()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._warm_up()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._after_warm_up()
        self.warmup_steps += 1
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            # thread_local: the producer thread pins host memory while
            # this thread captures, which a global check would refuse
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._run_all()
        except Exception as exc:
            _set_counts(before)
            raise RuntimeError(
                f"capturing the {self.name} graph failed (no eager "
                f"fallback): {exc}") from exc
        after = launch_counts()
        self.per_replay = {k: after[k] - before[k] for k in after}
        _set_counts(before)
        self.graph = graph


class StepGraph(_Graphed):
    """K training steps on static inputs.

    :param name: printed in errors ("large", "small", with K)
    :param body: `body(inputs, out)` runs one step on a slot's inputs
        (the static tensors of one step merged with the resident ones)
        and writes its rows of `out` (`train/step.step_body` with the
        trainer's model, momentum, learning-rate tensor and plan)
    :param example: a host pack [K, ...] giving the input shapes
    :param outputs: `step_outputs(plan, device, steps=K)`
    :param state: the tensors a step changes (parameters, momentum,
        BatchNorm statistics), restored after the warm-up
    """

    def __init__(self, name: str, body: Callable, example: Mapping,
                 steps: int, device, outputs: Dict[str, torch.Tensor],
                 state: Callable[[], Sequence[torch.Tensor]],
                 extra: Optional[Mapping] = None, graphed: bool = False):
        super().__init__(name, example, steps, device, extra, graphed)
        self.body = body
        self.out = outputs
        self.out_slots = [{k: v[i] for k, v in outputs.items()}
                          for i in range(steps)]
        self.state = state
        self._snapshot: List[torch.Tensor] = []

    def _run_all(self) -> None:
        for slot, out in zip(self.slots, self.out_slots):
            self.body(slot, out)

    def _before_warm_up(self) -> None:
        with torch.no_grad():
            self._snapshot = [t.detach().clone() for t in self.state()]

    def _warm_up(self) -> None:
        self.body(self.slots[0], self.out_slots[0])

    def _after_warm_up(self) -> None:
        with torch.no_grad():
            for t, saved in zip(self.state(), self._snapshot):
                t.copy_(saved)
        self._snapshot = []


class EvalGraph(_Graphed):
    """One validation batch on static inputs; `out` holds its "probs"
    and "labels" after `run` (allocated at the warm-up, from its output
    shapes).

    :param body: `body(inputs, out)` -> out (`infer.eval_body`; with
        `out` None it returns new tensors)
    """

    def __init__(self, name: str, body: Callable, example: Mapping,
                 device, extra: Optional[Mapping] = None,
                 graphed: bool = False):
        super().__init__(name, example, 1, device, extra, graphed)
        self.body = body
        self.out: Optional[Dict[str, torch.Tensor]] = None
        self._first: Dict[str, torch.Tensor] = {}

    def _run_all(self) -> None:
        if self.out is None:
            self.out = self.body(self.slots[0], None)
        else:
            self.body(self.slots[0], self.out)

    def _warm_up(self) -> None:
        self._first = self.body(self.slots[0], None)

    def _after_warm_up(self) -> None:
        self.out = {k: torch.empty_like(v) for k, v in self._first.items()}
        self._first = {}
