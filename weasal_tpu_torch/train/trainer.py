"""Training loop of both stages: sampling, steps, logs, checkpoints and
per-epoch validation.

Counterpart of `ModelTrainer` in weasal_tpu/train/trainer.py on its fused
path (the pyramid built on the device), one device, in weak mode
(`KPFCNN_mprm`) or pseudo mode (`KPFCNN`, by `config.model_name`):
`__init__` (:121-233), `save_checkpoint` and `load_checkpoint`
(:535-577), `train` (:582-957), `_resolve_steps_per_dispatch`
(:980-998), `_flush_log` (:1000-1024) and `cloud_segmentation_validation`
(:1031-1171). The artifacts are the JAX package's: `parameters.txt`,
`training_iteration{al}.txt` rows `epoch step out_loss offset_loss
train_accuracy time`, `val_IoUs.txt`, `plan_saturation.txt`, the
potentials plys, `conf.txt` every `checkpoint_gap` epochs, the
`running_PID.txt` kill file and `checkpoints/current_chkp.tar` with
`chkp_XXXX_{al}.tar`, here written by `torch.save`; a restore reads the
port's, the JAX package's and the reference's checkpoints
(utils/checkpoint.py).

The input is chosen as the JAX trainer chooses it (:611-633): with
`config.device_pyramid` (the port's default) the resident one
(data/resident.py) when `config.resident_clouds` resolves on ("auto": on
a CUDA device), else level-0 arrays (data/level0.py); without it the
host pyramid (data/loader.HostPyramidSource: `dataset.next_batch`, or a
`ParallelSphereBuilder` when `config.input_threads` > 1). Either way a
producer thread samples ahead of the steps and packs
`steps_per_dispatch` (K) batches at a time (data/loader.py); the host
pyramid runs one step a pack (K > 1 prints the JAX trainer's message and
runs 1, :994-997). On a CUDA device with the resident input or the host
pyramid each pack is one replay of a captured CUDA graph of K steps
(train/graphs.py), one graph per size bucket of the plan (`plan.small`,
resident input only) and one for validation batches; a short tail pack
replays the bucket's one-step graph once per real step. Elsewhere, and
with `graphs=False`, the same step bodies run eagerly. Nothing in the
loop waits for the card per step: each step's loss, accuracy and offset
loss (the deformable convs' regularizer, 0 for a rigid network) go to a
device ring buffer that `_flush_log` fetches every 20 steps or 2 s, the
skip of batches without regions reads host metas, and validation keeps
its argmax and labels on the device and fetches them once (off the
resident input it smooths its votes on the host, batch by batch,
:1117-1131). The port's kernels drop no neighbor, so the drop vector of
each step is zero; each epoch sums it and a non-zero sum raises, where
the JAX package would widen its band windows.

The loop times itself with the span table of utils/profiling:
`loop.wait_batch` (each wait for the producer's next item),
`loop.dispatch` (a pack's steps dispatched; `loop.load`, its input copies,
inside), `loop.flush` (inside `_flush_log`), `epoch_start` (a new
producer through its first batch) and `epoch_end` (after the epoch's
final flush: `epoch_end.drops`, `.audit`, `.checkpoint`,
`.validation`; the audit counts its searches by path,
`audit.search_native` and `audit.search_fallback`). Each `epoch_times`
entry holds that epoch's table under `spans`, its end included, and its
`loop.*` seconds as `wait_batch`, `dispatch` and `flush`; `loop.other`
is the epoch's time in none of them. `train` marks "train" in the table
as it starts.

In pseudo mode the gradients are clipped by value, no batch is skipped,
the log header counts the ground-truth ledger's points, and each step
takes a seed for its dropout mask and contrast draw from a host stream
of its own per active-learning iteration (the counterpart of the JAX
trainer's `PRNGKey(al_iteration)`, :586), shipped in the pack as
`step_seed`; from the epoch `contrast_start` on the steps add the
contrast loss, a graph of its own per bucket (JAX compiles
`use_contrast` as a static argument).

Data parallel (:131-141, 193-206, 635-660, 1079-1085), in a process of a
group that parallel/ddp.spawn started (the entry points' `--devices`):
`batch_num` is rounded up to a multiple of the world size W before the
example draw, every rank runs the same seeded sampler over the global
batch (the potentials, the plan bucket, the skips, the saturation audit
and the ledgers stay equal on every rank) and ships only its own
spheres to its card (`ddp.ShardedSource`; on the host pyramid it builds
only their pyramids); the resident clouds are replicated; the step's
sums and its gradients are the global batch's (train/step.py); the
validation gathers each rank's outputs in sphere order, so every rank
holds the same votes. Rank 0 alone writes files (parameters.txt, the
logs, checkpoints, potentials, confusions); the kill file is read by rank
0 at the end of each epoch and its decision broadcast. Under NCCL the
collectives sit inside the captured step graphs; gloo collectives cannot
be captured, so a gloo group on a card runs the steps eagerly.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from os.path import exists, join
from typing import Dict, List, Optional

import numpy as np
import torch

from weasal_tpu_torch.data.level0 import Level0BatchSource
from weasal_tpu_torch.data.loader import BatchPrefetcher, HostPyramidSource
from weasal_tpu_torch.data.resident import ResidentBatchSource, feature_spec
from weasal_tpu_torch.infer import eval_body
from weasal_tpu_torch.models.architectures import model_for_config
from weasal_tpu_torch.parallel import ddp
from weasal_tpu_torch.train.graphs import WORK_COUNTERS, EvalGraph, StepGraph
from weasal_tpu_torch.train.optim import init_opt_state
from weasal_tpu_torch.train.step import (class_weights, label_table,
                                         step_body, step_outputs)
from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
from weasal_tpu_torch.utils.checkpoint import load_checkpoint_file
from weasal_tpu_torch.utils.device import configure_precision, resolve_device
from weasal_tpu_torch.utils.metrics import IoU_from_confusions, fast_confusion
from weasal_tpu_torch.utils.ply import write_ply
from weasal_tpu_torch.utils.profiling import (add, close_range,
                                              device_trace, mark,
                                              open_range, span, span_totals)
from weasal_tpu_torch.utils.watchdog import StallWatchdog

# Steps per dispatch that "auto" picks: chip_smoke.py phase 7 found one
# graphed step a replay faster than ten (25.1-25.4 against 26.5-27.1 ms
# a step in 40-batch epochs, NVIDIA H100 80GB HBM3, 700 W): a replay's
# host cost grows with its kernels, and a pack of K waits for K sampled
# batches (PERF.md)
AUTO_STEPS_PER_DISPATCH = 1
# The log is fetched every FLUSH_STEPS steps (or 2 s)
FLUSH_STEPS = 20
# The WEASAL_TRACE_DIR profiler window: steps of epoch 0
TRACE_START, TRACE_STEPS = 20, 60
# Entropy of the pseudo-label steps' seed stream, beside the AL iteration
SEED_STREAM = 0x5EED
# The keys of an epoch_times entry that are the totals of its loop.* spans
LOOP_KEYS = ("wait_batch", "dispatch", "flush")
# The epoch end's parts, each an epoch_end.* span
EPOCH_END_PARTS = ("drops", "audit", "checkpoint", "validation")


def resolve_resident(value, device: torch.device) -> bool:
    """`config.resident_clouds`: True/False, or "auto" = on for CUDA."""
    if value == "auto":
        return device.type == "cuda"
    if isinstance(value, bool):
        return value
    raise ValueError(f"resident_clouds must be 'auto' or a bool, not "
                     f"{value!r}")


def loop_stats_line(record: Dict) -> str:
    """The `[loop-stats]` line of an epoch_times entry: the epoch's wall
    a step, its loop.* spans, the epoch's start and end with the end's
    parts and the audit's searches by path, the batch producer's spans,
    and where the network has deformable convs their chains' work
    counters a step (`deform.*`; the validation's forwards among the
    fwd ones)."""
    spans = record["spans"]

    def sec(name):
        return spans.get(name, {}).get("seconds", 0.0)

    def count(name):
        return spans.get(name, {}).get("count", 0)
    epoch_s, n = record["seconds"], max(record["steps"], 1)
    loop = " ".join(f"{k}={record[k]:.2f}s" for k in LOOP_KEYS)
    end = " ".join(f"{p}={sec('epoch_end.' + p):.3f}s"
                   for p in EPOCH_END_PARTS)
    searches = " ".join(f"{p}={count('audit.search_' + p)}"
                        for p in ("native", "fallback"))
    producer = " ".join(f"{p}={sec('batch.' + p):.2f}s"
                        for p in ("sample", "pin", "put_wait"))
    work = " ".join(f"{k[len(WORK_COUNTERS):]}={count(k) / n:.12g}"
                    for k in sorted(spans) if k.startswith(WORK_COUNTERS))
    return (f"[loop-stats] epoch {record['epoch']}: {epoch_s:.2f}s / {n} "
            f"steps = {1e3 * epoch_s / n:.1f} ms/step | {loop} "
            f"other={sec('loop.other'):.2f}s | "
            f"epoch_start={sec('epoch_start'):.3f}s "
            f"epoch_end={sec('epoch_end'):.3f}s ({end}; audit searches "
            f"{searches}) | batches: {producer} "
            f"skipped={count('batch.skipped')}"
            + (f" | {WORK_COUNTERS}* a step: {work}" if work else ""))


def _has_regions(metas) -> bool:
    """No sub-region labels -> no loss signal: such a batch is skipped
    (reference trainer_WeakLabel.py:183-184), from host metas."""
    return any(m["has_regions"] for m in metas)


class ModelTrainer:
    """Drives the training of one active-learning iteration.

    :param dataset: the training dataset (labels and shape plan)
    :param chkp_path: checkpoint to restore (None = fresh)
    :param finetune: restore the weights only (not the epoch or momentum)
    :param device: default ``cuda``; raises where CUDA is absent
    :param generator: the torch.Generator of the initial weights (default
        seed 0)
    :param graphs: on a CUDA device with the resident input or the host
        pyramid, replay captured CUDA graphs (None, the default, or True);
        False runs the same steps eagerly (the reference the graphs are
        held to). Under a gloo group on a card (whose collectives cannot
        be captured) None runs eagerly, and True or an int
        `steps_per_dispatch` raises
    :param stage_dir: the results subdirectory of a new log (WeakLabel |
        PseudoLabel)
    """

    def __init__(self, config, dataset, chkp_path: Optional[str] = None,
                 finetune: bool = False, device=None,
                 generator: Optional[torch.Generator] = None,
                 graphs: Optional[bool] = None,
                 stage_dir: str = "WeakLabel"):
        self.device = resolve_device(device)
        configure_precision()
        self.config = config
        # Data parallel: the world size, batch_num a multiple of it, before
        # the plan and the example draw (trainer.py:131-141)
        self.world = ddp.round_batch_num(config)
        self.writer = ddp.is_writer()
        self.epoch = 0
        self.step = 0
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.model = model_for_config(
            config, dataset.label_values, dataset.ignored_labels,
            generator=generator).to(self.device)
        # The model owns the stage: 'weak' or 'pseudo'
        self.mode = self.model.mode
        self.opt_state = init_opt_state(self.model)
        self.table = label_table(self.model, self.device)
        self.class_w = class_weights(config, self.device)
        t0 = time.perf_counter()
        with ddp.rank0_first():     # rank 0 writes the plan cache
            self.plan = dataset.calibration()
        self.calibration_seconds = time.perf_counter() - t0
        self.device_pyramid = bool(getattr(config, "device_pyramid", True))
        self.resident = self.device_pyramid and resolve_resident(
            getattr(config, "resident_clouds", "auto"), self.device)
        self.spec = feature_spec(dataset.name, config.in_features_dim)
        self.graphed = graphs is not False and self.device.type == "cuda" \
            and (self.resident or not self.device_pyramid)
        ctx = ddp.current()
        if self.graphed and ctx is not None and ctx.backend == "gloo":
            if graphs or not isinstance(getattr(
                    config, "steps_per_dispatch", "auto"), str):
                raise ValueError(
                    "gloo collectives cannot be captured in a CUDA graph: "
                    "run graphed steps under NCCL, or leave graphs and "
                    "steps_per_dispatch to 'auto' for eager steps")
            print("Data parallel over gloo: the steps run eagerly (gloo "
                  "collectives cannot be captured in a CUDA graph)")
            self.graphed = False
        # The small-sphere bucket trains at its own plan (resident input
        # only, as in the JAX trainer); validation stays on the full plan
        self.plan_small = self.plan.derive_small() if self.resident else None
        if self.plan_small is not None:
            print("Shape-plan small bucket: level-0 cut "
                  f"{self.plan.small['cut']} pts, budgets "
                  f"{self.plan_small.num_points} vs {self.plan.num_points}")

        # The JAX trainer initializes its model on one example batch
        # (trainer.py:175-176), which moves the potentials by batch_num
        # spheres: make the same draws, so that every later sphere is the
        # same in both packages
        rng = np.random.default_rng(0)
        for _ in range(config.batch_num):
            dataset.sample_sphere(rng, augment=True,
                                  max_points=self.plan.num_points[0])
        self.lr = config.learning_rate
        # The learning rate every step reads (a captured graph holds its
        # address; `lr_t.fill_` sets each epoch's decayed value)
        self.lr_t = torch.full((), float(self.lr), dtype=torch.float32,
                               device=self.device)

        if chkp_path is not None:
            self.load_checkpoint(chkp_path, finetune=finetune)
        # every rank starts from rank 0's state (mesh.replicate)
        ddp.broadcast_tensors(self._state_tensors())
        if self.world > 1:
            print(f"Data-parallel over {self.world} devices "
                  f"({config.batch_num} spheres/step, "
                  f"{config.batch_num // self.world} per device)")

        if config.saving:
            if config.saving_path is None and self.writer:
                config.saving_path = time.strftime(
                    f"results/{stage_dir}/Log_%Y-%m-%d_%H-%M-%S",
                    time.gmtime())
            config.saving_path = ddp.broadcast_object(config.saving_path)
            if self.writer:
                os.makedirs(config.saving_path, exist_ok=True)
                config.save()
        # Per epoch: host-clock seconds (ending in the last flush's
        # synchronization), real steps and their real level-0 points,
        # steps by bucket, the host clock at each dispatch, the neighbor
        # drops; per validation:
        # seconds and batches. For callers that report the loop's speed.
        self.epoch_times: List[Dict] = []
        self.epoch_drops: List[float] = []
        self.val_times: List[Dict] = []
        # Captured or eager step runners by (bucket, K), the validation
        # runner, and the training source they are bound to
        self._step_graphs: Dict = {}
        self._eval_graph: Optional[EvalGraph] = None
        self._train_source = None
        self._val_source = None

    # ------------------------------------------------------------------
    # Checkpoints
    # ------------------------------------------------------------------

    def save_checkpoint(self, directory: str, name: str = "current_chkp.tar"):
        """torch.save of the epoch, the model's state (parameters,
        BatchNorm statistics, kernel points), the momentum buffers and
        the saving path; written to a temporary file and renamed, so a
        crash never leaves a torn checkpoint."""
        os.makedirs(directory, exist_ok=True)
        payload = {
            "epoch": self.epoch,
            "model_state_dict": self.model.state_dict(),
            "optimizer_state_dict": self.opt_state,
            "saving_path": self.config.saving_path,
        }
        target = join(directory, name)
        tmp = target + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, target)

    def load_checkpoint(self, path: str, finetune: bool = False):
        """Restore a checkpoint of any format `load_checkpoint_file`
        reads (the port's, the JAX package's `.tar`, the reference's), in
        place: parameters, statistics and momentum keep their tensors,
        which captured graphs address. A missing or extra key raises. A
        payload without optimizer state (a reference file) restarts
        momentum at zero, as the JAX trainer does (:566-571)."""
        payload = load_checkpoint_file(path)
        self.model.load_state_dict(payload["model_state_dict"])
        if not finetune:
            opt = payload.get("optimizer_state_dict")
            with torch.no_grad():
                if opt is None:
                    print("Checkpoint has no optimizer state (reference "
                          "torch file): momentum restarts from zero.")
                    for v in self.opt_state.values():
                        v.zero_()
                else:
                    if set(opt) != set(self.opt_state):
                        raise ValueError("checkpoint optimizer state does "
                                         "not match the model's "
                                         "parameters")
                    for k, v in opt.items():
                        self.opt_state[k].copy_(v)
            self.epoch = int(payload["epoch"])
        print("Model restored" + (" for finetuning." if finetune
                                  else " with training state."))

    # ------------------------------------------------------------------
    # Steps
    # ------------------------------------------------------------------

    def _source(self, dataset, bucketed: bool = False, threads: int = 1):
        """(batch source, resident tensors or None) of a dataset; the
        host pyramid builds with `threads` workers."""
        if not self.device_pyramid:
            # builds only this rank's spheres under a group
            return HostPyramidSource(dataset, self.plan, threads), None
        if self.resident:
            source = ResidentBatchSource(dataset, self.plan, self.device,
                                         bucketed=bucketed)
            extra = source.resident.arrays
        else:
            source, extra = Level0BatchSource(dataset, self.plan), None
        if ddp.current() is not None:
            source = ddp.ShardedSource(source)
        return source, extra

    def _resolve_steps_per_dispatch(self) -> int:
        """`config.steps_per_dispatch`: an int, or "auto" =
        AUTO_STEPS_PER_DISPATCH; 1 on the host pyramid."""
        val = getattr(self.config, "steps_per_dispatch", "auto")
        if isinstance(val, str):
            if val != "auto":
                raise ValueError(f"steps_per_dispatch must be 'auto' or an "
                                 f"int, not {val!r}")
            k = AUTO_STEPS_PER_DISPATCH
        else:
            k = max(int(val), 1)
        if k > 1 and not self.device_pyramid:
            print("steps_per_dispatch > 1 requires the fused device-pyramid "
                  "path; running unpacked")
            return 1
        return k

    def _state_tensors(self):
        return (list(self.model.parameters()) + list(self.model.buffers())
                + list(self.opt_state.values()))

    def _step_graph(self, tag: str, steps: int, pack, extra) -> StepGraph:
        """The runner of `steps` steps of bucket `tag` (with the contrast
        loss when the epoch's steps add it), made on first use (its graph
        is captured at its first run)."""
        contrast = self._use_contrast
        key = (tag, steps, contrast)
        graph = self._step_graphs.get(key)
        if graph is None:
            plan = self.plan_small if tag == "small" else self.plan
            config, spec = self.config, self.spec

            def body(inputs, out):
                step_body(self.model, self.opt_state, inputs, config, plan,
                          self.lr_t, out, self.class_w, self.table,
                          spec=spec, use_contrast=contrast)

            name = f"{tag} training step x{steps}" + (
                " with the contrast loss" if contrast else "")
            graph = StepGraph(name, body, pack,
                              steps, self.device,
                              step_outputs(plan, self.device, steps=steps),
                              self._state_tensors, extra=extra,
                              graphed=self.graphed)
            self._step_graphs[key] = graph
        return graph

    def _dispatch(self, tag: str, K: int, pack, n_real: int, extra):
        """Run a pack's n_real steps: a full pack as one run of the K-step
        runner, a tail of n < K steps as n runs of the one-step runner.
        Each step's (loss, accuracy, offset loss) goes to the log ring,
        its drops to the epoch's sum; returns the ring rows written."""
        if self.mode == "pseudo":
            # one seed a step, in step order: K steps a replay draw what
            # K single steps draw
            pack = dict(pack, step_seed=torch.from_numpy(
                self._seeds.integers(0, 2 ** 32, size=n_real,
                                     dtype=np.int64)))
        if n_real == K:
            graph = self._step_graph(tag, K, pack, extra)
            with span("loop.load"):
                graph.load(pack)
            graph.run()
            return self._to_ring(graph.out, K)
        graph = self._step_graph(tag, 1, pack, extra)
        rows = []
        for i in range(n_real):
            with span("loop.load"):
                graph.load(pack, index=i)
            graph.run()
            rows += self._to_ring(graph.out, 1)
        return rows

    def _to_ring(self, out, n: int):
        pos = self._ring_pos
        self._ring[pos:pos + n].copy_(out["stats"])
        self._drops_sum.add_(out["drops"].sum(dim=0))
        self._ring_pos = pos + n
        return [self._ring[pos + i] for i in range(n)]

    def graph_counts(self) -> Dict:
        """Captures (each with one warm-up step) and replays of the
        training and validation graphs so far; `train_runs_by` gives the
        runs (replays, or eager runs) of each training runner by
        "<bucket> x<K>"."""
        steps = list(self._step_graphs.values())
        evals = [self._eval_graph] if self._eval_graph is not None else []
        return dict(
            train_warmups=sum(g.warmup_steps for g in steps),
            train_replays=sum(g.replays for g in steps),
            train_replayed_steps=sum(g.replays * g.steps for g in steps),
            eval_warmups=sum(g.warmup_steps for g in evals),
            eval_replays=sum(g.replays for g in evals),
            train_runs_by={f"{tag} x{k}" + (" contrast" if c else ""): g.runs
                           for (tag, k, c), g in self._step_graphs.items()})

    def validation_parts(self):
        """(batch source, runner, vote accumulator) of the last validation
        pass: the source's `next_batch` draws validation batches, the
        runner (an EvalGraph) loads and runs one, the accumulator (None
        off the resident input) smooths its probabilities into the
        votes."""
        if self._val_source is None:
            raise RuntimeError("no validation pass has run")
        return self._val_source[0], self._eval_graph, self._val_acc

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def train(self, train_dataset, val_dataset=None, al_iteration: int = 0):
        config = self.config
        self.al_iteration = al_iteration
        rng = np.random.default_rng(42 + al_iteration)
        self._seeds = np.random.default_rng([SEED_STREAM, al_iteration])
        self._use_contrast = False
        # rank 0 alone writes (the files of a run are one set)
        saving = config.saving and self.writer

        if saving:
            log_file = join(config.saving_path,
                            f"training_iteration{al_iteration}.txt")
            with open(log_file, "w") as f:
                f.write(self._log_header(train_dataset, al_iteration))
            pid_file = join(config.saving_path, "running_PID.txt")
            if not exists(pid_file):
                with open(pid_file, "w") as f:
                    f.write("Launched\n")
            chkp_dir = join(config.saving_path, "checkpoints")
            os.makedirs(chkp_dir, exist_ok=True)
        else:
            log_file = pid_file = chkp_dir = None

        # Per-epoch decayed LR, resuming mid-schedule
        lr = config.learning_rate
        for e in range(self.epoch):
            if e in config.lr_decays:
                lr *= config.lr_decays[e]
        self.lr = lr
        self.lr_t.fill_(self.lr)

        if self._train_source is None or \
                self._train_source[0].dataset is not train_dataset:
            self._train_source = self._source(
                train_dataset, bucketed=self.plan_small is not None,
                threads=getattr(config, "input_threads", 1))
            self._step_graphs = {}
        source, extra = self._train_source
        if self.resident:
            source.drop_pending()     # a new source per call, as in JAX
        if self.device.type == "cuda" and self.device_pyramid \
                and not self.resident:
            print("level-0 input on CUDA: running eagerly (graphs replay "
                  "the resident input's steps)")
        K = self._resolve_steps_per_dispatch()
        self._ring = torch.zeros((FLUSH_STEPS + K, 3), device=self.device)
        self._drops_sum = torch.zeros(5 * self.plan.num_layers - 3,
                                      device=self.device)

        # Each epoch's spans (utils/profiling) go into its epoch_times
        # entry; WEASAL_LOOP_STATS=1 prints them an epoch
        loop_stats = bool(os.environ.get("WEASAL_LOOP_STATS"))
        mark("train")
        trace_dir = os.environ.get("WEASAL_TRACE_DIR")
        trace = None
        trace_done = not trace_dir or not self.writer
        self._watchdog = StallWatchdog.from_config(
            config, f"train[{self.mode}]", self.device)

        def keep(metas) -> bool:
            if _has_regions(metas):
                return True
            # A streak of batches without regions is progress too
            self._watchdog.beat()
            return False
        # Only the weak-label stage skips batches (trainer.py:720)
        keep_fn = keep if self.mode == "weak" else None
        try:
            t0 = time.time()
            last_display = time.time()
            pending = []
            while self.epoch < config.max_epoch:
                self.step = 0
                self._ring_pos = 0
                epoch_real_steps = 0
                epoch_points = 0
                buckets: Dict[str, int] = {}
                stamps: List[float] = []
                self._use_contrast = (
                    self.mode == "pseudo" and self.epoch >= getattr(
                        config, "contrast_start", 1 << 30))
                epoch_mark = mark()
                # The epoch's start: a new producer through its first batch
                starting = span("epoch_start").__enter__()
                prefetcher = BatchPrefetcher(source, config.epoch_steps,
                                             self.device, rng=rng, pack=K,
                                             keep_fn=keep_fn)
                epoch_t0 = time.perf_counter()
                batch_iter = iter(prefetcher)
                while True:
                    # The wait's clock points sit right around next():
                    # where the loop gets the GIL back from the producer's
                    # Python moves with the calls around them, and a
                    # span's own calls before its clock left most of the
                    # wait outside it (PERF.md, section 6)
                    waiting = open_range("loop.wait_batch")
                    tw = time.perf_counter()
                    try:
                        pack, metas = next(batch_iter)
                    except StopIteration:
                        break
                    finally:
                        waited = time.perf_counter() - tw
                        close_range(waiting)
                    add("loop.wait_batch", waited)
                    if starting is not None:
                        starting.__exit__(None, None, None)
                        starting = None
                    # under a group the kill file is read at the epoch's
                    # end, where every rank learns rank 0's decision
                    if saving and self.world == 1 and pid_file \
                            and not exists(pid_file):
                        prefetcher.close()
                        break
                    n_real = len(metas)
                    tag = metas[0][0].get("bucket", "large")
                    buckets[tag] = buckets.get(tag, 0) + n_real
                    stamps.append(time.perf_counter())
                    with span("loop.dispatch"):
                        rows = self._dispatch(tag, K, pack, n_real, extra)
                    wall = time.time() - t0
                    for i, row in enumerate(rows):
                        pending.append((self.epoch, self.step + i, row[0],
                                        row[1], wall, row[2]))
                    epoch_real_steps += n_real
                    epoch_points += sum(m["n_real"] for ms in metas
                                        for m in ms)
                    self.step += n_real
                    if len(pending) >= FLUSH_STEPS or \
                            time.time() - last_display > 2.0:
                        last_display = time.time()
                        self._flush_log(pending, log_file, al_iteration)
                        pending = []
                        self._ring_pos = 0
                        self._watchdog.beat()
                        # The profiler window opens and closes right after
                        # a flush, when the card has caught up
                        if not trace_done and trace is None \
                                and self.epoch == 0 \
                                and self.step >= TRACE_START:
                            trace = self._open_trace(trace_dir)
                            trace_t0 = (self.step, time.perf_counter())
                        elif trace is not None and \
                                self.step >= trace_t0[0] + TRACE_STEPS:
                            self._close_trace(trace, trace_t0)
                            trace, trace_done = None, True

                if starting is not None:        # the epoch had no batch
                    starting.__exit__(None, None, None)
                self._flush_log(pending, log_file, al_iteration)
                pending = []
                self._ring_pos = 0
                epoch_s = time.perf_counter() - epoch_t0
                if trace is not None:
                    # The epoch ended inside the window: close it here,
                    # so that it stays a window of epoch 0
                    self._close_trace(trace, trace_t0)
                    trace, trace_done = None, True
                # The epoch's time in none of the loop.* spans (the loop's
                # waits for the GIL behind the producer's Python among it)
                loop_spans = span_totals(since=epoch_mark)
                add("loop.other", epoch_s - sum(
                    loop_spans.get(f"loop.{key}", {}).get("seconds", 0.0)
                    for key in LOOP_KEYS))
                record = dict(epoch=self.epoch, start=epoch_t0,
                              seconds=epoch_s, steps=epoch_real_steps,
                              points=epoch_points, buckets=buckets,
                              dispatch_stamps=stamps)
                self.epoch_times.append(record)
                with span("epoch_end"):
                    killed = self._end_epoch(buckets, saving, pid_file,
                                             chkp_dir, al_iteration,
                                             train_dataset, val_dataset)
                spans = span_totals(since=epoch_mark)
                record.update(spans=spans, **{
                    key: spans.get(f"loop.{key}", {}).get("seconds", 0.0)
                    for key in LOOP_KEYS})
                if loop_stats:
                    print(loop_stats_line(record))
                if killed:
                    break

            if saving and not exists(join(chkp_dir, "current_chkp.tar")):
                # Resumed at or after max_epoch: no epoch ran in this run
                # dir, but later stages restore from it
                self.save_checkpoint(chkp_dir)
            if pid_file and exists(pid_file) and \
                    self.epoch >= config.max_epoch:
                os.remove(pid_file)

            if getattr(self, "_val_acc", None) is not None:
                self.validation_probs = self._val_acc.materialize()
            # the other ranks read rank 0's checkpoint after this call
            ddp.barrier()
        finally:
            # An armed watchdog left behind would end unrelated later work
            self._watchdog.stop()
            if isinstance(source, HostPyramidSource):
                # No idle builder threads outlive the call (the stage
                # makes a trainer an iteration)
                source.close()
            if trace is not None:
                self._close_trace(trace, trace_t0)
        print("Finished Training")

    def _end_epoch(self, buckets, saving, pid_file, chkp_dir, al_iteration,
                   train_dataset, val_dataset) -> bool:
        """The end of an epoch: the kill file, the LR decay, then the
        drops read, the plan audit, the checkpoint and the validation,
        each an epoch_end.* span. Returns True where the kill file stops
        training (nothing after it runs)."""
        config = self.config
        if self.plan_small is not None and buckets:
            print(f"[buckets] epoch {self.epoch} dispatches: "
                  + " ".join(f"{t}={c}" for t, c in sorted(buckets.items())))
        killed = bool(saving and pid_file and not exists(pid_file))
        if self.world > 1:
            # Rank 0 sees the pid file; every rank stops with it
            killed = ddp.broadcast_object(killed)
        if killed:
            return True

        if self.epoch in config.lr_decays:
            self.lr *= config.lr_decays[self.epoch]
            self.lr_t.fill_(self.lr)
        self.epoch += 1

        # The port's kernels drop nothing: a non-zero sum is a fault
        with span("epoch_end.drops"):
            epoch_drops = float(self._drops_sum.sum())
        self._drops_sum.zero_()
        self.epoch_drops.append(epoch_drops)
        if epoch_drops != 0.0:
            raise RuntimeError(
                f"{epoch_drops:g} neighbors dropped in epoch "
                f"{self.epoch - 1}: the exact kernels must drop none")
        with span("epoch_end.audit"):
            self._audit(train_dataset, epoch_drops)

        if saving:
            with span("epoch_end.checkpoint"):
                self.save_checkpoint(chkp_dir)
                if (self.epoch + 1) % config.checkpoint_gap == 0:
                    self.save_checkpoint(
                        chkp_dir,
                        f"chkp_{self.epoch + 1:04d}_{al_iteration}.tar")
        self._watchdog.beat()

        if val_dataset is not None:
            with span("epoch_end.validation"):
                self.cloud_segmentation_validation(val_dataset)
            self._watchdog.beat()

        # The kill file goes once training completes
        if self.epoch >= config.max_epoch and pid_file and \
                exists(pid_file):
            os.remove(pid_file)
        return False

    def _open_trace(self, trace_dir):
        """Open the profiler window (utils/profiling.device_trace) that
        `_close_trace` closes; it writes trace_epoch<epoch>.json into
        `trace_dir`. Returns (the window, the trace's path)."""
        tag = f"epoch{self.epoch}"
        window = contextlib.ExitStack()
        window.enter_context(device_trace(trace_dir, tag=tag))
        return window, join(trace_dir, f"trace_{tag}.json")

    def _close_trace(self, trace, trace_t0):
        """Close the window of `_open_trace` (the card synchronized, the
        trace written)."""
        window, path = trace
        window.close()
        dt = time.perf_counter() - trace_t0[1]
        n = max(self.step - trace_t0[0], 1)
        print(f"[trace] {n} steps in {dt:.2f}s wall "
              f"({1e3 * dt / n:.1f} ms/step) -> {path}")

    def _audit(self, train_dataset, epoch_drops: float) -> None:
        """The plan-saturation audit (data/telemetry.py: a few fresh
        spheres, their pyramids searched at the plan's widths): warnings
        printed, one line appended to plan_saturation.txt; a failure never
        stops training."""
        try:
            from weasal_tpu_torch.data.telemetry import (
                audit_plan_saturation, format_saturation_line)
            report = audit_plan_saturation(
                train_dataset, self.plan,
                rng=np.random.default_rng(1000 + self.epoch))
            for warning in report["warnings"]:
                print(f"[plan-saturation] {warning}")
            if self.config.saving and self.writer:
                line = format_saturation_line(self.epoch, report)
                line = (line.rstrip("\n")
                        + f" kernel_drops {int(epoch_drops)}\n")
                with open(join(self.config.saving_path,
                               "plan_saturation.txt"), "a") as f:
                    f.write(line)
        except Exception as exc:
            print(f"[plan-saturation] audit skipped: {exc}")

    def _log_header(self, train_dataset, al_iteration) -> str:
        cfg = self.config
        if self.mode == "pseudo":
            gt_count = 0
            for cloud_name in train_dataset.cloud_names_split:
                gt_file = train_dataset.gt_ledger_file(cloud_name)
                if exists(gt_file):
                    with open(gt_file, "rb") as f:
                        gt_count += len(pickle.load(f))
            return ("epochs steps out_loss offset_loss train_accuracy time "
                    f"\tground truth labels: {gt_count}\n")
        n_files = len(train_dataset.cloud_names_split)
        init = (getattr(cfg, "initial_labels_per_file", 0) * n_files
                + al_iteration * getattr(cfg, "added_labels_per_epoch", 0)
                * n_files)
        over = int(np.sum([len(a) for a in train_dataset.anchors]))
        return ("epochs steps out_loss offset_loss train_accuracy time "
                f"\tweak labels (initial): {over} ({init})\n")

    def _flush_log(self, pending, log_file, al_iteration):
        """Fetch the buffered device scalars in one copy and log them."""
        with span("loop.flush"):
            if not pending:
                return
            values = torch.stack([torch.stack([p[k] for p in pending])
                                  for k in (2, 3, 5)], dim=1)
            values = values.cpu().numpy().astype(np.float64)
            rows = [(epoch, step, float(ls), float(rg), float(ac), wall)
                    for (epoch, step, _, _, wall, _), (ls, ac, rg) in zip(
                        pending, values)]
            if self.config.saving and log_file:
                with open(log_file, "a") as f:
                    for epoch, step, ls, rg, ac, wall in rows:
                        f.write(f"{epoch:d} {step:d} {ls:.3f} "
                                f"{rg:.3f} {ac:.3f} "
                                f"{wall:.3f}\n")
            epoch, step, ls, rg, ac, _ = rows[-1]
            print(f"e{epoch:03d}-i{step:04d} => L={ls:.3f} "
                  f"acc={100 * ac:3.0f}% "
                  f"| al_iteration={al_iteration}")

    # ------------------------------------------------------------------
    # Validation
    # ------------------------------------------------------------------

    def _eval_runner(self, pack, extra) -> EvalGraph:
        if self._eval_graph is None:
            config, plan, spec = self.config, self.plan, self.spec

            def body(inputs, out):
                return eval_body(self.model, inputs, config, plan,
                                 self.device, spec=spec, out=out)

            self._eval_graph = EvalGraph("validation batch", body, pack,
                                         self.device, extra=extra,
                                         graphed=self.graphed)
        return self._eval_graph

    def cloud_segmentation_validation(self, val_dataset) -> float:
        """One validation pass of `validation_size` batches: smoothed
        full-cloud probabilities (on the device with resident clouds),
        sub-part confusions rebalanced by class proportions, mIoU.
        Returns the mIoU in percent."""
        config = self.config
        val_smooth = 0.95
        nc_model = config.num_classes
        rng = np.random.default_rng(7 + self.epoch)
        t_start = time.perf_counter()

        if not hasattr(self, "validation_probs") or \
                len(self.validation_probs) != val_dataset.num_clouds:
            self.validation_probs = [
                np.zeros((l.shape[0], nc_model))
                for l in val_dataset.input_labels]
            self.val_proportions = np.zeros(nc_model, np.float32)
            i = 0
            for label_value in val_dataset.label_values:
                if label_value not in val_dataset.ignored_labels:
                    self.val_proportions[i] = np.sum(
                        [np.sum(lbl == label_value)
                         for lbl in val_dataset.validation_labels])
                    i += 1

        if self._val_source is None or \
                self._val_source[0].dataset is not val_dataset:
            self._val_source = self._source(val_dataset)
            self._eval_graph = None
            self._val_acc = None
            if self.resident:
                self._val_acc = DeviceVoteAccumulator(
                    self._val_source[0].resident, nc_model,
                    smooth=val_smooth)
                self._val_acc.load(self.validation_probs)
        source, extra = self._val_source
        val_acc = self._val_acc
        prefetcher = BatchPrefetcher(source, config.validation_size,
                                     self.device, rng=rng, augment=True,
                                     pack=1)
        label_values = val_dataset.label_values
        nonign = np.array([li for li, lv in enumerate(label_values)
                           if lv not in val_dataset.ignored_labels])

        predictions, targets = [], []
        buffered, metas_all = [], []
        for pack, metas in prefetcher:
            runner = self._eval_runner(pack, extra)
            runner.load(pack)
            runner.run()
            probs, labels = runner.out["probs"], runner.out["labels"]
            if val_acc is not None:
                # Smoothing on the device; argmax and labels stay there
                # and come back in one copy at the end (every rank's
                # spheres, gathered in sphere order under a group)
                val_acc.update_gathered(probs, runner.slots[0])
                buffered.append(torch.stack([
                    ddp.gather_spheres(probs.argmax(dim=-1)),
                    ddp.gather_spheres(labels.long())]))
                metas_all.append(metas[0])
                continue
            # copies: on the CPU .cpu() returns the runner's own tensors,
            # which the next batch overwrites
            probs_all = np.array(ddp.gather_spheres(probs).cpu())
            preds_all = np.argmax(probs_all, axis=-1)
            labels_all = np.array(ddp.gather_spheres(labels).cpu())
            metas_all.append(metas[0])
            for b, meta in enumerate(metas[0]):
                n = meta["n_real"]
                inds = meta["input_inds"][:n]
                c_i = meta["cloud_ind"]
                self.validation_probs[c_i][inds] = \
                    val_smooth * self.validation_probs[c_i][inds] \
                    + (1 - val_smooth) * probs_all[b, :n]
                predictions.append(preds_all[b, :n])
                targets.append(labels_all[b, :n])
        if buffered:
            fetched = torch.stack(buffered).cpu().numpy()
            for (preds_all, labels_all), metas in zip(fetched, metas_all):
                for b, meta in enumerate(metas):
                    n = meta["n_real"]
                    predictions.append(preds_all[b, :n])
                    targets.append(labels_all[b, :n])
        n_batches = len(metas_all)
        self.val_times.append(dict(epoch=self.epoch, batches=n_batches,
                                   seconds=time.perf_counter() - t_start))

        # Sub-part confusions with proportion rebalance
        confs = []
        for pred_cls, truth in zip(predictions, targets):
            preds = label_values[nonign[pred_cls]]
            truth_vals = label_values[np.clip(truth, 0, None)]
            confs.append(fast_confusion(truth_vals, preds, label_values))
        C = np.sum(np.stack(confs), axis=0).astype(np.float32)
        for l_ind, label_value in reversed(list(enumerate(label_values))):
            if label_value in val_dataset.ignored_labels:
                C = np.delete(C, l_ind, axis=0)
                C = np.delete(C, l_ind, axis=1)
        C *= np.expand_dims(
            self.val_proportions / (np.sum(C, axis=1) + 1e-6), 1)
        IoUs = IoU_from_confusions(C)
        mIoU = 100 * float(np.mean(IoUs))
        print(f"{config.dataset} mean IoU = {mIoU:.1f}%")

        if config.saving and self.writer:
            line = " ".join(f"{IoU:.3f}" for IoU in IoUs) + " \n"
            val_file = join(config.saving_path, "val_IoUs.txt")
            with open(val_file, "a" if exists(val_file) else "w") as f:
                f.write(line)

            pot_path = join(config.saving_path, "potentials")
            os.makedirs(pot_path, exist_ok=True)
            for i, file_path in enumerate(val_dataset.files):
                pot_points = np.asarray(val_dataset.pot_trees[i].data)
                pots = val_dataset.potentials[i].astype(np.float32)
                write_ply(join(pot_path, os.path.basename(file_path)),
                          [pot_points.astype(np.float32), pots],
                          ["x", "y", "z", "pots"])

            if (self.epoch + 1) % config.checkpoint_gap == 0:
                if val_acc is not None:
                    self.validation_probs = val_acc.materialize()
                self._save_val_confusions(val_dataset)
        self.last_mIoU = mIoU
        return mIoU

    def _save_val_confusions(self, val_dataset):
        """Full-cloud confusion of the smoothed probabilities, projected to
        the original points, as `conf.txt` (the plot is not ported)."""
        val_path = join(self.config.saving_path,
                        f"val_preds_{self.al_iteration}_{self.epoch + 1}")
        os.makedirs(val_path, exist_ok=True)
        label_values = val_dataset.label_values
        n_tot = len(label_values)
        confs = np.zeros((n_tot, n_tot), np.int32)
        for i in range(len(val_dataset.files)):
            sub_probs = self.validation_probs[i]
            for l_ind, label_value in enumerate(label_values):
                if label_value in val_dataset.ignored_labels:
                    sub_probs = np.insert(sub_probs, l_ind, 0, axis=1)
            sub_preds = label_values[np.argmax(sub_probs, axis=1)]
            preds = sub_preds[val_dataset.test_proj[i]].astype(np.int32)
            labels = val_dataset.validation_labels[i].astype(np.int32)
            confs += fast_confusion(labels, preds, label_values).astype(
                np.int32)
        np.savetxt(join(val_path, "conf.txt"), confs, fmt="%i")
