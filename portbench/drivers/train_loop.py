"""The training loop's cell: `weasal_tpu_torch.train.trainer.ModelTrainer
.train` on the resident input, graphed, at the configuration's
published `epoch_steps`, with no validation dataset.

Set-up builds one trainer with the seeded weights and drives its first
`followed_steps` steps through its own `train`, as one epoch: the steps
run back to back, with the prefetcher packing the next batch and the
flush ring in use, as in the window (the first step captures the step
graph). Before each step after the first is loaded, the harness copies
the trainer's state (parameters, BatchNorm statistics, momentum) into
pinned host memory on the loop's own stream, so nothing waits for the
card. After the window the reference takes each of those steps from the
state before it (the seeded state, then the program's) on the same
inputs, with a shape plan it calibrates itself: a step's discrete
choices (max-pool winners, leaky-ReLU signs, the contrast loss's
selections) turn on rounding, so two trajectories that drift apart at
the last bit are compared one step at a time.

The window is one more `train` call on the same trainer. It holds whole
epochs: at the first epoch end once the run's seconds have passed (the
trainer's `_audit`, which runs at every epoch end) the harness sets
`max_epoch` to the epoch reached, and the loop ends after that epoch's
checkpoint, as a user's run ends at its last epoch. So every window
holds the same epoch ends (the flush, the plan audit, the checkpoint, a
new prefetcher) as users' runs do.

The loop is driven through hooks on the trainer instance, never by an
edit of the program: `_step_graph` (each runner's `load` records the host
packs of the followed steps and the state before them), `_flush_log`
(the followed steps' losses; the traced stretch of a `--trace 1` run
opens and closes at flushes, where the card has caught up), `_audit`
(the window's end).
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.drivers import common
from portbench.drivers.stretch import Stretch
from portbench.reference.utils.device import configure_precision
from portbench.yardstick import compare


class _Hooks:
    """The harness's hooks on one trainer."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.recording = False
        self.packs: List[Dict[str, torch.Tensor]] = []
        self.losses: List[float] = []
        self.epochs: List[int] = []
        # the state before each recorded step after the first, copied
        # into `self.buffers` (pinned host memory) on the loop's stream
        self.buffers: List[Tuple[Dict, Dict]] = []
        self.snapshots: List[Tuple[Dict, Dict]] = []
        self.stretch = None
        # (start, seconds) of the window while it is open
        self.window: Optional[Tuple[float, float]] = None
        self._step_graph = trainer._step_graph
        self._flush_log = trainer._flush_log
        self._audit = trainer._audit
        trainer._step_graph = self.step_graph
        trainer._flush_log = self.flush_log
        trainer._audit = self.audit

    def step_graph(self, tag, steps, pack, extra):
        graph = self._step_graph(tag, steps, pack, extra)
        if not getattr(graph, "_portbench", False):
            graph._portbench = True
            load = graph.load

            def recorded_load(host, index=None):
                if self.recording:
                    if self.packs:
                        self.snapshots.append(
                            self._snapshot(self.buffers[len(self.snapshots)]))
                    part = {k: (v if index is None else v[index:index + 1])
                            for k, v in host.items()}
                    self.packs.append({k: v.clone() for k, v in
                                       part.items()})
                    self.epochs.append(self.trainer.epoch)
                load(host, index)
            graph.load = recorded_load
        return graph

    def _state(self):
        t = self.trainer
        return ({k: v.detach() for k, v in t.model.state_dict().items()},
                {k: v.detach() for k, v in t.opt_state.items()})

    def prepare(self, n: int) -> None:
        """Pinned host buffers for `n` snapshots of the state (allocated
        before the loop runs: an allocation of pinned memory may wait for
        the card)."""
        pin = self.trainer.device.type == "cuda"
        self.buffers = [tuple({k: torch.empty(v.shape, dtype=v.dtype,
                                              pin_memory=pin)
                               for k, v in part.items()}
                              for part in self._state())
                        for _ in range(n)]

    def _snapshot(self, buffers):
        """The state, as the steps issued so far leave it, copied into
        `buffers` on the current stream without waiting for the card."""
        for part, out in zip(self._state(), buffers):
            for k, v in part.items():
                out[k].copy_(v, non_blocking=True)
        return buffers

    def flush_log(self, pending, log_file, al_iteration):
        if self.recording and pending:
            self.losses += [float(v) for v in torch.stack(
                [p[2] for p in pending]).cpu()]
        self._flush_log(pending, log_file, al_iteration)
        if self.stretch is not None:
            t = self.trainer
            self.stretch.at_flush(
                t.graph_counts()["train_replayed_steps"],
                room=t.config.epoch_steps - t.step)

    def audit(self, train_dataset, epoch_drops):
        """At each epoch's end: the program's audit, then the window's
        end where its seconds have passed."""
        self._audit(train_dataset, epoch_drops)
        if self.window is not None and \
                time.perf_counter() - self.window[0] >= self.window[1]:
            self.trainer.config.max_epoch = self.trainer.epoch


def _full_state(trainer):
    """(the network's state dict, the momentum), copied to the host."""
    return ({k: v.detach().cpu().clone() for k, v in
             trainer.model.state_dict().items()},
            {k: v.detach().cpu().clone() for k, v in
             trainer.opt_state.items()})


def run(ctx) -> Dict:
    from weasal_tpu_torch.train.trainer import ModelTrainer
    spec, traffic, device = ctx.spec, ctx.traffic, ctx.device
    cfg = common.program_config(spec)
    if device.type != "cuda":
        cfg.resident_clouds = True     # the card's input, in CPU tests
    cfg.saving = True
    cfg.saving_path = common.run_dir(ctx.workload)
    try:
        return _run(ctx, spec, traffic, device, cfg, ModelTrainer)
    finally:
        shutil.rmtree(cfg.saving_path, ignore_errors=True)


def _run(ctx, spec, traffic, device, cfg, ModelTrainer) -> Dict:
    if ctx.trace:
        # the loop's own breakdown of its host time (wait_batch)
        os.environ["WEASAL_LOOP_STATS"] = "1"
    marks = [("imports", ctx.clock())]
    root = common.data_root(spec)
    common.calibrate(spec, cfg, root)
    marks.append(("tile and plan", ctx.clock()))
    train_ds = common.dataset(spec, cfg, root, "training", ctx.seed)
    marks.append(("dataset", ctx.clock()))
    trainer = ModelTrainer(cfg, train_ds, device=device,
                           graphs=None if device.type == "cuda" else False,
                           stage_dir=spec["program"]["stage_dir"])
    marks.append(("trainer", ctx.clock()))
    ref_cfg = common.reference_config(spec)
    ref_model = common.reference_model(spec, ref_cfg, cfg.num_classes)
    state0 = common.seeded_state(ref_model, ctx.seed, device)
    common.check_names(trainer.model, state0)
    trainer.model.load_state_dict(state0)
    hooks = _Hooks(trainer)
    marks.append(("seeded weights", ctx.clock()))

    # The followed steps: the window's own call on the same trainer, as
    # one epoch (a weak-label batch without regions is skipped, so an
    # epoch may run fewer; another epoch then runs the rest)
    total = int(traffic["followed_steps"])
    states = [_full_state(trainer)]
    hooks.prepare(total - 1)
    hooks.recording = True
    while len(hooks.packs) < total:
        cfg.epoch_steps = total - len(hooks.packs)
        cfg.max_epoch = trainer.epoch + 1
        trainer.train(train_ds, None)
    hooks.recording = False
    common.sync(device)
    states += hooks.snapshots + [_full_state(trainer)]
    hooks.buffers, hooks.snapshots = [], []
    if len(hooks.packs) != total or len(hooks.losses) != total \
            or len(states) != total + 1:
        raise RuntimeError(
            f"followed {total} steps, recorded {len(hooks.packs)} packs, "
            f"{len(hooks.losses)} losses and {len(states)} states")
    epochs = hooks.epochs
    marks.append(("followed steps, the capture among them", ctx.clock()))

    # The window: whole epochs, until an epoch ends past the seconds
    cfg.epoch_steps = spec["config"]["epoch_steps"]
    cfg.max_epoch = trainer.epoch + 10 ** 6
    first_epoch = len(trainer.epoch_times)
    if ctx.trace:
        hooks.stretch = Stretch(device, traffic["stretch"], ctx.seconds)

    common.sync(device)
    setup_s = ctx.clock()
    common.print_marks(marks)
    t0 = time.perf_counter()
    if hooks.stretch is not None:
        hooks.stretch.open_window(t0)
    hooks.window = (t0, ctx.seconds)
    trainer.train(train_ds, None)
    hooks.window = None
    common.sync(device)
    window_s = time.perf_counter() - t0
    epochs_run = trainer.epoch_times[first_epoch:]
    steps = sum(e["steps"] for e in epochs_run)
    peak = ctx.memory_peak()
    wait_batch = sum(e.get("wait_batch", 0.0) for e in epochs_run)
    loop_s = sum(e["seconds"] for e in epochs_run)
    if hooks.stretch is not None:
        # the profiler's starts and stops ran inside the loop's flushes
        loop_s -= hooks.stretch.overhead_s
    ends = [b["start"] - (a["start"] + a["seconds"])
            for a, b in zip(epochs_run, epochs_run[1:])]
    print(f"window: {steps} steps in {window_s:.3f} s; epochs "
          f"{[(e['steps'], round(e['seconds'], 3)) for e in epochs_run]}, "
          f"epoch ends (checkpoint, audit, a new prefetcher) "
          f"{[round(x, 3) for x in ends]} s", file=sys.stderr)

    # The start: the program's resident clouds against the reference's
    # own subsample of the raw tile
    from portbench.reference.data.resident import ResidentClouds
    pseudo = trainer.mode == "pseudo"
    clouds = common.TileClouds(
        root, ref_cfg, common.TRAIN_CLOUD,
        common.pseudo_labels(root, spec) if pseudo else None,
        common.label_table(pseudo))
    res_ref = ResidentClouds(clouds, device).arrays
    source = trainer._train_source[0]
    mismatch = common.resident_mismatch(source.resident.arrays, res_ref)
    program_plan = vars(trainer.plan)
    packs, losses, stretch = hooks.packs, hooks.losses, hooks.stretch
    del trainer, source, hooks
    if device.type == "cuda":
        torch.cuda.empty_cache()

    plan = common.reference_plan(spec, ref_cfg, root)
    configure_precision()
    numbers = {"resident_mismatch": mismatch,
               "plan_mismatch": common.plan_mismatch(program_plan, plan)}
    reference = follow(ref_model, states, packs, epochs, ref_cfg, plan,
                       res_ref, device, record=True)
    numbers.update(gaps(losses, states, reference, ref_cfg))
    control = None
    if ctx.control:
        with compare.tf32_products(device):
            control_run = follow(ref_model, states, packs, epochs, ref_cfg,
                                 plan, res_ref, device)
        control = gaps(control_run["losses"], states, reference, ref_cfg,
                       what="control", run=control_run)
    return dict(kind="train", setup_s=setup_s, window_s=window_s,
                steps=steps, attempted=steps, failed=0,
                memory_peak_bytes=peak, numbers=numbers, control=control,
                calls=reference["calls"], wait_batch_s=wait_batch,
                loop_s=loop_s, stretch=stretch)


def follow(ref_model, states, packs, epochs, ref_cfg, plan, res_ref,
           device, record: bool = False) -> Dict:
    """The reference's step k on the program's state before it
    (`states[k]`: the seeded state, then the program's after each step)
    and on step k's pack: {"losses", "m1" (the momentum after step 1),
    "changes" (each step's parameter change), "calls" (the KPConv and
    linear calls of one step)}."""
    from portbench.reference import work_log
    from portbench.reference.data.resident import feature_spec
    from portbench.reference.train.step import (class_weights, label_table,
                                                step_body)
    model = ref_model.to(device)
    spec = feature_spec("Vaihingen3D", ref_cfg.in_features_dim)
    class_w = class_weights(ref_cfg, device)
    table = label_table(model, device)
    losses, m1, changes, calls = [], None, [], []
    for i, (pack, epoch) in enumerate(zip(packs, epochs)):
        net, momentum = states[i]
        model.load_state_dict(net)
        opt = {k: v.to(device).clone() for k, v in momentum.items()}
        inputs = {k: v[0].to(device) for k, v in pack.items()}
        inputs.update(res_ref)
        contrast = model.mode == "pseudo" and epoch >= getattr(
            ref_cfg, "contrast_start", 1 << 30)
        lr = torch.full((), common.lr_of_epoch(ref_cfg, epoch),
                        dtype=torch.float32, device=device)
        work_log.CALLS = calls if (record and i == 0) else None
        try:
            loss = step_body(model, opt, inputs, ref_cfg, plan, lr, class_w,
                             table, spec, use_contrast=contrast)
        finally:
            work_log.CALLS = None
        losses.append(float(loss))
        if i == 0:
            m1 = {k: v.detach().cpu().clone() for k, v in opt.items()}
        changes.append({k: v.detach().cpu() - net[k] for k, v in
                        model.named_parameters()})
    model.to("cpu")
    return dict(losses=losses, m1=m1, changes=changes, calls=calls)


def gaps(losses, states, reference, ref_cfg, what: str = "program",
         run: Dict = None) -> Dict[str, float]:
    """loss_gap, grad_gap and step_gap of the program's steps (or, with
    `run`, of the control's) against the reference; prints the readings
    behind them on standard error."""
    wd = float(ref_cfg.weight_decay)
    p0 = {k: v for k, v in states[0][0].items()
          if k in reference["changes"][0]}
    if run is None:
        m1 = states[1][1]
        total = {k: states[-1][0][k] - p0[k] for k in p0}
    else:
        losses, m1 = run["losses"], run["m1"]
        total = {k: sum(c[k] for c in run["changes"]) for k in p0}
    g_ref = {k: reference["m1"][k] - wd * p0[k] for k in p0}
    g_got = {k: m1[k] - wd * p0[k] for k in p0}
    leaves = compare.counted_leaves(g_ref)
    total_ref = {k: sum(c[k] for c in reference["changes"]) for k in p0}
    grad = compare.leaf_gaps(g_got, g_ref, leaves)
    step = compare.leaf_gaps(total, total_ref, leaves)
    print(f"readings {what}: losses {losses} reference "
          f"{reference['losses']}; {len(leaves)} of {len(p0)} leaves; "
          f"grad worst {compare.worst(grad, 3)} median "
          f"{compare.median(grad):.3g}; step worst {compare.worst(step, 3)} "
          f"median {compare.median(step):.3g}", file=sys.stderr)
    return dict(loss_gap=compare.loss_gap(losses, reference["losses"]),
                grad_gap=max(grad.values()), step_gap=max(step.values()))
