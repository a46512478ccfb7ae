"""The voting pass's cell: `weasal_tpu_torch.train.tester.ModelTester.
cloud_segmentation_test` on the tile's test split, from a checkpoint of
the seeded weights that set-up writes: the final segmentation pass of
`test_models --on test`. The reference works on a shape plan it
calibrates itself (drivers/common.reference_plan), which has to equal
the program's.

The pass runs test epochs of `validation_size` batches, each ending in
its min-potential check. The harness wraps the dataset's `min_potential`
(called once at each epoch's end): its first call, after epoch 0 (a few
batches, `warmup_batches`, which capture the vote graph), restores the
configuration's `validation_size` and opens the window; the first call after the
run's seconds closes it, and raises to end the pass there. So the window
holds whole test epochs with their checks. `num_votes` is set beyond
reach, so that the pass never ends by itself.

The vote accumulator of the pass is the harness's through a wrapped
`vote_parts`: its `update_gathered` counts the batches, keeps the
sampled batches' inputs, probabilities and the buffer before and after
their update (for the comparison), and steps the traced stretches.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.drivers import common
from portbench.drivers.stretch import Stretch
from portbench.reference.utils.device import configure_precision
from portbench.yardstick import compare


def calibrate_batch_norm(ref_model, ref_cfg, plan, res, arrays, device):
    """The checkpoint's BatchNorm running statistics: those of one batch
    in the reference network (training mode, each BatchNorm's momentum 1
    for the pass), so that the eval network's activations are normalized
    as a trained one's are."""
    from portbench.reference.data.resident import feature_spec
    from portbench.reference.infer import input_batch
    from portbench.reference.models.blocks import MaskedBatchNorm
    bns = [m for m in ref_model.modules()
           if isinstance(m, MaskedBatchNorm) and m.use_bn]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    inputs = {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}
    inputs.update(res)
    spec = feature_spec("Vaihingen3D", ref_cfg.in_features_dim)
    ref_model.train()
    with torch.no_grad():
        batch, _ = input_batch(inputs, ref_cfg, plan, device, spec=spec)
        if ref_model.mode == "pseudo":
            ref_model(batch, dropout_seed=torch.zeros(
                (), dtype=torch.int64, device=device))
        else:
            ref_model(batch)
    for m, mom in zip(bns, saved):
        m.momentum = mom
    ref_model.eval()


class _Votes:
    """The harness's wrap of the pass's vote accumulator."""

    def __init__(self, acc, sample: List[int], stretch):
        self.acc = acc
        self.sample = set(sample)
        self.stretch = stretch
        self.batches = 0
        self.window_first = None
        self.kept: List[Dict] = []
        self._update = acc.update_gathered
        acc.update_gathered = self.update_gathered

    def update_gathered(self, probs, batch, d2=None):
        i = self.batches
        in_window = self.window_first is not None
        keep = in_window and (i - self.window_first) in self.sample
        if keep:
            before = self.acc._flat.clone()
        self._update(probs, batch, d2=d2)
        self.batches += 1
        if keep:
            self.kept.append(dict(
                inputs={k: v.clone() for k, v in batch.items()
                        if not k.startswith("res_")},
                probs=probs.clone(), before=before,
                after=self.acc._flat.clone()))
        if in_window and self.stretch is not None:
            self.stretch.at_unit(self.batches)


def run(ctx) -> Dict:
    from weasal_tpu_torch.train.tester import ModelTester
    spec, traffic, device = ctx.spec, ctx.traffic, ctx.device
    cfg = common.program_config(spec)
    if device.type != "cuda":
        cfg.resident_clouds = True     # the card's input, in CPU tests
    cfg.saving = False
    # epoch 0, which captures the vote graph, is short; the window's
    # epochs have the configuration's validation_size
    cfg.validation_size = int(traffic["warmup_batches"])
    marks = [("imports", ctx.clock())]
    root = common.data_root(spec)
    # the training split's plan, which voting uses, as after training
    common.calibrate(spec, cfg, root)
    marks.append(("tile and plan", ctx.clock()))
    test_ds = common.dataset(spec, cfg, root, "test", ctx.seed)
    plan_obj = test_ds.calibration()
    marks.append(("test dataset", ctx.clock()))
    ref_cfg = common.reference_config(spec)
    ref_model = common.reference_model(spec, ref_cfg, cfg.num_classes)
    state0 = common.seeded_state(ref_model, ctx.seed, device)

    # BatchNorm statistics of one sampled test batch, in the reference
    # (on its own plan of the training split, which voting uses)
    from portbench.reference.data.resident import (ResidentClouds,
                                                   pack_payloads)
    clouds = common.TileClouds(root, ref_cfg, common.TEST_CLOUD, None,
                               common.label_table(True))
    res_ref = ResidentClouds(clouds, device).arrays
    plan = common.reference_plan(spec, ref_cfg, root)
    configure_precision()
    program_plan = vars(plan_obj)
    rng = np.random.default_rng([ctx.seed % 2 ** 63, 29])
    payloads = [test_ds.sample_sphere(rng, augment=True,
                                      max_points=plan.num_points[0],
                                      gather=False)
                for _ in range(cfg.batch_num)]
    arrays = pack_payloads(payloads, plan, ref_cfg, rng,
                           base=np.zeros(1, np.int64),
                           shadow=res_ref["res_points"].shape[0] - 1)
    ref_model.to(device).load_state_dict(state0)
    calibrate_batch_norm(ref_model, ref_cfg, plan, res_ref, arrays, device)
    state0 = {k: v.detach().clone() for k, v in
              ref_model.state_dict().items()}
    ref_model.to("cpu")
    del res_ref
    if device.type == "cuda":
        # the peak from here on is the program's: its set-up, its window
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("seeded weights, BatchNorm statistics", ctx.clock()))
    chkp = os.path.join(common.run_dir(ctx.workload), "seeded_chkp.tar")
    torch.save({"epoch": 0,
                "model_state_dict": {k: v.cpu() for k, v in state0.items()},
                "optimizer_state_dict": None, "saving_path": None}, chkp)
    try:
        tester = ModelTester(cfg, test_ds, chkp, device=device)
    finally:
        shutil.rmtree(os.path.dirname(chkp), ignore_errors=True)
    common.check_names(tester.model, state0)
    marks.append(("tester", ctx.clock()))

    # the sampled batches: of the window's first test epoch, which every
    # window holds whole
    sample = sorted(np.random.default_rng(
        [ctx.seed % 2 ** 63, 31]).choice(
            int(spec["config"]["validation_size"]),
            size=int(traffic["sampled_batches"]), replace=False).tolist())
    stretch = Stretch(device, traffic["stretch"], ctx.seconds) \
        if ctx.trace else None
    state = dict(votes=None, points=[], t0=None, t1=None, setup_s=None,
                 first_batch=None, ends=[])
    vote_parts = tester.vote_parts

    def wrapped_parts(dataset):
        source, extra, acc = vote_parts(dataset)
        state["votes"] = _Votes(acc, sample, stretch)
        next_batch = source.next_batch

        def counted_batch(*args, **kwargs):
            arrays, metas = next_batch(*args, **kwargs)
            state["points"].append(sum(m["n_real"] for m in metas))
            return arrays, metas
        source.next_batch = counted_batch
        return source, extra, acc
    tester.vote_parts = wrapped_parts

    min_potential = test_ds.min_potential

    def window_clock():
        votes = state["votes"]
        common.sync(device)
        now = time.perf_counter()
        if state["t0"] is None:
            cfg.validation_size = spec["config"]["validation_size"]
            state["t0"] = now
            state["setup_s"] = ctx.clock()
            marks.append(("epoch 0, the capture among it", state["setup_s"]))
            common.print_marks(marks)
            state["first_batch"] = votes.batches
            votes.window_first = votes.batches
            if stretch is not None:
                stretch.open_window(now)
        else:
            state["ends"].append(now)
            if now - state["t0"] >= ctx.seconds:
                state["t1"] = now
                raise common.WindowClosed()
        return min_potential()
    test_ds.min_potential = window_clock

    try:
        tester.cloud_segmentation_test(
            test_ds, num_votes=float(traffic["num_votes"]),
            stage_dir=spec["program"]["stage_dir"])
    except common.WindowClosed:
        pass
    votes = state["votes"]
    batches = votes.batches - state["first_batch"]
    window_s = state["t1"] - state["t0"]
    points = float(sum(state["points"][state["first_batch"]:votes.batches]))
    ends = [state["t0"]] + state["ends"]
    print(f"window: {batches} batches, {points:.0f} points in "
          f"{window_s:.3f} s; test epochs "
          f"{[round(b - a, 3) for a, b in zip(ends, ends[1:])]} s",
          file=sys.stderr)
    peak = ctx.memory_peak()
    program_res = votes.acc.resident.arrays
    kept = votes.kept
    del tester, votes, state["votes"]
    if device.type == "cuda":
        torch.cuda.empty_cache()

    res_ref = ResidentClouds(clouds, device).arrays
    mismatch = common.resident_mismatch(program_res, res_ref)
    del program_res
    reference = follow(ref_model, state0, kept, ref_cfg, plan, res_ref,
                       device, cfg, record=True)
    numbers = {"resident_mismatch": mismatch,
               "plan_mismatch": common.plan_mismatch(program_plan, plan)}
    numbers.update(gaps(kept, reference))
    control = None
    if ctx.control:
        with compare.tf32_products(device):
            control_ref = follow(ref_model, state0, kept, ref_cfg, plan,
                                 res_ref, device, cfg)
        control = gaps([dict(k, probs=c, after=a) for k, c, a in zip(
            kept, control_ref["probs"], control_ref["after"])], reference)
    return dict(kind="vote", setup_s=state["setup_s"], window_s=window_s,
                steps=batches, attempted=batches, failed=0,
                points=points, memory_peak_bytes=peak, numbers=numbers,
                control=control, calls=reference["calls"], stretch=stretch,
                sampled=len(kept))


def follow(ref_model, state0, kept, ref_cfg, plan, res_ref, device,
           cfg, record: bool = False) -> Dict:
    """The reference's probabilities of the kept batches, and its vote
    update of each batch applied to the program's buffer before it."""
    from portbench.reference import work_log
    from portbench.reference.data.resident import feature_spec
    from portbench.reference.infer import eval_body
    from portbench.reference.train.vote import DeviceVoteAccumulator

    class _Res:
        arrays = res_ref
    model = ref_model.to(device)
    model.load_state_dict(state0)
    model.eval()
    spec = feature_spec("Vaihingen3D", ref_cfg.in_features_dim)
    acc = DeviceVoteAccumulator(_Res, cfg.num_classes, smooth=0.95,
                                radius_sq=(0.7 * ref_cfg.in_radius) ** 2)
    probs, after, calls = [], [], []
    for i, k in enumerate(kept):
        inputs = dict(k["inputs"])
        inputs.update(res_ref)
        work_log.CALLS = calls if (record and i == 0) else None
        try:
            with torch.no_grad():
                out = eval_body(model, inputs, ref_cfg, plan, device,
                                spec=spec)
        finally:
            work_log.CALLS = None
        acc._flat.copy_(k["before"])
        acc.update(out["probs"], inputs, d2=out["d2"])
        probs.append(out["probs"])
        after.append(acc._flat.clone())
    model.to("cpu")
    return dict(probs=probs, after=after, calls=calls)


def gaps(kept, reference) -> Dict[str, float]:
    """probs_gap over the kept batches' real points, and vote_gap (none
    where no batch was kept, which fails the run)."""
    if not kept:
        return {}
    probs_gap = vote_gap = 0.0
    for k, p_ref, a_ref in zip(kept, reference["probs"],
                               reference["after"]):
        shadow = a_ref.shape[0] - 1
        real = k["inputs"]["flat_inds"].long() < shadow
        diff = (k["probs"] - p_ref).abs().amax(dim=-1)
        probs_gap = max(probs_gap, float(diff[real].max()))
        vote_gap = max(vote_gap, float((k["after"] - a_ref).abs().max()))
    return dict(probs_gap=probs_gap, vote_gap=vote_gap)
