"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phases, in order; any failure exits non-zero:
1. setup: card name and power limit (nvidia-smi), build of both CUDA
   kernels with nvcc (sm_90a), the Vaihingen3D weak-label model at full
   width with weights from a seeded torch.Generator, a shape plan
   calibrated on synthetic spheres, and the level-0 batches;
2. kernels against their plain PyTorch versions on the card, at every
   shape one forward gives them: the 7 radius-search edges (kernel A,
   indices equal) and the 12 KPConvs (kernel B, f32 tolerance below),
   with kernel and plain times (CUDA events, median of 10 after warm-up)
   and each kernel's bound;
3. the main path: `eval_step` on each batch, launch counts read around
   it, probabilities checked, and one batch's forward compared with the
   same forward on the plain versions.
The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers as JSON. Imports nothing of JAX or weasal_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores; both kernels run f32 on the
# CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Kernel B vs its plain version: both sum in f32 but in different orders
# (gather-then-FMA per channel and a tiled GEMM against einsum + cuBLAS),
# so outputs agree to f32 rounding accumulated over Kp*K + Kp*Cin terms.
KPCONV_RTOL = 1e-4
KPCONV_ATOL_REL = 1e-5       # times max |plain output|
# Whole forward, kernels vs plain versions on one shared pyramid
PROBS_ATOL = 1e-4
N_BATCHES = 3
SEED = 0


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of fn() in ms (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def search_edges(batch, config, plan):
    """(name, query level, support level, radius, K) of the 3L-2 edges,
    in the pyramid's order."""
    from weasal_tpu_torch.data.batching import layer_radii
    conv_r, pool_r, up_r = layer_radii(config)
    L = plan.num_layers
    edges = []
    for l in range(L):
        edges.append((f"conv{l}", l, l, conv_r[l], plan.conv_neighbors[l]))
        if l < L - 1:
            edges.append((f"pool{l}", l + 1, l, pool_r[l],
                          plan.pool_neighbors[l]))
            edges.append((f"up{l}", l, l + 1, up_r[l], plan.up_neighbors))
    return edges


def check_radius_search(batch, config, plan, log):
    from weasal_tpu_torch.ops.cuda.radius_search import (
        radius_search, radius_search_plain)
    rows, t_k, t_p, t_b, ops_t, bytes_t = [], 0.0, 0.0, 0.0, 0.0, 0.0
    for name, lq, ls, r, k in search_edges(batch, config, plan):
        q, s = batch.points[lq], batch.points[ls]
        qm, sm = batch.masks[lq], batch.masks[ls]
        got = radius_search(q, s, qm, sm, r, k)[0]
        ref = radius_search_plain(q, s, qm, sm, r, k)
        torch.cuda.synchronize()
        mismatch = int((got != ref).sum())
        if mismatch:
            raise AssertionError(f"radius_search {name}: {mismatch} indices "
                                 "differ from the plain version")
        ms = cuda_ms(lambda: radius_search(q, s, qm, sm, r, k))
        plain = cuda_ms(lambda: radius_search_plain(q, s, qm, sm, r, k))
        pairs = float((qm.sum(1).double() * sm.sum(1).double()).sum())
        n_ops = 8.0 * pairs
        n_bytes = (q.numel() * 4 + s.numel() * 4 + qm.numel() + sm.numel()
                   + got.numel() * 4)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        t_k, t_p, t_b = t_k + ms, t_p + plain, t_b + b_ms
        ops_t, bytes_t = ops_t + n_ops, bytes_t + n_bytes
        row = dict(edge=name, shape=[*q.shape[:2], s.shape[1], k], ms=ms,
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
        rows.append(row)
        log(f"  A {name:6s} q{list(q.shape)} s{list(s.shape)} K={k}: "
            f"equal, kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=0.0,
                      bound_by=bound_ms(bytes_t, ops_t)[1])


def check_kpconv(model, batch, log, seed):
    from weasal_tpu_torch.models.blocks import conv_inputs, kpconv_modules
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd,
                                                      kpconv_fwd_plain)
    gen = torch.Generator(device=batch.features.device).manual_seed(seed)
    rows, t_k, t_p, t_b, ops_t, bytes_t = [], 0.0, 0.0, 0.0, 0.0, 0.0
    worst = 0.0
    for name, conv in kpconv_modules(model):
        q, s, nb, q_mask = conv_inputs(conv.strided, conv.layer_ind, batch)
        kp, w = conv.kernel_points, conv.weights.detach()
        cin = w.shape[1]
        x = torch.randn((s.shape[0], s.shape[1], cin), generator=gen,
                        device=s.device)
        ext, infl = conv.params.kp_extent, conv.params.influence
        got = kpconv_fwd(q, s, nb, x, kp, w, ext, infl)[0]
        ref = kpconv_fwd_plain(q, s, nb, x, kp, w, ext, infl)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not torch.allclose(got, ref, rtol=KPCONV_RTOL,
                              atol=KPCONV_ATOL_REL * max(scale, 1e-30)):
            raise AssertionError(f"kpconv_fwd {name}: max abs err {err} at "
                                 f"output scale {scale}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: kpconv_fwd(q, s, nb, x, kp, w, ext, infl))
        plain = cuda_ms(lambda: kpconv_fwd_plain(q, s, nb, x, kp, w, ext,
                                                 infl))
        n_kp, _, cout = w.shape
        pairs = float((nb < s.shape[1]).sum())
        rows_valid = float(q_mask.sum())
        n_ops = (pairs * n_kp * (14 + 2 * cin)
                 + rows_valid * 2.0 * n_kp * cin * cout)
        n_bytes = 4.0 * (q.numel() + s.numel() + nb.numel() + x.numel()
                         + kp.numel() + w.numel() + got.numel())
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        t_k, t_p, t_b = t_k + ms, t_p + plain, t_b + b_ms
        ops_t, bytes_t = ops_t + n_ops, bytes_t + n_bytes
        rows.append(dict(conv=name, shape=[*q.shape[:2], s.shape[1],
                                           nb.shape[2], cin, cout],
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"  B {name}: q{list(q.shape[:2])} Ns={s.shape[1]} "
            f"K={nb.shape[2]} {cin}->{cout}: err {err:.2e} (scale "
            f"{scale:.2e}), kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=worst,
                      bound_by=bound_ms(bytes_t, ops_t)[1])


def profile_step(step, log, top: int = 12):
    """Device time of one call of `step` by kernel name (torch.profiler);
    returns (rows, busy ms, wall ms). Busy is the sum of kernel self
    times, so the idle share is 1 - busy / wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    log(f"profile of one eval_step: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {len(rows)} kernels")
    for name, count, ms in rows[:top]:
        log(f"  {ms:9.3f} ms {count:4d}x  {name[:90]}")
    return rows, busy, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="also write the per-shape report to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from weasal_tpu_torch import KPFCNN_mprm, VaihingenWLConfig, eval_step
    from weasal_tpu_torch.data.batching import calibrate_shape_plan
    from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
    from weasal_tpu_torch.data.level0 import assemble_level0
    from weasal_tpu_torch.infer import to_device
    from weasal_tpu_torch.ops.cuda import build
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd
    from weasal_tpu_torch.ops.cuda.radius_search import radius_search
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.device import configure_precision, plain_ops

    def log(msg):
        print(msg, flush=True)

    # ---- phase 1: setup
    card = card_line()
    log(f"card: {card}")
    t0 = time.perf_counter()
    outputs = build.build_all(verbose=True)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(outputs)})")
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    configure_precision()
    dev = torch.device("cuda")
    config = VaihingenWLConfig()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    calib = [demo_sphere(rng, config) for _ in range(2 * config.batch_num)]
    plan = calibrate_shape_plan(
        [p["points"] for p in calib], config, region_budget=(8, 64), rng=rng)
    log(f"plan ({time.perf_counter() - t0:.1f} s): {plan}")
    model = KPFCNN_mprm(config, tuple(range(config.num_classes)), (),
                        generator=torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    n0 = plan.num_points[0]
    batches = [assemble_level0(
        [thin_payload(demo_sphere(rng, config), n0, rng)
         for _ in range(config.batch_num)], plan, config.num_classes, rng)
        for _ in range(N_BATCHES)]

    # ---- phase 2: kernels against their plain versions, main-path shapes
    t = to_device(batches[0], dev)
    with torch.no_grad(), plain_ops():
        ref_batch = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t["rotations"])
    log("phase 2: kernels vs plain versions")
    with torch.no_grad():
        a_rows, a_sum = check_radius_search(ref_batch, config, plan, log)
        b_rows, b_sum = check_kpconv(model, ref_batch, log, SEED)

    # ---- phase 3: the main path
    log("phase 3: eval_step on the card")
    radius_search.launches = 0
    kpconv_fwd.launches = 0
    step_ms, points = [], 0
    for arrays in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs = eval_step(model, arrays, config, plan, device=dev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        mask = torch.as_tensor(arrays["mask0"], device=dev)
        points += int(mask.sum())
        if tuple(probs.shape) != (*mask.shape, config.num_classes):
            raise AssertionError(f"probs shape {tuple(probs.shape)}")
        valid = probs[mask]
        if not bool(torch.isfinite(valid).all()):
            raise AssertionError("non-finite probabilities")
        if not torch.allclose(valid.sum(-1), torch.ones_like(valid[:, 0]),
                              atol=1e-5):
            raise AssertionError("probabilities do not sum to 1")
    launches = {"radius_search": radius_search.launches,
                "kpconv_fwd": kpconv_fwd.launches}
    expected = {"radius_search": 3 * plan.num_layers - 2,
                "kpconv_fwd": len(b_rows)}
    for name, per_batch in expected.items():
        if launches[name] != per_batch * len(batches):
            raise AssertionError(
                f"{name}: {launches[name]} launches in {len(batches)} "
                f"batches, expected {per_batch} per batch")
    log(f"launches: {launches} over {len(batches)} batches")
    steady_ms = statistics.mean(step_ms[1:] or step_ms)
    log(f"eval_step ms per batch: {[round(v, 3) for v in step_ms]}; "
        f"real points/s (batches 2..): "
        f"{points / len(batches) * 1e3 / steady_ms:.0f}")

    with torch.no_grad():
        probs_k = torch.softmax(model(ref_batch)[0], dim=-1)
        with plain_ops():
            probs_p = torch.softmax(model(ref_batch)[0], dim=-1)
    diff = float((probs_k - probs_p)[ref_batch.masks[0]].abs().max())
    log(f"forward, kernels vs plain versions on one pyramid: max |dprobs| "
        f"{diff:.2e} (atol {PROBS_ATOL})")
    if not diff <= PROBS_ATOL:
        raise AssertionError("kernel forward disagrees with the plain one")
    prof_rows, busy, wall = profile_step(
        lambda: eval_step(model, batches[-1], config, plan, device=dev), log)

    kernels = [
        dict(name="radius_search", route="cuda",
             source="weasal_tpu_torch/csrc/radius_search.cu",
             replaces="weasal_tpu/ops/pallas/radius_pallas.py:196",
             launches=launches["radius_search"], library_ms=None, **a_sum),
        dict(name="kpconv_fwd", route="cuda",
             source="weasal_tpu_torch/csrc/kpconv_fwd.cu",
             replaces="weasal_tpu/ops/pallas/kpconv_banded.py:478",
             launches=launches["kpconv_fwd"], library_ms=None, **b_sum),
    ]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, plan=vars(plan), step_ms=step_ms,
                           radius_search=a_rows, kpconv_fwd=b_rows,
                           kernels=kernels, probs_max_diff=diff,
                           profile=dict(wall_ms=wall, busy_ms=busy,
                                        rows=prof_rows)), f,
                      indent=1)
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
