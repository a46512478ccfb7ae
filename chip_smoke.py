"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phases, in order; any failure exits non-zero:
1. setup: card name and power limit (nvidia-smi), build of the four CUDA
   kernels with nvcc (sm_90a, one process per source, in parallel), the
   Vaihingen3D weak-label model at full width with weights from a seeded
   torch.Generator, a shape plan calibrated on synthetic spheres, and the
   level-0 batches;
2. kernels A and B against their plain PyTorch versions on the card, at
   every shape one forward gives them: the 7 radius-search edges (kernel
   A, indices equal, the same on a second call, and equal to the
   PyTorch emulation of its column rule, whose count of the candidates
   per query is reported beside them) and the 12 KPConvs (kernel B, f32
   tolerance below), with kernel and plain times (CUDA events, median of
   10 after warm-up) and each kernel's bound (A's from its in-radius
   pairs, with the figure of an all-pairs search beside it). For B also
   the time of its GEMM part (by kernel name, torch.profiler) beside
   cuBLAS f32 on the same product
   (`torch.matmul` without TF32, a yardstick the port never calls) and
   that product's f32 and 3xTF32 bounds; then the GEMM core's mean error
   on positive operands (its accumulation must not drift one way);
3. the inference path: `eval_step` on each batch, launch counts read
   around it, probabilities checked, and one batch's forward compared
   with the same forward on the plain versions;
4. kernels C and D against their plain versions at every shape one
   training step gives them: the 12 KPConv backwards (seeded random
   inputs and output gradients) and the 2 strided-shortcut max-pool
   backwards (integer-valued features, so that ties and maxima of 0
   shared with shadows occur), timed as in phase 2, C's two GEMM parts
   as B's;
5. the training path: `train_step` for 4 steps, launch counts read around
   them, losses, parameters and BatchNorm statistics checked, then one
   step with the kernels, one on the plain versions and one replay of
   the kernel step captured in a CUDA graph (train/graphs.StepGraph),
   each f32 step held to an f64 step, from the seeded initial state and
   one shared pyramid (loss, every gradient, the updated state);
6. the training loop: the entry point
   `weasal_tpu_torch.train_Vaihingen3D_WeakLabel.run` on a synthetic
   Vaihingen-like tile (150 m a side, seeded, as are the datasets'
   potentials, so the plan and the spheres are the same in every run) at
   full width, on the resident input, its steps and validation batches
   replaying captured CUDA graphs: 2 epochs of 10 steps with 5
   validation batches each, then a resume from `current_chkp.tar` for a
   third, which captures anew; finite losses, one log row per real step,
   the validation lines, zero neighbor drops, every step and validation
   batch replayed, the launches per step (7 A, 12 B, 12 C, 2 D) and per
   validation batch (7 A, 12 B), each graph's warm-up step counted, the
   checkpoint equal to the trained state and the state after resume
   equal to the checkpoint; the loop's ms per step, its host breakdown,
   ms per validation batch, real points/s, the host set-up times and the
   peak device memory; then one more epoch under torch.profiler for the
   loop's device busy share, whose kernel events by name must count the
   launches that the counters add up from the replays; then, on batches
   of the loop's own resident source assembled on the card, kernels A-D
   against their plain versions (as in phases 2 and 4) and, on the first
   batch, the kernel training step held to an f64 one (as in phase 5),
   and `train_step` timed at the loop's plan, synchronized and back to
   back, beside the loop's step and phase 5's;
7. dispatch at the loop's plan, on the loop's trainer and on an eager
   one (`graphs=False`, the same configuration and datasets): 10 pairs
   of 10-batch epochs, eager and graphed in turns, and 5 pairs of
   40-batch graphed
   epochs at K = 1 and K = 10 steps a replay (ms per step per epoch,
   ending in the last flush's synchronization, with the host's share
   waiting for batches, dispatching and flushing; medians and ranges;
   batches without regions are skipped, so an epoch's last pack is a
   tail run one step a replay); one graphed
   and one eager epoch under torch.profiler (device busy share); a
   validation batch's replay beside its eager vote update; the
   entry point with `--plan_buckets 80` for one epoch with validation,
   whose small-sphere bucket's graph must replay at least once (checked
   as phase 6's runs); and the device memory with every graph of both
   graphed trainers alive.
Phases 3 and 5 end with a profile of one step, by kernel family. Checks
of agreement (each kernel against its plain version, the GEMM core's
drift, the forward and the training step against their references, and
every check of phase 6) report their readings and fail the run at its
end, so that a failing run still reads every phase; checks of shapes,
launch counts and finite values in phases 3 and 5 fail it at once. The last line is {"ok": true, "device": {...}};
the line before it holds the kernels' numbers as JSON, each kernel's
bound counting its GEMM operations at the 3xTF32 rate of the tensor
cores and the rest at the f32 rate (`f32_bound_ms`: all at the f32
rate). Imports nothing of JAX or weasal_tpu.

Kernels B and C run their three products (y @ W; g @ W^T and y^T @ g)
through one GEMM core, weasal_tpu_torch/csrc/kpconv_common.cuh: wgmma
TF32 on the tensor cores with each f32 operand split as big + small
(3xTF32, f32-grade error), 128-row tiles 32 deep fed by a cp.async ring,
and split-K with a workspace where the schedule gains from it.

Kernel A is two launches: a binning of each sphere's supports into
columns of a 2-D grid (one block per sphere, counts, scan and scatter in
shared memory), then one thread per query testing only the columns its
reach overlaps, with a margin that keeps every in-radius support, and
keeping the K best by (d2, index). Kernel D runs one warp per pooled
row, its lanes across channels, and gathers each value once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32
# operations/s outside the tensor cores and dense TF32 operations/s on the
# tensor cores. A kernel's bound counts each operation at the rate of the
# unit that runs it: the GEMM core of B and C runs 3 TF32 products for each
# f32 one (3xTF32), so its 2MNK operations count as 3 x 2MNK at the TF32
# rate; everything else runs on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# Kernel B vs its plain version: both sum in f32 but in different orders
# (gather-then-FMA per channel and a tiled GEMM against einsum + cuBLAS),
# so outputs agree to f32 rounding accumulated over Kp*K + Kp*Cin terms.
KPCONV_RTOL = 1e-4
KPCONV_ATOL_REL = 1e-5       # times max |plain output|
# The GEMM core of B and C on positive operands at the widest conv: mean
# relative error to f64 (on an H100: cuBLAS f32 -2e-10 to -1e-9; this
# core +4e-9 to +7e-9; with a stage's twelve wgmmas in one truncating
# chain, as before its chains were cut, -2.2e-7, which BatchNorm's
# gradients amplified past the f64 allowance of a loop batch's step; one
# truncating accumulator over each split of the depth -1.4e-5 for y @ W
# and -3.1e-5 for y^T @ g)
GEMM_BIAS_MAX = 3e-8
# Kernel D vs its plain version: the same shares, added to a support by
# atomics in another order
MAXPOOL_RTOL = 1e-6
MAXPOOL_ATOL_REL = 1e-6      # times max |plain dX|
# Whole forward, kernels vs plain versions on one shared pyramid
PROBS_ATOL = 1e-4
# One training step, kernels vs plain versions from one state and pyramid:
# the losses to LOSS_RTOL. The gradients at full width are ill-conditioned
# in f32 (BatchNorm on batch statistics, a saturated softmax): the plain
# f32 step itself sits up to ~1e-2 (relative L2) from an f64 step, and the
# two f32 steps' errors there differ by up to ~2x from run to run. So each
# gradient and each change of the state is held to the f64 step: the
# kernel step's L2 error may be F64_FLOOR times the f64 tensor's norm plus
# F64_RATIO times the plain f32 step's own error. The steps start from the
# seeded initial state: the training steps before them add f32 atomics in
# another order on every run (kernels C and D, index_add_), and from the
# states they end in, the outcome of this check varied from run to run,
# with an f32 FFMA GEMM in kernels B and C as much as with the 3xTF32 one.
LOSS_RTOL = 1e-5
F64_RATIO = 4.0
F64_FLOOR = 1e-3
N_BATCHES = 3
N_TRAIN_STEPS = 4
SEED = 0
# Phase 6: a synthetic training tile of LOOP_EXTENT m a side at the
# synthetic module's density, whose anchor set holds the 600-anchor label
# budget of VaihingenWLConfig; 2 epochs of 10 steps with 5 validation
# batches each, then a resume for a third
LOOP_EXTENT = 150.0
LOOP_DENSITY = 8.0
LOOP_ARGS = ("--epoch_steps", "10", "--validation_size", "5",
             "--seed", str(SEED))
# Batches of the loop's source drawn after its runs, for the kernel checks
# and the step times at its shapes
LOOP_CHECK_BATCHES = 6
# Phase 7: pairs of epochs, eager against graphed and K = 1 against K = 10,
# and the percentile of the small-sphere bucket
DISPATCH_PAIRS = 10
K_PAIRS = 5
K_EPOCH_BATCHES = 40
BUCKET_PERCENTILE = 80
# Failed checks of agreement, reported at once and failing the run at its
# end (see the module docstring); PREFIX names the shapes being checked
FAILED: list = []
PREFIX = ""


def expect(ok: bool, msg: str) -> None:
    if not ok:
        msg = PREFIX + msg
        print(f"chip_smoke: FAILED {msg}", file=sys.stderr, flush=True)
        FAILED.append(msg)


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


def host_ms(fn, calls: int = 50) -> float:
    """Mean host time of one call of fn() in ms, over `calls` calls issued
    back to back without waiting for the card: the wrapper's own work
    (checks, allocations, ctypes, launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return elapsed


def bound_ms(n_bytes: float, n_ops: float, n_gemm_ops: float = 0.0):
    """(least ms, "bytes" or "operations") of work that moves n_bytes and
    does n_ops f32 operations on the CUDA cores and n_gemm_ops f32 GEMM
    operations through the 3xTF32 core on the tensor cores."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / F32_OPS_PER_S + 3 * n_gemm_ops / TF32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def gemm_product(m: float, n: float, k: float, ms: float,
                 cublas_ms: float) -> dict:
    """One product of the GEMM core: its time, cuBLAS f32's on the same
    product, and the product's f32 bound and 3xTF32 tensor-core bound
    (3 x 2MNK / 495 TFLOP/s), M counting the valid rows."""
    n_bytes, n_ops = 4.0 * (m * k + k * n + m * n), 2.0 * m * n * k
    f32_bound, by = bound_ms(n_bytes, n_ops)
    return dict(ms=ms, cublas_ms=cublas_ms, f32_bound_ms=f32_bound,
                f32_bound_by=by,
                tf32x3_bound_ms=bound_ms(n_bytes, 0.0, n_ops)[0])


def gemm_text(label: str, p: dict) -> str:
    ms = "lost by the profiler" if p["ms"] is None else f"{p['ms']:.3f} ms"
    return (f"{label} {ms} (cuBLAS f32 {p['cublas_ms']:.3f}, "
            f"bound f32 {p['f32_bound_ms']:.4f} / 3xTF32 "
            f"{p['tf32x3_bound_ms']:.4f})")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def check_radius_search(batch, config, plan, log):
    """Kernel A against its plain version at each edge, with its time, its
    bound and the candidates per valid query that the PyTorch emulation of
    its column rule counts (`emulated_candidates_*`: the emulation's count
    of the columns it gives a query, not a count taken in the kernel;
    only its output indices are held to the kernel's). The bound is the
    least work of any exact search: the bytes of the points, masks and
    K-wide rows (a point set or mask that is both queries and supports
    counted once), and 8 f32 operations for each in-radius pair,
    untruncated (each has to be ranked); `allpairs_bound_ms` counts 8
    operations for every valid pair, the bound of an all-pairs search."""
    from weasal_tpu_torch.data.batching import search_edges
    from weasal_tpu_torch.ops.cuda.radius_search import (
        count_in_radius, radius_search, radius_search_binned_reference,
        radius_search_plain)
    rows, t_k, t_p, t_b, t_all = [], 0.0, 0.0, 0.0, 0.0
    ops_t, bytes_t, t_host = 0.0, 0.0, 0.0
    for name, lq, ls, r, k in search_edges(config, plan):
        q, s = batch.points[lq], batch.points[ls]
        qm, sm = batch.masks[lq], batch.masks[ls]
        got = radius_search(q, s, qm, sm, r, k)[0]
        again = radius_search(q, s, qm, sm, r, k)[0]
        ref = radius_search_plain(q, s, qm, sm, r, k)
        emulated, cand = radius_search_binned_reference(q, s, qm, sm, r, k)
        torch.cuda.synchronize()
        mismatch = int((got != ref).sum())
        expect(mismatch == 0, f"radius_search {name}: {mismatch} indices "
               "differ from the plain version")
        expect(torch.equal(again, got), f"radius_search {name}: a second "
               "call gave other indices")
        expect(torch.equal(emulated, ref), f"radius_search {name}: the "
               "emulated column rule differs from the plain version")
        ms = cuda_ms(lambda: radius_search(q, s, qm, sm, r, k))
        plain = cuda_ms(lambda: radius_search_plain(q, s, qm, sm, r, k))
        host = host_ms(lambda: radius_search(q, s, qm, sm, r, k))
        in_radius = float(count_in_radius(q, s, qm, sm, r))
        pairs = float((qm.sum(1).double() * sm.sum(1).double()).sum())
        n_bytes = q.numel() * 4 + qm.numel() + got.numel() * 4
        if s.data_ptr() != q.data_ptr():
            n_bytes += s.numel() * 4
        if sm.data_ptr() != qm.data_ptr():
            n_bytes += sm.numel()
        b_ms, b_by = bound_ms(n_bytes, 8.0 * in_radius)
        all_ms = bound_ms(n_bytes, 8.0 * pairs)[0]
        valid = cand[qm].double()
        t_k, t_p, t_b = t_k + ms, t_p + plain, t_b + b_ms
        t_all += all_ms
        t_host += host
        ops_t, bytes_t = ops_t + 8.0 * in_radius, bytes_t + n_bytes
        row = dict(edge=name, shape=[*q.shape[:2], s.shape[1], k], ms=ms,
                   host_ms=host, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   allpairs_bound_ms=all_ms, in_radius_pairs=in_radius,
                   valid_pairs=pairs,
                   emulated_candidates_mean=float(valid.mean()),
                   emulated_candidates_max=int(valid.max()))
        rows.append(row)
        log(f"  A {name:6s} q{list(q.shape)} s{list(s.shape)} K={k} r={r}: "
            f"equal, kernel {ms:.4f} ms (host {host:.4f} ms a call), plain "
            f"{plain:.3f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}; all pairs {all_ms:.4f}); in-radius "
            f"per query {in_radius / max(1.0, float(qm.sum())):.1f}, "
            f"emulated candidates per query mean "
            f"{row['emulated_candidates_mean']:.1f}, max "
            f"{row['emulated_candidates_max']}")
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=0.0,
                      bound_by=bound_ms(bytes_t, ops_t)[1],
                      allpairs_bound_ms=t_all, host_ms=t_host)


def check_kpconv(model, batch, log, seed):
    from weasal_tpu_torch.models.blocks import conv_inputs, kpconv_modules
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd,
                                                      kpconv_fwd_plain,
                                                      kpconv_fwd_with_y)
    gen = torch.Generator(device=batch.features.device).manual_seed(seed)
    rows, t_k, t_p, t_b, t_f32 = [], 0.0, 0.0, 0.0, 0.0
    ops_t, gemm_t, bytes_t, worst = 0.0, 0.0, 0.0, 0.0
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
        expect(torch.allclose(got, ref, rtol=KPCONV_RTOL,
                              atol=KPCONV_ATOL_REL * max(scale, 1e-30)),
               f"kpconv_fwd {name}: max abs err {err} at output scale "
               f"{scale}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: kpconv_fwd(q, s, nb, x, kp, w, ext, infl))
        plain = cuda_ms(lambda: kpconv_fwd_plain(q, s, nb, x, kp, w, ext,
                                                 infl))
        n_kp, _, cout = w.shape
        pairs = float((nb < s.shape[1]).sum())
        rows_valid = float(q_mask.sum())
        # the aggregation on the CUDA cores, y @ W on the tensor cores
        n_ops = pairs * n_kp * (14 + 2 * cin)
        gemm_ops = rows_valid * 2.0 * n_kp * cin * cout
        n_bytes = 4.0 * (q.numel() + s.numel() + nb.numel() + x.numel()
                         + kp.numel() + w.numel() + got.numel())
        b_ms, b_by = bound_ms(n_bytes, n_ops, gemm_ops)
        f32_ms = bound_ms(n_bytes, n_ops + gemm_ops)[0]
        t_k, t_p, t_b = t_k + ms, t_p + plain, t_b + b_ms
        t_f32 += f32_ms
        ops_t, gemm_t = ops_t + n_ops, gemm_t + gemm_ops
        bytes_t += n_bytes
        y = kpconv_fwd_with_y(q, s, nb, x, kp, w, ext, infl)[1]
        w2 = w.reshape(n_kp * cin, cout)
        gemm = gemm_product(
            rows_valid, cout, n_kp * cin,
            gemm_part_ms(lambda: kpconv_fwd(q, s, nb, x, kp, w, ext, infl),
                         GEMM_FAMILIES[:1])[GEMM_FAMILIES[0]],
            cuda_ms(lambda: torch.matmul(y, w2)))
        rows.append(dict(conv=name, shape=[*q.shape[:2], s.shape[1],
                                           nb.shape[2], cin, cout],
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms,
                         gemm_y_w=gemm))
        log(f"  B {name}: q{list(q.shape[:2])} Ns={s.shape[1]} "
            f"K={nb.shape[2]} {cin}->{cout}: err {err:.2e} (scale "
            f"{scale:.2e}), kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; all f32 {f32_ms:.4f}); "
            f"{gemm_text('GEMM y@W', gemm)}")
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=worst,
                      bound_by=bound_ms(bytes_t, ops_t, gemm_t)[1],
                      f32_bound_ms=t_f32)


def _expect_close(what, got, want, rtol, atol):
    err = float((got - want).abs().max())
    expect(torch.allclose(got, want, rtol=rtol, atol=atol),
           f"{what}: max abs err {err:.3e} (rtol {rtol}, atol {atol:.3e})")


def check_gemm_bias(log, seed):
    """Mean signed and rms relative error to f64 of the GEMM core's y @ W
    (kernel B) and y^T @ g (kernel C) at the main path's widest conv
    (3 x 5712 rows, K 34, 512 -> 256) on positive operands, over the
    outputs above a tenth of the largest, beside cuBLAS f32 on the same
    products. On positive operands a sum that drops low bits always the
    same way (the tensor cores' accumulation truncates) shows as a mean
    error; it must stay below GEMM_BIAS_MAX."""
    from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd_with_y
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, n, k, n_kp, cin, cout = 3, 5712, 34, 15, 512, 256
    s = torch.rand((b, n, 3), generator=gen, device=dev) * 4 - 2
    q = s + 0.05
    nb = torch.randint(0, n, (b, n, k), generator=gen, device=dev,
                       dtype=torch.int32)
    kp = torch.rand((n_kp, 3), generator=gen, device=dev) - 0.5
    x = torch.rand((b, n, cin), generator=gen, device=dev)
    w = torch.rand((n_kp, cin, cout), generator=gen, device=dev)
    g = torch.rand((b, n, cout), generator=gen, device=dev)
    out, y = kpconv_fwd_with_y(q, s, nb, x, kp, w, 1.5, "linear")
    dw = kpconv_bwd(q, s, nb, y, kp, w, g, 1.5, "linear", need_dx=False)[1]
    w2, g2 = w.reshape(-1, cout), g.reshape(-1, cout)
    result = {}
    for name, got, cublas, ref in (
            ("y@W", out.reshape(-1, cout), y @ w2,
             y.double() @ w2.double()),
            ("y^T@g", dw.reshape(-1, cout), y.t() @ g2,
             y.double().t() @ g2.double())):
        big = ref.abs() > 0.1 * ref.abs().max()
        stats = {}
        for who, t in (("core", got), ("cublas_f32", cublas)):
            rel = ((t.double() - ref) / ref)[big]
            stats[who] = dict(mean=float(rel.mean()),
                              rms=float(rel.square().mean().sqrt()))
        result[name] = stats
        log(f"  GEMM core {name} on positive operands, depth "
            f"{y.shape[1] if name == 'y@W' else y.shape[0]}: relative "
            f"error to f64 mean {stats['core']['mean']:+.2e}, rms "
            f"{stats['core']['rms']:.2e} (cuBLAS f32 "
            f"{stats['cublas_f32']['mean']:+.2e}, "
            f"{stats['cublas_f32']['rms']:.2e})")
        expect(abs(stats["core"]["mean"]) <= GEMM_BIAS_MAX,
               f"GEMM core {name}: mean relative error "
               f"{stats['core']['mean']:.2e} on positive operands (limit "
               f"{GEMM_BIAS_MAX})")
    return result


def first_conv(model):
    """Name of the KPConv whose input is the raw features: on the main
    path its backward skips dX."""
    from weasal_tpu_torch.models.blocks import kpconv_modules
    return kpconv_modules(model)[0][0]


def check_kpconv_bwd(model, batch, log, seed):
    from weasal_tpu_torch.models.blocks import conv_inputs, kpconv_modules
    from weasal_tpu_torch.ops.cuda.kpconv_bwd import (kpconv_bwd,
                                                      kpconv_bwd_plain)
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd_plain_with_y
    gen = torch.Generator(device=batch.features.device).manual_seed(seed)
    rows, t_k, t_p, t_b, t_f32 = [], 0.0, 0.0, 0.0, 0.0
    ops_t, gemm_t, bytes_t, worst = 0.0, 0.0, 0.0, 0.0
    skip_dx = first_conv(model)
    for name, conv in kpconv_modules(model):
        q, s, nb, q_mask = conv_inputs(conv.strided, conv.layer_ind, batch)
        kp, w = conv.kernel_points, conv.weights.detach()
        n_kp, cin, cout = w.shape
        x = torch.randn((s.shape[0], s.shape[1], cin), generator=gen,
                        device=s.device)
        g = torch.randn((q.shape[0], q.shape[1], cout), generator=gen,
                        device=s.device)
        ext, infl = conv.params.kp_extent, conv.params.influence
        _, y = kpconv_fwd_plain_with_y(q, s, nb, x, kp, w, ext, infl)
        # Checked with dX at every conv; timed as the main path calls it
        args = (q, s, nb, y, kp, w, g, ext, infl)
        got = kpconv_bwd(*args)
        ref = kpconv_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for what, a, b in (("dX", got[0], ref[0]), ("dW", got[1], ref[1])):
            scale = float(b.abs().max())
            _expect_close(f"kpconv_bwd {name} {what}", a, b, KPCONV_RTOL,
                          KPCONV_ATOL_REL * max(scale, 1e-30))
            errs.append(float((a - b).abs().max()))
        worst = max(worst, *errs)
        need_dx = name != skip_dx
        ms = cuda_ms(lambda: kpconv_bwd(*args, need_dx=need_dx))
        plain = cuda_ms(lambda: kpconv_bwd_plain(*args, need_dx=need_dx))
        pairs = float((nb < s.shape[1]).sum())
        rows_valid = float(q_mask.sum())
        # dW (and dr) on the tensor cores, the dX scatter on the CUDA
        # cores; inputs y, W, g and output dW; with dX also q, s, nb, kp
        # and dX
        gemm_ops = 2.0 * rows_valid * n_kp * cin * cout
        n_ops = 0.0
        n_bytes = 4.0 * (y.numel() + w.numel() + g.numel() + w.numel())
        if need_dx:
            gemm_ops *= 2
            n_ops = pairs * n_kp * (14 + 2 * cin)
            n_bytes += 4.0 * (q.numel() + s.numel() + nb.numel()
                              + kp.numel() + x.numel())
        b_ms, b_by = bound_ms(n_bytes, n_ops, gemm_ops)
        f32_ms = bound_ms(n_bytes, n_ops + gemm_ops)[0]
        t_k, t_p, t_b = t_k + ms, t_p + plain, t_b + b_ms
        t_f32 += f32_ms
        ops_t, gemm_t = ops_t + n_ops, gemm_t + gemm_ops
        bytes_t += n_bytes
        parts = gemm_part_ms(lambda: kpconv_bwd(*args, need_dx=need_dx),
                             GEMM_FAMILIES[1 if need_dx else 2:])
        g2, w2 = g.reshape(-1, cout), w.reshape(n_kp * cin, cout)
        gemms = dict(gemm_yt_g=gemm_product(
            n_kp * cin, cout, rows_valid, parts[GEMM_FAMILIES[2]],
            cuda_ms(lambda: torch.matmul(y.t(), g2))))
        if need_dx:
            gemms["gemm_g_wt"] = gemm_product(
                rows_valid, n_kp * cin, cout, parts[GEMM_FAMILIES[1]],
                cuda_ms(lambda: torch.matmul(g2, w2.t())))
        rows.append(dict(conv=name, shape=[*q.shape[:2], s.shape[1],
                                           nb.shape[2], cin, cout],
                         need_dx=need_dx, max_abs_err_dx=errs[0],
                         max_abs_err_dw=errs[1], ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms,
                         **gemms))
        texts = [gemm_text(label, gemms[key]) for key, label in
                 (("gemm_g_wt", "GEMM g@W^T"), ("gemm_yt_g", "GEMM y^T@g"))
                 if key in gemms]
        log(f"  C {name}: q{list(q.shape[:2])} Ns={s.shape[1]} "
            f"K={nb.shape[2]} {cin}->{cout}: err dX {errs[0]:.2e} dW "
            f"{errs[1]:.2e}, kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; all f32 {f32_ms:.4f})"
            f"{'' if need_dx else ', no dX'}; " + "; ".join(texts))
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=worst,
                      bound_by=bound_ms(bytes_t, ops_t, gemm_t)[1],
                      f32_bound_ms=t_f32)


def strided_pools(model):
    """(name, level, channels) of each max-pooled strided shortcut."""
    from weasal_tpu_torch.models.blocks import ResnetBottleneckBlock
    return [(n, m.layer_ind, m.in_dim) for n, m in model.named_modules()
            if isinstance(m, ResnetBottleneckBlock) and m.KPConv.strided]


def check_maxpool_bwd(model, batch, log, seed):
    from weasal_tpu_torch.ops.cuda.maxpool_bwd import (maxpool_bwd,
                                                       maxpool_bwd_plain)
    gen = torch.Generator(device=batch.features.device).manual_seed(seed)
    rows, t_k, t_p, t_b, bytes_t, worst = [], 0.0, 0.0, 0.0, 0.0, 0.0
    for name, level, c in strided_pools(model):
        nb = batch.pools[level]
        b, ns = batch.points[level].shape[:2]
        # Integer values force ties; channel 0 is never positive, so its
        # maximum is often a 0 shared with the shadow slots
        x = torch.randint(-3, 3, (b, ns, c), generator=gen,
                          device=nb.device).float()
        x[:, :, 0].clamp_(max=0.0)
        g = torch.randn((b, nb.shape[1], c), generator=gen, device=nb.device)
        got = maxpool_bwd(x, nb, g)
        ref = maxpool_bwd_plain(x, nb, g)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        _expect_close(f"maxpool_bwd {name}", got, ref, MAXPOOL_RTOL,
                      MAXPOOL_ATOL_REL * max(scale, 1e-30))
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        ms = cuda_ms(lambda: maxpool_bwd(x, nb, g))
        plain = cuda_ms(lambda: maxpool_bwd_plain(x, nb, g))
        n_bytes = 4.0 * (x.numel() + nb.numel() + g.numel() + got.numel())
        b_ms, b_by = bound_ms(n_bytes, 0.0)
        t_k, t_p, t_b = t_k + ms, t_p + plain, t_b + b_ms
        bytes_t += n_bytes
        rows.append(dict(pool=name, shape=[b, nb.shape[1], ns, nb.shape[2],
                                           c],
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"  D {name}: nb{list(nb.shape)} Ns={ns} C={c}: err {err:.2e} "
            f"(scale {scale:.2e}), kernel {ms:.3f} ms, plain {plain:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by})")
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=worst,
                      bound_by="bytes")


def clone_state(model, opt_state):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in opt_state.items()})


def replayed_step(net, opt, data, config, plan):
    """One training step on the pyramid `data` as a replay of a captured
    CUDA graph (train/graphs.StepGraph: warm-up, state restored, capture,
    replay); returns its loss. The parameters' `.grad` hold the replay's
    gradients."""
    from weasal_tpu_torch.train.graphs import StepGraph
    from weasal_tpu_torch.train.step import (class_weights, label_table,
                                             step_on_batch, step_outputs)
    dev = data.features.device
    lr_t = torch.full((), config.learning_rate, device=dev)
    # made before the capture: a host-to-device copy cannot be captured
    class_w, table = class_weights(config, dev), label_table(net, dev)

    def body(inputs, out):
        loss, acc = step_on_batch(net, opt, data, config, lr_t,
                                  class_w=class_w, table=table)
        out["stats"][0].copy_(loss)
        out["stats"][1].copy_(acc)

    example = {"placeholder": torch.zeros((1, 1))}
    graph = StepGraph("phase 5 step", body, example, 1, dev,
                      step_outputs(plan, dev, steps=1),
                      lambda: (list(net.parameters()) + list(net.buffers())
                               + list(opt.values())), graphed=True)
    graph.load(example)
    graph.run()
    if graph.graph is None or graph.replays != 1:
        raise AssertionError("phase 5: the step was not replayed")
    return graph.out["stats"][0, 0]


def compare_train_steps(model, opt_state, batch, config, log, plan=None,
                        label: str = "kernels"):
    """One step with the kernels and one on the plain versions (f32), from
    the same state and pyramid, each held to the same step on the plain
    versions in f64; with `plan`, also one replay of the kernel step
    captured in a CUDA graph, held to the f64 step as the kernel step is.
    `label` names the kernel step in the log. The model is left after the
    last f32 step. Returns the errors."""
    import copy
    import dataclasses
    from weasal_tpu_torch.train.step import step_on_batch
    from weasal_tpu_torch.utils.device import plain_ops
    state0, opt0 = clone_state(model, opt_state)
    f64 = dataclasses.replace(
        batch, points=tuple(p.double() for p in batch.points),
        features=batch.features.double(), center_pts=batch.center_pts.double(),
        cloud_lb=batch.cloud_lb.double(), region_lb=batch.region_lb.double())
    model64 = copy.deepcopy(model).double()
    runs = {}
    labels = [("f64", model64, f64, torch.float64),
              ("kernels", model, batch, None), ("plain", model, batch, None)]
    if plan is not None:
        labels.append(("graph", model, batch, None))
    for run, net, data, dtype in labels:
        net.load_state_dict({k: v.to(dtype or v.dtype)
                             if v.is_floating_point() else v
                             for k, v in state0.items()})
        opt = {k: v.to(dtype or v.dtype, copy=True) for k, v in opt0.items()}
        with contextlib.ExitStack() as stack:
            if run in ("f64", "plain"):
                stack.enter_context(plain_ops())
            if run == "graph":
                loss = replayed_step(net, opt, data, config, plan)
            else:
                loss, _ = step_on_batch(net, opt, data, config,
                                        config.learning_rate)
        grads = {n: p.grad.double() for n, p in net.named_parameters()}
        moved = {k: v.double() - state0[k].double()
                 for k, v in net.state_dict().items() if v.is_floating_point()}
        runs[run] = (float(loss), grads, moved)
    del model64
    loss_k, loss_p = runs["kernels"][0], runs["plain"][0]
    expect(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p),
           f"train step loss {loss_k} vs plain {loss_p}")
    result = dict(loss=loss_k, loss_plain=loss_p, loss_f64=runs["f64"][0])
    for who in [w for w in ("kernels", "graph") if w in runs]:
        worst = dict(rel=0.0, plain_rel=0.0, ratio=0.0, ratio_of="",
                     share=0.0, share_of="")
        for part, what in ((1, "gradient"), (2, "state change")):
            truth = runs["f64"][part]
            for name, ref in truth.items():
                norm = float(ref.norm())
                err_k = float((runs[who][part][name] - ref).norm())
                err_p = float((runs["plain"][part][name] - ref).norm())
                allowed = F64_RATIO * err_p + F64_FLOOR * norm
                about = (f"{what} {name} (L2 errors {err_k:.3e} {who}, "
                         f"{err_p:.3e} plain, norm {norm:.3e})")
                expect(err_k <= allowed,
                       f"L2 error to the f64 step too large: {about}")
                if norm > 0:
                    worst["rel"] = max(worst["rel"], err_k / norm)
                    worst["plain_rel"] = max(worst["plain_rel"],
                                             err_p / norm)
                if err_p > 0 and err_k / err_p > worst["ratio"]:
                    worst.update(ratio=err_k / err_p, ratio_of=about)
                if allowed > 0 and err_k / allowed > worst["share"]:
                    worst.update(share=err_k / allowed, share_of=about)
        log(f"train step ({label if who == 'kernels' else who}) from one "
            f"state and pyramid: loss {runs[who][0]:.7f}, {loss_p:.7f} plain, "
            f"{runs['f64'][0]:.7f} plain f64; worst relative L2 error to "
            f"f64 over gradients and state changes: {worst['rel']:.2e} "
            f"({who}), {worst['plain_rel']:.2e} plain; worst ratio "
            f"{worst['ratio']:.2f}, {worst['ratio_of']}; largest share of "
            f"the allowed error {worst['share']:.3f}, {worst['share_of']}")
        if who == "kernels":
            result.update(kernel_rel=worst.pop("rel"), **worst)
        else:
            result["graph"] = dict(loss=runs[who][0], **worst)
    if "graph" in runs:
        loss_g = runs["graph"][0]
        expect(abs(loss_g - loss_k) <= LOSS_RTOL * abs(loss_k),
               f"replayed train step loss {loss_g} vs eager {loss_k}")
    return result


def run_training(config, plan, batches, dev, counted, expected, log):
    """N_TRAIN_STEPS of `train_step` from a fresh seeded model, with the
    launch counts of `counted` set to 0 before and read after; checks the
    counts per step against `expected`, the losses, the parameters and the
    BatchNorm statistics. Returns (model, opt_state, the model's and the
    optimizer's state before the first step, launches, step ms, losses)."""
    from weasal_tpu_torch import KPFCNN_mprm, init_opt_state, train_step
    model = KPFCNN_mprm(config, tuple(range(config.num_classes)), (),
                        generator=torch.Generator().manual_seed(SEED))
    model = model.to(dev)
    opt_state = init_opt_state(model)
    start = clone_state(model, opt_state)
    state0 = start[0]
    for fn in counted:
        fn.launches = 0
    step_ms, losses, points = [], [], []
    for i in range(N_TRAIN_STEPS):
        arrays = batches[i % len(batches)]
        points.append(int(arrays["mask0"].sum()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _acc, drops = train_step(model, opt_state, arrays, config,
                                       plan, config.learning_rate,
                                       device=dev)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        if float(drops.abs().sum()) != 0.0:
            raise AssertionError("train_step reported dropped neighbors")
    launches = {fn.__name__: fn.launches for fn in counted}
    for name, per_step in expected.items():
        if launches[name] != per_step * N_TRAIN_STEPS:
            raise AssertionError(
                f"{name}: {launches[name]} launches in {N_TRAIN_STEPS} "
                f"training steps, expected {per_step} per step")
    log(f"launches: {launches} over {N_TRAIN_STEPS} training steps")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training losses {losses}")
    state = model.state_dict()
    if not all(bool(torch.isfinite(v).all()) for v in state.values()):
        raise AssertionError("non-finite parameters after training")
    stats = [k for k in state if k.endswith((".mean", ".var"))]
    frozen = [k for k in stats if torch.equal(state[k], state0[k])]
    if frozen:
        raise AssertionError(f"BatchNorm statistics did not move: {frozen}")
    steady = statistics.mean(step_ms[1:])
    log(f"train_step ms per step: {[round(v, 3) for v in step_ms]}; "
        f"losses {[round(v, 5) for v in losses]}; mean of steps 2..: "
        f"{steady:.3f} ms, real points/s "
        f"{statistics.mean(points[1:]) * 1e3 / steady:.0f}")
    return model, opt_state, start, launches, step_ms, losses


# The GEMM core's three products, named by the operand layouts <A K-major,
# B K-major> of the tile kernel; a split-K sum belongs to the tile kernel
# launched before it (see `profiled_kernels`).
GEMM_FAMILIES = ("B GEMM y@W (3xTF32)", "C GEMM g@W^T (3xTF32)",
                 "C GEMM y^T@g (3xTF32)")
SPLITK_SUM = "splitk_sum_kernel"
# Kernel families of a step's device time: (label, substrings of the
# kernel name); the first match wins, anything else is "other". The
# GEMM core comes before the generic "gemm" match.
FAMILIES = (
    ("A radius_search", ("bin_supports_kernel", "search_kernel<")),
    ("B aggregate", ("aggregate_kernel",)),
    (GEMM_FAMILIES[0], ("tf32x3_gemm_kernel<true, false,",)),
    (GEMM_FAMILIES[1], ("tf32x3_gemm_kernel<true, true,",)),
    ("C scatter_dx", ("scatter_dx_kernel",)),
    (GEMM_FAMILIES[2], ("tf32x3_gemm_kernel<false, false,",)),
    ("D maxpool_bwd", ("maxpool_bwd_kernel",)),
    ("cuBLAS/CUTLASS GEMMs", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce_kernel",)),
    ("softmax", ("SoftMax",)),
    ("gathers, scatters, index", ("gather", "scatter", "index")),
    ("sorts", ("sort", "Sort", "radix")),
    ("copies, fills", ("Memcpy", "Memset", "copy", "fill")),
    ("elementwise", ("elementwise",)),
)


def family(name: str) -> str:
    """The FAMILIES label of a kernel name."""
    return next((lab for lab, keys in FAMILIES
                 if any(k in name for k in keys)), "other")


def kernel_families(rows):
    """[(family, launches, device ms)] of profile rows, largest first."""
    sums = {}
    for name, count, ms in rows:
        label = family(name)
        n, t = sums.get(label, (0, 0.0))
        sums[label] = (n + count, t + ms)
    return sorted(((k, n, t) for k, (n, t) in sums.items()),
                  key=lambda r: -r[2])


def profiled_kernels(fn, reps: int = 1):
    """([(kernel name, launches, device ms)] largest first, wall ms) of
    `reps` calls of fn() under torch.profiler. A split-K sum launch is
    named after the GEMM core's tile kernel that ran before it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.events()
                     if str(e.device_type).endswith("CUDA")
                     and e.self_device_time_total > 0),
                    key=lambda e: e.time_range.start)
    sums, tile = {}, ""
    for e in events:
        name = e.key
        if "tf32x3_gemm_kernel" in name:
            tile = name
        elif SPLITK_SUM in name:
            name = f"{SPLITK_SUM} after {tile}"
        n, t = sums.get(name, (0, 0.0))
        sums[name] = (n + 1, t + e.self_device_time_total / 1e3)
    rows = sorted(((k, n, t) for k, (n, t) in sums.items()),
                  key=lambda r: -r[2])
    return rows, wall


def gemm_part_ms(fn, families, reps: int = 5, tries: int = 6) -> dict:
    """Device ms of one call of fn() in each of `families` (GEMM_FAMILIES
    that fn launches): the mean time of its tile launch plus, where fn
    makes one, of its split-K sum launch, over `reps` calls under
    torch.profiler after a warm-up call. On an H100 the profiler has lost
    some of a profile's kernel events, and once all GEMM kernels of one
    call in three profiles in a row: so means count only the
    launches it kept, a profile that kept no tile launch of a family is
    taken again, up to `tries` times, and a family still missing then is
    None (a measurement lost, not a kernel fault: the kernels' outputs
    are checked apart)."""
    fn()
    for _ in range(tries):
        rows, _ = profiled_kernels(fn, reps)
        kept = {}
        for name, count, ms in rows:
            key = (family(name), name.startswith(SPLITK_SUM))
            n, t = kept.get(key, (0, 0.0))
            kept[key] = (n + count, t + ms)
        if all((f, False) in kept for f in families):
            break
    return {f: (sum(t / n for (fam, _), (n, t) in kept.items() if fam == f)
                if (f, False) in kept else None)
            for f in families}


def log_gemm_sums(rows, keys, log, wide_cin: int = 256) -> dict:
    """Sums over the convs of each product's GEMM-part time, cuBLAS time
    and bounds, over all convs and over the wide ones (Cin >= wide_cin),
    each over the convs whose GEMM part the profiler kept."""
    sums = {}
    for key in keys:
        parts = [(r["shape"][4] >= wide_cin, r[key]) for r in rows
                 if key in r]
        for scope in ("all", "wide"):
            chosen = [p for wide, p in parts if scope == "all" or wide]
            lost = sum(p["ms"] is None for p in chosen)
            chosen = [p for p in chosen if p["ms"] is not None]
            sums[f"{key}_{scope}"] = {
                f: sum(p[f] for p in chosen)
                for f in ("ms", "cublas_ms", "f32_bound_ms",
                          "tf32x3_bound_ms")}
            sums[f"{key}_{scope}"]["convs_lost"] = lost
            t = sums[f"{key}_{scope}"]
            log(f"  {key} summed over {len(chosen)} convs ({scope}"
                f"{f'; {lost} lost by the profiler' if lost else ''}): "
                f"{t['ms']:.3f} ms, cuBLAS f32 {t['cublas_ms']:.3f} ms, "
                f"bound f32 {t['f32_bound_ms']:.3f} / 3xTF32 "
                f"{t['tf32x3_bound_ms']:.3f} ms")
    return sums


# Per call of each counted wrapper, the one kernel it launches exactly
# once, by name (A's binning, B's GEMM and C's dX and g @ W^T GEMM launch
# beside it; split-K sums are named after their tile kernel): the
# launches that a profile observes
OBSERVED_KERNEL = {"radius_search": "search_kernel<",
                   "kpconv_fwd": "aggregate_kernel",
                   "kpconv_bwd": "tf32x3_gemm_kernel<false, false,",
                   "maxpool_bwd": "maxpool_bwd_kernel"}
# Profiles of phase 6's graphed epoch taken before a difference between
# its kernel events and the counters fails the run (the profiler has lost
# kernel events on an H100; see `gemm_part_ms`)
PROFILE_TRIES = 3


def observed_calls(rows) -> dict:
    """Calls of each counted wrapper that profile rows (`profiled_kernels`)
    show, by OBSERVED_KERNEL."""
    return {fn: sum(n for name, n, _ in rows
                    if key in name and not name.startswith(SPLITK_SUM))
            for fn, key in OBSERVED_KERNEL.items()}


def profile_step(step, log, label: str, top: int = 12):
    """Device time of one call of `step` by kernel name (torch.profiler);
    returns (rows, busy ms, wall ms). Busy is the sum of kernel self
    times, so the idle share is 1 - busy / wall."""
    rows, wall = profiled_kernels(step)
    busy = sum(r[2] for r in rows)
    log(f"profile of one {label}: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {len(rows)} kernels")
    for name, count, ms in rows[:top]:
        log(f"  {ms:9.3f} ms {count:4d}x  {name[:90]}")
    log(f"by family ({sum(r[1] for r in rows)} launches):")
    for family, count, ms in kernel_families(rows):
        log(f"  {ms:9.3f} ms {count:5d}x  {100 * ms / busy:5.1f}%  {family}")
    return rows, busy, wall


def _log_rows(logdir):
    with open(os.path.join(logdir, "training_iteration0.txt")) as f:
        return [r.split() for r in f.readlines()[1:]]


def _same_state(got, want) -> bool:
    return set(got) == set(want) and all(
        torch.equal(got[k].cpu(), want[k].cpu()) for k in want)


def check_loop_shapes(trainer, card, log):
    """The kernels and the step at the loop's own shapes, after its runs:
    LOOP_CHECK_BATCHES batches of the loop's resident source (the
    trainer's plan, a fresh epoch's draws), each assembled on the card
    (voxel-sorted) into a pyramid on the plain versions. On the first
    pyramid A, B, C and D are held to their plain versions as in phases
    2 and 4, and the kernel training step, from the loop's seeded initial
    state, to an f64 step as in phase 5 (BatchNorm's gradients amplify a
    drift of one sign in B's outputs: the GEMM core's drift before its
    chains were cut put this batch at 1.66-1.70 of its allowance). Then
    `train_step` on the batches that have regions, as the loop calls it:
    synchronized after each step, and back to back (host clock between
    dispatches, steps 2..). Returns the kernels' sums by name and the
    step times."""
    global PREFIX
    from weasal_tpu_torch import KPFCNN_mprm, init_opt_state, train_step
    from weasal_tpu_torch.data.loader import BatchPrefetcher
    from weasal_tpu_torch.data.resident import assemble_level0_device
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.device import plain_ops
    config, plan, dev = trainer.config, trainer.plan, trainer.device
    train_ds = trainer.datasets[0]
    from weasal_tpu_torch.data.resident import ResidentBatchSource
    source = ResidentBatchSource(train_ds, plan, dev)
    extra = source.resident.arrays
    drawn = list(BatchPrefetcher(source, LOOP_CHECK_BATCHES, dev,
                                 rng=np.random.default_rng(SEED),
                                 extra_arrays=extra))
    batches = [b for b, metas in drawn
               if any(m["has_regions"] for m in metas)]

    @torch.no_grad()
    def pyramid(batch):
        t = assemble_level0_device(batch, config, plan, augment=True,
                                   spec=trainer.spec)
        with plain_ops():
            return batch_from_device_pyramid(
                t["points0"], t["mask0"], t["features"], t["labels"],
                config, plan, t["center_pts"], rotations=t["rotations"],
                cloud_lb=t["cloud_lb"], region_inds=t["region_inds"],
                region_masks=t["region_masks"],
                region_point_masks=t["region_point_masks"],
                region_lb=t["region_lb"])

    pyr = pyramid(drawn[0][0])
    log(f"phase 6: kernels vs plain versions at the loop's shapes, {plan}, "
        f"{int(pyr.masks[0].sum())} real level-0 points")
    PREFIX = "loop shapes: "
    try:
        with torch.no_grad():
            sums = dict(radius_search=check_radius_search(pyr, config, plan,
                                                          log)[1],
                        kpconv_fwd=check_kpconv(trainer.model, pyr, log,
                                                SEED)[1])
        sums["kpconv_bwd"] = check_kpconv_bwd(trainer.model, pyr, log,
                                              SEED)[1]
        sums["maxpool_bwd"] = check_maxpool_bwd(trainer.model, pyr, log,
                                                SEED)[1]
        fresh = KPFCNN_mprm(
            config, tuple(int(v) for v in train_ds.label_values),
            tuple(int(v) for v in train_ds.ignored_labels),
            generator=torch.Generator().manual_seed(0)).to(dev)
        comparison = compare_train_steps(fresh, init_opt_state(fresh), pyr,
                                         config, log,
                                         label="first loop batch, kernels")
        del fresh
        log(f"[{card}] f64 step at the loop's shapes (first batch): share "
            f"of the f64 allowance {comparison['share']:.3f} (held)")
        expect(len(batches) >= 3, f"{len(batches)} of {len(drawn)} loop "
               "batches have regions")
    finally:
        PREFIX = ""

    def step(b):
        return train_step(trainer.model, trainer.opt_state, b, config, plan,
                          trainer.lr, device=dev, class_w=trainer.class_w,
                          table=trainer.table, spec=trainer.spec)

    sync_ms = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(b)
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    stamps = []
    torch.cuda.synchronize()
    for b in batches:
        step(b)
        stamps.append(time.perf_counter())
    torch.cuda.synchronize()
    gaps = [1e3 * float(v) for v in np.diff(stamps)[1:]]
    log(f"[{card}] train_step at the loop's plan on {len(batches)} of its "
        f"batches: synchronized {[round(v, 2) for v in sync_ms]} ms (mean "
        f"of steps 2.. {statistics.mean(sync_ms[1:]):.2f}); back to back, "
        f"between dispatches {[round(v, 2) for v in gaps]} ms (mean "
        f"{statistics.mean(gaps):.2f})")
    return sums, dict(compare=comparison, sync_ms=sync_ms,
                      dispatch_gap_ms=gaps)


def run_loop(counted, per_step, per_val, card, train_step_ms, log):
    """Phase 6: the weak-label training loop through its entry point
    (`weasal_tpu_torch.train_Vaihingen3D_WeakLabel.run`) at full
    VaihingenWLConfig width on a synthetic tile: 2 epochs, then a resume
    from `current_chkp.tar` for a third. Launch counts are set to 0 just
    before each run and read just after. Checks (each fails the run at
    its end): finite losses, one log row per real step, the validation
    lines, zero neighbor drops, the launches per real step and per
    validation batch, the checkpoint equal to the trained state and the
    state after resume equal to the checkpoint. Then one more epoch of the
    resumed trainer (no validation, nothing saved) under torch.profiler:
    the loop's device time by family and its busy share. Returns the
    report and the launches of the three runs."""
    import shutil
    import tempfile
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train.trainer import ModelTrainer
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run

    work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        t0 = time.perf_counter()
        root = make_vaihingen_like_root(
            os.path.join(work, "Vaihingen3D"), extent=LOOP_EXTENT,
            density=LOOP_DENSITY, seed=SEED)
        scene_s = time.perf_counter() - t0
        logdir = os.path.join(work, "log")
        chkp = os.path.join(logdir, "checkpoints", "current_chkp.tar")
        restored = {}
        load_checkpoint = ModelTrainer.load_checkpoint

        def keep_restored(self, path, finetune=False):
            load_checkpoint(self, path, finetune)
            restored.update(
                epoch=self.epoch,
                model={k: v.detach().clone()
                       for k, v in self.model.state_dict().items()},
                opt={k: v.clone() for k, v in self.opt_state.items()})

        os.environ["WEASAL_LOOP_STATS"] = "1"
        ModelTrainer.load_checkpoint = keep_restored
        torch.cuda.reset_peak_memory_stats()
        runs, total = [], {fn.__name__: 0 for fn in counted}
        try:
            for label, extra, epochs in (
                    ("run", ("--max_epoch", "2"), 2),
                    ("resume", ("--resume", logdir, "--max_epoch", "3"), 3)):
                for fn in counted:
                    fn.launches = 0
                t0 = time.perf_counter()
                trainer = run([logdir, "--data_root", root, *LOOP_ARGS,
                               *extra])
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                launches = {fn.__name__: fn.launches for fn in counted}
                runs.append(_loop_report(label, trainer, logdir, epochs,
                                         launches, per_step, per_val,
                                         wall_s, card, log))
                for k, v in launches.items():
                    total[k] += v
                if label == "run":
                    saved = torch.load(chkp, map_location="cpu",
                                       weights_only=True)
                    expect(saved["epoch"] == 2
                           and _same_state(saved["model_state_dict"],
                                           trainer.model.state_dict())
                           and _same_state(saved["optimizer_state_dict"],
                                           trainer.opt_state),
                           "loop: current_chkp.tar differs from the "
                           "trained state")
                else:
                    expect(restored.get("epoch") == 2
                           and _same_state(restored["model"],
                                           saved["model_state_dict"])
                           and _same_state(restored["opt"],
                                           saved["optimizer_state_dict"]),
                           "loop: the state after resume differs from the "
                           "checkpoint")
                    expect(trainer.epoch == 3, "loop: resume ended at epoch "
                           f"{trainer.epoch}, expected 3")
        finally:
            ModelTrainer.load_checkpoint = load_checkpoint
            os.environ.pop("WEASAL_LOOP_STATS", None)
        peak = torch.cuda.max_memory_allocated()
        first = trainer.datasets[0]

        # The loop's device busy share: one more epoch under the profiler,
        # whose kernel events by name give the launches as the card ran
        # them, beside the counters that each replay advances by its
        # capture's counts (taken again where the profiler lost events)
        trainer.config.saving = False
        for attempt in range(PROFILE_TRIES):
            trainer.config.max_epoch = trainer.epoch + 1
            for fn in counted:
                fn.launches = 0
            warm0 = trainer.graph_counts()["train_warmups"]
            rows, _ = profiled_kernels(lambda: trainer.train(first, None))
            launches = {fn.__name__: fn.launches for fn in counted}
            observed = observed_calls(rows)
            steps = trainer.epoch_times[-1]["steps"]
            # the epoch's own clock (the audit after it runs on the host)
            wall = 1e3 * trainer.epoch_times[-1]["seconds"]
            warm = trainer.graph_counts()["train_warmups"] - warm0
            want = {k: per_step.get(k, 0) * (steps + warm) for k in launches}
            for k, v in launches.items():
                total[k] += v
            log(f"[{card}] loop profiled epoch {attempt + 1}: {steps} steps, "
                f"launches by the counters {launches}, by kernel events "
                f"{observed}")
            if observed == launches:
                break
        expect(launches == want, f"loop profiled epoch: launches {launches}, "
               f"expected {want} for {steps} steps")
        expect(observed == launches, f"loop profiled epoch: kernel events "
               f"{observed} against the counters {launches} in "
               f"{PROFILE_TRIES} profiles")
        busy = sum(r[2] for r in rows)
        families = kernel_families(rows)
        log(f"[{card}] loop epoch (graphed) under torch.profiler: {steps} "
            f"steps, wall "
            f"{wall:.1f} ms ({wall / max(steps, 1):.2f} ms per step), device "
            f"busy {busy:.1f} ms ({busy / max(steps, 1):.2f} ms per step, "
            f"{100 * busy / wall:.1f} % of the wall)")
        for fam, count, ms in families:
            log(f"[{card}]   {ms:9.3f} ms {count:5d}x  "
                f"{100 * ms / busy:5.1f}%  {fam}")
        profile = dict(steps=steps, wall_ms=wall, busy_ms=busy,
                       launches=launches, observed_launches=observed,
                       profiles=attempt + 1, families=families)
        kernel_sums, at_plan = check_loop_shapes(trainer, card, log)
        dispatch = measure_dispatch(
            trainer, root, work, counted, per_step, per_val, card, log)
        setup = dict(scene_s=scene_s, **runs[0]["setup"])
        log(f"[{card}] loop set-up (host): scene {scene_s:.2f} s, "
            + ", ".join(f"{k} {v:.2f} s" for k, v in runs[0]["setup"].items())
            + f"; after resume from the caches: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in runs[1]["setup"].items())
            + f"; training tile {first.input_labels[0].shape[0]} points, "
            f"{len(first.anchors[0])} anchors; {trainer.plan}")
        log(f"[{card}] loop peak device memory (max_memory_allocated) of "
            f"the 2 runs: {peak / 2**20:.1f} MiB")
        loop_ms = [r["step_ms_steady"] for r in runs if r["step_ms_steady"]]
        log(f"[{card}] loop ms per step (epochs after each run's first, "
            f"ending in the flush's synchronization): "
            f"{[round(v, 2) for v in loop_ms]} "
            f"beside train_step at the loop's plan: back to back "
            f"{statistics.mean(at_plan['dispatch_gap_ms']):.2f} ms between "
            f"dispatches, synchronized "
            f"{statistics.mean(at_plan['sync_ms'][1:]):.2f} ms; phase 5's "
            f"train_step {train_step_ms:.2f} ms (synchronized, steps "
            f"2-{N_TRAIN_STEPS}, phase 5's plan)")
        return dict(runs=runs, setup=setup, plan=vars(trainer.plan),
                    peak_bytes=peak, train_step_ms=train_step_ms,
                    profile=profile, kernels=kernel_sums,
                    train_step_at_plan=at_plan, dispatch=dispatch), total
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _runs_by_k(trainer) -> dict:
    """Runs of the trainer's step runners by K (steps a run)."""
    runs = {}
    for key, n in trainer.graph_counts()["train_runs_by"].items():
        k = int(key.rsplit(" x", 1)[1])
        runs[k] = runs.get(k, 0) + n
    return runs


def _dispatch_epoch(trainer, steps_per_dispatch="auto", batches: int = 10):
    """One training epoch of `batches` batches of `trainer` (no
    validation, nothing saved), graphed or eager as the trainer was made;
    returns its numbers: ms per real step over the epoch (its host clock,
    ending in the last flush's synchronization), the loop's host breakdown
    per step, the host ms between consecutive dispatches, the dispatches,
    and the steps that ran in full packs of K (the rest, a tail, run one
    a replay)."""
    cfg = trainer.config
    cfg.steps_per_dispatch = steps_per_dispatch
    cfg.epoch_steps = batches
    cfg.max_epoch = trainer.epoch + 1
    before = _runs_by_k(trainer)
    trainer.train(trainer.datasets[0], None)
    packed = sum((n - before.get(k, 0)) * k
                 for k, n in _runs_by_k(trainer).items() if k > 1)
    e = trainer.epoch_times[-1]
    n = max(e["steps"], 1)
    gaps = np.diff(e["dispatch_stamps"]) * 1e3
    return dict(graphed=trainer.graphed,
                k=steps_per_dispatch,
                batches=batches, steps=e["steps"], packed_steps=packed,
                ms_per_step=1e3 * e["seconds"] / n,
                dispatches=len(e["dispatch_stamps"]),
                gap_ms=float(np.mean(gaps)) if len(gaps) else None,
                **{f"{k}_ms_per_step": 1e3 * e[k] / n
                   for k in ("wait_batch", "dispatch", "flush")})


def _spread(values):
    """(median, min, max) of a list."""
    return (statistics.median(values), min(values), max(values))


def measure_vote(trainer, card, log, batches: int = 5):
    """Host and device ms of a validation batch's replay and of its vote
    update (`DeviceVoteAccumulator.update`, eager after the replay), over
    `batches` batches of the trainer's validation source: whether the
    update belongs in the validation graph."""
    from weasal_tpu_torch.data.loader import BatchPrefetcher
    source, runner, acc = trainer.validation_parts()
    times = {k: [] for k in ("replay_host", "replay_dev", "update_host",
                             "update_dev")}
    for pack, _ in BatchPrefetcher(source, batches, trainer.device,
                                   rng=np.random.default_rng(SEED),
                                   augment=True, pack=1):
        runner.load(pack)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks[0].record()
        runner.run()
        marks[1].record()
        t1 = time.perf_counter()
        acc.update(runner.out["probs"], runner.slots[0])
        marks[2].record()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        times["replay_host"].append(1e3 * (t1 - t0))
        times["update_host"].append(1e3 * (t2 - t1))
        times["replay_dev"].append(marks[0].elapsed_time(marks[1]))
        times["update_dev"].append(marks[1].elapsed_time(marks[2]))
    out = {k: statistics.median(v) for k, v in times.items()}
    log(f"[{card}] phase 7 validation batch (median of {batches}): replay "
        f"{out['replay_dev']:.2f} ms on the card, {out['replay_host']:.2f} "
        f"ms of host; vote update (eager) {out['update_dev']:.2f} ms on the "
        f"card, {out['update_host']:.2f} ms of host")
    return out


def measure_dispatch(trainer, root, work, counted, per_step, per_val, card,
                     log):
    """Phase 7: dispatch at the loop's plan, on the loop's (graphed)
    trainer and on an eager one made with `graphs=False` from the same
    configuration and datasets (no validation, nothing saved):
    DISPATCH_PAIRS pairs of epochs of 10 steps, eager and graphed in
    turns (which first alternating), then K_PAIRS pairs of graphed epochs
    at K = 1 and K = 10; one epoch of each trainer under torch.profiler
    for the device's busy share; then the entry point with
    `--plan_buckets 80` for one epoch with validation, which must replay
    the small bucket's graph; and the peak device memory with every graph
    of both graphed trainers alive."""
    from weasal_tpu_torch.train.trainer import ModelTrainer
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    cfg = trainer.config
    saved = (cfg.saving, cfg.steps_per_dispatch, cfg.epoch_steps)
    cfg.saving = False
    os.environ["WEASAL_LOOP_STATS"] = "1"
    eager = ModelTrainer(cfg, trainer.datasets[0], device=trainer.device,
                         graphs=False)
    eager.datasets = trainer.datasets
    eager.epoch = trainer.epoch
    by_mode = {False: eager, True: trainer}
    try:
        # First runs, untimed: the eager runners and every capture
        for graphed in (False, True):
            _dispatch_epoch(by_mode[graphed])
        _dispatch_epoch(trainer, 10, K_EPOCH_BATCHES)
        pairs = {False: [], True: []}
        for i in range(DISPATCH_PAIRS):
            for graphed in ((False, True) if i % 2 == 0 else (True, False)):
                pairs[graphed].append(_dispatch_epoch(by_mode[graphed]))
        # K: epochs long enough for full packs of 10 (batches without
        # regions are skipped, so 10 batches hold fewer than 10 steps)
        by_k = {1: [], 10: []}
        for i in range(K_PAIRS):
            for k in ((1, 10) if i % 2 == 0 else (10, 1)):
                by_k[k].append(_dispatch_epoch(trainer, k, K_EPOCH_BATCHES))
        busy = {}
        for graphed in (True, False):
            runner = by_mode[graphed]
            rows, _ = profiled_kernels(lambda: _dispatch_epoch(runner))
            b = sum(r[2] for r in rows)
            # the epoch's own clock: the plan-saturation audit after it
            # runs on the host, inside the profile but outside the epoch
            steps = runner.epoch_times[-1]["steps"]
            wall = 1e3 * runner.epoch_times[-1]["seconds"]
            busy["graphed" if graphed else "eager"] = dict(
                steps=steps, wall_ms=wall, busy_ms=b, busy_share=b / wall,
                launches_per_step=sum(r[1] for r in rows) / max(steps, 1))
    finally:
        cfg.saving, cfg.steps_per_dispatch, cfg.epoch_steps = saved
        os.environ.pop("WEASAL_LOOP_STATS", None)
    del eager, by_mode

    def summary(runs):
        return {key: _spread([r[key] for r in runs])
                for key in ("ms_per_step", "wait_batch_ms_per_step",
                            "dispatch_ms_per_step", "flush_ms_per_step",
                            "steps", "packed_steps")}

    report = dict(eager=summary(pairs[False]), graphed=summary(pairs[True]),
                  k1=summary(by_k[1]), k10=summary(by_k[10]),
                  k1_gap_ms=_spread([r["gap_ms"] for r in by_k[1]]),
                  eager_gap_ms=_spread([r["gap_ms"] for r in pairs[False]]),
                  busy=busy, pairs={str(k): v for k, v in pairs.items()},
                  by_k={str(k): v for k, v in by_k.items()})
    ratios = [e["ms_per_step"] / g["ms_per_step"]
              for e, g in zip(pairs[False], pairs[True])]
    report["eager_over_graphed"] = _spread(ratios)
    for name in ("eager", "graphed", "k1", "k10"):
        parts = ", ".join(f"{k} {v[0]:.2f} [{v[1]:.2f}-{v[2]:.2f}]"
                          for k, v in report[name].items())
        epochs = (f"{DISPATCH_PAIRS} epochs of 10 batches"
                  if name in ("eager", "graphed")
                  else f"{K_PAIRS} epochs of {K_EPOCH_BATCHES} batches")
        log(f"[{card}] phase 7 {name}: median [min-max] over {epochs}: "
            f"{parts}")
    log(f"[{card}] phase 7: eager / graphed ms per step, pair by pair: "
        f"median {report['eager_over_graphed'][0]:.2f} [min "
        f"{report['eager_over_graphed'][1]:.2f}, max "
        f"{report['eager_over_graphed'][2]:.2f}]; host ms between "
        f"dispatches: eager {report['eager_gap_ms'][0]:.2f}, graphed K=1 "
        f"{report['k1_gap_ms'][0]:.2f} (median)")
    for name, b in busy.items():
        log(f"[{card}] phase 7 {name} epoch under torch.profiler: "
            f"{b['steps']} steps, wall {b['wall_ms']:.1f} ms, device busy "
            f"{b['busy_ms']:.1f} ms ({100 * b['busy_share']:.1f} %), "
            f"{b['launches_per_step']:.0f} kernel launches a step")

    report["vote"] = measure_vote(trainer, card, log)

    # The small-sphere bucket: its own plan and graph
    log_b = os.path.join(work, "log_buckets")
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    bucketed = run([log_b, "--data_root", root, *LOOP_ARGS, "--max_epoch",
                    "1", "--validation_size", "2", "--plan_buckets",
                    str(BUCKET_PERCENTILE)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    small = bucketed.plan.small
    expect(small is not None, "phase 7: the 150 m tile gave no small-sphere "
           f"bucket at p{BUCKET_PERCENTILE}")
    bucket_rep = _loop_report("buckets", bucketed, log_b, 1, launches,
                              per_step, per_val, wall_s, card, log)
    runs_by = bucketed.graph_counts()["train_runs_by"]
    small_replays = sum(n for key, n in runs_by.items()
                        if key.startswith("small "))
    steps_by_bucket = bucketed.epoch_times[-1]["buckets"]
    expect(small_replays >= 1, f"phase 7: the small bucket's graph was "
           f"replayed {small_replays} times (steps by bucket "
           f"{steps_by_bucket})")
    log(f"[{card}] phase 7 buckets: plan {bucketed.plan}; small plan "
        f"{bucketed.plan_small and bucketed.plan_small.num_points}; steps "
        f"by bucket {steps_by_bucket}; small graph replays {small_replays}; "
        f"graphs {sorted(runs_by)}")
    report["buckets"] = dict(plan=vars(bucketed.plan), report=bucket_rep,
                             steps_by_bucket=steps_by_bucket,
                             small_replays=small_replays)
    torch.cuda.synchronize()
    report["memory"] = dict(
        peak_allocated=torch.cuda.max_memory_allocated(),
        allocated=torch.cuda.memory_allocated(),
        reserved=torch.cuda.memory_reserved(),
        graphs=len(trainer.graph_counts()["train_runs_by"]) + len(runs_by)
        + 2)
    m = report["memory"]
    log(f"[{card}] phase 7 device memory with every graph alive "
        f"({m['graphs']} graphs of two trainers): peak allocated "
        f"{m['peak_allocated'] / 2**20:.1f} MiB, allocated "
        f"{m['allocated'] / 2**20:.1f} MiB, reserved "
        f"{m['reserved'] / 2**20:.1f} MiB")
    return report


def _loop_report(label, trainer, logdir, epochs, launches, per_step,
                 per_val, wall_s, card, log):
    """Checks and numbers of one run of phase 6."""
    rows = _log_rows(logdir)
    steps = sum(e["steps"] for e in trainer.epoch_times)
    batches = sum(v["batches"] for v in trainer.val_times)
    losses = [float(r[2]) for r in rows]
    expect(len(rows) == steps > 0, f"loop {label}: {len(rows)} log rows for "
           f"{steps} real steps")
    expect(all(np.isfinite(losses)), f"loop {label}: non-finite losses")
    with open(os.path.join(logdir, "val_IoUs.txt")) as f:
        n_val = len(f.readlines())
    expect(n_val == epochs, f"loop {label}: {n_val} validation lines, "
           f"expected {epochs}")
    expect(len(trainer.epoch_drops) == len(trainer.epoch_times)
           and not any(trainer.epoch_drops),
           f"loop {label}: neighbor drops {trainer.epoch_drops}")
    counts = trainer.graph_counts()
    expect(trainer.graphed and counts["train_replayed_steps"] == steps
           and counts["eval_replays"] == batches,
           f"loop {label}: {counts} for {steps} steps and {batches} "
           "validation batches: not every step and batch was replayed")
    # Each capture's warm-up runs one step (batch) on the card
    want = {k: per_step.get(k, 0) * (steps + counts["train_warmups"])
            + per_val.get(k, 0) * (batches + counts["eval_warmups"])
            for k in launches}
    expect(launches == want, f"loop {label}: launches {launches}, "
           f"expected {want} for {steps} replayed steps and {batches} "
           f"replayed validation batches and their graphs' warm-ups "
           f"({counts})")
    # Host ms between consecutive dispatches (each of up to K steps), and
    # ms per step of the epochs after a run's first (whose clock holds
    # the graphs' captures)
    gaps = [1e3 * float(g) for e in trainer.epoch_times
            for g in np.diff(e["dispatch_stamps"])]
    later = trainer.epoch_times[1:]
    steady = (1e3 * sum(e["seconds"] for e in later)
              / max(sum(e["steps"] for e in later), 1) if later else None)
    epochs_rep = []
    for e in trainer.epoch_times:
        n = max(e["steps"], 1)
        epochs_rep.append(dict(
            epoch=e["epoch"], steps=e["steps"], ms_per_step=1e3 * e["seconds"] / n,
            points_per_s=e["points"] / e["seconds"],
            **{f"{k}_ms_per_step": 1e3 * e[k] / n
               for k in ("wait_batch", "dispatch", "flush") if k in e}))
    vals = [dict(epoch=v["epoch"], batches=v["batches"],
                 ms_per_batch=1e3 * v["seconds"] / max(v["batches"], 1))
            for v in trainer.val_times]
    train_ds = trainer.datasets[0]
    setup = dict(subsample_s=train_ds.setup_seconds["subsample"],
                 anchors_s=train_ds.setup_seconds["anchors"],
                 calibration_s=trainer.calibration_seconds)
    log(f"[{card}] loop {label}: {len(trainer.epoch_times)} epochs, {steps} "
        f"real steps, {batches} validation batches in {wall_s:.1f} s; "
        f"graphs {counts}; launches {launches}; losses {losses}; mIoU "
        f"{trainer.last_mIoU:.2f} %")
    for r in epochs_rep:
        parts = ", ".join(f"{k[:-12]} {r[k]:.2f}" for k in r
                          if k.endswith("_ms_per_step"))
        log(f"[{card}] loop {label} epoch {r['epoch']}: "
            f"{r['ms_per_step']:.2f} ms per step over the epoch"
            + (f" ({parts} ms per step)" if parts else "")
            + f", {r['points_per_s']:.0f} real points/s")
    for v in vals:
        log(f"[{card}] loop {label} validation after epoch {v['epoch']}: "
            f"{v['ms_per_batch']:.2f} ms per batch ({v['batches']} batches)")
    log(f"[{card}] loop {label}: host ms between dispatches "
        f"{[round(g, 2) for g in gaps]}; ms per step over the epochs after "
        f"the first: {steady if steady is None else round(steady, 2)}")
    return dict(label=label, steps=steps, val_batches=batches,
                launches=launches, graphs=counts, losses=losses,
                wall_s=wall_s, dispatch_gaps_ms=gaps,
                step_ms_steady=steady, epochs=epochs_rep, validation=vals,
                setup=setup, mIoU=trainer.last_mIoU)


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
    from weasal_tpu_torch import (KPFCNN_mprm, VaihingenWLConfig, eval_step,
                                  train_step)
    from weasal_tpu_torch.data.batching import calibrate_shape_plan
    from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
    from weasal_tpu_torch.data.level0 import assemble_level0
    from weasal_tpu_torch.infer import to_device
    from weasal_tpu_torch.ops.cuda import build
    from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd
    from weasal_tpu_torch.ops.cuda.maxpool_bwd import maxpool_bwd
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
    gemm_sums = log_gemm_sums(b_rows, ("gemm_y_w",), log)
    gemm_bias = check_gemm_bias(log, SEED)

    # ---- phase 3: the inference path
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
    eval_launches = {"radius_search": radius_search.launches,
                     "kpconv_fwd": kpconv_fwd.launches}
    expected = {"radius_search": 3 * plan.num_layers - 2,
                "kpconv_fwd": len(b_rows)}
    for name, per_batch in expected.items():
        if eval_launches[name] != per_batch * len(batches):
            raise AssertionError(
                f"{name}: {eval_launches[name]} launches in {len(batches)} "
                f"batches, expected {per_batch} per batch")
    log(f"launches: {eval_launches} over {len(batches)} batches")
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
    expect(diff <= PROBS_ATOL, "kernel forward disagrees with the plain one")
    prof_rows, busy, wall = profile_step(
        lambda: eval_step(model, batches[-1], config, plan, device=dev), log,
        "eval_step")

    # ---- phase 4: kernels C and D against their plain versions
    log("phase 4: backward kernels vs plain versions")
    c_rows, c_sum = check_kpconv_bwd(model, ref_batch, log, SEED)
    d_rows, d_sum = check_maxpool_bwd(model, ref_batch, log, SEED)
    gemm_sums.update(log_gemm_sums(c_rows, ("gemm_g_wt", "gemm_yt_g"), log))

    # ---- phase 5: the training path
    log(f"phase 5: train_step on the card, {N_TRAIN_STEPS} steps")
    counted = (radius_search, kpconv_fwd, kpconv_bwd, maxpool_bwd)
    expected = {"radius_search": 3 * plan.num_layers - 2,
                "kpconv_fwd": len(b_rows), "kpconv_bwd": len(b_rows),
                "maxpool_bwd": len(d_rows)}
    train_model, opt_state, start, launches, train_ms, losses = run_training(
        config, plan, batches, dev, counted, expected, log)
    t = to_device(batches[0], dev)
    with torch.no_grad():
        shared = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t["rotations"],
            cloud_lb=t["cloud_lb"], region_inds=t["region_inds"],
            region_masks=t["region_masks"],
            region_point_masks=t["region_point_masks"],
            region_lb=t["region_lb"])
    train_model.load_state_dict(start[0])
    comparison = compare_train_steps(train_model, start[1], shared, config,
                                     log, plan=plan)
    tprof_rows, tbusy, twall = profile_step(
        lambda: train_step(train_model, opt_state, batches[1], config, plan,
                           config.learning_rate, device=dev), log,
        "train_step")

    # ---- phase 6: the training loop
    log("phase 6: the weak-label training loop on the card")
    per_val = {"radius_search": expected["radius_search"],
               "kpconv_fwd": expected["kpconv_fwd"]}
    loop, loop_launches = run_loop(counted, expected, per_val, card,
                                   statistics.mean(train_ms[1:]), log)

    def main_path(name):
        return (eval_launches.get(name, 0) + launches[name]
                + loop_launches[name])

    # The largest error of each kernel at either main path's shapes
    for name, phase_sum in (("radius_search", a_sum), ("kpconv_fwd", b_sum),
                            ("kpconv_bwd", c_sum), ("maxpool_bwd", d_sum)):
        phase_sum["max_abs_err"] = max(
            phase_sum["max_abs_err"], loop["kernels"][name]["max_abs_err"])

    kernels = [
        dict(name="radius_search", route="cuda",
             source="weasal_tpu_torch/csrc/radius_search.cu",
             replaces="weasal_tpu/ops/pallas/radius_pallas.py:196",
             launches=main_path("radius_search"), library_ms=None, **a_sum),
        dict(name="kpconv_fwd", route="cuda",
             source="weasal_tpu_torch/csrc/kpconv_fwd.cu",
             replaces="weasal_tpu/ops/pallas/kpconv_banded.py:478",
             launches=main_path("kpconv_fwd"), library_ms=None, **b_sum),
        dict(name="kpconv_bwd", route="cuda",
             source="weasal_tpu_torch/csrc/kpconv_bwd.cu",
             replaces="weasal_tpu/ops/pallas/kpconv_banded.py:550",
             launches=main_path("kpconv_bwd"), library_ms=None, **c_sum),
        dict(name="maxpool_bwd", route="cuda",
             source="weasal_tpu_torch/csrc/maxpool_bwd.cu",
             replaces="weasal_tpu/ops/pallas/maxpool_banded.py:159",
             launches=main_path("maxpool_bwd"), library_ms=None, **d_sum),
    ]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, plan=vars(plan), step_ms=step_ms,
                           radius_search=a_rows, kpconv_fwd=b_rows,
                           kpconv_bwd=c_rows, maxpool_bwd=d_rows,
                           kernels=kernels, gemm_sums=gemm_sums,
                           gemm_bias=gemm_bias,
                           probs_max_diff=diff,
                           eval_launches=eval_launches,
                           train_launches=launches, train_ms=train_ms,
                           train_losses=losses, train_compare=comparison,
                           profile=dict(wall_ms=wall, busy_ms=busy,
                                        rows=prof_rows),
                           train_profile=dict(wall_ms=twall, busy_ms=tbusy,
                                              rows=tprof_rows),
                           loop=loop, loop_launches=loop_launches), f,
                      indent=1)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} checks failed", file=sys.stderr)
        return 1
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
