"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json]

Phases, in order; any failure exits non-zero:
1. setup: card name and power limit (nvidia-smi), build of the five CUDA
   sources with nvcc (sm_90a, one process per source, in parallel), the
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
   shared with shadows occur), each the same bit for bit over 3 calls
   (their dX adds in a fixed order over inverse neighbor lists), timed as
   in phase 2 with the edge's inverse lists built once as a step shares
   them, C's two GEMM parts as B's, and each dX stage's device time;
5. the training path: `train_step` for 4 steps, launch counts read around
   them, losses, parameters and BatchNorm statistics checked, then one
   step with the kernels, one on the plain versions and one replay of
   the kernel step captured in a CUDA graph (train/graphs.StepGraph),
   each f32 step held to an f64 step, from the seeded initial state and
   one shared pyramid (loss, every gradient, the updated state), with a
   witness of the kernel step's largest share (the plain step with its
   sums in the kernels' order and in seeded random orders, and kernel
   B's forward before the plain backward, each read on that tensor); the
   inverse-list builds and the row sums of one step at the shapes it
   gives them, against their plain versions (lists equal to a stable
   sort's, sums within f32 rounding of `index_add_` / `scatter_add_`,
   beside whose times they are timed), each the same over repeated
   calls; one kernel training step in a process of its own under
   `torch.use_deterministic_algorithms(True)`;
6. the training loop: the entry point
   `weasal_tpu_torch.train_Vaihingen3D_WeakLabel.run` on a synthetic
   Vaihingen-like tile (150 m a side, seeded, as are the datasets'
   potentials, so the plan and the spheres are the same in every run) at
   full width, on the resident input, its steps and validation batches
   replaying captured CUDA graphs: 2 epochs of 10 steps with 5
   validation batches each, the same two epochs again in a fresh trainer
   (every loss and the checkpoint equal bit for bit), then a resume from
   `current_chkp.tar` for a third, which captures anew; finite losses,
   one log row per real step,
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
   graphed trainers alive;
8. testing and active learning on phase 6's tile at full width
   (`run_active_learning`): the entry point with one acquisition
   (`--al_iterations 1`, a vote of 2 on the training clouds replaying
   the tester's eval graph, 100 anchors added), `test_models --on
   validation` and `--on train` (2 votes), then pseudo-label refinement;
   the ledger's growth, the larger budget of iteration 1, the launches
   per vote batch (7 A, 12 B), one vote batch's replay against the
   eager body bit for bit, the plys, pseudo labels and class weights;
   ms per vote batch and update, voted points/s, the refinement's host
   seconds, the peak memory.
Phases 3 and 5 end with a profile of one step, by kernel family. Checks
of agreement (each kernel against its plain version and against itself
on a repeat, the GEMM core's drift, the forward and the training step
against their references, and every check of phases 6-8) report their
readings and fail the run at its end, so that a failing run still reads every phase; checks of shapes,
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

Kernels C and D take their dX in two stages: each (row, slot)
contribution to a workspace, then each support's slots summed in
ascending order over its inverse neighbor list (csrc/inverse_lists.cuh),
so that no atomic decides an order; the lists of each pyramid edge are
built once a step (five launches, no host read) and shared.

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
# Kernel D vs its plain version: the same shares, added to a support in
# ascending slot order by the kernel and in index_add_'s order (atomics on
# the card) by the plain version
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
# seeded initial state: before C's and D's dX added in a fixed order, the
# training steps before them added f32 atomics in another order on every
# run, and from the states they ended in, the outcome of this check varied
# from run to run, with an f32 FFMA GEMM in kernels B and C as much as
# with the 3xTF32 one.
LOSS_RTOL = 1e-5
F64_RATIO = 4.0
F64_FLOOR = 1e-3
N_BATCHES = 3
N_TRAIN_STEPS = 4
SEED = 0
# Seeded random orders of the sums in the witness of phase 5's largest
# share (`witness_runs`)
WITNESS_RANDOM_ORDERS = 3
# Phase 6: a synthetic training tile of LOOP_EXTENT m a side at the
# synthetic module's density, whose anchor set holds the 600-anchor label
# budget of VaihingenWLConfig; 2 epochs of 10 steps with 5 validation
# batches each, then a resume for a third
LOOP_EXTENT = 150.0
LOOP_DENSITY = 8.0
LOOP_ARGS = ("--epoch_steps", "10", "--validation_size", "5",
             "--seed", str(SEED), "--al_iterations", "0")
# Batches of the loop's source drawn after its runs, for the kernel checks
# and the step times at its shapes
LOOP_CHECK_BATCHES = 6
# Phase 7: pairs of epochs, eager against graphed and K = 1 against K = 10,
# and the percentile of the small-sphere bucket
DISPATCH_PAIRS = 10
K_PAIRS = 5
K_EPOCH_BATCHES = 40
BUCKET_PERCENTILE = 80
# Phase 8: anchors added per training file by the acquisition (fewer
# where the tile has fewer unused ones)
AL_ADDED = 100
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


def expect_repeats(what, fn, calls: int = 3):
    """fn()'s tensors are the same bit for bit over `calls` calls (the
    fixed-order sums of C's and D's dX, the row sums and the inverse
    lists: no atomics decide an order)."""
    first = [t.clone() for t in fn() if t is not None]
    same = True
    for _ in range(calls - 1):
        again = [t for t in fn() if t is not None]
        same &= all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(first, again))
    torch.cuda.synchronize()
    expect(same, f"{what}: {calls} calls on the same inputs differ")
    return same


def stage_ms(fn, names, reps: int = 5) -> dict:
    """Mean device ms a call of fn() of each kernel whose name contains
    one of `names` (torch.profiler; None where the profiler kept none)."""
    fn()
    rows, _ = profiled_kernels(fn, reps)
    return {key: (sum(t for name, _, t in rows if key in name) / reps
                  if any(key in name for name, _, _ in rows) else None)
            for key in names}


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
    from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
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
        # the edge's inverse lists, built once as the step shares them
        inv = LazyInverse(nb, s.shape[1])
        inv.get()

        def kernel(need_dx=True):
            return kpconv_bwd(*args, need_dx=need_dx, inverse=inv)

        got = kernel()
        ref = kpconv_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for what, a, b in (("dX", got[0], ref[0]), ("dW", got[1], ref[1])):
            scale = float(b.abs().max())
            _expect_close(f"kpconv_bwd {name} {what}", a, b, KPCONV_RTOL,
                          KPCONV_ATOL_REL * max(scale, 1e-30))
            errs.append(float((a - b).abs().max()))
        worst = max(worst, *errs)
        repeats = expect_repeats(f"kpconv_bwd {name}", kernel)
        need_dx = name != skip_dx
        ms = cuda_ms(lambda: kernel(need_dx))
        dx_stages = stage_ms(kernel, DX_STAGES["C"]) if need_dx else {}
        plain = cuda_ms(lambda: kpconv_bwd_plain(*args, need_dx=need_dx))
        pairs = float((nb < s.shape[1]).sum())
        rows_valid = float(q_mask.sum())
        # dW (and dr) on the tensor cores, dX's contributions on the CUDA
        # cores; inputs y, W, g and output dW; with dX also q, s, nb, kp
        # and dX (its workspace is the kernel's own traffic)
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
        parts = gemm_part_ms(lambda: kernel(need_dx),
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
                         max_abs_err_dw=errs[1], repeats=repeats,
                         dx_stage_ms=dx_stages, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by, f32_bound_ms=f32_ms,
                         **gemms))
        texts = [gemm_text(label, gemms[key]) for key, label in
                 (("gemm_g_wt", "GEMM g@W^T"), ("gemm_yt_g", "GEMM y^T@g"))
                 if key in gemms]
        log(f"  C {name}: q{list(q.shape[:2])} Ns={s.shape[1]} "
            f"K={nb.shape[2]} {cin}->{cout}: err dX {errs[0]:.2e} dW "
            f"{errs[1]:.2e}, kernel {ms:.3f} ms, plain {plain:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}; all f32 {f32_ms:.4f})"
            f"{'' if need_dx else ', no dX'}; " + "; ".join(texts)
            + f"; dX stages {stage_text(dx_stages)}; repeats {repeats}")
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=worst,
                      bound_by=bound_ms(bytes_t, ops_t, gemm_t)[1],
                      f32_bound_ms=t_f32,
                      dx_stage_ms=stage_sums(rows, DX_STAGES["C"]))


# The two stages of C's and D's dX by kernel name: the workspace of each
# slot's contribution, then the fixed-order sums over inverse lists
DX_STAGES = {"C": ("dx_contrib_kernel", "inverse_sum_kernel"),
             "D": ("maxpool_bwd_kernel", "inverse_sum_kernel")}


def stage_text(stages: dict) -> str:
    return ", ".join(f"{k.split('_kernel')[0]} "
                     + ("lost" if v is None else f"{v:.3f} ms")
                     for k, v in stages.items()) or "none"


def stage_sums(rows, names) -> dict:
    """Each dX stage's ms summed over a step's calls (rows with dX)."""
    return {k: sum(r["dx_stage_ms"].get(k) or 0.0 for r in rows)
            for k in names}


def strided_pools(model):
    """(name, level, channels) of each max-pooled strided shortcut."""
    from weasal_tpu_torch.models.blocks import ResnetBottleneckBlock
    return [(n, m.layer_ind, m.in_dim) for n, m in model.named_modules()
            if isinstance(m, ResnetBottleneckBlock) and m.KPConv.strided]


def check_maxpool_bwd(model, batch, log, seed):
    from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
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
        inv = LazyInverse(nb, ns)          # built once, as the step does
        inv.get()

        def kernel():
            return maxpool_bwd(x, nb, g, inverse=inv)

        got = kernel()
        ref = maxpool_bwd_plain(x, nb, g)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        _expect_close(f"maxpool_bwd {name}", got, ref, MAXPOOL_RTOL,
                      MAXPOOL_ATOL_REL * max(scale, 1e-30))
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        repeats = expect_repeats(f"maxpool_bwd {name}",
                                 lambda: (kernel(),))
        ms = cuda_ms(kernel)
        plain = cuda_ms(lambda: maxpool_bwd_plain(x, nb, g))
        dx_stages = stage_ms(kernel, DX_STAGES["D"])
        n_bytes = 4.0 * (x.numel() + nb.numel() + g.numel() + got.numel())
        b_ms, b_by = bound_ms(n_bytes, 0.0)
        t_k, t_p, t_b = t_k + ms, t_p + plain, t_b + b_ms
        bytes_t += n_bytes
        rows.append(dict(pool=name, shape=[b, nb.shape[1], ns, nb.shape[2],
                                           c],
                         max_abs_err=err, repeats=repeats,
                         dx_stage_ms=dx_stages, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"  D {name}: nb{list(nb.shape)} Ns={ns} C={c}: err {err:.2e} "
            f"(scale {scale:.2e}), kernel {ms:.3f} ms, plain {plain:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}); dX stages "
            f"{stage_text(dx_stages)}; repeats {repeats}")
    return rows, dict(ms=t_k, plain_ms=t_p, bound_ms=t_b, max_abs_err=worst,
                      bound_by="bytes",
                      dx_stage_ms=stage_sums(rows, DX_STAGES["D"]))


def record_inverse_calls(step):
    """Run step() once, recording the arguments of every call of the
    inverse-list build, the row sums and the voxel run sums it makes (the
    standalone ones: C and D run their own sums inside their launches);
    returns [(kind, args)]."""
    from weasal_tpu_torch.ops.cuda import inverse_lists as il
    calls = []
    originals = (il.build_inverse_lists, il.inverse_sum, il.run_sums)

    def build(inds, ns, k=None):
        calls.append(("build", (inds.clone(), ns, k)))
        return originals[0](inds, ns, k)

    def row_sum(src, inv, rows):
        calls.append(("sum", (src.clone(), il.InverseLists(
            inv.offsets.clone(), inv.entries.clone()), rows)))
        return originals[1](src, inv, rows)

    def runs(src, seg, n_out):
        calls.append(("runs", (src.clone(), seg.clone(), n_out)))
        return originals[2](src, seg, n_out)

    # the wrappers count their launches through their module names (and
    # the callers find them there), so the stand-ins carry the counters
    # while they are in place
    build.launches = originals[0].launches
    row_sum.launches = originals[1].launches
    il.build_inverse_lists, il.inverse_sum, il.run_sums = \
        build, row_sum, runs
    try:
        step()
        torch.cuda.synchronize()
    finally:
        il.build_inverse_lists, il.inverse_sum, il.run_sums = originals
        originals[0].launches = build.launches
        originals[1].launches = row_sum.launches
    return calls


def check_inverse_lists(calls, log):
    """The inverse-list build and the fixed-order row sums at the shapes
    one training step gives them (recorded by `record_inverse_calls`),
    against their plain versions: the build's lists equal the plain
    stable sort's; the row sums (and the voxel sums of the pyramid's
    subsample) within f32 rounding of `index_add_` / `scatter_add_`
    (MAXPOOL_RTOL, MAXPOOL_ATOL_REL); every call repeats bit for bit.
    Times: kernel, plain version, and for the sums one PyTorch call that
    computes the same function (`index_add_` of the source rows into
    their destinations, `scatter_add_` for the voxel sums; on CUDA both
    add with atomics in no fixed order). Returns the sums of both
    wrappers."""
    from weasal_tpu_torch.ops.cuda import inverse_lists as il
    sums = {n: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                    library_ms=0.0, calls=0, repeats=True)
            for n in ("build_inverse_lists", "inverse_sum")}
    for kind, args in calls:
        if kind == "build":
            inds, ns, k = args
            k = inds.shape[2] if k is None else k

            def kernel():
                return il.build_inverse_lists(inds, ns, k)

            def plain():
                return il.build_inverse_lists_plain(inds, ns, k)

            got, ref = kernel(), plain()
            total = int(ref.offsets[-1])
            ok = torch.equal(got.offsets, ref.offsets) and torch.equal(
                got.entries[:total], ref.entries[:total])
            expect(ok, f"build_inverse_lists {list(inds.shape)} k={k}: "
                   "lists differ from the stable sort's")
            err = 0.0 if ok else float("inf")
            rep = expect_repeats("build_inverse_lists", lambda: (
                kernel().offsets, kernel().entries[:total]), calls=2)
            n_bytes = 4.0 * (inds[..., :k].numel() + ref.offsets.numel()
                             + total)
            name, lib_ms = "build_inverse_lists", None
            shape = f"nb{list(inds.shape)} k={k} Ns={ns}: {total} entries"
        else:
            if kind == "sum":
                src, inv, rows = args

                def kernel():
                    return il.inverse_sum(src, inv, rows)

                def plain():
                    return il.inverse_sum_plain(src, inv, rows)

                total = int(inv.offsets[-1])
                c = src.shape[1]
                # each source row's destination (rows: not in any list)
                tgt = torch.full((src.shape[0],), rows, dtype=torch.int64,
                                 device=src.device)
                tgt[inv.entries[:total].long()] = il.segment_ids(
                    inv.offsets, total)

                def library():
                    out = torch.zeros((rows + 1, c), device=src.device)
                    return out.index_add_(0, tgt, src)
                n_bytes = 4.0 * (src.numel() + rows * c + rows + 1 + total)
                shape = f"src{list(src.shape)} -> {rows} rows"
            else:
                src, seg, n_out = args

                def kernel():
                    return il.run_sums(src, seg, n_out)

                def plain():
                    return il.run_sums_plain(src, seg, n_out)

                where = seg.clamp(max=n_out)[..., None].expand_as(src)

                def library():
                    out = torch.zeros((src.shape[0], n_out + 1,
                                       src.shape[2]), device=src.device)
                    return out.scatter_add_(1, where, src)
                n_bytes = 4.0 * (src.numel() + seg.numel() * 2
                                 + src.shape[0] * n_out * (src.shape[2] + 1))
                shape = f"voxel sums src{list(src.shape)} -> {n_out} voxels"
            got, ref = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = 0.0
            for a, b in zip(got, ref):
                scale = float(b.abs().max()) if b.numel() else 0.0
                _expect_close(f"inverse_sum {shape}", a, b, MAXPOOL_RTOL,
                              MAXPOOL_ATOL_REL * max(scale, 1e-30))
                err = max(err, float((a - b).abs().max()) if b.numel()
                          else 0.0)
            rep = expect_repeats(f"inverse_sum {shape}", lambda: (
                kernel() if kind == "runs" else (kernel(),)))
            name, lib_ms = "inverse_sum", cuda_ms(library)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        b_ms = bound_ms(n_bytes, 0.0)[0]
        t = sums[name]
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["bound_ms"] += b_ms
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["calls"] += 1
        t["repeats"] &= bool(rep)
        if lib_ms is not None:
            t["library_ms"] += lib_ms
        log(f"  {name} {shape}: err {err:.2e}, kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms" + ("" if lib_ms is None else
                                    f", library {lib_ms:.3f} ms")
            + f", bound {b_ms:.4f} ms (bytes); repeats {rep}")
    for name, t in sums.items():
        t["bound_by"] = "bytes"
        if name == "build_inverse_lists":
            t["library_ms"] = None
        log(f"  {name}: {t['calls']} calls a training step: kernel "
            f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms, library {t['library_ms']}")
    return sums


def run_deterministic_step(log, timeout: int = 600) -> dict:
    """weasal_tpu_torch.tools.deterministic_step in a process of its own:
    one eager kernel training step at phase 5's width under
    `torch.use_deterministic_algorithms(True)` (PyTorch raises at any op
    it knows to be non-deterministic on CUDA), CUBLAS_WORKSPACE_CONFIG
    :4096:8. Its failure fails the run at its end."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "weasal_tpu_torch.tools.deterministic_step",
         "--seed", str(SEED)], env=env, capture_output=True, text=True,
        timeout=timeout, cwd=os.path.dirname(os.path.abspath(__file__)))
    ok = out.returncode == 0 and "deterministic step: loss" in out.stdout
    line = (out.stdout.strip().splitlines() or [""])[-1][:200]
    log(f"deterministic-algorithms step (own process, "
        f"{time.perf_counter() - t0:.1f} s): "
        + (line if ok else f"FAILED rc {out.returncode}: "
           f"{out.stderr.strip()[-600:]}"))
    expect(ok, "a kernel training step under "
           "torch.use_deterministic_algorithms(True) failed")
    return dict(ok=ok, line=line)


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


@contextlib.contextmanager
def swapped(changes):
    """Sets each (module, name, value) of `changes` for the block's
    duration."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in changes]
    for mod, name, value in changes:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def ordered_scatter(seed=None):
    """A plain `scatter_rows` (ops/cuda/inverse_lists) that adds each
    support's terms one after another from 0.0: in ascending slot order,
    the order of kernels C and D and of the row sums, when seed is None,
    else in a seeded random order of each support's list."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import (
        build_inverse_lists_plain)

    def scatter(values, inds, ns):
        b, _, k, d = values.shape
        dev = values.device
        inv = build_inverse_lists_plain(inds, ns, k)
        offs = inv.offsets.long()
        lens = offs[1:] - offs[:-1]
        width = int(lens.max()) if lens.numel() else 0
        pos = torch.arange(width, device=dev)
        valid = pos[None] < lens[:, None]
        order = pos.expand(lens.shape[0], width)
        if seed is not None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            keys = torch.rand(valid.shape, generator=gen, device=dev)
            order = keys.masked_fill(~valid, 2.0).argsort(dim=1)
        ent = inv.entries.long()
        slot = (offs[:-1, None] + order).clamp(max=max(ent.numel() - 1, 0))
        src = values.reshape(-1, d)
        out = torch.zeros((lens.shape[0], d), dtype=values.dtype,
                          device=dev)
        for j in range(width):
            term = src.index_select(0, ent[slot[:, j]])
            out = out + torch.where(valid[:, j, None], term,
                                    torch.zeros_like(term))
        return out.reshape(b, ns, d)
    return scatter


def witness_runs() -> dict:
    """The witness of the f64 check's largest share: runs of one step by
    name, each a (plain versions?, attribute swaps) pair. The plain
    versions with every scatter-add summed in the kernels' order and in
    WITNESS_RANDOM_ORDERS seeded random orders (code that shares only
    that order with the kernels), and kernel B's forward before the
    plain backward (index_add_, in the card's atomic order)."""
    import importlib
    from weasal_tpu_torch.ops import kpconv as ops_mod
    inv_mod = importlib.import_module(
        "weasal_tpu_torch.ops.cuda.inverse_lists")
    c_mod = importlib.import_module("weasal_tpu_torch.ops.cuda.kpconv_bwd")
    d_mod = importlib.import_module("weasal_tpu_torch.ops.cuda.maxpool_bwd")

    def sums(fn):
        return [(mod, "scatter_rows", fn) for mod in (inv_mod, c_mod, d_mod)]

    runs = {"plain, kernels' sum order": (True, sums(ordered_scatter()))}
    for i in range(1, WITNESS_RANDOM_ORDERS + 1):
        runs[f"plain, random sum order {i}"] = (
            True, sums(ordered_scatter(seed=i)))
    runs["kernel B, plain backward"] = (False, [
        (ops_mod, "kpconv_bwd",
         lambda *a, need_dx, inverse: c_mod.kpconv_bwd_plain(
             *a, need_dx=need_dx)),
        (ops_mod, "maxpool_bwd",
         lambda x, nb, g, inverse: d_mod.maxpool_bwd_plain(x, nb, g)),
        (inv_mod, "inverse_sum", inv_mod.inverse_sum_plain)])
    return runs


def compare_train_steps(model, opt_state, batch, config, log, plan=None,
                        label: str = "kernels", witness: bool = False):
    """One step with the kernels and one on the plain versions (f32), from
    the same state and pyramid, each held to the same step on the plain
    versions in f64; with `plan`, also one replay of the kernel step
    captured in a CUDA graph, held to the f64 step as the kernel step is;
    with `witness`, the runs of `witness_runs`, each read on the tensor
    of the kernel step's largest share (not held). `label` names the
    kernel step in the log. The model is left after the last f32 step.
    Returns the errors."""
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
    extra = witness_runs() if witness else {}
    labels += [(run, model, batch, None) for run in extra]
    for run, net, data, dtype in labels:
        net.load_state_dict({k: v.to(dtype or v.dtype)
                             if v.is_floating_point() else v
                             for k, v in state0.items()})
        opt = {k: v.to(dtype or v.dtype, copy=True) for k, v in opt0.items()}
        with contextlib.ExitStack() as stack:
            if run in ("f64", "plain") or extra.get(run, (False,))[0]:
                stack.enter_context(plain_ops())
            if run in extra:
                stack.enter_context(swapped(extra[run][1]))
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

    def allowance(part, name):
        ref = runs["f64"][part][name]
        err_p = float((runs["plain"][part][name] - ref).norm())
        return F64_RATIO * err_p + F64_FLOOR * float(ref.norm())

    for who in [w for w in ("kernels", "graph") if w in runs]:
        worst = dict(rel=0.0, plain_rel=0.0, ratio=0.0, ratio_of="",
                     share=0.0, share_of="", share_key=None)
        for part, what in ((1, "gradient"), (2, "state change")):
            truth = runs["f64"][part]
            for name, ref in truth.items():
                norm = float(ref.norm())
                err_k = float((runs[who][part][name] - ref).norm())
                err_p = float((runs["plain"][part][name] - ref).norm())
                allowed = allowance(part, name)
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
                    worst.update(share=err_k / allowed, share_of=about,
                                 share_key=(part, name))
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
    key = result.get("share_key")
    if extra and key is not None:
        part, name = key
        ref, allowed = runs["f64"][part][name], allowance(part, name)
        result["witness"] = {}
        for run in extra:
            err = float((runs[run][part][name] - ref).norm())
            own = max((float((runs[run][p][n] - t).norm()) / a, n)
                      for p in (1, 2) for n, t in runs["f64"][p].items()
                      for a in [allowance(p, n)] if a > 0)
            result["witness"][run] = dict(err=err, share=err / allowed,
                                          own_share=own[0], own_of=own[1])
            log(f"witness of the largest share ({name}): {run}: L2 error "
                f"{err:.3e}, share {err / allowed:.3f}; its own largest "
                f"share {own[0]:.3f}, {own[1]}")
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
    ("C dX contributions", ("dx_contrib_kernel",)),
    ("row sums (C, D dX; gathers; voxels)", ("inverse_sum_kernel",)),
    ("inverse lists", ("inverse_count_kernel", "inverse_scan_kernel",
                       "inverse_fill_kernel", "inverse_sort_kernel")),
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
# launches that a profile observes. The row sums' kernel also runs inside
# C (once per call with dX, beside dx_contrib_kernel) and D (once per
# call): its own calls are its events less those.
OBSERVED_KERNEL = {"radius_search": "search_kernel<",
                   "kpconv_fwd": "aggregate_kernel",
                   "kpconv_bwd": "tf32x3_gemm_kernel<false, false,",
                   "maxpool_bwd": "maxpool_bwd_kernel",
                   "build_inverse_lists": "inverse_scan_kernel",
                   "inverse_sum": "inverse_sum_kernel"}
# Profiles of phase 6's graphed epoch taken before a difference between
# its kernel events and the counters fails the run (the profiler has lost
# kernel events on an H100; see `gemm_part_ms`)
PROFILE_TRIES = 3


def observed_calls(rows) -> dict:
    """Calls of each counted wrapper that profile rows (`profiled_kernels`)
    show, by OBSERVED_KERNEL."""
    def events(key):
        return sum(n for name, n, _ in rows
                   if key in name and not name.startswith(SPLITK_SUM))
    out = {fn: events(key) for fn, key in OBSERVED_KERNEL.items()}
    out["inverse_sum"] -= (events("dx_contrib_kernel")
                           + events("maxpool_bwd_kernel"))
    return out


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


def run_loop(counted, per_step, per_val, card, train_step_ms, work, log):
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
    the loop's device time by family and its busy share. The tile and the
    logs go into `work`. Returns the report, the launches of its runs and
    the tile's data root."""
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train.trainer import ModelTrainer
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run

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

    # Every loss at full precision, as each flush fetches it
    losses = {}
    flush_log = ModelTrainer._flush_log

    def keep_losses(self, pending, log_file, al_iteration):
        losses.setdefault(self.config.saving_path, []).extend(
            float(p[2]) for p in pending)
        return flush_log(self, pending, log_file, al_iteration)

    os.environ["WEASAL_LOOP_STATS"] = "1"
    ModelTrainer.load_checkpoint = keep_restored
    ModelTrainer._flush_log = keep_losses
    torch.cuda.reset_peak_memory_stats()
    runs, total = [], {fn.__name__: 0 for fn in counted}
    repeat_dir = os.path.join(work, "log_repeat")
    try:
        # "repeat": the first run's two seeded epochs again, in a
        # fresh trainer: its losses and checkpoint must be bit equal
        for label, out, extra, epochs in (
                ("run", logdir, ("--max_epoch", "2"), 2),
                ("repeat", repeat_dir, ("--max_epoch", "2"), 2),
                ("resume", logdir,
                 ("--resume", logdir, "--max_epoch", "3"), 3)):
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            trainer = run([out, "--data_root", root, *LOOP_ARGS,
                           *extra])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            runs.append(_loop_report(label, trainer, out, epochs,
                                     launches, per_step, per_val,
                                     wall_s, card, log))
            if label == "repeat":
                repeat = compare_repeat(
                    losses.get(logdir, []), losses.get(repeat_dir, []),
                    chkp, os.path.join(repeat_dir, "checkpoints",
                                       "current_chkp.tar"), card, log)
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
            elif label == "resume":
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
        ModelTrainer._flush_log = flush_log
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
        + ", ".join(f"{k} {v:.2f} s" for k, v in runs[2]["setup"].items())
        + f"; training tile {first.input_labels[0].shape[0]} points, "
        f"{len(first.anchors[0])} anchors; {trainer.plan}")
    log(f"[{card}] loop peak device memory (max_memory_allocated) of "
        f"the 3 runs: {peak / 2**20:.1f} MiB")
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
    return dict(runs=runs, repeat=repeat, setup=setup,
                plan=vars(trainer.plan),
                peak_bytes=peak, train_step_ms=train_step_ms,
                profile=profile, kernels=kernel_sums,
                train_step_at_plan=at_plan, dispatch=dispatch), total, root


def compare_repeat(losses_a, losses_b, chkp_a, chkp_b, card, log):
    """Two seeded runs of the loop's two epochs, each in a fresh trainer:
    every loss (the flushes' f32 values) and the checkpoint's payload
    (epoch, parameters, BatchNorm statistics, momentum; the saving path
    names the run's own directory) equal bit for bit."""
    a = torch.load(chkp_a, map_location="cpu", weights_only=True)
    b = torch.load(chkp_b, map_location="cpu", weights_only=True)
    same_losses = len(losses_a) == len(losses_b) > 0 and all(
        x == y for x, y in zip(losses_a, losses_b))
    same_state = (a["epoch"] == b["epoch"]
                  and _same_state(a["model_state_dict"],
                                  b["model_state_dict"])
                  and _same_state(a["optimizer_state_dict"],
                                  b["optimizer_state_dict"]))
    differ = [k for k in a["model_state_dict"]
              if not torch.equal(a["model_state_dict"][k],
                                 b["model_state_dict"][k])]
    log(f"[{card}] loop repeat: {len(losses_b)} losses "
        f"{'bit-equal' if same_losses else 'DIFFER'} to the first run's; "
        f"checkpoint {'bit-equal' if same_state else 'DIFFERS'}"
        + (f" ({len(differ)} tensors, e.g. {differ[:3]})" if differ else ""))
    expect(same_losses, "loop repeat: the losses of two seeded runs differ: "
           f"{losses_a} against {losses_b}")
    expect(same_state, "loop repeat: the checkpoints of two seeded runs "
           "differ")
    return dict(losses_equal=same_losses, checkpoint_equal=same_state,
                steps=len(losses_b), differing_tensors=differ)


def run_active_learning(root, work, counted, per_step, per_val, card, log):
    """Phase 8: testing and weak-label active learning on phase 6's tile
    at full width. The entry point with one acquisition (`--al_iterations
    1 --epoch_schedule 1,1`, 10 steps and 5 validation batches an epoch,
    2 votes on the training clouds, AL_ADDED anchors, or what the tile
    has left); then `test_models --on validation` and `--on train` (2
    votes each, 200 batches an epoch as the script sets), and the
    pseudo-label refinement. Checks (each fails the run at its end): the
    ledger grows by exactly the added anchors, none reused; iteration 1
    trains on the larger budget; every vote batch replays its graph, with
    7 A and 12 B launches a batch (counted as phase 6 counts them); one
    vote batch's replay equals the eager `eval_body` bit for bit; the
    plys, the pseudo labels (one a subsampled point) and finite class
    weights are written. Reports ms per vote batch (replay, on the card)
    and per vote update, each vote pass's seconds and voted points/s, the
    refinement's host seconds and the peak device memory. Returns the
    report and the launches."""
    import pickle
    from weasal_tpu_torch.data.loader import BatchPrefetcher
    from weasal_tpu_torch.infer import eval_body
    from weasal_tpu_torch.pseudoLabel_refinement import main as refine
    from weasal_tpu_torch.test_models import main as test_models
    from weasal_tpu_torch.train.tester import ModelTester
    from weasal_tpu_torch.train.trainer import ModelTrainer
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    from weasal_tpu_torch.utils.ply import read_ply

    log_name = "Log_phase8"
    logdir = os.path.join(work, "results", "WeakLabel", log_name)
    tree = os.path.join(root, "input_0.240_torch")
    cloud = "Vaihingen3D_Training"
    with open(os.path.join(tree, f"{cloud}_anchors_reduced.pkl"),
              "rb") as f:
        n_anchors = len(pickle.load(f)[1])
    with open(os.path.join(tree, f"{cloud}_subsampled_anchors.pkl"),
              "rb") as f:
        budget = len(pickle.load(f))
    added = min(AL_ADDED, n_anchors - budget)
    log(f"phase 8: {n_anchors} anchors in the training tile, {budget} in "
        f"the budget, {added} to add per acquisition")
    ledgers, trainers = {}, []
    extend, train = ModelTester._extend_anchor_ledger, ModelTrainer.train

    def ledger():
        with open(os.path.join(tree, f"{cloud}_subsampled_anchors.pkl"),
                  "rb") as f:
            return [int(v) for v in pickle.load(f)]

    def keep_ledgers(self, dataset, all_probs, all_pseudo_lbs):
        ledgers["before"] = ledger()
        extend(self, dataset, all_probs, all_pseudo_lbs)
        ledgers["after"] = ledger()

    def keep_trainer(self, *args, **kwargs):
        trainers.append(self)
        return train(self, *args, **kwargs)

    def vote_launches(tester):
        graph = tester._eval_graph
        batches = sum(v["batches"] for v in tester.vote_times)
        expect(tester.graphed and graph.replays == batches,
               f"phase 8: {graph.replays} vote replays for {batches} vote "
               "batches")
        return {k: per_val.get(k, 0) * (batches + graph.warmup_steps)
                for k in per_val}

    def add(total, part):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v

    cwd = os.getcwd()
    os.chdir(work)
    torch.cuda.reset_peak_memory_stats()
    report, total = {}, {fn.__name__: 0 for fn in counted}
    try:
        # 1. the entry point: train, vote on the training clouds, acquire,
        # train again
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        ModelTester._extend_anchor_ledger = keep_ledgers
        ModelTrainer.train = keep_trainer
        try:
            last = run([logdir, "--data_root", root, "--al_iterations", "1",
                        "--epoch_schedule", "1,1", "--epoch_steps", "10",
                        "--validation_size", "5", "--al_votes", "2",
                        "--added_labels", str(added), "--seed", str(SEED)])
        finally:
            ModelTester._extend_anchor_ledger = extend
            ModelTrainer.train = train
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        add(total, launches)
        want = {}
        for trainer in trainers:
            counts = trainer.graph_counts()
            steps = sum(e["steps"] for e in trainer.epoch_times)
            batches = sum(v["batches"] for v in trainer.val_times)
            expect(counts["train_replayed_steps"] == steps
                   and counts["eval_replays"] == batches,
                   f"phase 8: training {counts} for {steps} steps and "
                   f"{batches} validation batches")
            add(want, {k: per_step.get(k, 0)
                       * (steps + counts["train_warmups"])
                       + per_val.get(k, 0)
                       * (batches + counts["eval_warmups"])
                       for k in launches})
        tester = last.testers[0] if getattr(last, "testers", None) else None
        expect(tester is not None and len(trainers) == 2,
               f"phase 8: {len(trainers)} trainings and "
               f"{0 if tester is None else 1} acquisition")
        add(want, vote_launches(tester))
        expect(launches == want, f"phase 8 entry point: launches "
               f"{launches}, expected {want}")
        before, after = ledgers.get("before", []), ledgers.get("after", [])
        expect(len(after) == len(before) + added and after[:len(before)]
               == before and len(set(after)) == len(after),
               f"phase 8: ledger {len(before)} -> {len(after)} anchors "
               f"({len(set(after))} distinct), expected +{added}")
        sizes = [sum(len(a) for a in t.datasets[0].anchors)
                 for t in trainers]
        with open(os.path.join(logdir, "training_iteration1.txt")) as f:
            header = f.readline()
        expect(f"({len(before) + added})" in header and len(sizes) == 2
               and sizes[1] > sizes[0],
               f"phase 8: iteration 1 trained on anchors {sizes}, its log "
               f"header {header.strip()!r}")
        vote = dict(tester.vote_times[0])
        log(f"[{card}] phase 8 entry point: {wall_s:.1f} s; ledger "
            f"{len(before)} -> {len(after)}; anchors with overlaps by "
            f"iteration {sizes}; acquisition vote {vote['batches']} batches "
            f"in {vote['seconds']:.2f} s ({vote['points'] / vote['seconds']:.0f} "
            f"voted points/s); launches {launches}")
        report["entry"] = dict(wall_s=wall_s, ledger=[len(before), len(after)],
                               anchors=sizes, vote=vote, launches=launches)

        # one vote batch: replay against the eager body; replay and vote
        # update timed on the card
        source, extra, acc = tester.vote_parts(tester.dataset)
        runner = tester._eval_graph
        times = {k: [] for k in ("replay_dev", "replay_host", "update_dev",
                                 "update_host")}
        same = None
        for pack, _ in BatchPrefetcher(source, 5, tester.device,
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
            acc.update(runner.out["probs"], runner.slots[0],
                       d2=runner.out["d2"])
            marks[2].record()
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            times["replay_host"].append(1e3 * (t1 - t0))
            times["update_host"].append(1e3 * (t2 - t1))
            times["replay_dev"].append(marks[0].elapsed_time(marks[1]))
            times["update_dev"].append(marks[1].elapsed_time(marks[2]))
            if same is None:
                eager = eval_body(tester.model, runner.slots[0],
                                  tester.config, tester.plan, tester.device,
                                  spec=tester.spec)
                same = all(torch.equal(runner.out[k], eager[k])
                           for k in ("probs", "labels", "d2"))
        expect(bool(same), "phase 8: a vote batch's replay differs from "
               "the eager eval_body")
        med = {k: statistics.median(v) for k, v in times.items()}
        log(f"[{card}] phase 8 vote batch (median of 5): replay "
            f"{med['replay_dev']:.2f} ms on the card, {med['replay_host']:.2f}"
            f" ms of host; vote update with d2 {med['update_dev']:.3f} ms on "
            f"the card, {med['update_host']:.2f} ms of host; replay equal "
            f"to eager bit for bit: {same}")
        report["vote_batch"] = dict(replay_equals_eager=bool(same), **med)

        # 2-3. test_models on the validation and the training clouds
        for on in ("validation", "train"):
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            tm = test_models(["--log", logdir, "--on", on, "--num_votes",
                              "2", "--data_root", root])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            add(total, launches)
            want = vote_launches(tm)
            expect(launches == {k: want.get(k, 0) for k in launches},
                   f"phase 8 test_models --on {on}: launches {launches}, "
                   f"expected {want}")
            out = os.path.join("test", "WeakLabel", log_name)
            n_eval = len(tm.dataset.validation_labels[0])
            for sub in ("predictions", "probs", "potentials"):
                path = os.path.join(out, sub, f"{cloud}.ply")
                ok = os.path.exists(path)
                if ok and sub != "potentials":
                    ok = read_ply(path)["x"].shape[0] == n_eval
                expect(ok, f"phase 8 test_models --on {on}: {path} missing "
                       f"or not {n_eval} points")
            finite = all(np.isfinite(p).all() for p in tm.test_probs)
            expect(finite, f"phase 8 test_models --on {on}: non-finite "
                   "votes")
            vote = dict(tm.vote_times[0])
            log(f"[{card}] phase 8 test_models --on {on}: {wall_s:.1f} s; "
                f"vote {vote['batches']} batches in {vote['seconds']:.2f} s "
                f"({1e3 * vote['seconds'] / vote['batches']:.2f} ms a batch, "
                f"{vote['points'] / vote['seconds']:.0f} voted points/s); "
                f"{n_eval} points projected; launches {launches}")
            report[f"test_{on}"] = dict(wall_s=wall_s, vote=vote,
                                        launches=launches)

        t0 = time.perf_counter()
        out_dir = refine(["--weak_label_log", log_name, "--data_root",
                          root])
        refine_s = time.perf_counter() - t0
        n_sub = len(tm.dataset.input_labels[0])
        pseudo = os.path.join(out_dir, f"{cloud}_t20_pseudo.txt")
        weights = os.path.join(out_dir, "Vaihingen3D_t20_weight.txt")
        labels = np.loadtxt(pseudo) if os.path.exists(pseudo) else []
        w = np.loadtxt(weights) if os.path.exists(weights) else []
        expect(len(labels) == n_sub and len(w) == 9
               and np.isfinite(w).all(),
               f"phase 8 refinement: {len(labels)} pseudo labels for "
               f"{n_sub} subsampled points, weights {w}")
        peak = torch.cuda.max_memory_allocated()
        log(f"[{card}] phase 8 refinement: {refine_s:.2f} s of host for "
            f"{n_sub} points ({int(np.sum(np.asarray(labels) == 10))} "
            f"no-label); weights {np.round(w, 3).tolist()}; phase 8 peak "
            f"device memory {peak / 2**20:.1f} MiB")
        report.update(refine_s=refine_s, peak_bytes=peak)
    finally:
        os.chdir(cwd)
    return report, total


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
    from weasal_tpu_torch.ops.cuda.inverse_lists import (build_inverse_lists,
                                                         inverse_sum)
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
    counted = (radius_search, kpconv_fwd, kpconv_bwd, maxpool_bwd,
               build_inverse_lists, inverse_sum)
    for fn in counted:
        fn.launches = 0
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
    eval_launches = {fn.__name__: fn.launches for fn in counted}
    # the row sums: the pyramid subsample's voxel sums, one per level
    expected = {"radius_search": 3 * plan.num_layers - 2,
                "kpconv_fwd": len(b_rows), "kpconv_bwd": 0, "maxpool_bwd": 0,
                "build_inverse_lists": 0, "inverse_sum": plan.num_layers - 1}
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
    per_val = dict(expected)
    # Per step: the inverse lists of every edge a backward sums over (3
    # conv, 2 pool, 2 upsample edges and the region members), the row
    # sums of the 2 upsample gathers and the 4 region-member gathers, and
    # the subsample's voxel sums
    n_up = plan.num_layers - 1
    expected = {"radius_search": 3 * plan.num_layers - 2,
                "kpconv_fwd": len(b_rows), "kpconv_bwd": len(b_rows),
                "maxpool_bwd": len(d_rows)}
    inverse_per_step = {"build_inverse_lists": plan.num_layers + 2 * n_up + 1,
                        "inverse_sum": n_up + n_up + 4}
    train_model, opt_state, start, launches, train_ms, losses = run_training(
        config, plan, batches, dev, counted, expected, log)
    for name, want in inverse_per_step.items():
        got = launches[name] / N_TRAIN_STEPS
        expect(got == want, f"{name}: {launches[name]} launches in "
               f"{N_TRAIN_STEPS} training steps, expected {want} a step")
        expected[name] = int(got) if got == int(got) else want
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
                                     log, plan=plan, witness=True)
    tprof_rows, tbusy, twall = profile_step(
        lambda: train_step(train_model, opt_state, batches[1], config, plan,
                           config.learning_rate, device=dev), log,
        "train_step")
    log("phase 5: the inverse lists and the row sums at a step's shapes")
    inv_sums = check_inverse_lists(record_inverse_calls(
        lambda: train_step(train_model, opt_state, batches[2], config, plan,
                           config.learning_rate, device=dev)), log)
    deterministic = run_deterministic_step(log)

    # ---- phase 6: the training loop (phase 7 inside it)
    log("phase 6: the weak-label training loop on the card")
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        loop, loop_launches, root = run_loop(
            counted, expected, per_val, card, statistics.mean(train_ms[1:]),
            work, log)
        # ---- phase 8: testing and active learning on the loop's tile
        log("phase 8: testing and weak-label active learning on the card")
        al, al_launches = run_active_learning(root, work, counted, expected,
                                              per_val, card, log)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def main_path(name):
        return (eval_launches.get(name, 0) + launches[name]
                + loop_launches[name] + al_launches[name])

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
        # C's and D's dX sum over these lists in their own launches; the
        # standalone row sums are the other scatter-adds of the step. No
        # pallas_call computes them (the TPU kernels sum by membership
        # products), so they replace none and name the kernels they serve
        dict(name="build_inverse_lists", route="cuda",
             source="weasal_tpu_torch/csrc/inverse_lists.cu",
             replaces=None, helper_of=["kpconv_bwd", "maxpool_bwd"],
             launches=main_path("build_inverse_lists"),
             **inv_sums["build_inverse_lists"]),
        dict(name="inverse_sum", route="cuda",
             source="weasal_tpu_torch/csrc/inverse_lists.cu",
             replaces=None, helper_of=["kpconv_bwd", "maxpool_bwd"],
             launches=main_path("inverse_sum"),
             **inv_sums["inverse_sum"]),
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
                           loop=loop, loop_launches=loop_launches,
                           inverse_lists=inv_sums,
                           deterministic_step=deterministic,
                           active_learning=al, al_launches=al_launches), f,
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
