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
   (their dX adds in a fixed order over inverse neighbor lists), the row
   sums over each edge's lists of a seeded workspace at the layer's width
   equal to the sums added in list order, timed as in phase 2 with the
   edge's inverse lists built once as a step shares them, C's two GEMM
   parts as B's, and each dX stage's device time;
5. the training path: `train_step` for 4 steps, launch counts read around
   them, losses, parameters and BatchNorm statistics checked, then one
   step with the kernels, one on the plain versions and one replay of
   the kernel step captured in a CUDA graph (train/graphs.StepGraph),
   each f32 step held to an f64 step, from the seeded initial state and
   one shared pyramid (loss, every gradient, the updated state; the f64
   and plain steps take the kernel step's leaky-ReLU signs and max-pool
   winners, so that a tie within f32 rounding turns no branch), with a
   witness of the kernel step's largest share (the plain step with its
   sums in the kernels' order and in seeded random orders, and kernel
   B's forward before the plain backward, each read on that tensor); the
   inverse-list builds and the row sums of one step at the shapes it
   gives them, against their plain versions (lists equal to a stable
   sort's, eager and replayed from a CUDA graph; sums equal bit for bit
   to the sums added in list order, and within f32 rounding of the
   plain versions), timed by CUDA events and by device time split by
   kernel name beside their library calls (`torch.sort(keys,
   stable=True)` for the build, `index_add_` / `scatter_add_` for the
   sums), each the same over repeated calls; the same checks at
   adversarial shapes; one kernel training step in a process of its own
   under `torch.use_deterministic_algorithms(True)`;
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
   and read again on the same batch's pyramid built twice more (each
   pyramid's hash equal to the first's, its share of the f64 allowance
   within SHARE_REPEAT_RTOL of it),
   and `train_step` timed at the loop's plan, synchronized and back to
   back, beside the loop's step and phase 5's, after the inverse lists
   and row sums of one step checked and timed as in phase 5;
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
   seconds, the peak memory;
9. the pseudo-label stage on phase 6's tile at full VaihingenPLConfig
   width (`run_pseudo_label`; 5 levels, 4 spheres of 24 m, dropout, the
   contrast loss), on refined labels it writes (the tile's ground truth
   with a seeded 30 % set to 10, and class weights): the entry point
   `weasal_tpu_torch.train_Vaihingen3D_PseudoLabel.run` for 2 graphed
   epochs of 10 steps with 5 validation batches, the same again in a
   fresh trainer (losses and checkpoint bit-equal) and a resume, with
   the checks of phase 6 and 13 A, 10 B, 10 C, 4 D, 14 list builds and 9
   row sums a step (13 A, 10 B, 4 row sums a validation batch); one more
   epoch profiled (busy share, kernel events against the counters);
   kernels A-D, the lists and the row sums against their plain versions
   at the PL loop's shapes, as phases 2, 4 and 5 do, and the GEMM core's
   drift at the widest PL conv (256 -> 256, depth 3840); one PL kernel step,
   eager and replayed, against an f64 plain step on one shared pyramid
   from the seeded state with one dropout mask and one contrast draw;
   `train_step`'s launches and ms at the PL plan, profiles of a step, of
   the contrast loss and of the dropout mask; one acquisition (a vote of
   2, every step and vote batch replayed, the ground-truth ledger grown
   by `added_labels_per_epoch` points that iteration 1 trains on); and
   `test_models --on test` on the PL log (plys, launches, finite votes);
10. the DALES workflow (`run_dales`) on a synthetic DALES-like root of 3
   training and validation tiles and 1 test tile, each 400 m a side (a
   real DALES tile is 500 m: cut, with its second test tile, for the
   script's time; ~1.2 M points a tile after the 0.4 m subsampling), at
   a DALES tile's density, without color: the graphed WL loop at full
   DALESWLConfig width (128 features; `train_DALES_WeakLabel.run`, as
   phase 6 runs Vaihingen3D's: 2 epochs, the repeat, bit-equal, and a
   resume), a profiled epoch, A-D, the lists and the sums against their
   plain versions at its shapes with each conv's GEMM shape logged, the
   GEMM core's drift at its deepest conv (1024 -> 512, depth 15360), and
   its kernel step, eager and replayed, against an f64 step on 3 builds
   of one pyramid (`check_stage_shapes`); `test_models --on train` (1
   vote, every training tile), the refinement at its DALES default of
   10 %, the graphed PL loop at DALESPLConfig (`train_DALES_PseudoLabel.run`,
   on labels written from the ground truth, with the refinement's class
   weights) with the same checks, and `test_models --on test` (1 vote,
   every test tile): launches, plys per tile, finite votes, ms per vote
   batch and voted points/s, host set-up seconds and peak memory;
11. the pseudo-label stage with deformable convs (`run_deformable`):
   VaihingenPLConfig at full width with its layer-3 resnetb and layer-4
   blocks deformable, on phase 9's tile and labels, through the PL entry
   point's stage runner: one graphed epoch of 10 steps (K = 1) with 2
   validation batches, again in a fresh trainer (losses, offset losses
   and checkpoint bit-equal), every step replayed, 13 A, 10 B and 10 C
   (7 rigid convs and the 3 offset convs), 4 D, 14 builds and 12 row
   sums a step, the offset loss finite and non-zero; the checkpoint exported to the
   reference's torch format and reloaded into a fresh trainer and into
   `ModelTester` (eval probabilities bit-equal, momentum zero) and
   voted once by `test_models --on test --chkp` the exported file; one
   more epoch profiled; A-D, the lists and the sums against their plain
   versions and the kernel step against f64 at its shapes
   (`check_stage_shapes`); the deformable convs' device ms and peak
   memory;
12. the host-pyramid input path (`run_host_pyramid`, config.device_pyramid
   False, the JAX package's default): the WL entry point with
   `--host_pyramid` on phase 6's tile at full width (the config's input
   threads: a ParallelSphereBuilder of 8 workers), 2 graphed epochs of
   10 steps and 5 validation batches and the same again in a fresh
   trainer (losses and checkpoint bit-equal), every step and validation
   batch replayed, 0 A, 12 B, 12 C, 2 D, 8 builds and 6 row sums a step
   and 0 A and 12 B a validation batch; B, C, D, the lists and the sums
   against their plain versions and the kernel step (eager and replayed)
   against f64 on host batches (`check_host_shapes`), the loop's ms a
   step with its `wait_batch` share and the host build's ms a batch
   beside phase 6's fused loop; two PL epochs of 10 steps with
   `--host_pyramid` on phase 9's labels (launches, finite losses, the
   second epoch's ms a step and its `wait_batch` share);
   `test_models --host_pyramid --on validation` (1 vote, epochs of
   HOST_VOTE_BATCHES batches: plys, launches, finite votes); and KPCNN
   on host-built classification batches of synthetic shape clouds:
   B, C and D at its shapes against their plain versions, then
   KPCNN_STEPS eager SGD steps (lr 5e-3, momentum 0.9) whose accuracy
   over the last 10 must pass KPCNN_MIN_ACC;
13. compute_dtype "bfloat16" (the JAX package's bench precision: bf16
   inputs to KPConv's two products, f32 sums, rounded where JAX's XLA
   path rounds) and a generated kernel disposition
   (`run_bf16_dispositions`): B and C in bf16 against their plain bf16
   versions by the flip criterion of tests/_bf16_cases.py (y and dW equal
   but for one-ulp flips in at most 1e-3 of the elements, counting
   noise allowed; out and dX as close to an f64 evaluation of the same
   rounding points as the plain versions within 2x, or within 1e-4; out
   within f32 tolerance of y @ bf(W)) at phase 2's WL shapes, phase 9's
   PL shapes (from the bf16 PL run) and DALES's widest conv; B and C in
   f32 at Kp 1, 5, 16, 17, 20 and 40 and at Kp 40 with K 266 (past 48 KB of
   shared memory; also in bf16) within phases 2 and 4's tolerances, each
   timed beside its plain version and its bound (bf16: y @ bf(W) at the
   bf16 rate, C's products in two TF32 passes); the WL entry point with
   VaihingenWLConfig in bf16 on phase 6's tile (2 graphed epochs and the
   repeat: losses and checkpoint bit-equal; phase 6's launches a step),
   the bf16 kernel step against the plain bf16 step on one batch (loss
   rtol 1e-3, gradients within twice the plain step's own spread over
   two sphere orders), its ms a step beside phase 6's f32 loop and the
   first step's loss in f32 and bf16 (printed); one graphed bf16 PL
   epoch on phase 9's labels; the WL entry point at 20 kernel points, the
   disposition generated into the phase's work directory (5 graphed
   steps, 12 B and 12 C a step at Kp 20) and B and C at its shapes;
14. data parallel (`run_data_parallel`): two gloo ranks sharing the card
   (spawned processes, eager) take a WL step (VaihingenWLConfig,
   batch_num 3 rounded to 4) and a PL step with dropout and the contrast
   loss on phase 6's tile, and vote one batch; each rank launches A-D;
   held to one process on the same 4 spheres (loss, the f64 step's
   allowance, bit-equal masks, draw, ranks and vote buffers); then one
   NCCL rank runs a graphed WL epoch bit-equal to the same epoch with no
   group (the collectives inside the captured graphs);
15. the last modules of the JAX package (`run_phase15`): (a) the
   deformable-kernel inspector (`utils/visualizer.ModelVisualizer`) on
   phase 11's model and one of its validation batches, the pyramid built
   on the card and the eval forward (13 A, 10 B, 4 row sums), against
   the same on the plain versions (deformed kernel points within the
   KPConv tolerance, the same files written; the forward timed both
   ways); (b) the 'max_pool' block (`MaxPoolBlock`, the JAX block's edge
   pools[layer_ind + 1]) forward and backward on the first batch of
   phase 6's tile, kernel D against its plain version on that edge and
   timed; (c) `utils/profiling.device_trace` around a graphed WL epoch
   of 10 steps on phase 6's tile: `module_times_us(..., "train_step_k")`
   one duration a replay, their sum within the epoch's wall, and
   `stage_breakdown` times the steps and the readers' busy time equal to
   what torch.profiler's own events of the window give (1 %).
Phases 3 and 5 end with a profile of one step, by kernel family. Checks
of agreement (each kernel against its plain version and against itself
on a repeat, the GEMM core's drift, the forward and the training step
against their references, and every check of phases 6-8) report their
readings and fail the run at its end, so that a failing run still reads every phase; checks of shapes,
launch counts and finite values in phases 3 and 5 fail it at once. The last line is {"ok": true, "device": {...}};
the line before it holds the kernels' numbers as JSON, each kernel's
bound counting its GEMM operations at the 3xTF32 rate of the tensor
cores and the rest at the f32 rate (`f32_bound_ms`: all at the f32
rate), its launches on each main path (`launches_by_path`: inference,
the training steps, the WL loop, WL active learning, the PL stage, the
DALES WL and PL paths, the deformable PL path, the host-pyramid WL loop,
PL epoch and vote, KPCNN's steps, phase 13's bf16 WL loop and PL epoch
and Kp-20 WL epoch, phase 14's data-parallel WL and PL steps summed
over the ranks and its NCCL epoch, phase 15's visualizer (`visualize`)
and max_pool block (`max_pool_block`)), for B and C their sums at phase
13's shapes (`bf16_wl_ms` ... `kp20_wl_bound_ms`: `phase13_fields`) and
its sums at the PL loop's, the DALES loops', the deformable PL loop's,
the host-pyramid WL loop's and KPCNN's shapes (`pl_ms`, `pl_plain_ms`, `pl_bound_ms`, and the same with
`dales_wl_`, `dales_pl_`, `deform_pl_`, `host_wl_` and `kpcnn_`; A runs
on neither of the last two; D also at the max_pool block's edge,
`max_pool_block_`). Imports nothing of JAX or weasal_tpu.

Kernels B and C run their three products (y @ W; g @ W^T and y^T @ g)
through one GEMM core, weasal_tpu_torch/csrc/kpconv_common.cuh: wgmma
TF32 on the tensor cores with each f32 operand split as big + small
(3xTF32, f32-grade error), 128-row tiles 32 deep fed by a cp.async ring,
and split-K with a workspace where the schedule gains from it.

Kernels C and D take their dX in two stages: each (row, slot)
contribution to a workspace, then each support's slots summed in
ascending order over its inverse neighbor list (csrc/inverse_lists.cuh),
so that no atomic decides an order; the lists of each pyramid edge are
built once a step (a memset and one kernel in four phases, no host
read) and shared.

Kernel A is two launches: a binning of each sphere's supports into
columns of a 2-D grid (one block per sphere, counts, scan and scatter in
shared memory), then a search testing only the columns a query's reach
overlaps, with a margin that keeps every in-radius support, and keeping
the K best by (d2, index): one thread a query in registers for K <= 16,
one warp a query above (hits compacted into a shared-memory buffer, cut
to K by a bitonic sort when full). Kernel D runs one warp per pooled
row, its lanes across channels, and gathers each value once.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tests._bf16_cases import (OUT_REL_L2_MAX, REF_RATIO, flips, flips_ok,
                               is_bf16_valued, within_plain)
from tests._inverse_cases import (CASES as INVERSE_CASES, graph_replay,
                                  index_case, ordered_row_sums,
                                  ordered_run_sums, run_case)
from weasal_tpu_torch.utils.profiling import (
    BF16_GEMM_FAMILY, GEMM_FAMILIES, SPLITK_SUM, busy_us, categorize_op,
    device_trace, host_ranges, kernel_families, module_times_us,
    named_intervals, rows_of, stage_breakdown, union_us)

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32
# operations/s outside the tensor cores and dense TF32 operations/s on the
# tensor cores. A kernel's bound counts each operation at the rate of the
# unit that runs it: the GEMM core of B and C runs 3 TF32 products for each
# f32 one (3xTF32), so its 2MNK operations count as 3 x 2MNK at the TF32
# rate; everything else runs on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
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
# with the 3xTF32 one. The f64 and plain steps take the kernel step's
# branches (its leaky ReLUs' signs and max pools' winners, `Branches`):
# at DALES's shapes a branch within f32 rounding of a tie, taken the
# other way by one of the steps, read several times the allowance, and
# the plain step's own turns inflated it. A branch of the kernel step
# that the f64 step's own values would turn must lie within TIE_RATIO
# times the plain f32 step's largest deviation from the f64 step at that
# call, so a fault that moves a value across a tie still fails.
LOSS_RTOL = 1e-5
F64_RATIO = 4.0
F64_FLOOR = 1e-3
TIE_RATIO = 4.0
# One batch's plain pyramid built again is bit-equal (its voxel sums add
# in a fixed order), so its f64 shares differ only by the plain f32 step
# the allowance is made of: C's and D's plain dX add with index_add_,
# atomics in no fixed order on the card (a few 1e-5 of a share on an
# H100)
SHARE_REPEAT_RTOL = 1e-3
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
# Pyramids built of the loop's first batch, each read against the f64
# step (the first held)
LOOP_F64_PYRAMIDS = 3
# Phase 7: pairs of epochs, eager against graphed and K = 1 against K = 10,
# and the percentile of the small-sphere bucket
DISPATCH_PAIRS = 10
K_PAIRS = 5
K_EPOCH_BATCHES = 40
BUCKET_PERCENTILE = 80
# Phase 8: anchors added per training file by the acquisition (fewer
# where the tile has fewer unused ones)
AL_ADDED = 100
# Phase 9: the pseudo-label stage on phase 6's tile, trained on refined
# labels of its own (the tile's ground truth with a seeded PL_UNLABELED
# of its points set to 10, 'no label'); the contrast loss's reference
# points of the f64 check (its draw's size)
PL_LOG = "Log_phase9"
PL_UNLABELED = 0.3
PL_ARGS = ("--weak_label_log", PL_LOG, "--epoch_steps", "10",
           "--validation_size", "5", "--seed", str(SEED),
           "--al_iterations", "0")
PL_SLC = 1000
# Phase 10: the DALES workflow on a synthetic DALES-like root of
# DALES_TILES training and validation tiles (the lexically last one
# validates) and DALES_TEST_TILES test tiles, each DALES_EXTENT m a side at
# DALES_DENSITY points / m^2 (a real DALES tile's density), at full
# DALESWLConfig and DALESPLConfig width. Cut for the script's time: a real
# DALES tile is 500 m a side (about 3.1 M raw and 1.8 M subsampled points
# at this density) and DALES has 11 test tiles. At 500 m with 2 test tiles
# the phase took 268-311 s of the script's 850-994 on an H100 (at 400 m
# with 1 test tile 174-195 s of 820-911), most of it
# host set-up, votes and refinement that grow with the tiles' area and
# count; the sphere radius and the density stay a full tile's, so the
# plans and the kernels' shapes change little. A 300 m tile holds fewer
# anchors (5183) than DALESWLConfig's first labels take (7000)
DALES_TILES = 3
DALES_TEST_TILES = 1
DALES_EXTENT = 400.0
DALES_DENSITY = 10.0
DALES_LOG = "Log_phase10"
DALES_ARGS = ("--epoch_steps", "10", "--validation_size", "5",
              "--seed", str(SEED), "--al_iterations", "0")
# Phase 11: the pseudo-label stage with deformable convs on phase 9's tile
# and labels; the blocks made deformable (by index in VaihingenPLConfig's
# architecture: the layer-3 resnetb, the strided block from layer 3 and
# the layer-4 resnetb) and one graphed epoch of 10 steps a replay at a
# time with 2 validation batches
DEFORM_LOG = "Log_phase11"
DEFORM_BLOCKS = {7: "resnetb_deformable", 8: "resnetb_deformable_strided",
                 9: "resnetb_deformable"}
DEFORM_ARGS = ("--weak_label_log", PL_LOG, "--epoch_steps", "10",
               "--validation_size", "2", "--max_epoch", "1",
               "--steps_per_dispatch", "1", "--seed", str(SEED),
               "--al_iterations", "0")
# Phase 12: the host-pyramid input path on phase 6's tile (WL: 2 epochs
# of 10 steps with 5 validation batches, and their repeat) and phase 9's
# labels (PL: 2 epochs, the second timed without the capture); the vote's epochs of HOST_VOTE_BATCHES batches
# (each sphere built on one host thread, as the JAX tester builds them);
# KPCNN_STEPS SGD steps of KPCNN on classification batches of
# KPCNN_CLOUDS synthetic shape clouds, whose accuracy over the last 10
# must pass KPCNN_MIN_ACC (tests/test_classification.py's smoke)
HOST_LOG = "Log_phase12"
HOST_ARGS = ("--epoch_steps", "10", "--validation_size", "5",
             "--seed", str(SEED), "--al_iterations", "0", "--host_pyramid")
HOST_PL_EPOCHS = 2
HOST_PL_ARGS = ("--weak_label_log", PL_LOG, "--epoch_steps", "10",
                "--validation_size", "5", "--max_epoch", str(HOST_PL_EPOCHS),
                "--seed", str(SEED), "--al_iterations", "0",
                "--host_pyramid")
HOST_VOTE_BATCHES = 20
KPCNN_STEPS = 60
KPCNN_CLOUDS = 6
KPCNN_MIN_ACC = 0.65
# Phase 13: compute_dtype "bfloat16" and a generated disposition. The
# kernel-point counts of the f32 sweep of B and C (one chunk of 16 kernel
# points, one past it, a generated 20 and 40) at a level-0-like conv; Kp
# 40 at the deformable layers' K of 266 (the influence tile past 48 KB of
# shared memory); DALES's widest conv (1024 -> 512 on 2 spheres of the
# deepest level); the bf16 PL epoch's and the Kp-20 run's arguments; the
# bf16 kernel step's bounds against the plain bf16 step (its loss, and
# its gradients' distance within BF16_SPREAD_RATIO times the plain step's
# own spread over two sphere orders)
KP_SWEEP = (1, 5, 16, 17, 20, 40)
KP_SWEEP_SHAPE = dict(b=3, nq=4000, ns=4000, k=34, cin=128, cout=128)
KP_WIDE_SHAPE = dict(b=3, nq=1500, ns=1500, k=266, kp=40, cin=256,
                     cout=256)
DALES_WIDEST = dict(b=2, nq=640, ns=640, k=36, kp=15, cin=1024, cout=512)
BF16_LOG = "Log_phase13"
BF16_PL_ARGS = ("--weak_label_log", PL_LOG, "--epoch_steps", "10",
                "--validation_size", "2", "--max_epoch", "1",
                "--seed", str(SEED), "--al_iterations", "0")
KP20 = 20
KP20_ARGS = ("--epoch_steps", "5", "--validation_size", "1",
             "--max_epoch", "1", "--seed", str(SEED), "--al_iterations", "0")
BF16_LOSS_RTOL = 1e-3
BF16_SPREAD_RATIO = 2.0
# Failed checks of agreement, reported at once and failing the run at its
# end (see the module docstring); PREFIX names the shapes being checked;
# CARD the card's name and power limit, for the log
FAILED: list = []
PREFIX = ""
CARD = ""


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


def tensor_bound_ms(n_bytes: float, n_ops: float, bf16_ops: float = 0.0,
                    tf32_ops: float = 0.0):
    """(least ms, "bytes" or "operations") of work that moves n_bytes and
    does n_ops f32 operations on the CUDA cores, bf16_ops on the tensor
    cores at the bf16 rate and tf32_ops at the TF32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / F32_OPS_PER_S + bf16_ops / BF16_OPS_PER_S
             + tf32_ops / TF32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def bound_ms(n_bytes: float, n_ops: float, n_gemm_ops: float = 0.0):
    """(least ms, "bytes" or "operations") of work that moves n_bytes and
    does n_ops f32 operations on the CUDA cores and n_gemm_ops f32 GEMM
    operations through the 3xTF32 core on the tensor cores."""
    return tensor_bound_ms(n_bytes, n_ops, tf32_ops=3 * n_gemm_ops)


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
    from weasal_tpu_torch.models.blocks import conv_inputs, kernel_convs
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd,
                                                      kpconv_fwd_plain,
                                                      kpconv_fwd_with_y)
    gen = torch.Generator(device=batch.features.device).manual_seed(seed)
    rows, t_k, t_p, t_b, t_f32 = [], 0.0, 0.0, 0.0, 0.0
    ops_t, gemm_t, bytes_t, worst = 0.0, 0.0, 0.0, 0.0
    for name, conv in kernel_convs(model):
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
    rows, *_ = profiled_kernels(fn, reps)
    return {key: (sum(t for name, _, t in rows if key in name) / reps
                  if any(key in name for name, _, _ in rows) else None)
            for key in names}


def check_gemm_bias(log, seed, shape=(3, 5712, 34, 15, 512, 256)):
    """Mean signed and rms relative error to f64 of the GEMM core's y @ W
    (kernel B) and y^T @ g (kernel C) at a conv of `shape` (spheres,
    rows, K, kernel points, Cin, Cout; by default the WL main path's
    widest) on positive operands, over the outputs above a tenth of the
    largest, beside cuBLAS f32 on the same products. On positive operands
    a sum that drops low bits always the same way (the tensor cores'
    accumulation truncates) shows as a mean error; it must stay below
    GEMM_BIAS_MAX."""
    from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd_with_y
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, n, k, n_kp, cin, cout = shape
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
    from weasal_tpu_torch.models.blocks import conv_inputs, kernel_convs
    from weasal_tpu_torch.ops.cuda.kpconv_bwd import (kpconv_bwd,
                                                      kpconv_bwd_plain)
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd_plain_with_y
    from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
    gen = torch.Generator(device=batch.features.device).manual_seed(seed)
    rows, t_k, t_p, t_b, t_f32 = [], 0.0, 0.0, 0.0, 0.0
    ops_t, gemm_t, bytes_t, worst = 0.0, 0.0, 0.0, 0.0
    skip_dx = first_conv(model)
    ws_gen = torch.Generator(device=batch.features.device).manual_seed(
        seed + 1)
    for name, conv in kernel_convs(model):
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
        stage2 = expect_stage2_order(f"kpconv_bwd {name}", inv,
                                     s.shape[0] * s.shape[1], cin, ws_gen)
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
                         stage2_in_order=stage2,
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
            + f"; dX stages {stage_text(dx_stages)}; repeats {repeats}; "
            f"stage 2 in list order {stage2}")
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


def expect_stage2_order(what, inv, rows, width, gen) -> bool:
    """The row sums over an edge's lists (`inv`, a LazyInverse) of a
    seeded workspace [slots, width], as C's and D's dX take their stage
    2, equal the sums in list order bit for bit."""
    from weasal_tpu_torch.ops.cuda import inverse_lists as il
    lists = inv.get()
    ws = torch.randn((lists.entries.shape[0], width), generator=gen,
                     device=lists.entries.device)
    ok = torch.equal(il.inverse_sum(ws, lists, rows),
                     ordered_row_sums(ws, lists.offsets, lists.entries,
                                      rows))
    expect(ok, f"{what}: row sums over a workspace of width {width} "
           "differ from the sums in list order")
    return ok


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
    ws_gen = torch.Generator(device=batch.features.device).manual_seed(
        seed + 1)
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
        stage2 = expect_stage2_order(f"maxpool_bwd {name}", inv, b * ns, c,
                                     ws_gen)
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
                         stage2_in_order=stage2,
                         dx_stage_ms=dx_stages, ms=ms, plain_ms=plain,
                         bound_ms=b_ms, bound_by=b_by))
        log(f"  D {name}: nb{list(nb.shape)} Ns={ns} C={c}: err {err:.2e} "
            f"(scale {scale:.2e}), kernel {ms:.3f} ms, plain {plain:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}); dX stages "
            f"{stage_text(dx_stages)}; repeats {repeats}; stage 2 in list "
            f"order {stage2}")
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


def device_split(fn, reps: int = 10) -> dict:
    """{kernel name: mean device ms a call} of fn() (torch.profiler over
    `reps` calls after a warm-up call; memsets are "Memset (Device)")."""
    fn()
    rows, *_ = profiled_kernels(fn, reps)
    return {name: ms / reps for name, _, ms in rows}


def lists_equal(got, ref) -> bool:
    total = int(ref.offsets[-1])
    return torch.equal(got.offsets, ref.offsets) and torch.equal(
        got.entries[:total], ref.entries[:total])


def adversarial_inverse_calls(dev, seed):
    """Calls of the build, the row sums and the voxel run sums at shapes
    the main path does not give them, in `record_inverse_calls`' form:
    the builds of tests/_inverse_cases.py's index cases (a support
    referenced by thousands of slots, skew, duplicated supports in a row
    with shadows on both sides, rows of shadows only, no slots, no
    supports, k = 1 of a wider ld, B*Ns a multiple of no tile), the sums
    over each case's lists at C = 3, 9 and 64, and the run sums of its
    voxel runs (one of 400 rows, rows dropped past n_out, a sphere with
    no run)."""
    from weasal_tpu_torch.ops.cuda import inverse_lists as il
    gen = torch.Generator(device=dev).manual_seed(seed)
    builds = []
    for name in INVERSE_CASES:
        nb, ns, k = index_case(name, seed)
        builds.append((nb.to(dev), ns, k))
    calls = [("build", args) for args in builds]
    for inds, ns, k in builds:
        k = inds.shape[2] if k is None else k
        lists = il.build_inverse_lists_plain(inds, ns, k)
        for c in (3, 9, 64):
            src = torch.randn((inds.shape[0] * inds.shape[1] * k, c),
                              generator=gen, device=dev)
            calls.append(("sum", (src, lists, inds.shape[0] * ns)))
    seg, n_out = run_case(seed)
    calls.append(("runs", (torch.randn((*seg.shape, 3), generator=gen,
                                       device=dev), seg.to(dev), n_out)))
    return calls


def check_inverse_lists(calls, log, totals: bool = True, reps: int = 10):
    """The inverse-list build and the fixed-order row sums at recorded
    shapes (`record_inverse_calls`, or `adversarial_inverse_calls` with
    totals=False: checked alike, left out of the sums). The build's
    lists equal the plain stable sort's, eager and replayed from a CUDA
    graph; every row sum and voxel sum equals `ordered_row_sums` /
    `ordered_run_sums` bit for bit (and is within f32 rounding of the
    plain version, whose `index_add_` adds with atomics on the card: at
    the step's shapes within MAXPOOL_RTOL and MAXPOOL_ATOL_REL, at
    adversarial ones within the bound on two orders of an f32 sum; the
    voxel sums' plain version adds in the kernel's order and equals it
    bit for bit); every call repeats bit for bit. Times: CUDA events around a call
    (kernel, plain version, library call), and the device time of the
    kernel's launches and of the library call's from torch.profiler,
    split by kernel name. The library calls compute the same function
    and the port never calls them: `torch.sort(keys, stable=True)` on
    the slots' precomputed support keys for the build (its lists are
    the stable sort's order), `index_add_` of the source rows into their
    destinations for the row sums, `scatter_add_` for the voxel sums (on
    CUDA both add with atomics in no fixed order). Returns the sums of
    both wrappers over the calls."""
    from weasal_tpu_torch.ops.cuda import inverse_lists as il
    sums = {n: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                    max_abs_err=0.0, library_ms=0.0, library_device_ms=0.0,
                    calls=0, repeats=True, exact=True, split={})
            for n in ("build_inverse_lists", "inverse_sum")}
    for kind, args in calls:
        if kind == "build":
            inds, ns, k = args
            k = inds.shape[2] if k is None else k

            def kernel():
                return il.build_inverse_lists(inds, ns, k)

            def plain():
                return il.build_inverse_lists_plain(inds, ns, k)

            keys = il._support_keys(inds, ns, k)

            def library():
                return torch.sort(keys, stable=True)

            got, ref = kernel(), plain()
            total = int(ref.offsets[-1])
            captured = il.InverseLists(*graph_replay(kernel))
            exact = lists_equal(got, ref) and lists_equal(captured, ref)
            shape = f"nb{list(inds.shape)} k={k} Ns={ns}: {total} entries"
            expect(exact, f"build_inverse_lists {shape}: lists (eager or "
                   "graph-captured) differ from the stable sort's")
            err = 0.0 if exact else float("inf")
            rep = expect_repeats(f"build_inverse_lists {shape}", lambda: (
                kernel().offsets, kernel().entries[:total]), calls=2)
            n_bytes = 4.0 * (inds[..., :k].numel() + ref.offsets.numel()
                             + total)
            name = "build_inverse_lists"
        else:
            if kind == "sum":
                src, inv, rows = args

                def kernel():
                    return il.inverse_sum(src, inv, rows)

                def plain():
                    return il.inverse_sum_plain(src, inv, rows)

                total = int(inv.offsets[-1])
                c = src.shape[1]
                want = (ordered_row_sums(src, inv.offsets, inv.entries,
                                         rows),)
                magnitude = ordered_row_sums(src.abs(), inv.offsets,
                                             inv.entries, rows)
                longest = int((inv.offsets[1:] - inv.offsets[:-1]).max()) \
                    if rows else 0
                # each source row's destination (rows: not in any list)
                tgt = torch.full((src.shape[0],), rows, dtype=torch.int64,
                                 device=src.device)
                tgt[inv.entries[:total].long()] = il.segment_ids(
                    inv.offsets, total)

                def library():
                    out = torch.zeros((rows + 1, c), device=src.device)
                    return out.index_add_(0, tgt, src)
                # the rows the lists name, read once (a workspace's shadow
                # slots are in no list), the sums written, the lists read
                n_bytes = 4.0 * (total * c + rows * c + rows + 1 + total)
                shape = f"src{list(src.shape)} -> {rows} rows"
            else:
                src, seg, n_out = args

                def kernel():
                    return il.run_sums(src, seg, n_out)

                def plain():
                    return il.run_sums_plain(src, seg, n_out)

                want = ordered_run_sums(src, seg, n_out)
                magnitude, counts = ordered_run_sums(src.abs(), seg, n_out)
                longest = int(counts.max()) if counts.numel() else 0
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
            exact = all(torch.equal(a, w) for a, w in zip(got, want))
            expect(exact, f"inverse_sum {shape}: differs from the sums in "
                   "list order")
            if kind == "runs":
                expect(all(torch.equal(a, b) for a, b in zip(got, ref)),
                       f"run_sums {shape}: the plain voxel sums differ "
                       "from the kernel's")
            # The plain versions add with atomics on the card, in no fixed
            # order. The step's lists hold tens of terms, and the kernels
            # stay within MAXPOOL_RTOL / MAXPOOL_ATOL_REL of them there;
            # an adversarial list of thousands of terms is held to the
            # bound on two orders of one f32 sum of L terms instead:
            # 2 (L - 1) 2^-24 times the sum of the terms' magnitudes
            err = 0.0
            order_bound = 2 * max(longest - 1, 1) * 2.0 ** -24 * (
                float(magnitude.max()) if magnitude.numel() else 0.0)
            for a, b in zip(got, ref):
                if not b.numel():
                    continue
                scale = float(b.abs().max())
                _expect_close(f"inverse_sum {shape}", a, b, MAXPOOL_RTOL,
                              MAXPOOL_ATOL_REL * max(scale, 1e-30)
                              if totals else order_bound)
                err = max(err, float((a - b).abs().max()))
            rep = expect_repeats(f"inverse_sum {shape}", lambda: (
                kernel() if kind == "runs" else (kernel(),)))
            name = "inverse_sum"
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        lib_ms = cuda_ms(library)
        split = device_split(kernel, reps)
        dev_ms = sum(split.values())
        lib_dev_ms = sum(device_split(library, reps).values())
        b_ms = bound_ms(n_bytes, 0.0)[0]
        log(f"  {name} {shape}: err {err:.2e}, exact {exact}, kernel "
            f"{ms:.4f} ms (device {dev_ms:.4f}: "
            + ", ".join(f"{k.split('(')[0][-40:]} {v:.4f}"
                        for k, v in split.items())
            + f"), plain {plain_ms:.3f} ms, library {lib_ms:.4f} ms "
            f"(device {lib_dev_ms:.4f}), bound {b_ms:.5f} ms (bytes); "
            f"repeats {rep}")
        t = sums[name]
        t["repeats"] &= bool(rep)
        t["exact"] &= bool(exact)
        t["max_abs_err"] = max(t["max_abs_err"], err)
        if not totals:
            continue
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bound_ms", b_ms), ("library_ms", lib_ms),
                       ("device_ms", dev_ms),
                       ("library_device_ms", lib_dev_ms)):
            t[key] += v
        t["calls"] += 1
        for k, v in split.items():
            t["split"][k] = t["split"].get(k, 0.0) + v
    for name, t in sums.items():
        t["bound_by"] = "bytes"
        if not totals:
            continue
        log(f"  {name}: {t['calls']} calls: kernel {t['ms']:.4f} ms "
            f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.3f} "
            f"ms, library {t['library_ms']:.4f} ms (device "
            f"{t['library_device_ms']:.4f}), bound {t['bound_ms']:.5f} ms; "
            "device split " + ", ".join(
                f"{k} {v:.4f}" for k, v in sorted(
                    t["split"].items(), key=lambda kv: -kv[1])))
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


def replayed_step(net, opt, data, config, plan, step_kw=None):
    """One training step on the pyramid `data` as a replay of a captured
    CUDA graph (train/graphs.StepGraph: warm-up, state restored, capture,
    replay); returns its loss. The parameters' `.grad` hold the replay's
    gradients. `step_kw` goes to `step_on_batch` (a pseudo-label step's
    contrast flag, dropout mask and drawn points)."""
    from weasal_tpu_torch.train.graphs import StepGraph
    from weasal_tpu_torch.train.step import (class_weights, label_table,
                                             step_on_batch, step_outputs)
    dev = data.features.device
    lr_t = torch.full((), config.learning_rate, device=dev)
    # made before the capture: a host-to-device copy cannot be captured
    class_w, table = class_weights(config, dev), label_table(net, dev)

    def body(inputs, out):
        loss, acc = step_on_batch(net, opt, data, config, lr_t,
                                  class_w=class_w, table=table,
                                  **(step_kw or {}))
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
         lambda *a, need_dx, inverse, compute_dtype: c_mod.kpconv_bwd_plain(
             *a, need_dx=need_dx, compute_dtype=compute_dtype)),
        (ops_mod, "maxpool_bwd",
         lambda x, nb, g, inverse: d_mod.maxpool_bwd_plain(x, nb, g)),
        (inv_mod, "inverse_sum", inv_mod.inverse_sum_plain)])
    return runs


class Branches:
    """The branches that one step's forward takes: each leaky ReLU's sign,
    each max pool's winners (ties share the gradient, as kernel D shares
    it), the contrast loss's comparisons (its certain points, positive
    point losses and positive classes, `losses.above` and
    `losses.positive_classes`) and pseudo-labels (`losses.top_class`),
    and in each deformable conv the linear influences' kinks, the
    neighbors in range (`ops.in_range`) and each kernel point's nearest
    neighbor (`ops.nearest`, the fitting regularizer's minimum). Recorded
    in the kernel step's forward and replayed, call by call, in the
    forwards of the steps it is held to, so that a value that lies within
    f32 rounding of a tie takes the same branch in every run: the f64
    step is then the exact step of the kernel step's branches, and the
    comparison holds the kernels' arithmetic, not the turn of a tie (one
    turned kink or winner moves its row's gradient by its own size, and
    BatchNorm spreads that over the channel; one turned comparison of the
    contrast loss moves a class mean's count). The channel attention's
    `amax` is no branch: softmax(amax - energy) does not depend on the
    shift, so its winner takes a gradient that sums to zero; nor are the
    WL region loss's kinks (BCE of masked means). A replay must make the
    recorded number of calls. The plain step's replay keeps its inputs;
    the f64 step's counts the branches that its own values would take the
    other way, each at its distance to the tie (|x - threshold| of a
    kink or a comparison, the gap from a maximum or minimum to the kernel
    step's winner), and `beyond` those farther than TIE_RATIO times the
    plain f32 step's largest deviation from the f64 step at that call
    (a gap: twice that): a kernel fault that moves a value across a tie
    or changes a winner by more than f32 rounding then counts there
    instead of being absorbed."""

    # the kinds of branch, recorded in call order each; "class" is the
    # same on every rank of a data-parallel group, the others are rows
    KINDS = ("kink", "pool", "row", "class", "argmax", "influence",
             "in_range", "nearest")

    def __init__(self):
        from weasal_tpu_torch.models import blocks, losses
        from weasal_tpu_torch.ops import kpconv as ops_mod
        self.blocks, self.losses, self.ops = blocks, losses, ops_mod
        self.plain = {name: getattr(mod, name) for mod, name in self._hooks()}
        self.recorded = {k: [] for k in self.KINDS}
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.run, self.plain_inputs = None, {}
        self.turned = dict(dict.fromkeys(self.KINDS, 0), beyond=0,
                           worst=0.0)

    def _hooks(self):
        return ((self.blocks, "leaky_relu"), (self.ops, "max_pool"),
                (self.losses, "above"), (self.losses, "positive_classes"),
                (self.losses, "top_class"),
                (self.ops, "influence_weights"), (self.ops, "in_range"),
                (self.ops, "nearest"))

    def _swap(self, fns):
        return swapped([(mod, name, fns[name]) for mod, name in self._hooks()])

    @staticmethod
    def _share(values, chosen):
        """Each slot's share of the gradient where it equals `chosen`."""
        won = (values == chosen).to(values.dtype)
        return won / won.sum(dim=2, keepdim=True)

    def _record(self, kind, value):
        self.recorded[kind].append(value)

    def _record_kink(self, x):
        self._record("kink", x > 0)
        return self.plain["leaky_relu"](x)

    def _record_pool(self, x, inds, inverse=None):
        from weasal_tpu_torch.ops.cuda.kpconv_fwd import gather_neighbors
        out = self.plain["max_pool"](x, inds, inverse)
        with torch.no_grad():
            self._record("pool", self._share(gather_neighbors(x, inds, 0.0),
                                             out[:, :, None]))
        return out

    def _record_output(self, name, kind):
        """The function `name`, recording its output as a `kind` branch."""
        def record(*args):
            out = self.plain[name](*args)
            self._record(kind, out)
            return out
        return record

    def _record_influence(self, sq, extent, influence):
        if influence == "linear":
            with torch.no_grad():
                self._record("influence",
                             1.0 - torch.sqrt(sq) / extent > 0)
        return self.plain["influence_weights"](sq, extent, influence)

    def _record_nearest(self, sq):
        out = self.plain["nearest"](sq)
        with torch.no_grad():
            self._record("nearest", self._share(sq, out[:, :, None]))
        return out

    def _next(self, kind, x):
        """The recorded branch of this call; in the plain replay, keeps x;
        in the f64 replay, returns x's deviation from the plain step's."""
        i = self.calls[kind]
        if i >= len(self.recorded[kind]):
            raise AssertionError(f"a replay makes more {kind} calls than "
                                 f"the recorded {len(self.recorded[kind])}")
        self.calls[kind] += 1
        key, dev = (kind, i), None
        if self.run == "plain":
            self.plain_inputs[key] = x.detach().clone()
        elif self.run == "f64":
            plain = self.plain_inputs.pop(key)
            dev = float((x.detach() - plain.double()).abs().max())
        return self.recorded[kind][i], dev

    def _count(self, kind, turned, dist, margin):
        """Counts the f64 step's turned branches and those beyond
        `margin`."""
        dist = dist[turned]
        self.turned[kind] += int(turned.sum())
        if dist.numel():
            far = float(dist.max())
            self.turned["beyond"] += int((dist > margin).sum())
            self.turned["worst"] = max(self.turned["worst"],
                                       far / margin if margin > 0
                                       else float("inf"))

    def _replay_mask(self, kind, x, threshold=0.0):
        """A recorded x > threshold, counted at |x - threshold|."""
        mask, dev = self._next(kind, x)
        if dev is not None:
            with torch.no_grad():
                self._count(kind, mask != (x > threshold),
                            (x - threshold).abs(), TIE_RATIO * dev)
        return mask

    def _replay_winners(self, kind, x, values, maximum: bool):
        """(the recorded winners' shares among `values` (from x), counted
        at the gap from the f64 maximum or minimum over axis 2 to the
        winners')."""
        share, dev = self._next(kind, x)
        share = share.to(values.dtype)
        if dev is not None:
            with torch.no_grad():
                far = torch.inf if maximum else -torch.inf
                won = torch.where(share > 0, values, far)
                gap = (values.amax(dim=2) - won.amin(dim=2) if maximum
                       else won.amax(dim=2) - values.amin(dim=2))
                self._count(kind, gap > 0, gap, 2 * TIE_RATIO * dev)
        return share

    def _replay_kink(self, x):
        mask = self._replay_mask("kink", x)
        return torch.where(mask, x, x * self.blocks.LEAKY_SLOPE)

    def _replay_pool(self, x, inds, inverse=None):
        from weasal_tpu_torch.ops.cuda.kpconv_fwd import gather_neighbors
        pooled = gather_neighbors(x, inds, 0.0)
        return (pooled * self._replay_winners("pool", x, pooled, True)).sum(
            dim=2)

    def _replay_top(self, prob):
        labels, dev = self._next("argmax", prob)
        if dev is not None:
            with torch.no_grad():
                gap = prob.amax(dim=1) - prob.gather(
                    1, labels[:, None])[:, 0]
                self._count("argmax", gap > 0, gap, 2 * TIE_RATIO * dev)
        return labels

    def _replay_influence(self, sq, extent, influence):
        if influence != "linear":
            return self.plain["influence_weights"](sq, extent, influence)
        t = 1.0 - torch.sqrt(sq) / extent
        mask = self._replay_mask("influence", t)
        return torch.where(mask, t, torch.zeros_like(t)).transpose(-1, -2)

    def _replay_in_range(self, sq, extent):
        mask, dev = self._next("in_range", sq)
        if dev is not None:
            with torch.no_grad():
                closest = sq.amin(dim=-1)
                self._count("in_range", mask != (closest < extent ** 2),
                            (closest - extent ** 2).abs(), TIE_RATIO * dev)
        return mask

    def _replay_nearest(self, sq):
        return (sq * self._replay_winners("nearest", sq, sq, False)).sum(
            dim=2)

    def recording(self):
        out = self._record_output
        return self._swap(dict(
            leaky_relu=self._record_kink, max_pool=self._record_pool,
            above=out("above", "row"),
            positive_classes=out("positive_classes", "class"),
            top_class=out("top_class", "argmax"),
            influence_weights=self._record_influence,
            in_range=out("in_range", "in_range"),
            nearest=self._record_nearest))

    @contextlib.contextmanager
    def replaying(self, run=None):
        """Replays the recorded branches; `run` 'plain' keeps the inputs
        of each call, 'f64' (after 'plain') counts the turned branches."""
        self.run, self.calls = run, dict.fromkeys(self.KINDS, 0)
        with self._swap(dict(
                leaky_relu=self._replay_kink, max_pool=self._replay_pool,
                above=lambda x, t: self._replay_mask("row", x, t),
                positive_classes=lambda m: self._replay_mask("class", m),
                top_class=self._replay_top,
                influence_weights=self._replay_influence,
                in_range=self._replay_in_range,
                nearest=self._replay_nearest)):
            yield
        made = {k: len(v) for k, v in self.recorded.items()}
        if self.calls != made:
            raise AssertionError(f"a replay made {self.calls} calls, the "
                                 f"recorded step {made}")
        self.run = None

    def turned_text(self) -> str:
        """The f64 step's turned branches by kind (of the recorded calls),
        for the log."""
        return ", ".join(f"{self.turned[k]} {k} ({len(self.recorded[k])} "
                         f"calls)" for k in self.KINDS)

    @classmethod
    def of_ranks(cls, parts, device):
        """The branches of one step over the spheres of data-parallel
        ranks (`parts`: each rank's `recorded`, in rank order): rows in
        sphere order, the classes rank 0's (every rank's are equal)."""
        merged = cls()
        for kind in cls.KINDS:
            merged.recorded[kind] = [
                (rows[0] if kind == "class" else torch.cat(rows)).to(device)
                for rows in zip(*(p[kind] for p in parts))]
        return merged


def compare_train_steps(model, opt_state, batch, config, log, plan=None,
                        label: str = "kernels", witness: bool = False,
                        held: bool = True, step_kw=None, given=None,
                        branches=None):
    """One step with the kernels and one on the plain versions (f32), from
    the same state and pyramid, each held to the same step on the plain
    versions in f64; with `plan`, also one replay of the kernel step
    captured in a CUDA graph, held to the f64 step as the kernel step is;
    with `witness`, the runs of `witness_runs`, each read on the tensor
    of the kernel step's largest share (not held). `label` names the
    kernel step in the log; held=False reads the errors and fails no
    check; `step_kw` goes to every step (`step_on_batch`: a pseudo-label
    step's contrast flag, dropout mask and drawn points, the same in each
    run). The steps held to each other take the kernel step's branches
    (`Branches`); the graph replays the kernel step with its own. `given`
    holds steps run elsewhere from the same state on the same spheres,
    by label: (loss, gradients, state after), each held to the f64 step
    as the kernel step is (phase 14's data-parallel ranks); with
    `branches` (those given steps' recorded `Branches`) every step here,
    the kernel step too, replays those. The model is left after the last
    f32 step. Returns the errors."""
    import copy
    import dataclasses
    from weasal_tpu_torch.train.step import step_on_batch
    from weasal_tpu_torch.utils.device import plain_ops
    check = expect if held else (lambda ok, msg: None)
    state0, opt0 = clone_state(model, opt_state)
    def double(t):
        return None if t is None else t.double()

    f64 = dataclasses.replace(
        batch, points=tuple(p.double() for p in batch.points),
        features=batch.features.double(), center_pts=batch.center_pts.double(),
        cloud_lb=double(batch.cloud_lb), region_lb=double(batch.region_lb))
    model64 = copy.deepcopy(model).double()
    runs = {}
    # the kernel step first: it records the branches the others replay;
    # the plain step before the f64 one, which reads the plain step's
    # deviation at each branch
    labels = [("kernels", model, batch, None),
              ("plain", model, batch, None),
              ("f64", model64, f64, torch.float64)]
    if plan is not None:
        labels.append(("graph", model, batch, None))
    extra = witness_runs() if witness else {}
    labels += [(run, model, batch, None) for run in extra]
    replay_given = branches is not None
    branches = branches if replay_given else Branches()
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
            if run == "kernels":
                stack.enter_context(branches.replaying() if replay_given
                                    else branches.recording())
            elif run != "graph":
                stack.enter_context(branches.replaying(run))
            if run == "graph":
                loss = replayed_step(net, opt, data, config, plan, step_kw)
            else:
                loss, _ = step_on_batch(net, opt, data, config,
                                        config.learning_rate,
                                        **(step_kw or {}))
        grads = {n: p.grad.double() for n, p in net.named_parameters()}
        moved = {k: v.double() - state0[k].double()
                 for k, v in net.state_dict().items() if v.is_floating_point()}
        runs[run] = (float(loss), grads, moved)
    del model64
    for run, (g_loss, g_grads, g_state) in (given or {}).items():
        runs[run] = (float(g_loss),
                     {n: g.to(state0[n].device).double()
                      for n, g in g_grads.items()},
                     {k: v.to(state0[k].device).double() - state0[k].double()
                      for k, v in g_state.items() if v.is_floating_point()})
    loss_k, loss_p = runs["kernels"][0], runs["plain"][0]
    check(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p),
           f"train step loss {loss_k} vs plain {loss_p}")
    turned = dict(branches.turned)
    check(turned["beyond"] == 0,
          f"the f64 step turns {turned['beyond']} of the kernel step's "
          f"branches by more than {TIE_RATIO} x the plain step's deviation "
          f"(worst {turned['worst']:.3g} x)")
    result = dict(loss=loss_k, loss_plain=loss_p, loss_f64=runs["f64"][0],
                  turned=turned, branch_calls={
                      k: len(v) for k, v in branches.recorded.items()})

    def allowance(part, name):
        ref = runs["f64"][part][name]
        err_p = float((runs["plain"][part][name] - ref).norm())
        return F64_RATIO * err_p + F64_FLOOR * float(ref.norm())

    for who in [w for w in ("kernels", "graph", *(given or {}))
                if w in runs]:
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
                check(err_k <= allowed,
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
            f"the allowed error {worst['share']:.3f}, {worst['share_of']}; "
            f"the f64 step's own values turn {branches.turned_text()} "
            f"branches of the kernel step's, "
            f"{turned['beyond']} beyond their margin (the farthest at "
            f"{turned['worst']:.3f} of it)")
        if who == "kernels":
            result.update(kernel_rel=worst.pop("rel"), **worst)
        else:
            result[who] = dict(loss=runs[who][0], **worst)
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
        check(abs(loss_g - loss_k) <= LOSS_RTOL * abs(loss_k),
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


# The host event that ties the profiler's clock to time.perf_counter()
PROFILE_MARK = "chip_smoke: profile start"


def profiled_kernels(fn, reps: int = 1, window=None, trace_dir=None):
    """([(kernel name, launches, device ms)] largest first, wall ms, busy
    ms) of `reps` calls of fn() inside `device_trace` (its Chrome trace
    written into `trace_dir` when given). The rows and the busy time come from torch.profiler's own
    events of the window, through the readers' naming (a split-K sum
    launch is named after the GEMM core's tile kernel that ran before it)
    and union (`named_intervals`, `rows_of`, `union_us`): busy is the
    length of the union of the kernels' intervals on the card (where
    kernels overlap, less than the sum of their times); with `window`, a
    function that returns a (start, end) of time.perf_counter() seconds
    after the calls, only of their parts inside it."""
    from torch.profiler import record_function
    torch.cuda.synchronize()
    with device_trace(trace_dir) as prof:
        with record_function(PROFILE_MARK):
            t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    named = named_intervals(
        (e.key, e.time_range.start, e.time_range.end) for e in events
        if str(e.device_type).endswith("CUDA")
        and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False))
    # the profiler's clock (us) at t0: host and kernel events share it
    span = None
    if window is not None:
        mark = next(e.time_range.start for e in events
                    if e.name == PROFILE_MARK)
        span = tuple(mark + (t - t0) * 1e6 for t in window())
    return rows_of(named), wall, union_us(named, span) / 1e3


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
        rows, *_ = profiled_kernels(fn, reps)
        kept = {}
        for name, count, ms in rows:
            key = (categorize_op(name), name.startswith(SPLITK_SUM))
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
# launches that a profile observes. `inverse_sum` counts the row sums
# over lists and the voxel run sums; C and D run their own stage 2
# (`inverse_sum_kernel`) inside their launches.
OBSERVED_KERNEL = {"radius_search": ("search_kernel",),
                   "kpconv_fwd": ("aggregate_kernel",),
                   "kpconv_bwd": ("tf32x3_gemm_kernel<false, false,",),
                   "maxpool_bwd": ("maxpool_bwd_kernel",),
                   "build_inverse_lists": ("inverse_build_kernel",),
                   "inverse_sum": ("list_sum_kernel", "run_sum_kernel")}
# Profiles of phase 6's graphed epoch taken before a difference between
# its kernel events and the counters fails the run (the profiler has lost
# kernel events on an H100; see `gemm_part_ms`)
PROFILE_TRIES = 3


def observed_calls(rows) -> dict:
    """Calls of each counted wrapper that profile rows (`profiled_kernels`)
    show, by OBSERVED_KERNEL."""
    return {fn: sum(n for name, n, _ in rows
                    if any(key in name for key in keys)
                    and not name.startswith(SPLITK_SUM))
            for fn, keys in OBSERVED_KERNEL.items()}


def profile_step(step, log, label: str, top: int = 12):
    """Device time of one call of `step` by kernel name (torch.profiler);
    returns (rows, busy ms, wall ms). Busy is the union of the kernels'
    intervals (`profiled_kernels`), so the idle share is 1 - busy / wall;
    the families' shares are of the summed kernel time."""
    rows, wall, busy = profiled_kernels(step)
    summed = sum(r[2] for r in rows)
    log(f"profile of one {label}: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), kernel times summed "
        f"{summed:.3f} ms, {len(rows)} kernels")
    for name, count, ms in rows[:top]:
        log(f"  {ms:9.3f} ms {count:4d}x  {name[:90]}")
    log(f"by family ({sum(r[1] for r in rows)} launches):")
    for family, count, ms in kernel_families(rows):
        log(f"  {ms:9.3f} ms {count:5d}x  {100 * ms / summed:5.1f}%  "
            f"{family}")
    return rows, busy, wall


def _log_rows(logdir):
    with open(os.path.join(logdir, "training_iteration0.txt")) as f:
        return [r.split() for r in f.readlines()[1:]]


def _same_state(got, want) -> bool:
    return set(got) == set(want) and all(
        torch.equal(got[k].cpu(), want[k].cpu()) for k in want)


def pyramid_print(pyr) -> str:
    """A short hash of a pyramid's bits: its points and features."""
    h = hashlib.sha1()
    for t in (*pyr.points, pyr.features):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:10]


def expect_one_share(what, prints, shares):
    """The plain pyramid of one batch, built again, repeats bit for bit
    (its voxel sums add in a fixed order), and the f64 step's share read
    on it within SHARE_REPEAT_RTOL."""
    spread = (max(shares) - min(shares)) / max(max(shares), 1e-30)
    expect(len(set(prints)) == 1 and spread <= SHARE_REPEAT_RTOL,
           f"{what}: one batch's plain pyramid built {len(prints)} times "
           f"gave prints {prints} and f64 shares {shares} (spread "
           f"{spread:.2e}, limit {SHARE_REPEAT_RTOL})")


def check_loop_shapes(trainer, card, log):
    """The kernels and the step at the loop's own shapes, after its runs:
    LOOP_CHECK_BATCHES batches of the loop's resident source (the
    trainer's plan, a fresh epoch's draws), each assembled on the card
    (voxel-sorted) into a pyramid on the plain versions. On the first
    pyramid A, B, C and D are held to their plain versions as in phases
    2 and 4, and the kernel training step, from the loop's seeded initial
    state, to an f64 step as in phase 5 (BatchNorm's gradients amplify a
    drift of one sign in B's outputs: the GEMM core's drift before its
    chains were cut put this batch at 1.66-1.70 of its allowance); the
    first batch's pyramid is built LOOP_F64_PYRAMIDS times, and each
    later one's hash must equal the first's and its share of the f64
    allowance lie within SHARE_REPEAT_RTOL of it (`expect_one_share`).
    Then
    the inverse-list builds and row sums of one `train_step` on the
    first batch with regions, checked and timed as in phase 5 (their
    device split by kernel name), and `train_step` on the batches that
    have regions, as the loop calls it:
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

    pyrs = [pyramid(drawn[0][0]) for _ in range(LOOP_F64_PYRAMIDS)]
    pyr = pyrs[0]
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
        def fresh():
            return KPFCNN_mprm(
                config, tuple(int(v) for v in train_ds.label_values),
                tuple(int(v) for v in train_ds.ignored_labels),
                generator=torch.Generator().manual_seed(0)).to(dev)

        runs = []
        for i, p in enumerate(pyrs):
            # pyramids 1.. are the same batch's built again: their bits
            # must repeat (the plain voxel sums add in a fixed order), and
            # so the f64 step's share, up to the plain step's atomics
            net = fresh()
            runs.append(compare_train_steps(
                net, init_opt_state(net), p, config, log,
                label="first loop batch, kernels" + (
                    f", pyramid {i}" if i else ""), held=i == 0))
            del net
        comparison = runs[0]
        shares = [r["share"] for r in runs]
        prints = [pyramid_print(p) for p in pyrs]
        comparison.update(pyramid_prints=prints, pyramid_shares=shares)
        log(f"[{card}] f64 step at the loop's shapes (first batch): share "
            f"of the f64 allowance {comparison['share']:.3f} (held); the "
            f"batch's pyramid built {LOOP_F64_PYRAMIDS} times: prints "
            f"{prints}, shares {shares}")
        expect_one_share("phase 6", prints, shares)
        expect(len(batches) >= 3, f"{len(batches)} of {len(drawn)} loop "
               "batches have regions")
    finally:
        PREFIX = ""

    def step(b):
        return train_step(trainer.model, trainer.opt_state, b, config, plan,
                          trainer.lr, device=dev, class_w=trainer.class_w,
                          table=trainer.table, spec=trainer.spec)

    log("phase 6: the inverse lists and the row sums at the loop's shapes")
    PREFIX = "loop shapes: "
    try:
        sums["inverse_lists"] = check_inverse_lists(
            record_inverse_calls(lambda: step(batches[0])), log)
    finally:
        PREFIX = ""

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


def entry_runs(run, root, logdir, repeat_dir, args, counted, per_step,
               per_val, card, log, what: str = "loop", resume: bool = True):
    """An entry point's `run` on the tile at `root` three times: 2 epochs
    into `logdir`, the same 2 seeded epochs again in a fresh trainer into
    `repeat_dir` (every loss and the checkpoint bit-equal), then (unless
    `resume` is False) a resume from `logdir`'s `current_chkp.tar` for a
    third. Launch counts are set
    to 0 just before each run and read just after; each run is checked by
    `_loop_report`, the checkpoint against the trained state and the
    state after resume against the checkpoint. Returns the reports, the
    repeat's comparison, the last trainer, the launches summed over the
    runs and the peak device memory."""
    from weasal_tpu_torch.train.trainer import ModelTrainer
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
    try:
        # "repeat": the first run's two seeded epochs again, in a
        # fresh trainer: its losses and checkpoint must be bit equal
        plans = [("run", logdir, ("--max_epoch", "2"), 2),
                 ("repeat", repeat_dir, ("--max_epoch", "2"), 2)]
        if resume:
            plans.append(("resume", logdir,
                          ("--resume", logdir, "--max_epoch", "3"), 3))
        for label, out, extra, epochs in plans:
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            trainer = run([out, "--data_root", root, *args, *extra])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            runs.append(_loop_report(label, trainer, out, epochs,
                                     launches, per_step, per_val,
                                     wall_s, card, log, what=what))
            if label == "repeat":
                repeat = compare_repeat(
                    losses.get(logdir, []), losses.get(repeat_dir, []),
                    chkp, os.path.join(repeat_dir, "checkpoints",
                                       "current_chkp.tar"), card, log,
                    what=what)
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
                       f"{what}: current_chkp.tar differs from the "
                       "trained state")
            elif label == "resume":
                expect(restored.get("epoch") == 2
                       and _same_state(restored["model"],
                                       saved["model_state_dict"])
                       and _same_state(restored["opt"],
                                       saved["optimizer_state_dict"]),
                       f"{what}: the state after resume differs from the "
                       "checkpoint")
                expect(trainer.epoch == 3, f"{what}: resume ended at epoch "
                       f"{trainer.epoch}, expected 3")
    finally:
        ModelTrainer.load_checkpoint = load_checkpoint
        ModelTrainer._flush_log = flush_log
        os.environ.pop("WEASAL_LOOP_STATS", None)
    return dict(runs=runs, repeat=repeat, trainer=trainer, total=total,
                peak=torch.cuda.max_memory_allocated())


def epoch_window(record):
    """(start, end) in time.perf_counter() seconds of a trainer's epoch
    (an entry of `epoch_times`)."""
    return record["start"], record["start"] + record["seconds"]


def profile_epoch(trainer, counted, per_step, total, card, log,
                  what: str = "loop"):
    """One more epoch of `trainer` (no validation, nothing saved) under
    torch.profiler: its device time by family and busy share, and its
    kernel events by name, which must count the launches that the
    counters add up from the replays (taken again where the profiler lost
    events). Adds the epoch's launches to `total`; returns the report."""
    first = trainer.datasets[0]
    trainer.config.saving = False
    for attempt in range(PROFILE_TRIES):
        trainer.config.max_epoch = trainer.epoch + 1
        for fn in counted:
            fn.launches = 0
        warm0 = trainer.graph_counts()["train_warmups"]
        # the epoch's own clock: the audit and the votes' materialization
        # after it run inside the profile
        rows, _, busy = profiled_kernels(
            lambda: trainer.train(first, None), window=lambda: epoch_window(
                trainer.epoch_times[-1]))
        launches = {fn.__name__: fn.launches for fn in counted}
        observed = observed_calls(rows)
        steps = trainer.epoch_times[-1]["steps"]
        wall = 1e3 * trainer.epoch_times[-1]["seconds"]
        warm = trainer.graph_counts()["train_warmups"] - warm0
        want = {k: per_step.get(k, 0) * (steps + warm) for k in launches}
        for k, v in launches.items():
            total[k] += v
        log(f"[{card}] {what} profiled epoch {attempt + 1}: {steps} steps, "
            f"launches by the counters {launches}, by kernel events "
            f"{observed}")
        if observed == launches:
            break
    expect(launches == want, f"{what} profiled epoch: launches {launches}, "
           f"expected {want} for {steps} steps")
    expect(observed == launches, f"{what} profiled epoch: kernel events "
           f"{observed} against the counters {launches} in "
           f"{PROFILE_TRIES} profiles")
    summed = sum(r[2] for r in rows)
    families = kernel_families(rows)
    log(f"[{card}] {what} epoch (graphed) under torch.profiler: {steps} "
        f"steps, wall "
        f"{wall:.1f} ms ({wall / max(steps, 1):.2f} ms per step), device "
        f"busy {busy:.1f} ms ({busy / max(steps, 1):.2f} ms per step, "
        f"{100 * busy / wall:.1f} % of the wall: the union of the kernels' "
        f"intervals inside the epoch's clock); kernel times summed over "
        f"the profile {summed:.1f} ms")
    for fam, count, ms in families:
        log(f"[{card}]   {ms:9.3f} ms {count:5d}x  "
            f"{100 * ms / summed:5.1f}%  {fam}")
    return dict(steps=steps, wall_ms=wall, busy_ms=busy,
                busy_share=busy / wall, summed_ms=summed,
                launches=launches, observed_launches=observed,
                profiles=attempt + 1, families=families)


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
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run

    t0 = time.perf_counter()
    root = make_vaihingen_like_root(
        os.path.join(work, "Vaihingen3D"), extent=LOOP_EXTENT,
        density=LOOP_DENSITY, seed=SEED)
    scene_s = time.perf_counter() - t0
    logdir = os.path.join(work, "log")
    loop = entry_runs(run, root, logdir, os.path.join(work, "log_repeat"),
                      LOOP_ARGS, counted, per_step, per_val, card, log)
    runs, repeat, trainer = loop["runs"], loop["repeat"], loop["trainer"]
    total, peak = loop["total"], loop["peak"]
    first = trainer.datasets[0]
    profile = profile_epoch(trainer, counted, per_step, total, card, log)
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


def compare_repeat(losses_a, losses_b, chkp_a, chkp_b, card, log,
                   what: str = "loop"):
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
    log(f"[{card}] {what} repeat: {len(losses_b)} losses "
        f"{'bit-equal' if same_losses else 'DIFFER'} to the first run's; "
        f"checkpoint {'bit-equal' if same_state else 'DIFFERS'}"
        + (f" ({len(differ)} tensors, e.g. {differ[:3]})" if differ else ""))
    expect(same_losses, f"{what} repeat: the losses of two seeded runs "
           f"differ: {losses_a} against {losses_b}")
    expect(same_state, f"{what} repeat: the checkpoints of two seeded runs "
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
        add(want, vote_launches(tester, per_val, "phase 8"))
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
            log(f"[{card}] phase 8 test_models --on {on}: {wall_s:.1f} s")
            report[f"test_{on}"] = dict(wall_s=wall_s, **vote_report(
                tm, per_val, "WeakLabel", log_name, [cloud],
                f"phase 8 test_models --on {on}", card, log, launches))

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
            # the epoch's own clock: the plan-saturation audit after it
            # runs inside the profile
            rows, _, b = profiled_kernels(
                lambda: _dispatch_epoch(runner),
                window=lambda: epoch_window(runner.epoch_times[-1]))
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
                 per_val, wall_s, card, log, what: str = "loop"):
    """Checks and numbers of one run of an entry point's loop (`what`:
    phase 6's "loop", phase 9's "PL loop")."""
    rows = _log_rows(logdir)
    steps = sum(e["steps"] for e in trainer.epoch_times)
    batches = sum(v["batches"] for v in trainer.val_times)
    losses = [float(r[2]) for r in rows]
    expect(len(rows) == steps > 0, f"{what} {label}: {len(rows)} log rows for "
           f"{steps} real steps")
    expect(all(np.isfinite(losses)), f"{what} {label}: non-finite losses")
    with open(os.path.join(logdir, "val_IoUs.txt")) as f:
        n_val = len(f.readlines())
    expect(n_val == epochs, f"{what} {label}: {n_val} validation lines, "
           f"expected {epochs}")
    expect(len(trainer.epoch_drops) == len(trainer.epoch_times)
           and not any(trainer.epoch_drops),
           f"{what} {label}: neighbor drops {trainer.epoch_drops}")
    counts = trainer.graph_counts()
    expect(trainer.graphed and counts["train_replayed_steps"] == steps
           and counts["eval_replays"] == batches,
           f"{what} {label}: {counts} for {steps} steps and {batches} "
           "validation batches: not every step and batch was replayed")
    # Each capture's warm-up runs one step (batch) on the card
    want = {k: per_step.get(k, 0) * (steps + counts["train_warmups"])
            + per_val.get(k, 0) * (batches + counts["eval_warmups"])
            for k in launches}
    expect(launches == want, f"{what} {label}: launches {launches}, "
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
                 anchors_s=train_ds.setup_seconds.get("anchors", 0.0),
                 calibration_s=trainer.calibration_seconds)
    log(f"[{card}] {what} {label}: {len(trainer.epoch_times)} epochs, {steps} "
        f"real steps, {batches} validation batches in {wall_s:.1f} s; "
        f"graphs {counts}; launches {launches}; losses {losses}; mIoU "
        f"{trainer.last_mIoU:.2f} %")
    for r in epochs_rep:
        parts = ", ".join(f"{k[:-12]} {r[k]:.2f}" for k in r
                          if k.endswith("_ms_per_step"))
        log(f"[{card}] {what} {label} epoch {r['epoch']}: "
            f"{r['ms_per_step']:.2f} ms per step over the epoch"
            + (f" ({parts} ms per step)" if parts else "")
            + f", {r['points_per_s']:.0f} real points/s")
    for v in vals:
        log(f"[{card}] {what} {label} validation after epoch {v['epoch']}: "
            f"{v['ms_per_batch']:.2f} ms per batch ({v['batches']} batches)")
    log(f"[{card}] {what} {label}: host ms between dispatches "
        f"{[round(g, 2) for g in gaps]}; ms per step over the epochs after "
        f"the first: {steady if steady is None else round(steady, 2)}")
    return dict(label=label, steps=steps, val_batches=batches,
                launches=launches, graphs=counts, losses=losses,
                wall_s=wall_s, dispatch_gaps_ms=gaps,
                step_ms_steady=steady, epochs=epochs_rep, validation=vals,
                setup=setup, mIoU=trainer.last_mIoU)


def pl_expected(config):
    """Launches per pseudo-label training step and per eval (validation
    or vote) batch: 3L-2 searches, one B (and one C) per KPConv that the
    kernels compute (a deformable conv's offset conv among them), one D
    per strided shortcut; the inverse lists of the L conv edges, the L-1
    pool and the L-1 upsample edges and the contrast loss's drawn rows;
    the row sums of the L-1 upsample gathers, the drawn rows' gather, the
    deformable convs' neighbor gathers and the L-1 voxel sums of the
    pyramid (an eval batch: the voxel sums)."""
    from weasal_tpu_torch import KPFCNN
    from weasal_tpu_torch.models.blocks import kernel_convs, kpconv_modules
    net = KPFCNN(config, tuple(range(config.num_classes)) + (10,), (10,))
    n_l, convs = config.num_layers, len(kernel_convs(net))
    deformable = sum(m.params.deformable for _, m in kpconv_modules(net))
    per_step = {"radius_search": 3 * n_l - 2, "kpconv_fwd": convs,
                "kpconv_bwd": convs, "maxpool_bwd": len(strided_pools(net)),
                "build_inverse_lists": n_l + 2 * (n_l - 1) + 1,
                "inverse_sum": 2 * (n_l - 1) + 1 + deformable}
    per_val = {"radius_search": 3 * n_l - 2, "kpconv_fwd": convs,
               "inverse_sum": n_l - 1}
    return per_step, per_val


def write_pl_labels(root):
    """Phase 9's refined labels under `root`/PseudoLabels/PL_LOG: the
    training tile's subsampled ground truth with a seeded PL_UNLABELED of
    it set to 10, and seeded class weights. Returns (truth, pseudo)."""
    from weasal_tpu_torch.utils.ply import read_ply
    cloud = "Vaihingen3D_Training"
    truth = read_ply(os.path.join(root, "input_0.240_torch", f"{cloud}.ply")
                     )["class"].astype(np.int32)
    rng = np.random.default_rng(SEED)
    pseudo = np.where(rng.random(truth.shape[0]) < PL_UNLABELED, 10, truth)
    out = os.path.join(root, "PseudoLabels", PL_LOG)
    os.makedirs(out, exist_ok=True)
    np.savetxt(os.path.join(out, f"{cloud}_t20_pseudo.txt"), pseudo,
               fmt="%i")
    np.savetxt(os.path.join(out, "Vaihingen3D_t20_weight.txt"),
               rng.uniform(0.5, 2.0, (1, 9)), fmt="%.3f")
    return truth, pseudo


def gemm_shape(conv, batch) -> tuple:
    """(M, N, K) of a KPConv's product y @ W on `batch`: the rows of all
    its spheres, Cout and Kp x Cin."""
    n_kp, cin, cout = conv.weights.shape
    rows = batch.points[conv.layer_ind + int(conv.strided)].shape
    return rows[0] * rows[1], cout, n_kp * cin


def check_stage_shapes(trainer, per_step, card, log, what):
    """A stage's kernels and step at its loop's own shapes, after the
    loop's runs (phases 9 and 10; `what` names the stage in the log):
    LOOP_CHECK_BATCHES batches of its resident source (a fresh epoch's
    draws; in weak mode those with regions), the first assembled on the
    card into a pyramid on the plain versions. On it A, B, C and D are
    held to their plain versions as in phases 2 and 4, each conv's GEMM
    shape (M, N, K) is logged, and the GEMM core's drift is held at the
    deepest conv as phase 2 holds it; one kernel training step from the
    seeded initial state, eager and replayed, to an f64 step as in phase
    5 (a pseudo-label step with its dropout mask and contrast draw given:
    a seeded mask, PL_SLC labeled points), and the same batch's pyramid
    built LOOP_F64_PYRAMIDS - 1 times more, each stepped against its own
    f64 step, their prints and shares held as phase 6 holds its
    rebuilds; the inverse lists and
    row sums of one `train_step` checked and timed as in phase 5. Then
    `train_step` on the batches (launches per step, synchronized ms) and a
    profile of one step. Returns the kernels' sums, the readings, the
    pyramid and the step function."""
    global PREFIX
    from weasal_tpu_torch import init_opt_state, train_step
    from weasal_tpu_torch.data.loader import BatchPrefetcher
    from weasal_tpu_torch.data.resident import (ResidentBatchSource,
                                                assemble_level0_device)
    from weasal_tpu_torch.models.architectures import model_for_config
    from weasal_tpu_torch.models.blocks import dropout_keep, kernel_convs
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.train.graphs import COUNTED, launch_counts
    from weasal_tpu_torch.utils.device import plain_ops
    config, plan, dev = trainer.config, trainer.plan, trainer.device
    pseudo = trainer.mode == "pseudo"
    seed = torch.tensor(SEED, dtype=torch.int64, device=dev)
    train_ds = trainer.datasets[0]
    source = ResidentBatchSource(train_ds, plan, dev)
    drawn = list(BatchPrefetcher(
        source, LOOP_CHECK_BATCHES, dev, rng=np.random.default_rng(SEED),
        extra_arrays=source.resident.arrays))
    batches = [b for b, metas in drawn
               if pseudo or any(m["has_regions"] for m in metas)]
    expect(len(batches) >= 3, f"{what}: {len(batches)} of {len(drawn)} "
           "batches have regions")

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

    pyrs = [pyramid(batches[0]) for _ in range(LOOP_F64_PYRAMIDS)]
    pyr = pyrs[0]
    log(f"{what}: kernels vs plain versions at the loop's shapes, {plan}, "
        f"{int(pyr.masks[0].sum())} real level-0 points")
    PREFIX = f"{what} shapes: "
    try:
        with torch.no_grad():
            checks = dict(radius_search=check_radius_search(pyr, config,
                                                            plan, log),
                          kpconv_fwd=check_kpconv(trainer.model, pyr, log,
                                                  SEED))
        checks["kpconv_bwd"] = check_kpconv_bwd(trainer.model, pyr, log,
                                                SEED)
        checks["maxpool_bwd"] = check_maxpool_bwd(trainer.model, pyr, log,
                                                  SEED)
        sums = {k: v[1] for k, v in checks.items()}
        shapes = {k: v[0] for k, v in checks.items()}
        convs = kernel_convs(trainer.model)
        gemms = {name: gemm_shape(conv, pyr) for name, conv in convs}
        log(f"{what}: GEMM shapes (M, N, K) of y @ W by conv: {gemms}")
        # the drift check of phase 2 at the deepest conv (the largest
        # Kp x Cin; its rows as the plan gives them)
        name, wide = max(convs, key=lambda m: gemms[m[0]][2])
        n_kp, cin, cout = wide.weights.shape
        level = wide.layer_ind + int(wide.strided)
        log(f"{what}: GEMM core drift at the deepest conv {name}, (M, N, "
            f"K) = {gemms[name]}")
        gemm_bias = check_gemm_bias(log, SEED, shape=(
            config.batch_num, plan.num_points[level],
            plan.conv_neighbors[wide.layer_ind], n_kp, cin, cout))
        step_kw = None
        if pseudo:
            b, n0 = pyr.labels.shape
            keep = dropout_keep((b, n0, config.first_features_dim),
                                config.dropout, seed)
            labeled = ((pyr.labels >= 0)
                       & (pyr.labels < config.num_classes)
                       & pyr.masks[0]).reshape(-1).nonzero().flatten()
            gen = torch.Generator(device=dev).manual_seed(SEED)
            slc = labeled[torch.randint(labeled.numel(), (PL_SLC,),
                                        generator=gen, device=dev)]
            step_kw = dict(use_contrast=True, dropout_keep=keep,
                           slc_idx=slc)
        runs = []
        for i, p in enumerate(pyrs):
            # pyramids 1.. are the same batch's built again, each stepped
            # with the same draws: their bits must repeat, their shares
            # up to the plain step's atomics (not replayed)
            net = model_for_config(
                config, train_ds.label_values, train_ds.ignored_labels,
                generator=torch.Generator().manual_seed(0)).to(dev)
            runs.append(compare_train_steps(
                net, init_opt_state(net), p, config, log,
                plan=plan if i == 0 else None,
                label=f"{what} step, kernels" + (f", pyramid {i}" if i
                                                 else ""),
                held=i == 0, step_kw=step_kw))
            del net
        comparison = runs[0]
        shares = [r["share"] for r in runs]
        prints = [pyramid_print(p) for p in pyrs]
        comparison.update(pyramid_prints=prints, pyramid_shares=shares)
        log(f"[{card}] f64 {what} step (first batch): share of the f64 "
            f"allowance {comparison['share']:.3f} (held; replayed "
            f"{comparison['graph']['share']:.3f}); the batch's pyramid "
            f"built {LOOP_F64_PYRAMIDS} times: prints {prints}, shares "
            f"{shares}")
        expect_one_share(what, prints, shares)
    finally:
        PREFIX = ""

    def step(batch):
        return train_step(trainer.model, trainer.opt_state, batch, config,
                          plan, trainer.lr, device=dev,
                          class_w=trainer.class_w, table=trainer.table,
                          spec=trainer.spec, seed=SEED, use_contrast=pseudo)

    log(f"{what}: the inverse lists and the row sums at the loop's shapes")
    PREFIX = f"{what} shapes: "
    try:
        sums["inverse_lists"] = check_inverse_lists(
            record_inverse_calls(lambda: step(batches[0])), log)
    finally:
        PREFIX = ""
    for fn in COUNTED:
        fn.launches = 0
    sync_ms = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    want = {k: v * len(batches) for k, v in per_step.items()}
    expect(launches == want, f"{what} train_step: launches {launches} in "
           f"{len(batches)} steps, expected {want}")
    log(f"[{card}] {what} train_step on {len(batches)} loop batches: "
        f"synchronized {[round(v, 2) for v in sync_ms]} ms; launches "
        f"{launches}")
    rows, busy, wall = profile_step(lambda: step(batches[1]), log,
                                    f"{what} train_step")
    return sums, dict(compare=comparison, sync_ms=sync_ms,
                      launches=launches, shapes=shapes, gemm_shapes=gemms,
                      widest_gemm=dict(conv=name, mnk=gemms[name]),
                      gemm_bias=gemm_bias,
                      step_profile=dict(busy_ms=busy, wall_ms=wall,
                                        families=kernel_families(rows))
                      ), pyr, step


def check_pl_shapes(trainer, per_step, card, log):
    """Phase 9 at the pseudo-label loop's own shapes: `check_stage_shapes`,
    then profiles of the contrast loss (forward and backward) and of the
    dropout mask at the step's shapes. Returns the kernels' sums and the
    readings."""
    from weasal_tpu_torch.models import losses
    from weasal_tpu_torch.models.blocks import dropout_keep
    config, dev = trainer.config, trainer.device
    seed = torch.tensor(SEED, dtype=torch.int64, device=dev)
    sums, at_plan, pyr, _ = check_stage_shapes(trainer, per_step, card,
                                               log, "phase 9 PL")
    busy = at_plan["step_profile"]["busy_ms"]
    # the contrast loss and the dropout mask alone, at the step's shapes
    trainer.model.eval()
    with torch.no_grad():
        logits = trainer.model(pyr)
    c = logits.shape[-1]
    flat = logits.reshape(-1, c).detach().requires_grad_()
    raw = pyr.labels.reshape(-1)
    flat_labels = torch.where(raw >= 0, raw,
                              torch.full_like(raw, config.num_classes + 1))

    def contrast():
        loss = losses.contrast_loss(flat, flat_labels,
                                    pyr.masks[0].reshape(-1),
                                    config.num_classes,
                                    config.contrast_thd / 100.0, seed=seed)
        loss.backward()

    torch.cuda.reset_peak_memory_stats()
    c_rows, c_busy, _ = profile_step(contrast, log,
                                     "PL contrast loss (forward and "
                                     "backward)")
    c_peak = torch.cuda.max_memory_allocated()
    b, n0 = pyr.labels.shape
    d_rows, d_busy, _ = profile_step(
        lambda: dropout_keep((b, n0, config.first_features_dim),
                             config.dropout, seed), log,
        "PL dropout mask")
    log(f"[{card}] PL step device {busy:.2f} ms "
        f"({100 * busy / at_plan['step_profile']['wall_ms']:.1f} % of its "
        f"wall); the contrast loss {c_busy:.2f} ms "
        f"({100 * c_busy / busy:.1f} % of the step; peak allocation "
        f"while it ran {c_peak / 2**20:.0f} MiB, on {flat.shape[0]} "
        f"rows), the "
        f"dropout mask {d_busy:.2f} ms ({100 * d_busy / busy:.1f} %)")
    at_plan.update(contrast=dict(busy_ms=c_busy, share=c_busy / busy,
                                 peak_bytes=c_peak,
                                 families=kernel_families(c_rows)),
                   dropout_mask=dict(busy_ms=d_busy, share=d_busy / busy,
                                     families=kernel_families(d_rows)))
    return sums, at_plan


def run_pseudo_label(root, work, counted, card, log):
    """Phase 9: the pseudo-label stage at full VaihingenPLConfig width on
    phase 6's tile, through its entry point
    (`weasal_tpu_torch.train_Vaihingen3D_PseudoLabel.run`) on refined
    labels written by `write_pl_labels`: 2 graphed epochs of 10 steps
    with 5 validation batches, again in a fresh trainer (losses and
    checkpoint bit-equal), then a resume (`entry_runs`, with the launches
    per step and per validation batch of `pl_expected`); one more epoch
    profiled (`profile_epoch`); the kernels and the f64 step at the loop's
    shapes (`check_pl_shapes`); one acquisition (`--al_iterations 1
    --epoch_schedule 1,1`, a vote of 2: every training step, validation
    and vote batch replayed, the ground-truth ledger grown by
    `added_labels_per_epoch` points, iteration 1 trained on their ground
    truth); `test_models --on test` on the PL log (1 vote: the plys, the
    launches, finite votes). Returns the report and the launches of its
    main-path runs."""
    import pickle
    from weasal_tpu_torch.config import VaihingenPLConfig
    from weasal_tpu_torch.test_models import main as test_models
    from weasal_tpu_torch.train.tester import ModelTester
    from weasal_tpu_torch.train.trainer import ModelTrainer
    from weasal_tpu_torch.train_Vaihingen3D_PseudoLabel import run

    cloud = "Vaihingen3D_Training"
    truth, pseudo = write_pl_labels(root)
    config = VaihingenPLConfig()
    config.num_classes = 9
    per_step, per_val = pl_expected(config)
    log(f"phase 9: {truth.shape[0]} training points, "
        f"{int((pseudo == 10).sum())} without a label; launches expected "
        f"per step {per_step}, per eval batch {per_val}")

    def add(total, part):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v

    cwd = os.getcwd()
    os.chdir(work)
    report = {}
    try:
        logdir = os.path.join(work, "pl_log")
        loop = entry_runs(run, root, logdir, os.path.join(work,
                                                          "pl_log_repeat"),
                          PL_ARGS, counted, per_step, per_val, card, log,
                          what="PL loop")
        trainer, total = loop["trainer"], loop["total"]
        profile = profile_epoch(trainer, counted, per_step, total, card,
                                log, what="PL loop")
        kernel_sums, at_plan = check_pl_shapes(trainer, per_step, card, log)
        loop_ms = [r["step_ms_steady"] for r in loop["runs"]
                   if r["step_ms_steady"]]
        log(f"[{card}] PL loop ms per step (epochs after each run's "
            f"first): {[round(v, 2) for v in loop_ms]}; peak device memory "
            f"of the 3 runs {loop['peak'] / 2**20:.1f} MiB; {trainer.plan}")
        report.update(runs=loop["runs"], repeat=loop["repeat"],
                      plan=vars(trainer.plan), peak_bytes=loop["peak"],
                      profile=profile, kernels=kernel_sums,
                      at_plan=at_plan, per_step=per_step, per_val=per_val)

        # one acquisition
        ledger_file = os.path.join(root, "input_0.240_torch",
                                   f"{cloud}_al_groundTruth_IDs.pkl")

        def ledger():
            with open(ledger_file, "rb") as f:
                return [int(v) for v in np.asarray(pickle.load(f)).ravel()]

        ledgers, trainers = {}, []
        extend, train = ModelTester._extend_gt_ledger, ModelTrainer.train

        def keep_ledgers(self, dataset, all_probs):
            ledgers["before"] = ledger()
            extend(self, dataset, all_probs)
            ledgers["after"] = ledger()

        def keep_trainer(self, *args, **kwargs):
            trainers.append(self)
            return train(self, *args, **kwargs)

        for fn in counted:
            fn.launches = 0
        al_dir = os.path.join(work, "results", "PseudoLabel", PL_LOG)
        t0 = time.perf_counter()
        ModelTester._extend_gt_ledger = keep_ledgers
        ModelTrainer.train = keep_trainer
        try:
            last = run([al_dir, "--data_root", root, *PL_ARGS,
                        "--al_iterations", "1", "--epoch_schedule", "1,1",
                        "--al_votes", "2"])
        finally:
            ModelTester._extend_gt_ledger = extend
            ModelTrainer.train = train
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        add(total, launches)
        want = {}
        for t in trainers:
            counts = t.graph_counts()
            steps = sum(e["steps"] for e in t.epoch_times)
            batches = sum(v["batches"] for v in t.val_times)
            expect(counts["train_replayed_steps"] == steps
                   and counts["eval_replays"] == batches,
                   f"phase 9: training {counts} for {steps} steps and "
                   f"{batches} validation batches")
            add(want, {k: per_step.get(k, 0)
                       * (steps + counts["train_warmups"])
                       + per_val.get(k, 0)
                       * (batches + counts["eval_warmups"])
                       for k in launches})
        tester = last.testers[0] if getattr(last, "testers", None) else None
        expect(tester is not None and len(trainers) == 2,
               f"phase 9: {len(trainers)} trainings and "
               f"{0 if tester is None else 1} acquisition")
        if tester is not None:
            add(want, vote_launches(tester, per_val, "phase 9"))
        expect(launches == want, f"phase 9 entry point: launches "
               f"{launches}, expected {want}")
        before, after = ledgers.get("before", []), ledgers.get("after", [])
        added = last.config.added_labels_per_epoch
        gained = last.datasets[0].input_labels[0]
        expect(len(after) == len(before) + added and len(set(after))
               == len(after) and np.array_equal(gained[after], truth[after]),
               f"phase 9: GT ledger {len(before)} -> {len(after)} points "
               f"({len(set(after))} distinct), expected +{added} trained "
               "on their ground truth")
        with open(os.path.join(al_dir, "training_iteration1.txt")) as f:
            header = f.readline()
        expect(header.rstrip().endswith(f"ground truth labels: "
                                        f"{len(after)}"),
               f"phase 9: iteration 1's log header {header.strip()!r}")
        vote = dict(tester.vote_times[0]) if tester is not None else {}
        log(f"[{card}] phase 9 entry point with one acquisition: "
            f"{wall_s:.1f} s; GT ledger {len(before)} -> {len(after)}; "
            f"acquisition vote {vote.get('batches')} batches in "
            f"{vote.get('seconds', 0.0):.2f} s; launches {launches}")
        report["entry"] = dict(wall_s=wall_s, ledger=[len(before),
                                                      len(after)],
                               vote=vote, launches=launches)

        # the workflow's last step: test_models on the PL log
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        tm = test_models(["--log", al_dir, "--on", "test", "--num_votes",
                          "1", "--data_root", root])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        add(total, launches)
        log(f"[{card}] phase 9 test_models --on test: {wall_s:.1f} s")
        report["test_models"] = dict(wall_s=wall_s, **vote_report(
            tm, per_val, "PseudoLabel", PL_LOG, ["Vaihingen3D_Testing"],
            "phase 9 test_models --on test", card, log, launches))
    finally:
        os.chdir(cwd)
    return report, total



def vote_launches(tester, per_val, what):
    """The launches of a tester's vote pass, `per_val` for each of its
    batches and graph warm-ups; checks that every vote batch was a
    replay."""
    graph = tester._eval_graph
    batches = sum(v["batches"] for v in tester.vote_times)
    expect(tester.graphed and graph.replays == batches,
           f"{what}: {graph.replays} vote replays for {batches} vote "
           "batches")
    return {k: n * (batches + graph.warmup_steps)
            for k, n in per_val.items()}


def vote_report(tm, per_val, stage_dir, log_name, clouds, what, card, log,
                launches):
    """Checks and numbers of one `test_models` pass (phases 8-10): every
    vote batch replayed, the launches of its replays and warm-up, the
    clouds voted, one prediction, probability and potential ply per cloud
    (the first two with the cloud's points), finite votes; ms per vote
    batch and voted points/s."""
    from weasal_tpu_torch.utils.ply import read_ply
    per_pass = vote_launches(tm, per_val, what)
    want = {k: per_pass.get(k, 0) for k in launches}
    expect(launches == want, f"{what}: launches {launches}, expected {want}")
    expect(tm.dataset.cloud_names_split == clouds,
           f"{what}: voted {tm.dataset.cloud_names_split}, expected {clouds}")
    out = os.path.join("test", stage_dir, log_name)
    for i, name in enumerate(tm.dataset.cloud_names_split):
        n_eval = len(tm.dataset.validation_labels[i])
        for sub in ("predictions", "probs", "potentials"):
            path = os.path.join(out, sub, f"{name}.ply")
            ok = os.path.exists(path)
            if ok and sub != "potentials":
                ok = read_ply(path)["x"].shape[0] == n_eval
            expect(ok, f"{what}: {path} missing or not {n_eval} points")
    expect(all(np.isfinite(p).all() for p in tm.test_probs),
           f"{what}: non-finite votes")
    vote = dict(tm.vote_times[0])
    n_sub = sum(len(lbl) for lbl in tm.dataset.input_labels)
    n_eval = sum(len(lbl) for lbl in tm.dataset.validation_labels)
    log(f"[{card}] {what}: {len(clouds)} clouds ({n_sub} subsampled "
        f"points, {n_eval} projected), vote {vote['batches']} batches in "
        f"{vote['seconds']:.2f} s "
        f"({1e3 * vote['seconds'] / vote['batches']:.2f} ms a batch, "
        f"{vote['points'] / vote['seconds']:.0f} voted points/s); launches "
        f"{launches}")
    return dict(vote=vote, launches=launches, clouds=len(clouds))


def run_dales(work, counted, wl_per, card, log):
    """Phase 10: the DALES workflow at full width, through the entry
    points, on a synthetic DALES-like root (DALES_TILES training and
    validation tiles and DALES_TEST_TILES test tiles of DALES_EXTENT m):
    (i) the graphed WL loop (`train_DALES_WeakLabel.run`, DALESWLConfig:
    2 epochs of 10 steps with 5 validation batches, the same again in a
    fresh trainer, bit-equal, and a resume; `entry_runs`, with `wl_per`,
    the WL launches per step and per validation batch), one more epoch
    profiled, and the kernels and the f64 step at its shapes
    (`check_stage_shapes`); (ii) `test_models --on train` (1 vote) over
    the training tiles, the refinement at the DALES default threshold
    (10 %: one pseudo-label file per training tile and the class
    weights), then the graphed PL loop (`train_DALES_PseudoLabel.run`,
    DALESPLConfig) on labels written from the ground truth (a seeded
    PL_UNLABELED set to 10: 20 WL steps leave the refinement no confident
    label) with the refinement's class weights, its profiled epoch and
    its kernel checks, and `test_models --on test` (1 vote) over every
    test tile. Returns the report and the launches of the WL and the PL
    paths (loops, profiled epochs, votes)."""
    from weasal_tpu_torch.config import DALESPLConfig
    from weasal_tpu_torch.data.synthetic import make_dales_like_root
    from weasal_tpu_torch.pseudoLabel_refinement import main as refine
    from weasal_tpu_torch.test_models import main as test_models
    from weasal_tpu_torch.train_DALES_PseudoLabel import run as run_pl
    from weasal_tpu_torch.train_DALES_WeakLabel import run as run_wl
    from weasal_tpu_torch.utils.ply import read_ply

    t0 = time.perf_counter()
    root = make_dales_like_root(
        os.path.join(work, "DALES"), extent=DALES_EXTENT,
        density=DALES_DENSITY, seed=SEED, train_tiles=DALES_TILES,
        test_tiles=DALES_TEST_TILES)
    n_tiles = DALES_TILES + DALES_TEST_TILES
    scene_s = time.perf_counter() - t0
    training = [f"tile_{i:02d}" for i in range(DALES_TILES - 1)]
    test = [f"test_tile_{i:02d}" for i in range(DALES_TEST_TILES)]
    log(f"phase 10: {n_tiles} DALES-like tiles of {DALES_EXTENT:.0f} m in "
        f"{scene_s:.1f} s of host ({scene_s / n_tiles:.2f} s a tile); "
        f"training {training}, test {test}")
    wl_step, wl_val = wl_per
    pl_config = DALESPLConfig()
    pl_config.num_classes = 9
    pl_step, pl_val = pl_expected(pl_config)
    report = dict(scene_s=scene_s, tiles=n_tiles)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # (i) the WL loop
        wl_log = os.path.join(work, "results", "WeakLabel", DALES_LOG)
        loop = entry_runs(run_wl, root, wl_log,
                          os.path.join(work, "dales_wl_repeat"), DALES_ARGS,
                          counted, wl_step, wl_val, card, log,
                          what="DALES WL loop")
        trainer, wl_total = loop["trainer"], loop["total"]
        train_ds = trainer.datasets[0]
        expect(train_ds.cloud_names_split == training,
               f"phase 10: WL training tiles {train_ds.cloud_names_split}")
        n_points = [len(l) for l in train_ds.input_labels]
        profile = profile_epoch(trainer, counted, wl_step, wl_total, card,
                                log, what="DALES WL loop")
        wl_sums, wl_at, _, _ = check_stage_shapes(trainer, wl_step, card,
                                                  log, "phase 10 DALES WL")
        setup = loop["runs"][0]["setup"]
        log(f"[{card}] DALES WL loop: training tiles of {n_points} "
            f"subsampled points, {[len(a) for a in train_ds.anchors]} "
            f"anchors; host set-up of the first run: "
            + ", ".join(f"{k} {v:.2f} s" for k, v in setup.items())
            + f" ({setup['subsample_s'] / (len(training) + 1):.2f} s a tile"
            f" to subsample with its trees, "
            f"{setup['anchors_s'] / len(training):.2f} s a tile for "
            f"anchors); peak device memory of the 3 runs "
            f"{loop['peak'] / 2**20:.1f} MiB; {trainer.plan}")
        report["wl"] = dict(runs=loop["runs"], repeat=loop["repeat"],
                            plan=vars(trainer.plan), peak_bytes=loop["peak"],
                            profile=profile, kernels=wl_sums, at_plan=wl_at,
                            tile_points=n_points, per_step=wl_step,
                            per_val=wl_val)
        del trainer, loop

        # (ii) test_models --on train, the refinement
        for fn in counted:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tm = test_models(["--log", wl_log, "--on", "train", "--num_votes",
                          "1", "--data_root", root])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        for k, v in launches.items():
            wl_total[k] += v
        report["test_train"] = dict(
            wall_s=wall_s, peak_bytes=torch.cuda.max_memory_allocated(),
            **vote_report(tm, wl_val, "WeakLabel", DALES_LOG, training,
                          "phase 10 test_models --on train", card, log,
                          launches))
        del tm
        t0 = time.perf_counter()
        out_dir = refine(["--weak_label_log", DALES_LOG, "--data_root",
                          root])
        refine_s = time.perf_counter() - t0
        weights = np.loadtxt(os.path.join(out_dir, "DALES_t10_weight.txt"))
        no_label = []
        for i, name in enumerate(training):
            path = os.path.join(out_dir, f"{name}_t10_pseudo.txt")
            labels = np.loadtxt(path) if os.path.exists(path) else []
            expect(len(labels) == n_points[i], f"phase 10 refinement: "
                   f"{len(labels)} pseudo labels for {name}'s "
                   f"{n_points[i]} points")
            no_label.append(int(np.sum(np.asarray(labels) == 10)))
        expect(weights.shape == (9,) and np.isfinite(weights).all(),
               f"phase 10 refinement: class weights {weights}")
        log(f"[{card}] phase 10 test_models --on train: {wall_s:.1f} s, peak "
            f"device memory {report['test_train']['peak_bytes'] / 2**20:.1f}"
            f" MiB; refinement (threshold 10): {refine_s:.2f} s of host for "
            f"{sum(n_points)} points ({no_label} no-label by tile); weights "
            f"{np.round(weights, 3).tolist()}")
        report.update(refine_s=refine_s, no_label=no_label)

        # the PL stage's labels: the ground truth, PL_UNLABELED set to 10
        rng = np.random.default_rng(SEED)
        for name in training:
            truth = read_ply(os.path.join(root, "input_0.400_torch",
                                          f"{name}.ply"))["class"]
            np.savetxt(os.path.join(out_dir, f"{name}_t10_pseudo.txt"),
                       np.where(rng.random(truth.shape[0]) < PL_UNLABELED,
                                10, truth), fmt="%i")
        pl_log = os.path.join(work, "results", "PseudoLabel", DALES_LOG)
        loop = entry_runs(run_pl, root, pl_log,
                          os.path.join(work, "dales_pl_repeat"),
                          ("--weak_label_log", DALES_LOG, *DALES_ARGS),
                          counted, pl_step, pl_val, card, log,
                          what="DALES PL loop")
        trainer, pl_total = loop["trainer"], loop["total"]
        expect(trainer.config.class_w == list(weights),
               f"phase 10: the PL stage's class weights "
               f"{trainer.config.class_w}, the refinement's {weights}")
        profile = profile_epoch(trainer, counted, pl_step, pl_total, card,
                                log, what="DALES PL loop")
        pl_sums, pl_at, _, _ = check_stage_shapes(trainer, pl_step, card,
                                                  log, "phase 10 DALES PL")
        log(f"[{card}] DALES PL loop: peak device memory of the 3 runs "
            f"{loop['peak'] / 2**20:.1f} MiB; {trainer.plan}")
        report["pl"] = dict(runs=loop["runs"], repeat=loop["repeat"],
                            plan=vars(trainer.plan), peak_bytes=loop["peak"],
                            profile=profile, kernels=pl_sums, at_plan=pl_at,
                            per_step=pl_step, per_val=pl_val)
        del trainer, loop

        # test_models --on test over every test tile
        for fn in counted:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tm = test_models(["--log", pl_log, "--on", "test", "--num_votes",
                          "1", "--data_root", root])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        for k, v in launches.items():
            pl_total[k] += v
        expect(not tm.dataset.has_labels, "phase 10 test_models --on test: "
               "the test tiles' labels were read")
        report["test_test"] = dict(
            wall_s=wall_s, peak_bytes=torch.cuda.max_memory_allocated(),
            **vote_report(tm, pl_val, "PseudoLabel", DALES_LOG, test,
                          "phase 10 test_models --on test", card, log,
                          launches))
        log(f"[{card}] phase 10 test_models --on test: {wall_s:.1f} s; peak "
            f"device memory {report['test_test']['peak_bytes'] / 2**20:.1f} "
            "MiB")
    finally:
        os.chdir(cwd)
    return report, wl_total, pl_total


def deformable_pl_config():
    """VaihingenPLConfig with DEFORM_BLOCKS made deformable: its layer-3
    resnetb and its layer-4 blocks (KPConv-PyTorch's train_S3DIS.py
    pattern, whence the PL config's deform_radius, repulse_extent and
    deform_lr_factor); widths, levels and spheres are the PL config's."""
    from weasal_tpu_torch.config import VaihingenPLConfig
    arch = list(VaihingenPLConfig.architecture)
    for i, name in DEFORM_BLOCKS.items():
        if name.replace("_deformable", "") != arch[i]:
            raise AssertionError(f"block {i} is {arch[i]}, not {name}'s "
                                 "rigid twin")
        arch[i] = name
    return type("DeformablePLConfig", (VaihingenPLConfig,),
                {"architecture": arch})


def time_deformable_convs(model, pyr, card, log):
    """Each deformable conv of `model` at its shapes on `pyr`: forward
    and forward + backward (dX, dW, the offset conv's and the offsets'
    gradients, with the edge's inverse lists built once) in CUDA-event ms
    and in device busy ms (torch.profiler), the peak device memory of one
    forward + backward above what was allocated before it, and the size
    of its largest tensor, the differences [B, Nq, K, Kp, 3]."""
    from weasal_tpu_torch.models.blocks import (conv_inputs, conv_inverse,
                                                kpconv_modules)
    dev = pyr.features.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model.eval()
    rows = []
    for name, conv in kpconv_modules(model):
        if not conv.params.deformable:
            continue
        q, s, nb, _ = conv_inputs(conv.strided, conv.layer_ind, pyr)
        inverse = conv_inverse(conv.strided, conv.layer_ind, pyr)
        n_kp, cin, cout = conv.weights.shape
        x = torch.randn((s.shape[0], s.shape[1], cin), generator=gen,
                        device=dev, requires_grad=True)
        g = torch.randn((q.shape[0], q.shape[1], cout), generator=gen,
                        device=dev)

        def forward():
            with torch.no_grad():
                return conv(q, s, nb, x, inverse)

        def forward_backward():
            torch.autograd.backward(conv(q, s, nb, x, inverse), g)

        forward_backward()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        forward_backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        fwd_ms, fb_ms = cuda_ms(forward), cuda_ms(forward_backward)
        _, _, fwd_busy = profiled_kernels(forward, reps=3)
        _, _, fb_busy = profiled_kernels(forward_backward, reps=3)
        diffs = 4.0 * q.shape[0] * q.shape[1] * nb.shape[2] * n_kp * 3
        row = dict(conv=name, shape=[*q.shape[:2], s.shape[1], nb.shape[2],
                                     cin, cout],
                   fwd_ms=fwd_ms, fwd_bwd_ms=fb_ms,
                   fwd_busy_ms=fwd_busy / 3, fwd_bwd_busy_ms=fb_busy / 3,
                   peak_bytes=peak, diffs_bytes=diffs)
        rows.append(row)
        log(f"[{card}] deformable {name}: q{list(q.shape[:2])} "
            f"Ns={s.shape[1]} K={nb.shape[2]} {cin}->{cout}: forward "
            f"{fwd_ms:.3f} ms (device busy {fwd_busy / 3:.3f}), forward + "
            f"backward {fb_ms:.3f} ms (busy {fb_busy / 3:.3f}); peak "
            f"{peak / 2**20:.1f} MiB above the allocated, the differences "
            f"{diffs / 2**20:.1f} MiB")
    model.zero_grad(set_to_none=True)
    return rows


def run_deformable(root, work, counted, card, log):
    """Phase 11: the pseudo-label stage with deformable convs at full
    VaihingenPLConfig width (`deformable_pl_config`) on phase 9's tile and
    refined labels, through the PL entry point's stage runner with that
    configuration: one graphed epoch of 10 steps (K = 1) with 2 validation
    batches, the same again in a fresh trainer (losses, offset losses and
    checkpoint bit-equal); the checks of `_loop_report` with the launches
    of `pl_expected` (the offset convs on B and C, one row sum more a
    deformable conv); the offset loss finite and non-zero at every step.
    The run's checkpoint exported to the reference's format
    (`python -m weasal_tpu_torch.export_torch_checkpoint`), reloaded into
    a fresh trainer (momentum zero, epoch 1) and into `ModelTester`: eval
    probabilities on a validation batch bit-equal to the trained model's;
    `test_models --on test` with the exported file (1 vote). Then one
    more epoch profiled (`profile_epoch`: ms a graphed step, busy share),
    the kernels and the f64 step at the loop's shapes
    (`check_stage_shapes`) and the deformable convs' times and memory
    (`time_deformable_convs`).
    Returns the report, the launches of its main-path runs and, for phase
    15, the trained model with its config, plan, per-eval-batch launches
    and the level-0 tensors of the validation batch."""
    import copy
    import dataclasses
    from weasal_tpu_torch.data.loader import BatchPrefetcher
    from weasal_tpu_torch.data.resident import (ResidentBatchSource,
                                                assemble_level0_device)
    from weasal_tpu_torch.export_torch_checkpoint import main as export
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.test_models import main as test_models
    from weasal_tpu_torch.train import stage
    from weasal_tpu_torch.train.tester import ModelTester
    from weasal_tpu_torch.train.trainer import ModelTrainer
    from weasal_tpu_torch.train_Vaihingen3D_PseudoLabel import STAGE

    cls = deformable_pl_config()
    deform_stage = dataclasses.replace(STAGE, config_cls=cls)
    config = cls()
    config.num_classes = 9
    per_step, per_val = pl_expected(config)
    log(f"phase 11: architecture {config.architecture}, deform layers "
        f"{config.deform_layers}; launches expected per step {per_step}, "
        f"per eval batch {per_val}")
    total = {fn.__name__: 0 for fn in counted}

    def add(part):
        for k, v in part.items():
            total[k] += v

    results = os.path.join(work, "results", "PseudoLabel")
    logdir = os.path.join(results, DEFORM_LOG)
    repeat_dir = os.path.join(results, DEFORM_LOG + "_repeat")
    chkp = os.path.join(logdir, "checkpoints", "current_chkp.tar")
    # every step's loss and offset loss at full precision, per run
    seen = {}
    flush_log = ModelTrainer._flush_log

    def keep(self, pending, log_file, al_iteration):
        seen.setdefault(self.config.saving_path, []).extend(
            (float(p[2]), float(p[5])) for p in pending)
        return flush_log(self, pending, log_file, al_iteration)

    cwd = os.getcwd()
    os.chdir(work)
    report, runs = {}, []
    ModelTrainer._flush_log = keep
    try:
        torch.cuda.reset_peak_memory_stats()
        for label, out in (("run", logdir), ("repeat", repeat_dir)):
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            trainer = stage.run(deform_stage,
                                [out, "--data_root", root, *DEFORM_ARGS])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            add(launches)
            runs.append(_loop_report(label, trainer, out, 1, launches,
                                     per_step, per_val, wall_s, card, log,
                                     what="deformable PL loop"))
            if label == "run":
                first = trainer
        peak = torch.cuda.max_memory_allocated()
        ModelTrainer._flush_log = flush_log
        repeat = compare_repeat(
            [v for v, _ in seen.get(logdir, [])],
            [v for v, _ in seen.get(repeat_dir, [])], chkp,
            os.path.join(repeat_dir, "checkpoints", "current_chkp.tar"),
            card, log, what="deformable PL loop")
        offsets = [r for _, r in seen.get(logdir, [])]
        same_offsets = offsets == [r for _, r in seen.get(repeat_dir, [])]
        logged = [float(r[3]) for r in _log_rows(logdir)]
        expect(len(offsets) == runs[0]["steps"] and same_offsets
               and all(np.isfinite(offsets)) and min(offsets) > 0
               and min(logged) > 0,
               f"phase 11: offset losses {offsets} (repeat "
               f"{'equal' if same_offsets else 'DIFFERS'}), logged "
               f"{logged}: each must be finite and non-zero")
        log(f"[{card}] phase 11 offset losses (the fitting regularizer) "
            f"per step: {offsets}; the repeat's "
            f"{'bit-equal' if same_offsets else 'DIFFER'}; peak device "
            f"memory of the 2 runs {peak / 2**20:.1f} MiB")
        trainer = first
        saved = torch.load(chkp, map_location="cpu", weights_only=True)
        expect(_same_state(saved["model_state_dict"],
                           trainer.model.state_dict()),
               "phase 11: current_chkp.tar differs from the trained state")

        # export to the reference's format and reload it
        exported = os.path.join(work, "phase11_reference_chkp.tar")
        export([chkp, exported])
        ref = torch.load(exported, map_location="cpu", weights_only=True)
        groups = [len(g["params"])
                  for g in ref["optimizer_state_dict"]["param_groups"]]
        cfg2 = copy.copy(trainer.config)
        cfg2.saving = False
        train_ds, val_ds = trainer.datasets
        fresh = ModelTrainer(cfg2, train_ds, chkp_path=exported,
                             device=trainer.device, stage_dir="PseudoLabel")
        tester = ModelTester(cfg2, val_ds, exported, device=trainer.device)
        zero = all(float(v.abs().max()) == 0.0
                   for v in fresh.opt_state.values())
        source = ResidentBatchSource(val_ds, trainer.plan, trainer.device)
        batch, _ = next(iter(BatchPrefetcher(
            source, 1, trainer.device, rng=np.random.default_rng(SEED),
            augment=True, extra_arrays=source.resident.arrays)))
        with torch.no_grad():
            t = assemble_level0_device(batch, cfg2, trainer.plan,
                                       augment=True, spec=trainer.spec)
            pyr = batch_from_device_pyramid(
                t["points0"], t["mask0"], t["features"], t["labels"],
                cfg2, trainer.plan, t["center_pts"],
                rotations=t["rotations"])
            probs = []
            for net in (trainer.model, fresh.model, tester.model):
                net.eval()
                probs.append(torch.softmax(net(pyr), dim=-1))
        equal = [torch.equal(p, probs[0]) for p in probs[1:]]
        expect(all(equal) and zero and fresh.epoch == 1,
               f"phase 11: the exported checkpoint reloaded: eval "
               f"probabilities bit-equal (trainer, tester) {equal}, "
               f"momentum zero {zero}, epoch {fresh.epoch}")
        log(f"[{card}] phase 11 export: {len(ref['model_state_dict'])} "
            f"reference keys, SGD groups of {groups} parameters; reloaded "
            f"into a fresh trainer and ModelTester: eval probabilities "
            f"bit-equal {equal}, momentum zero {zero}, epoch {fresh.epoch}")
        del fresh, tester

        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        tm = test_models(["--log", logdir, "--on", "test", "--num_votes",
                          "1", "--data_root", root, "--chkp", exported])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        add(launches)
        log(f"[{card}] phase 11 test_models --on test with the exported "
            f"checkpoint: {wall_s:.1f} s")
        vote = dict(wall_s=wall_s, **vote_report(
            tm, per_val, "PseudoLabel", DEFORM_LOG, ["Vaihingen3D_Testing"],
            "phase 11 test_models --on test", card, log, launches))
        del tm

        profile = profile_epoch(trainer, counted, per_step, total, card,
                                log, what="deformable PL loop")
        kernel_sums, at_plan, shapes_pyr, _ = check_stage_shapes(
            trainer, per_step, card, log, "phase 11 deformable PL")
        deform = time_deformable_convs(trainer.model, shapes_pyr, card, log)
        report.update(runs=runs, repeat=repeat, offset_losses=offsets,
                      offset_losses_logged=logged, peak_bytes=peak,
                      plan=vars(trainer.plan), per_step=per_step,
                      per_val=per_val, kernels=kernel_sums, at_plan=at_plan,
                      export=dict(reference_keys=len(ref["model_state_dict"]),
                                  param_groups=groups, probs_equal=equal,
                                  momentum_zero=zero),
                      test_models=vote, deformable_convs=deform,
                      profile=profile)
        handoff = dict(model=trainer.model, config=cfg2, plan=trainer.plan,
                       level0=t, per_val=per_val)
    finally:
        ModelTrainer._flush_log = flush_log
        os.chdir(cwd)
    return report, total, handoff


def host_expected(per_step, per_val, n_layers):
    """Launches per host-pyramid training step and eval batch, from the
    fused path's: no radius search (the host builds the neighbor lists)
    and none of the L - 1 voxel sums (the host subsamples)."""
    step = dict(per_step, radius_search=0,
                inverse_sum=per_step["inverse_sum"] - (n_layers - 1))
    val = dict(per_val, radius_search=0,
               inverse_sum=per_val.get("inverse_sum", 0) - (n_layers - 1))
    return step, val


def host_batches(trainer, n, threads):
    """`n` seeded host batches of the trainer's training dataset (a fresh
    HostPyramidSource of `threads` workers) on its device, in weak mode
    those with regions: [(PyramidBatch, its arrays)], and the source's
    host ms a batch."""
    from weasal_tpu_torch.data.batch import PyramidBatch
    from weasal_tpu_torch.data.loader import (BatchPrefetcher,
                                              HostPyramidSource)
    source = HostPyramidSource(trainer.datasets[0], trainer.plan, threads)
    try:
        drawn = list(BatchPrefetcher(source, n, trainer.device,
                                     rng=np.random.default_rng(SEED)))
    finally:
        source.close()
    kept = [(PyramidBatch.from_arrays(b), b) for b, metas in drawn
            if trainer.mode == "pseudo"
            or any(m["has_regions"] for m in metas)]
    return kept, 1e3 * source.seconds / max(source.batches, 1)


def check_host_shapes(trainer, per_step, card, log, what):
    """Phase 12's checks at the host-pyramid loop's own shapes, after its
    runs: LOOP_CHECK_BATCHES seeded host batches of its training dataset
    (those with regions); on the first, B, C and D against their plain
    versions as in phases 2 and 4 (A is not on this path), and one kernel
    training step from the seeded initial state, eager and replayed, held
    to an f64 step as in phase 5; the inverse lists and row sums of one
    `train_step` checked and timed as in phase 5; then `train_step` on
    the batches (launches per step, synchronized ms) and a profile of one
    step. Returns the kernels' sums and the readings."""
    global PREFIX
    from weasal_tpu_torch import init_opt_state, train_step
    from weasal_tpu_torch.models.architectures import model_for_config
    from weasal_tpu_torch.train.graphs import COUNTED, launch_counts
    config, plan, dev = trainer.config, trainer.plan, trainer.device
    train_ds = trainer.datasets[0]
    batches, build_ms = host_batches(trainer, LOOP_CHECK_BATCHES,
                                     config.input_threads)
    expect(len(batches) >= 3, f"{what}: {len(batches)} of "
           f"{LOOP_CHECK_BATCHES} host batches have regions")
    pyr = batches[0][0]
    log(f"{what}: kernels vs plain versions on host-built lists, {plan}, "
        f"{int(pyr.masks[0].sum())} real level-0 points; host build "
        f"{build_ms:.1f} ms a batch ({min(config.input_threads, 8)} "
        "threads)")
    PREFIX = f"{what} shapes: "
    try:
        with torch.no_grad():
            checks = dict(kpconv_fwd=check_kpconv(trainer.model, pyr, log,
                                                  SEED))
        checks["kpconv_bwd"] = check_kpconv_bwd(trainer.model, pyr, log,
                                                SEED)
        checks["maxpool_bwd"] = check_maxpool_bwd(trainer.model, pyr, log,
                                                  SEED)
        sums = {k: v[1] for k, v in checks.items()}
        shapes = {k: v[0] for k, v in checks.items()}
        net = model_for_config(
            config, train_ds.label_values, train_ds.ignored_labels,
            generator=torch.Generator().manual_seed(0)).to(dev)
        comparison = compare_train_steps(net, init_opt_state(net), pyr,
                                         config, log, plan=plan,
                                         label=f"{what} step, kernels")
        del net
        log(f"[{card}] f64 {what} step (first host batch): share of the "
            f"f64 allowance {comparison['share']:.3f} (replayed "
            f"{comparison['graph']['share']:.3f})")
    finally:
        PREFIX = ""

    def step(arrays):
        return train_step(trainer.model, trainer.opt_state, arrays, config,
                          plan, trainer.lr, device=dev,
                          class_w=trainer.class_w, table=trainer.table)

    log(f"{what}: the inverse lists and the row sums at the loop's shapes")
    PREFIX = f"{what} shapes: "
    try:
        sums["inverse_lists"] = check_inverse_lists(
            record_inverse_calls(lambda: step(batches[0][1])), log)
    finally:
        PREFIX = ""
    for fn in COUNTED:
        fn.launches = 0
    sync_ms = []
    for _, arrays in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(arrays)
        torch.cuda.synchronize()
        sync_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    want = {k: per_step.get(k, 0) * len(batches) for k in launches}
    expect(launches == want, f"{what} train_step: launches {launches} in "
           f"{len(batches)} steps, expected {want}")
    log(f"[{card}] {what} train_step on {len(batches)} host batches: "
        f"synchronized {[round(v, 2) for v in sync_ms]} ms; launches "
        f"{launches}")
    rows, busy, wall = profile_step(lambda: step(batches[1][1]), log,
                                    f"{what} train_step")
    return sums, dict(compare=comparison, sync_ms=sync_ms,
                      launches=launches, shapes=shapes,
                      host_build_ms=build_ms,
                      step_profile=dict(busy_ms=busy, wall_ms=wall,
                                        families=kernel_families(rows)))


def run_kpcnn(dev, counted, card, log):
    """Phase 12's classifier: KPCNN at tests/test_classification.py's
    configuration (`weasal_tpu_torch.config.ShapeClsConfig`) on host-built
    classification batches of KPCNN_CLOUDS synthetic shape clouds (160
    points, seeded): B, C and D at its shapes against their plain
    versions, the inverse lists and row sums of one step, then
    KPCNN_STEPS eager SGD steps of the cross-entropy on `cloud_label` (lr
    5e-3, momentum 0.9, optax.sgd's rule) with their launches (set to 0
    just before, read just after: 0 A, one B and one C a conv, one D a
    strided shortcut, the same builds and sums every step) and
    synchronized ms; the mean accuracy of the last 10 must pass
    KPCNN_MIN_ACC. Returns the report, the kernels' sums and the
    launches."""
    global PREFIX
    import copy
    from weasal_tpu_torch import KPCNN, ShapeClsConfig
    from weasal_tpu_torch.data.batching import (
        assemble_classification_batch, build_sphere_pyramid,
        calibrate_shape_plan)
    from weasal_tpu_torch.data.synthetic import synthetic_shape_cloud
    from weasal_tpu_torch.models import losses
    from weasal_tpu_torch.models.blocks import kernel_convs
    cfg = ShapeClsConfig()
    rng = np.random.default_rng(SEED)
    plan = calibrate_shape_plan(
        [synthetic_shape_cloud(rng, i % 3, n=160) for i in range(6)], cfg)
    build_s = [0.0]

    def batch():
        t0 = time.perf_counter()
        clouds = []
        for _ in range(KPCNN_CLOUDS):
            label = int(rng.integers(3))
            pts = synthetic_shape_cloud(rng, label, n=160)
            clouds.append(dict(
                pyramid=build_sphere_pyramid(pts, cfg, rng=rng,
                                             with_upsamples=False),
                features=np.ones((pts.shape[0], 1), np.float32),
                label=label))
        out = assemble_classification_batch(clouds, plan).to(dev)
        build_s[0] += time.perf_counter() - t0
        return out

    model = KPCNN(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.to(dev).train()

    def sgd(net, trace, data):
        net.zero_grad(set_to_none=True)
        out = net(data)
        target = data.cloud_label.long()
        losses.softmax_cross_entropy(out, target).backward()
        with torch.no_grad():
            for k, p in net.named_parameters():
                trace[k].mul_(0.9).add_(p.grad)
                p.sub_(5e-3 * trace[k])
        return (out.argmax(-1) == target).float().mean()

    first = batch()
    log(f"KPCNN: {plan}; kernels vs plain versions at its shapes")
    PREFIX = "KPCNN shapes: "
    try:
        with torch.no_grad():
            checks = dict(kpconv_fwd=check_kpconv(model, first, log, SEED))
        checks["kpconv_bwd"] = check_kpconv_bwd(model, first, log, SEED)
        checks["maxpool_bwd"] = check_maxpool_bwd(model, first, log, SEED)
        spare = copy.deepcopy(model)
        checks["inverse_lists"] = (None, check_inverse_lists(
            record_inverse_calls(lambda: sgd(spare, {
                k: torch.zeros_like(p)
                for k, p in spare.named_parameters()}, first)), log))
        del spare
    finally:
        PREFIX = ""
    sums = {k: v[1] for k, v in checks.items()}
    trace = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    for fn in counted:
        fn.launches = 0
    accs, step_ms, per_step = [], [], None
    build_s[0] = 0.0
    for i in range(KPCNN_STEPS):
        data = batch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accs.append(sgd(model, trace, data))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            per_step = {fn.__name__: fn.launches for fn in counted}
    launches = {fn.__name__: fn.launches for fn in counted}
    accs = [float(a) for a in accs]
    n_conv = len(kernel_convs(model))
    n_pool = len(strided_pools(model))
    want = {k: v * KPCNN_STEPS for k, v in per_step.items()}
    expect(per_step["radius_search"] == 0
           and per_step["kpconv_fwd"] == per_step["kpconv_bwd"] == n_conv
           and per_step["maxpool_bwd"] == n_pool
           and per_step["build_inverse_lists"] > 0 and launches == want,
           f"KPCNN: launches {launches} in {KPCNN_STEPS} steps, the first "
           f"{per_step}; expected 0 A, {n_conv} B and C and {n_pool} D a "
           "step, every step alike")
    final = float(np.mean(accs[-10:]))
    expect(final > KPCNN_MIN_ACC, f"KPCNN: mean accuracy of the last 10 "
           f"steps {final:.3f}, not above {KPCNN_MIN_ACC}: {accs[-10:]}")
    steady = statistics.mean(step_ms[1:])
    log(f"[{card}] KPCNN: {KPCNN_STEPS} SGD steps of {KPCNN_CLOUDS} clouds, "
        f"accuracy of the last 10 {final:.3f}; {steady:.2f} ms a step "
        f"(synchronized, steps 2..), host build "
        f"{1e3 * build_s[0] / KPCNN_STEPS:.2f} ms a batch; launches "
        f"{launches}")
    return dict(accuracy_last10=final, accs=accs, step_ms=step_ms,
                step_ms_steady=steady,
                host_build_ms=1e3 * build_s[0] / KPCNN_STEPS,
                plan=vars(plan), per_step=per_step), sums, launches


def run_host_pyramid(root, work, counted, wl_per, fused_loop, card, log):
    """Phase 12: the host-pyramid input path (config.device_pyramid =
    False) through the entry points: the WL loop on phase 6's tile
    (`entry_runs` without the resume: 2 graphed epochs and their repeat,
    the launches of `host_expected`), the checks at its shapes
    (`check_host_shapes`), its ms a step with the `wait_batch` share and
    the host build's ms a batch beside phase 6's fused loop; two PL
    epochs on phase 9's labels (ms a step and `wait_batch` share of the
    second, whose clock holds no capture); `test_models --host_pyramid --on validation`
    with 1 vote in epochs of HOST_VOTE_BATCHES batches; KPCNN
    (`run_kpcnn`). A native geometry library that does not build fails
    the phase. Returns the report, the kernels' sums at the WL loop's and
    KPCNN's shapes and the launches of each path."""
    from weasal_tpu_torch import test_models
    from weasal_tpu_torch.config import VaihingenPLConfig, VaihingenWLConfig
    from weasal_tpu_torch.data.loader import ParallelSphereBuilder
    from weasal_tpu_torch.ops import native
    from weasal_tpu_torch.train_Vaihingen3D_PseudoLabel import run as run_pl
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run as run_wl
    if not native.available():
        raise RuntimeError("phase 12: the native geometry library did not "
                           "build (g++ and weasal_tpu_torch/cpp/geometry.cpp)")
    per_step, per_val = host_expected(*wl_per,
                                      VaihingenWLConfig().num_layers)
    pl_config = VaihingenPLConfig()
    pl_config.num_classes = 9
    pl_step, pl_val = host_expected(*pl_expected(pl_config),
                                    pl_config.num_layers)
    log(f"phase 12: launches expected per WL step {per_step}, per WL eval "
        f"batch {per_val}; per PL step {pl_step}, per PL eval batch "
        f"{pl_val}")
    cwd = os.getcwd()
    os.chdir(work)
    vote_batches = test_models.VOTE_EPOCH_BATCHES
    report, paths = {}, {}
    try:
        logdir = os.path.join(work, HOST_LOG)
        loop = entry_runs(run_wl, root, logdir,
                          os.path.join(work, HOST_LOG + "_repeat"),
                          HOST_ARGS, counted, per_step, per_val, card, log,
                          what="host WL loop", resume=False)
        trainer, paths["host_wl"] = loop["trainer"], loop["total"]
        source = trainer._train_source[0]
        builder = getattr(source, "builder", None)
        expect(not trainer.device_pyramid
               and isinstance(builder, ParallelSphereBuilder)
               and builder.max_workers == 8 and builder.pool is None,
               f"phase 12: the WL loop's source is {source!r}, not the host "
               "pyramid with 8 builder threads, closed when training ends")
        build_ms = 1e3 * source.seconds / max(source.batches, 1)
        epochs = [e for r in loop["runs"] for e in r["epochs"][1:]]
        shares = [e["wait_batch_ms_per_step"] / e["ms_per_step"]
                  for e in epochs]
        host_ms = [r["step_ms_steady"] for r in loop["runs"]]
        fused_ms = [r["step_ms_steady"] for r in fused_loop["runs"]
                    if r["step_ms_steady"]]
        kernel_sums, at_plan = check_host_shapes(trainer, per_step, card,
                                                 log, "phase 12 host WL")
        log(f"[{card}] host WL loop: "
            f"{[round(v, 2) for v in host_ms]} ms a step (second epochs), "
            f"wait_batch {[round(100 * v, 1) for v in shares]} % of it; "
            f"host build {build_ms:.1f} ms a batch ({source.batches} "
            f"batches, 8 threads, in the producer thread); phase 6's fused "
            f"loop {[round(v, 2) for v in fused_ms]} ms a step; "
            f"train_step on host batches {at_plan['sync_ms']} ms")
        report.update(wl=dict(runs=loop["runs"], repeat=loop["repeat"],
                              plan=vars(trainer.plan),
                              peak_bytes=loop["peak"], host_ms=host_ms,
                              wait_share=shares, host_build_ms=build_ms,
                              fused_ms=fused_ms, at_plan=at_plan,
                              per_step=per_step, per_val=per_val))

        # the PL epochs, the second timed without the graphs' captures
        pl_log = os.path.join(work, HOST_LOG + "_pl")
        for fn in counted:
            fn.launches = 0
        os.environ["WEASAL_LOOP_STATS"] = "1"
        try:
            t0 = time.perf_counter()
            pl = run_pl([pl_log, "--data_root", root, *HOST_PL_ARGS])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            os.environ.pop("WEASAL_LOOP_STATS", None)
        paths["host_pl"] = {fn.__name__: fn.launches for fn in counted}
        expect(not pl.device_pyramid and pl.mode == "pseudo",
               "phase 12: the PL run is not a host-pyramid pseudo-label run")
        report["pl"] = _loop_report("run", pl, pl_log, HOST_PL_EPOCHS,
                                    paths["host_pl"], pl_step, pl_val,
                                    wall_s, card, log,
                                    what="host PL epochs")
        second = report["pl"]["epochs"][-1]
        report["pl"]["wait_share"] = (second["wait_batch_ms_per_step"]
                                      / second["ms_per_step"])
        log(f"[{card}] host PL loop: {second['ms_per_step']:.2f} ms a step "
            f"(second epoch), wait_batch "
            f"{100 * report['pl']['wait_share']:.1f} % of it")

        # a vote of the WL loop's model
        test_models.VOTE_EPOCH_BATCHES = HOST_VOTE_BATCHES
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        tm = test_models.main(["--log", logdir, "--on", "validation",
                               "--num_votes", "1", "--data_root", root,
                               "--host_pyramid"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        paths["host_vote"] = {fn.__name__: fn.launches for fn in counted}
        expect(not tm.device_pyramid, "phase 12: the vote ran fused")
        report["vote"] = dict(wall_s=wall_s, **vote_report(
            tm, per_val, "WeakLabel", HOST_LOG, ["Vaihingen3D_Training"],
            "phase 12 test_models --host_pyramid --on validation", card,
            log, paths["host_vote"]))

        report["kpcnn"], kpcnn_sums, paths["kpcnn"] = run_kpcnn(
            trainer.device, counted, card, log)
    finally:
        test_models.VOTE_EPOCH_BATCHES = vote_batches
        os.chdir(cwd)
    return report, dict(host_wl=kernel_sums, kpcnn=kpcnn_sums), paths


# ---------------------------------------------------------------- phase 13

def synthetic_conv(dev, seed, b, nq, ns, k, kp, cin, cout):
    """A conv problem of `conv_pair`: supports in a 4 m box, queries beside
    the first nq of them, random neighbor rows (a shadow among them),
    seeded features, weights, kernel points and output gradients."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    s = torch.rand((b, ns, 3), generator=gen, device=dev) * 4 - 2
    return dict(
        name=f"b{b} nq{nq} ns{ns} K{k} Kp{kp} {cin}->{cout}",
        q=(s[:, :nq] + 0.05).contiguous(), s=s,
        nb=torch.randint(0, ns + 1, (b, nq, k), generator=gen, device=dev,
                         dtype=torch.int32),
        x=torch.randn((b, ns, cin), generator=gen, device=dev),
        kp=torch.rand((kp, 3), generator=gen, device=dev) - 0.5,
        w=torch.randn((kp, cin, cout), generator=gen, device=dev)
        / cin ** 0.5,
        g=torch.randn((b, nq, cout), generator=gen, device=dev),
        q_mask=torch.ones((b, nq), dtype=torch.bool, device=dev),
        ext=0.8, infl="linear", need_dx=True)


def model_convs(model, batch, seed):
    """The conv problems of every kernel conv of `model` on `batch`
    (seeded features and output gradients), dX skipped at the first conv
    as on the main path."""
    from weasal_tpu_torch.models.blocks import conv_inputs, kernel_convs
    gen = torch.Generator(device=batch.features.device).manual_seed(seed)
    skip_dx = first_conv(model)
    out = []
    for name, conv in kernel_convs(model):
        q, s, nb, q_mask = conv_inputs(conv.strided, conv.layer_ind, batch)
        w = conv.weights.detach()
        out.append(dict(
            name=name, q=q, s=s, nb=nb, q_mask=q_mask, w=w,
            kp=conv.kernel_points,
            x=torch.randn((s.shape[0], s.shape[1], w.shape[1]),
                          generator=gen, device=s.device),
            g=torch.randn((q.shape[0], q.shape[1], w.shape[2]),
                          generator=gen, device=s.device),
            ext=conv.params.kp_extent, infl=conv.params.influence,
            need_dx=name != skip_dx))
    return out


def conv_pair(p, dtype, log, what, gemm_parts: bool = False):
    """Kernels B and C at one conv problem under compute_dtype `dtype`
    against their plain versions on the same inputs (C on the plain
    forward's y, so that each kernel is held alone): f32 within phases 2
    and 4's tolerances; bf16 by the flip criterion of tests/_bf16_cases.py
    (y and dW, at their terms' scale: one-ulp flips in at most
    FLIP_SHARE_MAX of the elements, dW bf16-valued; out and dX as close to
    an f64 evaluation of the same rounding points as the plain version,
    within REF_RATIO, or within OUT_REL_L2_MAX: C's products are
    f32-grade, not f32-exact, and turn more roundings of sums that
    cancel), and B's out within f32 tolerance of its own y @ bf(W). Then
    each kernel's
    and plain version's device ms (dX as the main path asks) and the
    bound: bytes, the aggregation's f32 operations, and the products at
    the 3xTF32 rate (f32), at the bf16 rate (B's y @ bf(W)) or in two
    TF32 passes (C's bf16 products). With `gemm_parts` also the device
    ms of B's and C's products by kernel name (`gemm_part_ms`) beside
    their own bounds (`gemm`)."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
    from weasal_tpu_torch.ops.cuda.kpconv_bwd import (kpconv_bwd,
                                                      kpconv_bwd_plain)
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd_plain_with_y,
                                                      kpconv_fwd_with_y)
    q, s, nb, x, kp, w, g = (p[k] for k in ("q", "s", "nb", "x", "kp", "w",
                                            "g"))
    ext, infl, need_dx, name = p["ext"], p["infl"], p["need_dx"], p["name"]
    n_kp, cin, cout = w.shape
    bf = dtype == "bfloat16"
    with torch.no_grad():
        out, y = kpconv_fwd_with_y(q, s, nb, x, kp, w, ext, infl, dtype)
        out_p, y_p = kpconv_fwd_plain_with_y(q, s, nb, x, kp, w, ext, infl,
                                             dtype)
        inv = LazyInverse(nb, s.shape[1])
        inv.get()

        def bwd(nd=True):
            return kpconv_bwd(q, s, nb, y_p, kp, w, g, ext, infl,
                              need_dx=nd, inverse=inv, compute_dtype=dtype)

        dx, dw = bwd()
        dx_p, dw_p = kpconv_bwd_plain(q, s, nb, y_p, kp, w, g, ext, infl,
                                      compute_dtype=dtype)
        torch.cuda.synchronize()
        row = dict(conv=name, dtype=dtype,
                   shape=[*q.shape[:2], s.shape[1], nb.shape[2], n_kp, cin,
                          cout])
        if bf:
            # the sums of the terms' magnitudes (influences are >= 0)
            y_terms = kpconv_fwd_plain_with_y(q, s, nb, x.abs(), kp, w, ext,
                                              infl)[1]
            terms = (y_p.float().abs().t() @ g.abs().reshape(-1, cout))
            fy = flips(y, y_p, y_terms)
            fw = flips(dw, dw_p, terms.reshape(dw.shape))
            # B's product on its own y, at f32-grade
            gemm = (y.double() @ w.double().to(torch.bfloat16).double()
                    .reshape(n_kp * cin, cout)).reshape(out.shape)
            _expect_close(f"{what} B bf16 {name} out = y @ bf(W)", out.double(),
                          gemm, KPCONV_RTOL,
                          KPCONV_ATOL_REL * float(gemm.abs().max()))
            d64 = [t.double() for t in (q, s, x, kp, w, g)]
            out64 = kpconv_fwd_plain_with_y(d64[0], d64[1], nb, d64[2],
                                            d64[3], d64[4], ext, infl,
                                            dtype)[0]
            dx64 = kpconv_bwd_plain(d64[0], d64[1], nb, y_p, d64[3], d64[4],
                                    d64[5], ext, infl, compute_dtype=dtype)[0]
            e_out = within_plain(out, out_p, out64)
            e_dx = within_plain(dx, dx_p, dx64)
            expect(y.dtype == torch.bfloat16 and flips_ok(fy)
                   and e_out["ok"],
                   f"{what} B bf16 {name}: y flips {fy}, out to f64 "
                   f"{e_out} (within {REF_RATIO} x the plain version's or "
                   f"{OUT_REL_L2_MAX})")
            expect(is_bf16_valued(dw) and flips_ok(fw) and e_dx["ok"],
                   f"{what} C bf16 {name}: dW flips {fw}, dX to f64 "
                   f"{e_dx} (within {REF_RATIO} x the plain version's or "
                   f"{OUT_REL_L2_MAX})")
            row.update(y_flips=fy, out_to_f64=e_out, dw_flips=fw,
                       dx_to_f64=e_dx)
            text = (f"y flips {fy['share']:.1e} ({fy['beyond']} beyond an "
                    f"ulp), out to f64 {e_out['rel_l2']:.1e} (plain "
                    f"{e_out['plain_rel_l2']:.1e}); dW flips "
                    f"{fw['share']:.1e} ({fw['beyond']}), dX to f64 "
                    f"{e_dx['rel_l2']:.1e} (plain {e_dx['plain_rel_l2']:.1e})")
        else:
            errs = []
            for label, a, b in (("B out", out, out_p), ("B y", y, y_p),
                                ("C dX", dx, dx_p), ("C dW", dw, dw_p)):
                scale = float(b.abs().max())
                _expect_close(f"{what} {label} {name}", a, b, KPCONV_RTOL,
                              KPCONV_ATOL_REL * max(scale, 1e-30))
                errs.append(float((a - b).abs().max()))
            row.update(max_abs_err_b=max(errs[:2]),
                       max_abs_err_c=max(errs[2:]))
            text = (f"err B {row['max_abs_err_b']:.2e} C "
                    f"{row['max_abs_err_c']:.2e}")
        ms_b = cuda_ms(lambda: kpconv_fwd_with_y(q, s, nb, x, kp, w, ext,
                                                 infl, dtype))
        plain_b = cuda_ms(lambda: kpconv_fwd_plain_with_y(
            q, s, nb, x, kp, w, ext, infl, dtype))
        ms_c = cuda_ms(lambda: bwd(need_dx))
        plain_c = cuda_ms(lambda: kpconv_bwd_plain(
            q, s, nb, y_p, kp, w, g, ext, infl, need_dx=need_dx,
            compute_dtype=dtype))
    pairs = float((nb < s.shape[1]).sum())
    rows_valid = float(p["q_mask"].sum())
    agg_ops = pairs * n_kp * (14 + 2 * cin)
    gemm = rows_valid * 2.0 * n_kp * cin * cout
    fwd_bytes = 4.0 * (q.numel() + s.numel() + nb.numel() + x.numel()
                       + kp.numel() + w.numel() + out.numel())
    bwd_bytes = (2.0 if bf else 4.0) * y.numel() + 4.0 * (
        w.numel() + g.numel() + w.numel())
    products = 1
    if need_dx:
        products = 2
        bwd_bytes += 4.0 * (q.numel() + s.numel() + nb.numel() + kp.numel()
                            + x.numel())
    if bf:
        bound_b = tensor_bound_ms(fwd_bytes, agg_ops, bf16_ops=gemm)
        bound_c = tensor_bound_ms(bwd_bytes, agg_ops if need_dx else 0.0,
                                  tf32_ops=2.0 * products * gemm)
    else:
        bound_b = bound_ms(fwd_bytes, agg_ops, gemm)
        bound_c = bound_ms(bwd_bytes, agg_ops if need_dx else 0.0,
                           products * gemm)
    row.update(b=dict(ms=ms_b, plain_ms=plain_b, bound_ms=bound_b[0],
                      bound_by=bound_b[1]),
               c=dict(ms=ms_c, plain_ms=plain_c, bound_ms=bound_c[0],
                      bound_by=bound_c[1], need_dx=need_dx))
    if gemm_parts:
        # each product's bytes: its operands read once, its output
        # written once (y and a bf16 W 2 bytes a value in bf16 mode)
        m, kdim, e = rows_valid, n_kp * cin, 2.0 if bf else 4.0
        rate = ((lambda ops: dict(bf16_ops=ops)) if bf
                else (lambda ops: dict(tf32_ops=3 * ops)))
        fams = (BF16_GEMM_FAMILY,) if bf else GEMM_FAMILIES[:1]
        part = gemm_part_ms(lambda: kpconv_fwd_with_y(
            q, s, nb, x, kp, w, ext, infl, dtype), fams)[fams[0]]
        row["b"]["gemm"] = dict(ms=part, bound_ms=tensor_bound_ms(
            e * (m * kdim + kdim * cout) + 4.0 * m * cout, 0.0,
            **rate(gemm))[0])
        # C's products: g @ bf(W)^T and bf(y)^T @ g in two TF32 passes
        passes = 2 if bf else 3
        fams = GEMM_FAMILIES[1 if need_dx else 2:]
        parts = gemm_part_ms(lambda: bwd(need_dx), fams)
        for fam in fams:
            key = "gemm_g_wt" if fam == GEMM_FAMILIES[1] else "gemm_yt_g"
            n_bytes = (4.0 * (m * cout + m * kdim) + e * kdim * cout
                       if key == "gemm_g_wt" else
                       e * m * kdim + 4.0 * (m * cout + kdim * cout))
            row["c"][key] = dict(ms=parts[fam], bound_ms=tensor_bound_ms(
                n_bytes, 0.0, tf32_ops=passes * gemm)[0])
    log(f"  {what} {dtype} {name}: q{list(q.shape[:2])} Ns={s.shape[1]} "
        f"K={nb.shape[2]} Kp={n_kp} {cin}->{cout}: {text}; B {ms_b:.3f} ms "
        f"(plain {plain_b:.3f}, bound {bound_b[0]:.4f} {bound_b[1]}), C "
        f"{ms_c:.3f} ms (plain {plain_c:.3f}, bound {bound_c[0]:.4f} "
        f"{bound_c[1]}){'' if need_dx else ', no dX'}")
    return row


def conv_set(problems, dtype, log, what, gemm_parts: bool = False):
    """`conv_pair` at each problem; returns the rows and, for B and C, the
    sums of ms, plain ms and bound ms over them (`b`, `c`) and, with
    `gemm_parts`, of each product's ms and bound (`gemm`, `gemm_g_wt`,
    `gemm_yt_g`; a product the profiler lost is left out of both sums)."""
    rows = [conv_pair(p, dtype, log, what, gemm_parts) for p in problems]
    sums = {}
    for key in ("b", "c"):
        sums[key] = {f: sum(r[key][f] for r in rows)
                     for f in ("ms", "plain_ms", "bound_ms")}
        for g in ("gemm", "gemm_g_wt", "gemm_yt_g"):
            kept = [r[key][g] for r in rows
                    if g in r[key] and r[key][g]["ms"] is not None]
            if kept:
                sums[key][g] = {f: sum(k[f] for k in kept)
                                for f in ("ms", "bound_ms")}
                t = sums[key][g]
                log(f"[{CARD}] {what} {dtype}: {key.upper()} {g} "
                    f"{t['ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
                    f"({100 * t['bound_ms'] / t['ms']:.1f} % of it), "
                    f"{len(kept)} of {len(rows)} convs")
    log(f"[{CARD}] {what} {dtype}, {len(rows)} convs: B {sums['b']['ms']:.3f} "
        f"ms (plain {sums['b']['plain_ms']:.3f}, bound "
        f"{sums['b']['bound_ms']:.4f}); C {sums['c']['ms']:.3f} ms (plain "
        f"{sums['c']['plain_ms']:.3f}, bound {sums['c']['bound_ms']:.4f})")
    return dict(rows=rows, **sums)


def first_pyramid(trainer):
    """The first batch of LOOP_CHECK_BATCHES drawn from the trainer's
    resident source (in weak mode the first with regions), assembled on
    the card into a pyramid on the plain versions."""
    from weasal_tpu_torch.data.loader import BatchPrefetcher
    from weasal_tpu_torch.data.resident import (ResidentBatchSource,
                                                assemble_level0_device)
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.device import plain_ops
    config, plan, dev = trainer.config, trainer.plan, trainer.device
    source = ResidentBatchSource(trainer.datasets[0], plan, dev)
    drawn = list(BatchPrefetcher(
        source, LOOP_CHECK_BATCHES, dev, rng=np.random.default_rng(SEED),
        extra_arrays=source.resident.arrays))
    batch = next(b for b, metas in drawn if trainer.mode == "pseudo"
                 or any(m["has_regions"] for m in metas))
    with torch.no_grad():
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


def swapped_spheres(pyr):
    """The pyramid with its spheres in reverse order (every field's batch
    axis): the same arithmetic in another f32 order of the sums over
    spheres."""
    from weasal_tpu_torch.data.batch import PyramidBatch
    b = pyr.batch_size
    return PyramidBatch.from_arrays(
        {k: v.flip(0) if v.dim() and v.shape[0] == b else v
         for k, v in pyr.arrays().items()})


def bf16_step_check(trainer, pyr, log, what):
    """The bf16 kernel step against the plain bf16 step from the trainer's
    state on one pyramid: loss within BF16_LOSS_RTOL; the gradients'
    relative L2 over all parameters within BF16_SPREAD_RATIO times the
    plain step's own spread, the plain step on the same pyramid with its
    spheres reversed (each bf16 rounding of the backward turns a
    difference at f32 rounding into one at bf16 rounding where it crosses
    a boundary, so two sum orders differ by far more than in f32:
    tests/test_torch_bf16.py measures JAX against itself so)."""
    import copy
    from weasal_tpu_torch import init_opt_state
    from weasal_tpu_torch.train.step import step_on_batch
    from weasal_tpu_torch.utils.device import plain_ops
    net = copy.deepcopy(trainer.model)
    state0 = {k: v.clone() for k, v in net.state_dict().items()}
    config = trainer.config

    def run(batch, plain):
        net.load_state_dict(state0)
        opt = init_opt_state(net)
        with plain_ops() if plain else contextlib.nullcontext():
            loss = step_on_batch(net, opt, batch, config,
                                 config.learning_rate)[0]
        torch.cuda.synchronize()
        return float(loss), {n: p.grad.double().clone()
                             for n, p in net.named_parameters()}

    def spread(a, b):
        num = sum(float((a[k] - b[k]).norm()) ** 2 for k in b)
        den = sum(float(b[k].norm()) ** 2 for k in b)
        return (num / den) ** 0.5

    loss_k, grads_k = run(pyr, False)
    loss_p, grads_p = run(pyr, True)
    loss_s, grads_s = run(swapped_spheres(pyr), True)
    ours, theirs = spread(grads_k, grads_p), spread(grads_s, grads_p)
    log(f"[{CARD}] {what}: bf16 kernel step loss {loss_k!r}, plain "
        f"{loss_p!r} (spheres reversed {loss_s!r}); gradients' relative L2 "
        f"kernel vs plain {ours:.3e}, plain vs plain with the spheres "
        f"reversed {theirs:.3e}")
    expect(math.isfinite(loss_k) and abs(loss_k - loss_p)
           <= BF16_LOSS_RTOL * abs(loss_p),
           f"{what}: bf16 kernel step loss {loss_k} against plain {loss_p}")
    expect(ours <= BF16_SPREAD_RATIO * theirs,
           f"{what}: bf16 kernel step gradients {ours:.3e} from the plain "
           f"step's, past {BF16_SPREAD_RATIO} x its own spread {theirs:.3e}")
    return dict(loss=loss_k, plain_loss=loss_p, swapped_loss=loss_s,
                grads_rel_l2=ours, plain_spread_rel_l2=theirs)


def stage_with(stage_obj, **attrs):
    """The entry point's Stage with its configuration class's `attrs`
    overridden (no flag sets them: JAX's root scripts have none)."""
    import dataclasses
    cls = stage_obj.config_cls
    return dataclasses.replace(stage_obj, config_cls=type(
        cls.__name__ + "Phase13", (cls,), dict(attrs)))


def run_bf16_dispositions(root, work, counted, wl_per, model, ref_batch,
                          fused_loop, card, log):
    """Phase 13: compute_dtype "bfloat16" and a generated kernel
    disposition through the entry points at full width. Kernels B and C in
    bf16 against their plain bf16 versions (`conv_pair`) at phase 2's WL
    shapes and DALES's widest conv; in f32 at Kp in KP_SWEEP at a
    level-0-like conv and at Kp 40 with the deformable layers' K of 266
    (with bf16 there too). The WL entry point with VaihingenWLConfig in
    bf16 on phase 6's tile: 2 graphed epochs and their repeat in a fresh
    trainer (losses and checkpoint bit-equal, `entry_runs`), phase 6's
    launches a step and a validation batch; the bf16 kernel step against
    the plain bf16 step (`bf16_step_check`); its ms a step beside phase
    6's f32 loop; the first step's loss in bf16 and in f32 from one seeded
    state on one pyramid (printed). One graphed epoch of the PL entry
    point in bf16 on phase 9's labels (launches, finite losses) and B and
    C at its shapes. The WL entry point at num_kernel_points 20, its
    disposition generated into the phase's work directory (5 graphed
    steps; 12 B and 12 C a step at Kp 20), and B and C at its shapes.
    Returns the report, the kernels' sums and rows, and the launches of
    each path."""
    from weasal_tpu_torch import init_opt_state
    from weasal_tpu_torch.config import VaihingenPLConfig
    from weasal_tpu_torch.kernels import kernel_points
    from weasal_tpu_torch.models.architectures import model_for_config
    from weasal_tpu_torch.models.blocks import kpconv_modules
    from weasal_tpu_torch.train import stage
    from weasal_tpu_torch.train.step import step_on_batch
    from weasal_tpu_torch.train_Vaihingen3D_PseudoLabel import STAGE as PL
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import STAGE as WL
    dev = torch.device("cuda")
    per_step, per_val = wl_per
    report, kernels, paths = {}, {}, {}

    # -- kernels: bf16 at the WL and DALES shapes, f32 over kernel points
    kernels["bf16_wl"] = conv_set(model_convs(model, ref_batch, SEED),
                                  "bfloat16", log, "phase 13 WL shapes",
                                  gemm_parts=True)
    kernels["bf16_dales"] = conv_set(
        [synthetic_conv(dev, SEED, **DALES_WIDEST)], "bfloat16", log,
        "phase 13 DALES widest")
    sweep = [synthetic_conv(dev, SEED + kp, kp=kp, **KP_SWEEP_SHAPE)
             for kp in KP_SWEEP]
    kernels["kp_sweep"] = conv_set(sweep, "float32", log,
                                   "phase 13 Kp sweep")
    wide = [synthetic_conv(dev, SEED + 99, **KP_WIDE_SHAPE)]
    kernels["kp40_k266"] = conv_set(wide, "float32", log,
                                    "phase 13 Kp 40 K 266")
    kernels["bf16_kp40_k266"] = conv_set(wide, "bfloat16", log,
                                         "phase 13 Kp 40 K 266")

    def entry(stage_obj, out, args, label, epochs, step, val):
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = stage.run(stage_obj, [out, "--data_root", root, *args])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counted}
        return trainer, launches, _loop_report(
            label, trainer, out, epochs, launches, step, val, wall_s, card,
            log, what=label)

    # -- the bf16 WL loop and its repeat
    bf16_wl = stage_with(WL, compute_dtype="bfloat16")
    logdir = os.path.join(work, BF16_LOG)
    loop = entry_runs(lambda argv: stage.run(bf16_wl, argv), root, logdir,
                      logdir + "_repeat", LOOP_ARGS, counted, per_step,
                      per_val, card, log, what="bf16 WL loop", resume=False)
    trainer, paths["bf16_wl"] = loop["trainer"], loop["total"]
    convs = kpconv_modules(trainer.model)
    expect(trainer.config.compute_dtype == "bfloat16"
           and all(m.params.compute_dtype == "bfloat16" for _, m in convs),
           "phase 13: the bf16 WL loop's convs are not all bf16")
    pyr = first_pyramid(trainer)
    report["bf16_step"] = bf16_step_check(trainer, pyr, log,
                                          "phase 13 bf16 WL step")
    # the first step's loss in f32 and bf16 from one seeded state
    first = {}
    for dtype in ("float32", "bfloat16"):
        cfg = stage_with(WL, compute_dtype=dtype).config_cls()
        ds = trainer.datasets[0]
        net = model_for_config(cfg, ds.label_values, ds.ignored_labels,
                               generator=torch.Generator().manual_seed(SEED)
                               ).to(dev)
        first[dtype] = float(step_on_batch(net, init_opt_state(net), pyr,
                                           cfg, cfg.learning_rate)[0])
    bf16_ms = [r["step_ms_steady"] for r in loop["runs"]]
    f32_ms = [r["step_ms_steady"] for r in fused_loop["runs"]
              if r["step_ms_steady"]]
    log(f"[{card}] phase 13 bf16 WL loop: {[round(v, 2) for v in bf16_ms]} "
        f"ms a step (second epochs) beside phase 6's f32 loop "
        f"{[round(v, 2) for v in f32_ms]}; first step's loss from the "
        f"seeded state: f32 {first['float32']!r}, bf16 "
        f"{first['bfloat16']!r} (printed only)")
    report["bf16_wl"] = dict(runs=loop["runs"], repeat=loop["repeat"],
                             peak_bytes=loop["peak"], ms=bf16_ms,
                             f32_ms=f32_ms, first_loss=first)

    # -- one bf16 PL epoch on phase 9's labels
    pl_config = VaihingenPLConfig()
    pl_config.num_classes = 9
    pl_step, pl_val = pl_expected(pl_config)
    pl, paths["bf16_pl"], report["bf16_pl"] = entry(
        stage_with(PL, compute_dtype="bfloat16"),
        os.path.join(work, BF16_LOG + "_pl"), BF16_PL_ARGS, "bf16 PL epoch",
        1, pl_step, pl_val)
    expect(pl.mode == "pseudo" and all(
        m.params.compute_dtype == "bfloat16"
        for _, m in kpconv_modules(pl.model)),
        "phase 13: the bf16 PL run is not a bf16 pseudo-label run")
    kernels["bf16_pl"] = conv_set(model_convs(pl.model, first_pyramid(pl),
                                              SEED), "bfloat16", log,
                                  "phase 13 PL shapes")

    # -- a generated disposition of 20 kernel points
    disp_dir = os.path.join(work, "dispositions")
    shipped = sorted(os.listdir(kernel_points._DISPOSITION_DIR))
    saved_dir = kernel_points._DISPOSITION_DIR
    kernel_points._DISPOSITION_DIR = disp_dir
    try:
        t0 = time.perf_counter()
        kp20, paths["kp20_wl"], report["kp20_wl"] = entry(
            stage_with(WL, num_kernel_points=KP20),
            os.path.join(work, BF16_LOG + "_kp20"), KP20_ARGS,
            "Kp 20 WL epoch", 1, per_step, per_val)
        report["kp20_wl"]["wall_with_generation_s"] = (time.perf_counter()
                                                       - t0)
    finally:
        kernel_points._DISPOSITION_DIR = saved_dir
    written = sorted(os.listdir(disp_dir))
    expect(written == [f"k_{KP20:03d}_center_3D.ply"]
           and sorted(os.listdir(saved_dir)) == shipped
           and all(m.kernel_points.shape[0] == KP20
                   for _, m in kpconv_modules(kp20.model)),
           f"phase 13: the Kp {KP20} run wrote {written} (the package's "
           f"dispositions: {sorted(os.listdir(saved_dir))})")
    kernels["kp20_wl"] = conv_set(model_convs(kp20.model,
                                              first_pyramid(kp20), SEED),
                                  "float32", log, "phase 13 Kp 20 shapes")
    return report, kernels, paths


# Phase 14: data parallel. Two gloo ranks share the card (NCCL refuses two
# ranks on one card), eager: VaihingenWLConfig's batch_num 3 rounds up to
# 4, 2 spheres a rank, and VaihingenPLConfig's 4 splits in 2; each rank
# votes one batch and takes one step on phase 6's tile (phase 9's labels
# in pseudo mode). Then one NCCL rank runs DP_NCCL_EPOCHS graphed WL
# epochs of DP_NCCL_STEPS batches (DP_NCCL_VAL validation batches each)
# beside the same epochs with no group, and one epoch of each again under
# torch.profiler
DP_WORLD = 2
DP_STEP_SEED = 7
DP_LOSS_RTOL = 1e-5
DP_VOTE_ATOL = 1e-4
DP_NCCL_EPOCHS = 2
DP_NCCL_STEPS = 24
DP_NCCL_MIN_STEPS = 20
DP_NCCL_VAL = 10
DP_PROFILE_SKIP = 2


@contextlib.contextmanager
def recorded_draws():
    """([dropout masks], [contrast draws]) of the steps run in the block,
    in call order."""
    from weasal_tpu_torch.models import architectures, blocks, losses
    masks, draws = [], []
    draw, dropout = losses.contrast_draw, architectures.dropout

    def recording_draw(*a, **k):
        idx = draw(*a, **k)
        draws.append(idx.detach().clone())
        return idx

    def recording_dropout(x, rate, seed=None, keep=None):
        if keep is None:
            keep = blocks.dropout_keep(x.shape, rate, seed)
        masks.append(keep.clone())
        return dropout(x, rate, keep=keep)

    losses.contrast_draw = recording_draw
    architectures.dropout = recording_dropout
    try:
        yield masks, draws
    finally:
        losses.contrast_draw, architectures.dropout = draw, dropout


def dp_setup(mode, root, dev, batch_num=None):
    """(trainer, source, extra) of phase 14 in `mode` ('weak' or 'pseudo')
    on phase 6's tile, the potentials seeded, nothing saved: eager alone,
    and under a gloo group eager by its own choice."""
    from weasal_tpu_torch.config import VaihingenPLConfig, VaihingenWLConfig
    from weasal_tpu_torch.data.datasets import (Vaihingen3DPLDataset,
                                                Vaihingen3DWLDataset)
    from weasal_tpu_torch.parallel import ddp
    from weasal_tpu_torch.train.trainer import ModelTrainer
    if mode == "weak":
        config, cls = VaihingenWLConfig(), Vaihingen3DWLDataset
    else:
        config, cls = VaihingenPLConfig(), Vaihingen3DPLDataset
        config.num_classes = 9
        config.weak_label_log = PL_LOG
    config.saving = False
    if batch_num:
        config.batch_num = batch_num
    ctx = ddp.current()
    if ctx is not None:
        config.data_parallel_devices = ctx.world
    with ddp.rank0_first():
        ds = cls(config, split="training", data_root=root,
                 rng=np.random.default_rng(SEED))
    trainer = ModelTrainer(config, ds, device=dev,
                           graphs=False if ctx is None else None)
    source, extra = trainer._source(ds)
    return trainer, source, extra


def dp_inputs(arrays, extra, dev):
    """A batch's tensors on `dev` (as the prefetcher converts them) with
    the resident tensors and the step seed DP_STEP_SEED."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    out.update(extra)
    out["step_seed"] = torch.tensor(DP_STEP_SEED, dtype=torch.int64,
                                    device=dev)
    return out


def dp_vote(trainer, source, extra, rng):
    """One vote batch of the trainer's initial model smoothed into fresh
    buffers (`update_gathered`: every rank's spheres under a group):
    (probabilities of the global batch, buffers, flat_inds), on the
    CPU."""
    from weasal_tpu_torch.infer import eval_body
    from weasal_tpu_torch.parallel import ddp
    from weasal_tpu_torch.train.tester import TEST_RADIUS_RATIO, TEST_SMOOTH
    from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
    config, dev = trainer.config, trainer.device
    arrays, _ = source.next_batch(rng, augment=True)
    inputs = dp_inputs(arrays, extra, dev)
    acc = DeviceVoteAccumulator(
        source.resident, config.num_classes, smooth=TEST_SMOOTH,
        radius_sq=(TEST_RADIUS_RATIO * config.in_radius) ** 2)
    with torch.no_grad():
        ev = eval_body(trainer.model, inputs, config, trainer.plan, dev,
                       spec=trainer.spec)
        acc.update_gathered(ev["probs"], inputs, d2=ev["d2"])
    return (ddp.gather_spheres(ev["probs"]).cpu(), acc._flat.cpu(),
            ddp.gather_spheres(inputs["flat_inds"]).cpu())


def dp_batch(trainer, source, rng):
    """The next batch of `source` with regions (any in pseudo mode)."""
    while True:
        arrays, metas = source.next_batch(rng)
        if trainer.mode == "pseudo" or any(m["has_regions"] for m in metas):
            return arrays


def dp_rank(root, out_dir):
    """One rank of phase 14(a) under `ddp.spawn`: in weak mode a vote
    batch, then in each mode one eager step on this rank's spheres, its
    launches counted from 0; writes rank<r>.pt into `out_dir`."""
    from weasal_tpu_torch.parallel import ddp
    from weasal_tpu_torch.train.graphs import COUNTED
    from weasal_tpu_torch.train.step import step_body, step_outputs
    from weasal_tpu_torch.utils.device import configure_precision
    ctx = ddp.current()
    dev = ctx.device
    configure_precision()
    result = {}
    for mode in ("weak", "pseudo"):
        trainer, source, extra = dp_setup(mode, root, dev)
        config, plan = trainer.config, trainer.plan
        rng = np.random.default_rng(SEED)
        out = dict(batch_num=config.batch_num)
        if mode == "weak":
            out["vote_probs"], out["votes"], out["vote_inds"] = dp_vote(
                trainer, source, extra, rng)
        inputs = dp_inputs(dp_batch(trainer, source, rng), extra, dev)
        stats = step_outputs(plan, dev)
        branches = Branches()
        for fn in COUNTED:
            fn.launches = 0
        with recorded_draws() as (masks, draws), branches.recording():
            step_body(trainer.model, trainer.opt_state, inputs, config,
                      plan, trainer.lr_t, stats, trainer.class_w,
                      trainer.table, spec=trainer.spec,
                      use_contrast=mode == "pseudo")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.update(
            launches={fn.__name__: fn.launches for fn in COUNTED},
            loss=stats["stats"][0].cpu(),
            flat_inds=inputs["flat_inds"].cpu(),
            grads={n: p.grad.cpu()
                   for n, p in trainer.model.named_parameters()},
            state={k: v.cpu() for k, v in trainer.model.state_dict().items()},
            masks=[m.cpu() for m in masks], draws=[d.cpu() for d in draws],
            branches={k: [t.cpu() for t in v]
                      for k, v in branches.recorded.items()})
        result[mode] = out
        del trainer, source, extra
    torch.save(result, os.path.join(out_dir, f"rank{ctx.rank}.pt"))


def plain_pyramid(inputs, trainer):
    """The pyramid of a resident batch on the plain versions."""
    from weasal_tpu_torch.data.resident import assemble_level0_device
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.device import plain_ops
    config, plan = trainer.config, trainer.plan
    with torch.no_grad():
        t = assemble_level0_device(inputs, config, plan, augment=True,
                                   spec=trainer.spec)
        with plain_ops():
            return batch_from_device_pyramid(
                t["points0"], t["mask0"], t["features"], t["labels"],
                config, plan, t["center_pts"], rotations=t["rotations"],
                cloud_lb=t["cloud_lb"], region_inds=t["region_inds"],
                region_masks=t["region_masks"],
                region_point_masks=t["region_point_masks"],
                region_lb=t["region_lb"])


def run_data_parallel(root, work, counted, card, log, dev=None):
    """Phase 14: data parallel on the card.

    (a) DP_WORLD gloo ranks sharing cuda:0 (`ddp.spawn`, eager), each
    running `dp_rank`: the WL step (batch_num 3 -> 4) and the PL step with
    dropout and the contrast loss on their spheres, kernels A-D launched
    on every rank. Against one process on the same 4 spheres (the same
    seeded sampler): the loss within DP_LOSS_RTOL of the single-process
    kernel step; the gradients and state changes held to the f64 plain
    step of the global batch with phases 5 and 9's allowance
    (`compare_train_steps`, `given`), every step held there replaying
    the ranks' recorded branches (`Branches`); the dropout masks and the contrast
    draw bit-equal to the single-process step's; the parameters and
    running statistics bit-equal across the ranks; one vote batch's
    probabilities within DP_VOTE_ATOL of one process's, with the vote
    buffers bit-equal on the ranks.
    (b) one NCCL rank (a group of 1 in this process) through the graphed
    WL trainer for DP_NCCL_EPOCHS epochs of DP_NCCL_STEPS batches (at
    least DP_NCCL_MIN_STEPS steps with regions in the last), beside the
    same epochs with no group: the losses, the parameters and the running
    statistics bit-equal, every step replayed (the collectives inside the
    captured graphs), ms a step of both by epoch; then one epoch of both
    again under torch.profiler, for the device busy ms a step past its
    first DP_PROFILE_SKIP dispatches and the kernels that only the group
    launches.
    Returns the report and the launches of the ranks' steps (summed over
    the ranks) and of the NCCL epoch. `dev` is the card (cuda:0 by
    default; the CPU rehearses (a) with the plain versions)."""
    from weasal_tpu_torch.config import VaihingenWLConfig
    from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
    from weasal_tpu_torch.parallel import ddp
    from weasal_tpu_torch.train.step import step_on_batch
    from weasal_tpu_torch.train.trainer import ModelTrainer
    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    report, paths = {}, {}
    out_dir = os.path.join(work, "data_parallel")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    ddp.spawn(dp_rank, DP_WORLD, str(dev), args=(root, out_dir),
              timeout=600.0)
    report["ranks_s"] = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    log(f"[{card}] phase 14 (a): {DP_WORLD} gloo ranks on {dev} ran in "
        f"{report['ranks_s']:.1f} s (start, set-up, a vote batch, a WL and "
        "a PL step each)")
    for mode, path in (("weak", "dp_wl"), ("pseudo", "dp_pl")):
        rk = [r[mode] for r in ranks]
        what = f"phase 14 {path}"
        paths[path] = {k: sum(r["launches"][k] for r in rk)
                       for k in rk[0]["launches"]}
        for i, r in enumerate(rk):
            for name in ("radius_search", "kpconv_fwd", "kpconv_bwd",
                         "maxpool_bwd"):
                expect(r["launches"][name] > 0,
                       f"{what}: rank {i} launched no {name}")
        expect(all(_same_state(rk[0]["state"], r["state"]) for r in rk),
               f"{what}: the ranks' parameters and statistics differ")
        trainer, source, extra = dp_setup(mode, root, dev,
                                          batch_num=rk[0]["batch_num"])
        config = trainer.config
        expect(rk[0]["batch_num"] == 4,
               f"{what}: batch_num {rk[0]['batch_num']}, not 4")
        rng = np.random.default_rng(SEED)
        entry = dict(batch_num=rk[0]["batch_num"], launches=paths[path],
                     rank_launches=[r["launches"] for r in rk])
        if mode == "weak":
            probs, votes, inds = dp_vote(trainer, source, extra, rng)
            real = inds < source.resident.shadow
            p_diff = float((rk[0]["vote_probs"] - probs)[real].abs().max())
            v_diff = float((rk[0]["votes"] - votes).abs().max())
            same_votes = all(torch.equal(rk[0]["votes"], r["votes"])
                             for r in rk)
            expect(bool(torch.equal(rk[0]["vote_inds"], inds)),
                   f"{what}: the ranks voted other spheres")
            expect(p_diff <= DP_VOTE_ATOL and v_diff <= DP_VOTE_ATOL,
                   f"{what}: vote probabilities {p_diff:.2e}, buffers "
                   f"{v_diff:.2e} from one process's (atol {DP_VOTE_ATOL})")
            expect(same_votes, f"{what}: the ranks' vote buffers differ")
            entry.update(vote_probs_max_diff=p_diff,
                         vote_buffers_max_diff=v_diff,
                         vote_buffers_equal=same_votes)
        inputs = dp_inputs(dp_batch(trainer, source, rng), extra, dev)
        spheres = torch.cat([r["flat_inds"] for r in rk])
        expect(bool(torch.equal(spheres, inputs["flat_inds"].cpu())),
               f"{what}: the ranks' spheres are not the global batch's")
        pyr = plain_pyramid(inputs, trainer)
        step_kw = None
        if mode == "pseudo":
            state0, opt0 = clone_state(trainer.model, trainer.opt_state)
            with recorded_draws() as (masks, draws):
                step_on_batch(trainer.model, trainer.opt_state, pyr, config,
                              config.learning_rate, seed=DP_STEP_SEED,
                              use_contrast=True)
            trainer.model.load_state_dict(state0)
            for k, v in opt0.items():
                trainer.opt_state[k].copy_(v)
            keep = torch.cat([r["masks"][0] for r in rk])
            same_mask = bool(torch.equal(keep, masks[0].cpu()))
            same_draw = all(torch.equal(r["draws"][0], draws[0].cpu())
                            for r in rk)
            expect(same_mask, f"{what}: the ranks' dropout masks are not "
                   "the single-process mask")
            expect(same_draw, f"{what}: a rank's contrast draw differs "
                   "from the single-process draw")
            entry.update(masks_equal=same_mask, draws_equal=same_draw)
            step_kw = dict(use_contrast=True, dropout_keep=masks[0],
                           slc_idx=draws[0])
        # the ranks' branches, in sphere order: every step held here (one
        # process's kernel step too) takes the data-parallel step's
        # leaky-ReLU signs and pool winners, so that a tie turned by the
        # ranks' other f32 order of the sums does not read as an error
        branches = Branches.of_ranks([r["branches"] for r in rk], dev)
        cmp = compare_train_steps(
            trainer.model, trainer.opt_state, pyr, config, log,
            label=f"{what}, one process", step_kw=step_kw,
            given={"data parallel": (rk[0]["loss"], rk[0]["grads"],
                                     rk[0]["state"])}, branches=branches)
        loss_dp = float(rk[0]["loss"])
        rel = abs(loss_dp - cmp["loss"]) / abs(cmp["loss"])
        expect(rel <= DP_LOSS_RTOL, f"{what}: loss {loss_dp} against one "
               f"process's {cmp['loss']} (rel {rel:.2e})")
        entry.update(loss=loss_dp, loss_one_process=cmp["loss"],
                     loss_rel=rel, f64=cmp)
        log(f"[{card}] {what}: loss {loss_dp:.7f} ({rel:.2e} from one "
            f"process's), share of the f64 allowance "
            f"{cmp['data parallel']['share']:.3f} (one process: "
            f"{cmp['share']:.3f}); launches over the ranks {paths[path]}")
        report[path] = entry
        del trainer, source, extra, pyr

    # (b) one NCCL rank, graphed, beside no group
    def epochs(tag, profiled=False):
        config = VaihingenWLConfig()
        # a profiled run: one epoch and one validation batch (the
        # profiler's events cost host seconds), read past its capture
        config.max_epoch = 1 if profiled else DP_NCCL_EPOCHS
        config.epoch_steps = DP_NCCL_STEPS
        config.validation_size = 1 if profiled else DP_NCCL_VAL
        config.saving_path = os.path.join(work, f"dp_{tag}")
        ds = Vaihingen3DWLDataset(config, split="training", data_root=root,
                                  rng=np.random.default_rng(SEED))
        trainer = ModelTrainer(config, ds, device=dev)
        losses = []
        flush_log = ModelTrainer._flush_log

        def keep_losses(self, pending, log_file, al_iteration):
            losses.extend(float(p[2]) for p in pending)
            return flush_log(self, pending, log_file, al_iteration)

        def skipped(e):
            return min(DP_PROFILE_SKIP, max(len(e["dispatch_stamps"]) - 1,
                                            0))

        def replays():
            e = trainer.epoch_times[-1]
            stamps = e["dispatch_stamps"] or [e["start"]]
            return stamps[skipped(e)], e["start"] + e["seconds"]

        ModelTrainer._flush_log = keep_losses
        for fn in counted:
            fn.launches = 0
        profile = None
        try:
            if profiled:
                profile = profiled_kernels(lambda: trainer.train(ds),
                                           window=replays)
            else:
                trainer.train(ds)
        finally:
            ModelTrainer._flush_log = flush_log
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        e = trainer.epoch_times
        return dict(losses=losses, steps=sum(x["steps"] for x in e),
                    last_steps=e[-1]["steps"],
                    window_steps=e[-1]["steps"] * (1 - skipped(e[-1]) / max(
                        len(e[-1]["dispatch_stamps"]), 1)),
                    ms=[1e3 * x["seconds"] / max(x["steps"], 1) for x in e],
                    profile=profile,
                    counts=trainer.graph_counts(),
                    launches={fn.__name__: fn.launches for fn in counted},
                    state={k: v.cpu()
                           for k, v in trainer.model.state_dict().items()})

    def nccl(profiled=False):
        with ddp.group(0, 1, "nccl", dev, os.path.join(
                work, f"nccl_store{int(profiled)}")):
            return epochs("nccl", profiled)

    grouped = nccl()
    alone = epochs("alone")
    counts = grouped["counts"]
    expect(grouped["last_steps"] >= DP_NCCL_MIN_STEPS,
           f"phase 14 (b): {grouped['last_steps']} steps with regions in "
           "the last epoch")
    expect(counts["train_replayed_steps"] == grouped["steps"],
           f"phase 14 (b): {counts['train_replayed_steps']} of "
           f"{grouped['steps']} NCCL steps replayed")
    same_losses = grouped["losses"] == alone["losses"]
    same_state = _same_state(grouped["state"], alone["state"])
    expect(same_losses and len(alone["losses"]) == grouped["steps"],
           "phase 14 (b): the NCCL epochs' losses differ from the epochs "
           "with no group")
    expect(same_state, "phase 14 (b): the NCCL epochs' parameters or "
           "statistics differ from the epochs with no group")
    paths["dp_nccl_wl"] = grouped["launches"]
    # both again, profiled past their first DP_PROFILE_SKIP dispatches
    # (replays only): device busy ms a step, and the kernels that only the
    # group launches
    prof = {}
    for tag, run in (("nccl", lambda: nccl(True)),
                     ("alone", lambda: epochs("alone_profiled", True))):
        r = run()
        rows, wall, busy = r["profile"]
        prof[tag] = dict(busy_ms_step=busy / max(r["window_steps"], 1),
                         steps=r["window_steps"],
                         launches=sum(n for _, n, _ in rows),
                         kernel_ms=sum(t for _, _, t in rows),
                         rows={k: (n, t) for k, n, t in rows})
    extra = sorted(((k, n - prof["alone"]["rows"].get(k, (0, 0.0))[0],
                     t - prof["alone"]["rows"].get(k, (0, 0.0))[1])
                    for k, (n, t) in prof["nccl"]["rows"].items()),
                   key=lambda r: -r[2])
    extra = [r for r in extra if r[1] > 0][:10]
    report["nccl"] = dict(
        steps=grouped["steps"], ms=grouped["ms"], ms_no_group=alone["ms"],
        busy_ms_step=prof["nccl"]["busy_ms_step"],
        busy_ms_step_no_group=prof["alone"]["busy_ms_step"],
        run_launches=prof["nccl"]["launches"],
        run_launches_no_group=prof["alone"]["launches"],
        run_kernel_ms=prof["nccl"]["kernel_ms"],
        run_kernel_ms_no_group=prof["alone"]["kernel_ms"],
        extra_kernels=extra, losses_equal=same_losses,
        state_equal=same_state, counts=counts,
        launches=grouped["launches"])
    log(f"[{card}] phase 14 (b): one NCCL rank, graphed WL trainer, "
        f"{DP_NCCL_EPOCHS} epochs of {DP_NCCL_STEPS} batches: "
        f"{[round(v, 2) for v in grouped['ms']]} ms a step by epoch; with "
        f"no group {[round(v, 2) for v in alone['ms']]} ms; losses "
        f"bit-equal {same_losses}, state bit-equal {same_state}; "
        f"{counts['train_replays']} replays")
    log(f"[{card}] phase 14 (b) profiled epoch past its first "
        f"{DP_PROFILE_SKIP} dispatches: device busy "
        f"{prof['nccl']['busy_ms_step']:.3f} ms a step with the group, "
        f"{prof['alone']['busy_ms_step']:.3f} without; over each whole "
        f"profiled run (warm-up, capture and a validation batch included) "
        f"{prof['nccl']['launches']} launches, "
        f"{prof['nccl']['kernel_ms']:.3f} kernel ms with the group, "
        f"{prof['alone']['launches']}, {prof['alone']['kernel_ms']:.3f} "
        "without; launches the group adds (name, count, device ms over "
        "the run): "
        + "; ".join(f"{k[:60]} {n} {t:.3f}" for k, n, t in extra))
    return report, paths


# Phase 15: the visualizer's query points, the profiled WL epoch's steps
VIS_QUERIES = (0, 1, 2)
P15_STEPS = 10
# The profile readers against torch.profiler's own events of one window:
# each family's device ms and the busy ms within this share of each other
READER_RTOL = 0.01
P15_MARK = "chip_smoke: phase 15 mark"


def check_visualizer(handoff, work, counted, card, log):
    """Phase 15 (a): `ModelVisualizer.show_deformable_kernels` on phase
    11's deformable PL model and one of its validation batches: the
    pyramid built on the card (kernel A) and the eval forward (kernel B,
    the offset convs among them) with the launches counted from 0, then
    the same on the plain versions (`plain_ops()`). The deformed kernel
    points of every deformable conv agree within the KPConv tolerance of
    phases 2 and 11, both runs write the same files, and the eval
    forward is timed with the kernels and plain (CUDA events, median of
    10). Returns (report, launches)."""
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.device import plain_ops
    from weasal_tpu_torch.utils.visualizer import ModelVisualizer
    model, config, plan, t = (handoff[k] for k in ("model", "config",
                                                   "plan", "level0"))
    model.eval()

    def pyramid():
        return batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t["rotations"])

    runs = {}
    for label in ("kernels", "plain"):
        vis = ModelVisualizer(model)
        out = os.path.join(work, f"phase15_vis_{label}")
        with contextlib.ExitStack() as stack:
            if label == "plain":
                stack.enter_context(plain_ops())
            for fn in counted:
                fn.launches = 0
            t0 = time.perf_counter()
            with torch.no_grad():
                pyr = pyramid()
                frames = vis.show_deformable_kernels(
                    pyr, out, sphere=0, query_indices=VIS_QUERIES)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {fn.__name__: fn.launches for fn in counted}
            with torch.no_grad():
                fwd_ms = cuda_ms(lambda: model(pyr))
        runs[label] = dict(frames=[os.path.relpath(f, out) for f in frames],
                           files=sorted(os.listdir(out)), wall_s=wall,
                           launches=launches, forward_ms=fwd_ms,
                           deformed=vis.deformed)
    k, p = runs["kernels"], runs["plain"]
    n_convs = len(k["deformed"])
    want = {n: handoff["per_val"].get(n, 0) for n in k["launches"]}
    expect(k["launches"] == want, f"phase 15 (a): the visualizer's launches "
           f"{k['launches']}, expected an eval batch's {want}")
    expect(n_convs > 0 and len(k["frames"]) == n_convs
           * (len(VIS_QUERIES) + 1) and k["frames"] == p["frames"]
           and k["files"] == p["files"]
           and {"input.ply", "input.html"} <= set(k["files"]),
           f"phase 15 (a): {n_convs} deformable convs, frames "
           f"{k['frames']} (plain {p['frames']}), files {k['files']}")
    worst = 0.0
    for name, ref in p["deformed"].items():
        got = k["deformed"][name]
        scale = float(ref.abs().max())
        _expect_close(f"phase 15 (a) deformed kernel points {name}", got,
                      ref, KPCONV_RTOL, KPCONV_ATOL_REL * scale)
        worst = max(worst, float((got - ref).abs().max()))
    log(f"[{card}] phase 15 (a) visualizer: {n_convs} deformable convs, "
        f"{len(k['frames'])} frames and {len(k['files'])} files a run; "
        f"deformed kernel points, kernels vs plain: max abs err "
        f"{worst:.3e}; eval forward {k['forward_ms']:.3f} ms with the "
        f"kernels, {p['forward_ms']:.3f} ms plain; pyramid + visualizer "
        f"{k['wall_s']:.2f} s ({p['wall_s']:.2f} s plain); launches "
        f"{k['launches']}")
    report = {label: {key: v for key, v in r.items() if key != "deformed"}
              for label, r in runs.items()}
    report["max_abs_err"] = worst
    return report, k["launches"]


def check_max_pool_block(trainer, counted, card, log, seed):
    """Phase 15 (b): `MaxPoolBlock` (the 'max_pool' block, JAX's edge
    `pools[layer_ind + 1]`) at layer 0 on the first batch of phase 6's
    tile (`first_pyramid`): level 0's features at the WL model's first
    width pooled over pools[1], forward and backward with the kernels
    (launches counted from 0: one D, one list build) and on the plain
    versions; the forwards equal. The edge's shadow index, N_{l+1}, is
    a real row of level l's features, so every padded slot of the edge
    adds into that row: one inverse list of tens of thousands of slots a
    sphere, whose f32 sum moves with its order (3e-3 at a scale of 150
    between the kernel's order and `index_add_`'s, H100 80GB HBM3,
    700 W). So dX's other rows are held within D's tolerance (phase 4's)
    to the plain version, and that row, kernel and plain, to an f64
    evaluation of the plain version: the kernel's error within F64_RATIO
    times the plain version's, plus D's tolerance. Kernel D on the edge
    is timed beside its plain version and its bound.
    Returns (report, launches, the kernel's sums)."""
    from weasal_tpu_torch.models.blocks import MaxPoolBlock
    from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
    from weasal_tpu_torch.ops.cuda.maxpool_bwd import (maxpool_bwd,
                                                       maxpool_bwd_plain)
    from weasal_tpu_torch.utils.device import plain_ops
    pyr = first_pyramid(trainer)
    dev = pyr.features.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    block = MaxPoolBlock(0)
    nb = pyr.pools[1]
    b, ns = pyr.points[0].shape[:2]
    c = trainer.config.first_features_dim
    # integer values force ties; channel 0 is never positive
    x = torch.randint(-3, 3, (b, ns, c), generator=gen, device=dev).float()
    x[:, :, 0].clamp_(max=0.0)
    g = torch.randn((b, nb.shape[1], c), generator=gen, device=dev)
    out = {}
    for label in ("kernels", "plain"):
        xr = x.clone().requires_grad_()
        with contextlib.ExitStack() as stack:
            if label == "plain":
                stack.enter_context(plain_ops())
            for fn in counted:
                fn.launches = 0
            y = block(xr, pyr)
            y.backward(g)
            torch.cuda.synchronize()
        out[label] = (y.detach(), xr.grad,
                      {fn.__name__: fn.launches for fn in counted})
    (yk, dk, launches), (yp, dp, _) = out["kernels"], out["plain"]
    expect(tuple(yk.shape) == (b, nb.shape[1], c) and torch.equal(yk, yp),
           f"phase 15 (b): MaxPoolBlock forward {tuple(yk.shape)}, kernels "
           "and plain equal")
    shadow = pyr.points[1].shape[1]
    rest = torch.ones(ns, dtype=torch.bool, device=dev)
    rest[shadow] = False
    scale = float(dp[:, rest].abs().max())
    atol = MAXPOOL_ATOL_REL * max(scale, 1e-30)
    _expect_close("phase 15 (b) MaxPoolBlock dX but the edge's shadow row",
                  dk[:, rest], dp[:, rest], MAXPOOL_RTOL, atol)
    err = float((dk[:, rest] - dp[:, rest]).abs().max())
    exact = maxpool_bwd_plain(x.double(), nb, g.double())[:, shadow]
    f64_k = float((dk[:, shadow].double() - exact).abs().max())
    f64_p = float((dp[:, shadow].double() - exact).abs().max())
    expect(f64_k <= F64_RATIO * f64_p + atol, f"phase 15 (b): MaxPoolBlock "
           f"dX's shadow row {f64_k:.3e} from f64, the plain version's "
           f"{f64_p:.3e}")
    lists = LazyInverse(nb, ns).get()
    longest = int((lists.offsets[1:] - lists.offsets[:-1]).max())
    want = {n: int(n in ("maxpool_bwd", "build_inverse_lists"))
            for n in launches}
    expect(launches == want, f"phase 15 (b): launches {launches}, "
           f"expected {want}")
    inv = LazyInverse(nb, ns)
    inv.get()
    ms = cuda_ms(lambda: maxpool_bwd(x, nb, g, inverse=inv))
    plain = cuda_ms(lambda: maxpool_bwd_plain(x, nb, g))
    n_bytes = 4.0 * (x.numel() + nb.numel() + g.numel() + dk.numel())
    b_ms, b_by = bound_ms(n_bytes, 0.0)
    sums = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, calls=1)
    log(f"[{card}] phase 15 (b) MaxPoolBlock at layer 0 over pools[1] "
        f"(nb {list(nb.shape)}, Ns {ns}, C {c}, longest inverse list "
        f"{longest}): forward equal; dX err {err:.2e} but the shadow row "
        f"{shadow} (scale {scale:.2e}); that row from f64 {f64_k:.2e} "
        f"(kernel), {f64_p:.2e} (plain); kernel D {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}); launches "
        f"{launches}")
    return dict(shape=[b, nb.shape[1], ns, nb.shape[2], c],
                longest_list=longest, shadow_row_f64_err=f64_k,
                shadow_row_f64_err_plain=f64_p, **sums), launches, sums


def check_profile_readers(trainer, work, counted, card, log):
    """Phase 15 (c): one graphed WL epoch of P15_STEPS steps on phase 6's
    tile inside `device_trace` (through `profiled_kernels`, its Chrome
    trace kept): `module_times_us(trace, "train_step_k")` gives one
    duration a replay and their sum lies within the epoch's wall; the
    readers' `stage_breakdown` times the steps, by family, and their busy
    time inside the epoch's clock agree within READER_RTOL with the rows
    and busy time that torch.profiler's own events of the same window
    give (`profiled_kernels`). Returns the report."""
    from torch.profiler import record_function
    ds = trainer.datasets[0]
    trace = os.path.join(work, "phase15_trace")
    replays0 = trainer.graph_counts()["train_replays"]
    trainer.config.max_epoch = trainer.epoch + 1
    marks = []

    def epoch():
        # a mark of the trace's clock at a time.perf_counter() reading
        with record_function(P15_MARK):
            marks.append(time.perf_counter())
        trainer.train(ds)

    for fn in counted:
        fn.launches = 0
    rows, wall, busy = profiled_kernels(
        epoch, trace_dir=trace,
        window=lambda: epoch_window(trainer.epoch_times[-1]))
    launches = {fn.__name__: fn.launches for fn in counted}
    replays = trainer.graph_counts()["train_replays"] - replays0
    record = trainer.epoch_times[-1]
    steps, epoch_ms = record["steps"], 1e3 * record["seconds"]
    times = module_times_us(trace, "train_step_k")
    cores = module_times_us(trace, "step_core")
    expect(len(times) == replays and replays >= steps > 0,
           f"phase 15 (c): {len(times)} train_step_k durations for "
           f"{replays} replays ({steps} steps)")
    expect(sum(times) / 1e3 <= epoch_ms, f"phase 15 (c): the replays' "
           f"device spans sum to {sum(times) / 1e3:.3f} ms, more than the "
           f"epoch's wall {epoch_ms:.3f} ms")
    per_step = stage_breakdown(trace, steps)
    events = {f: ms for f, _, ms in kernel_families(rows)}
    agree = {}
    for fam in sorted(set(per_step) | set(events)):
        got, want = per_step.get(fam, 0.0) * steps / 1e3, events.get(fam, 0.0)
        agree[fam] = (got, want)
        expect(abs(got - want) <= READER_RTOL * want, f"phase 15 (c): "
               f"{fam}: stage_breakdown x {steps} steps {got:.4f} ms, the "
               f"profile's own events {want:.4f} ms")
    mark = host_ranges(trace, P15_MARK)[0][1]
    busy_json = busy_us(trace, tuple(mark + (t - marks[0]) * 1e6
                                     for t in epoch_window(record))) / 1e3
    expect(abs(busy_json - busy) <= READER_RTOL * busy,
           f"phase 15 (c): busy {busy_json:.3f} ms by the readers, "
           f"{busy:.3f} ms by the profile's own events")
    log(f"[{card}] phase 15 (c) device_trace of a graphed WL epoch: {steps} "
        f"steps, {replays} replays, epoch {epoch_ms:.1f} ms; train_step_k "
        f"device spans median {statistics.median(times or [0]):.1f} us, sum "
        f"{sum(times) / 1e3:.3f} ms; step_core (the capture's warm-up) "
        f"{[round(v, 1) for v in cores]} us; busy inside the epoch "
        f"{busy_json:.3f} ms by the readers, {busy:.3f} by the events; "
        f"stage_breakdown x steps against the profile's own events (ms): "
        + "; ".join(f"{f} {a:.3f}/{b:.3f}" for f, (a, b) in sorted(
            agree.items(), key=lambda kv: -kv[1][1])))
    return dict(steps=steps, replays=replays, epoch_ms=epoch_ms,
                profile_wall_ms=wall, train_step_k_us=times,
                step_core_us=cores, families=agree, busy_ms=busy,
                busy_ms_readers=busy_json, launches=launches)


def run_phase15(root, work, counted, handoff, card, log):
    """Phase 15: the visualizer on phase 11's model (`check_visualizer`),
    `MaxPoolBlock` on phase 6's tile (`check_max_pool_block`) and the
    profile readers on a graphed WL epoch there (`check_profile_readers`),
    one WL trainer (VaihingenWLConfig, graphed, nothing saved) serving
    (b) and (c). Returns (report, launches by path, D's sums)."""
    from weasal_tpu_torch.config import VaihingenWLConfig
    from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
    from weasal_tpu_torch.train.trainer import ModelTrainer
    vis, vis_launches = check_visualizer(handoff, work, counted, card, log)
    del handoff
    config = VaihingenWLConfig()
    config.epoch_steps = P15_STEPS
    config.saving = False
    ds = Vaihingen3DWLDataset(config, split="training", data_root=root,
                              rng=np.random.default_rng(SEED))
    trainer = ModelTrainer(config, ds, device=torch.device("cuda"))
    trainer.datasets = (ds, None)
    pool, pool_launches, d_sums = check_max_pool_block(trainer, counted,
                                                       card, log, SEED)
    readers = check_profile_readers(trainer, work, counted, card, log)
    return (dict(visualizer=vis, max_pool_block=pool, readers=readers),
            dict(visualize=vis_launches, max_pool_block=pool_launches),
            d_sums)


def main(argv=None) -> int:
    global CARD
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

    t_start = time.perf_counter()

    def phase(msg):
        log(f"{msg} [{time.perf_counter() - t_start:.0f} s]")

    # ---- phase 1: setup
    card = CARD = card_line()
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
    phase("phase 2: kernels vs plain versions")
    with torch.no_grad():
        a_rows, a_sum = check_radius_search(ref_batch, config, plan, log)
        b_rows, b_sum = check_kpconv(model, ref_batch, log, SEED)
    gemm_sums = log_gemm_sums(b_rows, ("gemm_y_w",), log)
    gemm_bias = check_gemm_bias(log, SEED)

    # ---- phase 3: the inference path
    phase("phase 3: eval_step on the card")
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
    phase("phase 4: backward kernels vs plain versions")
    c_rows, c_sum = check_kpconv_bwd(model, ref_batch, log, SEED)
    d_rows, d_sum = check_maxpool_bwd(model, ref_batch, log, SEED)
    gemm_sums.update(log_gemm_sums(c_rows, ("gemm_g_wt", "gemm_yt_g"), log))

    # ---- phase 5: the training path
    phase(f"phase 5: train_step on the card, {N_TRAIN_STEPS} steps")
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
    log("phase 5: the inverse lists and the row sums at adversarial shapes")
    inv_adversarial = check_inverse_lists(
        adversarial_inverse_calls(dev, SEED), log, totals=False)
    for name, t in inv_sums.items():
        t["exact"] &= inv_adversarial[name]["exact"]
        t["repeats"] &= inv_adversarial[name]["repeats"]
    deterministic = run_deterministic_step(log)

    # ---- phase 6: the training loop (phase 7 inside it)
    phase("phase 6: the weak-label training loop on the card")
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="chip_smoke_loop_")
    try:
        loop, loop_launches, root = run_loop(
            counted, expected, per_val, card, statistics.mean(train_ms[1:]),
            work, log)
        # ---- phase 8: testing and active learning on the loop's tile
        phase("phase 8: testing and weak-label active learning on the card")
        al, al_launches = run_active_learning(root, work, counted, expected,
                                              per_val, card, log)
        # ---- phase 9: the pseudo-label stage on the loop's tile
        phase("phase 9: the pseudo-label stage on the card")
        pl, pl_launches = run_pseudo_label(root, work, counted, card, log)
        # ---- phase 10: the DALES workflow on DALES-like tiles
        phase("phase 10: the DALES workflow on the card")
        dales, dales_wl, dales_pl = run_dales(work, counted,
                                              (expected, per_val), card, log)
        # ---- phase 11: deformable convs, checkpoints across formats
        phase("phase 11: the deformable pseudo-label stage on the card")
        deform, deform_pl, deform_handoff = run_deformable(
            root, work, counted, card, log)
        # ---- phase 12: the host-pyramid input path and KPCNN
        phase("phase 12: the host-pyramid input path and KPCNN on the card")
        host, host_kernels, host_paths = run_host_pyramid(
            root, work, counted, (expected, per_val), loop, card, log)
        # ---- phase 13: bf16 compute_dtype, a generated disposition
        phase("phase 13: bf16 compute_dtype and a generated kernel "
              "disposition on the card")
        bf16, bf16_kernels, bf16_paths = run_bf16_dispositions(
            root, work, counted, (expected, per_val), model, ref_batch,
            loop, card, log)
        # ---- phase 14: data parallel
        phase("phase 14: data-parallel training and voting on the card")
        dp, dp_paths = run_data_parallel(root, work, counted, card, log)
        # ---- phase 15: the visualizer, the max_pool block, the readers
        phase("phase 15: the deformable-kernel visualizer, the max_pool "
              "block and the profile readers on the card")
        p15, p15_paths, p15_d = run_phase15(root, work, counted,
                                            deform_handoff, card, log)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def line_fields(sums):
        return {k: v for k, v in sums.items() if k != "split"}

    paths = dict(inference=eval_launches, train_step=launches,
                 wl_loop=loop_launches, wl_active_learning=al_launches,
                 pl_stage=pl_launches, dales_wl=dales_wl, dales_pl=dales_pl,
                 deformable_pl=deform_pl, **host_paths, **bf16_paths,
                 **dp_paths, **p15_paths)

    def by_path(name):
        return {path: counts.get(name, 0) for path, counts in paths.items()}

    def main_path(name):
        return sum(by_path(name).values())

    stage_kernels = dict(pl=pl["kernels"], dales_wl=dales["wl"]["kernels"],
                         dales_pl=dales["pl"]["kernels"],
                         deform_pl=deform["kernels"], **host_kernels,
                         max_pool_block=dict(maxpool_bwd=p15_d,
                                             inverse_lists={}))

    def sums_of(kernels, name):
        return kernels.get(name) or kernels["inverse_lists"].get(name)

    def pl_fields(name):
        """The kernel's sums at the shapes of the pseudo-label loop
        (`pl_*`), of the DALES loops (`dales_wl_*`, `dales_pl_*`), of
        the deformable PL loop (`deform_pl_*`), of the host-pyramid WL
        loop (`host_wl_*`) and of KPCNN (`kpcnn_*`), where it runs: a
        path whose recorded calls hold none of the kernel's gives none
        of its fields (no zeros that were never measured)."""
        fields = {}
        for prefix, kernels in stage_kernels.items():
            sums = sums_of(kernels, name)
            if sums is not None and sums.get("calls", 1) > 0:
                fields.update({f"{prefix}_{k}": sums[k]
                               for k in ("ms", "plain_ms", "bound_ms")})
        return fields

    # The largest error of each kernel at any main path's shapes (and of B
    # and C at phase 13's f32 shapes: the Kp sweep and the Kp-20 model)
    for name, phase_sum in (("radius_search", a_sum), ("kpconv_fwd", b_sum),
                            ("kpconv_bwd", c_sum), ("maxpool_bwd", d_sum)):
        phase_sum["max_abs_err"] = max(
            phase_sum["max_abs_err"], loop["kernels"][name]["max_abs_err"],
            *(k[name]["max_abs_err"] for k in stage_kernels.values()
              if name in k))
    for name, phase_sum, key in (("kpconv_fwd", b_sum, "max_abs_err_b"),
                                 ("kpconv_bwd", c_sum, "max_abs_err_c")):
        phase_sum["max_abs_err"] = max(
            phase_sum["max_abs_err"],
            *(r[key] for k in bf16_kernels.values() for r in k["rows"]
              if key in r))

    def phase13_fields(part):
        """B's (`b`) or C's (`c`) sums at phase 13's shapes: `bf16_wl_*`,
        `bf16_pl_*`, `bf16_dales_*`, `bf16_kp40_k266_*` (bf16),
        `kp_sweep_*`, `kp40_k266_*`, `kp20_wl_*` (f32), the products'
        device ms and bounds at the WL shapes in bf16 (`bf16_wl_gemm_*`;
        C's `bf16_wl_gemm_g_wt_*`, `bf16_wl_gemm_yt_g_*`), and the
        largest bf16 flip share and distance to f64 at any of them."""
        fields = {f"{prefix}_{k}": sums[part][k]
                  for prefix, sums in bf16_kernels.items()
                  for k in ("ms", "plain_ms", "bound_ms")}
        fields.update({f"{prefix}_{g}_{k}": sums[part][g][k]
                       for prefix, sums in bf16_kernels.items()
                       for g in ("gemm", "gemm_g_wt", "gemm_yt_g")
                       if g in sums[part] for k in ("ms", "bound_ms")})
        rows = [r for k in bf16_kernels.values() for r in k["rows"]
                if r["dtype"] == "bfloat16"]
        flip_key, l2_key = (("y_flips", "out_to_f64") if part == "b"
                            else ("dw_flips", "dx_to_f64"))
        fields["bf16_max_flip_share"] = max(r[flip_key]["share"]
                                            for r in rows)
        fields["bf16_max_rel_l2_to_f64"] = max(r[l2_key]["rel_l2"]
                                               for r in rows)
        return fields

    kernels = [
        dict(name="radius_search", route="cuda",
             source="weasal_tpu_torch/csrc/radius_search.cu",
             replaces="weasal_tpu/ops/pallas/radius_pallas.py:196",
             launches=main_path("radius_search"),
             launches_by_path=by_path("radius_search"),
             **pl_fields("radius_search"), library_ms=None,
             **a_sum),
        dict(name="kpconv_fwd", route="cuda",
             source="weasal_tpu_torch/csrc/kpconv_fwd.cu",
             replaces="weasal_tpu/ops/pallas/kpconv_banded.py:478",
             launches=main_path("kpconv_fwd"),
             launches_by_path=by_path("kpconv_fwd"),
             **pl_fields("kpconv_fwd"), **phase13_fields("b"),
             library_ms=None, **b_sum),
        dict(name="kpconv_bwd", route="cuda",
             source="weasal_tpu_torch/csrc/kpconv_bwd.cu",
             replaces="weasal_tpu/ops/pallas/kpconv_banded.py:550",
             launches=main_path("kpconv_bwd"),
             launches_by_path=by_path("kpconv_bwd"),
             **pl_fields("kpconv_bwd"), **phase13_fields("c"),
             library_ms=None, **c_sum),
        dict(name="maxpool_bwd", route="cuda",
             source="weasal_tpu_torch/csrc/maxpool_bwd.cu",
             replaces="weasal_tpu/ops/pallas/maxpool_banded.py:159",
             launches=main_path("maxpool_bwd"),
             launches_by_path=by_path("maxpool_bwd"),
             **pl_fields("maxpool_bwd"), library_ms=None,
             **d_sum),
        # C's and D's dX sum over these lists in their own launches; the
        # standalone row sums are the other scatter-adds of the step. No
        # pallas_call computes them (the TPU kernels sum by membership
        # products), so they replace none and name the kernels they serve
        dict(name="build_inverse_lists", route="cuda",
             source="weasal_tpu_torch/csrc/inverse_lists.cu",
             replaces=None, helper_of=["kpconv_bwd", "maxpool_bwd"],
             launches=main_path("build_inverse_lists"),
             launches_by_path=by_path("build_inverse_lists"),
             **pl_fields("build_inverse_lists"),
             **line_fields(inv_sums["build_inverse_lists"])),
        dict(name="inverse_sum", route="cuda",
             source="weasal_tpu_torch/csrc/inverse_lists.cu",
             replaces=None, helper_of=["kpconv_bwd", "maxpool_bwd"],
             launches=main_path("inverse_sum"),
             launches_by_path=by_path("inverse_sum"),
             **pl_fields("inverse_sum"),
             **line_fields(inv_sums["inverse_sum"])),
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
                           inverse_lists_adversarial=inv_adversarial,
                           deterministic_step=deterministic,
                           active_learning=al, al_launches=al_launches,
                           pseudo_label=pl, pl_launches=pl_launches,
                           dales=dales, dales_wl_launches=dales_wl,
                           dales_pl_launches=dales_pl, deformable=deform,
                           deformable_pl_launches=deform_pl,
                           host_pyramid=host,
                           host_launches=host_paths,
                           bf16_dispositions=dict(report=bf16,
                                                  kernels=bf16_kernels,
                                                  launches=bf16_paths),
                           data_parallel=dict(report=dp,
                                              launches=dp_paths),
                           phase15=dict(report=p15, launches=p15_paths)), f,
                      indent=1)
    phase("chip_smoke: every phase ran")
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
