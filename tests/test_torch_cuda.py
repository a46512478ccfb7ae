"""Kernels A-D on the card against their plain versions, at small shapes
with shadows, masks, ties (a maximum of 0 shared with shadows for D) and
all three influences, and the autograd Functions that launch C and D.
Tolerances: B and C rtol 1e-4, atol 1e-5 x output scale (f32 sums in
another order; the GEMM core's 3xTF32 products are f32-grade); D rtol
1e-6, atol 1e-6 x scale (the kernel adds the shares of one support in
ascending slot order, `index_add_` in its own). C and D repeat bit for
bit, and a training step runs under `torch.use_deterministic_algorithms`;
inverse neighbor lists built inside a captured graph equal eager ones, and
the plain stable sort's on adversarial indices (tests/_inverse_cases.py);
the row sums and voxel run sums at C from 1 to 512, and over workspaces at
C's and D's widths, equal the sums added in list order bit for bit. The GEMM core of B and C is also held to f64 products at shapes
that reach each of its edges, at the main path's widest conv and at
DALES's first (Cin 3) and widest (1024 -> 512, depth 15360) convs, and,
on positive operands at both widest convs, to a mean relative error below
3e-8; B's
influences equal the plain version's bit for bit; and
B's and C's launches write nothing outside their buffers (guard bands of
a sentinel around each) and refuse a split-K workspace too short. Kernel
A runs the point sets built to break its column rule
(tests/_cell_search_cases.py) and a level-0-sized batch, equal to the
plain version and the same on a second call, writes only its output and
scratch, and refuses a scratch too short or misaligned. D runs at the
main path's K (14, 29), past its mask's 32 and 64 slots and at 256
channels (DALES's weak-label shortcut). The training
loop's input: the resident assembly and the vote buffers on the card
equal their CPU runs (1e-5 and 1e-6; the jitter's threefry bits are
equal, its normals within 4 ulp: log1p and sqrt round otherwise on the
card), and a two-step loop with validation,
graphed, launches 7 A and 12 B per step and per validation batch, 12 C
and 2 D per step, its warm-ups counted. The captured steps
(train/graphs.py): a replayed training step against the eager one, both
held to an f64 step from one state and pyramid (L2 error <= 1e-3 x norm
+ 4 x the eager step's, as chip_smoke.py); a replay after `lr_t.fill_`
applies the new rate; the validation graph equals `eval_batch` (1e-6), and a vote batch's
replay equals the eager body bit for bit (probabilities, labels, `d2`);
`load_checkpoint` and the vote buffer's `load` keep every captured
address; a capture that meets a host synchronization raises. The
pseudo-label stage (5 levels, dropout, the contrast loss): a graphed
epoch launches 13 A, 10 B, 10 C, 4 D, 14 list builds and 9 row sums a
step and 13 A, 10 B, 4 row sums a validation batch; a replayed step
equals the eager one (1e-6) and redraws with its seed; the dropout mask
and the contrast draw on the card equal the CPU's; the contrast loss's
gradient repeats bit for bit. Kernel A at K of 300 and 768 (the
deformable layers' wide searches), at their level-3 shapes (4 x 3192, K
266) and on the warp path's cases whose hits overflow its buffer equals
the plain version and repeats; the plain
voxel sums on the card equal the `run_sums` kernel bit for bit, and
three plain builds of one batch's pyramid are bit-equal (and equal the
kernels' build); a deformable pseudo-label step (layers 3-4 deformable)
repeats bit for bit, eager twice and replayed from a graph. The
host-pyramid path (config.device_pyramid False): B, C and D on
host-built neighbor lists and at KPCNN's shapes equal their plain
versions (and KPCNN's forward its plain one); a host step replayed from
a graph equals its eager body bit for bit; a graphed host epoch launches
0 A, 12 B, 12 C and 2 D a step and 0 A and 12 B a validation batch.
compute_dtype "bfloat16": B and C in their bf16 variants at GEMM_CASES
against their plain bf16 versions (y and dW by the flip criterion of
tests/_bf16_cases.py; out and dX as close to an f64 evaluation of the
same rounding points as the plain versions within 2x, or within 1e-4;
out within f32 tolerance of its own y @ bf(W)), and a bf16 step
replayed from a graph bit-equal to its eager run. Any kernel-point
count: B and C in f32 at Kp 1, 5, 16, 17, 20, 40 and at Kp 40 with K 266
(the influence tile past 48 KB of shared memory; bf16 too at 17 and 40)
within the f32 tolerances; a tile past the card's shared memory raises
and names the limit. Data parallel (parallel/ddp.py): two gloo ranks
sharing the card take a WL and a PL step equal to one process's (the
ranks bit-equal, the masks and the draw bit-equal to one process's), and
one NCCL rank's replayed step, its collectives inside the graph, is
bit-equal to the same step with no group; under a gloo group a trainer
on the card steps eagerly and refuses a request for graphs. The
deformable-kernel visualizer on the card equals its plain run (deformed
kernel points within B's tolerance, the same files), and the 'max_pool'
block's backward runs D on its edge, equal to the plain version.
Needs an
NVIDIA GPU with nvcc; skips elsewhere. On the machine with the card
(which has no JAX) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import contextlib
import ctypes
import math
import os

import numpy as np
import pytest
import torch

from weasal_tpu_torch.config import ShapeClsConfig
from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda import kpconv_bwd as bwd_lib
from weasal_tpu_torch.ops.cuda import kpconv_fwd as fwd_lib
from weasal_tpu_torch.ops.cuda import radius_search as radius_lib
from weasal_tpu_torch.ops.cuda.build import load_library
from weasal_tpu_torch.ops.cuda.inverse_lists import (
    LazyInverse, build_inverse_lists, build_inverse_lists_plain)
from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd, kpconv_bwd_plain
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd,
                                                  kpconv_fwd_plain,
                                                  kpconv_fwd_plain_with_y,
                                                  kpconv_fwd_with_y)
from weasal_tpu_torch.ops.cuda.maxpool_bwd import (maxpool_bwd,
                                                   maxpool_bwd_plain)
from weasal_tpu_torch.ops.cuda.radius_search import (
    radius_search, radius_search_plain, radius_search_warp_reference)
from weasal_tpu_torch.utils.device import plain_ops
from tests._bf16_cases import flips, flips_ok, is_bf16_valued, within_plain
from tests._cell_search_cases import (CASES as CELL_CASES, WARP_CASES,
                                      as_tensors, deformable_level3)
from tests._inverse_cases import (CASES as INVERSE_CASES, graph_replay,
                                  index_case, ordered_row_sums,
                                  ordered_run_sums, run_case)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("grid,k", [(False, 12), (True, 10), (False, 200)])
def test_radius_search_kernel_equals_plain(dev, grid, k):
    g = torch.Generator(device=dev).manual_seed(0)
    b, nq, ns = 2, 333, 777
    if grid:
        s = torch.randint(-3, 4, (b, ns, 3), generator=g, device=dev).float()
    else:
        s = torch.rand((b, ns, 3), generator=g, device=dev) * 6 - 3
    q = s[:, :nq].contiguous()
    qm = torch.rand((b, nq), generator=g, device=dev) > 0.1
    sm = torch.rand((b, ns), generator=g, device=dev) > 0.1
    got, ovf = radius_search(q, s, qm, sm, 1.3, k)
    want = radius_search_plain(q, s, qm, sm, 1.3, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(ovf.sum()) == 0.0


@pytest.mark.parametrize("k", [300, 768])
def test_radius_search_kernel_at_wide_k(dev, k):
    """K of several hundred, as the deformable layers' wider searches
    give (up to MAX_K): hundreds of hits a query on the warp path, its
    buffer cut to K at K = 300; equal to the plain version and the same
    on a second call."""
    g = torch.Generator(device=dev).manual_seed(k)
    b, nq, ns = 2, 200, 1500
    s = torch.rand((b, ns, 3), generator=g, device=dev) * 6 - 3
    q = s[:, :nq].contiguous()
    qm = torch.rand((b, nq), generator=g, device=dev) > 0.1
    sm = torch.rand((b, ns), generator=g, device=dev) > 0.1
    got, ovf = radius_search(q, s, qm, sm, 3.0, k)
    again, _ = radius_search(q, s, qm, sm, 3.0, k)
    want = radius_search_plain(q, s, qm, sm, 3.0, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    assert float(ovf.sum()) == 0.0
    hits = (got < ns).sum(dim=-1)[qm]
    assert int(hits.max()) >= 300        # full rows at K = 300


def test_radius_search_kernel_at_deformable_level3(dev):
    """The deformable layers' widest search at its shapes (4 x 3192
    points, r 11.52 m, K 266: about 200 hits a query, the densest more
    than K) on the warp path: equal to the plain version, the same on a
    second call, full rows where the hits exceed K."""
    q, s, qm, sm = (t.to(dev) for t in as_tensors(
        *deformable_level3(np.random.default_rng(3))))
    got, ovf = radius_search(q, s, qm, sm, 11.52, 266)
    again, _ = radius_search(q, s, qm, sm, 11.52, 266)
    want = radius_search_plain(q, s, qm, sm, 11.52, 266)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    assert float(ovf.sum()) == 0.0
    assert int((got < s.shape[1]).sum(dim=-1)[qm].max()) == 266


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_radius_search_warp_path_cuts_its_buffer(dev, case):
    """The warp path's CPU cases on the card. Where the emulation runs the
    kernel's own capacity and is cut, some query has more hits than the
    kernel's buffer (dense clusters at K 300 and 768, one column at K 17),
    so the kernel cuts it to K too; equal to the plain version and the
    same on a second call."""
    make, radius, k, capacity, cut = WARP_CASES[case]
    cpu = as_tensors(*make(np.random.default_rng(7), radius))
    if capacity == 0:
        _, cuts = radius_search_warp_reference(*cpu, radius, k)
        assert bool(cuts.any()) == cut
    q, s, qm, sm = (t.to(dev) for t in cpu)
    got, ovf = radius_search(q, s, qm, sm, radius, k)
    again, _ = radius_search(q, s, qm, sm, radius, k)
    want = radius_search_plain(q, s, qm, sm, radius, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(again, got)
    assert float(ovf.sum()) == 0.0


@pytest.mark.parametrize("case", list(CELL_CASES))
def test_radius_search_kernel_on_adversarial_sets(dev, case):
    make, radius, k = CELL_CASES[case]
    q, s, qm, sm = (t.to(dev) for t in as_tensors(
        *make(np.random.default_rng(7), radius)))
    got, ovf = radius_search(q, s, qm, sm, radius, k)
    again, _ = radius_search(q, s, qm, sm, radius, k)
    want = radius_search_plain(q, s, qm, sm, radius, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(again, got)
    assert float(ovf.sum()) == 0.0


def _level0_batch(dev, seed, b=3, n=16352):
    """Spheres of the main path's level-0 size: a disc of radius 18 m at
    about 16 points per m^2, 2.5-D (z up to 3 m, more under a few
    "trees"), ordered by a 0.24 m voxel key as the pyramid delivers them."""
    rng = np.random.default_rng(seed)
    r = 18 * np.sqrt(rng.random((b, n)))
    a = rng.uniform(0, 2 * np.pi, (b, n))
    z = rng.uniform(0, 0.3, (b, n))
    z[:, : n // 10] += rng.uniform(0, 12, (b, n // 10))
    pts = np.stack([r * np.cos(a), r * np.sin(a), z], -1).astype(np.float32)
    key = np.floor(pts / 0.24).astype(np.int64) + 200
    order = np.argsort(key[..., 0] * 10**6 + key[..., 1] * 10**3
                       + key[..., 2], axis=1, kind="stable")
    pts = np.take_along_axis(pts, order[..., None], 1)
    mask = rng.random((b, n)) > 0.05
    return (torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev))


def test_radius_search_kernel_level0_size_deterministic(dev):
    """conv0's search at the main path's size (3 x 16352 points, r 0.6 m,
    K 15): equal to the plain version, and the same on a second call
    although the binning scatters in another order each time."""
    s, sm = _level0_batch(dev, 5)
    got = radius_search(s, s, sm, sm, 0.6, 15)[0]
    again = radius_search(s, s, sm, sm, 0.6, 15)[0]
    want = radius_search_plain(s, s, sm, sm, 0.6, 15)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(again, got)


@pytest.mark.parametrize("influence", ["linear", "constant", "gaussian"])
def test_kpconv_kernel_matches_plain(dev, influence):
    g = torch.Generator(device=dev).manual_seed(1)
    b, nq, ns, k, kp, cin, cout = 2, 300, 500, 20, 15, 24, 40
    s = torch.rand((b, ns, 3), generator=g, device=dev) * 4 - 2
    q = (s[:, :nq] + 0.05).contiguous()
    nb = torch.randint(0, ns + 1, (b, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    x = torch.randn((b, ns, cin), generator=g, device=dev)
    kpts = torch.rand((kp, 3), generator=g, device=dev) - 0.5
    w = torch.randn((kp, cin, cout), generator=g, device=dev)
    got, oob = kpconv_fwd(q, s, nb, x, kpts, w, 0.8, influence)
    want = kpconv_fwd_plain(q, s, nb, x, kpts, w, 0.8, influence)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    assert float(oob.sum()) == 0.0


# 0.24, 0.48 and 0.96: the WL model's extents, where the f32 reciprocal of
# f32 ext differs from PyTorch's (1 / ext in double, rounded to f32)
@pytest.mark.parametrize("ext", [0.8, 0.288, 0.576, 0.24, 0.48, 0.96])
@pytest.mark.parametrize("influence", ["linear", "gaussian"])
def test_kpconv_influences_equal_plain_bit_for_bit(dev, influence, ext):
    # One neighbor and x = 1: the aggregate y of either version is the
    # influence itself, with no sum to round
    g = torch.Generator(device=dev).manual_seed(2)
    b, nq, ns, kp = 2, 2000, 2000, 15
    s = torch.rand((b, ns, 3), generator=g, device=dev) * 2 * ext - ext
    q = torch.rand((b, nq, 3), generator=g, device=dev) * 2 * ext - ext
    nb = torch.randint(0, ns, (b, nq, 1), generator=g, device=dev,
                       dtype=torch.int32)
    x = torch.ones((b, ns, 1), device=dev)
    kpts = (torch.rand((kp, 3), generator=g, device=dev) - 0.5) * ext
    w = torch.randn((kp, 1, 8), generator=g, device=dev)
    y = fwd_lib.kpconv_fwd_with_y(q, s, nb, x, kpts, w, ext, influence)[1]
    want = fwd_lib.kpconv_fwd_plain_with_y(q, s, nb, x, kpts, w, ext,
                                           influence)[1]
    torch.cuda.synchronize()
    assert float((want > 0).double().mean()) > 0.1
    assert torch.equal(y, want)


def test_kpconv_kernel_rejects_other_dtypes(dev):
    q = torch.zeros(1, 4, 3, device=dev)
    nb = torch.zeros(1, 4, 2, dtype=torch.int32, device=dev)
    x = torch.zeros(1, 4, 5, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        kpconv_fwd(q, q, nb, x, torch.zeros(15, 3, device=dev),
                   torch.zeros(15, 5, 6, device=dev), 1.0)


def _conv_problem(dev, seed, b=2, nq=300, ns=500, k=20, kp=15, cin=24,
                  cout=40):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.rand((b, ns, 3), generator=g, device=dev) * 4 - 2
    q = (s[:, :nq] + 0.05).contiguous()
    nb = torch.randint(0, ns + 1, (b, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    nb[:, -5:] = ns                                # all-shadow rows
    x = torch.randn((b, ns, cin), generator=g, device=dev)
    kpts = torch.rand((kp, 3), generator=g, device=dev) - 0.5
    w = torch.randn((kp, cin, cout), generator=g, device=dev)
    grad = torch.randn((b, nq, cout), generator=g, device=dev)
    return q, s, nb, x, kpts, w, grad


def _close(got, want, rtol, atol_rel):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol_rel * float(want.abs().max()))


@pytest.mark.parametrize("influence", ["linear", "constant", "gaussian"])
def test_kpconv_bwd_kernel_matches_plain(dev, influence):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 2)
    out, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, influence)
    _, y_plain = kpconv_fwd_plain_with_y(q, s, nb, x, kpts, w, 0.8,
                                         influence)
    _close(y, y_plain, 1e-4, 1e-5)
    dx, dw = kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8, influence,
                        inverse=LazyInverse(nb, s.shape[1]))
    dx_p, dw_p = kpconv_bwd_plain(q, s, nb, y, kpts, w, grad, 0.8,
                                  influence)
    torch.cuda.synchronize()
    _close(dx, dx_p, 1e-4, 1e-5)
    _close(dw, dw_p, 1e-4, 1e-5)
    none, dw2 = kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8, influence,
                           need_dx=False)
    assert none is None
    _close(dw2, dw_p, 1e-4, 1e-5)


# (K, C): the main path's two pools, an odd width (scalar loads, two
# channel chunks), K past the 32-slot mask and past the 64-slot one
# (the slots beyond it gathered again)
@pytest.mark.parametrize("k,c", [(14, 64), (29, 128), (14, 80), (40, 128),
                                 (70, 7), (31, 256)])
def test_maxpool_bwd_kernel_matches_plain(dev, k, c):
    g = torch.Generator(device=dev).manual_seed(3)
    b, nq, ns = 2, 400, 600
    # integer values: exact ties; column 0 is never positive, so its
    # maximum is often the 0 that real rows share with shadow slots
    x = torch.randint(-3, 3, (b, ns, c), generator=g, device=dev).float()
    x[:, :, 0] = x[:, :, 0].clamp(max=0)
    nb = torch.randint(0, ns + 1, (b, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    nb[torch.rand(nb.shape, generator=g, device=dev) < 0.2] = ns
    grad = torch.randn((b, nq, c), generator=g, device=dev)
    got = maxpool_bwd(x, nb, grad, inverse=LazyInverse(nb, ns))
    want = maxpool_bwd_plain(x, nb, grad)
    torch.cuda.synchronize()
    _close(got, want, 1e-6, 1e-6)


def _bits_repeat(fn, calls=3):
    """fn()'s outputs over `calls` calls, each equal bit for bit to the
    first; returns the first."""
    first = [t.clone() for t in fn() if t is not None]
    for _ in range(calls - 1):
        again = [t for t in fn() if t is not None]
        torch.cuda.synchronize()
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(first, again))
    return first


# C at small shapes and at the main path's level-0 conv (K 15, Cin 64,
# 3 spheres of 16352 rows), D at the main path's two pools
@pytest.mark.parametrize("case", [
    dict(), dict(b=3, nq=16352, ns=16352, k=15, cin=64, cout=64)])
def test_kpconv_bwd_repeats_bit_for_bit(dev, case):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 12, **case)
    _, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, "linear")
    inv = LazyInverse(nb, s.shape[1])
    dx, dw = _bits_repeat(lambda: kpconv_bwd(q, s, nb, y, kpts, w, grad,
                                             0.8, "linear", inverse=inv))
    dx_p, dw_p = kpconv_bwd_plain(q, s, nb, y, kpts, w, grad, 0.8, "linear")
    _close(dx, dx_p, 1e-4, 1e-5)
    _close(dw, dw_p, 1e-4, 1e-5)


@pytest.mark.parametrize("k,c,nq,ns", [(14, 64, 11432, 16352),
                                       (29, 128, 5712, 11432)])
def test_maxpool_bwd_repeats_bit_for_bit(dev, k, c, nq, ns):
    g = torch.Generator(device=dev).manual_seed(13)
    x = torch.randint(-3, 3, (3, ns, c), generator=g, device=dev).float()
    nb = torch.randint(0, ns + 1, (3, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    grad = torch.randn((3, nq, c), generator=g, device=dev)
    inv = LazyInverse(nb, ns)
    (got,) = _bits_repeat(lambda: (maxpool_bwd(x, nb, grad, inverse=inv),))
    _close(got, maxpool_bwd_plain(x, nb, grad), 1e-6, 1e-6)


def test_inverse_lists_captured_equal_eager(dev):
    """The build reads nothing back to the host, so a CUDA graph captures
    it; its lists equal the eager build's and the plain stable sort's,
    and the row sums over them equal index_add_ to f32 rounding."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import (inverse_sum,
                                                         inverse_sum_plain)
    g = torch.Generator(device=dev).manual_seed(14)
    b, nq, ns, ld = 3, 2000, 1500, 12
    nb = torch.randint(0, ns + 1, (b, nq, ld), generator=g, device=dev,
                       dtype=torch.int32)
    eager = build_inverse_lists(nb, ns)
    plain = build_inverse_lists_plain(nb, ns)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        build_inverse_lists(nb, ns)              # warm-up: load the library
    torch.cuda.current_stream(dev).wait_stream(side)
    with torch.cuda.graph(graph):
        captured = build_inverse_lists(nb, ns)
    graph.replay()
    torch.cuda.synchronize()
    total = int(plain.offsets[-1])
    for lists in (eager, captured):
        assert torch.equal(lists.offsets, plain.offsets)
        assert torch.equal(lists.entries[:total], plain.entries[:total])
    src = torch.randn((b * nq * ld, 40), generator=g, device=dev)
    got = inverse_sum(src, eager, b * ns)
    _close(got, inverse_sum_plain(src, plain, b * ns), 1e-6, 1e-6)
    # one column of an upsample edge (k = 1 of ld)
    one = build_inverse_lists(nb, ns, k=1)
    ref = build_inverse_lists_plain(nb, ns, k=1)
    assert torch.equal(one.offsets, ref.offsets)
    assert torch.equal(one.entries[:int(ref.offsets[-1])],
                       ref.entries[:int(ref.offsets[-1])])


@pytest.mark.parametrize("case", list(INVERSE_CASES))
def test_inverse_lists_build_on_adversarial_indices(dev, case):
    """The build equals the plain stable sort on the cases that stress its
    phases (tests/_inverse_cases.py: a support of thousands of slots,
    skew, duplicates, rows of shadows, no slots, no supports, k = 1 of a
    wider ld), eager, again, and replayed from a CUDA graph."""
    nb, ns, k = index_case(case)
    nb = nb.to(dev)
    k = nb.shape[2] if k is None else k
    want = build_inverse_lists_plain(nb, ns, k)
    total = int(want.offsets[-1])
    for got in (build_inverse_lists(nb, ns, k),
                build_inverse_lists(nb, ns, k),
                graph_replay(lambda: build_inverse_lists(nb, ns, k))):
        torch.cuda.synchronize()
        assert torch.equal(got[0], want.offsets)
        assert torch.equal(got[1][:total], want.entries[:total])


@pytest.mark.parametrize("c_dim", [1, 3, 9, 64, 128, 512])
def test_row_sums_equal_sums_in_list_order(dev, c_dim):
    """`inverse_sum` (over skewed lists with a support of thousands of
    slots) and `run_sums` (voxel runs, one of 400 rows, rows dropped
    past n_out, a sphere with none) equal the sums added rank by rank in
    list order, bit for bit, and repeat."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import inverse_sum, run_sums
    g = torch.Generator(device=dev).manual_seed(c_dim)
    for case in ("hot", "skewed"):
        nb, ns, _ = index_case(case)
        nb = nb.to(dev)
        inv = build_inverse_lists(nb, ns)
        rows = nb.shape[0] * ns
        src = torch.randn((nb.numel(), c_dim), generator=g, device=dev)
        (got,) = _bits_repeat(lambda: (inverse_sum(src, inv, rows),))
        assert torch.equal(got, ordered_row_sums(src, inv.offsets,
                                                 inv.entries, rows))
    seg, n_out = run_case()
    seg = seg.to(dev)
    src = torch.randn((*seg.shape, c_dim), generator=g, device=dev)
    sums, counts = _bits_repeat(lambda: run_sums(src, seg, n_out))
    want_sums, want_counts = ordered_run_sums(src, seg, n_out)
    assert torch.equal(sums, want_sums)
    assert torch.equal(counts, want_counts)


# C's and D's stage 2 at their widths on the main path: the convs' K with
# their Cin, the pools' K with their C
@pytest.mark.parametrize("k,c_dim", [(15, 64), (31, 128), (34, 256),
                                     (34, 512), (14, 64), (29, 128)])
def test_inverse_sum_on_stage2_workspaces(dev, k, c_dim):
    """The row sums over a conv or pool edge's lists of a workspace [rows
    * K, C], as C's and D's dX take their stage 2, equal the sums in list
    order bit for bit."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import inverse_sum
    g = torch.Generator(device=dev).manual_seed(k * c_dim)
    b, nq, ns = 3, 700, 900
    nb = torch.randint(0, ns + 1, (b, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    inv = build_inverse_lists(nb, ns)
    ws = torch.randn((b * nq * k, c_dim), generator=g, device=dev)
    got = inverse_sum(ws, inv, b * ns)
    assert torch.equal(got, ordered_row_sums(ws, inv.offsets, inv.entries,
                                             b * ns))


def test_deterministic_algorithms_training_step(dev):
    """One eager kernel training step at full width runs under
    `torch.use_deterministic_algorithms(True)` (which raises at any
    PyTorch op known to be non-deterministic on CUDA), in a process of
    its own with CUBLAS_WORKSPACE_CONFIG=:4096:8."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run(
        [sys.executable, "-m", "weasal_tpu_torch.tools.deterministic_step"],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "deterministic step: loss" in out.stdout


def test_autograd_functions_launch_kernels_c_and_d(dev):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 4)
    x.requires_grad_()
    w.requires_grad_()
    gen = torch.Generator(device=dev).manual_seed(5)
    pools = torch.randint(0, q.shape[1] + 1, (q.shape[0], 200, 9),
                          generator=gen, device=dev, dtype=torch.int32)
    c0, d0 = kpconv_bwd.launches, maxpool_bwd.launches
    out = ops.kpconv(q, s, nb, x, kpts, w, ops.KPConvParams(0.8),
                     LazyInverse(nb, s.shape[1]))
    assert out.grad_fn is not None
    pooled = ops.max_pool(out, pools, LazyInverse(pools, q.shape[1]))
    assert pooled.grad_fn is not None
    loss = (pooled * grad[:, :200]).sum()
    dx, dw = torch.autograd.grad(loss, (x, w))
    assert dx is not None and dw is not None
    assert float(dx.abs().max()) > 0 and float(dw.abs().max()) > 0
    assert kpconv_bwd.launches == c0 + 1
    assert maxpool_bwd.launches == d0 + 1
    xp = x.detach().clone().requires_grad_()
    wp = w.detach().clone().requires_grad_()
    with plain_ops():
        outp = ops.kpconv(q, s, nb, xp, kpts, wp, ops.KPConvParams(0.8))
        lossp = (ops.max_pool(outp, pools) * grad[:, :200]).sum()
    dxp, dwp = torch.autograd.grad(lossp, (xp, wp))
    assert kpconv_bwd.launches == c0 + 1
    assert maxpool_bwd.launches == d0 + 1
    _close(dw, dwp, 1e-3, 1e-5)
    _close(dx, dxp, 1e-3, 1e-5)


def test_card_backward_without_inverse_lists_raises(dev):
    """A dX on the card sums over inverse lists that its caller passes;
    without them the wrappers raise rather than build their own."""
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 4)
    _, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, "linear")
    with pytest.raises(ValueError, match="inverse lists"):
        kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8, "linear")
    with pytest.raises(ValueError, match="inverse lists"):
        maxpool_bwd(x, nb, grad[..., :x.shape[2]].contiguous())


# Shapes that reach every edge of the GEMM core (csrc/kpconv_common.cuh):
# rows B*Nq not a multiple of its 128-row tile, Kp*Cin = 60 (not a
# multiple of its 32-deep stage) and 360, Cout 32 and 40 (narrower than
# the 128-wide tile) and 256, Cin 512 (depth 7680), an odd Cin and Cout
# (4-byte copies instead of 16-byte ones), and the main path's widest
# conv (multi_att.simple1: 3 spheres of 5712 rows, K = 34, 512 -> 256);
# DALES's first conv (Cin 3: depth 45) and its weak-label model's widest
# (multi_att.simple1 at 128 features: 1024 -> 512, depth 15360, on 2
# spheres of the deepest level's few hundred rows).
GEMM_CASES = {
    "kpcin60-cout32": dict(b=2, nq=300, ns=500, k=20, cin=4, cout=32),
    "kpcin360-cout40": dict(b=2, nq=300, ns=500, k=20, cin=24, cout=40),
    "kpcin360-cout256": dict(b=3, nq=421, ns=600, k=20, cin=24, cout=256),
    "cin512-cout256": dict(b=2, nq=333, ns=400, k=16, cin=512, cout=256),
    "odd-strides": dict(b=2, nq=129, ns=200, k=9, cin=5, cout=7),
    "widest": dict(b=3, nq=5712, ns=5712, k=34, cin=512, cout=256),
    "dales-first": dict(b=2, nq=6000, ns=6000, k=28, cin=3, cout=64),
    "dales-widest": dict(b=2, nq=640, ns=640, k=36, cin=1024, cout=512),
}


def _f64(*tensors):
    return [t.double() for t in tensors]


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_kpconv_fwd_gemm_core_matches_f64(dev, case):
    q, s, nb, x, kpts, w, _ = _conv_problem(dev, 6, **GEMM_CASES[case])
    out, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, "linear")
    _, y64 = kpconv_fwd_plain_with_y(*_f64(q, s), nb, *_f64(x, kpts, w),
                                     0.8, "linear")
    kp, cin, cout = w.shape
    want = (y.double() @ w.double().reshape(kp * cin, cout)).reshape(
        out.shape)
    torch.cuda.synchronize()
    _close(y.double(), y64, 1e-4, 1e-5)
    _close(out.double(), want, 1e-4, 1e-5)


@pytest.mark.parametrize("need_dx", [True, False])
@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_kpconv_bwd_gemm_core_matches_f64(dev, case, need_dx):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 7, **GEMM_CASES[case])
    _, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, "linear")
    dx, dw = kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8, "linear",
                        need_dx=need_dx, inverse=LazyInverse(nb, s.shape[1]))
    kp, cin, cout = w.shape
    want_dw = (y.double().t() @ grad.double().reshape(-1, cout)).reshape(
        kp, cin, cout)
    torch.cuda.synchronize()
    _close(dw.double(), want_dw, 1e-4, 1e-5)
    if not need_dx:
        assert dx is None
        return
    want_dx, _ = kpconv_bwd_plain(*_f64(q, s), nb, *_f64(y, kpts, w, grad),
                                  0.8, "linear")
    _close(dx.double(), want_dx, 1e-4, 1e-5)


def test_gemm_core_sums_do_not_drift(dev):
    """The tensor cores truncate as they accumulate; the core keeps one
    big product a chain and adds each chain's result, untruncated, in f32
    round-to-nearest, so on positive operands (where truncation always
    errs one way) y @ W and y^T @ g at the widest conv keep a mean
    relative error to f64 below 3e-8 (a stage's twelve wgmmas in one
    chain drifted by -2.2e-7)."""
    _assert_no_drift(dev, "widest")


def test_gemm_core_sums_do_not_drift_at_dales_depth(dev):
    """As above at DALES's widest conv, whose depth (15360) is twice the
    Vaihingen3D model's."""
    _assert_no_drift(dev, "dales-widest")


def _assert_no_drift(dev, case):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 8, **GEMM_CASES[case])
    x, w, grad = x.abs(), w.abs(), grad.abs()
    out, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 1.5, "linear")
    _, dw = kpconv_bwd(q, s, nb, y, kpts, w, grad, 1.5, "linear",
                       need_dx=False)
    kp, cin, cout = w.shape
    for got, want in (
            (out.reshape(-1, cout),
             y.double() @ w.double().reshape(kp * cin, cout)),
            (dw.reshape(-1, cout),
             y.double().t() @ grad.double().reshape(-1, cout))):
        big = want.abs() > 0.1 * want.abs().max()
        rel = ((got.double() - want) / want)[big]
        assert abs(float(rel.mean())) < 3e-8


GUARD = 4096           # floats of sentinel on either side of a buffer
SENTINEL = -7.25
INVALID_VALUE = 1      # cudaErrorInvalidValue


def _guarded(shape, dev, dtype=torch.float32):
    """(buffer, view of `shape`) with GUARD sentinel floats on either side
    of the view; the view reinterprets the floats as `dtype` (4 bytes)."""
    n = math.prod(shape)
    buf = torch.full((n + 2 * GUARD,), SENTINEL, device=dev)
    return buf, buf[GUARD:GUARD + n].view(dtype).view(shape)


def _guards_hold(buffers):
    torch.cuda.synchronize()
    return [name for name, (buf, _) in buffers.items()
            if not bool((buf[:GUARD] == SENTINEL).all()
                        and (buf[-GUARD:] == SENTINEL).all())]


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_kpconv_launches_write_only_their_buffers(dev, case):
    """Kernels B and C write nothing outside y, out, dr, C's dX
    workspace, dX, dW and the split-K workspace (each between guard
    bands), and refuse a workspace one float shorter than the schedule
    needs."""
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 9, **GEMM_CASES[case])
    b, nq, _ = q.shape
    ns, k = s.shape[1], nb.shape[2]
    kp, cin, cout = w.shape
    rows, kdim = b * nq, kp * cin
    inv_ext, inv_den = fwd_lib.reciprocals(0.8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    head = [t.data_ptr() for t in (q, s, nb)]
    scalars = [b, nq, ns, k, kp, cin, cout, inv_ext, 1, inv_den]

    lib = load_library("kpconv_fwd")
    n_ws = fwd_lib.workspace_floats(lib, "kpconv_fwd", rows, kdim, cout)
    fwd = {name: _guarded(shape, dev) for name, shape in (
        ("y", (rows, kdim)), ("out", (b, nq, cout)), ("ws", (max(n_ws, 1),)))}
    fn = lib.kpconv_fwd_launch
    fn.argtypes, fn.restype = fwd_lib._ARGTYPES, ctypes.c_int

    def launch_fwd(ws_floats):
        return fn(*head, x.data_ptr(), kpts.data_ptr(), w.data_ptr(), *scalars,
                  fwd["y"][1].data_ptr(), fwd["out"][1].data_ptr(),
                  fwd["ws"][1].data_ptr(), ws_floats, stream)

    if n_ws:
        assert launch_fwd(n_ws - 1) == INVALID_VALUE
    assert launch_fwd(n_ws) == 0
    assert _guards_hold(fwd) == []
    y = fwd["y"][1]
    want = y.double() @ w.double().reshape(kdim, cout)
    _close(fwd["out"][1].reshape(rows, cout).double(), want, 1e-4, 1e-5)

    lib = load_library("kpconv_bwd")
    n_ws = fwd_lib.workspace_floats(lib, "kpconv_bwd", rows, kdim, cout, 1)
    bwd = {name: _guarded(shape, dev) for name, shape in (
        ("dr", (rows, kdim)), ("xws", (rows * k, cin)), ("dx", (b, ns, cin)),
        ("dw", (kp, cin, cout)), ("ws", (max(n_ws, 1),)))}
    inv = build_inverse_lists(nb, ns)
    fn = lib.kpconv_bwd_launch
    fn.argtypes, fn.restype = bwd_lib._ARGTYPES, ctypes.c_int

    def launch_bwd(ws_floats):
        outs = [bwd[n][1].data_ptr() for n in ("dr", "xws", "dx", "dw",
                                                "ws")]
        return fn(*head, y.data_ptr(), kpts.data_ptr(), w.data_ptr(),
                  grad.data_ptr(), *scalars, 1, inv.offsets.data_ptr(),
                  inv.entries.data_ptr(), *outs, ws_floats, stream)

    if n_ws:
        assert launch_bwd(n_ws - 1) == INVALID_VALUE
    assert launch_bwd(n_ws) == 0
    assert _guards_hold(bwd) == []
    want_dw = y.double().t() @ grad.double().reshape(rows, cout)
    _close(bwd["dw"][1].reshape(kdim, cout).double(), want_dw, 1e-4, 1e-5)


@pytest.mark.parametrize("k", [15, 34, 100])
def test_radius_search_launch_writes_only_its_buffers(dev, k):
    """Kernel A writes nothing outside its output and its scratch (the
    column-ordered supports, grid parameters and column starts), and
    refuses a scratch one word shorter than it needs or not 16-byte
    aligned."""
    s, sm = _level0_batch(dev, 6, b=2, n=3000)
    q, qm = s[:, ::2].contiguous(), sm[:, ::2].contiguous()
    b, nq, ns = q.shape[0], q.shape[1], s.shape[1]
    lib = radius_lib.declare(load_library("radius_search"))
    words = radius_lib.scratch_words(b, ns)
    bufs = {"out": _guarded((b, nq, k), dev, torch.int32),
            "scratch": _guarded((words + 1,), dev, torch.int32)}
    fn = lib.radius_search_launch
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(scratch_ptr, n_words):
        return fn(q.data_ptr(), s.data_ptr(), qm.data_ptr(), sm.data_ptr(),
                  b, nq, ns, k, radius_lib._r2(1.2),
                  bufs["out"][1].data_ptr(), scratch_ptr, n_words, stream)

    scratch = bufs["scratch"][1]
    assert launch(scratch.data_ptr(), words - 1) == INVALID_VALUE
    assert launch(scratch.data_ptr() + 4, words) == INVALID_VALUE
    assert _guards_hold(bufs) == []
    assert bool((bufs["out"][0][GUARD:-GUARD] == SENTINEL).all())
    bufs["scratch"] = _guarded((words,), dev, torch.int32)
    assert launch(bufs["scratch"][1].data_ptr(), words) == 0
    assert _guards_hold(bufs) == []
    want = radius_search_plain(q, s, qm, sm, 1.2, k)
    assert torch.equal(bufs["out"][1], want)


# ------------------------------------------------ the training loop's input

@pytest.fixture(scope="module")
def synth_wl(tmp_path_factory):
    """A small synthetic Vaihingen root, its training and validation
    datasets (in_radius 8 m, dl 0.4 m, 16 features) and their plan."""
    from weasal_tpu_torch.config import VaihingenWLConfig
    from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root

    class Small(VaihingenWLConfig):
        in_radius = 8.0
        sub_radius = 3.0
        first_subsampling_dl = 0.4
        first_features_dim = 16
        batch_num = 2
        max_epoch = 1
        epoch_steps = 2
        validation_size = 1
        initial_labels_per_file = 30
        saving = False

    root = make_vaihingen_like_root(
        str(tmp_path_factory.mktemp("card_loop") / "Vaihingen3D"),
        extent=30.0, density=5.0, seed=11)
    cfg = Small()
    train = Vaihingen3DWLDataset(cfg, split="training", data_root=root,
                                 rng=np.random.default_rng(0))
    val = Vaihingen3DWLDataset(cfg, split="validation", data_root=root,
                               rng=np.random.default_rng(1))
    return cfg, train, val, train.calibration(num_samples=8)


def _input_order(out, key):
    a, unsort = out[key].cpu(), out["unsort"].cpu()
    return torch.gather(a, 1, unsort.reshape(
        *unsort.shape, *([1] * (a.dim() - 2))).expand_as(a))


def test_resident_assembly_on_card_equals_cpu(dev, synth_wl):
    from weasal_tpu_torch.data import resident as res
    cfg, train, _, plan = synth_wl
    spec = res.feature_spec(train.name, cfg.in_features_dim)
    small, _ = res.ResidentBatchSource(train, plan, "cpu").next_batch(
        np.random.default_rng(3), augment=True)
    outs = {}
    for where in ("cpu", dev):
        clouds = res.ResidentClouds(train, where)
        batch = {k: torch.from_numpy(v.astype(np.int64) if k == "noise_seed"
                                     else v).to(where)
                 for k, v in small.items()}
        outs[str(where)] = res.assemble_level0_device(
            {**batch, **clouds.arrays}, cfg, plan, True, spec)
    cpu, card = outs["cpu"], outs[str(dev)]
    assert torch.equal(card["mask0"].cpu(), cpu["mask0"])
    assert torch.equal(_input_order(card, "labels"),
                       _input_order(cpu, "labels"))
    for key in ("points0", "features"):
        torch.testing.assert_close(_input_order(card, key),
                                   _input_order(cpu, key), rtol=0,
                                   atol=1e-5)


def test_vote_accumulator_on_card_equals_cpu(dev, synth_wl):
    from weasal_tpu_torch.data import resident as res
    from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
    cfg, _, val, plan = synth_wl
    accs, clouds = {}, {}
    for where in ("cpu", dev):
        clouds[str(where)] = res.ResidentClouds(val, where)
        accs[str(where)] = DeviceVoteAccumulator(
            clouds[str(where)], cfg.num_classes, radius_sq=(0.7 * 8.0) ** 2)
    src = res.ResidentBatchSource(val, plan, "cpu")
    rng = np.random.default_rng(9)
    for it in range(3):
        small, metas = src.next_batch(rng, augment=False)
        small["flat_inds"][1] = small["flat_inds"][0]      # overlapping
        probs = torch.rand((len(metas), plan.num_points[0], cfg.num_classes),
                           generator=torch.Generator().manual_seed(it))
        for where, acc in accs.items():
            acc.update(probs.to(where), {
                "flat_inds": torch.from_numpy(small["flat_inds"]).to(where),
                "center_pts": torch.from_numpy(small["center_pts"]).to(where),
                **clouds[where].arrays})
    for got, want in zip(accs[str(dev)].materialize(),
                         accs["cpu"].materialize()):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_two_step_loop_launches_the_kernels(dev, synth_wl):
    from weasal_tpu_torch.models.blocks import kpconv_modules
    from weasal_tpu_torch.train.trainer import ModelTrainer
    cfg, train, val, plan = synth_wl
    trainer = ModelTrainer(cfg, train, device=dev)
    assert trainer.resident and trainer.graphed
    counted = (radius_search, kpconv_fwd, kpconv_bwd, maxpool_bwd)
    for fn in counted:
        fn.launches = 0
    trainer.train(train, val)
    torch.cuda.synchronize()
    steps = trainer.epoch_times[0]["steps"]
    batches = trainer.val_times[0]["batches"]
    assert steps >= 1 and batches == 1
    n_conv = len(kpconv_modules(trainer.model))
    assert n_conv == 12
    counts = trainer.graph_counts()
    # every step and batch replayed; each capture's warm-up ran once
    assert counts["train_replayed_steps"] == steps
    assert counts["eval_replays"] == batches
    steps += counts["train_warmups"]
    batches += counts["eval_warmups"]
    want = {"radius_search": 7 * (steps + batches),
            "kpconv_fwd": n_conv * (steps + batches),
            "kpconv_bwd": n_conv * steps, "maxpool_bwd": 2 * steps}
    assert {fn.__name__: fn.launches for fn in counted} == want
    assert all(np.isfinite(v).all() for v in trainer.validation_probs)


# ------------------------------------------------- captured steps (graphs)

def _card_setup(dev, synth_wl, seed=3):
    """A model and momentum on the card, one resident batch of the small
    config (tensors on the card) and its pyramid on the plain versions."""
    from weasal_tpu_torch import KPFCNN_mprm, init_opt_state
    from weasal_tpu_torch.data import resident as res
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    cfg, train, _, plan = synth_wl
    spec = res.feature_spec(train.name, cfg.in_features_dim)
    src = res.ResidentBatchSource(train, plan, dev)
    small, _ = src.next_batch(np.random.default_rng(seed), augment=True)
    batch = {k: torch.from_numpy(v.astype(np.int64) if k == "noise_seed"
                                 else v).to(dev) for k, v in small.items()}
    batch.update(src.resident.arrays)
    with torch.no_grad():
        t = res.assemble_level0_device(batch, cfg, plan, True, spec)
        with plain_ops():
            pyr = batch_from_device_pyramid(
                t["points0"], t["mask0"], t["features"], t["labels"], cfg,
                plan, t["center_pts"], rotations=t["rotations"],
                cloud_lb=t["cloud_lb"], region_inds=t["region_inds"],
                region_masks=t["region_masks"],
                region_point_masks=t["region_point_masks"],
                region_lb=t["region_lb"])
    model = KPFCNN_mprm(cfg, tuple(int(v) for v in train.label_values), (),
                        generator=torch.Generator().manual_seed(seed)).to(dev)
    return cfg, plan, spec, model, init_opt_state(model), batch, pyr


def _pyramid_step_graph(model, opt, pyr, cfg, plan, lr, dev, graphed):
    """A StepGraph whose step is `step_on_batch` on a fixed pyramid (its
    static input is a placeholder)."""
    from weasal_tpu_torch.train.graphs import StepGraph
    from weasal_tpu_torch.train.step import (class_weights, label_table,
                                             step_on_batch, step_outputs)
    # made before the capture: a host-to-device copy cannot be captured
    class_w, table = class_weights(cfg, dev), label_table(model, dev)

    def body(inputs, out):
        loss, acc = step_on_batch(model, opt, pyr, cfg, lr, class_w=class_w,
                                  table=table)
        out["stats"][0].copy_(loss)
        out["stats"][1].copy_(acc)

    example = {"placeholder": torch.zeros((1, 1))}
    graph = StepGraph("test step", body, example, 1, dev,
                      step_outputs(plan, dev, steps=1),
                      lambda: (list(model.parameters())
                               + list(model.buffers())
                               + list(opt.values())), graphed=graphed)
    graph.load(example)
    return graph


def test_replayed_step_equals_eager_and_f64(dev, synth_wl):
    import copy
    import dataclasses
    from weasal_tpu_torch.train.step import step_on_batch
    cfg, plan, _, model, opt, _, pyr = _card_setup(dev, synth_wl)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt0 = {k: v.clone() for k, v in opt.items()}
    lr_t = torch.full((), cfg.learning_rate, device=dev)
    runs = {}
    for label in ("eager", "graph"):
        model.load_state_dict(state0)
        for k in opt:
            opt[k].copy_(opt0[k])
        graph = _pyramid_step_graph(model, opt, pyr, cfg, plan, lr_t, dev,
                                    graphed=label == "graph")
        graph.run()
        torch.cuda.synchronize()
        assert (graph.graph is not None) == (label == "graph")
        runs[label] = (float(graph.out["stats"][0, 0]),
                       {n: p.grad.double().clone()
                        for n, p in model.named_parameters()},
                       {k: v.double() - state0[k].double()
                        for k, v in model.state_dict().items()
                        if v.is_floating_point()})
    model64 = copy.deepcopy(model).double()
    model64.load_state_dict({k: v.double() if v.is_floating_point() else v
                             for k, v in state0.items()})
    pyr64 = dataclasses.replace(
        pyr, points=tuple(p.double() for p in pyr.points),
        features=pyr.features.double(), center_pts=pyr.center_pts.double(),
        cloud_lb=pyr.cloud_lb.double(), region_lb=pyr.region_lb.double())
    opt64 = {k: v.double() for k, v in opt0.items()}
    with plain_ops():
        step_on_batch(model64, opt64, pyr64, cfg, cfg.learning_rate)
    truth = ({n: p.grad.clone() for n, p in model64.named_parameters()},
             {k: v - state0[k].double()
              for k, v in model64.state_dict().items()
              if v.is_floating_point()})
    assert runs["graph"][0] == pytest.approx(runs["eager"][0], rel=1e-6)
    for part in (1, 2):
        for name, ref in truth[part - 1].items():
            norm = float(ref.norm())
            err_g = float((runs["graph"][part][name] - ref).norm())
            err_e = float((runs["eager"][part][name] - ref).norm())
            assert err_g <= 4.0 * err_e + 1e-3 * norm, (part, name, err_g,
                                                        err_e, norm)


def test_replay_after_lr_fill_applies_the_new_rate(dev, synth_wl):
    cfg, plan, _, model, opt, _, pyr = _card_setup(dev, synth_wl, seed=5)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    lr_t = torch.full((), cfg.learning_rate, device=dev)
    graph = _pyramid_step_graph(model, opt, pyr, cfg, plan, lr_t, dev,
                                graphed=True)
    moved = []
    for rate in (cfg.learning_rate, cfg.learning_rate / 4):
        model.load_state_dict(state0)
        for v in opt.values():
            v.zero_()
        lr_t.fill_(rate)
        graph.run()
        torch.cuda.synchronize()
        moved.append(torch.cat([(p.detach() - state0[n]).reshape(-1)
                                for n, p in model.named_parameters()]))
    assert graph.replays == 2 and graph.warmup_steps == 1
    # From zero momentum a step moves every parameter by -lr * (its
    # clipped, decayed gradient): a quarter of the rate, a quarter of the
    # move (up to the atomics' rounding in the gradients)
    ratio = float(moved[1].norm() / moved[0].norm())
    assert ratio == pytest.approx(0.25, rel=1e-3)


def test_eval_graph_equals_eval_batch(dev, synth_wl):
    from weasal_tpu_torch.infer import eval_batch, eval_body
    from weasal_tpu_torch.train.graphs import EvalGraph
    cfg, plan, spec, model, _, batch, _ = _card_setup(dev, synth_wl, seed=7)
    host = {k: v.cpu()[None] for k, v in batch.items()
            if not k.startswith("res_")}
    extra = {k: v for k, v in batch.items() if k.startswith("res_")}
    graph = EvalGraph("test eval", lambda inputs, out: eval_body(
        model, inputs, cfg, plan, dev, spec=spec, out=out), host, dev,
        extra=extra, graphed=True)
    graph.load(host)
    graph.run()
    want_p, want_l = eval_batch(model, batch, cfg, plan, device=dev,
                                spec=spec)
    torch.cuda.synchronize()
    assert graph.graph is not None and graph.replays == 1
    torch.testing.assert_close(graph.out["probs"], want_p, rtol=0,
                               atol=1e-6)
    assert torch.equal(graph.out["labels"], want_l)


def test_vote_batch_replay_equals_eager_bit_for_bit(dev, synth_wl):
    """A vote batch's replay (the tester's EvalGraph) equals the eager
    `eval_body` bit for bit: probabilities, labels and `d2`, the squared
    norms of the augmented points that the vote mask reads."""
    from weasal_tpu_torch.infer import eval_body
    from weasal_tpu_torch.train.graphs import EvalGraph
    cfg, plan, spec, model, _, batch, _ = _card_setup(dev, synth_wl, seed=8)
    host = {k: v.cpu()[None] for k, v in batch.items()
            if not k.startswith("res_")}
    extra = {k: v for k, v in batch.items() if k.startswith("res_")}
    graph = EvalGraph("vote batch", lambda inputs, out: eval_body(
        model, inputs, cfg, plan, dev, spec=spec, out=out), host, dev,
        extra=extra, graphed=True)
    graph.load(host)
    graph.run()
    eager = eval_body(model, batch, cfg, plan, dev, spec=spec)
    torch.cuda.synchronize()
    assert graph.replays == 1 and set(graph.out) == {"probs", "labels", "d2"}
    for key in ("probs", "labels", "d2"):
        assert torch.equal(graph.out[key], eager[key]), key


def test_threefry_on_card_equals_cpu(dev):
    from weasal_tpu_torch.utils import prng
    seeds = torch.tensor([0, 1, 5, 2 ** 31 - 1, 2 ** 32 - 1])
    cpu_bits = prng.random_bits(seeds, 3000)
    card_bits = prng.random_bits(seeds.to(dev), 3000)
    assert torch.equal(card_bits.cpu(), cpu_bits)
    cpu = prng.normal(seeds, (1000, 3)).numpy()
    card = prng.normal(seeds.to(dev), (1000, 3)).cpu().numpy()
    ulps = np.abs(card.view(np.int32).astype(np.int64)
                  - cpu.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4, ulps.max()


def test_checkpoint_and_vote_loads_keep_graphs_valid(dev, synth_wl,
                                                     tmp_path):
    from weasal_tpu_torch.train.trainer import ModelTrainer
    cfg, train, val, _ = synth_wl
    trainer = ModelTrainer(cfg, train, device=dev)
    cfg.max_epoch = 1
    trainer.train(train, val)
    trainer.save_checkpoint(str(tmp_path))
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ptrs = [t.data_ptr() for t in trainer._state_tensors()]
    flat = trainer._val_acc._flat.data_ptr()
    counts = trainer.graph_counts()
    assert counts["train_warmups"] >= 1 and counts["eval_warmups"] == 1
    try:
        cfg.max_epoch = 2
        trainer.train(train, val)              # moves the state on
        trainer.load_checkpoint(str(tmp_path / "current_chkp.tar"))
        trainer._val_acc.load(trainer.validation_probs)
        assert [t.data_ptr() for t in trainer._state_tensors()] == ptrs
        assert trainer._val_acc._flat.data_ptr() == flat
        for k, v in trainer.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        cfg.max_epoch = 2
        trainer.train(train, val)              # replays, no new capture
    finally:
        cfg.max_epoch = 1
    after = trainer.graph_counts()
    assert after["train_warmups"] == counts["train_warmups"]
    assert after["eval_warmups"] == 1
    assert after["train_replays"] > counts["train_replays"]
    moved = [k for k, v in trainer.model.state_dict().items()
             if not torch.equal(v, saved[k])]
    assert any(k.endswith(".var") for k in moved)
    assert all(np.isfinite(v).all() for v in trainer.validation_probs)


def test_capture_with_a_host_sync_raises(dev, synth_wl):
    from weasal_tpu_torch.train.graphs import StepGraph
    cfg, plan, _, model, opt, _, pyr = _card_setup(dev, synth_wl)
    example = {"x": torch.ones((1, 4))}

    def body(inputs, out):
        out["stats"][0].copy_(inputs["x"].sum())
        float(out["stats"][0])                 # a read back to the host

    graph = StepGraph("syncing step", body, example, 1, dev,
                      {"stats": torch.zeros((1, 2), device=dev),
                       "drops": torch.zeros((1, 1), device=dev)},
                      lambda: [], graphed=True)
    graph.load(example)
    with pytest.raises(RuntimeError, match="capturing the syncing step"):
        graph.run()
    assert graph.graph is None and graph.replays == 0


# ------------------------------------------------ the pseudo-label stage

@pytest.fixture(scope="module")
def synth_pl(tmp_path_factory):
    """A small synthetic Vaihingen root with refined pseudo labels (the
    ground truth, 30 % of it set to 10), the pseudo-label stage's 5-level
    architecture at 16 features on 8 m spheres, and its training and
    validation datasets."""
    from weasal_tpu_torch.config import VaihingenPLConfig
    from weasal_tpu_torch.data.datasets import Vaihingen3DPLDataset
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root

    class Small(VaihingenPLConfig):
        in_radius = 8.0
        first_subsampling_dl = 0.4
        first_features_dim = 16
        batch_num = 2
        max_epoch = 1
        epoch_steps = 2
        validation_size = 1
        weak_label_log = "WL"
        saving = False

    root = make_vaihingen_like_root(
        str(tmp_path_factory.mktemp("card_pl") / "Vaihingen3D"),
        extent=30.0, density=5.0, seed=11)
    cfg = Small()
    val = Vaihingen3DPLDataset(cfg, split="validation", data_root=root,
                               rng=np.random.default_rng(1))
    truth = val.input_labels[0]
    out = f"{root}/PseudoLabels/WL"
    os.makedirs(out, exist_ok=True)
    np.savetxt(f"{out}/Vaihingen3D_Training_t20_pseudo.txt", np.where(
        np.random.default_rng(2).random(truth.shape[0]) < 0.3, 10, truth),
        fmt="%i")
    train = Vaihingen3DPLDataset(cfg, split="training", data_root=root,
                                 rng=np.random.default_rng(0))
    return cfg, train, val


def test_pl_loop_launches_the_kernels(dev, synth_pl):
    """One graphed epoch of the pseudo-label stage, with the contrast loss
    and dropout: per step 13 A, 10 B, 10 C, 4 D, 14 inverse-list builds
    and 9 row sums; per validation batch 13 A, 10 B, 4 row sums."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import inverse_sum
    from weasal_tpu_torch.train.graphs import COUNTED, launch_counts
    from weasal_tpu_torch.train.trainer import ModelTrainer
    cfg, train, val = synth_pl
    trainer = ModelTrainer(cfg, train, device=dev)
    assert trainer.mode == "pseudo" and trainer.graphed
    for fn in COUNTED:
        fn.launches = 0
    trainer.train(train, val)
    torch.cuda.synchronize()
    counts = trainer.graph_counts()
    steps = trainer.epoch_times[0]["steps"]
    batches = trainer.val_times[0]["batches"]
    assert steps == cfg.epoch_steps and batches == 1
    assert counts["train_replayed_steps"] == steps
    assert counts["eval_replays"] == batches
    assert list(counts["train_runs_by"]) == ["large x1 contrast"]
    steps += counts["train_warmups"]
    batches += counts["eval_warmups"]
    per_step = {"radius_search": 13, "kpconv_fwd": 10, "kpconv_bwd": 10,
                "maxpool_bwd": 4, "build_inverse_lists": 14,
                "inverse_sum": 9}
    per_val = {"radius_search": 13, "kpconv_fwd": 10, "inverse_sum": 4}
    want = {k: per_step.get(k, 0) * steps + per_val.get(k, 0) * batches
            for k in launch_counts()}
    assert launch_counts() == want
    assert inverse_sum.launches == want["inverse_sum"]
    assert all(np.isfinite(v).all() for v in trainer.validation_probs)


def _pl_pyramid(dev, synth_pl, seed=3):
    from weasal_tpu_torch import KPFCNN, init_opt_state
    from weasal_tpu_torch.data import resident as res
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    cfg, train, _ = synth_pl
    plan = train.calibration(num_samples=8)
    spec = res.feature_spec(train.name, cfg.in_features_dim)
    src = res.ResidentBatchSource(train, plan, dev)
    small, _ = src.next_batch(np.random.default_rng(seed), augment=True)
    batch = {k: torch.from_numpy(v.astype(np.int64) if k == "noise_seed"
                                 else v).to(dev) for k, v in small.items()}
    batch.update(src.resident.arrays)
    with torch.no_grad():
        t = res.assemble_level0_device(batch, cfg, plan, True, spec)
        with plain_ops():
            pyr = batch_from_device_pyramid(
                t["points0"], t["mask0"], t["features"], t["labels"], cfg,
                plan, t["center_pts"], rotations=t["rotations"])
    model = KPFCNN(cfg, tuple(int(v) for v in train.label_values),
                   tuple(int(v) for v in train.ignored_labels),
                   generator=torch.Generator().manual_seed(seed)).to(dev)
    return cfg, plan, model, init_opt_state(model), pyr


def test_pl_step_replay_equals_eager(dev, synth_pl):
    """A pseudo-label step (dropout and the contrast draw from a seed on
    the card) replayed from a captured graph against the same step run
    eagerly from the same state: the same loss and state to 1e-6; from
    that state again, a replay with another seed draws anew and one with
    the same seed repeats its loss."""
    from weasal_tpu_torch.train.graphs import StepGraph
    from weasal_tpu_torch.train.step import (class_weights, label_table,
                                             step_on_batch, step_outputs)
    cfg, plan, model, opt, pyr = _pl_pyramid(dev, synth_pl)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt0 = {k: v.clone() for k, v in opt.items()}
    class_w, table = class_weights(cfg, dev), label_table(model, dev)
    seed = torch.zeros((), dtype=torch.int64, device=dev)
    lr_t = torch.full((), cfg.learning_rate, device=dev)

    def body(inputs, out):
        loss, acc = step_on_batch(model, opt, pyr, cfg, lr_t,
                                  class_w=class_w, table=table, seed=seed,
                                  use_contrast=True)
        out["stats"][0].copy_(loss)
        out["stats"][1].copy_(acc)

    runs = {}
    for graphed in (False, True):
        model.load_state_dict(state0)
        for k in opt:
            opt[k].copy_(opt0[k])
        seed.fill_(7)
        example = {"placeholder": torch.zeros((1, 1))}
        graph = StepGraph("PL test step", body, example, 1, dev,
                          step_outputs(plan, dev, steps=1),
                          lambda: (list(model.parameters())
                                   + list(model.buffers())
                                   + list(opt.values())), graphed=graphed)
        graph.load(example)
        graph.run()
        torch.cuda.synchronize()
        runs[graphed] = (float(graph.out["stats"][0, 0]),
                         {k: v.clone() for k, v in
                          model.state_dict().items()})
    assert graph.graph is not None
    assert runs[True][0] == pytest.approx(runs[False][0], rel=1e-6)
    for k, v in runs[False][1].items():
        torch.testing.assert_close(runs[True][1][k], v, rtol=1e-6,
                                   atol=1e-7)
    # from the same state: another seed, another draw; the same seed, the
    # same step
    for value, same in ((8, False), (7, True)):
        model.load_state_dict(state0)
        for k in opt:
            opt[k].copy_(opt0[k])
        seed.fill_(value)
        graph.run()
        assert (float(graph.out["stats"][0, 0]) == runs[True][0]) == same


def test_pl_draws_on_card_equal_cpu(dev):
    from weasal_tpu_torch.models import losses
    from weasal_tpu_torch.models.blocks import dropout_keep
    from weasal_tpu_torch.utils import prng
    seed = torch.tensor(12345, dtype=torch.int64)
    shape = (2, 3001, 64)
    assert torch.equal(dropout_keep(shape, 0.5, seed.to(dev)).cpu(),
                       dropout_keep(shape, 0.5, seed))
    rng = np.random.default_rng(0)
    certain = torch.from_numpy(rng.random(20000) < 0.2)
    valid = certain | torch.from_numpy(rng.random(20000) < 0.5)
    u = prng.uniform(seed.reshape(1), 1000, losses.CONTRAST_STREAM)[0]
    cpu = losses.contrast_draw(certain, valid, u)
    card = losses.contrast_draw(certain.to(dev), valid.to(dev), u.to(dev))
    assert bool(certain[card.cpu()].all())
    assert torch.equal(card.cpu(), cpu)


def test_pl_contrast_backward_repeats_bit_for_bit(dev):
    """The contrast loss's gradient on the card (its drawn rows' gather
    summed over inverse lists) is the same over 3 calls."""
    from weasal_tpu_torch.models import losses
    rng = np.random.default_rng(1)
    n, c = 30000, 9
    logits = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    raw = rng.integers(0, 9, n)
    labels = torch.from_numpy(np.where(rng.random(n) < 0.4, 10, raw))
    valid = torch.from_numpy(rng.random(n) < 0.95)
    seed = torch.tensor(3, dtype=torch.int64, device=dev)

    def grad():
        x = logits.to(dev).requires_grad_()
        losses.contrast_loss(x, labels.to(dev), valid.to(dev), c, 0.2,
                             seed=seed).backward()
        return (x.grad,)

    assert _bits_repeat(grad)


# --------------------------------------- plain voxel sums, deformable convs

def test_plain_run_sums_on_card_equal_the_kernel(dev):
    """The plain voxel sums (`run_sums_plain`, a pass per rank within the
    runs) on the card equal the `run_sums` kernel bit for bit, sums and
    counts, and repeat, at widths 3 and 64."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import (run_sums,
                                                         run_sums_plain)
    seg, n_out = run_case()
    seg = seg.to(dev)
    for c_dim in (3, 64):
        g = torch.Generator(device=dev).manual_seed(c_dim)
        src = torch.randn((*seg.shape, c_dim), generator=g, device=dev)
        got = _bits_repeat(lambda: run_sums_plain(src, seg, n_out))
        want = run_sums(src, seg, n_out)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def _deform_pl(dev, synth_pl, seed=3):
    """synth_pl's configuration with its layer-3 resnetb and its layer-4
    blocks deformable (chip_smoke.py phase 11's pattern), its training
    dataset and plan, a model and momentum on the card and one batch's
    level-0 tensors."""
    from weasal_tpu_torch import KPFCNN, init_opt_state
    from weasal_tpu_torch.data import resident as res
    cfg, train, _ = synth_pl
    arch = list(cfg.architecture)
    arch[7:10] = ["resnetb_deformable", "resnetb_deformable_strided",
                  "resnetb_deformable"]
    dcfg = type("DeformSmall", (type(cfg),), {"architecture": arch})()
    assert dcfg.deform_layers == [False, False, False, True, True]
    ds = type(train)(dcfg, split="training", data_root=train.path,
                     rng=np.random.default_rng(0))
    plan = ds.calibration(num_samples=8)
    spec = res.feature_spec(ds.name, dcfg.in_features_dim)
    src = res.ResidentBatchSource(ds, plan, dev)
    small, _ = src.next_batch(np.random.default_rng(seed), augment=True)
    batch = {k: torch.from_numpy(v.astype(np.int64) if k == "noise_seed"
                                 else v).to(dev) for k, v in small.items()}
    batch.update(src.resident.arrays)
    with torch.no_grad():
        t = res.assemble_level0_device(batch, dcfg, plan, True, spec)
    model = KPFCNN(dcfg, tuple(int(v) for v in ds.label_values),
                   tuple(int(v) for v in ds.ignored_labels),
                   generator=torch.Generator().manual_seed(seed)).to(dev)
    return dcfg, plan, model, init_opt_state(model), t


def _plain_pyramid(t, cfg, plan):
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    with torch.no_grad(), plain_ops():
        return batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], cfg, plan,
            t["center_pts"], rotations=t["rotations"])


def test_plain_pyramid_builds_are_bit_equal(dev, synth_pl):
    """Three builds of one batch's pyramid on the plain versions are bit
    equal (the voxel sums add in a fixed order), and equal the kernels'
    build."""
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    cfg, plan, _, _, t = _deform_pl(dev, synth_pl)
    pyrs = [_plain_pyramid(t, cfg, plan) for _ in range(3)]
    with torch.no_grad():
        pyrs.append(batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], cfg, plan,
            t["center_pts"], rotations=t["rotations"]))
    for other in pyrs[1:]:
        for field in ("points", "masks", "neighbors", "pools", "upsamples"):
            for a, b in zip(getattr(pyrs[0], field), getattr(other, field)):
                assert torch.equal(a, b), field


def test_deformable_step_repeats_bit_for_bit(dev, synth_pl):
    """A pseudo-label step of the deformable network on the card (its
    rigid convs and offset convs on kernels B and C, the deformable convs
    in plain PyTorch with the neighbor gather's dX over inverse lists),
    eager twice and replayed from a captured graph, from one state and
    pyramid: loss, offset loss and every updated tensor bit-equal; the
    offset loss is finite and positive, and every offset parameter
    moves."""
    from weasal_tpu_torch.train.graphs import StepGraph
    from weasal_tpu_torch.train.step import (class_weights, label_table,
                                             step_on_batch, step_outputs)
    cfg, plan, model, opt, t = _deform_pl(dev, synth_pl)
    pyr = _plain_pyramid(t, cfg, plan)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt0 = {k: v.clone() for k, v in opt.items()}
    class_w, table = class_weights(cfg, dev), label_table(model, dev)
    seed = torch.full((), 7, dtype=torch.int64, device=dev)

    def body(inputs, out):
        loss, acc, reg = step_on_batch(
            model, opt, pyr, cfg, cfg.learning_rate, class_w=class_w,
            table=table, seed=seed, use_contrast=True,
            with_offset_loss=True)
        out["stats"][0].copy_(loss)
        out["stats"][1].copy_(acc)
        out["stats"][2].copy_(reg)

    runs = []
    for graphed in (False, False, True):
        model.load_state_dict(state0)
        for k in opt:
            opt[k].copy_(opt0[k])
        example = {"placeholder": torch.zeros((1, 1))}
        graph = StepGraph("deformable step", body, example, 1, dev,
                          step_outputs(plan, dev, steps=1),
                          lambda: (list(model.parameters())
                                   + list(model.buffers())
                                   + list(opt.values())), graphed=graphed)
        graph.load(example)
        graph.run()
        torch.cuda.synchronize()
        runs.append((graph.out["stats"][0].clone(),
                     {k: v.clone() for k, v in model.state_dict().items()}))
    assert graph.graph is not None
    stats, state = runs[0]
    assert math.isfinite(float(stats[2])) and float(stats[2]) > 0
    for other_stats, other_state in runs[1:]:
        assert torch.equal(other_stats, stats)
        for k, v in state.items():
            assert torch.equal(other_state[k], v), k
    moved = [k for k in state if "offset" in k and "kernel_points" not in k
             and not torch.equal(state[k], state0[k])]
    assert len(moved) == 6


# ------------------------------------------------- the host-pyramid path

def _kernels_vs_plain(model, pyr, dev):
    """B and C at every kernel conv of `model` and D at every strided
    shortcut, on the neighbor lists of the batch `pyr` (seeded random
    features and output gradients), against their plain versions;
    returns the counts of convs and pools checked."""
    from weasal_tpu_torch.models.blocks import (ResnetBottleneckBlock,
                                                conv_inputs, kernel_convs)
    g = torch.Generator(device=dev).manual_seed(0)
    convs = kernel_convs(model)
    for name, conv in convs:
        q, s, nb, _ = conv_inputs(conv.strided, conv.layer_ind, pyr)
        kp, w = conv.kernel_points, conv.weights.detach()
        ext, infl = conv.params.kp_extent, conv.params.influence
        x = torch.randn((s.shape[0], s.shape[1], w.shape[1]), generator=g,
                        device=dev)
        out, y = kpconv_fwd_with_y(q, s, nb, x, kp, w, ext, infl)
        ref, y_plain = kpconv_fwd_plain_with_y(q, s, nb, x, kp, w, ext,
                                               infl)
        _close(out, ref, 1e-4, 1e-5)
        grad = torch.randn(out.shape, generator=g, device=dev)
        dx, dw = kpconv_bwd(q, s, nb, y, kp, w, grad, ext, infl,
                            inverse=LazyInverse(nb, s.shape[1]))
        dx_p, dw_p = kpconv_bwd_plain(q, s, nb, y_plain, kp, w, grad, ext,
                                      infl)
        torch.cuda.synchronize()
        _close(dx, dx_p, 1e-4, 1e-5)
        _close(dw, dw_p, 1e-4, 1e-5)
    pools = [m for m in model.modules()
             if isinstance(m, ResnetBottleneckBlock) and m.KPConv.strided]
    for m in pools:
        nb = pyr.pools[m.layer_ind]
        b, ns = pyr.points[m.layer_ind].shape[:2]
        x = torch.randint(-3, 3, (b, ns, m.in_dim), generator=g,
                          device=dev).float()
        x[:, :, 0].clamp_(max=0.0)
        grad = torch.randn((b, nb.shape[1], m.in_dim), generator=g,
                           device=dev)
        got = maxpool_bwd(x, nb, grad, inverse=LazyInverse(nb, ns))
        want = maxpool_bwd_plain(x, nb, grad)
        torch.cuda.synchronize()
        _close(got, want, 1e-6, 1e-6)
    return len(convs), len(pools)


def test_kernels_equal_plain_on_host_lists(dev, synth_wl):
    """B, C and D on a host-built batch (data/batching.assemble_batch:
    supports in grid-subsample order, rows cropped at the plan's
    widths)."""
    from weasal_tpu_torch import KPFCNN_mprm
    cfg, train, _, plan = synth_wl
    batch, _ = train.next_batch(np.random.default_rng(3), plan)
    pyr = batch.to(dev)
    assert pyr.search_overflow is None
    model = KPFCNN_mprm(cfg, tuple(int(v) for v in train.label_values), (),
                        generator=torch.Generator().manual_seed(3)).to(dev)
    assert _kernels_vs_plain(model, pyr, dev) == (12, 2)


def test_kernels_equal_plain_at_kpcnn_shapes(dev):
    """B, C and D at KPCNN's shapes, on a host-built classification
    batch of synthetic shape clouds; KPCNN's forward on the card against
    its plain-version forward."""
    from weasal_tpu_torch import KPCNN
    from weasal_tpu_torch.data.batching import (
        assemble_classification_batch, build_sphere_pyramid,
        calibrate_shape_plan)
    from weasal_tpu_torch.data.synthetic import synthetic_shape_cloud
    cfg = ShapeClsConfig()
    rng = np.random.default_rng(0)
    plan = calibrate_shape_plan(
        [synthetic_shape_cloud(rng, i % 3, n=160) for i in range(6)], cfg)
    clouds = []
    for i in range(6):
        pts = synthetic_shape_cloud(rng, i % 3, n=160)
        clouds.append(dict(pyramid=build_sphere_pyramid(
            pts, cfg, rng=rng, with_upsamples=False),
            features=np.ones((pts.shape[0], 1), np.float32), label=i % 3))
    pyr = assemble_classification_batch(clouds, plan).to(dev)
    model = KPCNN(cfg, generator=torch.Generator().manual_seed(0)).to(dev)
    assert _kernels_vs_plain(model, pyr, dev) == (3, 1)
    model.eval()
    with torch.no_grad():
        got = model(pyr)
        with plain_ops():
            want = model(pyr)
    assert got.shape == (6, 3)
    _close(got, want, 1e-4, 1e-5)


def test_host_step_replay_equals_eager_bit_for_bit(dev, synth_wl):
    """One weak-label step on a host batch (its `arrays()` in a pack, as
    the trainer's prefetcher carries it) through `step_body`, eager and
    replayed from a captured graph (the inverse lists built inside it
    from the static neighbor tensors), from one state: loss, accuracy,
    drops and every updated tensor bit-equal."""
    from weasal_tpu_torch import KPFCNN_mprm, init_opt_state
    from weasal_tpu_torch.data.loader import HostPyramidSource
    from weasal_tpu_torch.train.graphs import StepGraph
    from weasal_tpu_torch.train.step import (class_weights, label_table,
                                             step_body, step_outputs)
    cfg, train, _, plan = synth_wl
    source = HostPyramidSource(train, plan)
    rng = np.random.default_rng(5)
    for _ in range(20):
        arrays, metas = source.next_batch(rng, augment=True)
        if any(m["has_regions"] for m in metas):
            break
    pack = {k: torch.from_numpy(np.ascontiguousarray(v[None]))
            for k, v in arrays.items()}
    model = KPFCNN_mprm(cfg, tuple(int(v) for v in train.label_values), (),
                        generator=torch.Generator().manual_seed(2)).to(dev)
    opt = init_opt_state(model)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt0 = {k: v.clone() for k, v in opt.items()}
    lr_t = torch.full((), cfg.learning_rate, device=dev)
    class_w, table = class_weights(cfg, dev), label_table(model, dev)

    def body(inputs, out):
        step_body(model, opt, inputs, cfg, plan, lr_t, out, class_w, table)

    runs = []
    for graphed in (False, True):
        model.load_state_dict(state0)
        for k in opt:
            opt[k].copy_(opt0[k])
        graph = StepGraph("host step", body, pack, 1, dev,
                          step_outputs(plan, dev, steps=1),
                          lambda: (list(model.parameters())
                                   + list(model.buffers())
                                   + list(opt.values())), graphed=graphed)
        graph.load(pack)
        graph.run()
        torch.cuda.synchronize()
        runs.append(({k: v.clone() for k, v in graph.out.items()},
                     {k: v.clone() for k, v in model.state_dict().items()},
                     {k: v.clone() for k, v in opt.items()}))
    assert graph.graph is not None and graph.replays == 1
    (out_e, state_e, opt_e), (out_g, state_g, opt_g) = runs
    assert math.isfinite(float(out_e["stats"][0, 0]))
    assert not out_e["drops"].any()
    for k in out_e:
        assert torch.equal(out_e[k], out_g[k]), k
    for k in state_e:
        assert torch.equal(state_e[k], state_g[k]), k
    for k in opt_e:
        assert torch.equal(opt_e[k], opt_g[k]), k


def test_host_pyramid_loop_launches_the_kernels(dev, synth_wl):
    """A graphed weak-label epoch on the host pyramid: every step and
    validation batch replayed; 0 A, 12 B, 12 C, 2 D a step and 0 A, 12 B
    a validation batch, the warm-ups counted."""
    import copy
    from weasal_tpu_torch.train.trainer import ModelTrainer
    cfg, train, val, plan = synth_wl
    cfg = copy.copy(cfg)
    cfg.device_pyramid = False
    trainer = ModelTrainer(cfg, train, device=dev)
    assert not trainer.resident and trainer.graphed
    counted = (radius_search, kpconv_fwd, kpconv_bwd, maxpool_bwd)
    for fn in counted:
        fn.launches = 0
    trainer.train(train, val)
    torch.cuda.synchronize()
    steps = trainer.epoch_times[0]["steps"]
    batches = trainer.val_times[0]["batches"]
    assert steps >= 1 and batches == 1
    counts = trainer.graph_counts()
    assert counts["train_replayed_steps"] == steps
    assert counts["eval_replays"] == batches
    steps += counts["train_warmups"]
    batches += counts["eval_warmups"]
    want = {"radius_search": 0, "kpconv_fwd": 12 * (steps + batches),
            "kpconv_bwd": 12 * steps, "maxpool_bwd": 2 * steps}
    assert {fn.__name__: fn.launches for fn in counted} == want
    assert trainer.epoch_drops == [0.0]
    assert all(np.isfinite(v).all() for v in trainer.validation_probs)


# ------------------------------------- bf16 and any kernel-point count (B, C)

def _bf16_conv_check(dev, case, seed, kp=15):
    """B and C in bf16 on one conv problem against their plain bf16
    versions: y and dW by the flip criterion (tests/_bf16_cases.py), out
    and dX by their distance to an f64 evaluation of the same rounding
    points (`within_plain`), out within f32 tolerance of its own y @
    bf(W); C runs on the plain forward's y, so that each kernel is held
    alone."""
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, seed, kp=kp, **case)
    out, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, "linear",
                               compute_dtype="bfloat16")
    out_p, y_p = kpconv_fwd_plain_with_y(q, s, nb, x, kpts, w, 0.8,
                                         "linear", "bfloat16")
    dx, dw = kpconv_bwd(q, s, nb, y_p, kpts, w, grad, 0.8, "linear",
                        inverse=LazyInverse(nb, s.shape[1]),
                        compute_dtype="bfloat16")
    dx_p, dw_p = kpconv_bwd_plain(q, s, nb, y_p, kpts, w, grad, 0.8,
                                  "linear", compute_dtype="bfloat16")
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y_p.dtype == torch.bfloat16
    assert is_bf16_valued(dw)
    terms = (y_p.float().abs().t() @ grad.abs().reshape(-1, w.shape[2]))
    y_terms = kpconv_fwd_plain_with_y(q, s, nb, x.abs(), kpts, w, 0.8,
                                      "linear")[1]
    fy = flips(y, y_p, y_terms)
    fw = flips(dw, dw_p, terms.reshape(dw.shape))
    kp_, cin, cout = w.shape
    _close(out.double(), (y.double() @ w.to(torch.bfloat16).double()
                          .reshape(kp_ * cin, cout)).reshape(out.shape),
           1e-4, 1e-5)
    assert flips_ok(fy), fy
    assert flips_ok(fw), fw
    out64 = kpconv_fwd_plain(*_f64(q, s), nb, *_f64(x, kpts, w), 0.8,
                             "linear", "bfloat16")
    dx64, _ = kpconv_bwd_plain(*_f64(q, s), nb, y_p, *_f64(kpts, w, grad),
                               0.8, "linear", compute_dtype="bfloat16")
    for got, plain, ref in ((out, out_p, out64), (dx, dx_p, dx64)):
        report = within_plain(got, plain, ref)
        assert report["ok"], report


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_kpconv_bf16_kernels_match_plain(dev, case):
    """Kernels B and C under compute_dtype "bfloat16" at GEMM_CASES (the
    main path's widest conv, DALES's first and widest, depths that are
    not multiples of 8: value-by-value loads of the bf16 operands)."""
    _bf16_conv_check(dev, GEMM_CASES[case], 11)


# (Kp, K): one chunk of kernel points, one past it, 20 (a generated
# disposition), 40 at the deformable layers' K of 266 (the influence tile
# past 48 KB of shared memory)
KP_CASES = [(1, 20), (5, 20), (16, 20), (17, 20), (20, 20), (40, 20),
            (40, 266)]


@pytest.mark.parametrize("kp,k", KP_CASES)
def test_kpconv_kernels_at_any_kp(dev, kp, k):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 12, k=k, kp=kp)
    out, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, "linear")
    out_p, y_p = kpconv_fwd_plain_with_y(q, s, nb, x, kpts, w, 0.8,
                                         "linear")
    dx, dw = kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8, "linear",
                        inverse=LazyInverse(nb, s.shape[1]))
    dx_p, dw_p = kpconv_bwd_plain(q, s, nb, y, kpts, w, grad, 0.8, "linear")
    torch.cuda.synchronize()
    _close(y, y_p, 1e-4, 1e-5)
    _close(out, out_p, 1e-4, 1e-5)
    _close(dx, dx_p, 1e-4, 1e-5)
    _close(dw, dw_p, 1e-4, 1e-5)
    if kp in (17, 40):
        # past one chunk the bf16 workspace of C is f32
        _bf16_conv_check(dev, dict(k=k), 13, kp=kp)


def test_kpconv_past_the_shared_memory_limit_raises(dev):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 14, k=2000, kp=40,
                                               nq=20, ns=30)
    with pytest.raises(ValueError, match="limit of"):
        kpconv_fwd(q, s, nb, x, kpts, w, 0.8)
    y = torch.zeros((2 * 20, 40 * 24), device=dev)
    with pytest.raises(ValueError, match="limit of"):
        kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8,
                   inverse=LazyInverse(nb, s.shape[1]))


def test_bf16_step_replay_equals_eager(dev, synth_wl):
    """A weak-label step with compute_dtype "bfloat16" (kernels B and C in
    their bf16 variants, the bf16 aggregates allocated inside the graph's
    pool) replayed from a captured graph: loss and every updated tensor
    bit-equal to the same step run eagerly; the bf16 variants launch."""
    import copy
    from weasal_tpu_torch import KPFCNN_mprm, init_opt_state
    cfg, plan, _, _, _, _, pyr = _card_setup(dev, synth_wl)
    cfg = copy.copy(cfg)
    cfg.compute_dtype = "bfloat16"
    labels = tuple(int(v) for v in synth_wl[1].label_values)
    model = KPFCNN_mprm(cfg, labels, (),
                        generator=torch.Generator().manual_seed(3)).to(dev)
    opt = init_opt_state(model)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt0 = {k: v.clone() for k, v in opt.items()}
    lr_t = torch.full((), cfg.learning_rate, device=dev)
    runs = []
    for graphed in (False, True):
        model.load_state_dict(state0)
        for k in opt:
            opt[k].copy_(opt0[k])
        kpconv_fwd.launches = kpconv_bwd.launches = 0
        graph = _pyramid_step_graph(model, opt, pyr, cfg, plan, lr_t, dev,
                                    graphed=graphed)
        graph.run()
        torch.cuda.synchronize()
        assert (graph.graph is not None) == graphed
        assert kpconv_fwd.launches >= 12 and kpconv_bwd.launches >= 12
        runs.append((graph.out["stats"][0].clone(),
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (s0, st0), (s1, st1) = runs
    assert math.isfinite(float(s0[0]))
    assert torch.equal(s0, s1)
    for k, v in st0.items():
        assert torch.equal(st1[k], v), k


def test_two_gloo_ranks_on_one_card_equal_one_process(dev, tmp_path):
    """Data parallel on one card (parallel/ddp.py): two gloo ranks sharing
    cuda:0 take the weak-label and the pseudo-label step of
    tests/_torch_ddp_worker.py on their halves of the demo batch, with
    kernels B, C and D; their loss is one process's kernel step's (rtol
    1e-5), their gradients within the CPU test's rtol 2e-4 and atol 2e-5,
    the ranks bit-equal to each other, the dropout masks and the contrast
    draw bit-equal to one process's."""
    from weasal_tpu_torch.parallel import ddp
    from tests import _torch_ddp_worker as worker
    for mode in ("weak", "pseudo"):
        out = tmp_path / mode
        out.mkdir()
        ddp.spawn(worker.step_rank, 2, "cuda:0", args=(str(out), mode),
                  timeout=180.0)
        ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(2)]
        single = worker.run_step(mode, worker.global_batch(mode),
                                 device=dev)
        for key in ("grads", "state"):
            for name, value in ranks[0][key].items():
                assert torch.equal(value, ranks[1][key][name]), (key, name)
        np.testing.assert_allclose(float(ranks[0]["loss"]),
                                   float(single["loss"]), rtol=1e-5)
        for name, ref in single["grads"].items():
            np.testing.assert_allclose(ranks[0]["grads"][name].numpy(),
                                       ref.numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=name)
        if mode == "pseudo":
            keep = torch.cat([r["keep"] for r in ranks])
            assert torch.equal(keep, single["keep"])
            assert all(torch.equal(r["draw"], single["draw"]) for r in ranks)


def test_nccl_one_rank_graphed_step_equals_no_group(dev, synth_wl,
                                                    tmp_path):
    """One NCCL rank (a group of one in this process): a training step
    replayed from a captured graph, with the collectives of BatchNorm's
    statistics, the loss's sums and the gradient average inside it,
    equals the same replayed step with no group bit for bit (loss and
    every updated tensor), over three replays in a row."""
    from weasal_tpu_torch.parallel import ddp
    cfg, plan, _, model, opt, _, pyr = _card_setup(dev, synth_wl)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt0 = {k: v.clone() for k, v in opt.items()}
    lr_t = torch.full((), cfg.learning_rate, device=dev)
    runs = []
    for grouped in (True, False):
        model.load_state_dict(state0)
        for k in opt:
            opt[k].copy_(opt0[k])
        with contextlib.ExitStack() as stack:
            if grouped:
                stack.enter_context(ddp.group(
                    0, 1, "nccl", dev, str(tmp_path / "store")))
            graph = _pyramid_step_graph(model, opt, pyr, cfg, plan, lr_t,
                                        dev, graphed=True)
            for _ in range(3):
                graph.run()
            torch.cuda.synchronize()
            assert graph.graph is not None and graph.replays == 3
        runs.append((graph.out["stats"][0].clone(),
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (s0, st0), (s1, st1) = runs
    assert math.isfinite(float(s0[0])) and torch.equal(s0, s1)
    for k, v in st0.items():
        assert torch.equal(st1[k], v), k


def test_gloo_group_on_a_card_steps_eagerly_and_refuses_graphs(
        dev, synth_wl, tmp_path):
    """Gloo collectives cannot be captured: under a gloo group a trainer
    on the card runs its steps eagerly when graphs are left to it, and
    raises when graphs or a steps_per_dispatch are asked for."""
    import copy
    from weasal_tpu_torch.parallel import ddp
    from weasal_tpu_torch.train.trainer import ModelTrainer
    cfg, train, _, _ = synth_wl
    with ddp.group(0, 1, "gloo", dev, str(tmp_path / "store")):
        assert not ModelTrainer(copy.copy(cfg), train, device=dev).graphed
        with pytest.raises(ValueError, match="gloo"):
            ModelTrainer(copy.copy(cfg), train, device=dev, graphs=True)
        explicit = copy.copy(cfg)
        explicit.steps_per_dispatch = 1
        with pytest.raises(ValueError, match="gloo"):
            ModelTrainer(explicit, train, device=dev)
    assert ModelTrainer(copy.copy(cfg), train, device=dev).graphed


def test_visualizer_on_the_card_equals_plain(dev, synth_pl, tmp_path):
    """`ModelVisualizer.show_deformable_kernels` on the deformable
    pseudo-label model (layers 3-4 deformable) and one batch, its pyramid
    built on the card, against the same on the plain versions: the
    deformed kernel points of each deformable conv within B's tolerance
    (rtol 1e-4, atol 1e-5 x scale), the same frames and files; the
    pyramid and forward launch A and B (chip_smoke.py phase 15 (a))."""
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.visualizer import ModelVisualizer
    dcfg, plan, model, _, t = _deform_pl(dev, synth_pl)
    model.eval()
    runs = {}
    for label in ("kernels", "plain"):
        vis = ModelVisualizer(model)
        out = tmp_path / label
        with contextlib.ExitStack() as stack:
            if label == "plain":
                stack.enter_context(plain_ops())
            a0, b0 = radius_search.launches, kpconv_fwd.launches
            with torch.no_grad():
                pyr = batch_from_device_pyramid(
                    t["points0"], t["mask0"], t["features"], t["labels"],
                    dcfg, plan, t["center_pts"], rotations=t["rotations"])
                frames = vis.show_deformable_kernels(pyr, str(out))
            torch.cuda.synchronize()
            launched = (radius_search.launches - a0,
                        kpconv_fwd.launches - b0)
        runs[label] = (vis.deformed, [os.path.relpath(f, out)
                                      for f in frames],
                       sorted(os.listdir(out)), launched)
    (dk, fk, files_k, (a, b)), (dp, fp, files_p, plain) = (runs["kernels"],
                                                          runs["plain"])
    assert a == 3 * dcfg.num_layers - 2 and b > 0 and plain == (0, 0)
    assert fk == fp and files_k == files_p and len(dk) == 3
    assert len(fk) == 3 * 4 and "input.ply" in files_k
    for name, ref in dp.items():
        got = dk[name]
        assert torch.allclose(got, ref, rtol=1e-4,
                              atol=1e-5 * float(ref.abs().max())), name


def test_max_pool_block_runs_kernel_d_on_its_edge(dev, synth_pl,
                                                  monkeypatch):
    """`MaxPoolBlock` at layer 0 (JAX's edge pools[1], into level 0's
    features) forward and backward on the card against the plain
    versions: forwards equal, one D launch over the edge's inverse
    lists, and dX within D's tolerance (rtol 1e-6, atol 1e-6 x scale) of
    the plain version with its sums in the kernel's order
    (`ordered_row_sums`): the edge's shadow index is a real row of level
    0, whose list takes every padded slot, so `index_add_`'s order moves
    that row's f32 sum (chip_smoke.py phase 15 (b))."""
    from weasal_tpu_torch.models.blocks import MaxPoolBlock
    from weasal_tpu_torch.ops.cuda import maxpool_bwd as d_mod
    dcfg, plan, _, _, t = _deform_pl(dev, synth_pl)
    pyr = _plain_pyramid(t, dcfg, plan)
    g = torch.Generator(device=dev).manual_seed(0)
    b, ns = pyr.points[0].shape[:2]
    x = torch.randint(-3, 3, (b, ns, 16), generator=g, device=dev).float()
    x[:, :, 0].clamp_(max=0.0)
    grad = torch.randn((b, pyr.pools[1].shape[1], 16), generator=g,
                       device=dev)
    out = {}
    for label in ("kernels", "plain"):
        xr = x.clone().requires_grad_()
        d0 = maxpool_bwd.launches
        with contextlib.ExitStack() as stack:
            if label == "plain":
                stack.enter_context(plain_ops())
            y = MaxPoolBlock(0)(xr, pyr)
            y.backward(grad)
        torch.cuda.synchronize()
        out[label] = (y.detach(), xr.grad, maxpool_bwd.launches - d0)
    (yk, dk, nk), (yp, _, np_) = out["kernels"], out["plain"]
    assert yk.shape == (b, pyr.pools[1].shape[1], 16)
    assert torch.equal(yk, yp) and (nk, np_) == (1, 0)

    def in_list_order(values, inds, ns):
        lists = build_inverse_lists_plain(inds, ns, values.shape[2])
        return ordered_row_sums(values.reshape(-1, values.shape[3]),
                                lists.offsets, lists.entries,
                                inds.shape[0] * ns).reshape(
            inds.shape[0], ns, values.shape[3])

    monkeypatch.setattr(d_mod, "scatter_rows", in_list_order)
    want = maxpool_bwd_plain(x, pyr.pools[1], grad)
    assert torch.allclose(dk, want, rtol=1e-6,
                          atol=1e-6 * float(want.abs().max()))
