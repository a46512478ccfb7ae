"""Kernel A's candidate rule on the CPU.

Kernel A (weasal_tpu_torch/csrc/radius_search.cu) bins the supports of a
sphere into columns of a 2-D grid and tests only the columns that a
query's reach overlaps. `radius_search_binned_reference` emulates that
binning and column rule in PyTorch with the kernel's f32 formulas; here
it is held for equality against the all-pairs `radius_search_plain` on
sets built to break it: lattices with exact distance ties, supports at r
and r +- 1 ulp, points on column boundaries, an extent wider than the
grid at the radius (so the column side grows), all points in one column,
empty and all-masked spheres, K = 1 and K = 256. Each case also checks
that the candidates contain every in-radius pair (the exactness
argument of the source note) and that the candidate counts read from the
column starts match the candidate mask. One case is held against the JAX
package's banded Pallas search in interpret mode.

The kernel's warp path (K above 16: one warp a query, hits compacted into
a buffer that is cut to the K smallest when full, the K-th key then the
limit) is emulated by `radius_search_warp_reference`, which walks the
candidates in the kernel's order with a buffer capacity given as a
parameter; it is held to the all-pairs search on sets whose hits overflow
small buffers many times (dense clusters, a fine lattice whose cuts fall
inside groups of exact ties), at K = 17, 200-300 and 768, on an all-masked
sphere and with fewer hits than K, and once against the banded Pallas
search. No card needed.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from weasal_tpu.ops.pallas.radius_pallas import radius_search_banded
from weasal_tpu_torch.ops.cuda.radius_search import (
    _r2, _sq_dist, candidate_mask, radius_search_binned_reference,
    radius_search_plain, radius_search_warp_reference, support_grid,
    warp_capacity)
from tests._cell_search_cases import (CASES, WARP_CASES, as_tensors,
                                      column_boundaries, lattice, one_column,
                                      random_sphere, ulp_shell, wide_extent)
from tests._warm_torch import cpu_torch


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


@pytest.mark.parametrize("case", list(CASES))
def test_binned_rule_equals_all_pairs(case):
    make, radius, k = CASES[case]
    q, s, qm, sm = as_tensors(*make(np.random.default_rng(7), radius))
    want = radius_search_plain(q, s, qm, sm, radius, k)
    got, candidates = radius_search_binned_reference(q, s, qm, sm, radius, k)
    assert torch.equal(got, want)
    # Every in-radius pair is a candidate (the exactness argument), and
    # the counts read from the column starts are the candidate sets' sizes
    grid = support_grid(s, sm, radius)
    cand = candidate_mask(q, s, sm, grid)
    inside = (_sq_dist(q, s) <= _r2(radius)) & sm[:, None, :]
    assert not bool((inside & ~cand)[qm].any())
    assert torch.equal(candidates, torch.where(qm, cand.sum(-1), 0))


def test_cases_reach_what_they_are_built_for():
    """The sets do stress the rule: ties at r, supports one ulp either
    side of r, supports on column boundaries with queries in and out of
    range across them, a column side above the reach, one occupied column
    with more candidates than K."""
    rng = np.random.default_rng(7)
    q, s, qm, sm = as_tensors(*ulp_shell(rng, 0.6))
    d2 = _sq_dist(q, s)
    r2 = _r2(0.6)
    assert bool((d2 == r2).any() or ((d2 < r2) & (d2 > r2 * 0.99999)).any())
    assert bool((d2 > r2).any() & (d2 < r2 * 1.00001).any())
    q, s, qm, sm = as_tensors(*lattice(rng, 0.5))
    assert bool((_sq_dist(q, s) == _r2(0.5)).any())
    q, s, qm, sm = as_tensors(*wide_extent(rng, 0.5))
    _, _, inv_h, reach = support_grid(s, sm, 0.5)
    assert float((1 / inv_h)[0]) > 2 * float(reach[0])
    q, s, qm, sm = as_tensors(*one_column(rng, 0.3))
    x0, y0, inv_h, _ = support_grid(s, sm, 0.3)
    assert float(((s[0, :, 0] - x0[0]) * inv_h[0]).max()) < 1
    _, cand = radius_search_binned_reference(q, s, qm, sm, 0.3, 256)
    assert int(cand.max()) > 256
    q, s, qm, sm = as_tensors(*column_boundaries(rng, 0.6))
    x0, _, inv_h, _ = support_grid(s, sm, 0.6)
    frac = (s[0, :, 0] - x0[0]) * inv_h[0]
    assert bool((frac == torch.floor(frac)).any())
    d2 = _sq_dist(q, s)
    assert bool((d2 <= _r2(0.6)).any() & (d2 > _r2(0.6)).any())


def test_binned_rule_equals_banded_pallas():
    """One random sphere batch through the JAX package's banded search in
    interpret mode, with a band wider than the sphere (no overflow)."""
    rng = np.random.default_rng(11)
    q, s, qm, sm = random_sphere(rng, 0.8)
    order = np.argsort(s[:, :, 0], axis=1, kind="stable")
    s = np.take_along_axis(s, order[..., None], 1)
    sm = np.take_along_axis(sm, order, 1)
    idx, ovf = radius_search_banded(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm),
        jnp.asarray(q[:, :, 0]), jnp.asarray(s[:, :, 0]), radius=0.8,
        max_count=20, band=512, interpret=True)
    assert float(jnp.sum(ovf)) == 0.0
    got, _ = radius_search_binned_reference(*as_tensors(q, s, qm, sm), 0.8, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))


@pytest.mark.parametrize("case", list(WARP_CASES))
def test_warp_selection_equals_all_pairs(case):
    """The warp path's compaction, cut and limit rule give the all-pairs
    rows, whether the buffer is cut (many times at a capacity of K + 32)
    or never fills."""
    make, radius, k, capacity, cut = WARP_CASES[case]
    q, s, qm, sm = as_tensors(*make(np.random.default_rng(7), radius))
    want = radius_search_plain(q, s, qm, sm, radius, k)
    got, cuts = radius_search_warp_reference(q, s, qm, sm, radius, k,
                                             capacity)
    assert torch.equal(got, want)
    assert bool(cuts.any()) == cut
    assert not bool(cuts[~qm].any())


def test_warp_capacity_and_its_floor():
    """The kernel's buffer: the power of two >= K + 32 (a chunk of 32 hits
    fits after a cut to K), 64 to 1024 keys over K 17-768; a smaller
    emulated capacity is refused."""
    assert [warp_capacity(k) for k in (17, 32, 33, 96, 97, 266, 480, 768)] \
        == [64, 64, 128, 128, 256, 512, 512, 1024]
    q, s, qm, sm = as_tensors(*random_sphere(np.random.default_rng(7), 0.8))
    with pytest.raises(ValueError):
        radius_search_warp_reference(q, s, qm, sm, 0.8, 200, 231)


def test_warp_selection_equals_banded_pallas():
    """The fine lattice at K 200 through the JAX package's banded search in
    interpret mode (a band over the whole sphere: no overflow) and through
    the warp path's emulation with a buffer cut several times a query,
    its cuts inside groups of exact ties."""
    make, radius, k, capacity, _ = WARP_CASES["fine-lattice-k200-cap232"]
    q, s, qm, sm = make(np.random.default_rng(7), radius)
    order = np.argsort(s[:, :, 0], axis=1, kind="stable")
    s = np.take_along_axis(s, order[..., None], 1)
    sm = np.take_along_axis(sm, order, 1)
    idx, ovf = radius_search_banded(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm),
        jnp.asarray(q[:, :, 0]), jnp.asarray(s[:, :, 0]), radius=radius,
        max_count=k, band=2048, interpret=True)
    assert float(jnp.sum(ovf)) == 0.0
    got, cuts = radius_search_warp_reference(*as_tensors(q, s, qm, sm),
                                             radius, k, capacity)
    assert int(cuts.max()) >= 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(idx))
