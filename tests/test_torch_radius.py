"""Port kernel A (exact radius search), plain version on the CPU, against
the JAX package: the banded Pallas kernel in interpret mode (indices equal)
and the XLA `radius_search_fixed` (equal up to distances within rounding
of the radius, since it expands |q|^2 + |s|^2 - 2 q.s)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from weasal_tpu.ops.neighbors import radius_search_fixed as jax_fixed
from weasal_tpu.ops.pallas.radius_pallas import radius_search_banded
from weasal_tpu_torch.ops.cuda.radius_search import (radius_search,
                                                     radius_search_plain)
from weasal_tpu_torch.ops.neighbors import (radius_search as host_search,
                                            radius_search_fixed)
from tests._warm_torch import cpu_torch


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _problem(seed, b=2, nq=150, ns=400, spread=3.0, grid=False):
    rng = np.random.default_rng(seed)
    if grid:
        # integer coordinates: many exactly equal distances (ties)
        s = rng.integers(-3, 4, (b, ns, 3)).astype(np.float32)
    else:
        s = rng.uniform(-spread, spread, (b, ns, 3)).astype(np.float32)
    s = s[np.arange(b)[:, None], np.argsort(s[:, :, 0], axis=1,
                                            kind="stable")]
    q = s[:, rng.permutation(ns)[:nq]] + (
        0 if grid else rng.normal(0, 0.05, (b, nq, 3)).astype(np.float32))
    qm = rng.random((b, nq)) > 0.1
    sm = rng.random((b, ns)) > 0.1
    return q.astype(np.float32), s, qm, sm


def _banded(q, s, qm, sm, radius, k):
    idx, ovf = radius_search_banded(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(qm), jnp.asarray(sm),
        jnp.asarray(q[:, :, 0]), jnp.asarray(s[:, :, 0]), radius=radius,
        max_count=k, band=512, interpret=True)
    assert float(jnp.sum(ovf)) == 0.0
    return np.asarray(idx)


def _port(q, s, qm, sm, radius, k):
    return radius_search_plain(torch.from_numpy(q), torch.from_numpy(s),
                               torch.from_numpy(qm), torch.from_numpy(sm),
                               radius, k).numpy()


@pytest.mark.parametrize("seed,radius,k,grid,truncated", [
    (0, 1.1, 12, False, True),      # rows mostly full: K-truncation
    (1, 0.6, 40, False, False),     # partial rows: shadow padding
    (2, 1.5, 10, True, True),       # integer grid: exact distance ties
])
def test_plain_equals_banded_pallas(seed, radius, k, grid, truncated):
    q, s, qm, sm = _problem(seed, grid=grid)
    want = _banded(q, s, qm, sm, radius, k)
    got = _port(q, s, qm, sm, radius, k)
    np.testing.assert_array_equal(got, want)
    ns = s.shape[1]
    assert np.all(got[~qm] == ns)                       # masked queries
    for bi in range(q.shape[0]):
        real = got[bi][got[bi] < ns]
        assert sm[bi][real].all()                       # masked supports
    assert ((got < ns).sum(-1).max() == k) == truncated


def _assert_equal_up_to_rounding(got, want, q, s, radius, eps=1e-5):
    """Rows may differ only by supports whose d2 lies within eps*r^2 of
    r^2 (membership) or of the row's last kept distance (truncation)."""
    ns = s.shape[0]
    r2 = radius * radius
    q64, s64 = q.astype(np.float64), s.astype(np.float64)
    for i in np.where((got != want).any(axis=1))[0]:
        a, b = got[i][got[i] < ns], want[i][want[i] < ns]
        d2 = ((s64 - q64[i]) ** 2).sum(axis=1)
        edge = max(d2[a].max(initial=0.0), d2[b].max(initial=0.0))
        for j in np.setxor1d(a, b):
            assert (abs(d2[j] - r2) <= eps * r2
                    or abs(d2[j] - edge) <= eps * r2), (i, j, d2[j])
        for row in (a, b):                   # each row distance-sorted
            assert np.all(np.diff(d2[row]) >= -eps * r2)


def test_plain_matches_xla_fixed_up_to_boundary_rounding():
    q, s, qm, sm = _problem(3, b=1, nq=300, ns=600)
    radius, k = 1.0, 24
    got = _port(q, s, qm, sm, radius, k)[0]
    want = np.asarray(jax_fixed(jnp.asarray(q[0]), jnp.asarray(s[0]),
                                jnp.asarray(qm[0]), jnp.asarray(sm[0]),
                                radius, k))
    assert (got == want).mean() > 0.99
    _assert_equal_up_to_rounding(got, want, q[0], s[0], radius)


def test_wrapper_runs_plain_on_cpu_and_reports_no_overflow():
    q, s, qm, sm = _problem(4, b=1)
    t = [torch.from_numpy(a) for a in (q, s, qm, sm)]
    idx, overflow = radius_search(*t, 1.0, 8, band=128, margin=0.3)
    np.testing.assert_array_equal(idx.numpy(), _port(q, s, qm, sm, 1.0, 8))
    assert overflow.tolist() == [0.0]
    np.testing.assert_array_equal(radius_search_fixed(*t, 1.0, 8).numpy(),
                                  idx.numpy())


def test_host_search_rows_sorted_and_complete():
    q, s, _, _ = _problem(5, b=1, nq=80, ns=300)
    got = host_search(q[0], s[0], 0.9)
    ns = s.shape[1]
    d2 = ((q[0][:, None] - s[0][None]) ** 2).sum(-1)
    for i in range(q.shape[1]):
        real = got[i][got[i] < ns]
        np.testing.assert_array_equal(np.sort(real),
                                      np.where(d2[i] <= 0.81)[0])
        assert np.all(np.diff(d2[i][real]) >= 0)
