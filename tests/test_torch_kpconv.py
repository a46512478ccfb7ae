"""Port kernel B (rigid KPConv forward), plain version on the CPU, and the
pooling ops against the JAX package.

Tolerances, f32:
- against the XLA path (same direct differences s - q - kp): rtol 1e-4,
  atol 1e-5; only the summation order differs (einsum and a folded GEMM
  here, XLA's dots there);
- against the banded Pallas kernel: rtol 2e-4, atol 2e-4, the bound the
  JAX package holds that kernel to against its own XLA path
  (tests/test_kpconv_banded.py). The kernel expands |s - q - kp|^2
  separably, whose cancellation error is amplified by the square root
  near d = 0 (measured here: 2.4e-5 at outputs of order 1).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from weasal_tpu.ops import kpconv as jops
from weasal_tpu.ops.pallas.kpconv_banded import kpconv_banded
from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd
from tests._warm_torch import cpu_torch


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _problem(seed, b=2, nq=90, ns=240, k=12, kp=15, cin=8, cout=16):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.uniform(-2, 2, (b, ns, 3)).astype(np.float32), axis=1)
    q = (s[:, :nq] + rng.normal(0, 0.05, (b, nq, 3))).astype(np.float32)
    # neighbor lists with shadow entries (index ns)
    nb = rng.integers(0, ns + 1, (b, nq, k)).astype(np.int32)
    nb[:, :, -2:] = ns
    x = rng.normal(size=(b, ns, cin)).astype(np.float32)
    kpts = rng.uniform(-0.6, 0.6, (kp, 3)).astype(np.float32)
    w = (rng.normal(size=(kp, cin, cout)) / np.sqrt(cin)).astype(np.float32)
    return q, s, nb, x, kpts, w


def _port(args, extent, influence):
    t = [torch.from_numpy(a) for a in args]
    return ops.kpconv(*t, ops.KPConvParams(kp_extent=extent,
                                           influence=influence)).numpy()


@pytest.mark.parametrize("influence", ["linear", "constant", "gaussian"])
def test_kpconv_matches_jax_xla(influence):
    args = _problem(0)
    want, _ = jops.kpconv(*[jnp.asarray(a) for a in args],
                          jops.KPConvParams(kp_extent=0.9,
                                            influence=influence))
    np.testing.assert_allclose(_port(args, 0.9, influence),
                               np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("influence", ["linear", "constant", "gaussian"])
def test_kpconv_matches_jax_banded_pallas(influence):
    args = _problem(1)
    want, oob = kpconv_banded(*[jnp.asarray(a) for a in args], 0.9,
                              influence=influence, interpret=True)
    assert float(jnp.sum(oob)) == 0.0
    np.testing.assert_allclose(_port(args, 0.9, influence),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def test_kernel_wrapper_on_cpu_is_the_plain_version():
    args = _problem(2)
    t = [torch.from_numpy(a) for a in args]
    out, oob = kpconv_fwd(*t, 0.9, "linear", band=256, tile=128)
    np.testing.assert_array_equal(out.numpy(), _port(args, 0.9, "linear"))
    assert oob.tolist() == [0.0, 0.0]


def test_unported_variants_raise():
    """'closest' aggregation is ported (`kpconv_dense`; equal to the JAX
    XLA path at rtol 1e-4, atol 1e-5, as the sum convs above); an
    unknown aggregation or influence, and a deformable conv without its
    offsets, raise."""
    args = _problem(3)
    t = [torch.from_numpy(a) for a in args]
    want, _ = jops.kpconv(*[jnp.asarray(a) for a in args],
                          jops.KPConvParams(0.9, aggregation="closest"))
    got = ops.kpconv(*t, ops.KPConvParams(0.9, aggregation="closest"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError):
        ops.kpconv(*t, ops.KPConvParams(0.9, aggregation="max"))
    with pytest.raises(ValueError):
        ops.kpconv(*t, ops.KPConvParams(0.9, influence="cubic"))
    with pytest.raises(ValueError):
        ops.kpconv(*t, ops.KPConvParams(0.9, deformable=True))


def test_pooling_ops_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 50, 6)).astype(np.float32)
    inds = rng.integers(0, 51, (2, 30, 7)).astype(np.int32)
    mask = rng.random((2, 50)) > 0.3
    tx, ti = torch.from_numpy(x), torch.from_numpy(inds)
    np.testing.assert_array_equal(
        ops.max_pool(tx, ti).numpy(),
        np.asarray(jops.max_pool(jnp.asarray(x), jnp.asarray(inds),
                                 route="dense")))
    np.testing.assert_array_equal(
        ops.closest_pool(tx, ti).numpy(),
        np.asarray(jops.closest_pool(jnp.asarray(x), jnp.asarray(inds))))
    np.testing.assert_allclose(
        ops.global_average(tx, torch.from_numpy(mask)).numpy(),
        np.asarray(jops.global_average(jnp.asarray(x), jnp.asarray(mask))),
        rtol=1e-6, atol=1e-6)


def test_max_pool_rejects_unknown_routes(monkeypatch):
    t = torch.zeros(1, 4, 2)
    i = torch.zeros(1, 3, 2, dtype=torch.int32)
    for route in ("argmax", "banded"):
        monkeypatch.setenv("WEASAL_MAXPOOL", route)
        with pytest.raises(ValueError):
            ops.max_pool(t, i)
    monkeypatch.setenv("WEASAL_MAXPOOL", "dense")
    assert ops.max_pool(t, i).shape == (1, 3, 2)
