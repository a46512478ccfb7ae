"""The port's threefry draws (weasal_tpu_torch/utils/prng.py) against
`jax.random` on the CPU.

- the random bits equal `jax.random.bits(PRNGKey(seed), shape, uint32)`
  exactly, for several seeds (0, small, large, 2^31 - 1, 2^32 - 1) and
  shapes, all seeds of a shape in one call;
- the normals are within 4 ulp of `jax.random.normal(PRNGKey(seed),
  shape, float32)` (the same bits and XLA's erfinv polynomials; log1p and
  the multiply-adds may round differently), and within 1e-6 absolute;
- the test also pins the mode it reproduces: JAX's
  `jax_threefry_partitionable` flag is on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weasal_tpu_torch.utils import prng

SEEDS = np.array([0, 1, 5, 123456789, 2 ** 31 - 1, 2 ** 32 - 1],
                 dtype=np.uint32)
SHAPES = [(1,), (7, 3), (1000, 3), (4, 5, 6)]
ULP = 4


def test_jax_runs_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_equal_jax(shape):
    want = np.stack([np.asarray(jax.random.bits(
        jax.random.PRNGKey(s), shape, jnp.uint32)).reshape(-1)
        for s in SEEDS]).astype(np.int64)
    got = prng.random_bits(torch.from_numpy(SEEDS.astype(np.int64)),
                           int(np.prod(shape)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_normals_within_a_few_ulp_of_jax(shape):
    want = np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), shape, jnp.float32)) for s in SEEDS])
    got = prng.normal(torch.from_numpy(SEEDS.astype(np.int64)),
                      shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= ULP, ulps.max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_seed_dtypes_agree():
    """int32 and int64 seed tensors (the loader ships int64) draw alike."""
    a = prng.normal(torch.tensor([3, 9], dtype=torch.int32), (5, 3))
    b = prng.normal(torch.tensor([3, 9], dtype=torch.int64), (5, 3))
    assert torch.equal(a, b)


def test_erfinv_edges_equal_jax():
    x = np.array([-1.0, -0.5, 0.0, 0.5, 1.0], np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erfinv(torch.from_numpy(x)).numpy()
    assert np.isinf(want[[0, 4]]).all()
    np.testing.assert_array_equal(got[[0, 2, 4]], want[[0, 2, 4]])
    np.testing.assert_allclose(got, want, rtol=1e-6)
