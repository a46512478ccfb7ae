"""JAX's threefry normal draws as plain tensor ops.

Counterpart of `jax.random.normal(jax.random.PRNGKey(seed), shape,
jnp.float32)` (JAX 0.9, `jax_threefry_partitionable` on, its default),
which the JAX package's resident assembly draws its jitter from
(weasal_tpu/data/resident.py:309-312):

- the key of a 32-bit seed is (0, seed);
- element i of the flattened shape is threefry2x32(key, (hi, lo)) of the
  64-bit counter i split into words, and its 32 random bits are the two
  output words XORed;
- the top 23 bits become a uniform on [nextafter(-1, 0), 1), and the
  normal is sqrt(2) * erfinv(u), with XLA's f32 erfinv (M. Giles'
  single-precision polynomials in w = -log1p(-u^2)).

The 32-bit words live in int64 tensors masked to 32 bits, so every
operation is an integer add, shift, or, xor or and on the seeds' device:
nothing reads back to the host and no generator object is involved, so
the same code runs on the CPU, on the card and inside a captured CUDA
graph. The bits equal JAX's; the normals differ from JAX's by a few ulp
(log1p and the multiply-adds round differently).
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# nextafter(-1, 0) in f32
_LO = -1.0 + 2.0 ** -24
# XLA's ErfInv32 coefficients, highest degree first: for w < 5 in w - 2.5,
# else in sqrt(w) - 3
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key words (k0, k1); all int64 tensors holding uint32 values, the keys
    broadcast against the counters. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _horner(coeffs, w: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = p * w + c
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erfinv: Giles' polynomials, +-inf at +-1."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    p = torch.where(small, _horner(_ERFINV_SMALL, w - 2.5),
                    _horner(_ERFINV_LARGE, torch.sqrt(w) - 3.0))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def random_bits(seeds: torch.Tensor, n: int, stream: int = 0,
                offset: int = 0) -> torch.Tensor:
    """[S, n] int64 holding the uint32 bits `jax.random.bits` draws for a
    key made from each 32-bit seed of `seeds` [S] (any integer dtype,
    values in [0, 2^32)) over n elements, on the seeds' device. The key
    is (stream, seed): stream 0 is `jax.random.PRNGKey(seed)`'s; other
    streams give independent bits from the same seed. With `offset` the
    draw is elements [offset, offset + n) of a longer one: element i's
    counter is i whatever the length (`jax_threefry_partitionable`), so a
    rank draws its slice of a global mask alone."""
    seeds = seeds.to(torch.int64).reshape(-1, 1) & _MASK
    counter = torch.arange(offset, offset + n, dtype=torch.int64,
                           device=seeds.device)
    hi = (counter >> 32)[None, :]
    lo = (counter & _MASK)[None, :]
    y0, y1 = threefry2x32(torch.full_like(seeds, stream & _MASK), seeds,
                          hi, lo)
    return y0 ^ y1


def uniform(seeds: torch.Tensor, n: int, stream: int = 0,
            offset: int = 0) -> torch.Tensor:
    """[S, n] f32 uniforms on [0, 1) from `random_bits` (elements
    [offset, offset + n)), as `jax.random.uniform` makes them: the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(seeds, n, stream, offset)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def normal(seeds: torch.Tensor, shape) -> torch.Tensor:
    """[S, *shape] f32 standard normals, row s equal to
    `jax.random.normal(jax.random.PRNGKey(seeds[s]), shape, float32)` up
    to erfinv rounding."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    bits = random_bits(seeds, n)
    # 23 mantissa bits under the exponent of 1.0: a float in [1, 2)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    # uniform on [lo, 1): floats * (1 - lo) + lo, where 1 - lo rounds to
    # 2 in f32, then max(lo, .)
    u = torch.clamp(floats * 2.0 + _LO, min=_LO)
    z = erfinv(u) * math.sqrt(2.0)
    return z.reshape(-1, *shape)
