"""Port device pyramid against the JAX `_build_pyramid`, on level-0 arrays
from `assemble_level0` of `demo_sphere` spheres, with grid rotations.

- masks of every level: bit-equal;
- points: level 0 equal; above it atol 4e-6 (about 4 ulp at the sphere's
  5 m scale): XLA on the CPU fuses the un-rotation's products into FMAs,
  the port rounds each product, as it does on the card;
- neighbors, pools and upsamples: equal to the banded Pallas search
  (interpret mode) run on the port's levels, except where two candidates'
  d2 lie within 1e-6 r^2 of each other (ties at f32 rounding: inside this
  jit, XLA on the CPU contracts the kernel's d2 sum into FMAs, which the
  port's plain version and CUDA kernel both avoid); against both JAX
  pyramids,
  equal up to supports whose distance lies within rounding of the radius
  or of the K-th distance (the XLA search expands |q|^2 + |s|^2 - 2 q.s,
  and the levels above 0 differ by the ulps above).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from weasal_tpu.ops.pallas.radius_pallas import radius_search_banded
from weasal_tpu.ops.pyramid import build_pyramid_device as jax_pyramid
from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data.batching import ShapePlan, layer_radii
from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
from weasal_tpu_torch.data.level0 import assemble_level0
from weasal_tpu_torch.ops.pyramid import (batch_from_device_pyramid,
                                          build_pyramid_device, search_slot)
from tests.test_torch_radius import _assert_equal_up_to_rounding
from tests._warm_torch import cpu_torch


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


class TinyConfig(Config):
    num_classes = 9
    in_features_dim = 4
    first_features_dim = 16
    in_radius = 5.0
    first_subsampling_dl = 0.5
    architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                    "resnetb_strided", "resnetb",
                    "nearest_upsample", "nearest_upsample"]
    use_pallas_search = False
    pallas_interpret = True
    pallas_band = 0


PLAN = ShapePlan(num_points=[440, 272, 120], conv_neighbors=[20, 26, 38],
                 pool_neighbors=[18, 23], max_regions=8,
                 max_region_points=64)


@pytest.fixture(scope="module")
def pyramids():
    cfg = TinyConfig()
    rng = np.random.default_rng(0)
    payloads = [thin_payload(demo_sphere(rng, cfg, density=8.0),
                             PLAN.num_points[0], rng) for _ in range(2)]
    arrays = assemble_level0(payloads, PLAN, cfg.num_classes, rng)
    port = build_pyramid_device(torch.from_numpy(arrays["points0"]),
                                torch.from_numpy(arrays["mask0"]), cfg, PLAN,
                                torch.from_numpy(arrays["rotations"]))
    jax_args = (jnp.asarray(arrays["points0"]), jnp.asarray(arrays["mask0"]),
                cfg, PLAN, jnp.asarray(arrays["rotations"]))
    xla = jax_pyramid(*jax_args)
    cfg.use_pallas_search = True
    banded = jax_pyramid(*jax_args)
    return cfg, arrays, port, xla, banded


@pytest.mark.parametrize("path", ["xla", "banded"])
def test_levels_match_jax(pyramids, path):
    _, _, port, xla, banded = pyramids
    want = xla if path == "xla" else banded
    for l in range(3):
        np.testing.assert_array_equal(port[1][l].numpy(),
                                      np.asarray(want[1][l]))
        np.testing.assert_allclose(port[0][l].numpy(),
                                   np.asarray(want[0][l]), rtol=0,
                                   atol=0 if l == 0 else 4e-6)
    assert port[5].tolist() == [0.0] * 7
    if path == "banded":
        assert float(jnp.sum(want[5])) == 0.0


def _edges(cfg):
    """(kind, level, query level, support level, radius, K) per edge."""
    conv_r, pool_r, up_r = layer_radii(cfg)
    return ([(2, l, l, l, conv_r[l], PLAN.conv_neighbors[l])
             for l in range(3)]
            + [(3, l, l + 1, l, pool_r[l], PLAN.pool_neighbors[l])
               for l in range(2)]
            + [(4, l, l, l + 1, up_r[l], PLAN.up_neighbors)
               for l in range(2)])


def test_indices_equal_banded_search(pyramids):
    cfg, _, port, _, _ = pyramids
    pts = [p.numpy() for p in port[0]]
    msk = [m.numpy() for m in port[1]]
    for kind, l, lq, ls, r, k in _edges(cfg):
        want, ovf = radius_search_banded(
            jnp.asarray(pts[lq]), jnp.asarray(pts[ls]), jnp.asarray(msk[lq]),
            jnp.asarray(msk[ls]), jnp.asarray(pts[lq][:, :, 0]),
            jnp.asarray(pts[ls][:, :, 0]), radius=r, max_count=k, band=512,
            interpret=True)
        assert float(jnp.sum(ovf)) == 0.0
        got, want = port[kind][l].numpy(), np.asarray(want)
        assert (got != want).mean() < 1e-3
        for b in range(got.shape[0]):
            _assert_equal_up_to_rounding(got[b], want[b], pts[lq][b],
                                         pts[ls][b], r, eps=1e-6)


@pytest.mark.parametrize("path", ["xla", "banded"])
def test_indices_match_jax_pyramid_up_to_rounding(pyramids, path):
    cfg, _, port, xla, banded = pyramids
    want_pyr = xla if path == "xla" else banded
    pts = [p.numpy() for p in port[0]]
    for kind, l, lq, ls, r, _ in _edges(cfg):
        got, want = port[kind][l].numpy(), np.asarray(want_pyr[kind][l])
        assert (got == want).mean() > 0.98
        for b in range(got.shape[0]):
            _assert_equal_up_to_rounding(got[b], want[b], pts[lq][b],
                                         pts[ls][b], r)


def test_batch_from_device_pyramid(pyramids):
    cfg, arrays, port, _, _ = pyramids
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    batch = batch_from_device_pyramid(
        t["points0"], t["mask0"], t["features"], t["labels"], cfg, PLAN,
        t["center_pts"], rotations=t["rotations"], cloud_lb=t["cloud_lb"])
    assert batch.num_layers == 3 and batch.batch_size == 2
    for l in range(3):
        assert batch.lengths[l].tolist() == port[1][l].sum(1).tolist()
        assert batch.lengths[l].dtype == torch.int32
    assert [search_slot(e, l, 3) for e, l in
            (("conv", 0), ("conv", 2), ("pool", 0), ("up", 1))] == [0, 2, 3, 6]
