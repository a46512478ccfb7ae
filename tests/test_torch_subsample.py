"""Port host-side data modules and the fixed-shape subsample against the
JAX package, on identical numpy inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from weasal_tpu.data import batching as jbatching
from weasal_tpu.data.level0 import assemble_level0 as jax_level0
from weasal_tpu.kernels.kernel_points import load_kernels as jax_kernels
from weasal_tpu.ops.subsample import (grid_extent_cells as jax_cells,
                                      grid_subsample_fixed as jax_fixed,
                                      grid_subsample_numpy)
from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data import batching
from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
from weasal_tpu_torch.data.level0 import assemble_level0
from weasal_tpu_torch.kernels.kernel_points import load_kernels
from weasal_tpu_torch.ops.subsample import (SHADOW_COORD, grid_extent_cells,
                                            grid_subsample,
                                            grid_subsample_fixed)
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


def _padded_spheres(seed, b=2, n=700, r=5.0):
    rng = np.random.default_rng(seed)
    pts = np.full((b, n, 3), SHADOW_COORD, np.float32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        k = n - 60 * i
        pts[i, :k] = rng.uniform(-r, r, (k, 3)).astype(np.float32)
        mask[i, :k] = True
    return pts, mask


@pytest.mark.parametrize("dl,max_out", [(0.5, 512), (1.0, 200), (2.0, 40)])
def test_grid_subsample_fixed_matches_jax(dl, max_out):
    pts, mask = _padded_spheres(0)
    n_cells = grid_extent_cells(5.0, dl)
    assert n_cells == jax_cells(5.0, dl)
    got_p, got_m = grid_subsample_fixed(torch.from_numpy(pts),
                                        torch.from_numpy(mask), dl,
                                        max_out, n_cells)
    want = jax.vmap(lambda p, m: jax_fixed(p, m, dl, max_out, n_cells))(
        jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want[0]),
                               rtol=0, atol=1e-6)


def test_host_grid_subsample_matches_numpy_reference():
    pts, _ = _padded_spheres(1, b=1)
    np.testing.assert_array_equal(grid_subsample(pts[0], 0.7),
                                  grid_subsample_numpy(pts[0], dl=0.7))


def test_load_kernels_same_pose_as_jax(tmp_path):
    for seed in (0, 12345):
        got = load_kernels(1.5, 15, 3, "center",
                           rng=np.random.default_rng(seed))
        want = jax_kernels(1.5, 15, 3, "center",
                           rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
    # a size without a shipped disposition is generated, as the JAX
    # package generates it from the same rng, each into a directory of
    # its own (Lloyd relaxation here, the quick generator)
    got = load_kernels(1.0, 17, 3, "center", lloyd=True,
                       rng=np.random.default_rng(4),
                       dispositions_dir=str(tmp_path / "torch"))
    want = jax_kernels(1.0, 17, 3, "center", lloyd=True,
                       rng=np.random.default_rng(4),
                       dispositions_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(got, want)


def test_helpers_match_jax():
    cfg = TinyConfig()
    assert cfg.num_layers == 3
    assert batching.layer_radii(cfg) == jbatching.layer_radii(cfg)
    np.testing.assert_array_equal(
        batching.grid_rotations(np.random.default_rng(3), 4),
        jbatching.grid_rotations(np.random.default_rng(3), 4))


def test_assemble_level0_matches_jax():
    cfg = TinyConfig()
    rng = np.random.default_rng(0)
    payloads = [demo_sphere(rng, cfg, density=8.0) for _ in range(2)]
    plan = batching.ShapePlan(num_points=[300, 200, 100],
                              conv_neighbors=[20, 20, 20],
                              pool_neighbors=[20, 20], max_regions=8,
                              max_region_points=32)
    payloads = [thin_payload(p, 300, rng) for p in payloads]
    copies = [dict(p) for p in payloads]
    got = assemble_level0(payloads, plan, 9, np.random.default_rng(7))
    want = jax_level0(copies, plan, 9, np.random.default_rng(7))
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_calibrate_shape_plan_matches_jax():
    cfg = TinyConfig()
    rng = np.random.default_rng(2)
    clouds = [demo_sphere(rng, cfg, density=8.0)["points"] for _ in range(3)]
    got = batching.calibrate_shape_plan(clouds, cfg, region_budget=(8, 64),
                                        rng=np.random.default_rng(5))
    want = jbatching.calibrate_shape_plan(clouds, cfg, region_budget=(8, 64),
                                          rng=np.random.default_rng(5))
    for field in ("num_points", "conv_neighbors", "pool_neighbors",
                  "up_neighbors", "max_regions", "max_region_points"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("dl,max_out", [(0.5, 400), (0.9, 60)])
def test_voxel_sums_in_sorted_order(dl, max_out):
    """The card's voxel sums (`run_sums`: each voxel's run of the stable
    sort added in order from 0.0, its rows [lo, hi) the lower bounds of j
    and j + 1 in the sphere's seg row, as `run_sum_kernel` searches them)
    equal the CPU's `scatter_add_` bit for bit; the second case drops
    voxels past max_out."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import run_sums_plain
    rng = np.random.default_rng(3)
    b, n = 3, 900
    pts = torch.from_numpy(
        (rng.random((b, n, 3)) * 8 - 4).astype(np.float32))
    mask = torch.from_numpy(rng.random((b, n)) < 0.8)
    n_cells = grid_extent_cells(4.0, dl)
    origin = torch.where(mask[..., None], pts,
                         torch.full_like(pts, np.inf)).amin(dim=1,
                                                           keepdim=True)
    vox = torch.floor((pts - origin) / dl).clamp(0, n_cells - 1).long()
    lin = (vox[..., 0] * n_cells + vox[..., 1]) * n_cells + vox[..., 2]
    lin = torch.where(mask, lin, torch.full_like(lin, n_cells ** 3))
    sorted_lin, order = torch.sort(lin, dim=1, stable=True)
    src = torch.gather(pts, 1, order[..., None].expand(b, n, 3))
    valid = sorted_lin < n_cells ** 3
    is_new = torch.ones_like(valid)
    is_new[:, 1:] = sorted_lin[:, 1:] != sorted_lin[:, :-1]
    seg = torch.cumsum((is_new & valid).long(), dim=1) - 1
    seg = torch.where(valid, seg.clamp(max=max_out),
                      torch.full_like(seg, max_out))
    src = torch.where(valid[..., None], src, torch.zeros_like(src))
    want_sums, want_counts = run_sums_plain(src, seg, max_out)
    bounds = np.stack([np.searchsorted(row, np.arange(max_out + 1))
                       for row in seg.numpy()]) + np.arange(b)[:, None] * n
    lo, hi = bounds[:, :-1].reshape(-1), bounds[:, 1:].reshape(-1)
    flat = src.reshape(-1, 3)
    sums = torch.zeros((b * max_out, 3))
    for r in range(b * max_out):
        for e in range(int(lo[r]), int(hi[r])):
            sums[r] = sums[r] + flat[e]
    assert torch.equal(sums.reshape(b, max_out, 3), want_sums)
    assert torch.equal(torch.from_numpy(hi - lo).float().reshape(b, max_out),
                       want_counts)
    assert int((want_counts > 0).sum()) > b * 10
