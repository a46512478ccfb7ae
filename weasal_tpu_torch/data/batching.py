"""Shape plan and the host-side sphere pyramid used to calibrate it.

Counterpart of weasal_tpu/data/batching.py: `ShapePlan` (:36),
`fill_region_row` (:110), `grid_rotations` (:138), `layer_radii` (:160),
`build_sphere_pyramid` (:183) and `calibrate_shape_plan` (:236), running
on the port's own host subsample and radius search. Random draws follow
the JAX package's order, so one numpy seed gives both packages the same
plan. The small-sphere bucket is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from weasal_tpu_torch.kernels.kernel_points import create_3d_rotations
from weasal_tpu_torch.ops.neighbors import radius_search
from weasal_tpu_torch.ops.subsample import grid_subsample


@dataclasses.dataclass
class ShapePlan:
    """Static shape budgets for one config's pyramid."""
    num_points: List[int]          # N_l per level
    conv_neighbors: List[int]      # K_l per level
    pool_neighbors: List[int]      # width of pools[l] (levels 0..L-2)
    up_neighbors: int = 1          # only column 0 is read (closest_pool)
    max_regions: int = 0           # R (weak-label sub-regions per sphere)
    max_region_points: int = 0     # P (points per sub-region)

    @property
    def num_layers(self) -> int:
        return len(self.num_points)


def fill_region_row(region_inds_b: np.ndarray,
                    region_point_masks_b: np.ndarray,
                    region_masks_b: np.ndarray,
                    region_lb_b: np.ndarray,
                    regions, limit: int,
                    rng: np.random.Generator) -> None:
    """Fill one sphere's rows of the padded region tables: drop members
    past the kept-point `limit`, random-subsample crowded regions to P."""
    R, P = region_inds_b.shape
    for ri, (inds, lb) in enumerate((regions or [])[:R]):
        inds = np.asarray(inds, dtype=np.int64)
        inds = inds[inds < limit]
        if inds.size == 0:
            continue
        if inds.size > P:
            inds = rng.choice(inds, size=P, replace=False)
        region_inds_b[ri, :inds.size] = inds
        region_point_masks_b[ri, :inds.size] = True
        region_masks_b[ri] = True
        region_lb_b[ri] = lb


def grid_rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 3, 3] random vertical-axis rotations for voxel de-aliasing."""
    theta = rng.random(n) * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rotations = np.zeros((n, 3, 3), np.float32)
    rotations[:, 0, 0] = c
    rotations[:, 0, 1] = -s
    rotations[:, 1, 0] = s
    rotations[:, 1, 1] = c
    rotations[:, 2, 2] = 1.0
    return rotations


def _round_up(x, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def layer_radii(config) -> Tuple[List[float], List[float], List[float]]:
    """Per-level (conv, pool, upsample) radii in meters: r_l = dl_l *
    conv_radius with dl_l = first_subsampling_dl * 2^l; deform layers
    widen by deform_radius / conv_radius."""
    conv_r, pool_r, up_r = [], [], []
    r_normal = config.first_subsampling_dl * config.conv_radius
    deform_layers = getattr(config, "deform_layers", None) or \
        [False] * config.num_layers
    for l in range(config.num_layers):
        if deform_layers[l]:
            r = r_normal * config.deform_radius / config.conv_radius
        else:
            r = r_normal
        conv_r.append(r)
        pool_r.append(r)
        up_r.append(2 * r_normal)
        r_normal *= 2
    return conv_r, pool_r, up_r


def build_sphere_pyramid(points: np.ndarray, config,
                         rng: Optional[np.random.Generator] = None,
                         max_neighbors: Optional[Sequence[int]] = None,
                         max_pool_neighbors: Optional[Sequence[int]] = None,
                         random_grid_orient: bool = True,
                         with_upsamples: bool = True) -> Dict:
    """Host pyramid of one sphere: per-level points ('points') and index
    lists ('neighbors' into level l, 'pools' from l+1 into l, 'upsamples'
    from l into l+1). Widths follow the data unless capped."""
    rng = rng or np.random.default_rng()
    conv_r, pool_r, up_r = layer_radii(config)
    L = config.num_layers

    level_points = [np.asarray(points, dtype=np.float32)]
    for l in range(L - 1):
        dl = config.first_subsampling_dl * (2 ** (l + 1))
        pts = level_points[l]
        if random_grid_orient:
            theta = rng.random() * 2 * np.pi
            phi = (rng.random() - 0.5) * np.pi
            u = np.array([[np.cos(theta) * np.cos(phi),
                           np.sin(theta) * np.cos(phi),
                           np.sin(phi)]])
            alpha = np.array([rng.random() * 2 * np.pi])
            R = create_3d_rotations(u, alpha)[0].astype(np.float32)
            sub = grid_subsample(pts @ R.T, dl=dl) @ R
        else:
            sub = grid_subsample(pts, dl=dl)
        level_points.append(sub.astype(np.float32))

    neighbors, pools, upsamples = [], [], []
    for l in range(L):
        cap = max_neighbors[l] if max_neighbors is not None else 0
        neighbors.append(radius_search(level_points[l], level_points[l],
                                       conv_r[l], max_count=cap))
        if l < L - 1:
            pool_cap = (max_pool_neighbors[l]
                        if max_pool_neighbors is not None else cap)
            pools.append(radius_search(level_points[l + 1], level_points[l],
                                       pool_r[l], max_count=pool_cap))
            if with_upsamples:
                upsamples.append(radius_search(
                    level_points[l], level_points[l + 1], up_r[l],
                    max_count=1))
    return {"points": level_points, "neighbors": neighbors,
            "pools": pools, "upsamples": upsamples}


def calibrate_shape_plan(sphere_point_clouds: Sequence[np.ndarray], config,
                         untouched_ratio: float = 0.9,
                         point_percentile: float = 100.0,
                         region_budget: Tuple[int, int] = (0, 0),
                         rng: Optional[np.random.Generator] = None
                         ) -> ShapePlan:
    """Static budgets from sampled spheres: N_l at `point_percentile` of
    the level-0 counts (p100 above level 0), padded ~10% and rounded up to
    a multiple of 8; K_l keeps `untouched_ratio` of neighborhoods whole."""
    rng = rng or np.random.default_rng(0)
    L = config.num_layers
    counts: List[List[int]] = [[] for _ in range(L)]
    conv_hist: List[List[np.ndarray]] = [[] for _ in range(L)]
    pool_hist: List[List[np.ndarray]] = [[] for _ in range(L - 1)]

    for pts in sphere_point_clouds:
        pyr = build_sphere_pyramid(pts, config, rng=rng)
        for l in range(L):
            n_s = pyr["points"][l].shape[0]
            counts[l].append(n_s)
            conv_hist[l].append(np.sum(pyr["neighbors"][l] < n_s, axis=1))
        for l in range(L - 1):
            n_s = pyr["points"][l].shape[0]
            pool_hist[l].append(np.sum(pyr["pools"][l] < n_s, axis=1))

    def percentile_width(rows: List[np.ndarray]) -> int:
        return int(np.quantile(np.concatenate(rows), untouched_ratio)) + 1

    num_points = [
        _round_up(np.percentile(counts[l],
                                point_percentile if l == 0 else 100.0)
                  * 1.1 + 1, 8)
        for l in range(L)]
    return ShapePlan(
        num_points=num_points,
        conv_neighbors=[percentile_width(conv_hist[l]) for l in range(L)],
        pool_neighbors=[percentile_width(pool_hist[l])
                        for l in range(L - 1)],
        max_regions=region_budget[0],
        max_region_points=region_budget[1])
