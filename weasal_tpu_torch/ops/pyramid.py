"""Device-side multi-scale pyramid.

Counterpart of weasal_tpu/ops/pyramid.py: `_build_pyramid` (:90),
`build_pyramid_device` (:197), `batch_from_device_pyramid` (:241) and
`search_slot` (:61). Per level: a voxel subsample in the per-sphere
rotated frame, rotated back; then one radius search per conv, pool and
upsample edge (3L - 2 searches), in the order conv_l, pool_l, up_l.

The rotations are written as explicit per-component f32 sums (x, y, z in
order): a one-ulp difference moves a point across a voxel boundary and
changes the masks of every level above. The radius search is exact on
every device, so the overflow vector is all zeros.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from weasal_tpu_torch.data.batch import PyramidBatch
from weasal_tpu_torch.data.batching import ShapePlan, layer_radii
from weasal_tpu_torch.ops.neighbors import radius_search_fixed
from weasal_tpu_torch.ops.subsample import (grid_extent_cells,
                                            grid_subsample_fixed)


def search_slot(edge: str, l: int, L: int) -> int:
    """Slot of (edge, level) in the [3L-2] search-overflow vector:
    conv_0..conv_{L-1}, pool_0..pool_{L-2}, up_0..up_{L-2}."""
    return {"conv": l, "pool": L + l, "up": 2 * L - 1 + l}[edge]


def _rotate(pts: torch.Tensor, rot: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    """pts @ R ("bnd,bde->bne") or, with `transpose`, pts @ R^T
    ("bnd,bed->bne"), as per-component sums over d = x, y, z."""
    cols = []
    for e in range(3):
        acc = None
        for d in range(3):
            r = rot[:, e, d] if transpose else rot[:, d, e]
            term = pts[:, :, d] * r[:, None]
            acc = term if acc is None else acc + term
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _build_pyramid(points0: torch.Tensor, mask0: torch.Tensor,
                   rotations: Optional[torch.Tensor],
                   num_points: Sequence[int],
                   conv_neighbors: Sequence[int],
                   pool_neighbors: Sequence[int], up_neighbors: int,
                   dl0: float, conv_radii: Sequence[float],
                   pool_radii: Sequence[float], up_radii: Sequence[float],
                   in_radius: float, scale_max: float = 1.25):
    L = len(num_points)
    points = [points0]
    masks = [mask0]
    for l in range(L - 1):
        dl = dl0 * (2 ** (l + 1))
        n_cells = grid_extent_cells(in_radius, dl, scale_max)
        pts = points[l]
        if rotations is not None:
            pts = _rotate(pts, rotations, transpose=False)
        sub, sub_mask = grid_subsample_fixed(pts, masks[l], dl,
                                             num_points[l + 1], n_cells)
        if rotations is not None:
            sub = _rotate(sub, rotations, transpose=True)
        points.append(sub)
        masks.append(sub_mask)

    def search(lq, ls, r, k):
        return radius_search_fixed(points[lq], points[ls], masks[lq],
                                   masks[ls], r, k)

    neighbors, pools, upsamples = [], [], []
    for l in range(L):
        neighbors.append(search(l, l, conv_radii[l], conv_neighbors[l]))
        if l < L - 1:
            pools.append(search(l + 1, l, pool_radii[l], pool_neighbors[l]))
            upsamples.append(search(l, l + 1, up_radii[l], up_neighbors))
    overflow = torch.zeros(3 * L - 2, dtype=torch.float32,
                           device=points0.device)
    return (tuple(points), tuple(masks), tuple(neighbors), tuple(pools),
            tuple(upsamples), overflow)


def build_pyramid_device(points0: torch.Tensor, mask0: torch.Tensor,
                         config, plan: ShapePlan,
                         rotations: Optional[torch.Tensor] = None):
    """Pyramid of a padded sphere batch, on the tensors' device.

    :param points0: [B, N_0, 3] centered sphere points, padded rows masked
    :param mask0: [B, N_0] bool
    :param rotations: optional [B, 3, 3] per-sphere grid rotations
    :return: (points, masks, neighbors, pools, upsamples, overflow)
    """
    scale_max = max(
        1.25, float(getattr(config, "augment_scale_max", 1.0) or 1.0))
    conv_r, pool_r, up_r = layer_radii(config)
    return _build_pyramid(
        points0, mask0, rotations, tuple(plan.num_points),
        tuple(plan.conv_neighbors), tuple(plan.pool_neighbors),
        plan.up_neighbors, float(config.first_subsampling_dl),
        tuple(float(r) for r in conv_r), tuple(float(r) for r in pool_r),
        tuple(float(r) for r in up_r), float(config.in_radius),
        scale_max=scale_max)


def batch_from_device_pyramid(points0, mask0, features, labels, config,
                              plan: ShapePlan, center_pts, rotations=None,
                              cloud_lb=None, region_inds=None,
                              region_masks=None, region_point_masks=None,
                              region_lb=None) -> PyramidBatch:
    """A PyramidBatch whose levels are computed on the tensors' device."""
    points, masks, neighbors, pools, upsamples, overflow = \
        build_pyramid_device(points0, mask0, config, plan, rotations)
    lengths: Tuple[torch.Tensor, ...] = tuple(
        m.to(torch.int32).sum(dim=1, dtype=torch.int32) for m in masks)
    return PyramidBatch(
        points=points, masks=masks, neighbors=neighbors, pools=pools,
        upsamples=upsamples, features=features, labels=labels,
        lengths=lengths, center_pts=center_pts, cloud_lb=cloud_lb,
        region_inds=region_inds, region_masks=region_masks,
        region_point_masks=region_point_masks, region_lb=region_lb,
        search_overflow=overflow)
