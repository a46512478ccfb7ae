"""Grid (voxel) subsampling: one point per occupied voxel, at the
barycenter of its members.

Counterpart of weasal_tpu/ops/subsample.py:
- `grid_subsample`: host numpy version (points only), voxel-linear
  output order;
- `grid_extent_cells` (:145): static per-axis voxel count bound;
- `grid_subsample_fixed` (:159): fixed-shape batched torch version used by
  the device pyramid.

The fixed version must reproduce the JAX masks bit for bit, because every
level above depends on them: min-corner origin over valid points,
``floor((p - origin) / dl)`` as a true division, clip to ``n_cells - 1``,
a stable sort of the voxel ids, and ``SHADOW_COORD`` padding. On CUDA the
barycenter sums go through ``scatter_add_``, whose order is not fixed, so
barycenters may differ in the last ulp from run to run (masks do not).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

SHADOW_COORD = 1e6


def grid_subsample(points: np.ndarray, dl: float) -> np.ndarray:
    """Voxel barycenters of one cloud, in linear voxel-id order."""
    points = np.asarray(points, dtype=np.float32)
    origin = points.min(axis=0)
    vox = np.floor((points - origin) / dl).astype(np.int64)
    dims = vox.max(axis=0) + 1
    lin = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
    uniq, inv, counts = np.unique(lin, return_inverse=True,
                                  return_counts=True)
    sub = np.zeros((uniq.shape[0], 3), dtype=np.float64)
    for d in range(3):
        sub[:, d] = np.bincount(inv, weights=points[:, d],
                                minlength=uniq.shape[0])
    sub /= counts[:, None]
    return sub.astype(np.float32)


def grid_extent_cells(in_radius: float, dl: float,
                      scale_max: float = 1.25) -> int:
    """Per-axis voxel count bound for sphere points in
    [-scale_max*r, scale_max*r]; +2 covers the min-corner floor offset."""
    return int(math.ceil(2.0 * max(scale_max, 1.0) * in_radius / dl)) + 2


def grid_subsample_fixed(points: torch.Tensor, mask: torch.Tensor,
                         dl: float, max_out: int, n_cells: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape voxel-barycenter subsample of a padded sphere batch.

    :param points: [B, N, 3] float32, padded rows arbitrary
    :param mask: [B, N] bool
    :param dl: voxel size; max_out: output rows per sphere (voxels beyond
        it are dropped); n_cells: per-axis bound (grid_extent_cells)
    :return: (sub_points [B, max_out, 3] with SHADOW_COORD padding,
        sub_mask [B, max_out] bool), voxels in linear-id order
    """
    b, n, _ = points.shape
    big = n_cells ** 3
    masked = torch.where(mask[..., None], points,
                         torch.full_like(points, math.inf))
    origin = masked.amin(dim=1, keepdim=True)                 # [B, 1, 3]
    # A device tensor divisor keeps this a true division on CUDA (a host
    # scalar there is turned into a multiplication by its reciprocal).
    dl_t = torch.tensor(dl, dtype=points.dtype, device=points.device)
    vox = torch.floor((points - origin) / dl_t)
    vox = vox.clamp(0, n_cells - 1).to(torch.int64)
    lin = (vox[..., 0] * n_cells + vox[..., 1]) * n_cells + vox[..., 2]
    lin = torch.where(mask, lin, torch.full_like(lin, big))

    sorted_lin, order = torch.sort(lin, dim=1, stable=True)
    sorted_pts = torch.gather(points, 1, order[..., None].expand(b, n, 3))
    valid = sorted_lin < big
    is_new = torch.ones_like(valid)
    is_new[:, 1:] = sorted_lin[:, 1:] != sorted_lin[:, :-1]
    is_new = is_new & valid
    seg = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    seg = torch.where(valid, seg.clamp(max=max_out),
                      torch.full_like(seg, max_out))

    sums = torch.zeros((b, max_out + 1, 3), dtype=points.dtype,
                       device=points.device)
    sums.scatter_add_(1, seg[..., None].expand(b, n, 3),
                      torch.where(valid[..., None], sorted_pts,
                                  torch.zeros_like(sorted_pts)))
    counts = torch.zeros((b, max_out + 1), dtype=points.dtype,
                         device=points.device)
    counts.scatter_add_(1, seg, valid.to(points.dtype))

    out_mask = counts[:, :max_out] > 0
    centers = sums[:, :max_out] / counts[:, :max_out, None].clamp(min=1.0)
    centers = torch.where(out_mask[..., None], centers,
                          torch.full_like(centers, SHADOW_COORD))
    return centers, out_mask
