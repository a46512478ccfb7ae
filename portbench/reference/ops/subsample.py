"""Grid (voxel) subsampling: one point per occupied voxel, at the
barycenter of its members.

Counterpart of weasal_tpu/ops/subsample.py:
- `grid_subsample` (:52): host version, voxel-linear output order, with
  optional features (voxel means) and labels (voxel majority); it runs
  the native library (ops/native.py) where that is available, as the
  JAX package does (:63-66), else `grid_subsample_numpy` (:69), which
  gives the same result bit for bit (both sum each voxel in f64 in point
  order);
- `grid_extent_cells` (:145): static per-axis voxel count bound;
- `grid_subsample_fixed` (:159): fixed-shape batched torch version used by
  the device pyramid.

The fixed version must reproduce the JAX masks bit for bit, because every
level above depends on them: min-corner origin over valid points,
``floor((p - origin) / dl)`` as a true division, clip to ``n_cells - 1``,
a stable sort of the voxel ids, and ``SHADOW_COORD`` padding. Each
voxel's members are summed in their stable-sorted order from 0.0 by the
fixed-order row sums over each voxel's run (`run_sums`), so the
barycenters repeat bit for bit from run to run: a last bit that moved
could carry a point across a voxel or radius boundary at a later level,
and the pyramid would differ in its structure, not by rounding.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from portbench.reference.ops import native

SHADOW_COORD = 1e6


def grid_subsample(points: np.ndarray, dl: float, *,
                   features: Optional[np.ndarray] = None,
                   labels: Optional[np.ndarray] = None):
    """Voxel barycenters of one cloud, in linear voxel-id order; with
    `features`, their voxel means, and with `labels`, the voxel majority
    (ties to the smallest label). Returns the points alone, or the tuple
    (points[, features][, labels]). Sums in f64, results in f32."""
    if native.available():
        return native.grid_subsample_native(points, dl, features=features,
                                            labels=labels)
    return grid_subsample_numpy(points, dl, features=features,
                                labels=labels)


def grid_subsample_numpy(points: np.ndarray, dl: float, *,
                         features: Optional[np.ndarray] = None,
                         labels: Optional[np.ndarray] = None):
    """The numpy version of `grid_subsample` (its oracle)."""
    points = np.asarray(points, dtype=np.float32)
    origin = points.min(axis=0)
    vox = np.floor((points - origin) / dl).astype(np.int64)
    dims = vox.max(axis=0) + 1
    lin = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
    uniq, inv, counts = np.unique(lin, return_inverse=True,
                                  return_counts=True)
    n_out = uniq.shape[0]
    sub = np.zeros((n_out, 3), dtype=np.float64)
    for d in range(3):
        sub[:, d] = np.bincount(inv, weights=points[:, d], minlength=n_out)
    sub /= counts[:, None]
    out = [sub.astype(np.float32)]

    if features is not None:
        features = np.asarray(features, dtype=np.float32)
        if features.ndim == 1:
            features = features[:, None]
        sub_feat = np.zeros((n_out, features.shape[1]), dtype=np.float64)
        for d in range(features.shape[1]):
            sub_feat[:, d] = np.bincount(inv, weights=features[:, d],
                                         minlength=n_out)
        sub_feat /= counts[:, None]
        out.append(sub_feat.astype(np.float32))

    if labels is not None:
        labels = np.squeeze(np.asarray(labels)).astype(np.int64)
        n_lbl = int(labels.max()) + 1 if labels.size else 1
        votes = np.zeros((n_out, n_lbl), dtype=np.int64)
        np.add.at(votes, (inv, labels), 1)
        out.append(np.argmax(votes, axis=1).astype(np.int32))

    return out[0] if len(out) == 1 else tuple(out)


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
    # scalar there is turned into a multiplication by its reciprocal);
    # filled on the device, so no host copy (none is allowed while a CUDA
    # graph captures)
    dl_t = torch.full((), dl, dtype=points.dtype, device=points.device)
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

    sums, counts = run_sums(
        torch.where(valid[..., None], sorted_pts,
                    torch.zeros_like(sorted_pts)), seg, max_out)

    out_mask = counts > 0
    centers = sums / counts[..., None].clamp(min=1.0)
    centers = torch.where(out_mask[..., None], centers,
                          torch.full_like(centers, SHADOW_COORD))
    return centers, out_mask


def run_sums(src: torch.Tensor, seg: torch.Tensor, n_out: int):
    """(sums [B, n_out, C], counts [B, n_out]) of the runs of a
    non-decreasing seg [B, N] (a value of n_out or more is dropped): each
    run's rows added one after another from 0.0 in row order, on any
    device (as the CPU's `scatter_add_` does). Each run's bounds are the lower bounds of j and j + 1 in seg;
    a loop over the ranks within the runs adds one row to every run a
    pass. Reads the longest run back to the host."""
    b, n, c = src.shape
    seg = seg.clamp(max=n_out).contiguous()
    ids = torch.arange(n_out + 1, device=seg.device,
                       dtype=seg.dtype).expand(b, n_out + 1).contiguous()
    bounds = torch.searchsorted(seg, ids)
    start, lens = bounds[:, :-1], bounds[:, 1:] - bounds[:, :-1]
    sums = torch.zeros((b, n_out, c), dtype=src.dtype, device=src.device)
    width = int(lens.max()) if lens.numel() else 0
    for j in range(width):
        row = (start + j).clamp(max=n - 1)[..., None].expand(b, n_out, c)
        term = torch.gather(src, 1, row)
        sums = sums + torch.where((lens > j)[..., None], term,
                                  torch.zeros_like(term))
    return sums, lens.to(src.dtype)
