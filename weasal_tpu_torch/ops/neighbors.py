"""Radius neighbor search: distance-sorted rows, shadow index = Ns.

Counterpart of weasal_tpu/ops/neighbors.py:
- `radius_search` (:30): host version; a fixed width runs the native
  library (ops/native.py) where that is available, as the JAX package
  does (:50-56), else `radius_search_scipy` (:59, cKDTree), as does a
  width taken from the data (calibration). The native search compares
  f32 squared distances with the radius, cKDTree f64 distances: the two
  differ only for supports within rounding of the radius;
- `query_radius`: sklearn's `KDTree.query_radius` on a cKDTree, for the
  datasets and anchors (rows sorted ascending);
- `radius_search_fixed` (:124): fixed-shape batched search for the device
  pyramid. CUDA tensors go to kernel A (ops/cuda/radius_search.py), CPU
  tensors to its plain version. Both compute d2 per axis in f32, where the
  JAX XLA path expands |q|^2 + |s|^2 - 2 q.s; the two agree except for
  supports whose distance lies within rounding of the radius.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from weasal_tpu_torch.ops import native
from weasal_tpu_torch.ops.cuda.radius_search import (
    radius_search as radius_search_kernel, radius_search_plain)
from weasal_tpu_torch.utils.device import use_kernel


def radius_search(queries: np.ndarray, supports: np.ndarray, radius: float,
                  max_count: int = 0) -> np.ndarray:
    """Host search: int32 [Nq, W] distance-sorted rows (ties to the lowest
    index), padded with len(supports); W = max_count, or the longest row
    when max_count is 0."""
    if max_count and native.available():
        return native.radius_search_native(queries, supports, float(radius),
                                           max_count)
    return radius_search_scipy(queries, supports, radius, max_count)


def radius_search_scipy(queries: np.ndarray, supports: np.ndarray,
                        radius: float, max_count: int = 0) -> np.ndarray:
    """The cKDTree version of `radius_search` (the native search's
    oracle)."""
    queries = np.asarray(queries, dtype=np.float32)
    supports = np.asarray(supports, dtype=np.float32)
    n_q, n_s = queries.shape[0], supports.shape[0]
    lists = cKDTree(supports).query_ball_point(queries, r=radius)
    lengths = np.fromiter((len(r) for r in lists), np.int64, n_q)
    width = max_count if max_count else max(int(lengths.max(initial=0)), 1)
    out = np.full((n_q, width), n_s, dtype=np.int32)
    if lengths.sum() == 0:
        return out
    rows = np.repeat(np.arange(n_q), lengths)
    cols = np.concatenate([np.asarray(r, np.int64) for r in lists])
    d2 = np.sum((supports[cols] - queries[rows]) ** 2, axis=1)
    order = np.lexsort((cols, d2, rows))
    rows, cols = rows[order], cols[order]
    starts = np.repeat(np.cumsum(lengths) - lengths, lengths)
    rank = np.arange(rows.shape[0]) - starts
    keep = rank < width
    out[rows[keep], rank[keep]] = cols[keep]
    return out


def query_radius(tree: cKDTree, centers: np.ndarray, r: float,
                 return_distance: bool = False):
    """Counterpart of sklearn's `KDTree.query_radius` on a scipy cKDTree:
    for each center, the int64 indices of the tree's points within `r`
    (distance <= r), and with `return_distance` their f64 distances.
    Each row is sorted ascending: sklearn returns rows in its tree's
    order, which no other tree reproduces, and the samplers that thin or
    remap rows need one canonical order."""
    centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
    rows = [np.sort(np.asarray(row, dtype=np.int64))
            for row in tree.query_ball_point(centers, r=r)]
    if not return_distance:
        return rows
    dists = [np.sqrt(np.sum(np.square(tree.data[row] - c), axis=1))
             for row, c in zip(rows, centers)]
    return rows, dists


def radius_search_fixed(queries, supports, q_mask, s_mask, radius: float,
                        max_count: int):
    """[B, Nq, K] int32 rows for a padded sphere batch: distance-sorted,
    ties to the lowest index, shadow = Ns, all-Ns rows for masked queries."""
    if use_kernel(queries):
        idx, _overflow = radius_search_kernel(queries, supports, q_mask,
                                              s_mask, radius, max_count)
        return idx
    return radius_search_plain(queries, supports, q_mask, s_mask, radius,
                               max_count)
