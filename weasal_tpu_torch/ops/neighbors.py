"""Radius neighbor search: distance-sorted rows, shadow index = Ns.

Counterpart of weasal_tpu/ops/neighbors.py:
- `radius_search`: host version (scipy cKDTree), for calibration;
- `radius_search_fixed` (:124): fixed-shape batched search for the device
  pyramid. CUDA tensors go to kernel A (ops/cuda/radius_search.py), CPU
  tensors to its plain version. Both compute d2 per axis in f32, where the
  JAX XLA path expands |q|^2 + |s|^2 - 2 q.s; the two agree except for
  supports whose distance lies within rounding of the radius.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from weasal_tpu_torch.ops.cuda.radius_search import (
    radius_search as radius_search_kernel, radius_search_plain)
from weasal_tpu_torch.utils.device import use_kernel


def radius_search(queries: np.ndarray, supports: np.ndarray, radius: float,
                  max_count: int = 0) -> np.ndarray:
    """Host search: int32 [Nq, W] distance-sorted rows (ties to the lowest
    index), padded with len(supports); W = max_count, or the longest row
    when max_count is 0."""
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
