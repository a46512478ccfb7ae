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
  pyramid, in plain PyTorch: per-axis f32 d2 over all pairs, masking, a
  stable sort and truncation to K (the JAX XLA path expands |q|^2 + |s|^2
  - 2 q.s; the two agree except for supports whose distance lies within
  rounding of the radius).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.spatial import cKDTree

from portbench.reference.ops import native


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


def _r2(radius: float) -> float:
    """r^2 computed in double and rounded to f32, as the TPU kernel does
    (radius_pallas.py:183); d2 is compared against it in f32."""
    return float(np.float32(float(radius) ** 2))


def _sq_dist(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[B, Nq, Ns] f32 d2, summed per axis x, y, z from 0, each product
    and sum rounded (no fused multiply-add), as the kernel computes it."""
    d2 = None
    for d in range(3):
        diff = q[:, :, None, d] - s[:, None, :, d]
        sq = diff * diff
        d2 = sq if d2 is None else d2 + sq
    return d2


def _chunk(b: int, ns: int) -> int:
    return max(1, (1 << 24) // max(1, b * ns))


def _rows_from_d2(d2, keep, r2: float, max_count: int, ns: int):
    """Distance-sorted rows (ties to the lowest index, shadow = Ns) of
    the supports where `keep` holds and d2 <= r2."""
    inf = torch.tensor(math.inf, dtype=d2.dtype, device=d2.device)
    d2 = torch.where(keep, d2, inf)
    d2 = torch.where(d2 > r2, inf, d2)
    sd, si = torch.sort(d2, dim=2, stable=True)
    k = min(max_count, ns)
    idx = torch.where(torch.isinf(sd[..., :k]),
                      torch.full_like(si[..., :k], ns), si[..., :k])
    return idx.to(torch.int32)


def radius_search_fixed(queries, supports, q_mask, s_mask, radius,
                        max_count: int):
    """[B, Nq, K] int32 neighbor rows: distance-sorted, ties to the lowest
    index, shadow = Ns, all-Ns rows for invalid queries."""
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    r2 = _r2(radius)
    out = torch.full((b, nq, max_count), ns, dtype=torch.int32,
                     device=queries.device)
    chunk = _chunk(b, ns)
    for q0 in range(0, nq, chunk):
        d2 = _sq_dist(queries[:, q0:q0 + chunk], supports)
        rows = _rows_from_d2(d2, s_mask[:, None, :], r2, max_count, ns)
        out[:, q0:q0 + chunk, :rows.shape[2]] = rows
    return torch.where(q_mask[..., None], out, torch.full_like(out, ns))
