"""Kernel A: exact fixed-width radius search (csrc/radius_search.cu).

Replaces the Pallas TPU kernel `radius_search_banded`
(weasal_tpu/ops/pallas/radius_pallas.py:110, body `_search_kernel` :77).
The TPU kernel searched a window of supports around each query tile and
counted what the window missed; this one bins the supports of each sphere
into columns of a 2-D grid and tests only the columns a query's reach
overlaps, with a margin that provably keeps every in-radius support (see
the source note), so it is exact and its `overflow` output is always
zero. `band`, `tile`, `margin` and the sort keys are accepted and
ignored, keeping the call signature. One call is two launches (binning,
then search) and counts once in `radius_search.launches`.

What bounds it on the H100: the in-radius pairs (about K per query, 8
f32 operations each) and the bytes of two point sets in and K indices
out; both are small, so the search is latency-bound. See the source for
the design.

`radius_search_plain` is the same function in plain PyTorch: per-axis f32
d2 over all pairs, masking, a stable sort and truncation to K, matching
`_search_kernel`. The CPU path and the tests use it; `chip_smoke.py`
compares the kernel with it on the card. `radius_search_binned_reference`
emulates the kernel's binning and column rule in PyTorch, with its f32
formulas, so that the rule can be tested on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_void_p])
MAX_K = 256
# The kernel's grid constants (csrc/radius_search.cu): columns per axis,
# reach = sqrt(r2) * REACH_SCALE + max|coordinate| * ABS_SLACK, at least
# MIN_REACH.
GRID_SIDE = 128
REACH_SCALE = 1.001
ABS_SLACK = 2.0 ** -20
MIN_REACH = 2.0 ** -60


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


def radius_search_plain(queries, supports, q_mask, s_mask, radius,
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


def count_in_radius(queries, supports, q_mask, s_mask, radius) -> int:
    """Number of (valid query, valid support) pairs with f32 d2 <= r2,
    before truncation to K: the pairs any exact search has to rank."""
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    r2 = _r2(radius)
    total = 0
    chunk = _chunk(b, ns)
    for q0 in range(0, nq, chunk):
        d2 = _sq_dist(queries[:, q0:q0 + chunk], supports)
        hit = (d2 <= r2) & s_mask[:, None, :] & q_mask[:, q0:q0 + chunk,
                                                       None]
        total += int(hit.sum())
    return total


def support_grid(supports, s_mask, radius):
    """Per sphere (x0, y0, 1/h, reach), each [B] f32, as the kernel's
    binning computes them from the valid supports' (x, y) bounding box:
    reach = sqrt(r2) * REACH_SCALE + m * ABS_SLACK (m the largest
    |coordinate| of the box, reach at least MIN_REACH) and the column side
    h = max(reach, extent / GRID_SIDE), every operation rounded in f32."""
    dev = supports.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    b, ns, _ = supports.shape
    x, y = supports[..., 0], supports[..., 1]
    if ns == 0:
        lo_x = lo_y = hi_x = hi_y = torch.zeros(b, dtype=torch.float32,
                                                device=dev)
    else:
        inf = f32(math.inf)
        lo_x = torch.where(s_mask, x, inf).amin(1)
        lo_y = torch.where(s_mask, y, inf).amin(1)
        hi_x = torch.where(s_mask, x, -inf).amax(1)
        hi_y = torch.where(s_mask, y, -inf).amax(1)
        empty = ~(lo_x <= hi_x)
        lo_x, lo_y, hi_x, hi_y = (torch.where(empty, f32(0.0), v)
                                  for v in (lo_x, lo_y, hi_x, hi_y))
    m = torch.maximum(torch.maximum(lo_x.abs(), hi_x.abs()),
                      torch.maximum(lo_y.abs(), hi_y.abs()))
    reach = torch.sqrt(f32(_r2(radius))) * f32(REACH_SCALE) \
        + m * f32(ABS_SLACK)
    reach = torch.maximum(reach, f32(MIN_REACH))
    extent = torch.maximum(hi_x - lo_x, hi_y - lo_y)
    h = torch.maximum(reach, extent * f32(1.0 / GRID_SIDE))
    return lo_x, lo_y, f32(1.0) / h, reach


def column(v, origin, inv_h):
    """The kernel's monotone column index clamp(floor((v - origin) *
    inv_h), 0, GRID_SIDE - 1), in f32, as int64."""
    t = torch.floor((v - origin) * inv_h)
    return t.clamp(0, GRID_SIDE - 1).to(torch.int64)


def _query_columns(queries, grid):
    """(cx0, cx1, cy0, cy1), each [B, Nq], of the columns a query visits."""
    x0, y0, inv_h, reach = (g[:, None] for g in grid)
    qx, qy = queries[..., 0], queries[..., 1]
    return (column(qx - reach, x0, inv_h), column(qx + reach, x0, inv_h),
            column(qy - reach, y0, inv_h), column(qy + reach, y0, inv_h))


def candidate_mask(queries, supports, s_mask, grid):
    """[B, Nq, Ns] bool: the valid supports whose column lies in a
    query's visited range, i.e. the supports the kernel tests."""
    x0, y0, inv_h, _ = (g[:, None] for g in grid)
    sx = column(supports[..., 0], x0, inv_h)[:, None, :]
    sy = column(supports[..., 1], y0, inv_h)[:, None, :]
    cx0, cx1, cy0, cy1 = (c[..., None] for c in _query_columns(queries,
                                                               grid))
    return ((sx >= cx0) & (sx <= cx1) & (sy >= cy0) & (sy <= cy1)
            & s_mask[:, None, :])


def column_starts(supports, s_mask, grid) -> torch.Tensor:
    """[B, GRID_SIDE^2 + 1] int64 exclusive starts of the columns (cell =
    cy * GRID_SIDE + cx) in the kernel's column-ordered copy."""
    b = supports.shape[0]
    x0, y0, inv_h, _ = (g[:, None] for g in grid)
    cells = (column(supports[..., 1], y0, inv_h) * GRID_SIDE
             + column(supports[..., 0], x0, inv_h))
    n_cells = GRID_SIDE * GRID_SIDE
    flat = (cells + torch.arange(b, device=cells.device)[:, None]
            * n_cells)[s_mask]
    counts = torch.bincount(flat, minlength=b * n_cells).reshape(b, n_cells)
    starts = torch.zeros((b, n_cells + 1), dtype=torch.int64,
                         device=supports.device)
    starts[:, 1:] = torch.cumsum(counts, dim=1)
    return starts


def radius_search_binned_reference(queries, supports, q_mask, s_mask,
                                   radius, max_count: int):
    """The kernel's algorithm in plain PyTorch: (rows [B, Nq, K] int32,
    candidates [B, Nq] int64). Bins the supports as the kernel does, ranks
    only each valid query's candidates (the supports of its visited
    columns) by (d2, index), and counts the candidates from the column
    starts, as the kernel's search walks them (0 for a masked query)."""
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    r2 = _r2(radius)
    grid = support_grid(supports, s_mask, radius)
    out = torch.full((b, nq, max_count), ns, dtype=torch.int32,
                     device=queries.device)
    chunk = _chunk(b, ns)
    for q0 in range(0, nq, chunk):
        q = queries[:, q0:q0 + chunk]
        d2 = _sq_dist(q, supports)
        keep = candidate_mask(q, supports, s_mask, grid)
        rows = _rows_from_d2(d2, keep, r2, max_count, ns)
        out[:, q0:q0 + chunk, :rows.shape[2]] = rows
    out = torch.where(q_mask[..., None], out, torch.full_like(out, ns))

    starts = column_starts(supports, s_mask, grid)
    cx0, cx1, cy0, cy1 = _query_columns(queries, grid)
    candidates = torch.zeros((b, nq), dtype=torch.int64,
                             device=queries.device)
    span = int((cy1 - cy0).max()) + 1 if b * nq else 0
    for dy in range(span):
        cy = cy0 + dy
        row = cy.clamp(max=GRID_SIDE - 1) * GRID_SIDE
        n = (torch.gather(starts, 1, (row + cx1 + 1).reshape(b, -1))
             - torch.gather(starts, 1, (row + cx0).reshape(b, -1)))
        candidates += torch.where(cy <= cy1, n.reshape(b, nq), 0)
    return out, torch.where(q_mask, candidates, 0)


def declare(lib):
    """Set the C signatures of a radius-search library's two entries;
    returns the library."""
    words = lib.radius_search_scratch_words
    words.argtypes, words.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    launch = lib.radius_search_launch
    launch.argtypes, launch.restype = _ARGTYPES, ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library, built first when stale, its entries declared."""
    return declare(load_library("radius_search"))


@functools.lru_cache(maxsize=None)
def scratch_words(b: int, ns: int) -> int:
    """4-byte words of scratch a launch needs (`radius_search_scratch_words`
    of the library): the column-ordered supports, the grid parameters and
    the column starts."""
    return int(_library().radius_search_scratch_words(b, ns))


def _launch(queries, supports, q_mask, s_mask, radius, max_count):
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    for name, t, dtype in (("queries", queries, torch.float32),
                           ("supports", supports, torch.float32),
                           ("q_mask", q_mask, torch.bool),
                           ("s_mask", s_mask, torch.bool)):
        if t.device != queries.device:
            raise ValueError(f"{name} is on {t.device}, queries on "
                             f"{queries.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if queries.shape[2] != 3 or supports.shape[0] != b \
            or supports.shape[2] != 3 or tuple(q_mask.shape) != (b, nq) \
            or tuple(s_mask.shape) != (b, ns):
        raise ValueError("expected queries [B,Nq,3], supports [B,Ns,3], "
                         "q_mask [B,Nq], s_mask [B,Ns]")
    if not 1 <= max_count <= MAX_K:
        raise ValueError(f"max_count must be in [1, {MAX_K}], got {max_count}")
    out = torch.empty((b, nq, max_count), dtype=torch.int32,
                      device=queries.device)
    if b * nq == 0:
        return out
    scratch = torch.empty(scratch_words(b, ns), dtype=torch.int32,
                          device=queries.device)
    radius_search.launches += 1
    check(_library().radius_search_launch(queries.data_ptr(), supports.data_ptr(), q_mask.data_ptr(),
             s_mask.data_ptr(), b, nq, ns, max_count, _r2(radius),
             out.data_ptr(), scratch.data_ptr(), scratch.numel(),
             torch.cuda.current_stream(queries.device).cuda_stream),
          "radius_search")
    return out


def radius_search(queries, supports, q_mask, s_mask, radius, max_count: int,
                  skey_q=None, skey_s=None, band: int = 0, tile: int = 128,
                  margin: float = 0.0):
    """Exact radius search over a padded sphere batch.

    :param queries: [B, Nq, 3] f32; supports: [B, Ns, 3] f32
    :param q_mask / s_mask: [B, Nq] / [B, Ns] bool validity
    :param radius: search radius; max_count: row width K (<= 256)
    :return: (neighbors [B, Nq, K] int32, overflow [B] f32, always 0)

    A CPU tensor runs `radius_search_plain`; a CUDA tensor launches the
    kernel (binning, then search) or raises. The sort keys, band, tile
    and margin are ignored.
    """
    overflow = torch.zeros(queries.shape[0], dtype=torch.float32,
                           device=queries.device)
    if queries.device.type == "cpu":
        return radius_search_plain(queries, supports, q_mask, s_mask,
                                   radius, max_count), overflow
    if not queries.is_cuda:
        raise ValueError(f"radius_search runs on cpu or cuda tensors, "
                         f"got {queries.device}")
    return _launch(queries, supports, q_mask, s_mask, radius,
                   max_count), overflow


radius_search.launches = 0
