"""Kernel A: exact fixed-width radius search (csrc/radius_search.cu).

Replaces the Pallas TPU kernel `radius_search_banded`
(weasal_tpu/ops/pallas/radius_pallas.py:110, body `_search_kernel` :77).
The TPU kernel searched a window of supports around each query tile and
counted what the window missed; this one scans every support of the
sphere, so it is exact and its `overflow` output is always zero. `band`,
`tile`, `margin` and the sort keys are accepted and ignored, keeping the
call signature.

What bounds it on the H100: Nq x Ns pairwise distances per sphere, 8 f32
operations each; bytes are small (two point sets in, K indices out). See
the source for the design.

`radius_search_plain` is the same function in plain PyTorch: per-axis f32
d2, masking, a stable sort and truncation to K, matching `_search_kernel`.
The CPU path and the tests use it; `chip_smoke.py` compares the kernel
with it on the card.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
MAX_K = 256


def _r2(radius: float) -> float:
    """r^2 computed in double and rounded to f32, as the TPU kernel does
    (radius_pallas.py:183); d2 is compared against it in f32."""
    return float(np.float32(float(radius) ** 2))


def radius_search_plain(queries, supports, q_mask, s_mask, radius,
                        max_count: int):
    """[B, Nq, K] int32 neighbor rows: distance-sorted, ties to the lowest
    index, shadow = Ns, all-Ns rows for invalid queries."""
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    r2 = torch.tensor(_r2(radius), dtype=torch.float32)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=queries.device)
    out = torch.full((b, nq, max_count), ns, dtype=torch.int32,
                     device=queries.device)
    chunk = max(1, (1 << 24) // max(1, b * ns))
    for q0 in range(0, nq, chunk):
        q = queries[:, q0:q0 + chunk]
        d2 = None
        for d in range(3):
            diff = q[:, :, None, d] - supports[:, None, :, d]
            sq = diff * diff
            d2 = sq if d2 is None else d2 + sq
        d2 = torch.where(s_mask[:, None, :], d2, inf)
        d2 = torch.where(d2 > r2.to(d2.device), inf, d2)
        sd, si = torch.sort(d2, dim=2, stable=True)
        k = min(max_count, ns)
        idx = torch.where(torch.isinf(sd[..., :k]),
                          torch.full_like(si[..., :k], ns), si[..., :k])
        out[:, q0:q0 + chunk, :k] = idx.to(torch.int32)
    return torch.where(q_mask[..., None], out, torch.full_like(out, ns))


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
    lib = load_library("radius_search")
    fn = lib.radius_search_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    radius_search.launches += 1
    check(fn(queries.data_ptr(), supports.data_ptr(), q_mask.data_ptr(),
             s_mask.data_ptr(), b, nq, ns, max_count, _r2(radius),
             out.data_ptr(), torch.cuda.current_stream(queries.device)
             .cuda_stream), "radius_search")
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
    kernel or raises. The sort keys, band, tile and margin are ignored.
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
