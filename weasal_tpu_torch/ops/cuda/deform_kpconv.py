"""The deformable conv chain's pair work (csrc/deform_kpconv.cu).

Replaces no Pallas kernel: the JAX package runs the deformable chain in
plain jnp (weasal_tpu/ops/kpconv.py:171-236). For a deformable conv with
offsets [B, Nq, Kp, 3], the forward `deform_pairs_fwd` gives

    y[b, q, p, :]  = sum_k hm[p, k] * x[b, nb_k, :]        [B, Nq, Kp, Cin]
    min_sq[b, q, p] = min_k d2[p, k]                        [B, Nq, Kp]

with d2 the squared distance from each neighbor (a shadow at the far
pad coordinate) to each deformed kernel point kp_p + offsets[b, q, p],
computed as `ops/kpconv.kpconv_dense` computes it, and hm the influence
masked to the neighbors inside some deformed kernel point's extent. The
backward `deform_pairs_bwd` takes the gradients of y and min_sq and gives
those of x (each slot's sum over the kernel points into a workspace
[B*Nq*K, Cin], added in the fixed order of the edge's inverse lists by
`inverse_sum`, as kernel C's dX) and of the offsets. The source gives the
formulas, what bounds the kernels on the H100 and their design. Nothing
of size K x Kp reaches device memory; the workspace is the one
pair-sized tensor.

`deform_aggregate_reference` and `deform_aggregate_reference_bwd` are the
same two functions written out in plain PyTorch: the forward as the
plain chain computes it, the backward derived by hand (slot sums added
over the inverse lists, the offsets' gradient through the influence's
slope, the mask and the minima's tie split), not autograd of the
forward, so that the tests can hold it against autograd through
`kpconv_dense`. They are the plain route of
`ops/kpconv.DeformPairsFunction`; the card's checks compare the kernels
with them and with the plain chain.

The wrappers count their launches in `launches`, which
`train/graphs.launch_counts` does not list; the chain's engagement is
counted in the span table instead (`deform.fused.fwd` / `.bwd`,
ops/kpconv.DeformPairsFunction).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library
from weasal_tpu_torch.ops.cuda.inverse_lists import (inverse_sum,
                                                     require_lists,
                                                     scatter_rows)
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (INFLUENCES,
                                                  gather_neighbors,
                                                  gaussian_denominator,
                                                  influence_weights,
                                                  reciprocals)
from weasal_tpu_torch.ops.subsample import SHADOW_COORD

# kPointChunk of csrc/deform_kpconv.cu: kernel points a thread holds at once
POINT_CHUNK = 16
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int] + [ctypes.c_float] * 3
                 + [ctypes.c_void_p] * 4)
_BWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                 + [ctypes.c_float, ctypes.c_int] + [ctypes.c_float] * 3
                 + [ctypes.c_void_p] * 3)


def pair_geometry(q_pts, s_pts, neighb_inds, kernel_points, offsets=None):
    """(diffs [B, Nq, K, Kp, 3], d2 [B, Nq, K, Kp]): each neighbor's
    difference to each (deformed) kernel point and its squared norm, the
    plain chain's (`ops/kpconv.kpconv_dense`): s - q, then minus kp +
    offsets (kp alone without offsets), each axis rounded apart; a
    shadow at SHADOW_COORD."""
    neighbors = gather_neighbors(s_pts, neighb_inds, SHADOW_COORD)
    neighbors = neighbors - q_pts[:, :, None, :]
    deformed = kernel_points[None, None]
    if offsets is not None:
        deformed = deformed + offsets
    diffs = neighbors[:, :, :, None, :] - deformed[:, :, None, :, :]
    sq = diffs * diffs
    return diffs, sq[..., 0] + sq[..., 1] + sq[..., 2]


def _masked_influences(d2, kp_extent: float, influence: str):
    """(inside [B, Nq, K], hm [B, Nq, Kp, K]): the in-range flags and the
    influences masked by them."""
    inside = (d2 < kp_extent ** 2).any(dim=-1)
    hm = influence_weights(d2, kp_extent, influence) \
        * inside[:, :, None, :].to(d2.dtype)
    return inside, hm


def deform_aggregate_reference(q_pts, s_pts, neighb_inds, x, kernel_points,
                               offsets, kp_extent: float,
                               influence: str = "linear"):
    """(y [B, Nq, Kp, Cin], min_sq [B, Nq, Kp]) in plain PyTorch: the
    kernel's forward, as the plain chain computes it."""
    _, d2 = pair_geometry(q_pts, s_pts, neighb_inds, kernel_points, offsets)
    _, hm = _masked_influences(d2, kp_extent, influence)
    y = torch.einsum("bqpk,bqkc->bqpc", hm,
                     gather_neighbors(x, neighb_inds, 0.0))
    return y, d2.amin(dim=2)


def deform_aggregate_reference_bwd(q_pts, s_pts, neighb_inds, x,
                                   kernel_points, offsets, dy, dmin,
                                   kp_extent: float,
                                   influence: str = "linear",
                                   need_dx: bool = True,
                                   need_doff: bool = True, inverse=None):
    """(dX [B, Ns, Cin] or None, d offsets [B, Nq, Kp, 3] or None) of
    `deform_aggregate_reference` for dy [B, Nq, Kp, Cin] and dmin
    [B, Nq, Kp] (None: the minima take no gradient), derived by hand:
    each slot's sum over the kernel points, added over the inverse lists
    (`inverse`; `scatter_rows` without); the offsets' gradient through
    the masked influence's slope (autograd's expressions at clamp's >= 0
    and sqrt's grad / (2 sqrt); the strict in-range test takes none) and
    the minima, whose ties share it equally. At d2 = 0 the slope's
    division by zero gives NaN, as autograd through the plain chain."""
    diffs, d2 = pair_geometry(q_pts, s_pts, neighb_inds, kernel_points,
                              offsets)
    inside, hm = _masked_influences(d2, kp_extent, influence)
    dx = doff = None
    if need_dx:
        b, ns = x.shape[:2]
        slots = torch.einsum("bqpk,bqpc->bqkc", hm, dy)
        if inverse is None:
            dx = scatter_rows(slots, neighb_inds, ns)
        else:
            lists = require_lists(inverse, b * ns, "deform_pairs_bwd")
            dx = inverse_sum(slots.reshape(-1, slots.shape[-1]).contiguous(),
                             lists, b * ns).reshape(b, ns, -1)
    if need_doff:
        dots = torch.einsum("bqpc,bqkc->bqkp", dy,
                            gather_neighbors(x, neighb_inds, 0.0))
        g_h = dots * inside[..., None].to(dots.dtype)
        if influence == "linear":
            r = torch.sqrt(d2)
            u = 1.0 - r / kp_extent
            g_u = torch.where(u >= 0, g_h, torch.zeros_like(g_h))
            g2 = (-g_u / kp_extent) / (2 * r)
        elif influence == "gaussian":
            den = gaussian_denominator(kp_extent)
            g2 = -((g_h * torch.exp(-d2 / den)) / den)
        elif influence == "constant":
            g2 = torch.zeros_like(d2)
        else:
            raise ValueError(f"Unknown KP influence: {influence}")
        if dmin is not None:
            tied = d2 == d2.amin(dim=2, keepdim=True)
            share = dmin[:, :, None, :] / tied.sum(dim=2, keepdim=True)
            g2 = g2 + share * tied.to(share.dtype)
        doff = -(2 * (g2[..., None] * diffs)).sum(dim=2)
    return dx, doff


def pair_smem_bytes(n_kp: int, k: int, cin: int, backward: bool) -> int:
    """Bytes of shared memory a block of the forward or the backward
    takes (the `Layout` of csrc/deform_kpconv.cu)."""
    words = k * (-(-n_kp // 4) * 4) + POINT_CHUNK
    if backward:
        words += -(-n_kp * cin // 4) * 4 + n_kp * k
    return 4 * (words + 6 * k + 4 * n_kp + 1)


@functools.lru_cache(maxsize=None)
def smem_limit(lib) -> int:
    """Bytes of shared memory the card gives a block, from the library."""
    fn = lib.deform_kpconv_smem_limit
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def check_deform_inputs(what: str, tensors, q_pts, s_pts, neighb_inds, x,
                        kernel_points, offsets, smem: int,
                        limit: int) -> None:
    """Raise unless every (name, tensor, dtype) of `tensors` lies on
    q_pts's device with that dtype, contiguous, the shapes are q [B,Nq,3],
    s [B,Ns,3], nb [B,Nq,K], x [B,Ns,Cin], kp [Kp,3], offsets [B,Nq,Kp,3]
    with Kp, K and Cin >= 1, and a block's `smem` bytes lie within
    `limit` (the card's shared memory a block)."""
    for name, t, dtype in tensors:
        if t.device != q_pts.device:
            raise ValueError(f"{name} is on {t.device}, q_pts on "
                             f"{q_pts.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what} takes {name} as {dtype} only, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, nq = q_pts.shape[:2]
    kp = kernel_points.shape[0]
    if (q_pts.dim() != 3 or q_pts.shape[2] != 3 or s_pts.dim() != 3
            or s_pts.shape[0] != b or s_pts.shape[2] != 3
            or neighb_inds.dim() != 3
            or tuple(neighb_inds.shape[:2]) != (b, nq)
            or x.dim() != 3 or tuple(x.shape[:2]) != tuple(s_pts.shape[:2])
            or tuple(kernel_points.shape) != (kp, 3)
            or tuple(offsets.shape) != (b, nq, kp, 3)):
        raise ValueError("expected q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K], "
                         "x [B,Ns,Cin], kp [Kp,3], offsets [B,Nq,Kp,3]")
    if min(kp, neighb_inds.shape[2], x.shape[2]) < 1:
        raise ValueError(f"{what} needs at least one kernel point, "
                         "neighbor and channel")
    if smem > limit:
        raise ValueError(
            f"{what}: {kp} kernel points x {neighb_inds.shape[2]} neighbors "
            f"x {x.shape[2]} channels need {smem} bytes of shared memory a "
            f"block, past the card's limit of {limit} bytes")


def _prepare(what, q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
             kp_extent, influence, grads, backward):
    """(library, sizes, scalars) of a launch, the inputs checked."""
    if not q_pts.is_cuda:
        raise ValueError(f"{what} runs on cuda tensors, got {q_pts.device}")
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP influence: {influence}")
    lib = load_library("deform_kpconv")
    f32 = torch.float32
    b, nq, k = neighb_inds.shape
    kp, (ns, cin) = kernel_points.shape[0], x.shape[1:]
    check_deform_inputs(
        what, (("q_pts", q_pts, f32), ("s_pts", s_pts, f32),
               ("neighb_inds", neighb_inds, torch.int32), ("x", x, f32),
               ("kernel_points", kernel_points, f32),
               ("offsets", offsets, f32), *grads),
        q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
        pair_smem_bytes(kp, k, cin, backward), smem_limit(lib))
    inv_ext, inv_den = reciprocals(kp_extent)
    # the plain chain's `d2 < ext ** 2` compares with ext^2 rounded to f32
    thr = float(np.float32(kp_extent ** 2))
    sizes = (b, nq, ns, k, kp, cin)
    scalars = (inv_ext, INFLUENCES[influence], inv_den, thr,
               float(SHADOW_COORD))
    return lib, sizes, scalars


def deform_pairs_fwd(q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
                     kp_extent: float, influence: str = "linear",
                     with_mask: bool = False):
    """The forward kernel: (y [B, Nq, Kp, Cin], min_sq [B, Nq, Kp]) and,
    `with_mask`, the in-range flags [B, Nq, K] (bool; for the checks).

    :param q_pts: [B, Nq, 3]; s_pts: [B, Ns, 3]; neighb_inds: [B, Nq, K]
        int32 (>= Ns = shadow); x: [B, Ns, Cin]; kernel_points: [Kp, 3];
        offsets: [B, Nq, Kp, 3]; all f32 except the indices, contiguous,
        on the card (raises otherwise, and for sizes past the card's
        shared memory)."""
    lib, (b, nq, ns, k, kp, cin), scalars = _prepare(
        "deform_pairs_fwd", q_pts, s_pts, neighb_inds, x, kernel_points,
        offsets, kp_extent, influence, (), False)
    dev = q_pts.device
    y = torch.empty((b, nq, kp, cin), dtype=torch.float32, device=dev)
    min_sq = torch.empty((b, nq, kp), dtype=torch.float32, device=dev)
    mask = (torch.empty((b, nq, k), dtype=torch.uint8, device=dev)
            if with_mask else None)
    fn = lib.deform_kpconv_fwd_launch
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    deform_pairs_fwd.launches += 1
    check(fn(q_pts.data_ptr(), s_pts.data_ptr(), neighb_inds.data_ptr(),
             x.data_ptr(), kernel_points.data_ptr(), offsets.data_ptr(), b,
             nq, ns, k, kp, cin, *scalars, y.data_ptr(), min_sq.data_ptr(),
             None if mask is None else mask.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream), "deform_pairs_fwd")
    return (y, min_sq) if mask is None else (y, min_sq, mask.bool())


def deform_pairs_bwd(q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
                     dy, dmin, kp_extent: float, influence: str = "linear",
                     need_dx: bool = True, need_doff: bool = True,
                     inverse=None):
    """The backward kernel and the row sums of its dX: (dX [B, Ns, Cin] or
    None, d offsets [B, Nq, Kp, 3] or None).

    :param dy: [B, Nq, Kp, Cin], the gradient of y; dmin: [B, Nq, Kp], of
        min_sq, or None (the minima take none); both f32, contiguous
    :param inverse: a LazyInverse of neighb_inds (shared by the ops on one
        edge); dX needs it
    The other inputs are the forward's (`deform_pairs_fwd`)."""
    f32 = torch.float32
    grads = (("dy", dy, f32),) + (() if dmin is None
                                  else (("dmin", dmin, f32),))
    lib, (b, nq, ns, k, kp, cin), scalars = _prepare(
        "deform_pairs_bwd", q_pts, s_pts, neighb_inds, x, kernel_points,
        offsets, kp_extent, influence, grads, True)
    if tuple(dy.shape) != (b, nq, kp, cin) or (
            dmin is not None and tuple(dmin.shape) != (b, nq, kp)):
        raise ValueError("expected dy [B,Nq,Kp,Cin] and dmin [B,Nq,Kp]")
    dev = q_pts.device
    inv = require_lists(inverse, b * ns, "deform_pairs_bwd") if need_dx \
        else None
    ws = (torch.empty((b * nq * k, cin), dtype=f32, device=dev)
          if need_dx else None)
    doff = (torch.empty((b, nq, kp, 3), dtype=f32, device=dev)
            if need_doff else None)
    fn = lib.deform_kpconv_bwd_launch
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    deform_pairs_bwd.launches += 1
    check(fn(q_pts.data_ptr(), s_pts.data_ptr(), neighb_inds.data_ptr(),
             x.data_ptr(), kernel_points.data_ptr(), offsets.data_ptr(),
             dy.data_ptr(), None if dmin is None else dmin.data_ptr(), b, nq,
             ns, k, kp, cin, *scalars,
             None if ws is None else ws.data_ptr(),
             None if doff is None else doff.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream), "deform_pairs_bwd")
    dx = (inverse_sum(ws, inv, b * ns).reshape(b, ns, cin) if need_dx
          else None)
    return dx, doff


deform_pairs_fwd.launches = 0
deform_pairs_bwd.launches = 0
