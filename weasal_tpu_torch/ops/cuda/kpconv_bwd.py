"""Kernel C: rigid KPConv backward, sum aggregation (csrc/kpconv_bwd.cu).

Replaces the backward of the Pallas TPU kernel `kpconv_banded`
(weasal_tpu/ops/pallas/kpconv_banded.py:550, `_bwd_kernel` :295 behind
the custom VJP rule `_bwd_rule` :502). Given the forward's inputs, its
aggregate y [B*Nq, Kp*Cin] (kernel B writes it; see kpconv_fwd.py) and
the output gradient g [B, Nq, Cout]:

    dX[b, s] = sum over (q, k) with nb[b, q, k] = s < Ns of
               sum_p h_p(s - q) * (g[b, q] @ W_p^T)
    dW_p     = y_p^T @ g

Points, neighbor indices and kernel points get no gradient, as in
kpconv_banded.py:562-566. The TPU kernel summed dX over a window of
sorted supports in a fixed order and could drop neighbors outside it
(counted in the forward's `oob`); this kernel sums over the exact
neighbor rows, also in a fixed order: each (row, slot) contribution goes
to a workspace, and each support adds its slots in ascending order over
its inverse neighbor list (ops/cuda/inverse_lists.py), so dX repeats bit
for bit. The lists come from the caller (`inverse`, shared by the convs
on one pyramid edge) or are built here.

What bounds it on the H100: the two contractions at the wide levels
(operations; both run on the tensor cores through the 3xTF32 split of
csrc/kpconv_common.cuh), the workspace's traffic at level 0; the source
describes the launches. The wrapper allocates the GEMMs' split-K
workspace, whose size the library computes (`kpconv_bwd_workspace`), and
the dX workspace [B*Nq*K, Cin].

`kpconv_bwd_plain` is the same function written out in plain PyTorch
(influences, gathers, einsums, `index_add_`), not autograd of the
forward, so that the tests can hold it against autograd. The CPU path
and the tests use it; `chip_smoke.py` compares the kernel with it on the
card.
"""

from __future__ import annotations

import ctypes

import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library
from weasal_tpu_torch.ops.cuda.inverse_lists import (require_lists,
                                                     scatter_rows)
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (
    INFLUENCES, check_kpconv_inputs, gaussian_denominator,
    neighbor_influences, workspace, workspace_args)

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int]
             + [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p])


def kpconv_bwd_plain(q_pts, s_pts, neighb_inds, y, kernel_points, weights,
                     g, kp_extent: float, influence: str = "linear",
                     need_dx: bool = True):
    """(dX [B, Ns, Cin] or None, dW [Kp, Cin, Cout]) in plain PyTorch."""
    b, nq, cout = g.shape
    kp, cin, _ = weights.shape
    g2 = g.reshape(b * nq, cout)
    dw = (y.t() @ g2).reshape(kp, cin, cout)
    if not need_dx:
        return None, dw
    dr = (g2 @ weights.reshape(kp * cin, cout).t()).reshape(b, nq, kp, cin)
    h = neighbor_influences(q_pts, s_pts, neighb_inds, kernel_points,
                            kp_extent, influence)            # [B,Nq,Kp,K]
    contrib = torch.einsum("bqpk,bqpc->bqkc", h, dr)         # [B,Nq,K,Cin]
    return scatter_rows(contrib, neighb_inds, s_pts.shape[1]), dw


def _launch(q_pts, s_pts, neighb_inds, y, kernel_points, weights, g,
            kp_extent, influence, need_dx, inverse):
    b, nq, _ = q_pts.shape
    ns = s_pts.shape[1]
    kp, cin, cout = weights.shape
    k = neighb_inds.shape[2]
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP influence: {influence}")
    check_kpconv_inputs(
        "kpconv_bwd", (("q_pts", q_pts, torch.float32),
                       ("s_pts", s_pts, torch.float32),
                       ("neighb_inds", neighb_inds, torch.int32),
                       ("y", y, torch.float32),
                       ("kernel_points", kernel_points, torch.float32),
                       ("weights", weights, torch.float32),
                       ("g", g, torch.float32)),
        q_pts, s_pts, neighb_inds, kernel_points, weights, cin)
    if (tuple(y.shape) != (b * nq, kp * cin)
            or tuple(g.shape) != (b, nq, cout)):
        raise ValueError("expected y [B*Nq, Kp*Cin] and g [B,Nq,Cout]")
    dev = q_pts.device
    dx = (torch.empty((b, ns, cin), dtype=torch.float32, device=dev)
          if need_dx else None)
    dr = (torch.empty((b * nq, kp * cin), dtype=torch.float32, device=dev)
          if need_dx else None)
    xws = (torch.empty((b * nq * k, cin), dtype=torch.float32, device=dev)
           if need_dx else None)
    inv = require_lists(inverse, b * ns, "kpconv_bwd") if need_dx else None
    dw = torch.empty((kp, cin, cout), dtype=torch.float32, device=dev)
    lib = load_library("kpconv_bwd")
    ws = workspace(lib, "kpconv_bwd", b * nq, kp * cin, cout, int(need_dx),
                   device=dev)
    fn = lib.kpconv_bwd_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    kpconv_bwd.launches += 1
    check(fn(q_pts.data_ptr(), s_pts.data_ptr(), neighb_inds.data_ptr(),
             y.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
             g.data_ptr(), b, nq, ns, k, kp, cin, cout, float(kp_extent),
             INFLUENCES[influence], gaussian_denominator(kp_extent),
             int(need_dx),
             *((inv.offsets.data_ptr(), inv.entries.data_ptr(),
                dr.data_ptr(), xws.data_ptr(), dx.data_ptr()) if need_dx
               else (None,) * 5), dw.data_ptr(),
             *workspace_args(ws), torch.cuda.current_stream(dev).cuda_stream),
          "kpconv_bwd")
    return dx, dw


def kpconv_bwd(q_pts, s_pts, neighb_inds, y, kernel_points, weights, g,
               kp_extent: float, influence: str = "linear",
               need_dx: bool = True, inverse=None):
    """Gradients of the rigid KPConv forward.

    :param q_pts: [B, Nq, 3]; s_pts: [B, Ns, 3]; neighb_inds: [B, Nq, K]
        int32 (>= Ns = shadow); y: [B*Nq, Kp*Cin], the forward's
        aggregate; kernel_points: [Kp, 3]; weights: [Kp, Cin, Cout];
        g: [B, Nq, Cout]; all f32 except the indices
    :param need_dx: False skips dX (the input needs no gradient)
    :param inverse: a LazyInverse of neighb_inds (ops/cuda/inverse_lists;
        shared by the convs on one edge); the kernel's dX needs it, the
        plain version ignores it
    :return: (dX [B, Ns, Cin] or None, dW [Kp, Cin, Cout])

    A CPU tensor runs `kpconv_bwd_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    if q_pts.device.type == "cpu":
        return kpconv_bwd_plain(q_pts, s_pts, neighb_inds, y, kernel_points,
                                weights, g, kp_extent, influence, need_dx)
    if not q_pts.is_cuda:
        raise ValueError(f"kpconv_bwd runs on cpu or cuda tensors, got "
                         f"{q_pts.device}")
    return _launch(q_pts, s_pts, neighb_inds, y, kernel_points, weights, g,
                   kp_extent, influence, need_dx, inverse)


kpconv_bwd.launches = 0
