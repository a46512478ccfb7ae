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

Under compute_dtype "bfloat16" both round where the VJP of the JAX
package's XLA path rounds (`jax.grad` of weasal_tpu/ops/kpconv.py:206-233,
whose casts transpose into casts of the cotangents): g is not rounded;
dr = bf(g @ bf(W)^T); dW = bf(y^T @ g) with y the forward's bf16
aggregate; each (query, slot) gradient bf(sum_p bf(h_p) * dr_p), rounded
before the slots are added into dX in f32. The kernel's bf16 variant
(`kpconv_bwd_bf16_launch`) keeps its dX workspace in bf16 where one chunk
of KP_CHUNK kernel points covers Kp, in f32 past it.
"""

from __future__ import annotations

import ctypes

import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library
from weasal_tpu_torch.ops.cuda.inverse_lists import (require_lists,
                                                     scatter_rows)
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (
    INFLUENCES, KP_CHUNK, bf, check_compute_dtype, check_kpconv_inputs,
    influence_smem_limit, neighbor_influences, reciprocals, workspace,
    workspace_args)

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int]
             + [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p])


def kpconv_bwd_plain(q_pts, s_pts, neighb_inds, y, kernel_points, weights,
                     g, kp_extent: float, influence: str = "linear",
                     need_dx: bool = True, compute_dtype: str = "float32"):
    """(dX [B, Ns, Cin] or None, dW [Kp, Cin, Cout]) in plain PyTorch; y
    is bf16 under compute_dtype "bfloat16" (the forward's)."""
    use_bf16 = check_compute_dtype(compute_dtype)
    b, nq, cout = g.shape
    kp, cin, _ = weights.shape
    g2 = g.reshape(b * nq, cout)
    w2 = weights.reshape(kp * cin, cout)
    if use_bf16:
        dw = bf(y.to(g2.dtype).t() @ g2).reshape(kp, cin, cout)
    else:
        dw = (y.t() @ g2).reshape(kp, cin, cout)
    if not need_dx:
        return None, dw
    dr = g2 @ (bf(w2) if use_bf16 else w2).t()
    if use_bf16:
        dr = bf(dr)
    dr = dr.reshape(b, nq, kp, cin)
    h = neighbor_influences(q_pts, s_pts, neighb_inds, kernel_points,
                            kp_extent, influence)            # [B,Nq,Kp,K]
    if use_bf16:
        h = bf(h)
    contrib = torch.einsum("bqpk,bqpc->bqkc", h, dr)         # [B,Nq,K,Cin]
    if use_bf16:
        contrib = bf(contrib)
    return scatter_rows(contrib, neighb_inds, s_pts.shape[1]), dw


def _launch(q_pts, s_pts, neighb_inds, y, kernel_points, weights, g,
            kp_extent, influence, need_dx, inverse, compute_dtype):
    b, nq, _ = q_pts.shape
    ns = s_pts.shape[1]
    kp, cin, cout = weights.shape
    k = neighb_inds.shape[2]
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP influence: {influence}")
    use_bf16 = check_compute_dtype(compute_dtype)
    lib = load_library("kpconv_bwd")
    check_kpconv_inputs(
        "kpconv_bwd", (("q_pts", q_pts, torch.float32),
                       ("s_pts", s_pts, torch.float32),
                       ("neighb_inds", neighb_inds, torch.int32),
                       ("y", y,
                        torch.bfloat16 if use_bf16 else torch.float32),
                       ("kernel_points", kernel_points, torch.float32),
                       ("weights", weights, torch.float32),
                       ("g", g, torch.float32)),
        q_pts, s_pts, neighb_inds, kernel_points, weights, cin,
        influence_smem_limit(lib))
    if (tuple(y.shape) != (b * nq, kp * cin)
            or tuple(g.shape) != (b, nq, cout)):
        raise ValueError("expected y [B*Nq, Kp*Cin] and g [B,Nq,Cout]")
    dev = q_pts.device
    # bf16: the workspace of the slots' rounded gradients is bf16 where one
    # chunk of kernel points covers Kp (csrc/kpconv_bwd.cu)
    ws_dtype = (torch.bfloat16 if use_bf16 and kp <= KP_CHUNK
                else torch.float32)
    dx = (torch.empty((b, ns, cin), dtype=torch.float32, device=dev)
          if need_dx else None)
    dr = (torch.empty((b * nq, kp * cin), dtype=torch.float32, device=dev)
          if need_dx else None)
    xws = (torch.empty((b * nq * k, cin), dtype=ws_dtype, device=dev)
           if need_dx else None)
    inv = require_lists(inverse, b * ns, "kpconv_bwd") if need_dx else None
    dw = torch.empty((kp, cin, cout), dtype=torch.float32, device=dev)
    ws = workspace(lib, "kpconv_bwd", b * nq, kp * cin, cout, int(need_dx),
                   device=dev)
    name = "kpconv_bwd_bf16" if use_bf16 else "kpconv_bwd"
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    inv_ext, inv_den = reciprocals(kp_extent)
    kpconv_bwd.launches += 1
    check(fn(q_pts.data_ptr(), s_pts.data_ptr(), neighb_inds.data_ptr(),
             y.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
             g.data_ptr(), b, nq, ns, k, kp, cin, cout, inv_ext,
             INFLUENCES[influence], inv_den, int(need_dx),
             *((inv.offsets.data_ptr(), inv.entries.data_ptr(),
                dr.data_ptr(), xws.data_ptr(), dx.data_ptr()) if need_dx
               else (None,) * 5), dw.data_ptr(),
             *workspace_args(ws), torch.cuda.current_stream(dev).cuda_stream),
          name)
    return dx, dw


def kpconv_bwd(q_pts, s_pts, neighb_inds, y, kernel_points, weights, g,
               kp_extent: float, influence: str = "linear",
               need_dx: bool = True, inverse=None,
               compute_dtype: str = "float32"):
    """Gradients of the rigid KPConv forward.

    :param q_pts: [B, Nq, 3]; s_pts: [B, Ns, 3]; neighb_inds: [B, Nq, K]
        int32 (>= Ns = shadow); y: [B*Nq, Kp*Cin], the forward's
        aggregate (bf16 under compute_dtype "bfloat16"); kernel_points:
        [Kp, 3]; weights: [Kp, Cin, Cout]; g: [B, Nq, Cout]; all f32
        except the indices and a bf16 y
    :param need_dx: False skips dX (the input needs no gradient)
    :param inverse: a LazyInverse of neighb_inds (ops/cuda/inverse_lists;
        shared by the convs on one edge); the kernel's dX needs it, the
        plain version ignores it
    :param compute_dtype: "float32" or "bfloat16" (the forward's)
    :return: (dX [B, Ns, Cin] or None, dW [Kp, Cin, Cout]), f32

    A CPU tensor runs `kpconv_bwd_plain`; a CUDA tensor launches the
    kernel (its bf16 variant under "bfloat16") or raises.
    """
    if q_pts.device.type == "cpu":
        return kpconv_bwd_plain(q_pts, s_pts, neighb_inds, y, kernel_points,
                                weights, g, kp_extent, influence, need_dx,
                                compute_dtype)
    if not q_pts.is_cuda:
        raise ValueError(f"kpconv_bwd runs on cpu or cuda tensors, got "
                         f"{q_pts.device}")
    return _launch(q_pts, s_pts, neighb_inds, y, kernel_points, weights, g,
                   kp_extent, influence, need_dx, inverse, compute_dtype)


kpconv_bwd.launches = 0
