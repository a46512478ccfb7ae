"""Kernel D: neighborhood max-pool backward (csrc/maxpool_bwd.cu).

Replaces the Pallas TPU kernel `maxpool_bwd_banded`
(weasal_tpu/ops/pallas/maxpool_banded.py:159, `_bwd_kernel` :58-96), the
custom VJP of `max_pool_banded` (:170). Its semantics are jnp.max's VJP
(maxpool_banded.py:178-187): for out[q, c] = max_k xs[q, k, c], where a
shadow slot (nb >= Ns) holds 0.0,

    dX[nb[q, k], c] += g[q, c] / ties[q, c]   for each slot k with
                                               xs[q, k, c] == out[q, c]

so ties split the gradient equally, and where the maximum is 0.0 the
shadow slots count among the ties and their shares are dropped. The
pooled features come after a leaky ReLU and can be negative, so the
shadow's 0.0 does win.

The TPU kernel took the winner mask [B, Nq, K, C] from the forward; the
kernel recomputes maximum and tie count from x and nb, so the mask is
never built. One warp per query row: its K indices are loaded once,
the lanes run across channels with vector loads, and one pass keeps
each channel's maximum, tie count and winning slots, so each value is
gathered once; the second pass writes each slot's share (or 0.0) to a
workspace [B*Nq*K, C], and each support adds its slots in ascending
order over the pool edge's inverse neighbor list
(ops/cuda/inverse_lists.py), so dX repeats bit for bit as the TPU
kernel's fixed-order sums do. Its bound on the H100 is bytes (a gather,
the workspace and dX, a few compares per value); see the source.

`maxpool_bwd_plain` is the same formula written out in plain PyTorch
(gather, max, tie count, `index_add_`). The CPU path and the tests use
it; `chip_smoke.py` compares the kernel with it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library
from weasal_tpu_torch.ops.cuda.inverse_lists import (require_lists,
                                                     scatter_rows)
from weasal_tpu_torch.ops.cuda.kpconv_fwd import gather_neighbors

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 5)


def maxpool_bwd_plain(x: torch.Tensor, neighb_inds: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """dX [B, Ns, C] of the neighborhood max with a 0.0 shadow slot."""
    pooled = gather_neighbors(x, neighb_inds, 0.0)          # [B,Nq,K,C]
    win = pooled == pooled.amax(dim=2, keepdim=True)
    ties = win.sum(dim=2, keepdim=True).to(g.dtype)
    share = g[:, :, None, :] / ties                         # [B,Nq,1,C]
    contrib = torch.where(win, share, torch.zeros_like(share))
    return scatter_rows(contrib, neighb_inds, x.shape[1])


def _launch(x, neighb_inds, g, inverse):
    b, ns, c = x.shape
    nq, k = neighb_inds.shape[1:]
    for name, t, dtype in (("x", x, torch.float32),
                           ("neighb_inds", neighb_inds, torch.int32),
                           ("g", g, torch.float32)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"maxpool_bwd takes {name} as {dtype} only, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if neighb_inds.shape[0] != b or tuple(g.shape) != (b, nq, c):
        raise ValueError("expected x [B,Ns,C], nb [B,Nq,K], g [B,Nq,C]")
    if k < 1:
        raise ValueError("maxpool_bwd needs at least one neighbor slot")
    dx = torch.empty((b, ns, c), dtype=torch.float32, device=x.device)
    ws = torch.empty((max(b * nq * k, 1), c), dtype=torch.float32,
                     device=x.device)
    inv = require_lists(inverse, b * ns, "maxpool_bwd")
    lib = load_library("maxpool_bwd")
    fn = lib.maxpool_bwd_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    maxpool_bwd.launches += 1
    check(fn(x.data_ptr(), neighb_inds.data_ptr(), g.data_ptr(), b, nq, ns,
             k, c, inv.offsets.data_ptr(), inv.entries.data_ptr(),
             ws.data_ptr(), dx.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream),
          "maxpool_bwd")
    return dx


def maxpool_bwd(x: torch.Tensor, neighb_inds: torch.Tensor,
                g: torch.Tensor, inverse=None) -> torch.Tensor:
    """Gradient of the neighborhood max-pool.

    :param x: [B, Ns, C] f32, the pooled features
    :param neighb_inds: [B, Nq, K] int32 (>= Ns = shadow)
    :param g: [B, Nq, C] f32, the gradient of the pooled output
    :param inverse: a LazyInverse of neighb_inds (ops/cuda/inverse_lists;
        shared on one pool edge); the kernel needs it, the plain version
        ignores it
    :return: dX [B, Ns, C] f32

    A CPU tensor runs `maxpool_bwd_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    if x.device.type == "cpu":
        return maxpool_bwd_plain(x, neighb_inds, g)
    if not x.is_cuda:
        raise ValueError(f"maxpool_bwd runs on cpu or cuda tensors, got "
                         f"{x.device}")
    return _launch(x, neighb_inds, g, inverse)


maxpool_bwd.launches = 0
