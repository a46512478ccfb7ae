"""KPConv and the pooling ops on the dense sphere layout.

Counterpart of weasal_tpu/ops/kpconv.py: `gather_neighbors` (:90),
`influence_weights` (:112), the rigid sum-aggregation branch of `kpconv`
(:131-237), the dense route of `max_pool` (:244), `closest_pool` (:297)
and `global_average` (:303). Deformable kernels and 'closest'
aggregation are not ported and raise.

Both differentiable ops are `torch.autograd.Function`s, the counterparts
of the custom VJPs of weasal_tpu/ops/pallas/kpconv_banded.py:572 and
maxpool_banded.py:170:
- `KPConvFunction`: forward kernel B (ops/cuda/kpconv_fwd.py), backward
  kernel C (ops/cuda/kpconv_bwd.py);
- `MaxPoolFunction`: forward gather + max in plain torch (on the JAX path
  too the forward is XLA's), backward kernel D (ops/cuda/maxpool_bwd.py).
The route is fixed in the forward and kept for the backward (which runs
on autograd's own thread): a CUDA tensor outside `plain_ops()` launches
the kernels, anything else runs their plain PyTorch versions. Points,
neighbor indices and kernel points get no gradient. On the card the
backwards sum dX in a fixed order over inverse neighbor lists
(ops/cuda/inverse_lists.py), which the caller passes as a `LazyInverse`
shared by every op on one pyramid edge (data/batch.PyramidBatch), and
`closest_pool`'s gather has a backward of the same kind.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse, gather_rows
from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd, kpconv_bwd_plain
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (  # noqa: F401 (re-export)
    gather_neighbors, influence_weights, kpconv_fwd, kpconv_fwd_plain,
    kpconv_fwd_plain_with_y, kpconv_fwd_with_y)
from weasal_tpu_torch.ops.cuda.maxpool_bwd import (maxpool_bwd,
                                                   maxpool_bwd_plain)
from weasal_tpu_torch.utils.device import use_kernel

MAXPOOL_ROUTES = ("dense",)


class KPConvParams(NamedTuple):
    """Static hyper-parameters of one KPConv op."""
    kp_extent: float
    influence: str = "linear"        # 'constant' | 'linear' | 'gaussian'
    aggregation: str = "sum"         # only 'sum' is ported


class KPConvFunction(torch.autograd.Function):
    """Rigid sum-aggregation KPConv whose forward is kernel B and whose
    backward is kernel C; gradients flow to x and the weights only. The
    forward's aggregate y [B*Nq, Kp*Cin] is kept for dW."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                kp_extent: float, influence: str, inverse=None):
        ctx.kernel = use_kernel(x)
        ctx.inverse = inverse
        x, weights = x.contiguous(), weights.contiguous()
        fwd = kpconv_fwd_with_y if ctx.kernel else kpconv_fwd_plain_with_y
        out, y = fwd(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                     kp_extent, influence)
        ctx.save_for_backward(q_pts, s_pts, neighb_inds, y, kernel_points,
                              weights)
        ctx.kp_extent, ctx.influence = kp_extent, influence
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q_pts, s_pts, neighb_inds, y, kernel_points, weights = \
            ctx.saved_tensors
        args = (q_pts, s_pts, neighb_inds, y, kernel_points, weights,
                g.contiguous(), ctx.kp_extent, ctx.influence)
        need_dx = ctx.needs_input_grad[3]
        if ctx.kernel:
            dx, dw = kpconv_bwd(*args, need_dx=need_dx, inverse=ctx.inverse)
        else:
            dx, dw = kpconv_bwd_plain(*args, need_dx=need_dx)
        return None, None, None, dx, None, dw, None, None, None


class MaxPoolFunction(torch.autograd.Function):
    """Neighborhood max with a 0.0 shadow slot; the forward is a plain
    gather + max, the backward is kernel D (ties split equally)."""

    @staticmethod
    def forward(ctx, x, neighb_inds, inverse=None):
        ctx.kernel = use_kernel(x)
        ctx.inverse = inverse
        ctx.save_for_backward(x, neighb_inds)
        return gather_neighbors(x, neighb_inds, 0.0).amax(dim=2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, neighb_inds = ctx.saved_tensors
        if ctx.kernel:
            dx = maxpool_bwd(x, neighb_inds, g.contiguous(),
                             inverse=ctx.inverse)
        else:
            dx = maxpool_bwd_plain(x, neighb_inds, g.contiguous())
        return dx, None, None


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
           params: KPConvParams,
           inverse: Optional[LazyInverse] = None) -> torch.Tensor:
    """Rigid KPConv: [B, Nq, 3], [B, Ns, 3], [B, Nq, K], [B, Ns, Cin],
    [Kp, 3], [Kp, Cin, Cout] -> [B, Nq, Cout]; `inverse`: the edge's
    inverse lists for kernel C's dX."""
    if params.aggregation != "sum":
        raise NotImplementedError(
            "only sum-aggregation KPConv is ported")
    return KPConvFunction.apply(q_pts, s_pts, neighb_inds, x, kernel_points,
                                weights, params.kp_extent, params.influence,
                                inverse)


def max_pool(x: torch.Tensor, inds: torch.Tensor,
             inverse: Optional[LazyInverse] = None) -> torch.Tensor:
    """Max over each pooling neighborhood; the shadow row is zero, so the
    result is clamped at >= 0 like the reference. Only the 'dense' route
    is ported: `WEASAL_MAXPOOL` naming another one raises. `inverse`:
    the edge's inverse lists for kernel D."""
    route = os.environ.get("WEASAL_MAXPOOL", "") or "dense"
    if route not in MAXPOOL_ROUTES:
        raise ValueError(f"max_pool route {route!r} is not ported "
                         f"(known: {MAXPOOL_ROUTES})")
    return MaxPoolFunction.apply(x, inds, inverse)


def closest_pool(x: torch.Tensor, inds: torch.Tensor,
                 inverse: Optional[LazyInverse] = None) -> torch.Tensor:
    """Features of the nearest support (column 0 of the sorted rows); its
    backward adds in a fixed order (`inverse`: the lists of column 0)."""
    return gather_rows(x, inds, 1, inverse)[:, :, 0, :]


def global_average(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the point axis: [B, N, C] -> [B, C]."""
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
