"""KPConv and the pooling ops on the dense sphere layout.

Counterpart of weasal_tpu/ops/kpconv.py: `gather_neighbors` (:90),
`influence_weights` (:112), `kpconv` (:131-237), the dense route of
`max_pool` (:244), `closest_pool` (:297) and `global_average` (:303).

Rigid sum-aggregation convs run kernels B and C (`kernel_eligible`).
Deformable, modulated and 'closest'-aggregation convs run `kpconv_dense`,
the plain PyTorch chain of :171-236, on every device: the JAX package
runs them off its Pallas kernel too (`pallas_eligible`, :63-72). Its
neighbor-feature gather is `gather_rows`, whose backward adds in a fixed
order over the edge's inverse lists on the card; its other reductions
(the influence products, the GEMM, the min over neighbors) are torch's
own, which repeat bit for bit.

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
from weasal_tpu_torch.ops.subsample import SHADOW_COORD
from weasal_tpu_torch.utils.device import use_kernel

MAXPOOL_ROUTES = ("dense",)


class KPConvParams(NamedTuple):
    """Static hyper-parameters of one KPConv op."""
    kp_extent: float
    influence: str = "linear"        # 'constant' | 'linear' | 'gaussian'
    aggregation: str = "sum"         # 'sum' | 'closest'
    deformable: bool = False
    modulated: bool = False


AGGREGATIONS = ("sum", "closest")


def kernel_eligible(params: KPConvParams) -> bool:
    """Whether kernels B and C compute this conv: rigid sum aggregation
    (the JAX package's `pallas_eligible` without its width cap, which the
    port's kernels do not have)."""
    return not params.deformable and params.aggregation == "sum"


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
    """KPConv without offsets: [B, Nq, 3], [B, Ns, 3], [B, Nq, K],
    [B, Ns, Cin], [Kp, 3], [Kp, Cin, Cout] -> [B, Nq, Cout]; `inverse`:
    the edge's inverse lists for the fixed-order dX. Rigid sum convs run
    kernels B and C, 'closest' aggregation `kpconv_dense`; a deformable
    conv needs its offsets and calls `kpconv_dense` itself."""
    if params.deformable:
        raise ValueError("deformable KPConv requires offsets "
                         "(kpconv_dense)")
    if not kernel_eligible(params):
        return kpconv_dense(q_pts, s_pts, neighb_inds, x, kernel_points,
                            weights, params, inverse=inverse)[0]
    return KPConvFunction.apply(q_pts, s_pts, neighb_inds, x, kernel_points,
                                weights, params.kp_extent, params.influence,
                                inverse)


def kpconv_dense(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                 params: KPConvParams,
                 offsets: Optional[torch.Tensor] = None,
                 modulations: Optional[torch.Tensor] = None,
                 inverse: Optional[LazyInverse] = None):
    """The plain chain of weasal_tpu/ops/kpconv.py:171-236, every
    aggregation, rigid or deformable: direct differences from each
    neighbor to the (deformed) kernel points [B, Nq, K, Kp, 3], their
    squared norms, the influences, a one-hot of the nearest kernel point
    for 'closest', for a deformable conv the mask of neighbors inside some
    deformed kernel point's extent, the per-kernel-point aggregate (times
    the modulations of a modulated conv) and one folded GEMM.

    :param offsets: [B, Nq, Kp, 3] kernel-point offsets (deformable)
    :param modulations: [B, Nq, Kp] in (0, 2) (modulated)
    :param inverse: the edge's inverse lists: the neighbor-feature gather's
        dX adds over them in a fixed order on the card
    :return: (out [B, Nq, Cout], min_sq [B, Nq, Kp] or None): a deformable
        conv's squared distance from each deformed kernel point to its
        nearest neighbor (ties share the gradient, as jnp.min's), for the
        fitting regularizer
    """
    kp = kernel_points.shape[0]
    neighbors = gather_neighbors(s_pts, neighb_inds, SHADOW_COORD)
    neighbors = neighbors - q_pts[:, :, None, :]              # [B,Nq,K,3]
    if params.deformable:
        if offsets is None:
            raise ValueError("deformable KPConv requires offsets")
        deformed = kernel_points[None, None] + offsets        # [B,Nq,Kp,3]
        diffs = neighbors[:, :, :, None, :] - deformed[:, :, None, :, :]
    else:
        diffs = neighbors[:, :, :, None, :] - kernel_points[None, None, None]
    sq = diffs * diffs
    sq_distances = sq[..., 0] + sq[..., 1] + sq[..., 2]       # [B,Nq,K,Kp]
    min_sq = sq_distances.amin(dim=2) if params.deformable else None
    all_weights = influence_weights(sq_distances, params.kp_extent,
                                    params.influence)        # [B,Nq,Kp,K]
    if params.aggregation == "closest":
        # a comparison, not F.one_hot, which reads its indices' range
        # back to the host (no capture in a CUDA graph)
        closest = sq_distances.argmin(dim=-1)                 # [B,Nq,K]
        onehot = closest[..., None] == torch.arange(kp, device=x.device)
        all_weights = all_weights * onehot.transpose(-1, -2).to(
            all_weights.dtype)
    elif params.aggregation != "sum":
        raise ValueError(f"Unknown aggregation mode: {params.aggregation} "
                         f"(known: {AGGREGATIONS})")
    if params.deformable:
        # neighbors outside every deformed kernel point's extent drop out
        in_range = (sq_distances < params.kp_extent ** 2).any(dim=-1)
        all_weights = all_weights * in_range[:, :, None, :].to(
            all_weights.dtype)
    neighb_x = gather_rows(x, neighb_inds, None, inverse)     # [B,Nq,K,Cin]
    weighted = torch.einsum("bqpk,bqkc->bqpc", all_weights, neighb_x)
    if params.deformable and params.modulated:
        if modulations is None:
            raise ValueError("modulated KPConv requires modulations")
        weighted = weighted * modulations[..., None]
    b, nq = weighted.shape[:2]
    cin, cout = weights.shape[1:]
    out = weighted.reshape(b * nq, kp * cin) @ weights.reshape(kp * cin,
                                                               cout)
    return out.reshape(b, nq, cout), min_sq


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
