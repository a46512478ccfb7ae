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

`deformable_kpconv`, a deformable conv's chain, runs between two
identity Functions that mark its span on the device's clock, forward and
backward (ops/cuda/marks.py), and add its work to the span table's
`deform.fwd.*` and `deform.bwd.*` counters (`chain_work`;
utils/profiling). On the card an f32 sum-aggregation chain
(`deform_kernel_eligible`) runs `kpconv_fused`: its pair work (the
neighbor gather, the differences to the deformed kernel points, the
influences, the in-range mask, the minima and the aggregate) in the
hand-written kernels of `DeformPairsFunction` (ops/cuda/deform_kpconv.py),
counted in `deform.fused.fwd` / `deform.fused.bwd`, then the modulations'
product and the GEMM in plain PyTorch. 'closest' aggregation, compute_dtype
"bfloat16", the CPU and `plain_ops()` run `kpconv_dense`.

`KPConvParams.compute_dtype` "bfloat16" rounds the two products' inputs
to bf16 as the JAX package's XLA path does (:206-233): kernels B and C
run their bf16 variants (a bf16 aggregate y is kept for dW), and
`kpconv_dense` puts the same casts into its chain (`bf`), so that autograd
rounds the cotangents where `jax.grad` does. The JAX package's Pallas
kernel ignores compute_dtype (it runs only on a TPU, in f32 in interpret
mode), so the XLA path is the reference.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from weasal_tpu_torch.ops.cuda.deform_kpconv import (
    deform_aggregate_reference, deform_aggregate_reference_bwd,
    deform_pairs_bwd, deform_pairs_fwd, pair_geometry)
from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse, gather_rows
from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd, kpconv_bwd_plain
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (  # noqa: F401 (re-export)
    COMPUTE_DTYPES, bf, check_compute_dtype, gather_neighbors,
    influence_weights, kpconv_fwd, kpconv_fwd_plain, kpconv_fwd_plain_with_y,
    kpconv_fwd_with_y)
from weasal_tpu_torch.ops.cuda.marks import mark
from weasal_tpu_torch.ops.cuda.maxpool_bwd import (maxpool_bwd,
                                                   maxpool_bwd_plain)
from weasal_tpu_torch.utils.device import use_kernel
from weasal_tpu_torch.utils.profiling import counter

MAXPOOL_ROUTES = ("dense",)


class KPConvParams(NamedTuple):
    """Static hyper-parameters of one KPConv op."""
    kp_extent: float
    influence: str = "linear"        # 'constant' | 'linear' | 'gaussian'
    aggregation: str = "sum"         # 'sum' | 'closest'
    deformable: bool = False
    modulated: bool = False
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16'


AGGREGATIONS = ("sum", "closest")


def kernel_eligible(params: KPConvParams) -> bool:
    """Whether kernels B and C compute this conv: rigid sum aggregation
    (the JAX package's `pallas_eligible` without its width cap, which the
    port's kernels do not have)."""
    return not params.deformable and params.aggregation == "sum"


class KPConvFunction(torch.autograd.Function):
    """Rigid sum-aggregation KPConv whose forward is kernel B and whose
    backward is kernel C; gradients flow to x and the weights only. The
    forward's aggregate y [B*Nq, Kp*Cin] (bf16 under compute_dtype
    "bfloat16") is kept for dW."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                kp_extent: float, influence: str, inverse=None,
                compute_dtype: str = "float32"):
        ctx.kernel = use_kernel(x)
        ctx.inverse = inverse
        x, weights = x.contiguous(), weights.contiguous()
        fwd = kpconv_fwd_with_y if ctx.kernel else kpconv_fwd_plain_with_y
        out, y = fwd(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                     kp_extent, influence, compute_dtype)
        ctx.save_for_backward(q_pts, s_pts, neighb_inds, y, kernel_points,
                              weights)
        ctx.kp_extent, ctx.influence = kp_extent, influence
        ctx.compute_dtype = compute_dtype
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
            dx, dw = kpconv_bwd(*args, need_dx=need_dx, inverse=ctx.inverse,
                                compute_dtype=ctx.compute_dtype)
        else:
            dx, dw = kpconv_bwd_plain(*args, need_dx=need_dx,
                                      compute_dtype=ctx.compute_dtype)
        return None, None, None, dx, None, dw, None, None, None, None


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
                                inverse, params.compute_dtype)


# The deformable chain's discrete choices besides the influences' kink,
# each one function so that a check can record and replay them
# (chip_smoke.py's `Branches`)
def nearest(sq_distances: torch.Tensor) -> torch.Tensor:
    """[B, Nq, K, Kp] -> [B, Nq, Kp]: each kernel point's squared distance
    to its nearest neighbor (ties share the gradient)."""
    return sq_distances.amin(dim=2)


def in_range(sq_distances: torch.Tensor, kp_extent: float) -> torch.Tensor:
    """[B, Nq, K, Kp] -> [B, Nq, K]: the neighbors inside some kernel
    point's extent."""
    return (sq_distances < kp_extent ** 2).any(dim=-1)


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
    the modulations of a modulated conv) and one folded GEMM. Under
    compute_dtype "bfloat16" the inputs of the aggregate and of the GEMM
    are rounded to bf16 (`bf`) after the modulations, as in JAX (:221-233).

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
    mxu = bf if check_compute_dtype(params.compute_dtype) else (lambda t: t)
    if params.deformable and offsets is None:
        raise ValueError("deformable KPConv requires offsets")
    _, sq_distances = pair_geometry(
        q_pts, s_pts, neighb_inds, kernel_points,
        offsets if params.deformable else None)               # [B,Nq,K,Kp]
    min_sq = nearest(sq_distances) if params.deformable else None
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
        inside = in_range(sq_distances, params.kp_extent)
        all_weights = all_weights * inside[:, :, None, :].to(
            all_weights.dtype)
    neighb_x = gather_rows(x, neighb_inds, None, inverse)     # [B,Nq,K,Cin]
    weighted = torch.einsum("bqpk,bqkc->bqpc", mxu(all_weights),
                            mxu(neighb_x))
    if params.deformable and params.modulated:
        if modulations is None:
            raise ValueError("modulated KPConv requires modulations")
        weighted = weighted * modulations[..., None]
    b, nq = weighted.shape[:2]
    cin, cout = weights.shape[1:]
    out = mxu(weighted.reshape(b * nq, kp * cin)) @ mxu(
        weights.reshape(kp * cin, cout))
    return out.reshape(b, nq, cout), min_sq


def chain_work(q_pts, s_pts, neighb_inds, x, weights,
               modulated: bool) -> Tuple[Dict[str, int], Dict[str, int]]:
    """The work of one deformable chain (`kpconv_dense` with offsets) at
    the padded rows it computes, as counts of the span table: (forward,
    backward), each {"deform.<fwd|bwd>.<part>": n} with `calls` 1,
    `pairs` rows K Kp (neighbor-kernel point pairs: differences,
    influences, the mask, the minima), `aggregate` rows K Kp Cin (the
    aggregate's multiply-adds), `gemm` rows Kp Cin Cout (the GEMM's),
    `in_elems` and `out_elems` (elements of the inputs read and the
    outputs written: forward, the points, neighbor indices, features,
    kernel points, offsets, modulations and weights in, the output and
    the minima out; backward, those and the two outputs' gradients in,
    the gradients of the features, offsets, modulations and weights
    out). rows = B Nq."""
    b, nq, k = neighb_inds.shape
    ns, cin = x.shape[1], x.shape[2]
    kp, cout = weights.shape[0], weights.shape[2]
    rows = b * nq
    shifts = rows * kp * (3 + int(modulated))
    inputs = (rows * 3 + b * ns * 3 + rows * k + b * ns * cin + kp * 3
              + shifts + kp * cin * cout)
    outputs = rows * cout + rows * kp
    grads = b * ns * cin + shifts + kp * cin * cout
    common = dict(calls=1, pairs=rows * k * kp, aggregate=rows * k * kp * cin,
                  gemm=rows * kp * cin * cout)
    return ({f"deform.fwd.{n}": v for n, v in dict(
                common, in_elems=inputs, out_elems=outputs).items()},
            {f"deform.bwd.{n}": v for n, v in dict(
                common, in_elems=inputs + outputs, out_elems=grads).items()})


def deform_kernel_eligible(params: KPConvParams) -> bool:
    """Whether a deformable conv's pair work runs the kernels of
    `DeformPairsFunction` on the card: sum aggregation in f32 ('closest'
    and compute_dtype "bfloat16" run `kpconv_dense`)."""
    return (params.deformable and params.aggregation == "sum"
            and params.compute_dtype == "float32")


class DeformPairsFunction(torch.autograd.Function):
    """A deformable conv's pair work: (y [B, Nq, Kp, Cin], min_sq
    [B, Nq, Kp]) of x and the offsets (ops/cuda/deform_kpconv.py). On the
    card the forward and the backward are the kernels `deform_pairs_fwd`
    and `deform_pairs_bwd` (dX added over the edge's inverse lists, the
    offsets' gradient in the kernel), each counted once in the span table
    (`deform.fused.fwd`, `deform.fused.bwd`); elsewhere they are the
    plain `deform_aggregate_reference` and its hand-derived backward.
    Points, neighbor indices and kernel points get no gradient; a
    min_sq whose gradient is None takes none."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
                kp_extent: float, influence: str, inverse=None):
        ctx.set_materialize_grads(False)
        ctx.kernel = use_kernel(x)
        ctx.inverse = inverse
        x, offsets = x.contiguous(), offsets.contiguous()
        if ctx.kernel:
            neighb_inds = neighb_inds.to(torch.int32).contiguous()
            y, min_sq = deform_pairs_fwd(q_pts, s_pts, neighb_inds, x,
                                         kernel_points, offsets, kp_extent,
                                         influence)
            counter("deform.fused.fwd")
        else:
            y, min_sq = deform_aggregate_reference(
                q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
                kp_extent, influence)
        ctx.save_for_backward(q_pts, s_pts, neighb_inds, x, kernel_points,
                              offsets)
        ctx.kp_extent, ctx.influence = kp_extent, influence
        return y, min_sq

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dmin):
        q_pts, s_pts, neighb_inds, x, kernel_points, offsets = \
            ctx.saved_tensors
        if dy is None:
            b, nq = neighb_inds.shape[:2]
            dy = x.new_zeros((b, nq, kernel_points.shape[0], x.shape[2]))
        args = (q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
                dy.contiguous(), None if dmin is None else dmin.contiguous(),
                ctx.kp_extent, ctx.influence)
        flags = dict(need_dx=ctx.needs_input_grad[3],
                     need_doff=ctx.needs_input_grad[5], inverse=ctx.inverse)
        if ctx.kernel:
            dx, doff = deform_pairs_bwd(*args, **flags)
            counter("deform.fused.bwd")
        else:
            dx, doff = deform_aggregate_reference_bwd(*args, **flags)
        return None, None, None, dx, None, doff, None, None, None


def deform_pairs(q_pts, s_pts, neighb_inds, x, kernel_points, offsets,
                 params: KPConvParams,
                 inverse: Optional[LazyInverse] = None):
    """`DeformPairsFunction` of a deformable conv (a module-level function,
    so that a check can record the branches its kernels take:
    chip_smoke.py's `Branches`)."""
    return DeformPairsFunction.apply(q_pts, s_pts, neighb_inds, x,
                                     kernel_points, offsets,
                                     params.kp_extent, params.influence,
                                     inverse)


def kpconv_fused(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                 params: KPConvParams, offsets: torch.Tensor,
                 modulations: Optional[torch.Tensor] = None,
                 inverse: Optional[LazyInverse] = None):
    """`kpconv_dense` of a deformable sum-aggregation conv in f32 with its
    pair work in `deform_pairs`; the modulations' product and the folded
    GEMM are `kpconv_dense`'s. Returns (out [B, Nq, Cout], min_sq
    [B, Nq, Kp])."""
    y, min_sq = deform_pairs(q_pts, s_pts, neighb_inds, x, kernel_points,
                             offsets, params, inverse)
    if params.modulated:
        if modulations is None:
            raise ValueError("modulated KPConv requires modulations")
        y = y * modulations[..., None]
    b, nq, kp, cin = y.shape
    cout = weights.shape[2]
    out = y.reshape(b * nq, kp * cin) @ weights.reshape(kp * cin, cout)
    return out.reshape(b, nq, cout), min_sq


class _SpanEdge(torch.autograd.Function):
    """Identity on its tensors: the forward launches the mark `fwd` and
    adds `fwd_work` to the span table, the backward (once every output's
    gradient is in) launches `bwd` and adds `bwd_work`."""

    @staticmethod
    def forward(ctx, fwd, bwd, fwd_work, bwd_work, *tensors):
        ctx.set_materialize_grads(False)
        ctx.bwd, ctx.bwd_work = bwd, bwd_work
        ctx.device = tensors[0].device
        mark(fwd, ctx.device)
        for name, n in fwd_work.items():
            counter(name, n)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.bwd, ctx.device)
        for name, n in ctx.bwd_work.items():
            counter(name, n)
        return (None, None, None, None, *grads)


def deformable_kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                      params: KPConvParams, offsets: torch.Tensor,
                      modulations: Optional[torch.Tensor] = None,
                      inverse: Optional[LazyInverse] = None):
    """A deformable conv's chain inside its span: the marks
    `deform_fwd_begin` before the chain and `deform_fwd_end` after it
    (on the chain's inputs x, offsets, modulations and weights, and on
    its outputs), whose backwards launch `deform_bwd_end` and
    `deform_bwd_begin`; the chain's forward work (`chain_work`) counted
    at the first, its backward work at `deform_bwd_begin`. The chain is
    `kpconv_fused` on the card for `deform_kernel_eligible` params,
    `kpconv_dense` otherwise; the values are `kpconv_dense`'s (the fused
    chain's up to f32 sums in another order, its in-range flags and
    minima bit for bit)."""
    fwd_work, bwd_work = chain_work(q_pts, s_pts, neighb_inds, x, weights,
                                    modulations is not None)
    inputs = [x, offsets, weights] + ([modulations] if modulations
                                      is not None else [])
    x, offsets, weights, *mods = _SpanEdge.apply(
        "deform_fwd_begin", "deform_bwd_end", fwd_work, {}, *inputs)
    chain = (kpconv_fused if deform_kernel_eligible(params)
             and use_kernel(x) else kpconv_dense)
    out, min_sq = chain(q_pts, s_pts, neighb_inds, x, kernel_points,
                        weights, params, offsets=offsets,
                        modulations=mods[0] if mods else None,
                        inverse=inverse)
    return _SpanEdge.apply("deform_fwd_end", "deform_bwd_begin", {},
                           bwd_work, out, min_sq)


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
