"""KPConv and the pooling ops on the dense sphere layout, in plain PyTorch
on one device; autograd takes every gradient (the gathers' backward adds
the rows with `index_add_`).

Counterpart of weasal_tpu/ops/kpconv.py: `gather_neighbors` (:90),
`influence_weights` (:112), `kpconv` (:131-237), the dense route of
`max_pool` (:244), `closest_pool` (:297) and `global_average` (:303).

`KPConvParams.compute_dtype` "bfloat16" rounds the two products' inputs
to bf16 (`bf`) as the JAX package's XLA path does (:206-233).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from portbench.reference import work_log
from portbench.reference.ops.subsample import SHADOW_COORD

COMPUTE_DTYPES = ("float32", "bfloat16")
AGGREGATIONS = ("sum", "closest")


class KPConvParams(NamedTuple):
    """Static hyper-parameters of one KPConv op."""
    kp_extent: float
    influence: str = "linear"        # 'constant' | 'linear' | 'gaussian'
    aggregation: str = "sum"         # 'sum' | 'closest'
    deformable: bool = False
    modulated: bool = False
    compute_dtype: str = "float32"   # 'float32' | 'bfloat16'


def check_compute_dtype(compute_dtype: str) -> bool:
    """True for "bfloat16", False for "float32"; raises on any other."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"Unknown compute_dtype: {compute_dtype!r} "
                         f"(known: {COMPUTE_DTYPES})")
    return compute_dtype == "bfloat16"


def bf(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest bf16 (ties to even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def gather_neighbors(values: torch.Tensor, inds: torch.Tensor,
                     pad_value: float) -> torch.Tensor:
    """Gather [B, Ns, D] rows by [B, Nq, K] sphere-local indices; index Ns
    (the shadow) selects an appended constant `pad_value` row."""
    b, ns, d = values.shape
    pad = torch.full((b, 1, d), pad_value, dtype=values.dtype,
                     device=values.device)
    flat = torch.cat([values, pad], dim=1).reshape(b * (ns + 1), d)
    offs = (torch.arange(b, device=inds.device, dtype=torch.int64)
            * (ns + 1))[:, None, None]
    idx = inds.to(torch.int64) + offs
    out = flat.index_select(0, idx.reshape(-1))
    return out.reshape(b, inds.shape[1], inds.shape[2], d)


def influence_weights(sq_distances: torch.Tensor, kp_extent: float,
                      influence: str) -> torch.Tensor:
    """[B, Nq, K, Kp] squared distances -> [B, Nq, Kp, K] influences."""
    if influence == "constant":
        w = torch.ones_like(sq_distances)
    elif influence == "linear":
        w = torch.clamp(1.0 - torch.sqrt(sq_distances) / kp_extent, min=0.0)
    elif influence == "gaussian":
        sigma = kp_extent * 0.3
        w = torch.exp(-sq_distances / (2 * sigma ** 2 + 1e-9))
    else:
        raise ValueError(f"Unknown KP influence: {influence}")
    return w.transpose(-1, -2)


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
           params: KPConvParams) -> torch.Tensor:
    """KPConv without offsets: [B, Nq, 3], [B, Ns, 3], [B, Nq, K],
    [B, Ns, Cin], [Kp, 3], [Kp, Cin, Cout] -> [B, Nq, Cout]; a deformable
    conv needs its offsets and calls `kpconv_dense` itself."""
    work_log.conv(q_pts, s_pts, neighb_inds, x, weights)
    if params.deformable:
        raise ValueError("deformable KPConv requires offsets "
                         "(kpconv_dense)")
    return kpconv_dense(q_pts, s_pts, neighb_inds, x, kernel_points,
                        weights, params)[0]


def kpconv_dense(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                 params: KPConvParams,
                 offsets: Optional[torch.Tensor] = None,
                 modulations: Optional[torch.Tensor] = None):
    """The plain chain of weasal_tpu/ops/kpconv.py:171-236, every
    aggregation, rigid or deformable: direct differences from each
    neighbor to the (deformed) kernel points [B, Nq, K, Kp, 3], their
    squared norms, the influences, a one-hot of the nearest kernel point
    for 'closest', for a deformable conv the mask of neighbors inside some
    deformed kernel point's extent, the per-kernel-point aggregate (times
    the modulations of a modulated conv) and one folded GEMM.

    :param offsets: [B, Nq, Kp, 3] kernel-point offsets (deformable)
    :param modulations: [B, Nq, Kp] in (0, 2) (modulated)
    :return: (out [B, Nq, Cout], min_sq [B, Nq, Kp] or None): a deformable
        conv's squared distance from each deformed kernel point to its
        nearest neighbor, for the fitting regularizer
    """
    kp = kernel_points.shape[0]
    mxu = bf if check_compute_dtype(params.compute_dtype) else (lambda t: t)
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
        closest = sq_distances.argmin(dim=-1)                 # [B,Nq,K]
        onehot = closest[..., None] == torch.arange(kp, device=x.device)
        all_weights = all_weights * onehot.transpose(-1, -2).to(
            all_weights.dtype)
    elif params.aggregation != "sum":
        raise ValueError(f"Unknown aggregation mode: {params.aggregation} "
                         f"(known: {AGGREGATIONS})")
    if params.deformable:
        # neighbors outside every deformed kernel point's extent drop out
        inside = (sq_distances < params.kp_extent ** 2).any(dim=-1)
        all_weights = all_weights * inside[:, :, None, :].to(
            all_weights.dtype)
    neighb_x = gather_neighbors(x, neighb_inds, 0.0)          # [B,Nq,K,Cin]
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


def max_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Max over each pooling neighborhood; the shadow row is zero, so the
    result is clamped at >= 0 like the reference (ties share the
    gradient)."""
    return gather_neighbors(x, inds, 0.0).amax(dim=2)


def closest_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Features of the nearest support (column 0 of the sorted rows)."""
    return gather_neighbors(x, inds[:, :, :1], 0.0)[:, :, 0, :]


def global_average(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the point axis: [B, N, C] -> [B, C]."""
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
