"""KPConv and the pooling ops on the dense sphere layout.

Counterpart of weasal_tpu/ops/kpconv.py: `gather_neighbors` (:90),
`influence_weights` (:112), the rigid sum-aggregation branch of `kpconv`
(:131-237), the dense route of `max_pool` (:244), `closest_pool` (:297)
and `global_average` (:303). Deformable kernels and 'closest'
aggregation are not ported and raise.

`kpconv` sends CUDA tensors to kernel B (ops/cuda/kpconv_fwd.py) and CPU
tensors to its plain version. `max_pool` is plain torch on every device:
on the JAX path its forward is XLA's (ops/pallas/maxpool_banded.py:178),
and only its backward is a Pallas kernel.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from weasal_tpu_torch.ops.cuda.kpconv_fwd import (  # noqa: F401 (re-export)
    gather_neighbors, influence_weights, kpconv_fwd, kpconv_fwd_plain)
from weasal_tpu_torch.utils.device import use_kernel

MAXPOOL_ROUTES = ("dense",)


class KPConvParams(NamedTuple):
    """Static hyper-parameters of one KPConv op."""
    kp_extent: float
    influence: str = "linear"        # 'constant' | 'linear' | 'gaussian'
    aggregation: str = "sum"         # only 'sum' is ported


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
           params: KPConvParams) -> torch.Tensor:
    """Rigid KPConv: [B, Nq, 3], [B, Ns, 3], [B, Nq, K], [B, Ns, Cin],
    [Kp, 3], [Kp, Cin, Cout] -> [B, Nq, Cout]."""
    if params.aggregation != "sum":
        raise NotImplementedError(
            "only sum-aggregation KPConv is ported")
    if use_kernel(x):
        out, _oob = kpconv_fwd(q_pts, s_pts, neighb_inds, x, kernel_points,
                               weights, params.kp_extent, params.influence)
        return out
    return kpconv_fwd_plain(q_pts, s_pts, neighb_inds, x, kernel_points,
                            weights, params.kp_extent, params.influence)


def max_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Max over each pooling neighborhood; the shadow row is zero, so the
    result is clamped at >= 0 like the reference. Only the 'dense' route
    is ported: `WEASAL_MAXPOOL` naming another one raises."""
    route = os.environ.get("WEASAL_MAXPOOL", "") or "dense"
    if route not in MAXPOOL_ROUTES:
        raise ValueError(f"max_pool route {route!r} is not ported "
                         f"(known: {MAXPOOL_ROUTES})")
    return gather_neighbors(x, inds, 0.0).amax(dim=2)


def closest_pool(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """Features of the nearest support (column 0 of the sorted rows)."""
    return gather_neighbors(x, inds[:, :, :1], 0.0)[:, :, 0, :]


def global_average(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the point axis: [B, N, C] -> [B, C]."""
    m = mask.to(x.dtype)[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
