"""Network blocks on the dense sphere-batch layout.

Counterpart of weasal_tpu/models/blocks.py. Tensors are [B, N_l, C] with
a [B, N_l] mask; blocks take (x, batch) and read their level's tensors by
`layer_ind`. Module attributes carry the flax names (`unary1.mlp`,
`batch_norm.{scale,bias,mean,var}`, `KPConv.weights`,
`KPConv.kernel_points`, `gamma`), so that weasal_tpu_torch/interop.py maps
a flax variable tree onto `state_dict` by renaming alone.

Fresh parameters come from an explicit `torch.Generator`; kernel-point
poses come from the crc32 pose seed of the JAX package (blocks.py:291-306)
and equal its `constants`. In training mode (`model.train()`) BatchNorm
normalizes with masked batch statistics and updates its running ones.
"""

from __future__ import annotations

import math
import zlib
from typing import Tuple

import numpy as np
import torch
from torch import nn

from weasal_tpu_torch.kernels.kernel_points import load_kernels
from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
from weasal_tpu_torch.parallel import ddp
from weasal_tpu_torch.utils import prng

LEAKY_SLOPE = 0.1
# The threefry stream (utils/prng) of the dropout masks; the contrast
# loss draws from another stream of the same step seed
DROPOUT_STREAM = 0


def leaky_relu(x):
    return torch.nn.functional.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def dropout_keep(shape, rate: float, seed: torch.Tensor) -> torch.Tensor:
    """The keep mask of `dropout`: uniforms of the step's threefry bits
    (utils/prng.uniform over the flattened shape, on the seed's device)
    below 1 - rate, as flax's Dropout draws `bernoulli(1 - rate)`.

    :param seed: a 0-d or 1-element integer tensor (values < 2^32); it
        stays on the device, so a captured graph draws a new mask on each
        replay of a new seed

    Under a data-parallel group `shape` is this rank's spheres, and the
    mask is its slice of the global batch's (parallel/ddp.sphere_offset).
    """
    n = math.prod(int(d) for d in shape)
    u = prng.uniform(seed.reshape(1), n, DROPOUT_STREAM,
                     offset=ddp.sphere_offset(n))
    return (u < 1.0 - rate).reshape(shape)


def dropout(x: torch.Tensor, rate: float, seed=None,
            keep=None) -> torch.Tensor:
    """Dropout in training mode, as flax.linen.Dropout: kept elements
    divided by 1 - rate, the others 0. The mask is `keep` when given (a
    bool tensor of x's shape), else `dropout_keep(x.shape, rate, seed)`;
    never torch's global generator."""
    if not rate:
        return x
    if keep is None:
        if seed is None:
            raise ValueError("dropout in training mode needs a seed tensor "
                             "or a keep mask")
        keep = dropout_keep(x.shape, rate, seed)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _uniform(shape, bound: float, generator: torch.Generator):
    return nn.Parameter(
        (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound)


class Linear(nn.Module):
    """Bias-free linear map with torch's [out, in] `weight` layout (the
    flax `mlp` kernel transposed); init uniform(+-1/sqrt(in))."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.weight = _uniform((out_dim, in_dim), 1.0 / math.sqrt(in_dim),
                               generator)

    def forward(self, x):
        return x @ self.weight.t()


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the real rows of a padded batch (`scale`, `bias`,
    buffers `mean`, `var`), or a learned bias when use_bn is False.

    Counterpart of weasal_tpu/models/blocks.py:59-114. In training mode
    it normalizes with the batch mean and biased variance over the rows
    where `mask` is set (count = max(sum(mask), 1)), and each call updates
    the running statistics with the torch-convention `momentum`
    (running = (1 - momentum) * running + momentum * batch), the running
    variance taking the unbiased var * count / max(count - 1, 1). In eval
    mode it normalizes with the running statistics."""

    def __init__(self, features: int, use_bn: bool, momentum: float,
                 eps: float = 1e-5):
        super().__init__()
        self.use_bn = use_bn
        self.momentum = momentum
        self.eps = eps
        self.bias = nn.Parameter(torch.zeros(features))
        if use_bn:
            self.scale = nn.Parameter(torch.ones(features))
            self.register_buffer("mean", torch.zeros(features))
            self.register_buffer("var", torch.ones(features))

    def forward(self, x, mask=None):
        if not self.use_bn:
            return x + self.bias
        if self.training:
            m = (torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
                 if mask is None else mask.to(x.dtype))[..., None]
            dims = tuple(range(x.dim() - 1))
            # global sums: the statistics of the global batch under a
            # data-parallel group (two passes, as the JAX block; the count
            # rides in the first pass's collective)
            total, count = ddp.global_sums((x * m).sum(dim=dims), m.sum())
            count = count.clamp(min=1.0)
            mean = total / count
            var = ddp.global_sum((((x - mean) ** 2) * m).sum(dim=dims)) \
                / count
            with torch.no_grad():
                mom = self.momentum
                self.mean.copy_((1 - mom) * self.mean + mom * mean)
                unbiased = var * count / (count - 1.0).clamp(min=1.0)
                self.var.copy_((1 - mom) * self.var + mom * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * inv + self.bias


class UnaryBlock(nn.Module):
    """Linear (no bias) + BN + LeakyReLU."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool,
                 bn_momentum: float, generator: torch.Generator,
                 no_relu: bool = False):
        super().__init__()
        self.mlp = Linear(in_dim, out_dim, generator)
        self.batch_norm = MaskedBatchNorm(out_dim, use_bn, bn_momentum)
        self.no_relu = no_relu

    def forward(self, x, mask):
        x = self.batch_norm(self.mlp(x), mask)
        return x if self.no_relu else leaky_relu(x)


class KPConv(nn.Module):
    """Kernel point convolution: `weights` [Kp, Cin, Cout] and a
    `kernel_points` [Kp, 3] buffer posed from `pose_seed`.

    A deformable conv (weasal_tpu/models/blocks.py:177-205) also holds an
    `offset_conv`, a rigid KPConv of its own inputs to (p_dim + modulated)
    * Kp channels posed from `pose_seed + 1`, and an `offset_bias`: its
    output plus the bias gives each query's kernel-point offsets (times
    kp_extent) and, modulated, 2 * sigmoid modulations. In training mode
    each forward keeps the fitting regularizer's inputs in
    `regularizer_inputs` (:233-246): the squared distances to the nearest
    neighbor / extent^2 [B, Nq, Kp], the deformed kernel points / extent
    [B, Nq, Kp, 3] and the real-query mask [B, Nq] (a row with any
    non-shadow neighbor), all on the device; `deform_terms` collects
    them."""

    def __init__(self, kernel_size: int, p_dim: int, in_channels: int,
                 out_channels: int, kp_extent: float, radius: float,
                 generator: torch.Generator, layer_ind: int, strided: bool,
                 fixed_kernel_points: str = "center",
                 influence: str = "linear", aggregation: str = "sum",
                 pose_seed: int = 0, deformable: bool = False,
                 modulated: bool = False, compute_dtype: str = "float32"):
        super().__init__()
        ops.check_compute_dtype(compute_dtype)
        self.params = ops.KPConvParams(kp_extent=kp_extent,
                                       influence=influence,
                                       aggregation=aggregation,
                                       deformable=deformable,
                                       modulated=modulated,
                                       compute_dtype=compute_dtype)
        self.layer_ind = layer_ind
        self.strided = strided
        self.p_dim = p_dim
        self.weights = _uniform((kernel_size, in_channels, out_channels),
                                1.0 / math.sqrt(in_channels * out_channels),
                                generator)
        kp = load_kernels(radius, kernel_size, p_dim, fixed_kernel_points,
                          rng=np.random.default_rng(pose_seed))
        self.register_buffer("kernel_points", torch.from_numpy(kp))
        self.regularizer_inputs = None
        if deformable:
            offset_dim = (p_dim + int(modulated)) * kernel_size
            self.offset_conv = KPConv(
                kernel_size, p_dim, in_channels, offset_dim, kp_extent,
                radius, generator, layer_ind, strided,
                fixed_kernel_points=fixed_kernel_points,
                influence=influence, aggregation=aggregation,
                pose_seed=pose_seed + 1, compute_dtype=compute_dtype)
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))

    def split_offsets(self, offset_feats):
        """(offsets [B, Nq, Kp, p_dim] times kp_extent, modulations
        [B, Nq, Kp] or None) of a deformable conv's `offset_conv` output
        (`offset_bias` is added here)."""
        n_kp = self.kernel_points.shape[0]
        feats = offset_feats + self.offset_bias
        b, nq = feats.shape[:2]
        modulations = None
        if self.params.modulated:
            offsets = feats[..., :self.p_dim * n_kp]
            modulations = 2 * torch.sigmoid(feats[..., self.p_dim * n_kp:])
        else:
            offsets = feats
        offsets = offsets.reshape(b, nq, n_kp, self.p_dim) \
            * self.params.kp_extent
        return offsets, modulations

    def deformed_kernel_points(self, offsets):
        """[B, Nq, Kp, 3] deformed kernel points / kp_extent, in each
        query's frame, of `split_offsets`' offsets."""
        return (self.kernel_points[None, None] + offsets) \
            / self.params.kp_extent

    def forward(self, q_pts, s_pts, neighb_inds, x, inverse=None):
        if not self.params.deformable:
            return ops.kpconv(q_pts, s_pts, neighb_inds, x,
                              self.kernel_points, self.weights, self.params,
                              inverse=inverse)
        extent = self.params.kp_extent
        offsets, modulations = self.split_offsets(
            self.offset_conv(q_pts, s_pts, neighb_inds, x, inverse))
        out, min_sq = ops.deformable_kpconv(
            q_pts, s_pts, neighb_inds, x, self.kernel_points, self.weights,
            self.params, offsets=offsets, modulations=modulations,
            inverse=inverse)
        if self.training:
            q_valid = (neighb_inds < s_pts.shape[1]).any(dim=-1)
            self.regularizer_inputs = (
                min_sq / extent ** 2, self.deformed_kernel_points(offsets),
                q_valid.to(out.dtype))
        return out


def deform_terms(model: nn.Module):
    """The regularizer inputs that the deformable convs of `model` kept in
    its last training-mode forward (`KPConv.regularizer_inputs`), in
    registration order; each conv's are taken (cleared), so a later
    forward cannot see them. Empty for a rigid network."""
    terms = []
    for m in model.modules():
        if isinstance(m, KPConv) and m.regularizer_inputs is not None:
            terms.append(m.regularizer_inputs)
            m.regularizer_inputs = None
    return terms


def conv_inputs(strided: bool, layer_ind: int, batch):
    """(query points, support points, neighbor rows, output mask) of a
    conv at `layer_ind`; a strided conv goes from level l to l+1."""
    if strided:
        return (batch.points[layer_ind + 1], batch.points[layer_ind],
                batch.pools[layer_ind], batch.masks[layer_ind + 1])
    return (batch.points[layer_ind], batch.points[layer_ind],
            batch.neighbors[layer_ind], batch.masks[layer_ind])


def conv_inverse(strided: bool, layer_ind: int, batch):
    """The LazyInverse of a conv's neighbor rows (see conv_inputs)."""
    return batch.inverse("pools" if strided else "neighbors", layer_ind)


def _make_kpconv(cfg, block_name: str, in_dim: int, out_dim: int,
                 radius: float, layer_ind: int, path: Tuple[str, ...],
                 generator: torch.Generator) -> KPConv:
    seed = zlib.crc32(
        ("/".join(path) + "|"
         + f"{block_name}|{in_dim}|{out_dim}|{radius:.6f}|{layer_ind}"
         ).encode())
    return KPConv(cfg.num_kernel_points, cfg.in_points_dim, in_dim, out_dim,
                  radius * cfg.KP_extent / cfg.conv_radius, radius,
                  generator, layer_ind, "strided" in block_name,
                  fixed_kernel_points=cfg.fixed_kernel_points,
                  influence=cfg.KP_influence,
                  aggregation=cfg.aggregation_mode,
                  pose_seed=seed & 0x7FFFFFFF,
                  deformable="deform" in block_name,
                  modulated=bool(cfg.modulated),
                  compute_dtype=getattr(cfg, "compute_dtype", "float32"))


class _ConvBlock(nn.Module):
    """Shared fields of conv-carrying blocks; `path` is the flax module
    path, which seeds the kernel-point poses."""

    def __init__(self, block_name, in_dim, out_dim, radius, layer_ind,
                 config, path: Tuple[str, ...]):
        super().__init__()
        self.block_name = block_name
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.radius = radius
        self.layer_ind = layer_ind
        self.config = config
        self.path = tuple(path)

    def _conv(self, in_dim, out_dim, generator):
        return _make_kpconv(self.config, self.block_name, in_dim, out_dim,
                            self.radius, self.layer_ind, self.path,
                            generator)

    def _sub(self, cls, name, generator, **kw):
        args = dict(block_name=self.block_name, in_dim=self.in_dim,
                    out_dim=self.out_dim, radius=self.radius,
                    layer_ind=self.layer_ind, config=self.config)
        args.update(kw)
        return cls(path=self.path + (name,), generator=generator, **args)

    def _unary(self, in_dim, out_dim, generator, no_relu=False):
        return UnaryBlock(in_dim, out_dim, self.config.use_batch_norm,
                          self.config.batch_norm_momentum, generator,
                          no_relu=no_relu)

    def _bn(self, features):
        return MaskedBatchNorm(features, self.config.use_batch_norm,
                               self.config.batch_norm_momentum)


class SimpleBlock(_ConvBlock):
    """KPConv(out_dim // 2) + BN + LeakyReLU."""
    width_div = 2

    def __init__(self, generator, **kw):
        super().__init__(**kw)
        width = self.out_dim // self.width_div
        self.KPConv = self._conv(self.in_dim, width, generator)
        self.batch_norm = self._bn(width)

    def forward(self, x, batch):
        strided = self.KPConv.strided
        q_pts, s_pts, neighb, out_mask = conv_inputs(
            strided, self.layer_ind, batch)
        x = self.KPConv(q_pts, s_pts, neighb, x,
                        conv_inverse(strided, self.layer_ind, batch))
        return leaky_relu(self.batch_norm(x, out_mask))


class SimpleBlock2(SimpleBlock):
    """SimpleBlock with the full out_dim."""
    width_div = 1


class ResnetBottleneckBlock(_ConvBlock):
    """unary -> KPConv -> unary with a (max-pooled) shortcut."""

    def __init__(self, generator, **kw):
        super().__init__(**kw)
        mid = self.out_dim // 4
        self.unary1 = (self._unary(self.in_dim, mid, generator)
                       if self.in_dim != mid else None)
        self.KPConv = self._conv(mid, mid, generator)
        self.batch_norm_conv = self._bn(mid)
        self.unary2 = self._unary(mid, self.out_dim, generator, no_relu=True)
        self.unary_shortcut = (
            self._unary(self.in_dim, self.out_dim, generator, no_relu=True)
            if self.in_dim != self.out_dim else None)

    def forward(self, features, batch):
        strided = self.KPConv.strided
        q_pts, s_pts, neighb, out_mask = conv_inputs(
            strided, self.layer_ind, batch)
        x = features
        if self.unary1 is not None:
            x = self.unary1(x, batch.masks[self.layer_ind])
        inverse = conv_inverse(strided, self.layer_ind, batch)
        x = self.KPConv(q_pts, s_pts, neighb, x, inverse)
        x = leaky_relu(self.batch_norm_conv(x, out_mask))
        x = self.unary2(x, out_mask)
        shortcut = (ops.max_pool(features, neighb, inverse) if strided
                    else features)
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, out_mask)
        return leaky_relu(x + shortcut)


class NearestUpsampleBlock(nn.Module):
    """Closest-neighbor upsampling from level layer_ind onto layer_ind-1."""

    def __init__(self, layer_ind: int):
        super().__init__()
        self.layer_ind = layer_ind

    def forward(self, x, batch):
        l = self.layer_ind - 1
        return ops.closest_pool(x, batch.upsamples[l],
                                batch.inverse("upsamples", l))


class MaxPoolBlock(nn.Module):
    """Neighborhood max over `pools[layer_ind + 1]`, the JAX block's edge
    (weasal_tpu/models/blocks.py:429-436): the rows of level l + 2 from
    indices into level l + 1, applied to the features it is given, with
    a 0.0 shadow slot (`ops.max_pool`). Its backward is kernel D on the
    card, over that edge's inverse lists for the features' own rows
    (a shadow index of the edge is a real row of wider features, as in
    the JAX package's gather)."""

    def __init__(self, layer_ind: int):
        super().__init__()
        self.layer_ind = layer_ind

    def forward(self, x, batch):
        inds = batch.pools[self.layer_ind + 1]
        return ops.max_pool(x, inds, LazyInverse(inds, x.shape[1]))


class GlobalAverageBlock(nn.Module):
    """Per-sphere masked mean at the last level."""

    def forward(self, x, batch):
        return ops.global_average(x, batch.masks[-1])


def _zero_padded(x, mask):
    return x * mask.to(x.dtype)[..., None]


class SpatialAttention(_ConvBlock):
    """Point-to-point self-attention per sphere; returns (merged, xn)."""

    def __init__(self, generator, **kw):
        super().__init__(**kw)
        d = self.out_dim
        self.simple1 = self._sub(SimpleBlock2, "simple1", generator)
        self.unary1 = self._unary(d, d // 8, generator)
        self.unary2 = self._unary(d, d // 8, generator)
        self.unary3 = self._unary(d, d, generator)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.simple2 = self._sub(SimpleBlock2, "simple2", generator)

    def forward(self, features, batch):
        mask = batch.masks[self.layer_ind]
        features = self.simple1(features, batch)
        x1 = self.unary1(features, mask)
        x2 = self.unary2(features, mask)
        x3 = self.unary3(features, mask)
        energy = torch.einsum("bnc,bmc->bnm", x1, x2)
        energy = energy.masked_fill(~mask[:, None, :], -math.inf)
        att = torch.einsum("bnm,bmc->bnc", torch.softmax(energy, dim=-1), x3)
        counts = mask.sum(dim=1).clamp(min=1).to(att.dtype)
        xn = att / counts[:, None, None]
        merged = self.simple2(self.gamma * att + features, batch)
        return merged, xn


class ChannelAttention(_ConvBlock):
    """C x C channel attention per sphere."""

    def __init__(self, generator, **kw):
        super().__init__(**kw)
        d8 = self.out_dim // 8
        self.simple1 = self._sub(SimpleBlock2, "simple1", generator,
                                 out_dim=d8)
        self.unary1 = self._unary(d8, d8, generator)
        self.unary2 = self._unary(d8, d8, generator)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.simple2 = self._sub(SimpleBlock2, "simple2", generator,
                                 in_dim=d8)

    def forward(self, features, batch):
        mask = batch.masks[self.layer_ind]
        features = self.simple1(features, batch)
        q = _zero_padded(self.unary1(features, mask), mask)
        k = _zero_padded(self.unary2(features, mask), mask)
        energy = torch.einsum("bnc,bnd->bcd", q, k)
        energy_new = energy.amax(dim=-1, keepdim=True) - energy
        att = torch.einsum("bnc,bcd->bnd", features,
                           torch.softmax(energy_new, dim=-1))
        return self.simple2(self.gamma * att + features, batch)


class ElevationAttention(_ConvBlock):
    """Attention keyed on (reduced height, absolute height)."""

    def __init__(self, generator, **kw):
        super().__init__(**kw)
        d = self.out_dim
        self.unary1 = self._unary(2, d, generator)
        self.unary2 = self._unary(2, d, generator)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.simple2 = self._sub(SimpleBlock2, "simple2", generator,
                                 in_dim=d)

    def forward(self, features, h, batch):
        mask = batch.masks[self.layer_ind]
        o_z = batch.center_pts[:, 2][:, None, None]
        ele_f = torch.cat([h, h + o_z], dim=-1)              # [B, N, 2]
        q = _zero_padded(self.unary1(ele_f, mask), mask)
        k = _zero_padded(self.unary2(ele_f, mask), mask)
        energy = torch.einsum("bnc,bnd->bcd", q, k)
        att = torch.einsum("bnc,bcd->bnd", features,
                           torch.softmax(energy, dim=-1))
        return self.simple2(self.gamma * att + features, batch)


class MultiPathAttention(_ConvBlock):
    """MPRM 4-path head; returns per-point class maps (sa, ca, no, pa)."""

    def __init__(self, generator, **kw):
        super().__init__(**kw)
        c = self.config.num_classes
        d = self.out_dim
        self.sa_f = self._sub(SpatialAttention, "sa_f", generator)
        self.ca_f = self._sub(ChannelAttention, "ca_f", generator)
        self.simple1 = self._sub(SimpleBlock2, "simple1", generator,
                                 in_dim=self.in_dim + d)
        self.sa_unary = self._unary(d, c, generator)
        self.ca_unary = self._unary(d, c, generator)
        self.no_unary = self._unary(self.in_dim, c, generator)
        self.pa_unary = self._unary(d, c, generator)

    def forward(self, features, batch):
        mask = batch.masks[self.layer_ind]
        sa, sa_xn = self.sa_f(features, batch)
        ca = self.ca_f(features, batch)
        pa = self.simple1(torch.cat([features, sa_xn], dim=-1), batch)
        return (self.sa_unary(sa, mask), self.ca_unary(ca, mask),
                self.no_unary(features, mask), self.pa_unary(pa, mask))


# The JAX decider's names (weasal_tpu/models/blocks.py:613-625): the
# invariant and equivariant variants are the plain blocks, and a
# "deformable" name makes its KPConv deformable
_SIMPLE = tuple(f"simple{kind}{stride}"
                for kind in ("", "_deformable", "_invariant", "_equivariant")
                for stride in ("", "_strided"))
_RESNETB = tuple(f"resnetb{kind}{stride}"
                 for kind in ("", "_deformable", "_invariant",
                              "_equivariant")
                 for stride in ("", "_strided"))


def block_decider(block_name: str, radius: float, in_dim: int, out_dim: int,
                  layer_ind: int, config, path: Tuple[str, ...],
                  generator: torch.Generator) -> nn.Module:
    """Map an architecture-DSL block name to its module, as the JAX
    package's decider (weasal_tpu/models/blocks.py:606-631). 'max_pool'
    and 'max_pool_wide' build `MaxPoolBlock` on the JAX block's edge,
    `pools[layer_ind + 1]`: from level l + 1 into l + 2, one level past
    the edge that a strided block of the same layer reads. Its output
    holds level l + 2's rows where the next block expects level l + 1's,
    so a model that holds the block fails in both packages (JAX's
    KPFCNN_mprm on [simple, resnetb, max_pool, resnetb, ...] with "add
    got incompatible shapes" at the next shortcut); no shipped
    architecture uses it."""
    kw = dict(block_name=block_name, in_dim=in_dim, out_dim=out_dim,
              radius=radius, layer_ind=layer_ind, config=config, path=path,
              generator=generator)
    if block_name == "unary":
        return UnaryBlock(in_dim, out_dim, config.use_batch_norm,
                          config.batch_norm_momentum, generator)
    if block_name in _SIMPLE:
        return SimpleBlock(**kw)
    if block_name in _RESNETB:
        return ResnetBottleneckBlock(**kw)
    if block_name == "global_average":
        return GlobalAverageBlock()
    if block_name == "nearest_upsample":
        return NearestUpsampleBlock(layer_ind)
    if block_name in ("max_pool", "max_pool_wide"):
        return MaxPoolBlock(layer_ind)
    raise ValueError(f"Unknown or unported block name: {block_name}")


def kpconv_modules(model: nn.Module):
    """(name, KPConv) pairs of a model, in registration order."""
    return [(n, m) for n, m in model.named_modules() if isinstance(m, KPConv)]


def kernel_convs(model: nn.Module):
    """The (name, KPConv) pairs of `kpconv_modules` that kernels B and C
    compute: every conv but the deformable and 'closest' ones (a
    deformable conv's offset conv included)."""
    return [(n, m) for n, m in kpconv_modules(model)
            if ops.kernel_eligible(m.params)]
