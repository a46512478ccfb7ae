"""The networks of the two training stages.

Counterpart of weasal_tpu/models/architectures.py: `_encoder_plan` (:56),
`_decoder_plan` (:84), `KPFCNN` (:109-162), the pseudo-label stage's
encoder-decoder with skip concats, dropout and a two-unary head, and
`KPFCNN_mprm` (:164-233), the weak-label network: encoder, elevation
attention, MPRM 4-path heads, per-path global-average class logits, the
shared nearest-upsample decoder run on the four class-map streams as one
channel-concatenated gather, and the elementwise-max fusion.
`model_for_config` picks one by `config.model_name`, as the JAX trainer's
`_model_for_config` (weasal_tpu/train/trainer.py:107-118) does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from weasal_tpu_torch.models.blocks import (
    ElevationAttention, MultiPathAttention, NearestUpsampleBlock,
    UnaryBlock, block_decider, dropout)
from weasal_tpu_torch.ops.kpconv import global_average


def _encoder_plan(config):
    """Walk the architecture list; per-block build info + final dims."""
    layer = 0
    r = config.first_subsampling_dl * config.conv_radius
    in_dim = config.in_features_dim
    out_dim = config.first_features_dim
    blocks, skip_blocks, skip_dims = [], [], []
    for block_i, block in enumerate(config.architecture):
        if ("equivariant" in block) and out_dim % 3 != 0:
            raise ValueError("Equivariant block with dim not multiple of 3")
        if any(tmp in block for tmp in
               ("pool", "strided", "upsample", "global", "attention")):
            skip_blocks.append(block_i)
            skip_dims.append(in_dim)
        if "attention" in block or "upsample" in block:
            break
        blocks.append((block, r, in_dim, out_dim, layer))
        in_dim = out_dim // 2 if "simple" in block else out_dim
        if "pool" in block or "strided" in block:
            layer += 1
            r *= 2
            out_dim *= 2
    return blocks, skip_blocks, skip_dims, in_dim, out_dim, layer, r


def _decoder_plan(config, skip_dims, layer, r, out_dim):
    """Build info for decoder blocks + skip-concat block indices."""
    start_i = 0
    for block_i, block in enumerate(config.architecture):
        if "upsample" in block:
            start_i = block_i
            break
    in_dim = out_dim
    blocks, concats = [], []
    for block_i, block in enumerate(config.architecture[start_i:]):
        if block_i > 0 and "upsample" in config.architecture[
                start_i + block_i - 1]:
            in_dim += skip_dims[layer]
            concats.append(block_i)
        blocks.append((block, r, in_dim, out_dim, layer))
        in_dim = out_dim
        if "upsample" in block:
            layer -= 1
            r *= 0.5
            out_dim = out_dim // 2
    return blocks, concats


def _split_channels(x, widths):
    off = 0
    for w in widths:
        yield x[..., off:off + w]
        off += w


def _check_labels(config, lbl_values, ign_lbls):
    if getattr(config, "compute_dtype", "float32") != "float32":
        raise NotImplementedError("only compute_dtype float32 is ported")
    if len(lbl_values) - len(ign_lbls) != config.num_classes:
        raise ValueError("label values minus ignored labels must give "
                         "config.num_classes classes")


class KPFCNN(nn.Module):
    """Pseudo-label segmentation network; forward(batch) returns the
    logits [B, N_0, C].

    In training mode dropout (`config.dropout`) acts before the head; its
    mask comes from `dropout_keep` (a bool tensor of the head's input
    shape) or is drawn from `dropout_seed` (models/blocks.dropout). As in
    the JAX package, `head_softmax` ends in a leaky ReLU."""
    mode = "pseudo"

    def __init__(self, config, lbl_values: Sequence[int],
                 ign_lbls: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_labels(config, lbl_values, ign_lbls)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.lbl_values = tuple(lbl_values)
        self.ign_lbls = tuple(ign_lbls)
        num_classes = len(lbl_values) - len(ign_lbls)
        enc, skips, skip_dims, _in, out_dim, layer, r = _encoder_plan(config)
        self.encoder_skips = tuple(skips)
        self.encoder_blocks = nn.ModuleList([
            block_decider(b, rr, di, do, li, config,
                          (f"encoder_blocks_{i}",), generator)
            for i, (b, rr, di, do, li) in enumerate(enc)])
        dec, concats = _decoder_plan(config, skip_dims, layer, r, out_dim)
        self.decoder_concats = tuple(concats)
        self.decoder_blocks = nn.ModuleList([
            block_decider(b, rr, di, do, li, config,
                          (f"decoder_blocks_{i}",), generator)
            for i, (b, rr, di, do, li) in enumerate(dec)])
        head_in = dec[-1][3] if dec else out_dim
        self.head_mlp = UnaryBlock(head_in, config.first_features_dim,
                                   False, 0.0, generator)
        self.head_softmax = UnaryBlock(config.first_features_dim,
                                       num_classes, False, 0.0, generator)
        self.dropout_rate = float(getattr(config, "dropout", 0) or 0)

    def forward(self, batch, dropout_seed: Optional[torch.Tensor] = None,
                dropout_keep: Optional[torch.Tensor] = None):
        x = batch.features
        mask0 = batch.masks[0]
        skip_x = []
        for block_i, block in enumerate(self.encoder_blocks):
            if block_i in self.encoder_skips:
                skip_x.append(x)
            x = block(x, batch)
        level = len(batch.points) - 1
        for block_i, block in enumerate(self.decoder_blocks):
            if block_i in self.decoder_concats:
                x = torch.cat([x, skip_x.pop()], dim=-1)
            if isinstance(block, UnaryBlock):
                x = block(x, batch.masks[level])
            else:
                x = block(x, batch)
                level -= 1
        if self.training:
            x = dropout(x, self.dropout_rate, seed=dropout_seed,
                        keep=dropout_keep)
        x = self.head_mlp(x, mask0)
        return self.head_softmax(x, mask0)


class KPFCNN_mprm(nn.Module):
    """Weak-label multi-path network; forward(batch) returns
    (logits [B, N_0, C], cla_logits [4 x [B, C]], cam [4 x [B, N_0, C]])
    with the paths in the order (no, pa, sa, ca)."""
    mode = "weak"

    def __init__(self, config, lbl_values: Sequence[int],
                 ign_lbls: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_labels(config, lbl_values, ign_lbls)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.lbl_values = tuple(lbl_values)
        self.ign_lbls = tuple(ign_lbls)
        enc, _skips, skip_dims, _in, out_dim, layer, r = _encoder_plan(config)
        self.encoder_blocks = nn.ModuleList([
            block_decider(b, rr, di, do, li, config,
                          (f"encoder_blocks_{i}",), generator)
            for i, (b, rr, di, do, li) in enumerate(enc)])
        self.att_layer = layer
        self.multi_att = MultiPathAttention(
            block_name="attention", in_dim=out_dim, out_dim=out_dim,
            radius=r, layer_ind=layer, config=config, path=("multi_att",),
            generator=generator)
        self.ele_head = ElevationAttention(
            block_name="ele_attention", in_dim=2, out_dim=out_dim, radius=r,
            layer_ind=layer, config=config, path=("ele_head",),
            generator=generator)
        dec, _ = _decoder_plan(config, skip_dims, layer, r, out_dim)
        self.decoder_blocks = nn.ModuleList([
            block_decider(b, rr, di, do, li, config,
                          (f"decoder_blocks_{i}",), generator)
            for i, (b, rr, di, do, li) in enumerate(dec)])
        self.decoder_levels = tuple(li for (_, _, _, _, li) in dec)

    def forward(self, batch):
        x = batch.features
        ele_down = batch.points[self.att_layer][:, :, 2:3]
        for block in self.encoder_blocks:
            x = block(x, batch)
        x = self.ele_head(x, ele_down, batch)
        sa, ca, no, pa = self.multi_att(x, batch)

        att_mask = batch.masks[self.att_layer]
        cla_logits = [global_average(p, att_mask) for p in (no, pa, sa, ca)]

        paths = [no, pa, sa, ca]
        for block, level in zip(self.decoder_blocks, self.decoder_levels):
            if isinstance(block, UnaryBlock):
                paths = [block(p, batch.masks[level]) for p in paths]
            elif isinstance(block, NearestUpsampleBlock):
                widths = [p.shape[-1] for p in paths]
                fused = block(torch.cat(paths, dim=-1), batch)
                paths = list(_split_channels(fused, widths))
            else:
                paths = [block(p, batch) for p in paths]
        no, pa, sa, ca = paths
        x = torch.maximum(torch.maximum(no, pa), torch.maximum(sa, ca))
        return x, cla_logits, paths


def model_for_config(config, label_values: Sequence[int],
                     ignored_labels: Sequence[int],
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Module:
    """The network of `config.model_name` ('KPFCNN_mprm', the default, or
    'KPFCNN'); its `mode` attribute names the training stage ('weak' or
    'pseudo')."""
    name = getattr(config, "model_name", "KPFCNN_mprm")
    classes = {"KPFCNN_mprm": KPFCNN_mprm, "KPFCNN": KPFCNN}
    if name not in classes:
        raise ValueError(f"Unsupported model: {name}")
    return classes[name](config, tuple(int(v) for v in label_values),
                         tuple(int(v) for v in ignored_labels),
                         generator=generator)

