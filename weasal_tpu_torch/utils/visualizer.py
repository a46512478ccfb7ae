"""Model and cloud visualization as files.

Counterpart of weasal_tpu/utils/visualizer.py (the reference's mayavi
tooling, utils/visualizer.py:99-445 and utils/mayavi_visu.py): ply
snapshots, which any point-cloud viewer reads, and standalone HTML
viewers (utils/html_viewer.export_html). The JAX module also writes
matplotlib PNG previews; the port writes none (matplotlib is not a
dependency of the port) and opens no mayavi window.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional, Sequence

import numpy as np
import torch

from weasal_tpu_torch.data.batching import layer_radii
from weasal_tpu_torch.interop import _LIST_TOKEN
from weasal_tpu_torch.models.blocks import kpconv_modules
from weasal_tpu_torch.utils.html_viewer import export_html
from weasal_tpu_torch.utils.ply import write_ply


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def show_point_cloud(points: np.ndarray,
                     labels: Optional[np.ndarray] = None,
                     out_prefix: str = "cloud",
                     interactive: bool = False,
                     html: bool = True) -> str:
    """Write <prefix>.ply (x, y, z and, with labels, class) and, with
    `html`, the interactive viewer <prefix>.html; returns the ply's path.
    `interactive=True` (the JAX module's mayavi window) raises
    NotImplementedError: open the HTML viewer instead."""
    if interactive:
        raise NotImplementedError(
            "interactive=True opens a mayavi window, which the port does "
            "not use: open the HTML viewer (html=True) instead")
    fields = [np.asarray(points, np.float32)]
    names = ["x", "y", "z"]
    if labels is not None:
        fields.append(np.asarray(labels, np.int32))
        names.append("class")
    write_ply(out_prefix + ".ply", fields, names)
    if html:
        export_html(out_prefix + ".html",
                    layers=[(os.path.basename(out_prefix), points,
                             labels, 1.5)],
                    title=os.path.basename(out_prefix))
    return out_prefix + ".ply"


def show_batch(batch, out_dir: str = "debug_batch", sphere: int = 0):
    """Every pyramid level of one sphere of a `PyramidBatch` (tensors on
    any device, or numpy arrays) as sphere<s>_level<l>.ply, and one HTML
    viewer, sphere<s>_levels.html, whose arrow keys step through the
    levels; returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    outputs, frames = [], []
    for l in range(batch.num_layers):
        pts = _np(batch.points[l][sphere])
        mask = _np(batch.masks[l][sphere])
        prefix = join(out_dir, f"sphere{sphere}_level{l}")
        outputs.append(show_point_cloud(pts[mask], out_prefix=prefix,
                                        html=False))
        frames.append((f"level {l}", pts[mask], None, 1.5))
    outputs.append(export_html(join(out_dir, f"sphere{sphere}_levels.html"),
                               frames=frames,
                               title=f"sphere {sphere} pyramid levels"))
    return outputs


def _flax_path(name: str):
    """The JAX package's module path of a port module's name
    ("encoder_blocks.3.KPConv" -> ("encoder_blocks_3", "KPConv"))."""
    tokens, out = name.split("."), []
    for tok in tokens:
        if tok.isdigit() and out and _LIST_TOKEN.match(f"{out[-1]}_{tok}"):
            out[-1] = f"{out[-1]}_{tok}"
        else:
            out.append(tok)
    return tuple(out)


class ModelVisualizer:
    """Deformable-kernel inspector (reference utils/visualizer.py:99-445).

    Runs the network forward in eval mode on one batch, keeps each
    deformable conv's deformed kernel points (a forward hook on its
    offset conv, removed after the call: nothing changes on any other
    forward), then writes, for chosen query points, the deformed kernel
    positions with the input cloud as ply frames and HTML viewers.
    """

    def __init__(self, model):
        self.model = model
        # {conv name: [B, Nq, Kp, 3] deformed kernel points / kp_extent}
        # of the last `show_deformable_kernels` call, on the model's device
        self.deformed = {}

    def show_deformable_kernels(self, batch, out_dir: str = "deform_vis",
                                sphere: int = 0,
                                query_indices: Sequence[int] = (0, 1, 2)):
        """Writes block<i>_query<q>_kernels.ply (the kernel points of
        query q of the i-th deformable conv, in the order of the JAX
        package's tree of sown values: module names sorted), one
        block<i>_kernels.html per conv and input.ply / input.html;
        returns the plys and HTMLs of the kernels, as the JAX inspector
        does. The kernel points come back to world coordinates with the
        extent of their query level (`layer_radii`) and the query's
        position."""
        os.makedirs(out_dir, exist_ok=True)
        convs = sorted(((n, m) for n, m in kpconv_modules(self.model)
                        if m.params.deformable),
                       key=lambda nm: _flax_path(nm[0]))
        if not convs:
            print("Network has no deformable KPConv blocks; nothing to show")
            return []
        deformed = self.deformed = {}

        def keep(name, conv):
            def hook(_module, _inputs, output):
                offsets, _ = conv.split_offsets(output)
                deformed[name] = conv.deformed_kernel_points(offsets)
            return hook

        hooks = [m.offset_conv.register_forward_hook(keep(n, m))
                 for n, m in convs]
        training = self.model.training
        try:
            self.model.eval()
            with torch.no_grad():
                self.model(batch)
        finally:
            self.model.train(training)
            for h in hooks:
                h.remove()

        config = self.model.config
        conv_r, _, _ = layer_radii(config)
        extents = [r * config.KP_extent / config.conv_radius
                   for r in conv_r]
        points0 = _np(batch.points[0][sphere])
        mask0 = _np(batch.masks[0][sphere])
        level_sizes = [p.shape[1] for p in batch.points]
        frames = []
        for li, (name, _conv) in enumerate(convs):
            kp = _np(deformed[name][sphere])          # [Nq, Kp, 3]
            level = (level_sizes.index(kp.shape[0])
                     if kp.shape[0] in level_sizes else 0)
            q_pts = _np(batch.points[level][sphere])
            ext = extents[min(level, len(extents) - 1)]
            html_frames = []
            for qi in query_indices:
                if qi >= kp.shape[0]:
                    continue
                prefix = join(out_dir, f"block{li}_query{qi}")
                world = kp[qi] * ext + q_pts[qi][None, :]
                write_ply(prefix + "_kernels.ply",
                          world.astype(np.float32), ["x", "y", "z"])
                frames.append(prefix + "_kernels.ply")
                # one frame a query (g / h step between them), the
                # reference's point picker (utils/visualizer.py:206-229)
                rgb = np.tile(np.array([[214, 39, 40]], np.uint8),
                              (world.shape[0], 1))
                html_frames.append((f"query {qi} deformed kernel",
                                    world.astype(np.float32), rgb, 8.0))
            if html_frames:
                grey = np.tile(np.array([[150, 150, 150]], np.uint8),
                               (int(mask0.sum()), 1))
                export_html(join(out_dir, f"block{li}_kernels.html"),
                            layers=[("input cloud", points0[mask0], grey,
                                     1.2)],
                            frames=html_frames,
                            title=f"deformable kernels, block {li}")
                frames.append(join(out_dir, f"block{li}_kernels.html"))
        show_point_cloud(points0[mask0], out_prefix=join(out_dir, "input"))
        return frames
