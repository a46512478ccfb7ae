"""Configuration: the attributes the inference and training steps read.

Counterpart of weasal_tpu/config.py (the `Config` parameter bag). Datasets
subclass `Config` and override attributes; `num_layers` and
`deform_layers` are derived from the architecture in `__init__`. The
`parameters.txt` round-trip is not ported yet.
"""

from __future__ import annotations

from typing import List


class Config:
    """Parameter bag for one model (subclass per dataset)."""

    # Input
    num_classes = 0
    in_points_dim = 3
    in_features_dim = 1
    in_radius = 1.0

    # Model
    architecture: List[str] = []
    first_features_dim = 64
    use_batch_norm = True
    batch_norm_momentum = 0.99       # torch convention: weight of the batch

    # KPConv
    num_kernel_points = 15
    first_subsampling_dl = 0.02
    conv_radius = 2.5
    deform_radius = 5.0
    KP_extent = 1.0
    KP_influence = "linear"          # 'constant' | 'linear' | 'gaussian'
    aggregation_mode = "sum"         # only 'sum' is ported
    fixed_kernel_points = "center"

    # Batching and augmentation bounds the pyramid reads
    batch_num = 10
    augment_scale_max = 1.1

    # Precision of the feature products; only float32 is ported
    compute_dtype = "float32"

    # Training (optimizer of weasal_tpu/train/trainer.py:88-105)
    learning_rate = 1e-3
    momentum = 0.9
    grad_clip_norm = 100.0
    weight_decay = 1e-3
    class_w: List[float] = []
    deform_lr_factor = 0.1
    loss_type = "region_mprm_loss"   # or 'class_logits_loss'

    def __init__(self):
        self.num_layers = len(
            [b for b in self.architecture if "pool" in b or "strided" in b]) + 1

        # Per-layer flags: does any block of this layer deform its kernel
        layer_blocks: List[str] = []
        self.deform_layers: List[bool] = []
        for block in self.architecture:
            if not ("pool" in block or "strided" in block
                    or "global" in block or "upsample" in block):
                layer_blocks.append(block)
                continue
            deform_layer = bool(layer_blocks) and any(
                "deformable" in b for b in layer_blocks)
            if ("pool" in block or "strided" in block) \
                    and "deformable" in block:
                deform_layer = True
            self.deform_layers.append(deform_layer)
            layer_blocks = []
            if "global" in block or "upsample" in block:
                break


class VaihingenWLConfig(Config):
    """Vaihingen3D weak-label model (train_Vaihingen3D_WeakLabel.py:39-89)."""
    num_classes = 9
    architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                    "resnetb_strided", "resnetb",
                    "nearest_upsample", "nearest_upsample"]
    num_kernel_points = 15
    in_radius = 18.0
    first_subsampling_dl = 0.24
    conv_radius = 2.5
    deform_radius = 1.0
    KP_extent = 1.0
    KP_influence = "linear"
    aggregation_mode = "sum"
    first_features_dim = 64
    in_features_dim = 4
    use_batch_norm = True
    batch_norm_momentum = 0.02
    batch_num = 3
    augment_scale_max = 1.2

    # Training (train_Vaihingen3D_WeakLabel.py:56-90)
    learning_rate = 0.01
    momentum = 0.98
    grad_clip_norm = 1
    class_w = [1, 1, 1, 1, 1, 1, 1, 1, 1]
    deform_lr_factor = 0.1
    loss_type = "region_mprm_loss"
