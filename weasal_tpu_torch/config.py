"""Configuration with the `parameters.txt` round-trip.

Counterpart of weasal_tpu/config.py: the `Config` parameter bag, its
`save` (:296) and `load` (:240) in the same file format, so that a log
directory written by either package configures the other. Datasets
subclass `Config` and override attributes; `num_layers` and
`deform_layers` are derived from the architecture in `__init__`.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, List, Optional


class Config:
    """Parameter bag for one training session (subclass per dataset)."""

    # Input
    dataset = ""
    dataset_task = ""
    num_classes = 0
    in_points_dim = 3
    in_features_dim = 1
    in_radius = 1.0
    input_threads = 8

    # Model
    architecture: List[str] = []
    equivar_mode = ""
    invar_mode = ""
    first_features_dim = 64
    use_batch_norm = True
    batch_norm_momentum = 0.99       # torch convention: weight of the batch
    segmentation_ratio = 1.0

    # KPConv
    num_kernel_points = 15
    first_subsampling_dl = 0.02
    conv_radius = 2.5
    deform_radius = 5.0
    KP_extent = 1.0
    KP_influence = "linear"          # 'constant' | 'linear' | 'gaussian'
    aggregation_mode = "sum"         # only 'sum' is ported
    fixed_kernel_points = "center"
    modulated = False
    n_frames = 1
    max_in_points = 0
    val_radius = 51.0
    max_val_points = 50000

    # Training (optimizer of weasal_tpu/train/trainer.py:88-105)
    learning_rate = 1e-3
    momentum = 0.9
    lr_decays: Dict[int, float] = {200: 0.2, 300: 0.2}
    grad_clip_norm = 100.0

    augment_scale_anisotropic = True
    augment_scale_min = 0.9
    augment_scale_max = 1.1
    augment_symmetries = [False, False, False]
    augment_rotation = "vertical"
    augment_noise = 0.005
    augment_color = 0.7
    augment_occlusion = "none"
    augment_occlusion_ratio = 0.2
    augment_occlusion_num = 1

    weight_decay = 1e-3
    segloss_balance = "none"
    class_w: List[float] = []

    deform_fitting_mode = "point2point"
    deform_fitting_power = 1.0
    deform_lr_factor = 0.1
    repulse_extent = 1.0

    batch_num = 10
    val_batch_num = 10
    max_epoch = 1000
    epoch_steps = 1000
    validation_size = 100
    checkpoint_gap = 50

    saving = True
    saving_path: Optional[str] = None

    # Port options (not written to parameters.txt)
    # Precision of KPConv's two products' inputs: 'float32' | 'bfloat16'
    # (weasal_tpu/config.py:133; bf16 inputs, f32 sums, where the JAX
    # package's XLA path rounds; kernels B and C run their bf16 variants)
    compute_dtype = "float32"
    loss_type = "region_mprm_loss"   # or 'class_logits_loss'
    # Input path: True builds each batch's pyramid on the device (the
    # fused path: level-0 or resident input, ops/pyramid.py); False takes
    # the host pyramid (data/batching.assemble_batch, ParallelSphereBuilder
    # when input_threads > 1). The JAX package defaults to False
    # (weasal_tpu/config.py:55) and its root scripts opt into the fused
    # path with --fused; the port defaults to its fused path, and its
    # entry points take --host_pyramid for the JAX default
    device_pyramid = True
    # Device-resident clouds (data/resident.py), fused path only: "auto" =
    # on when the trainer's device is CUDA; True / False force it
    resident_clouds = "auto"
    # Level-0 sizing percentile of the shape plan (data/batching.py)
    plan_point_percentile = 100.0
    # Small-sphere plan bucket (data/batching.py): > 0 sizes a second,
    # smaller plan for batches of small spheres at this level-0 percentile
    plan_bucket_percentile = 0.0
    # Training steps per dispatch (train/trainer.py): an int, or "auto"
    steps_per_dispatch = "auto"
    # Data-parallel ranks (parallel/ddp.py, the entry points' --devices):
    # 0 and 1 mean one device, -1 every visible card, N > 1 N ranks, as
    # the JAX trainer reads weasal_tpu/config.py:135 (trainer.py:133-136;
    # the comment there, "0 = all", does not match that code). Written to
    # parameters.txt when not 0, so test_models votes as the run trained
    data_parallel_devices = 0
    # Seconds without progress before the stall watchdog ends the process
    # (utils/watchdog.py; armed on CUDA only; <= 0 disables)
    stall_watchdog_s = 900

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

    # ------------------------------------------------------------------
    # parameters.txt
    # ------------------------------------------------------------------

    def load(self, path: str) -> None:
        """Re-parse a `parameters.txt` written by `save` (of either
        package)."""
        with open(join(path, "parameters.txt"), "r") as f:
            lines = f.readlines()

        for line in lines:
            info = line.split()
            if len(info) <= 2 or info[0] == "#":
                continue
            key, value = info[0], info[2]

            if value == "None":
                setattr(self, key, None)
            elif key == "lr_decay_epochs":
                self.lr_decays = {int(b.split(":")[0]): float(b.split(":")[1])
                                  for b in info[2:]}
            elif key == "architecture":
                self.architecture = list(info[2:])
            elif key == "augment_symmetries":
                self.augment_symmetries = [bool(int(b)) for b in info[2:]]
            elif key == "num_classes":
                if len(info) > 3:
                    self.num_classes = [int(c) for c in info[2:]]
                else:
                    self.num_classes = int(value)
            elif key == "class_w":
                self.class_w = [float(w) for w in info[2:]]
            elif key in ("dropout", "sub_radius", "contrast_start"):
                setattr(self, key, float(value))
            elif key in ("model_name", "loss_type", "anchor_method",
                         "subsample_method", "weak_label_log",
                         "al_acquisition"):
                setattr(self, key, value)
            elif key in ("active_learning_iterations",
                         "initial_labels_per_file", "added_labels_per_epoch"):
                setattr(self, key, int(value))
            elif key == "subsample_labels":
                setattr(self, key, bool(int(value)))
            elif key.startswith("contrast_thd"):
                setattr(self, "contrast_thd", float(value))
            elif hasattr(self, key):
                if len(value.split(".")) == 2:
                    attr_type = float
                else:
                    attr_type = type(getattr(self, key))
                if attr_type == bool:
                    setattr(self, key, bool(int(value)))
                else:
                    setattr(self, key, attr_type(value))

        self.saving = True
        self.saving_path = path
        self.__init__()

    def save(self) -> None:
        """Write `parameters.txt` into saving_path."""
        assert self.saving_path is not None, "saving_path must be set"
        os.makedirs(self.saving_path, exist_ok=True)
        with open(join(self.saving_path, "parameters.txt"), "w") as f:
            w = f.write
            w("# -----------------------------------#\n")
            w("# Parameters of the training session #\n")
            w("# -----------------------------------#\n\n")

            w("# Input parameters\n# ****************\n\n")
            w(f"dataset = {self.dataset:s}\n")
            w(f"dataset_task = {self.dataset_task:s}\n")
            if isinstance(self.num_classes, list):
                w("num_classes =" +
                  "".join(f" {n:d}" for n in self.num_classes) + "\n")
            else:
                w(f"num_classes = {self.num_classes:d}\n")
            w(f"in_points_dim = {self.in_points_dim:d}\n")
            w(f"in_features_dim = {self.in_features_dim:d}\n")
            w(f"in_radius = {self.in_radius:.6f}\n")
            w(f"input_threads = {self.input_threads:d}\n\n")

            w("# Model parameters\n# ****************\n\n")
            w("architecture =" +
              "".join(f" {a:s}" for a in self.architecture) + "\n")
            w(f"equivar_mode = {self.equivar_mode:s}\n")
            w(f"invar_mode = {self.invar_mode:s}\n")
            w(f"num_layers = {self.num_layers:d}\n")
            w(f"first_features_dim = {self.first_features_dim:d}\n")
            w(f"use_batch_norm = {int(self.use_batch_norm):d}\n")
            w(f"batch_norm_momentum = {self.batch_norm_momentum:.6f}\n\n")
            w(f"segmentation_ratio = {self.segmentation_ratio:.6f}\n\n")

            w("# KPConv parameters\n# *****************\n\n")
            w(f"first_subsampling_dl = {self.first_subsampling_dl:.6f}\n")
            w(f"num_kernel_points = {self.num_kernel_points:d}\n")
            w(f"conv_radius = {self.conv_radius:.6f}\n")
            w(f"deform_radius = {self.deform_radius:.6f}\n")
            w(f"fixed_kernel_points = {self.fixed_kernel_points:s}\n")
            w(f"KP_extent = {self.KP_extent:.6f}\n")
            w(f"KP_influence = {self.KP_influence:s}\n")
            w(f"aggregation_mode = {self.aggregation_mode:s}\n")
            w(f"modulated = {int(self.modulated):d}\n")
            w(f"n_frames = {self.n_frames:d}\n")
            w(f"max_in_points = {self.max_in_points:d}\n\n")
            w(f"max_val_points = {self.max_val_points:d}\n\n")
            w(f"val_radius = {self.val_radius:.6f}\n\n")

            w("# Training parameters\n# *******************\n\n")
            w(f"learning_rate = {self.learning_rate:f}\n")
            w(f"momentum = {self.momentum:f}\n")
            w("lr_decay_epochs =" +
              "".join(f" {e:d}:{d:f}" for e, d in self.lr_decays.items())
              + "\n")
            w(f"grad_clip_norm = {self.grad_clip_norm:f}\n\n")

            w("augment_symmetries =" +
              "".join(f" {int(a):d}" for a in self.augment_symmetries) + "\n")
            w(f"augment_rotation = {self.augment_rotation:s}\n")
            w(f"augment_noise = {self.augment_noise:f}\n")
            w(f"augment_occlusion = {self.augment_occlusion:s}\n")
            w(f"augment_occlusion_ratio = {self.augment_occlusion_ratio:.6f}\n")
            w(f"augment_occlusion_num = {self.augment_occlusion_num:d}\n")
            w("augment_scale_anisotropic = "
              f"{int(self.augment_scale_anisotropic):d}\n")
            w(f"augment_scale_min = {self.augment_scale_min:.6f}\n")
            w(f"augment_scale_max = {self.augment_scale_max:.6f}\n")
            w(f"augment_color = {self.augment_color:.6f}\n\n")

            w(f"weight_decay = {self.weight_decay:f}\n")
            w(f"segloss_balance = {self.segloss_balance:s}\n")
            w("class_w =" +
              "".join(f" {a:.6f}" for a in self.class_w) + "\n")
            w(f"deform_fitting_mode = {self.deform_fitting_mode:s}\n")
            w(f"deform_fitting_power = {self.deform_fitting_power:.6f}\n")
            w(f"deform_lr_factor = {self.deform_lr_factor:.6f}\n")
            w(f"repulse_extent = {self.repulse_extent:.6f}\n")
            w(f"batch_num = {self.batch_num:d}\n")
            w(f"val_batch_num = {self.val_batch_num:d}\n")
            w(f"max_epoch = {self.max_epoch:d}\n")
            if self.epoch_steps is None:
                w("epoch_steps = None\n")
            else:
                w(f"epoch_steps = {self.epoch_steps:d}\n")
            w(f"validation_size = {self.validation_size:d}\n")
            w(f"checkpoint_gap = {self.checkpoint_gap:d}\n\n")

            w("# Other parameters\n# *******************\n\n")
            if hasattr(self, "sub_radius"):
                w(f"sub_radius = {self.sub_radius:.6f}\n")
            if hasattr(self, "model_name"):
                w(f"model_name = {self.model_name:s}\n")
            if hasattr(self, "loss_type"):
                w(f"loss_type = {self.loss_type:s}\n")
            if hasattr(self, "contrast_start"):
                w(f"contrast_start = {self.contrast_start:.6f}\n")
            if hasattr(self, "contrast_thd"):
                w(f"contrast_thd[%] = {float(self.contrast_thd):.6f}\n")
            if hasattr(self, "anchor_method"):
                w(f"anchor_method = {self.anchor_method:s}\n")
            if hasattr(self, "active_learning_iterations"):
                w("active_learning_iterations = "
                  f"{self.active_learning_iterations:d}\n")
            if hasattr(self, "subsample_labels"):
                w(f"subsample_labels = {int(self.subsample_labels):d}\n")
            if hasattr(self, "initial_labels_per_file"):
                w("initial_labels_per_file = "
                  f"{self.initial_labels_per_file:d}\n")
            if hasattr(self, "subsample_method"):
                w(f"subsample_method = {self.subsample_method:s}\n")
            if hasattr(self, "added_labels_per_epoch"):
                w("added_labels_per_epoch = "
                  f"{self.added_labels_per_epoch:d}\n")
            if hasattr(self, "weak_label_log"):
                w(f"weak_label_log = {self.weak_label_log:s}\n")
            if hasattr(self, "dropout"):
                w(f"dropout = {float(self.dropout):.3f}\n")
            if float(getattr(self, "plan_point_percentile", 100.0)) != 100.0:
                w("plan_point_percentile = "
                  f"{float(self.plan_point_percentile):.6f}\n")
            if float(getattr(self, "plan_bucket_percentile", 0.0)) > 0.0:
                w("plan_bucket_percentile = "
                  f"{float(self.plan_bucket_percentile):.6f}\n")
            if int(getattr(self, "data_parallel_devices", 0) or 0):
                w("data_parallel_devices = "
                  f"{int(self.data_parallel_devices):d}\n")


class VaihingenWLConfig(Config):
    """Vaihingen3D weak-label model and training session
    (train_Vaihingen3D_WeakLabel.py:32-94)."""
    dataset = "Vaihingen3DWL"
    num_classes = 9
    input_threads = 10
    architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                    "resnetb_strided", "resnetb",
                    "nearest_upsample", "nearest_upsample"]
    num_kernel_points = 15
    in_radius = 18.0
    sub_radius = 5.0
    first_subsampling_dl = 0.24
    conv_radius = 2.5
    deform_radius = 1.0
    KP_extent = 1.0
    KP_influence = "linear"
    aggregation_mode = "sum"
    first_features_dim = 64
    in_features_dim = 4
    modulated = False
    use_batch_norm = True
    batch_norm_momentum = 0.02

    deform_fitting_mode = "point2point"
    deform_fitting_power = 1.0
    deform_lr_factor = 0.1
    repulse_extent = 1.2

    max_epoch = 80
    learning_rate = 0.01
    momentum = 0.98
    lr_decays = {i: 0.98 for i in range(1, 1000)}
    grad_clip_norm = 1

    batch_num = 3
    epoch_steps = 600
    validation_size = 200
    checkpoint_gap = 40

    augment_scale_anisotropic = True
    augment_symmetries = [True, True, False]
    augment_rotation = "vertical"
    augment_scale_min = 0.8
    augment_scale_max = 1.2
    augment_noise = 0.04

    class_w = [1, 1, 1, 1, 1, 1, 1, 1, 1]

    active_learning_iterations = 20
    initial_labels_per_file = 600
    subsample_method = "balanced"
    added_labels_per_epoch = 200
    subsample_labels = True

    model_name = "KPFCNN_mprm"
    loss_type = "region_mprm_loss"
    anchor_method = "reduced"

    saving = True
    saving_path = None


class VaihingenPLConfig(Config):
    """Vaihingen3D pseudo-label model and training session
    (train_Vaihingen3D_PseudoLabel.py:32-106)."""
    dataset = "Vaihingen3DPL"
    num_classes = None
    dataset_task = ""
    input_threads = 10

    architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                    "resnetb_strided", "resnetb", "resnetb_strided",
                    "resnetb", "resnetb_strided", "resnetb",
                    "nearest_upsample", "unary",
                    "nearest_upsample", "unary",
                    "nearest_upsample", "unary",
                    "nearest_upsample", "unary"]

    num_kernel_points = 15
    in_radius = 24
    first_subsampling_dl = 0.24
    conv_radius = 2.5
    deform_radius = 6.0
    KP_extent = 1.0
    KP_influence = "linear"
    aggregation_mode = "sum"
    first_features_dim = 64
    in_features_dim = 4
    modulated = False
    use_batch_norm = True
    batch_norm_momentum = 0.02

    deform_fitting_mode = "point2point"
    deform_fitting_power = 1.0
    deform_lr_factor = 0.1
    repulse_extent = 1.2

    max_epoch = 150
    learning_rate = 0.01
    momentum = 0.98
    lr_decays = {i: 0.1 ** (1 / 150) for i in range(1, 150)}
    grad_clip_norm = 100.0

    batch_num = 4
    epoch_steps = 200
    validation_size = 200
    checkpoint_gap = 75

    augment_scale_anisotropic = True
    augment_symmetries = [True, True, True]
    augment_rotation = "vertical"
    augment_scale_min = 0.2
    augment_scale_max = 1.8
    augment_noise = 0.06
    augment_color = 0.7

    dropout = 0.5
    contrast_start = 0
    contrast_thd = 20

    active_learning_iterations = 20
    added_labels_per_epoch = 5000

    model_name = "KPFCNN"
    weak_label_log = ""

    class_w = [1, 1, 1, 1, 1, 1, 1, 1, 1]

    saving = True
    saving_path = None


def deformable_last_layers(architecture: List[str]) -> List[str]:
    """`architecture` with the deformable blocks of KPConv-PyTorch's
    train_S3DIS.py: the encoder's second-last layer after its strided
    entry, the strided block into the last layer and the last layer's
    blocks ('resnetb' -> 'resnetb_deformable', 'resnetb_strided' ->
    'resnetb_deformable_strided')."""
    arch = list(architecture)
    end = next((i for i, b in enumerate(arch)
                if "upsample" in b or "global" in b), len(arch))
    strided = [i for i in range(end) if "strided" in arch[i]]
    if len(strided) < 2:
        raise ValueError(f"{arch} has fewer than three layers")
    for i in range(strided[-2] + 1, end):
        if "deformable" not in arch[i]:
            base, tail = ((arch[i][:-len("_strided")], "_strided")
                          if arch[i].endswith("_strided") else (arch[i], ""))
            arch[i] = base + "_deformable" + tail
    return arch


class VaihingenPLDeformConfig(VaihingenPLConfig):
    """The Vaihingen3D pseudo-label session with the deformable KP-FCNN
    (KPConv's deform variant, Thomas et al., ICCV 2019): WeaSAL's
    train_Vaihingen3D_PseudoLabel.py:32-106, whose deform_radius,
    deform_fitting_*, deform_lr_factor and repulse_extent come from
    KPConv-PyTorch's train_S3DIS.py, with that file's deformable layers
    mapped onto the one-resnetb-a-layer architecture: blocks 7, 8 and 9
    (layer 3's resnetb, the strided block into layer 4, layer 4's
    resnetb), so layers 3 and 4 deform. Every other value is the PL
    configuration's."""
    architecture = deformable_last_layers(VaihingenPLConfig.architecture)


class DALESWLConfig(VaihingenWLConfig):
    """DALES weak-label model and training session
    (train_DALES_WeakLabel.py:19-43): 128 features, no color."""
    dataset = "DALESWL"

    in_radius = 16
    sub_radius = 5
    first_subsampling_dl = 0.4
    in_features_dim = 3
    first_features_dim = 128
    # DALES's batch-norm momentum is 0.98 (torch convention: the running
    # statistics take 0.98 of each batch's); Vaihingen3D's is 0.02
    batch_norm_momentum = 0.98

    max_epoch = 100
    batch_num = 2
    epoch_steps = 400
    checkpoint_gap = 50

    augment_scale_min = 0.9
    augment_scale_max = 1.1
    augment_noise = 0.01

    active_learning_iterations = 10
    initial_labels_per_file = 7000
    subsample_method = "balanced"
    added_labels_per_epoch = 1000
    subsample_labels = active_learning_iterations > 0


class DALESPLConfig(VaihingenPLConfig):
    """DALES pseudo-label model and training session
    (train_DALES_PseudoLabel.py:20-40)."""
    dataset = "DALESPL"

    in_radius = 16
    first_subsampling_dl = 0.4
    in_features_dim = 3

    max_epoch = 200
    batch_num = 4
    epoch_steps = 100
    lr_decays = {i: 0.1 ** (1 / 200) for i in range(1, 200)}

    augment_scale_min = 0.9
    augment_scale_max = 1.1
    augment_noise = 0.01

    contrast_thd = 10

    active_learning_iterations = 20
    added_labels_per_epoch = 5000


class ShapeClsConfig(Config):
    """The KPCNN classifier over synthetic shape clouds
    (data/synthetic.synthetic_shape_cloud, batches by
    data/batching.assemble_classification_batch): the JAX package's
    classification configuration (tests/test_classification.py
    `ClsConfig`), 16 features, two levels."""
    dataset = "ShapeCls"
    num_classes = 3
    in_features_dim = 1
    first_features_dim = 16
    num_kernel_points = 15
    first_subsampling_dl = 0.3
    conv_radius = 2.5
    in_radius = 2.0
    architecture = ["simple", "resnetb_strided", "resnetb",
                    "global_average"]
    use_batch_norm = True
    batch_norm_momentum = 0.02
    KP_influence = "linear"
    aggregation_mode = "sum"
    fixed_kernel_points = "center"
