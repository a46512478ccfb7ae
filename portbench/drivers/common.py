"""What the cells' drivers share: the configuration as it is run, the
tile and its labels, the seeded weights, the reference's inputs, and the
window's clock.

Everything the benchmark writes goes into `portbench/_cache/` (the tiles,
their caches and the calibrated plans, at fixed paths, so that only the
first run of a checkout pays for them) or under the run's temporary
directory (the loop's logs and checkpoints), which the run removes.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from os.path import dirname, exists, join
from typing import Dict

import numpy as np
import torch

HERE = dirname(dirname(os.path.abspath(__file__)))
CACHE = join(HERE, "_cache")
# The raw tile's file names (the Vaihingen3D layout)
TRAIN_CLOUD = "Vaihingen3D_Training"
TEST_CLOUD = "Vaihingen3D_Testing"
# The pseudo-label log the PL configuration reads its labels from
PL_LOG = "portbench"


class WindowClosed(Exception):
    """Raised from a hook of the program's loop to end the window."""


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def lr_decays(spec) -> Dict[int, float]:
    """`config.lr_decays` of a configuration file: {"epochs": [first,
    last], "factor": f} is f at every epoch from first to last."""
    first, last = spec["epochs"]
    return {i: float(spec["factor"]) for i in range(first, last + 1)}


def program_config(spec: Dict):
    """The program's configuration class, every key set from the
    configuration file (the file is what runs, whatever the class's
    defaults say)."""
    from weasal_tpu_torch import config as configs
    cfg = getattr(configs, spec["program"]["config_class"])()
    for key, value in spec["config"].items():
        if key == "lr_decays":
            value = lr_decays(value)
        setattr(cfg, key, value)
    cfg.__init__()          # num_layers and the deform flags
    return cfg


def reference_config(spec: Dict):
    """The configuration file as an attribute bag for the reference (its
    own num_layers and deform flags, as the program derives them)."""
    cfg = type("ReferenceConfig", (), {})()
    for key, value in spec["config"].items():
        setattr(cfg, key, lr_decays(value) if key == "lr_decays" else value)
    arch = cfg.architecture
    cfg.num_layers = len([b for b in arch
                          if "pool" in b or "strided" in b]) + 1
    # per layer: does a block of it deform its kernel (Config.__init__)
    cfg.deform_layers, blocks = [], []
    for block in arch:
        if not any(t in block for t in ("pool", "strided", "global",
                                        "upsample")):
            blocks.append(block)
            continue
        cfg.deform_layers.append(
            any("deformable" in b for b in blocks)
            or (("pool" in block or "strided" in block)
                and "deformable" in block))
        blocks = []
        if "global" in block or "upsample" in block:
            break
    return cfg


def lr_of_epoch(cfg, epoch: int) -> float:
    """The learning rate the trainer uses in `epoch`."""
    lr = float(cfg.learning_rate)
    for e in range(epoch):
        if e in cfg.lr_decays:
            lr *= cfg.lr_decays[e]
    return lr


# ----------------------------------------------------------------------
# The tile
# ----------------------------------------------------------------------

def data_root(spec: Dict) -> str:
    """The configuration's data root: the frozen generator's tile (made
    on the first run of a checkout), and for a pseudo-label
    configuration its labels. Returns the root."""
    data = spec["data"]
    root = join(CACHE, spec["name"], "Vaihingen3D")
    if not exists(join(root, TRAIN_CLOUD + ".ply")):
        from portbench.yardstick.synthetic import make_vaihingen_like_root
        tmp = root + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        make_vaihingen_like_root(tmp, extent=data["extent_m"],
                                 density=data["density_per_m2"],
                                 seed=data["seed"])
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(dirname(root), exist_ok=True)
        os.replace(tmp, root)
    if "pseudo_labels" in data:
        write_pseudo_labels(root, spec)
    return root


def subsampled_tile(root: str, dl: float, cloud: str = TRAIN_CLOUD):
    """(points f32, colors f32 [n, 1], labels int32) of a raw tile, worked
    out as the Vaihingen3D datasets do it: points relative to the training
    tile's first point, voxel barycenters at `dl`, mean intensity / 255,
    majority label."""
    from portbench.reference.ops.subsample import grid_subsample_numpy
    from portbench.reference.utils.ply import read_ply
    first = read_ply(join(root, TRAIN_CLOUD + ".ply"))
    offset = np.vstack((first["x"][0], first["y"][0], first["z"][0])).T
    data = first if cloud == TRAIN_CLOUD else read_ply(
        join(root, cloud + ".ply"))
    points = np.vstack((data["x"], data["y"], data["z"])).T
    points = (points - offset).astype(np.float32)
    intensity = data["scalar_Intensity"].astype(np.uint8)
    classes = data["scalar_Classification"].astype(np.int32)
    sub, colors, labels = grid_subsample_numpy(
        points, dl, features=intensity.astype(np.float32)[:, None],
        labels=classes)
    return sub, colors / 255.0, labels


def write_pseudo_labels(root: str, spec: Dict) -> None:
    """The pseudo-label stage's input, as the refinement would leave it:
    the training tile's subsampled ground truth with a seeded share set
    to 10 (no label), and class weights of 1."""
    pl = spec["data"]["pseudo_labels"]
    cfg = spec["config"]
    out = join(root, "PseudoLabels", PL_LOG)
    name = f"{TRAIN_CLOUD}_t{int(cfg['contrast_thd'])}_pseudo.txt"
    if exists(join(out, name)):
        return
    _, _, truth = subsampled_tile(root, cfg["first_subsampling_dl"])
    rng = np.random.default_rng(pl["seed"])
    pseudo = np.where(rng.random(truth.shape[0]) < pl["unlabeled_share"],
                      10, truth)
    os.makedirs(out, exist_ok=True)
    np.savetxt(join(out, name + ".tmp"), pseudo, fmt="%i")
    os.replace(join(out, name + ".tmp"), join(out, name))


def dataset(spec: Dict, cfg, root: str, split: str, seed: int):
    """The program's dataset of `split`, its initial potentials drawn
    from the run's seed (which fixes the spheres the run draws)."""
    from weasal_tpu_torch.data import datasets
    cls = getattr(datasets, spec["program"]["dataset_class"])
    return cls(cfg, split=split, data_root=root,
               rng=np.random.default_rng(seed))


def calibrate(spec: Dict, cfg, root: str) -> None:
    """The configuration's shape plan, in the data root's cache: the
    program calibrates on the potentials of the first dataset that asks,
    so the plan (the graph's shapes, its memory and its time) would
    follow the seed of a checkout's first run; calibrated here first, on
    the configuration's own data seed, every run finds the same plan."""
    dataset(spec, cfg, root, "training", spec["data"]["seed"]).calibration()


# Spheres the datasets' calibration draws (data/datasets.calibration)
CALIBRATION_SPHERES = 40


def reference_plan(spec: Dict, ref_cfg, root: str):
    """The reference's own shape plan of the configuration: its copy of
    `calibrate_shape_plan` on the spheres that the program's sampler
    draws for a calibration (the inputs: the training split on the
    configuration's data seed, `default_rng(0)`), with the datasets'
    region budget. Kept in the data root's cache, so that a checkout's
    first run alone pays for it."""
    from portbench.reference.data.batching import (ShapePlan,
                                                   calibrate_shape_plan)
    path = join(CACHE, spec["name"], "reference_plan.json")
    if exists(path):
        return ShapePlan.load(path)
    ds = dataset(spec, program_config(spec), root, "training",
                 spec["data"]["seed"])
    rng = np.random.default_rng(0)
    clouds, counts, sizes = ds._sample_calibration_clouds(
        CALIBRATION_SPHERES, rng)
    budget = ((int(np.quantile(counts, 0.98)) + 2,
               int(np.quantile(sizes, 0.95)) + 1) if sizes else (0, 0))
    plan = calibrate_shape_plan(
        clouds, ref_cfg, untouched_ratio=0.9,
        point_percentile=float(getattr(ref_cfg, "plan_point_percentile",
                                       100.0)),
        region_budget=budget, rng=rng,
        bucket_percentile=float(getattr(ref_cfg, "plan_bucket_percentile",
                                        0.0)))
    os.makedirs(dirname(path), exist_ok=True)
    plan.save(path + ".tmp")
    os.replace(path + ".tmp", path)
    return plan


def plan_mismatch(program: Dict, plan) -> float:
    """Fields of the program's shape plan that differ from the
    reference's (both printed on standard error)."""
    ref = vars(plan)
    print(f"plan: program {program}; reference {ref}", file=sys.stderr)
    return float(sum(program.get(k) != v for k, v in ref.items())
                 + len(set(program) - set(ref)))


def run_dir(workload: str) -> str:
    """A directory of this run's logs and checkpoints, under TMPDIR."""
    return tempfile.mkdtemp(prefix=f"portbench_{workload}_")


# ----------------------------------------------------------------------
# Seeded weights
# ----------------------------------------------------------------------

def reference_model(spec: Dict, ref_cfg, num_classes: int):
    """The reference's network of the configuration, on the CPU."""
    from portbench.reference.models.architectures import model_for_config
    labels = np.arange(num_classes, dtype=np.int32)
    ignored = np.array([], np.int32)
    if spec["program"]["dataset_class"].endswith("PLDataset"):
        labels = np.append(labels, 10).astype(np.int32)
        ignored = np.array([10], np.int32)
    return model_for_config(ref_cfg, labels, ignored,
                            generator=torch.Generator().manual_seed(0))


def seeded_state(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """A state dict for `model`'s names and shapes, made on `device` from
    `seed` in one draw: KPConv weights [Kp, Cin, Cout] uniform within
    1/sqrt(Cin Cout), linear weights [out, in] within 1/sqrt(in) (the
    program's own init), BatchNorm scales 1, biases 0, attention gammas
    uniform in [0.5, 1] (non-zero, so that the attention paths train),
    running statistics 0 and 1, and each conv's kernel points turned
    about the vertical by a seeded angle."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = dict(model.named_parameters())
    drawn = [n for n, p in params.items()
             if p.dim() >= 2 or n.endswith("gamma")]
    total = sum(params[n].numel() for n in drawn)
    flat = torch.rand(total, generator=gen, device=device)
    state, pos = {}, 0
    for name in drawn:
        p = params[name]
        u = flat[pos:pos + p.numel()].view(p.shape)
        pos += p.numel()
        if name.endswith("gamma"):
            state[name] = 0.5 + 0.5 * u
        elif p.dim() == 3:
            state[name] = (2 * u - 1) / np.sqrt(p.shape[1] * p.shape[2])
        else:
            state[name] = (2 * u - 1) / np.sqrt(p.shape[1])
    for name, p in params.items():
        if name not in state:
            state[name] = (torch.ones if name.endswith("scale")
                           else torch.zeros)(p.shape, device=device)
    rng = np.random.default_rng([int(seed) % 2 ** 63, 17])
    for name, b in model.named_buffers():
        if name.endswith("kernel_points"):
            t = rng.random() * 2 * np.pi
            rot = np.array([[np.cos(t), -np.sin(t), 0],
                            [np.sin(t), np.cos(t), 0], [0, 0, 1]])
            state[name] = torch.from_numpy(
                (b.numpy().astype(np.float64) @ rot).astype(np.float32)
            ).to(device)
        elif name.endswith("var"):
            state[name] = torch.ones(b.shape, device=device)
        else:
            state[name] = torch.zeros(b.shape, dtype=b.dtype, device=device)
    return state


def check_names(program_model, state: Dict) -> None:
    """The program's network holds exactly the reference's tensors."""
    got = {k: tuple(v.shape) for k, v in program_model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in state.items()}
    if got != want:
        raise RuntimeError(
            "the program's network differs from the reference's: "
            f"{sorted(set(got.items()) ^ set(want.items()))[:6]}")


# ----------------------------------------------------------------------
# The reference's resident clouds
# ----------------------------------------------------------------------

class TileClouds:
    """The reference's own subsampled tile, with the attributes the
    frozen `ResidentClouds` reads from a dataset."""

    def __init__(self, root: str, cfg, cloud: str, labels: np.ndarray,
                 label_table: np.ndarray):
        pts, colors, truth = subsampled_tile(root, cfg.first_subsampling_dl,
                                             cloud)
        self._pts = pts
        self.input_trees = [None]
        self.input_colors = [colors.astype(np.float32)]
        self.input_labels = [truth if labels is None else labels]
        self._table = label_table

    def _cloud_points_f32(self, i: int) -> np.ndarray:
        return self._pts

    def _label_table(self) -> np.ndarray:
        return self._table


def pseudo_labels(root: str, spec: Dict) -> np.ndarray:
    """The pseudo-label file the harness wrote for the PL configuration."""
    cfg = spec["config"]
    return np.genfromtxt(join(
        root, "PseudoLabels", PL_LOG,
        f"{TRAIN_CLOUD}_t{int(cfg['contrast_thd'])}_pseudo.txt")
    ).astype(np.int32)


def label_table(pseudo: bool) -> np.ndarray:
    """Raw label -> training index of the Vaihingen3D datasets (the PL
    stage keeps 10, its 'no label', as 10)."""
    table = np.full(11 if pseudo else 9, -1, np.int32)
    table[:9] = np.arange(9)
    if pseudo:
        table[10] = 10
    return table


def resident_mismatch(program: Dict[str, torch.Tensor],
                      reference: Dict[str, torch.Tensor]) -> float:
    """Entries of the program's resident clouds that differ from the
    reference's (a shape that differs counts every entry)."""
    bad = 0
    for key, want in reference.items():
        got = program.get(key)
        if got is None or got.shape != want.shape:
            bad += want.numel()
            continue
        bad += int((got.to(want.device) != want).sum())
    return float(bad)


def print_marks(marks) -> None:
    """The set-up's stages, each with the seconds it took."""
    parts, last = [], 0.0
    for name, t in marks:
        parts.append(f"{name} {t - last:.2f}")
        last = t
    print("setup: " + ", ".join(parts) + " s", file=sys.stderr)
