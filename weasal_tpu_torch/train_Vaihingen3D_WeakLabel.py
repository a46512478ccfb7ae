"""Weak-label training on Vaihingen3D, active-learning iteration 0.

Counterpart of `run()` in train_Vaihingen3D_WeakLabel.py:112-264 on the
fused path (its `--fused` is implied): the training and validation
datasets, the trainer, `train` with per-epoch validation, checkpoints and
resume. Active learning (iterations after 0, with their testing passes)
is not ported yet.

    python -m weasal_tpu_torch.train_Vaihingen3D_WeakLabel [saving_path]
        [--data_root data/Vaihingen3D] [--max_epoch N] [--epoch_steps N]
        [--validation_size N] [--resume Log_dir] [--preset quick]
        [--initial_labels N] [--plan_percentile P] [--plan_buckets P]
        [--steps_per_dispatch K] [--device cuda|cpu] [--seed S]

Runs on CUDA unless `--device cpu` is given; where CUDA is absent it
raises instead. On CUDA the training and validation steps replay
captured CUDA graphs, K training steps a replay (`--steps_per_dispatch`,
default "auto"); a capture that fails raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from weasal_tpu_torch.config import VaihingenWLConfig
from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
from weasal_tpu_torch.train.trainer import ModelTrainer
from weasal_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("saving_path", nargs="?", default=None)
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--epoch_steps", type=int, default=None)
    parser.add_argument("--validation_size", type=int, default=None)
    parser.add_argument("--al_iterations", type=int, default=None,
                        help="only 0: active learning comes with slice D "
                             "of the port")
    parser.add_argument("--resume", default=None,
                        help="previous Log_* dir to resume from")
    parser.add_argument("--preset", default=None, choices=["quick"],
                        help="'quick': scaled-down smoke-run config "
                             "(small spheres, few steps)")
    parser.add_argument("--plan_percentile", type=float, default=None,
                        help="shape-plan level-0 sizing percentile "
                             "(config.plan_point_percentile)")
    parser.add_argument("--plan_buckets", type=float, default=None,
                        help="small-sphere plan bucket percentile "
                             "(config.plan_bucket_percentile, e.g. 80): "
                             "batches of small spheres train on a second, "
                             "smaller captured step; nothing is cropped")
    parser.add_argument("--steps_per_dispatch", type=int, default=None,
                        help="training steps per graph replay "
                             "(config.steps_per_dispatch; default auto)")
    parser.add_argument("--initial_labels", type=int, default=None,
                        help="initial weak-label anchors per file "
                             "(config.initial_labels_per_file)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the datasets' initial potentials "
                             "(default unseeded), which fixes the "
                             "calibrated plan and the spheres of a run")
    return parser.parse_args(argv)


def run(argv=None):
    """Parse `argv` and train; returns the trainer (its `datasets` hold
    the training and validation datasets)."""
    args = parse_args(argv)
    if args.al_iterations not in (None, 0):
        raise NotImplementedError(
            "--al_iterations > 0: active learning comes with slice D of the "
            "port; this entry point trains iteration 0")
    device = resolve_device(args.device)

    config = VaihingenWLConfig()
    if args.plan_percentile is not None:
        config.plan_point_percentile = args.plan_percentile
    if args.plan_buckets is not None:
        config.plan_bucket_percentile = args.plan_buckets
    if args.steps_per_dispatch is not None:
        config.steps_per_dispatch = args.steps_per_dispatch
    if args.preset == "quick":
        config.in_radius = min(config.in_radius, 7.0)
        config.sub_radius = min(getattr(config, "sub_radius", 5), 2.5)
        config.first_subsampling_dl = max(config.first_subsampling_dl, 0.45)
        config.first_features_dim = 16
        config.batch_num = 2
        config.max_epoch = 1
        config.epoch_steps = 3
        config.validation_size = 2
        config.initial_labels_per_file = 40
        config.subsample_labels = True
    chosen_chkp = None
    if args.resume:
        config.load(args.resume)
        chosen_chkp = os.path.join(config.saving_path, "checkpoints",
                                   "current_chkp.tar")
        config.saving_path = None
    if args.saving_path:
        config.saving_path = args.saving_path
    for key in ("max_epoch", "epoch_steps", "validation_size"):
        if getattr(args, key) is not None:
            setattr(config, key, getattr(args, key))
    if args.initial_labels is not None:
        config.initial_labels_per_file = args.initial_labels
    # Iteration 0 only: no acquisition follows, the label budget stays
    config.active_learning_iterations = 0

    def potentials_rng():
        return (None if args.seed is None
                else np.random.default_rng(args.seed))

    print("\n=== Active-learning iteration 0 ===\n")
    train_ds = Vaihingen3DWLDataset(config, split="training",
                                    data_root=args.data_root,
                                    rng=potentials_rng())
    val_ds = Vaihingen3DWLDataset(config, split="validation",
                                  data_root=args.data_root,
                                  rng=potentials_rng())
    trainer = ModelTrainer(config, train_ds, chkp_path=chosen_chkp,
                           device=device)
    trainer.datasets = (train_ds, val_ds)
    trainer.train(train_ds, val_ds, al_iteration=0)

    n_files = len(train_ds.cloud_names_split)
    over = int(np.sum([len(a) for a in train_ds.anchors]))
    print(f"\nInitial amount of weak labels: "
          f"{config.initial_labels_per_file * n_files}")
    print(f"Amount of weak labels with overlaps: {over}\n")
    return trainer


if __name__ == "__main__":
    run(sys.argv[1:])
