"""Weak-label training on Vaihingen3D with active learning.

Counterpart of `run()` in train_Vaihingen3D_WeakLabel.py:97-264 on the
fused path (its `--fused` is implied): per active-learning iteration the
training and validation datasets (iteration i > 0 reads the anchor
ledger that the last acquisition extended), a fresh trainer, `train`
with per-epoch validation, checkpoints; between iterations a vote of the
trained model on the training clouds (the test split with
`test_on_train`, `--al_votes` votes) that adds `--added_labels` anchors
to every training file's ledger (train/tester.ModelTester, by entropy x
class rarity or at random with `--al_acquisition random`). `--resume`
continues a log at its last `training_iteration*` file. The loop is
train/stage.run; this module holds what the stage adds to it.

    python -m weasal_tpu_torch.train_Vaihingen3D_WeakLabel [saving_path]
        [--data_root data/Vaihingen3D] [--max_epoch N]
        [--epoch_schedule 80,15,15] [--epoch_steps N]
        [--validation_size N] [--al_iterations N] [--al_votes N]
        [--added_labels N] [--al_acquisition entropy|random]
        [--resume Log_dir] [--preset quick] [--initial_labels N]
        [--plan_percentile P] [--plan_buckets P] [--steps_per_dispatch K]
        [--device cuda|cpu] [--seed S]

Runs on CUDA unless `--device cpu` is given; where CUDA is absent it
raises instead. On CUDA the training and validation steps and the vote
batches replay captured CUDA graphs, K training steps a replay
(`--steps_per_dispatch`, default "auto"); a capture that fails raises.
"""

from __future__ import annotations

import sys

import numpy as np

from weasal_tpu_torch.config import VaihingenWLConfig
from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
from weasal_tpu_torch.train import stage


def add_arguments(parser) -> None:
    parser.add_argument("--initial_labels", type=int, default=None,
                        help="initial weak-label anchors per file "
                             "(config.initial_labels_per_file)")


def quick(config) -> None:
    config.in_radius = min(config.in_radius, 7.0)
    config.sub_radius = min(getattr(config, "sub_radius", 5), 2.5)
    config.first_subsampling_dl = max(config.first_subsampling_dl, 0.45)
    config.first_features_dim = 16
    config.batch_num = 2
    config.max_epoch = 1
    config.epoch_steps = 3
    config.validation_size = 2
    config.active_learning_iterations = 1
    config.initial_labels_per_file = 40
    config.added_labels_per_epoch = 5
    config.subsample_labels = True


def configure(config, args) -> None:
    """`--initial_labels`; with `--al_iterations` above 0 the labels are
    subsampled to the initial budget (the reference trains on every
    anchor only when its config class turns subsampling off)."""
    if args.initial_labels is not None:
        config.initial_labels_per_file = args.initial_labels
    if args.al_iterations:
        config.subsample_labels = True


def after_training(config, train_ds, iteration: int) -> None:
    n_files = len(train_ds.cloud_names_split)
    init = config.initial_labels_per_file * n_files \
        + iteration * config.added_labels_per_epoch * n_files
    over = int(np.sum([len(a) for a in train_ds.anchors]))
    print(f"\nInitial amount of weak labels: {init}")
    print(f"Amount of weak labels with overlaps: {over}\n")


STAGE = stage.Stage(
    config_cls=VaihingenWLConfig, dataset_cls=Vaihingen3DWLDataset,
    stage_dir="WeakLabel", description=__doc__.splitlines()[0],
    add_arguments=add_arguments, quick=quick, configure=configure,
    after_training=after_training)


def run(argv=None):
    """Parse `argv` and run every active-learning iteration; returns the
    last iteration's trainer (train/stage.run)."""
    return stage.run(STAGE, argv)


if __name__ == "__main__":
    run(sys.argv[1:])
