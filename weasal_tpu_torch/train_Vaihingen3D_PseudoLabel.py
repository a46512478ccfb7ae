"""Pseudo-label training on Vaihingen3D with active learning.

Counterpart of `run_pl()` in train_Vaihingen3D_PseudoLabel.py:109-235 on
the fused path (its `--fused` is implied): the class weights come from
the refinement's `<data_root>/PseudoLabels/<weak_label_log>/
Vaihingen3D_t<thd>_weight.txt` when it exists; per active-learning
iteration the training and validation datasets (the training split reads
the refined pseudo labels `<cloud>_t<thd>_pseudo.txt` with the
ground truth of the cloud's ledger over them), a fresh `KPFCNN` trainer
in pseudo mode (cross-entropy, the contrast loss from `contrast_start`
on, dropout, gradients clipped by value), `train` with per-epoch
validation and checkpoints under `results/PseudoLabel/`; between
iterations a vote of the trained model on the training clouds (the test
split with `test_on_train`, `--al_votes` votes) that adds
`added_labels_per_epoch` points to every training file's ground-truth
ledger (train/tester.ModelTester in pseudo mode, by entropy x class
weight or at random with `--al_acquisition random`). `--resume`
continues a log at its last `training_iteration*` file. The loop is
train/stage.run; this module holds what the stage adds to it.

    python -m weasal_tpu_torch.train_Vaihingen3D_PseudoLabel [saving_path]
        --weak_label_log Log_x [--data_root data/Vaihingen3D]
        [--max_epoch N] [--epoch_schedule 150,15,15] [--epoch_steps N]
        [--validation_size N] [--al_iterations N] [--al_votes N]
        [--added_labels N] [--al_acquisition entropy|random]
        [--resume Log_dir] [--preset quick] [--plan_percentile P]
        [--plan_buckets P] [--steps_per_dispatch K]
        [--device cuda|cpu] [--seed S]

Runs on CUDA unless `--device cpu` is given; where CUDA is absent it
raises instead. On CUDA the training and validation steps and the vote
batches replay captured CUDA graphs; a capture that fails raises.
"""

from __future__ import annotations

import sys
from os.path import exists, join

import numpy as np

from weasal_tpu_torch.config import VaihingenPLConfig
from weasal_tpu_torch.data.datasets import Vaihingen3DPLDataset
from weasal_tpu_torch.train import stage


def add_arguments(parser) -> None:
    parser.add_argument("--weak_label_log", default=None,
                        help="the weak-label log whose refined pseudo "
                             "labels to train on")


def quick(config) -> None:
    config.in_radius = min(config.in_radius, 7.0)
    config.first_subsampling_dl = max(config.first_subsampling_dl, 0.45)
    config.first_features_dim = 16
    config.architecture = [
        "simple", "resnetb", "resnetb_strided", "resnetb",
        "resnetb_strided", "resnetb",
        "nearest_upsample", "unary", "nearest_upsample", "unary"]
    config.batch_num = 2
    config.max_epoch = 1
    config.epoch_steps = 3
    config.validation_size = 2
    config.active_learning_iterations = 0
    config.__init__()   # num_layers of the new architecture


def configure(config, args) -> None:
    """`--weak_label_log`, then `config.class_w` from the refinement's
    weight file, when it exists (train_Vaihingen3D_PseudoLabel.py:
    201-207)."""
    if args.weak_label_log:
        config.weak_label_log = args.weak_label_log
    data_folder = args.data_root or join("data", config.dataset[:-2])
    weight_file = join(data_folder, "PseudoLabels", config.weak_label_log,
                       config.dataset[:-2]
                       + f"_t{int(config.contrast_thd)}_weight.txt")
    if exists(weight_file):
        config.class_w = list(np.genfromtxt(weight_file, delimiter=" "))
        print(f"Loaded class weights from {weight_file}")


STAGE = stage.Stage(
    config_cls=VaihingenPLConfig, dataset_cls=Vaihingen3DPLDataset,
    stage_dir="PseudoLabel", description=__doc__.splitlines()[0],
    add_arguments=add_arguments, quick=quick, configure=configure)


def run(argv=None):
    """Parse `argv` and run every active-learning iteration; returns the
    last iteration's trainer (train/stage.run)."""
    return stage.run(STAGE, argv)


if __name__ == "__main__":
    run(sys.argv[1:])
