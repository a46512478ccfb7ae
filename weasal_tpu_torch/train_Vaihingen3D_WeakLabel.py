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
continues a log at its last `training_iteration*` file.

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

import argparse
import os
import sys

import numpy as np

from weasal_tpu_torch.config import VaihingenWLConfig
from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
from weasal_tpu_torch.train.tester import ModelTester
from weasal_tpu_torch.train.trainer import ModelTrainer
from weasal_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("saving_path", nargs="?", default=None)
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--epoch_schedule", default=None,
                        help="comma list of epochs per AL iteration, e.g. "
                             "'80,15,15' (the last value repeats); "
                             "overrides --max_epoch per iteration")
    parser.add_argument("--epoch_steps", type=int, default=None)
    parser.add_argument("--validation_size", type=int, default=None)
    parser.add_argument("--al_iterations", type=int, default=None,
                        help="active-learning iterations after the first "
                             "training (config.active_learning_iterations)")
    parser.add_argument("--al_votes", type=int, default=None,
                        help="votes per acquisition pass (default 10; 2 "
                             "with --preset quick)")
    parser.add_argument("--added_labels", type=int, default=None,
                        help="anchors added per training file and "
                             "acquisition (config.added_labels_per_epoch)")
    parser.add_argument("--al_acquisition", default=None,
                        choices=["entropy", "random"],
                        help="acquisition policy: entropy x class rarity "
                             "(the reference's) or random unused anchors "
                             "at the same budget")
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


def apply_al_override(config, al_iterations: int) -> None:
    """`--al_iterations` sets how many acquisitions run; with any, the
    labels are subsampled to the initial budget (the reference trains on
    every anchor only when its config class turns subsampling off)."""
    config.active_learning_iterations = al_iterations
    if al_iterations > 0:
        config.subsample_labels = True


def run(argv=None):
    """Parse `argv` and run every active-learning iteration; returns the
    last iteration's trainer (its `datasets` hold that iteration's
    training and validation datasets, its `testers` the acquisition
    passes' testers)."""
    args = parse_args(argv)
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
        config.active_learning_iterations = 1
        config.initial_labels_per_file = 40
        config.added_labels_per_epoch = 5
        config.subsample_labels = True
    iteration_previous = 0
    chosen_chkp = None
    if args.resume:
        config.load(args.resume)
        iter_files = [f for f in os.listdir(config.saving_path)
                      if f.startswith("training_iteration")]
        # a run that stopped before its first log resumes at iteration 0
        iteration_previous = max(len(iter_files) - 1, 0)
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
    if args.al_acquisition is not None:
        config.al_acquisition = args.al_acquisition
    if args.added_labels is not None:
        config.added_labels_per_epoch = args.added_labels
    if args.al_iterations is not None:
        apply_al_override(config, args.al_iterations)
    schedule = None
    if args.epoch_schedule:
        schedule = [int(v) for v in args.epoch_schedule.split(",")]
    al_votes = args.al_votes if args.al_votes is not None \
        else (2 if args.preset == "quick" else 10)

    def potentials_rng():
        return (None if args.seed is None
                else np.random.default_rng(args.seed))

    testers = []
    trainer = None
    for iteration in range(iteration_previous,
                           config.active_learning_iterations + 1):
        print(f"\n=== Active-learning iteration {iteration} ===\n")
        if schedule:
            config.max_epoch = schedule[min(iteration, len(schedule) - 1)]
        train_ds = Vaihingen3DWLDataset(config, split="training",
                                        al_iteration=iteration,
                                        data_root=args.data_root,
                                        rng=potentials_rng())
        val_ds = Vaihingen3DWLDataset(config, split="validation",
                                      data_root=args.data_root,
                                      rng=potentials_rng())
        trainer = ModelTrainer(config, train_ds, chkp_path=chosen_chkp,
                               device=device)
        trainer.datasets = (train_ds, val_ds)
        trainer.testers = testers
        trainer.train(train_ds, val_ds, al_iteration=iteration)

        n_files = len(train_ds.cloud_names_split)
        init = config.initial_labels_per_file * n_files \
            + iteration * config.added_labels_per_epoch * n_files
        over = int(np.sum([len(a) for a in train_ds.anchors]))
        print(f"\nInitial amount of weak labels: {init}")
        print(f"Amount of weak labels with overlaps: {over}\n")

        if config.active_learning_iterations and \
                iteration != config.active_learning_iterations:
            chosen_chkp = os.path.join(config.saving_path, "checkpoints",
                                       "current_chkp.tar")
            test_ds = Vaihingen3DWLDataset(config, split="test",
                                           test_on_train=True,
                                           data_root=args.data_root,
                                           rng=potentials_rng())
            tester = ModelTester(config, test_ds, chosen_chkp,
                                 device=device)
            tester.dataset = test_ds
            tester.cloud_segmentation_test(test_ds, num_votes=al_votes,
                                           active_learning=True,
                                           test_on_train=True)
            testers.append(tester)
        # every iteration trains from fresh weights
        chosen_chkp = None
    return trainer


if __name__ == "__main__":
    run(sys.argv[1:])
