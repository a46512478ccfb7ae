"""The active-learning stage runner that both training entry points share.

Counterpart of the shared `run(config_cls, dataset_cls, stage_dir)` of
the JAX root scripts (train_Vaihingen3D_WeakLabel.py:112-264, which
train_Vaihingen3D_PseudoLabel.py's `run_pl` follows), on the fused path
or, with `--host_pyramid` (those scripts without `--fused`), on the host
pyramid: the arguments both stages take, the plan, bucket and dispatch
overrides, the quick preset, resume, then per active-learning iteration
the training and validation datasets, a fresh trainer, `train` with
per-epoch validation and checkpoints, and between iterations a vote of
the trained model on the training clouds (the test split with
`test_on_train`, `--al_votes` votes) that extends every training file's
ledger (train/tester.ModelTester). A `Stage` names what differs between
the stages: the configuration and dataset classes, the results
subdirectory, its own arguments, its quick preset, its own set-up after
the shared overrides, and what it prints after each training.

`--devices N` (the JAX scripts' `--devices`,
train_Vaihingen3D_WeakLabel.py:133-135, 175-176; -1 = every visible
card) trains and votes data parallel (parallel/ddp.py): the runner
spawns N ranks, each running this whole stage in a group, NCCL on
`cuda:0..N-1`, or gloo with `--device cpu`; more cards than exist
raises. Rank 0 builds each dataset's caches first and writes every file;
the potentials take a seed that every rank shares (`--seed`, or rank 0's
draw).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from weasal_tpu_torch.parallel import ddp
from weasal_tpu_torch.train.tester import ModelTester
from weasal_tpu_torch.train.trainer import ModelTrainer
from weasal_tpu_torch.utils.device import resolve_device


@dataclass
class Stage:
    """What one training stage adds to the shared runner.

    :param config_cls: the stage's configuration class
    :param dataset_cls: the stage's dataset class
    :param stage_dir: the results subdirectory (WeakLabel | PseudoLabel)
    :param description: the argument parser's description
    :param add_arguments: adds the stage's own arguments to the parser
    :param quick: turns a configuration into the `--preset quick` one
    :param configure: the stage's set-up from its own arguments, after the
        shared overrides and resume, before the first iteration
    :param after_training: prints after each iteration's training, given
        (config, training dataset, iteration)
    :param config_for: the configuration class that the stage's own
        arguments select in place of `config_cls` (None: `config_cls`)
    """
    config_cls: type
    dataset_cls: type
    stage_dir: str
    description: str
    add_arguments: Callable[[argparse.ArgumentParser], None]
    quick: Callable[[object], None]
    configure: Callable[[object, argparse.Namespace], None]
    after_training: Optional[Callable[[object, object, int], None]] = None
    config_for: Optional[Callable[[argparse.Namespace], Optional[type]]] \
        = None


def parse_args(stage: Stage, argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=stage.description)
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
                        help="labels added per training file and "
                             "acquisition (config.added_labels_per_epoch)")
    parser.add_argument("--al_acquisition", default=None,
                        choices=["entropy", "random"],
                        help="acquisition policy: the reference's entropy "
                             "ranking or random unused labels at the same "
                             "budget")
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
    parser.add_argument("--host_pyramid", action="store_true",
                        help="build each batch's pyramid on the host "
                             "(config.device_pyramid = False; the JAX "
                             "root scripts' default, run there without "
                             "--fused)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None,
                        help="data-parallel ranks (config."
                             "data_parallel_devices): one process per "
                             "card with NCCL, or gloo with --device cpu; "
                             "-1 = every visible card")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the datasets' initial potentials "
                             "(default unseeded), which fixes the "
                             "calibrated plan and the spheres of a run")
    stage.add_arguments(parser)
    return parser.parse_args(argv)


def run(stage: Stage, argv=None):
    """Parse `argv` and run every active-learning iteration of `stage`;
    returns the last iteration's trainer (its `datasets` hold that
    iteration's training and validation datasets, its `testers` the
    acquisition passes' testers)."""
    args = parse_args(stage, argv)
    chosen = stage.config_for(args) if stage.config_for else None
    config = (chosen or stage.config_cls)()
    if args.plan_percentile is not None:
        config.plan_point_percentile = args.plan_percentile
    if args.plan_buckets is not None:
        config.plan_bucket_percentile = args.plan_buckets
    if args.steps_per_dispatch is not None:
        config.steps_per_dispatch = args.steps_per_dispatch
    if args.host_pyramid:
        config.device_pyramid = False
    if args.preset == "quick":
        stage.quick(config)
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
    if args.al_acquisition is not None:
        config.al_acquisition = args.al_acquisition
    if args.added_labels is not None:
        config.added_labels_per_epoch = args.added_labels
    if args.al_iterations is not None:
        config.active_learning_iterations = args.al_iterations
    if args.devices is not None:
        config.data_parallel_devices = args.devices
    ctx = ddp.current()
    if ctx is None:
        # --devices, or a resumed log's data_parallel_devices: the ranks
        # each run this function again, in their group
        world = ddp.resolve_world(config.data_parallel_devices,
                                  args.device or "cuda")
        if world > 1:
            ddp.spawn(_run_rank, world, args.device or "cuda",
                      args=(stage, argv))
            return None
    device = resolve_device(args.device if ctx is None else ctx.device)
    stage.configure(config, args)
    schedule = None
    if args.epoch_schedule:
        schedule = [int(v) for v in args.epoch_schedule.split(",")]
    al_votes = args.al_votes if args.al_votes is not None \
        else (2 if args.preset == "quick" else 10)

    seed = args.seed
    if seed is None and ctx is not None:
        # every rank samples the same spheres
        seed = ddp.broadcast_object(int(np.random.SeedSequence().entropy
                                        % 2 ** 63))

    def potentials_rng():
        return None if seed is None else np.random.default_rng(seed)

    testers = []
    trainer = None
    for iteration in range(iteration_previous,
                           config.active_learning_iterations + 1):
        print(f"\n=== Active-learning iteration {iteration} ===\n")
        if schedule:
            config.max_epoch = schedule[min(iteration, len(schedule) - 1)]
        with ddp.rank0_first():     # rank 0 writes the caches
            train_ds = stage.dataset_cls(config, split="training",
                                         al_iteration=iteration,
                                         data_root=args.data_root,
                                         rng=potentials_rng())
            val_ds = stage.dataset_cls(config, split="validation",
                                       data_root=args.data_root,
                                       rng=potentials_rng())
        trainer = ModelTrainer(config, train_ds, chkp_path=chosen_chkp,
                               device=device, stage_dir=stage.stage_dir)
        trainer.datasets = (train_ds, val_ds)
        trainer.testers = testers
        trainer.train(train_ds, val_ds, al_iteration=iteration)
        if stage.after_training is not None:
            stage.after_training(config, train_ds, iteration)

        if config.active_learning_iterations and \
                iteration != config.active_learning_iterations:
            chosen_chkp = os.path.join(config.saving_path, "checkpoints",
                                       "current_chkp.tar")
            with ddp.rank0_first():
                test_ds = stage.dataset_cls(config, split="test",
                                            test_on_train=True,
                                            data_root=args.data_root,
                                            rng=potentials_rng())
            tester = ModelTester(config, test_ds, chosen_chkp,
                                 device=device)
            tester.dataset = test_ds
            tester.cloud_segmentation_test(test_ds, num_votes=al_votes,
                                           active_learning=True,
                                           test_on_train=True,
                                           stage_dir=stage.stage_dir)
            testers.append(tester)
        # every iteration trains from fresh weights
        chosen_chkp = None
    return trainer


def _run_rank(stage: Stage, argv) -> None:
    """One rank of `run` under `ddp.spawn`."""
    run(stage, argv)
