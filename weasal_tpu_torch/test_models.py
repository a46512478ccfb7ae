"""Vote a trained weak-label or pseudo-label model over the training,
validation or test clouds.

Counterpart of the root test_models.py:33-100: picks the newest matching
log (`last_<DS>` aliases over `results/<stage>/Log_*`) or an explicit
one, reloads its parameters.txt and votes with `train/tester.ModelTester`
(validation_size 200, as the JAX script sets it); `--on train` votes on
the training clouds (the test split with `test_on_train`) and writes the
predictions that pseudo-label refinement reads; a pseudo-label log
(`last_Vaihingen3DPL`, results/PseudoLabel/) votes with its `KPFCNN`
into test/PseudoLabel/, the workflow's last step (`--on test`). A DALES
log (`last_DALESWL`, `last_DALESPL`) votes every tile of the split: `--on
train` the training tiles, `--on test` the `test_*` tiles, whose labels
are not read.

    python -m weasal_tpu_torch.test_models [--log last_Vaihingen3DWL |
        last_Vaihingen3DPL | last_DALESWL | last_DALESPL |
        results/WeakLabel/Log_x] [--on train|validation|test]
        [--data_root data/<dataset>] [--num_votes N] [--chkp file]
        [--resume Log_dir] [--host_pyramid] [--device cuda|cpu]
        [--devices N]

`--host_pyramid` votes on host-built pyramids (config.device_pyramid =
False), as the JAX script does without `--fused` (:64, 84-85).

A log trained data parallel (`data_parallel_devices` in its
parameters.txt) votes across as many ranks (parallel/ddp.py: NCCL on
`cuda:0..N-1`, gloo with `--device cpu`); `--devices N` sets another
count (1 votes alone).

Runs on CUDA unless `--device cpu` is given; where CUDA is absent it
raises.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data.datasets import (DALESPLDataset, DALESWLDataset,
                                            Vaihingen3DPLDataset,
                                            Vaihingen3DWLDataset)
from weasal_tpu_torch.parallel import ddp
from weasal_tpu_torch.train.tester import ModelTester
from weasal_tpu_torch.utils.device import resolve_device

# Batches of a vote epoch (the voting config's validation_size), as the
# JAX script sets it; the vote's end is tested between epochs
VOTE_EPOCH_BATCHES = 200
DEFAULT_VOTES = {"Vaihingen3DWL": 20, "Vaihingen3DPL": 20,
                 "DALESWL": 2, "DALESPL": 2}
DATASETS = {"Vaihingen3DWL": Vaihingen3DWLDataset,
            "Vaihingen3DPL": Vaihingen3DPLDataset,
            "DALESWL": DALESWLDataset,
            "DALESPL": DALESPLDataset}


def model_choice(chosen_log: str, results_root: str = "results") -> str:
    """Resolve a 'last_<DS>' alias to the newest log of that dataset
    under `results_root`/<stage>; any other value must be a log
    directory that exists."""
    if chosen_log in ("last_Vaihingen3DWL", "last_Vaihingen3DPL",
                      "last_DALESWL", "last_DALESPL"):
        test_dataset = "_".join(chosen_log.split("_")[1:])
        stage = "WeakLabel" if test_dataset.endswith("WL") else "PseudoLabel"
        results_dir = os.path.join(results_root, stage)
        logs = np.sort([os.path.join(results_dir, f)
                        for f in os.listdir(results_dir)
                        if f.startswith("Log")])
        for log in logs[::-1]:
            cfg = Config()
            cfg.load(log)
            if cfg.dataset.startswith(test_dataset):
                return str(log)
        raise ValueError(f'No log of the dataset "{test_dataset}" found')
    if not os.path.exists(chosen_log):
        raise ValueError("The given log does not exist: " + chosen_log)
    return chosen_log


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log", default="last_Vaihingen3DWL")
    parser.add_argument("--on", default="train",
                        choices=["train", "validation", "test"])
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--num_votes", type=int, default=None)
    parser.add_argument("--chkp", default=None,
                        help="checkpoint file (default current_chkp.tar)")
    parser.add_argument("--resume", default=None, metavar="LOG_DIR",
                        help="resume an interrupted vote from LOG_DIR's "
                             "vote checkpoint")
    parser.add_argument("--host_pyramid", action="store_true",
                        help="build each batch's pyramid on the host "
                             "(config.device_pyramid = False)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda)")
    parser.add_argument("--devices", type=int, default=None,
                        help="data-parallel ranks (default: the log's "
                             "data_parallel_devices)")
    return parser.parse_args(argv)


def main(argv=None):
    """Parse `argv` and vote; returns the tester (its `test_probs` hold
    the votes, its `dataset` the split voted on), or None after a
    data-parallel vote (the ranks' processes held the testers)."""
    args = parse_args(argv)
    chosen_log = model_choice(args.resume or args.log)
    config = Config()
    config.load(chosen_log)
    if args.devices is not None:
        config.data_parallel_devices = args.devices
    if ddp.current() is None:
        world = ddp.resolve_world(config.data_parallel_devices,
                                  args.device or "cuda")
        if world > 1:
            ddp.spawn(_vote_rank, world, args.device or "cuda",
                      args=(argv,))
            return None
        # a log trained data parallel, voted alone
        config.data_parallel_devices = 0
    ctx = ddp.current()
    device = resolve_device(args.device if ctx is None else ctx.device)
    print("\nTesting on " + chosen_log)
    chosen_chkp = args.chkp or os.path.join(chosen_log, "checkpoints",
                                            "current_chkp.tar")
    config.validation_size = VOTE_EPOCH_BATCHES
    config.input_threads = 10
    config.dropout = 0
    if args.host_pyramid:
        config.device_pyramid = False

    split = args.on
    test_on_train = split == "train"
    if test_on_train:
        split = "test"
    num_votes = (args.num_votes if args.num_votes is not None
                 else DEFAULT_VOTES[config.dataset])
    # under a group every rank starts from the same potentials
    rng = (None if ctx is None else np.random.default_rng(
        ddp.broadcast_object(int(np.random.SeedSequence().entropy
                                 % 2 ** 63))))
    with ddp.rank0_first():     # rank 0 writes the caches
        dataset = DATASETS[config.dataset](config, split=split,
                                           test_on_train=test_on_train,
                                           data_root=args.data_root,
                                           rng=rng)
    tester = ModelTester(config, dataset, chosen_chkp, device=device)
    tester.dataset = dataset
    stage_dir = ("WeakLabel" if config.dataset.endswith("WL")
                 else "PseudoLabel")
    tester.cloud_segmentation_test(dataset, num_votes,
                                   test_on_train=test_on_train,
                                   stage_dir=stage_dir,
                                   resume=args.resume is not None)
    return tester


def _vote_rank(argv) -> None:
    """One rank of `main` under `ddp.spawn`."""
    main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
