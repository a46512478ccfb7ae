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

`--host_pyramid` votes on host-built pyramids (config.device_pyramid =
False), as the JAX script does without `--fused` (:64, 84-85).

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
    return parser.parse_args(argv)


def main(argv=None):
    """Parse `argv` and vote; returns the tester (its `test_probs` hold
    the votes, its `dataset` the split voted on)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    chosen_log = model_choice(args.resume or args.log)
    print("\nTesting on " + chosen_log)
    chosen_chkp = args.chkp or os.path.join(chosen_log, "checkpoints",
                                            "current_chkp.tar")
    config = Config()
    config.load(chosen_log)
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
    dataset = DATASETS[config.dataset](config, split=split,
                                       test_on_train=test_on_train,
                                       data_root=args.data_root)
    tester = ModelTester(config, dataset, chosen_chkp, device=device)
    tester.dataset = dataset
    stage_dir = ("WeakLabel" if config.dataset.endswith("WL")
                 else "PseudoLabel")
    tester.cloud_segmentation_test(dataset, num_votes,
                                   test_on_train=test_on_train,
                                   stage_dir=stage_dir,
                                   resume=args.resume is not None)
    return tester


if __name__ == "__main__":
    main(sys.argv[1:])
