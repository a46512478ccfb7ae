"""Weak-label training on DALES with active learning.

Counterpart of train_DALES_WeakLabel.py (`run(DALESWLConfig,
DALESWLDataset)`): the Vaihingen3D weak-label stage's runner, arguments,
quick preset and set-up (train_Vaihingen3D_WeakLabel) with the DALES
configuration (`DALESWLConfig`: 128 features, 16 m spheres at 0.4 m, no
color) and the multi-tile DALES dataset; every training tile keeps an
anchor ledger of its own.

    python -m weasal_tpu_torch.train_DALES_WeakLabel [saving_path]
        [--data_root data/DALES] [the arguments of
        train_Vaihingen3D_WeakLabel]

Runs on CUDA unless `--device cpu` is given; where CUDA is absent it
raises instead.
"""

from __future__ import annotations

import dataclasses
import sys

from weasal_tpu_torch import train_Vaihingen3D_WeakLabel as vaihingen
from weasal_tpu_torch.config import DALESWLConfig
from weasal_tpu_torch.data.datasets import DALESWLDataset
from weasal_tpu_torch.train import stage

STAGE = dataclasses.replace(
    vaihingen.STAGE, config_cls=DALESWLConfig, dataset_cls=DALESWLDataset,
    description=__doc__.splitlines()[0])


def run(argv=None):
    """Parse `argv` and run every active-learning iteration; returns the
    last iteration's trainer (train/stage.run)."""
    return stage.run(STAGE, argv)


if __name__ == "__main__":
    run(sys.argv[1:])
