"""Pseudo-label training on DALES with active learning.

Counterpart of train_DALES_PseudoLabel.py (`run_pl(DALESPLConfig,
DALESPLDataset)`): the Vaihingen3D pseudo-label stage's runner,
arguments, quick preset and set-up (train_Vaihingen3D_PseudoLabel) with
the DALES configuration (`DALESPLConfig`: 5 levels, 16 m spheres at 0.4
m, no color, a 10 % refinement threshold) and the multi-tile DALES
dataset. The class weights come from `<data_root>/PseudoLabels/
<weak_label_log>/DALES_t10_weight.txt` when it exists, the labels of
each training tile from its `<tile>_t10_pseudo.txt`.

    python -m weasal_tpu_torch.train_DALES_PseudoLabel [saving_path]
        --weak_label_log Log_x [--data_root data/DALES] [the arguments
        of train_Vaihingen3D_PseudoLabel]

Runs on CUDA unless `--device cpu` is given; where CUDA is absent it
raises instead.
"""

from __future__ import annotations

import dataclasses
import sys

from weasal_tpu_torch import train_Vaihingen3D_PseudoLabel as vaihingen
from weasal_tpu_torch.config import DALESPLConfig
from weasal_tpu_torch.data.datasets import DALESPLDataset
from weasal_tpu_torch.train import stage


def config_for(args):
    """DALES has no deformable configuration: `--deformable` raises."""
    if args.deformable:
        raise ValueError("--deformable: no deformable DALES configuration "
                         "(config.VaihingenPLDeformConfig is Vaihingen3D's)")
    return None


STAGE = dataclasses.replace(
    vaihingen.STAGE, config_cls=DALESPLConfig, dataset_cls=DALESPLDataset,
    description=__doc__.splitlines()[0], config_for=config_for)


def run(argv=None):
    """Parse `argv` and run every active-learning iteration; returns the
    last iteration's trainer (train/stage.run)."""
    return stage.run(STAGE, argv)


if __name__ == "__main__":
    run(sys.argv[1:])
