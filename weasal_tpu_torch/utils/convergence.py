"""Training-log loaders.

Counterpart of the loaders of weasal_tpu/utils/convergence.py (:23-72,
180): `training_iteration*.txt` (columns: epoch step out_loss
offset_loss accuracy time) and `val_IoUs.txt` of a log, the centered
running mean of the curves, and the `Log_*` directories under a results
root. Both packages' trainers write these files, so either package reads
either's logs. The plots (`compare_*`) are not ported: they need
matplotlib, which the port does not import.
"""

from __future__ import annotations

import os
from os.path import exists, isdir, join
from typing import Dict, List, Optional

import numpy as np

from weasal_tpu_torch.config import Config


def load_training_iterations(log_dir: str) -> Dict[int, np.ndarray]:
    """{al_iteration: array[N, 6]} of per-step rows for one log dir."""
    out = {}
    for f in sorted(os.listdir(log_dir)):
        if not f.startswith("training_iteration"):
            continue
        it = int(f[len("training_iteration"):-len(".txt")])
        rows = []
        with open(join(log_dir, f)) as fh:
            fh.readline()                   # the header
            for line in fh:
                parts = line.split()
                if len(parts) >= 6:
                    rows.append([float(p) for p in parts[:6]])
        if rows:
            out[it] = np.array(rows)
    return out


def load_val_ious(log_dir: str) -> np.ndarray:
    """[n_epochs, n_classes] validation IoUs for one log dir."""
    path = join(log_dir, "val_IoUs.txt")
    if not exists(path):
        return np.zeros((0, 0))
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if vals:
                rows.append(vals)
    if not rows:
        return np.zeros((0, 0))
    width = max(len(r) for r in rows)
    return np.array([r + [np.nan] * (width - len(r)) for r in rows])


def running_mean(x: np.ndarray, n: int) -> np.ndarray:
    """Centered moving average over +-n rows, each divided by the rows it
    covers (a zero-padded convolution would halve the first and last n
    values); `x` itself when n <= 1 or x has fewer than 2n rows."""
    if n <= 1 or x.shape[0] < 2 * n:
        return x
    kernel = np.ones(2 * n + 1)
    sums = np.convolve(x, kernel, mode="same")
    counts = np.convolve(np.ones_like(x), kernel, mode="same")
    return sums / counts


def find_logs(results_root: str = "results",
              stage: Optional[str] = None,
              dataset_prefix: Optional[str] = None) -> List[str]:
    """The Log_* directories under `results_root`/<stage> (WeakLabel and
    PseudoLabel by default), those whose parameters.txt names a dataset
    starting with `dataset_prefix` when it is given (a log without a
    readable parameters.txt is left out then)."""
    stages = [stage] if stage else ["WeakLabel", "PseudoLabel"]
    logs = []
    for st in stages:
        root = join(results_root, st)
        if not isdir(root):
            continue
        for d in sorted(os.listdir(root)):
            full = join(root, d)
            if not d.startswith("Log") or not isdir(full):
                continue
            if dataset_prefix:
                try:
                    cfg = Config()
                    cfg.load(full)
                except (OSError, ValueError, IndexError):
                    continue
                if not cfg.dataset.startswith(dataset_prefix):
                    continue
            logs.append(full)
    return logs
