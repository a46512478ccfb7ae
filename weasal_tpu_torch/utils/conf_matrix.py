"""Confusion-matrix reports: asymmetric matrices, per-class scores, text.

Counterpart of weasal_tpu/utils/conf_matrix.py: `create` (:20),
`analyze` (:56) and `print_to_file` (:157), the same arithmetic in
numpy. The heatmap (`plot`) is not ported: it needs matplotlib, which the
port does not import.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from weasal_tpu_torch.utils.metrics import fast_confusion


def create(gt: np.ndarray, pred: np.ndarray,
           label_values: Optional[Sequence[int]] = None,
           pred_label_values: Optional[Sequence[int]] = None) -> np.ndarray:
    """Confusion matrix (rows = ground truth). With `pred_label_values`
    the rows follow `label_values` and the columns `pred_label_values`
    (possibly rectangular); a label outside its set (an ignore label such
    as -1, or one past the largest) drops the point."""
    if label_values is None:
        label_values = np.unique(np.hstack((gt, pred)))
    if pred_label_values is None:
        return fast_confusion(gt, pred, np.asarray(label_values))

    def continuous(data, labels):
        labels = np.asarray(labels, np.int64)
        data = np.asarray(data, np.int64)
        table = np.full(labels.max() + 2, -1, np.int64)
        table[labels] = np.arange(labels.size)
        # out-of-range ids go to the -1 slot, which `valid` drops
        safe = np.where((data >= 0) & (data <= labels.max()), data,
                        labels.max() + 1)
        return table[safe], labels.size

    g, n_gt = continuous(gt, label_values)
    p, n_pr = continuous(pred, pred_label_values)
    valid = (g >= 0) & (p >= 0)
    flat = np.bincount(g[valid] * n_pr + p[valid], minlength=n_gt * n_pr)
    return flat.reshape(n_gt, n_pr)


def analyze(confusion: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-class precision, recall, F1, IoU and frequency, and the overall
    accuracy `oa`."""
    C = confusion.astype(np.float64)
    tp = np.diagonal(C)
    col = C.sum(axis=0)
    row = C.sum(axis=1)
    precision = tp / np.maximum(col, 1e-9)
    recall = tp / np.maximum(row, 1e-9)
    f1 = 2 * tp / np.maximum(col + row, 1e-9)
    iou = tp / np.maximum(col + row - tp, 1e-9)
    oa = tp.sum() / np.maximum(C.sum(), 1e-9)
    freq = row / np.maximum(C.sum(), 1e-9)
    return dict(precision=precision, recall=recall, f1=f1, iou=iou,
                oa=oa, frequency=freq)


def print_to_file(confusion: np.ndarray, label_to_names: Dict[int, str],
                  path: str) -> None:
    """Write the confusion (one row a class, in label order) and the
    per-class scores as text."""
    stats = analyze(confusion)
    names = [label_to_names[k] for k in sorted(label_to_names)]
    with open(path, "w") as f:
        f.write("confusion (rows = ground truth):\n")
        for i, nm in enumerate(names):
            f.write(nm.ljust(20)
                    + " ".join(f"{int(v):8d}" for v in confusion[i]) + "\n")
        f.write(f"\nOA = {100 * stats['oa']:.2f}%\n")
        for key in ("precision", "recall", "f1", "iou"):
            f.write(key.ljust(10) + " ".join(
                f"{100 * v:6.2f}" for v in stats[key]) + "\n")
