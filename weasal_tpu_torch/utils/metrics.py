"""Segmentation metrics: confusion matrices and the scores derived from
them.

Counterpart of weasal_tpu/utils/metrics.py: `fast_confusion` (:13),
`metrics_from_confusions` (:61), `smooth_metrics` (:82) and
`IoU_from_confusions` (:105), the same arithmetic in numpy.
"""

from __future__ import annotations

import numpy as np


def fast_confusion(true: np.ndarray,
                   pred: np.ndarray,
                   label_values: np.ndarray | None = None) -> np.ndarray:
    """Vectorized confusion matrix.

    Rows are ground truth, columns are predictions, ordered by sorted
    `label_values`. Handles non-contiguous label sets via a remap table.
    """
    true = np.squeeze(np.asarray(true))
    pred = np.squeeze(np.asarray(pred))
    if true.ndim != 1 or pred.ndim != 1:
        raise ValueError("fast_confusion expects 1-D label arrays")
    if true.dtype.kind not in "iu" or pred.dtype.kind not in "iu":
        raise ValueError("fast_confusion expects integer labels")
    true = true.astype(np.int64)
    pred = pred.astype(np.int64)

    if label_values is None:
        label_values = np.unique(np.hstack((true, pred)))
    else:
        label_values = np.asarray(label_values)
        if len(np.unique(label_values)) < len(label_values):
            raise ValueError("label_values must be unique")
    label_values = np.sort(label_values).astype(np.int64)
    num_classes = len(label_values)

    contiguous = label_values[0] == 0 and label_values[-1] == num_classes - 1
    if not contiguous:
        if label_values[0] < 0:
            raise ValueError("Negative class labels are not supported")
        label_map = np.zeros(label_values[-1] + 1, dtype=np.int64)
        label_map[label_values] = np.arange(num_classes)
        true = label_map[true]
        pred = label_map[pred]

    idx = true * num_classes + pred
    if idx.size and (idx.max() >= num_classes ** 2 or idx.min() < 0):
        # Fail loudly like the reference's reshape would: a label outside
        # label_values (e.g. NO_LABEL=10 leaking into a 9-class eval)
        # must not silently alias into a wrong confusion cell
        bad_t = np.setdiff1d(np.unique(true), np.arange(num_classes))
        bad_p = np.setdiff1d(np.unique(pred), np.arange(num_classes))
        raise ValueError(
            f"labels outside label_values: true={bad_t}, pred={bad_p}")
    vec = np.bincount(idx, minlength=num_classes ** 2)
    return vec.reshape(num_classes, num_classes)


def metrics_from_confusions(confusions: np.ndarray,
                            ignore_unclassified: bool = False):
    """(PRE, REC, F1, IoU, ACC) of [..., C, C] confusion stacks (rows =
    ground truth); with `ignore_unclassified` class 0's row and column are
    zeroed first."""
    confusions = np.asarray(confusions, dtype=np.float64)
    if ignore_unclassified:
        confusions = confusions.copy()
        confusions[..., 0, :] = 0
        confusions[..., :, 0] = 0
    TP = np.diagonal(confusions, axis1=-2, axis2=-1)
    TP_plus_FP = np.sum(confusions, axis=-2)       # prediction counts
    TP_plus_FN = np.sum(confusions, axis=-1)       # truth counts
    PRE = TP / (TP_plus_FP + 1e-6)
    REC = TP / (TP_plus_FN + 1e-6)
    ACC = np.sum(TP, axis=-1) / (np.sum(confusions, axis=(-2, -1)) + 1e-6)
    F1 = 2 * TP / (TP_plus_FP + TP_plus_FN + 1e-6)
    IoU = F1 / (2 - F1)
    return PRE, REC, F1, IoU, ACC


def smooth_metrics(confusions: np.ndarray, smooth_n: int = 0,
                   ignore_unclassified: bool = False):
    """`metrics_from_confusions` of the confusions summed over +-smooth_n
    epochs (the axis before the last two), returned as (REC, PRE, F1, IoU,
    ACC): the reference's smooth_metrics swaps precision and recall, and
    the JAX package keeps that order (weasal_tpu/utils/metrics.py:85-89)."""
    confusions = np.asarray(confusions)
    smoothed = confusions.copy()
    if confusions.ndim > 2 and smooth_n > 0:
        n_epochs = confusions.shape[-3]
        for epoch in range(n_epochs):
            i0 = max(epoch - smooth_n, 0)
            i1 = min(epoch + smooth_n + 1, n_epochs)
            smoothed[..., epoch, :, :] = np.sum(
                confusions[..., i0:i1, :, :], axis=-3)
    pre, rec, f1, iou, acc = metrics_from_confusions(
        smoothed, ignore_unclassified)
    return rec, pre, f1, iou, acc


def IoU_from_confusions(confusions: np.ndarray) -> np.ndarray:
    """Per-class IoU from [..., C, C] confusions.

    Classes absent from the ground truth get the mean IoU of present classes
    substituted, so that taking the plain mean afterwards yields the honest
    mIoU over present classes (reference utils/metrics.py:223-228).
    """
    confusions = np.asarray(confusions, dtype=np.float64)
    TP = np.diagonal(confusions, axis1=-2, axis2=-1)
    TP_plus_FN = np.sum(confusions, axis=-1)
    TP_plus_FP = np.sum(confusions, axis=-2)

    IoU = TP / (TP_plus_FP + TP_plus_FN - TP + 1e-6)

    mask = TP_plus_FN < 1e-3
    counts = np.sum(1 - mask, axis=-1, keepdims=True)
    mIoU = np.sum(IoU, axis=-1, keepdims=True) / (counts + 1e-6)
    IoU += mask * mIoU
    return IoU
