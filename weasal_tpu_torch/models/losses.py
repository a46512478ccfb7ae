"""Weak-label losses and the training accuracy on the dense sphere layout.

Counterpart of weasal_tpu/models/losses.py: `bce_with_logits` (:42),
`class_logits_loss` (:66), `region_mprm_loss` (:74) and `accuracy`
(:237), plus the port's own copy of `valid_label_mapper`
(weasal_tpu/models/architectures.py:40). Padded rows and padded regions
are masked out, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse, gather_rows


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    class_w: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy on logits, weighted by class_w on the last
    axis; with a row `mask`, the mean runs over the masked-in rows only."""
    loss = -(targets * F.logsigmoid(logits)
             + (1 - targets) * F.logsigmoid(-logits))
    if class_w is not None:
        loss = loss * class_w
    if mask is None:
        return loss.mean()
    m = mask.to(loss.dtype)
    while m.dim() < loss.dim():
        m = m[..., None]
    return (loss * m).sum() / (m * torch.ones_like(loss)).sum().clamp(
        min=1e-9)


def class_logits_loss(cla_logits: Sequence[torch.Tensor],
                      cloud_lb: torch.Tensor,
                      class_w: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Sphere-level BCE summed over the 4 MPRM paths."""
    return sum(bce_with_logits(lg, cloud_lb, class_w) for lg in cla_logits)


def region_mprm_loss(cam: Sequence[torch.Tensor],
                     region_inds: torch.Tensor,
                     region_masks: torch.Tensor,
                     region_point_masks: torch.Tensor,
                     region_lb: torch.Tensor,
                     class_w: Optional[torch.Tensor] = None,
                     inverse: Optional[LazyInverse] = None
                     ) -> torch.Tensor:
    """Sub-region weak-label loss: for each of the 4 class maps, the mean
    logit over every region's member points against the region's
    multi-hot label (BCE over the existing regions), summed over paths.
    The members' gather adds its gradient into each point in a fixed
    order (ops/cuda/inverse_lists.GatherRows; `inverse`: the lists of
    region_inds over the level-0 points, shared by the 4 paths; needed
    on the card only).

    :param cam: 4 x [B, N0, C] per-point class maps
    :param region_inds: [B, R, P] level-0 indices (pad = N0)
    :param region_masks: [B, R] region exists
    :param region_point_masks: [B, R, P] member valid
    :param region_lb: [B, R, C] multi-hot labels
    """
    total = 0.0
    pm = region_point_masks.to(cam[0].dtype)                  # [B, R, P]
    counts = pm.sum(dim=-1).clamp(min=1.0)                    # [B, R]
    for path in cam:
        member = gather_rows(path, region_inds, inverse=inverse)  # [B,R,P,C]
        mean_logits = ((member * pm[..., None]).sum(dim=2)
                       / counts[..., None])                   # [B, R, C]
        total = total + bce_with_logits(mean_logits, region_lb, class_w,
                                        mask=region_masks)
    return total


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Fraction of the masked-in (real) points whose argmax equals the
    target; ignored points (target -1) count as wrong."""
    correct = (logits.argmax(dim=-1) == targets) & mask
    return correct.sum() / mask.sum().clamp(min=1)


def valid_label_mapper(lbl_values: Sequence[int],
                       ign_lbls: Sequence[int]) -> np.ndarray:
    """Lookup table raw label -> class index in [0, C), or -1 if ignored."""
    valid = np.sort([c for c in lbl_values if c not in set(ign_lbls)])
    table = -np.ones(int(max(lbl_values)) + 1, dtype=np.int32)
    for i, c in enumerate(valid):
        table[c] = i
    return table


def label_targets(labels: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Class targets of raw labels through a `valid_label_mapper` table;
    padding (-1) stays -1."""
    return torch.where(labels >= 0, table[labels.clamp(min=0).long()],
                       torch.full_like(labels, -1))
