"""The training losses and accuracy on the dense sphere layout.

Counterpart of weasal_tpu/models/losses.py: `softmax_cross_entropy`
(:19), `bce_with_logits` (:42), `class_logits_loss` (:66),
`region_mprm_loss` (:74), `p2p_fitting_regularizer` (:112-157),
`contrast_loss` (:158-236) and `accuracy` (:237), plus the port's own copy of `valid_label_mapper`
(weasal_tpu/models/architectures.py:40). Padded rows and padded regions
are masked out, as in the JAX package.

`contrast_loss` draws its reference points as `jax.random.choice(p=...,
replace=True)` does (an inverse CDF over the marked points, exact in
integers), from uniforms of the port's threefry stream of the step's seed
(utils/prng), not from JAX's key; its per-class sums are masked
reductions and the gather of the drawn rows sums its gradient in a
fixed order (ops/cuda/inverse_lists.GatherRows), so that nothing adds
with atomics on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse, gather_rows
from weasal_tpu_torch.utils import prng


# The threefry stream (utils/prng) of the contrast loss's draw; dropout
# draws from stream 0 of the same step seed (models/blocks.py)
CONTRAST_STREAM = 1


def softmax_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                          class_w: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Weighted cross-entropy with ignore index -1:
    sum(w_i * nll_i) / max(sum(w_i), 1e-9), w_i = class_w[target_i] (1
    without weights) and 0 for an ignored point.

    :param logits: [..., C]
    :param targets: [...] integer in [0, C) or -1
    """
    valid = targets >= 0
    safe_t = torch.where(valid, targets, torch.zeros_like(targets)).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe_t[..., None])[..., 0]
    w = class_w[safe_t] if class_w is not None else torch.ones_like(nll)
    w = w * valid.to(nll.dtype)
    return (nll * w).sum() / w.sum().clamp(min=1e-9)


def contrast_draw(certain: torch.Tensor, valid_mask: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """The reference points of `contrast_loss` (int64 [S]): uniform over
    the certain points, over the valid ones when none is certain, drawn
    with replacement at the uniforms u [S] on [0, 1) by the inverse CDF,
    as `jax.random.choice(p=p, replace=True)` draws them: the k-th
    marked point, k = ceil((1 - u) * marked points). The CDF is an
    integer cumsum, exact in any order of its adds (a float scan on the
    card may add in an order that varies from run to run)."""
    w = torch.where(certain.any(), certain, valid_mask).to(torch.int64)
    cum = torch.cumsum(w, dim=0)
    k = torch.ceil((1.0 - u) * cum[-1].to(u.dtype)).to(torch.int64)
    k = torch.minimum(k.clamp(min=1), cum[-1])
    return torch.searchsorted(cum, k).clamp(max=w.shape[0] - 1)


def contrast_loss(logits: torch.Tensor, labels: torch.Tensor,
                  valid_mask: torch.Tensor, num_classes: int,
                  threshold: float, seed: Optional[torch.Tensor] = None,
                  slc_con: int = 1000, temperature: float = 0.1,
                  base_temperature: float = 1.0,
                  slc_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Supervised contrastive loss on pseudo labels (flattened points).

    :param logits: [N, C]
    :param labels: [N] raw label indices; below num_classes = labeled,
        num_classes or more (10 'Ignore', or num_classes + 1 for padding)
        = unlabeled
    :param valid_mask: [N] real points
    :param seed: the step's seed tensor (0-d, on the device): slc_con
        reference points are drawn from its CONTRAST_STREAM uniforms
    :param slc_idx: [S] reference points given instead of the draw
    :return: 0-d; 0 when no point is certain
    """
    n = logits.shape[0]
    eps = 1e-8
    prob = torch.softmax(logits, dim=1)
    pseudo_conf = prob.amax(dim=1)
    label_id = (labels < num_classes) & valid_mask
    certain = ((pseudo_conf > threshold) | label_id) & valid_mask
    pseudo_lbs = torch.where(label_id, labels.long(),
                             torch.argmax(prob, dim=1))
    any_valid = certain.sum() > 0
    if slc_idx is None:
        if seed is None:
            raise ValueError("contrast_loss needs a seed tensor or slc_idx")
        u = prng.uniform(seed.reshape(1), slc_con, CONTRAST_STREAM)[0]
        slc_idx = contrast_draw(certain, valid_mask, u)
    slc_idx = slc_idx.to(device=logits.device, dtype=torch.int64)

    mask_slice = torch.arange(n, device=logits.device)[:, None] \
        != slc_idx[None, :]
    certain_slc = certain[slc_idx]
    mask_certain = certain_slc[None, :] == certain[:, None]
    pos_bool = pseudo_lbs[slc_idx][None, :] == pseudo_lbs[:, None]
    mc = (mask_slice & mask_certain).to(logits.dtype)
    pos_mask = (pos_bool & mask_slice & mask_certain).to(logits.dtype)

    feats = logits / torch.linalg.vector_norm(
        logits, dim=1, keepdim=True).clamp(min=1e-12)
    # the drawn rows' gradient sums over their inverse list (fixed order)
    inds = slc_idx.to(torch.int32).reshape(1, -1, 1)
    feats_slc = gather_rows(feats[None], inds,
                            inverse=LazyInverse(inds, n))[0, :, 0]
    sim = (feats @ feats_slc.t()) / temperature
    sim = sim - sim.amax(dim=1, keepdim=True).detach()
    exp_sim = torch.exp(sim) * mc
    log_prob = (sim - torch.log(exp_sim.sum(dim=1, keepdim=True) + eps)) \
        * mc
    mean_log_prob_pos = ((pos_mask * log_prob).sum(dim=1)
                         / (pos_mask.sum(dim=1) + 1e-12))
    pts_loss = -(temperature / base_temperature) * mean_log_prob_pos

    # Positive per-point losses averaged per pseudo class, then over the
    # classes with a positive mean; the class sums as masked reductions
    w = ((pts_loss > 0) & valid_mask).to(logits.dtype)
    onehot = (pseudo_lbs[:, None] == torch.arange(
        num_classes + 2, device=logits.device)[None, :]).to(logits.dtype)
    sums = (onehot * (pts_loss * w)[:, None]).sum(dim=0)
    cnts = (onehot * w[:, None]).sum(dim=0)
    class_means = sums / cnts.clamp(min=1e-9)
    pos = (class_means > 0).to(logits.dtype)
    loss = (class_means * pos).sum() / pos.sum().clamp(min=1e-9)
    return torch.where(any_valid, loss, torch.zeros_like(loss))


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


def p2p_fitting_regularizer(terms: Sequence, repulse_extent: float,
                            deform_fitting_power: float) -> torch.Tensor:
    """The deformable kernels' fitting and repulsion regularizer
    (weasal_tpu/models/losses.py:112-157).

    :param terms: per deformable conv (models/blocks.deform_terms), the
        tuple (min_sq [B, N, Kp] extent-normalized squared distance from
        each deformed kernel point to its nearest neighbor, deformed_kp
        [B, N, Kp, 3] extent-normalized positions, q_valid [B, N]
        real-query mask); the means run over real query rows only
    :return: a 0-d tensor, deform_fitting_power * (2 * fitting +
        repulsion); 0 (a Python float) without terms
    """
    fitting = 0.0
    repulsive = 0.0
    for min_sq, kp, m in terms:
        denom = m.sum().clamp(min=1.0)
        k = min_sq.shape[-1]
        fitting = fitting + (min_sq.abs() * m[..., None]).sum() / (denom * k)
        diff = kp[..., :, None, :] - kp[..., None, :, :].detach()
        dist = torch.sqrt((diff * diff).sum(dim=-1) + 1e-12)
        off_diag = 1.0 - torch.eye(k, dtype=kp.dtype, device=kp.device)
        rep = torch.clamp(dist - repulse_extent, max=0.0) ** 2 * off_diag
        # sum_i mean(rep_i) / K: the mean over (real point, i) of each
        # kernel point's repulsion sum
        repulsive = repulsive + (rep.sum(dim=-1) * m[..., None]).sum() / (
            denom * k)
    return deform_fitting_power * (2 * fitting + repulsive)


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
