"""Training step of both stages: one batch in, one SGD update out.

Counterpart of `step_core` (weasal_tpu/train/trainer.py:257-365): a
resident batch (`flat_inds`, data/resident.py) is assembled into level-0
arrays on the device, as :259-267 do, and the pyramid is built on the
device. The model runs in training mode (BatchNorm on batch statistics, running statistics
updated), autograd takes the gradients, and `sgd_step` applies the
update. The stage follows the model's `mode`:
- 'weak' (`KPFCNN_mprm`): `region_mprm_loss` (or `class_logits_loss`,
  by `config.loss_type`), the gradients clipped by their global norm;
- 'pseudo' (`KPFCNN`, :317-343): the weighted cross-entropy on the
  pseudo labels through the label table (raw 10 -> ignored), plus
  `contrast_loss` when `use_contrast` is set (from the epoch
  `contrast_start` on), the gradients clipped by value. Dropout and the
  contrast draw take the step's seed tensor (`step_seed` in a pack),
  which never leaves the device.
A network with deformable convs adds `p2p_fitting_regularizer` of their
regularizer inputs to the loss it differentiates (:304-309, 343); the
step reports it apart, as the log's `offset_loss`.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from portbench.reference.infer import input_batch
from portbench.reference.models import losses
from portbench.reference.models.blocks import deform_terms
from portbench.reference.train.optim import sgd_step


def class_weights(config, device) -> Optional[torch.Tensor]:
    """`config.class_w` as an f32 tensor on `device` (None when empty)."""
    return (torch.tensor(config.class_w, dtype=torch.float32, device=device)
            if len(config.class_w) else None)


def label_table(model, device) -> torch.Tensor:
    """The model's raw-label -> class-index table on `device`."""
    return torch.as_tensor(
        losses.valid_label_mapper(model.lbl_values, model.ign_lbls),
        device=device)


def seed_tensor(seed, device) -> torch.Tensor:
    """A step seed (an int or a tensor) as a 0-d int64 tensor on
    `device`."""
    return torch.as_tensor(seed, dtype=torch.int64).reshape(()).to(device)


def pseudo_loss(logits, batch, config, class_w, table, use_contrast: bool,
                seed: Optional[torch.Tensor] = None,
                slc_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The pseudo-label stage's loss of `step_core` (trainer.py:328-343):
    cross-entropy on the targets through `table`, plus, with
    `use_contrast`, the contrast loss on the flattened logits (labels
    below 0 as num_classes + 1, the level-0 mask as valid, threshold
    `contrast_thd` / 100)."""
    targets = losses.label_targets(batch.labels, table)
    loss = losses.softmax_cross_entropy(logits, targets, class_w)
    if use_contrast:
        c = logits.shape[-1]
        raw = batch.labels.reshape(-1)
        flat_labels = torch.where(raw >= 0, raw,
                                  torch.full_like(raw, config.num_classes
                                                  + 1))
        loss = loss + losses.contrast_loss(
            logits.reshape(-1, c), flat_labels, batch.masks[0].reshape(-1),
            config.num_classes,
            float(getattr(config, "contrast_thd", 20)) / 100.0,
            seed=seed, slc_idx=slc_idx)
    return loss


def step_on_batch(model, opt_state: Dict[str, torch.Tensor], batch, config,
                  lr: float, class_w: Optional[torch.Tensor] = None,
                  table: Optional[torch.Tensor] = None,
                  seed: Optional[torch.Tensor] = None,
                  use_contrast: bool = False,
                  dropout_keep: Optional[torch.Tensor] = None,
                  slc_idx: Optional[torch.Tensor] = None,
                  with_offset_loss: bool = False) -> Tuple[torch.Tensor, ...]:
    """One update of `model` on a PyramidBatch; returns (loss, accuracy) as
    0-d tensors, and the deformable convs' regularizer as a third with
    `with_offset_loss` (0 for a rigid network). `loss` is the stage's
    loss; the gradients are those of loss + regularizer. The parameters'
    `.grad` keep this step's gradients.
    `class_w` and `table` (from `class_weights` and `label_table`) are
    made here when the caller does not pass them. A 'pseudo' model takes
    the step's `seed` (a 0-d integer tensor on the device; default 0),
    `use_contrast`, and, to replay given draws, the dropout mask
    `dropout_keep` and the contrast loss's `slc_idx`."""
    model.train()
    model.zero_grad(set_to_none=True)
    mode = getattr(model, "mode", "weak")
    if mode == "pseudo":
        dev = batch.features.device
        seed = (torch.zeros((), dtype=torch.int64, device=dev)
                if seed is None else seed_tensor(seed, dev))
        logits = model(batch, dropout_seed=seed, dropout_keep=dropout_keep)
    else:
        logits, cla_logits, cam = model(batch)
    terms = deform_terms(model)
    reg = (losses.p2p_fitting_regularizer(terms, config.repulse_extent,
                                          config.deform_fitting_power)
           if terms else None)
    if class_w is None:
        class_w = class_weights(config, logits.device)
    if table is None:
        table = label_table(model, logits.device)
    loss_type = config.loss_type
    if mode == "pseudo":
        loss = pseudo_loss(logits, batch, config, class_w, table,
                           use_contrast, seed=seed, slc_idx=slc_idx)
    elif loss_type == "region_mprm_loss":
        loss = losses.region_mprm_loss(
            cam, batch.region_inds, batch.region_masks,
            batch.region_point_masks, batch.region_lb, class_w)
    elif loss_type == "class_logits_loss":
        loss = losses.class_logits_loss(cla_logits, batch.cloud_lb, class_w)
    else:
        raise ValueError(f"Unknown weak-label loss_type: {loss_type}")
    acc = losses.accuracy(logits.detach(),
                          losses.label_targets(batch.labels, table),
                          batch.masks[0])
    (loss if reg is None else loss + reg).backward()
    # the weak-label stage clips by global norm, the pseudo-label stage by
    # value (the JAX trainer's choice, trainer.py:182)
    sgd_step(model, opt_state, config, lr,
             clip="norm" if mode == "weak" else "value")
    if with_offset_loss:
        return loss.detach(), acc, (torch.zeros_like(loss.detach())
                                    if reg is None else reg.detach())
    return loss.detach(), acc


def step_body(model, opt_state: Dict[str, torch.Tensor], inputs: Mapping,
              config, plan, lr: Union[float, torch.Tensor],
              class_w: Optional[torch.Tensor], table: torch.Tensor, spec,
              use_contrast: bool = False) -> torch.Tensor:
    """One training step on a resident batch (`flat_inds`, the
    `pack_payloads` arrays and the `res_*` tensors, on the model's
    device); returns the stage's loss (0-d).

    :param lr: a float or a 0-d tensor on the device
    :param class_w, table: from `class_weights` and `label_table`
    :param use_contrast: a 'pseudo' step adds the contrast loss; its
        draws and the dropout mask take the seed `inputs["step_seed"]`
        (0-d; 0 when absent)
    """
    device = next(model.parameters()).device
    with torch.no_grad():
        batch, _ = input_batch(inputs, config, plan, device, spec=spec)
    return step_on_batch(model, opt_state, batch, config, lr,
                         class_w=class_w, table=table,
                         seed=inputs.get("step_seed"),
                         use_contrast=use_contrast)[0]
