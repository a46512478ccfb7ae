"""Training step of both stages: one batch in, one SGD update out.

Counterpart of `step_core` (weasal_tpu/train/trainer.py:257-365) on the
fused path: a resident batch (`flat_inds`, data/resident.py) is first
assembled into level-0 arrays on the device, as :259-267 do; a level-0
batch goes on as it is. The pyramid is built on the device, the model
runs in training mode (BatchNorm on batch statistics, running statistics
updated), the backward runs kernels C and D, and `sgd_step` applies the
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

`step_body` is the step on fixed-shape inputs with its results written
into preallocated tensors: what the trainer runs eagerly or captures in a
CUDA graph (train/graphs.py). `train_step` calls it eagerly.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from weasal_tpu_torch.infer import level0_on_device
from weasal_tpu_torch.models import losses
from weasal_tpu_torch.models.blocks import deform_terms
from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
from weasal_tpu_torch.train.optim import sgd_step
from weasal_tpu_torch.utils.device import configure_precision, resolve_device


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
            batch.region_point_masks, batch.region_lb, class_w,
            inverse=batch.inverse("regions", 0))
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


def step_outputs(plan, device, steps: int = 0) -> Dict[str, torch.Tensor]:
    """Zeroed output tensors of `step_body`: "stats" [3] (loss, accuracy,
    offset loss) and "drops" [(2L-1) + (3L-2)]; with `steps` > 0 one row
    of each per step ([steps, 3], [steps, 5L-3])."""
    lead = (steps,) if steps else ()
    n_drops = 5 * plan.num_layers - 3
    return {"stats": torch.zeros(*lead, 3, device=device),
            "drops": torch.zeros(*lead, n_drops, device=device)}


def step_body(model, opt_state: Dict[str, torch.Tensor], inputs: Mapping,
              config, plan, lr: Union[float, torch.Tensor],
              out: Dict[str, torch.Tensor], class_w: Optional[torch.Tensor],
              table: torch.Tensor, spec=None,
              use_contrast: bool = False) -> None:
    """One training step on fixed-shape tensors, with no read back to the
    host: the counterpart of one iteration of the JAX trainer's step scan.

    :param inputs: a level-0 batch or a resident batch (`flat_inds`, the
        `pack_payloads` arrays and the `res_*` tensors) as tensors on the
        model's device (level-0 numpy arrays are moved there first)
    :param lr: a float or a 0-d tensor on the device
    :param out: `step_outputs` tensors (one step's rows), written in
        place: loss, accuracy and offset loss in "stats", the drop vector
        (all zero:
        the port's kernels drop nothing) in "drops"
    :param class_w, table: from `class_weights` and `label_table`
    :param use_contrast: a 'pseudo' step adds the contrast loss; its
        draws and the dropout mask take the seed `inputs["step_seed"]`
        (0-d; 0 when absent)
    """
    device = out["stats"].device
    with torch.no_grad():
        t = level0_on_device(inputs, config, plan, device, spec=spec)
        batch = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t.get("rotations"),
            cloud_lb=t.get("cloud_lb"), region_inds=t.get("region_inds"),
            region_masks=t.get("region_masks"),
            region_point_masks=t.get("region_point_masks"),
            region_lb=t.get("region_lb"))
    loss, acc, reg = step_on_batch(model, opt_state, batch, config, lr,
                                   class_w=class_w, table=table,
                                   seed=inputs.get("step_seed"),
                                   use_contrast=use_contrast,
                                   with_offset_loss=True)
    with torch.no_grad():
        out["stats"][0].copy_(loss)
        out["stats"][1].copy_(acc)
        out["stats"][2].copy_(reg)
        out["drops"].zero_()


def train_step(model, opt_state: Dict[str, torch.Tensor], arrays: Mapping,
               config, plan, lr: float, device=None,
               class_w: Optional[torch.Tensor] = None,
               table: Optional[torch.Tensor] = None, spec=None,
               seed=0, use_contrast: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One training step on a level-0 or a resident batch.

    :param model: a KPFCNN_mprm (weak-label step) or a KPFCNN
        (pseudo-label step) whose parameters lie on `device`
    :param opt_state: its momentum buffers (`init_opt_state`), updated in
        place like the parameters and the BatchNorm running statistics
    :param arrays: assemble_level0 output (numpy arrays or tensors), or a
        resident batch: `pack_payloads` output as tensors on `device`
        merged with the `ResidentClouds` tensors
    :param lr: the learning rate of this step
    :param device: default ``cuda``; raises where CUDA is absent
    :param class_w, table: prepared once by a loop (`class_weights`,
        `label_table`); made per call when left out
    :param spec: the resident feature recipe (data/resident.feature_spec);
        needed with a resident batch
    :param seed, use_contrast: a pseudo-label step's seed (int or tensor)
        of its dropout mask and contrast draw, and whether it adds the
        contrast loss
    :return: (loss, accuracy, drops) as tensors on `device`; drops is the
        [(2L-1) + (3L-2)] dropped-neighbor vector of the JAX step, all
        zero because the port's kernels drop nothing
    """
    device = resolve_device(device)
    configure_precision()
    param = next(model.parameters())
    if param.device != device:
        raise ValueError(f"model parameters are on {param.device}, the "
                         f"step runs on {device}; move the model first")
    if class_w is None:
        class_w = class_weights(config, device)
    if table is None:
        table = label_table(model, device)
    out = step_outputs(plan, device)
    inputs = dict(arrays, step_seed=seed_tensor(seed, device))
    step_body(model, opt_state, inputs, config, plan, lr, out, class_w,
              table, spec=spec, use_contrast=use_contrast)
    return out["stats"][0], out["stats"][1], out["drops"]
