"""Weak-label training step: one batch in, one SGD update out.

Counterpart of the weak-mode branch of `step_core`
(weasal_tpu/train/trainer.py:257-365) on the fused path: a resident batch
(`flat_inds`, data/resident.py) is first assembled into level-0 arrays on
the device, as :259-267 do; a level-0 batch goes on as it is. The pyramid
is built on the device, `KPFCNN_mprm` runs in training mode (BatchNorm on
batch statistics, running statistics updated), the loss is
`region_mprm_loss` (or `class_logits_loss`, by `config.loss_type`), the
backward runs kernels C and D, and `sgd_step` applies the update.

`step_body` is the step on fixed-shape inputs with its results written
into preallocated tensors: what the trainer runs eagerly or captures in a
CUDA graph (train/graphs.py). `train_step` calls it eagerly.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from weasal_tpu_torch.infer import level0_on_device
from weasal_tpu_torch.models import losses
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


def step_on_batch(model, opt_state: Dict[str, torch.Tensor], batch, config,
                  lr: float, class_w: Optional[torch.Tensor] = None,
                  table: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One update of `model` on a PyramidBatch; returns (loss, accuracy) as
    0-d tensors. The parameters' `.grad` keep this step's gradients.
    `class_w` and `table` (from `class_weights` and `label_table`) are
    made here when the caller does not pass them."""
    model.train()
    model.zero_grad(set_to_none=True)
    logits, cla_logits, cam = model(batch)
    if class_w is None:
        class_w = class_weights(config, logits.device)
    if table is None:
        table = label_table(model, logits.device)
    loss_type = config.loss_type
    if loss_type == "region_mprm_loss":
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
    loss.backward()
    sgd_step(model, opt_state, config, lr)
    return loss.detach(), acc


def step_outputs(plan, device, steps: int = 0) -> Dict[str, torch.Tensor]:
    """Zeroed output tensors of `step_body`: "stats" [2] (loss, accuracy)
    and "drops" [(2L-1) + (3L-2)]; with `steps` > 0 one row of each per
    step ([steps, 2], [steps, 5L-3])."""
    lead = (steps,) if steps else ()
    n_drops = 5 * plan.num_layers - 3
    return {"stats": torch.zeros(*lead, 2, device=device),
            "drops": torch.zeros(*lead, n_drops, device=device)}


def step_body(model, opt_state: Dict[str, torch.Tensor], inputs: Mapping,
              config, plan, lr: Union[float, torch.Tensor],
              out: Dict[str, torch.Tensor], class_w: Optional[torch.Tensor],
              table: torch.Tensor, spec=None) -> None:
    """One training step on fixed-shape tensors, with no read back to the
    host: the counterpart of one iteration of the JAX trainer's step scan.

    :param inputs: a level-0 batch or a resident batch (`flat_inds`, the
        `pack_payloads` arrays and the `res_*` tensors) as tensors on the
        model's device (level-0 numpy arrays are moved there first)
    :param lr: a float or a 0-d tensor on the device
    :param out: `step_outputs` tensors (one step's rows), written in
        place: loss and accuracy in "stats", the drop vector (all zero:
        the port's kernels drop nothing) in "drops"
    :param class_w, table: from `class_weights` and `label_table`
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
    loss, acc = step_on_batch(model, opt_state, batch, config, lr,
                              class_w=class_w, table=table)
    with torch.no_grad():
        out["stats"][0].copy_(loss)
        out["stats"][1].copy_(acc)
        out["drops"].zero_()


def train_step(model, opt_state: Dict[str, torch.Tensor], arrays: Mapping,
               config, plan, lr: float, device=None,
               class_w: Optional[torch.Tensor] = None,
               table: Optional[torch.Tensor] = None, spec=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One weak-label training step on a level-0 or a resident batch.

    :param model: a KPFCNN_mprm whose parameters lie on `device`
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
    step_body(model, opt_state, arrays, config, plan, lr, out, class_w,
              table, spec=spec)
    return out["stats"][0], out["stats"][1], out["drops"]
