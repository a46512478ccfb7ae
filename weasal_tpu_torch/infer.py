"""Weak-label inference step: level-0 arrays in, class probabilities out.

Counterpart of the eval step of weasal_tpu/train/tester.py:93-131 and
weasal_tpu/train/trainer.py:406-447 for a level-0 batch without
`flat_inds` (the non-resident input of data/level0.assemble_level0): the
pyramid is built on the device, `KPFCNN_mprm` runs in eval mode, and a
softmax turns its fused logits into probabilities.
"""

from __future__ import annotations

from typing import Mapping

import torch

from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
from weasal_tpu_torch.utils.device import configure_precision, resolve_device

_KEYS = ("points0", "mask0", "features", "labels", "center_pts",
         "rotations", "cloud_lb", "region_inds", "region_masks",
         "region_point_masks", "region_lb")


def to_device(arrays: Mapping, device) -> dict:
    """The level-0 arrays (numpy or tensors) as tensors on `device`."""
    return {k: torch.as_tensor(arrays[k]).to(device) for k in _KEYS
            if arrays.get(k) is not None}


def eval_step(model, arrays: Mapping, config, plan, device=None
              ) -> torch.Tensor:
    """Probabilities [B, N_0, C] for one level-0 batch.

    :param model: a KPFCNN_mprm whose parameters lie on `device`
    :param arrays: assemble_level0 output (numpy arrays or tensors)
    :param device: default ``cuda``; raises where CUDA is absent
    """
    device = resolve_device(device)
    configure_precision()
    param = next(model.parameters())
    if param.device != device:
        raise ValueError(f"model parameters are on {param.device}, the "
                         f"step runs on {device}; move the model first")
    t = to_device(arrays, device)
    model.eval()
    with torch.no_grad():
        batch = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t.get("rotations"),
            cloud_lb=t.get("cloud_lb"), region_inds=t.get("region_inds"),
            region_masks=t.get("region_masks"),
            region_point_masks=t.get("region_point_masks"),
            region_lb=t.get("region_lb"))
        logits, _cla_logits, _cam = model(batch)
        return torch.softmax(logits, dim=-1)
