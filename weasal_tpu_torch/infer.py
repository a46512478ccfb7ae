"""Inference of both stages: level-0 or resident batches in, class
probabilities out.

Counterpart of the eval step of weasal_tpu/train/tester.py:93-131 and
weasal_tpu/train/trainer.py:406-447 on the fused path: the pyramid is
built on the device, the model runs in eval mode (no dropout), and a
softmax turns its logits (`KPFCNN_mprm`'s fused ones, `KPFCNN`'s only
output, tester.py:125) into probabilities. `eval_step` takes level-0 arrays;
`eval_batch`, the training loop's validation step, also takes a resident
batch and returns probabilities and labels in `input_inds` order; its
body, `eval_body`, writes them (and the squared norms `d2` of the
augmented level-0 points, which the tester's vote mask reads,
weasal_tpu/train/tester.py:103-131) into preallocated tensors, which is
what the trainer and the tester run eagerly or capture in a CUDA graph
(train/graphs.py).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

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


def level0_on_device(arrays: Mapping, config, plan, device,
                     spec=None) -> dict:
    """Level-0 tensors on `device`: a resident batch (`flat_inds`) is
    assembled there with augmentation (data/resident.py; its `unsort`
    comes along), a level-0 batch is moved there."""
    if "flat_inds" not in arrays:
        return to_device(arrays, device)
    from weasal_tpu_torch.data.resident import assemble_level0_device
    if spec is None:
        raise ValueError("a resident batch needs its feature spec")
    return assemble_level0_device(arrays, config, plan, augment=True,
                                  spec=spec)


def _check_model(model, device):
    param = next(model.parameters())
    if param.device != device:
        raise ValueError(f"model parameters are on {param.device}, the "
                         f"step runs on {device}; move the model first")


def _probs(model, t: dict, config, plan) -> torch.Tensor:
    batch = batch_from_device_pyramid(
        t["points0"], t["mask0"], t["features"], t["labels"], config,
        plan, t["center_pts"], rotations=t.get("rotations"),
        cloud_lb=t.get("cloud_lb"), region_inds=t.get("region_inds"),
        region_masks=t.get("region_masks"),
        region_point_masks=t.get("region_point_masks"),
        region_lb=t.get("region_lb"))
    out = model(batch)
    logits = out[0] if isinstance(out, tuple) else out
    return torch.softmax(logits, dim=-1)


def eval_step(model, arrays: Mapping, config, plan, device=None
              ) -> torch.Tensor:
    """Probabilities [B, N_0, C] for one level-0 batch.

    :param model: a KPFCNN_mprm or a KPFCNN whose parameters lie on
        `device`
    :param arrays: assemble_level0 output (numpy arrays or tensors)
    :param device: default ``cuda``; raises where CUDA is absent
    """
    device = resolve_device(device)
    configure_precision()
    _check_model(model, device)
    t = to_device(arrays, device)
    model.eval()
    with torch.no_grad():
        return _probs(model, t, config, plan)


@torch.no_grad()
def eval_body(model, inputs: Mapping, config, plan, device, spec=None,
              out: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """{"probs": [B, N_0, C], "labels": [B, N_0], "d2": [B, N_0]} of one
    validation or vote batch on `device`, with no read back to the host;
    written into `out` when given (tensors of those shapes), else into
    new tensors. `d2` holds the squared norms of the augmented level-0
    points, (x*x + y*y) + z*z, which the tester's vote mask compares
    with its radius (validation ignores it). A resident batch is
    assembled with augmentation (the validation and vote spheres are
    augmented, as in training) and its outputs are gathered back to
    `input_inds` order; a level-0 batch's outputs stay in its rows'
    order, which its metas' `input_inds` follow."""
    model.eval()
    t = level0_on_device(inputs, config, plan, device, spec=spec)
    probs = _probs(model, t, config, plan)
    labels = t["labels"]
    pts = t["points0"]
    d2 = pts[..., 0] * pts[..., 0] + pts[..., 1] * pts[..., 1] \
        + pts[..., 2] * pts[..., 2]
    unsort = t.get("unsort")
    if unsort is not None:
        probs = torch.gather(
            probs, 1, unsort[..., None].expand(-1, -1, probs.shape[-1]))
        labels = torch.gather(labels, 1, unsort)
        d2 = torch.gather(d2, 1, unsort)
    if out is None:
        return {"probs": probs, "labels": labels, "d2": d2}
    out["probs"].copy_(probs)
    out["labels"].copy_(labels)
    out["d2"].copy_(d2)
    return out


def eval_batch(model, arrays: Mapping, config, plan, device=None, spec=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs [B, N_0, C], labels [B, N_0]) of one validation batch, both
    on `device` (`eval_body`, eagerly)."""
    device = resolve_device(device)
    configure_precision()
    _check_model(model, device)
    out = eval_body(model, arrays, config, plan, device, spec=spec)
    return out["probs"], out["labels"]
