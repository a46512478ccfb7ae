"""Inference of both stages: a resident batch in, class probabilities
out.

Counterpart of the eval step of weasal_tpu/train/tester.py:93-131: the
pyramid is built on the device, the model runs in eval mode (no
dropout), and a softmax turns its logits (`KPFCNN_mprm`'s fused ones,
`KPFCNN`'s only output, tester.py:125) into probabilities, gathered back
to `input_inds` order with the labels and the squared norms `d2` of the
augmented level-0 points, which the tester's vote mask reads
(weasal_tpu/train/tester.py:103-131, 253-273).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from portbench.reference.ops.pyramid import batch_from_device_pyramid


def input_batch(inputs, config, plan, device, spec):
    """(PyramidBatch on `device`, unsort) of a resident batch
    (`flat_inds`): its level 0 assembled on the device with augmentation
    (data/resident.py; `unsort` takes a sorted per-point output back to
    `input_inds` order), then the device pyramid."""
    from portbench.reference.data.resident import assemble_level0_device
    t = assemble_level0_device(inputs, config, plan, augment=True, spec=spec)
    batch = batch_from_device_pyramid(
        t["points0"], t["mask0"], t["features"], t["labels"], config,
        plan, t["center_pts"], rotations=t.get("rotations"),
        cloud_lb=t.get("cloud_lb"), region_inds=t.get("region_inds"),
        region_masks=t.get("region_masks"),
        region_point_masks=t.get("region_point_masks"),
        region_lb=t.get("region_lb"))
    return batch, t.get("unsort")


def _probs(model, batch) -> torch.Tensor:
    out = model(batch)
    logits = out[0] if isinstance(out, tuple) else out
    return torch.softmax(logits, dim=-1)


@torch.no_grad()
def eval_body(model, inputs: Mapping, config, plan, device,
              spec) -> Dict[str, torch.Tensor]:
    """{"probs": [B, N_0, C], "labels": [B, N_0], "d2": [B, N_0]} of one
    vote batch on `device`, in `input_inds` order; `d2` holds the squared
    norms of the augmented level-0 points, (x*x + y*y) + z*z, which the
    tester's vote mask compares with its radius."""
    model.eval()
    batch, unsort = input_batch(inputs, config, plan, device, spec=spec)
    probs = _probs(model, batch)
    pts = batch.points[0]
    d2 = pts[..., 0] * pts[..., 0] + pts[..., 1] * pts[..., 1] \
        + pts[..., 2] * pts[..., 2]
    probs = torch.gather(
        probs, 1, unsort[..., None].expand(-1, -1, probs.shape[-1]))
    return {"probs": probs, "labels": torch.gather(batch.labels, 1, unsort),
            "d2": torch.gather(d2, 1, unsort)}
