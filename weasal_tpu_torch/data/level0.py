"""Level-0 batch assembly for the device pyramid (numpy, host side).

Counterpart of weasal_tpu/data/level0.py `assemble_level0` (:23) and
`_sort_payload` (:87) and `Level0BatchSource` (:119): the non-resident
input that the steps take when a batch has no `flat_inds`. The host pads
sphere payloads to the plan's level-0 budget and draws per-sphere grid
rotations; the device builds the rest of the pyramid (ops/pyramid.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from weasal_tpu_torch.data.batching import (
    ShapePlan, fill_region_row, grid_rotations, payload_meta)
from weasal_tpu_torch.ops.subsample import SHADOW_COORD


def assemble_level0(payloads: Sequence[Dict], plan: ShapePlan,
                    num_classes: int,
                    rng: Optional[np.random.Generator] = None,
                    spatial_sort: bool = True) -> Dict:
    """Pad payloads to level-0 arrays: points0 [B,N0,3], mask0 [B,N0],
    features [B,N0,F], labels [B,N0] (-1 pad), rotations [B,3,3],
    center_pts [B,3], cloud_lb [B,C] and the region tables.

    With `spatial_sort` each sphere's kept points are reordered by voxel
    id in the grid-rotated frame (payload dicts are updated in place, as
    in the JAX package; all consumers are order-invariant)."""
    rng = rng or np.random.default_rng()
    B = len(payloads)
    n0 = plan.num_points[0]
    F = payloads[0]["features"].shape[1]
    R, P = max(plan.max_regions, 1), max(plan.max_region_points, 1)

    points0 = np.full((B, n0, 3), SHADOW_COORD, np.float32)
    mask0 = np.zeros((B, n0), bool)
    features = np.zeros((B, n0, F), np.float32)
    labels = np.full((B, n0), -1, np.int32)
    centers = np.zeros((B, 3), np.float32)
    cloud_lb = np.zeros((B, num_classes), np.float32)
    region_inds = np.full((B, R, P), n0, np.int32)
    region_masks = np.zeros((B, R), bool)
    region_point_masks = np.zeros((B, R, P), bool)
    region_lb = np.zeros((B, R, num_classes), np.float32)

    rotations = grid_rotations(rng, B)

    for b, p in enumerate(payloads):
        k = min(p["points"].shape[0], n0)
        if spatial_sort and k:
            _sort_payload(p, rotations[b], k)
        points0[b, :k] = p["points"][:k]
        mask0[b, :k] = True
        features[b, :k] = p["features"][:k]
        if p.get("labels") is not None:
            labels[b, :k] = p["labels"][:k]
        centers[b] = p.get("center", np.zeros(3))
        if p.get("cloud_lb") is not None:
            cloud_lb[b] = p["cloud_lb"]
        fill_region_row(region_inds[b], region_point_masks[b],
                        region_masks[b], region_lb[b],
                        p.get("regions"), k, rng)

    return dict(points0=points0, mask0=mask0, features=features,
                labels=labels, rotations=rotations, center_pts=centers,
                cloud_lb=cloud_lb, region_inds=region_inds,
                region_masks=region_masks,
                region_point_masks=region_point_masks, region_lb=region_lb)


def _sort_payload(p: Dict, rotation: np.ndarray, k: int) -> None:
    """Reorder the first `k` payload rows by grid-rotated voxel order
    (voxel size extent/256, effectively a lexicographic spatial sort)."""
    pts = p["points"][:k] @ rotation
    lo = pts.min(axis=0)
    extent = float(max(pts.max() - lo.min(), 1e-6))
    vox = np.floor((pts - lo) / (extent / 256.0)).astype(np.int64)
    dims = vox.max(axis=0) + 1
    lin = (vox[:, 0] * dims[1] + vox[:, 1]) * dims[2] + vox[:, 2]
    perm = np.argsort(lin, kind="stable")
    if np.array_equal(perm, np.arange(k)):
        return
    inv = np.empty(k, np.int64)
    inv[perm] = np.arange(k)

    for key in ("points", "features", "labels", "input_inds"):
        if p.get(key) is not None:
            arr = np.asarray(p[key])
            p[key] = np.concatenate([arr[:k][perm], arr[k:]], axis=0)
    if p.get("regions"):
        remapped = []
        for inds, lb in p["regions"]:
            inds = np.asarray(inds, dtype=np.int64)
            remapped.append((inv[inds[inds < k]], lb))
        p["regions"] = remapped


class Level0BatchSource:
    """`next_batch()` -> (level-0 arrays, metas) from a dataset's sphere
    sampler: the training loop's input when the clouds are not resident
    on the device."""

    def __init__(self, dataset, plan: ShapePlan):
        self.dataset = dataset
        self.plan = plan

    def next_batch(self, rng, augment: Optional[bool] = None):
        ds, plan = self.dataset, self.plan
        if augment is None:
            augment = ds.split == "training"
        payloads = [ds.sample_sphere(rng, augment=augment,
                                     max_points=plan.num_points[0])
                    for _ in range(ds.config.batch_num)]
        arrays = assemble_level0(payloads, plan, ds.config.num_classes, rng)
        metas = [payload_meta(p, plan.num_points[0]) for p in payloads]
        return arrays, metas
