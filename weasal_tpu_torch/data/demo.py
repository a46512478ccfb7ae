"""Synthetic aerial-like sphere payloads, made in memory from a numpy seed.

Counterpart of weasal_tpu/data/demo.py `demo_sphere` (:18) and
`thin_payload` (:62): geometry statistics near Vaihingen3D at the
configured radius and voxel size, with no dataset on disk.
"""

from __future__ import annotations

import numpy as np

from weasal_tpu_torch.ops.subsample import grid_subsample


def demo_sphere(rng: np.random.Generator, config,
                density: float = 20.0) -> dict:
    """One synthetic sphere payload (centered coordinates)."""
    r = config.in_radius
    n = int(np.pi * r * r * density)
    xy = rng.uniform(-r, r, size=(n, 2))
    xy = xy[np.linalg.norm(xy, axis=1) < r]
    n = xy.shape[0]
    z = (0.5 * np.sin(xy[:, 0] / 5) + rng.normal(0, 0.2, n)
         + (rng.random(n) < 0.25) * rng.uniform(2, 12, n))
    pts = np.column_stack([xy, z]).astype(np.float32)
    # The real pipeline feeds grid-subsampled clouds
    pts = grid_subsample(pts, dl=config.first_subsampling_dl)
    n = pts.shape[0]
    xy = pts[:, :2]
    labels = rng.integers(0, config.num_classes, n).astype(np.int32)

    center_z = 10.0
    cols = [np.ones((n, 1), np.float32)]
    if config.in_features_dim == 4:
        cols += [rng.random((n, 1)).astype(np.float32)]
    if config.in_features_dim >= 3:
        cols += [pts[:, 2:] + center_z, pts[:, 2:]]
    feats = np.hstack(cols).astype(np.float32)[:, :config.in_features_dim]

    regions = []
    for _ in range(6):
        c = rng.uniform(-r * 0.6, r * 0.6, size=2)
        member = np.where(np.linalg.norm(xy - c, axis=1) < r * 0.2)[0]
        if member.size:
            lb = np.zeros(config.num_classes, np.float32)
            lb[np.unique(labels[member])] = 1
            regions.append((member, lb))
    cloud_lb = np.zeros(config.num_classes, np.float32)
    cloud_lb[np.unique(labels)] = 1
    return dict(points=pts, features=feats, labels=labels,
                center=np.array([0, 0, center_z], np.float32),
                cloud_lb=cloud_lb, regions=regions)


def thin_payload(p: dict, n0: int, rng) -> dict:
    """Crop a payload to the level-0 budget, remapping region members into
    the compacted point array. Returns a new dict; no-op when it fits."""
    if p["points"].shape[0] <= n0:
        return p
    keep = np.sort(rng.choice(p["points"].shape[0], n0, replace=False))
    remap = -np.ones(p["points"].shape[0], np.int64)
    remap[keep] = np.arange(n0)
    regions = []
    for inds, lb in p.get("regions") or []:
        new = remap[np.asarray(inds, np.int64)]
        new = new[new >= 0]
        if new.size:
            regions.append((new, lb))
    return dict(p, points=p["points"][keep], features=p["features"][keep],
                labels=p["labels"][keep], regions=regions)
