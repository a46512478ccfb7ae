"""Device-resident clouds: the host ships sphere indices, not points.

Counterpart of weasal_tpu/data/resident.py: `feature_spec` (:49),
`ResidentClouds` (:64), `pack_payloads` (:185) and
`assemble_level0_device` (:282).

- `ResidentClouds` uploads one split's subsampled clouds once, as flat
  `[S, ...]` tensors on the device with a trailing shadow row.
- `pack_payloads` packs sampled spheres as `flat_inds` [B, N0] and each
  sphere's augmentation parameters.
- `assemble_level0_device` gathers the spheres from the resident tensors,
  applies the augmentation, builds the features and voxel-sorts each
  sphere in its grid-rotated frame, all on the device: the level-0 arrays
  `assemble_level0` would have made, plus `unsort`, which takes a sorted
  per-point output back to `input_inds` order.

The jitter is `jax.random.normal` keyed by each sphere's `noise_seed`, as
in the JAX package, drawn on the device by utils/prng from the shipped
seed tensor: the same bits as JAX's, normals within a few ulp, and no
read of the seeds on the host, so the assembly can be captured in a CUDA
graph.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.data.batching import (
    ShapePlan, fill_region_row, grid_rotations)
from portbench.reference.ops.pyramid import _rotate
from portbench.reference.ops.subsample import SHADOW_COORD
from portbench.reference.utils import prng

_KEY_SENTINEL = 2 ** 31 - 1    # sort key of pad rows


def feature_spec(dataset_name: str, in_features_dim: int) -> Tuple[str, ...]:
    """The feature columns of the datasets' `_sphere_features`, by name."""
    name = (dataset_name or "").lower()
    if name.startswith("vaihingen"):
        return {1: ("ones",),
                2: ("ones", "color0"),
                4: ("ones", "color0", "abs_z", "red_z")}[in_features_dim]
    if name.startswith("dales"):
        return {1: ("ones",),
                3: ("ones", "abs_z", "red_z")}[in_features_dim]
    raise ValueError(f"no feature spec for dataset {dataset_name!r}")


class ResidentClouds:
    """One split's clouds as flat tensors on `device`, with the host-side
    base row of each cloud. Each cloud is padded to the largest; the
    colors (`res_colors`) are held only where a cloud has them."""

    def __init__(self, dataset, device):
        clouds = [dataset._cloud_points_f32(i)
                  for i in range(len(dataset.input_trees))]
        nmax = max(c.shape[0] for c in clouds)
        n_clouds = len(clouds)
        S = n_clouds * nmax + 1                 # +1 trailing shadow row
        if S >= 2 ** 31:
            raise ValueError(
                f"resident flat cloud too large for int32 indexing: "
                f"{n_clouds} clouds x {nmax} max points = {S} rows")
        pts = np.zeros((S, 3), np.float32)
        labels = np.full(S, -1, np.int32)
        # a dataset's clouds all have colors, or none has (DALES)
        first = dataset.input_colors[0]
        colors = (np.zeros((S, first.shape[1]), np.float32)
                  if first is not None else None)

        self.base = np.arange(n_clouds, dtype=np.int64) * nmax
        self.sizes = [c.shape[0] for c in clouds]
        self.shadow = S - 1
        table = dataset._label_table()
        for i, c in enumerate(clouds):
            b = int(self.base[i])
            pts[b:b + c.shape[0]] = c
            labels[b:b + c.shape[0]] = table[
                np.asarray(dataset.input_labels[i], np.int64)]
            if colors is not None:
                colors[b:b + c.shape[0]] = dataset.input_colors[i]

        self.arrays: Dict[str, torch.Tensor] = {
            "res_points": torch.from_numpy(pts).to(device),
            "res_labels": torch.from_numpy(labels).to(device)}
        if colors is not None:
            self.arrays["res_colors"] = torch.from_numpy(colors).to(device)


def pack_payloads(payloads, plan: ShapePlan, config, rng,
                  base: np.ndarray, shadow: int) -> Dict:
    """Pack gather-less sphere payloads into the per-step arrays of the
    device assembly: `flat_inds`, the augmentation parameters and the
    region tables (numpy). `base[cloud_ind] + input_inds` addresses rows
    of the resident tensors; `shadow` pads. The random draws are those of
    `assemble_level0` (grid rotations, then region subsampling), then one
    `noise_seed` per sphere."""
    B = len(payloads)
    n0 = plan.num_points[0]
    R, P = max(plan.max_regions, 1), max(plan.max_region_points, 1)
    C = config.num_classes

    flat_inds = np.full((B, n0), shadow, np.int32)
    centers = np.zeros((B, 3), np.float32)
    cloud_lb = np.zeros((B, C), np.float32)
    aug_rot = np.zeros((B, 3, 3), np.float32)
    aug_scale = np.ones((B, 3), np.float32)
    color_keep = np.ones(B, np.float32)
    region_inds = np.full((B, R, P), n0, np.int32)
    region_masks = np.zeros((B, R), bool)
    region_point_masks = np.zeros((B, R, P), bool)
    region_lb = np.zeros((B, R, C), np.float32)

    rotations = grid_rotations(rng, B)

    for b, p in enumerate(payloads):
        inds = p["input_inds"]
        k = min(inds.shape[0], n0)
        flat_inds[b, :k] = base[p["cloud_ind"]] + inds[:k]
        centers[b] = p["center"]
        if p.get("cloud_lb") is not None:
            cloud_lb[b] = p["cloud_lb"]
        aug_rot[b] = p["rot"]
        aug_scale[b] = p["scale"]
        color_keep[b] = p.get("color_keep", 1.0)
        fill_region_row(region_inds[b], region_point_masks[b],
                        region_masks[b], region_lb[b],
                        p.get("regions"), k, rng)

    noise_seed = rng.integers(0, 2 ** 31, size=B).astype(np.uint32)

    return dict(flat_inds=flat_inds, center_pts=centers,
                cloud_lb=cloud_lb, rotations=rotations,
                aug_rot=aug_rot, aug_scale=aug_scale,
                color_keep=color_keep, noise_seed=noise_seed,
                region_inds=region_inds, region_masks=region_masks,
                region_point_masks=region_point_masks,
                region_lb=region_lb)


def sphere_noise(noise_seed: torch.Tensor, n0: int) -> torch.Tensor:
    """[B, n0, 3] standard-normal jitter on `noise_seed`'s device, sphere b
    `jax.random.normal(PRNGKey(noise_seed[b]), (n0, 3))` (utils/prng)."""
    return prng.normal(noise_seed, (n0, 3))


def assemble_level0_device(batch: Dict, config, plan: ShapePlan,
                           augment: bool, spec: Sequence[str]) -> Dict:
    """Resident tensors + shipped indices -> the level-0 dict, on the
    tensors' device.

    :param batch: `res_*` tensors and the `pack_payloads` arrays as tensors
        on the same device (`noise_seed` included)
    :return: the keys `batch_from_device_pyramid` takes, plus `unsort`
        [B, N0] (gather a sorted-order output with it to get `input_inds`
        order)
    """
    res_pts = batch["res_points"]
    inds = batch["flat_inds"].long()
    centers = batch["center_pts"]
    shadow = res_pts.shape[0] - 1
    B, n0 = inds.shape
    dev = res_pts.device

    mask0 = inds < shadow
    pts = res_pts[inds] - centers[:, None, :]
    if augment:
        pts = _rotate(pts, batch["aug_rot"], transpose=False)
        pts = pts * batch["aug_scale"][:, None, :]
        sigma = float(getattr(config, "augment_noise", 0.0) or 0.0)
        if sigma:
            pts = pts + sphere_noise(batch["noise_seed"], n0) * sigma

    labels = torch.where(mask0, batch["res_labels"][inds],
                         torch.full_like(inds, -1, dtype=torch.int32))

    columns = []
    for tok in spec:
        if tok == "ones":
            columns.append(torch.ones((B, n0, 1), device=dev))
        elif tok == "color0":
            columns.append(batch["res_colors"][inds][..., 0:1]
                           * batch["color_keep"][:, None, None])
        elif tok == "abs_z":
            columns.append(pts[..., 2:3] + centers[:, None, 2:3])
        elif tok == "red_z":
            columns.append(pts[..., 2:3])
        else:
            raise ValueError(f"unknown feature token {tok!r}")
    features = torch.cat(columns, dim=-1) * mask0[..., None]

    points0 = torch.where(mask0[..., None], pts,
                          torch.full_like(pts, SHADOW_COORD))

    # Voxel sort in the grid-rotated frame (as level0._sort_payload)
    rotations = batch["rotations"]
    rpts = _rotate(points0, rotations, transpose=False)
    inf = torch.full_like(rpts, float("inf"))
    lo = torch.where(mask0[..., None], rpts, inf).amin(dim=1)       # [B, 3]
    hi = torch.where(mask0[..., None], rpts, -inf).amax(dim=1)
    extent = torch.clamp(hi.amax(dim=1) - lo.amin(dim=1), min=1e-6)
    safe = torch.where(mask0[..., None], rpts, lo[:, None, :])
    vox = torch.floor((safe - lo[:, None, :])
                      / (extent[:, None, None] / 256.0)).to(torch.int32)
    vox = vox.clamp(0, 256)
    dims = torch.where(mask0[..., None], vox,
                       torch.zeros_like(vox)).amax(dim=1) + 1
    lin = ((vox[..., 0] * dims[:, None, 1] + vox[..., 1])
           * dims[:, None, 2] + vox[..., 2])
    keys = torch.where(mask0, lin, torch.full_like(lin, _KEY_SENTINEL))
    perm = torch.sort(keys, dim=1, stable=True)[1]
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(n0, device=dev).expand(B, n0))

    points0 = torch.gather(points0, 1, perm[..., None].expand(B, n0, 3))
    features = torch.gather(features, 1,
                            perm[..., None].expand(B, n0,
                                                   features.shape[-1]))
    labels = torch.gather(labels, 1, perm)
    mask0 = torch.gather(mask0, 1, perm)

    ri = batch["region_inds"].long()
    ri_sorted = torch.where(
        ri < n0,
        torch.gather(inv, 1, ri.clamp(0, n0 - 1).reshape(B, -1)
                     ).reshape(ri.shape),
        torch.full_like(ri, n0)).to(torch.int32)

    return dict(points0=points0, mask0=mask0, features=features,
                labels=labels, rotations=rotations, center_pts=centers,
                cloud_lb=batch["cloud_lb"], region_inds=ri_sorted,
                region_masks=batch["region_masks"],
                region_point_masks=batch["region_point_masks"],
                region_lb=batch["region_lb"], unsort=inv)
