"""Shape plan and the host-side sphere pyramid: calibration and the
host-pyramid input path.

Counterpart of weasal_tpu/data/batching.py: `ShapePlan` (:36),
`payload_meta` (:95), `fill_region_row` (:110), `grid_rotations` (:138),
`layer_radii` (:160), `build_sphere_pyramid` (:183, its grid orientations
in `pyramid_grid_rotations`),
`calibrate_shape_plan` (:236), `assemble_classification_batch` (:318),
`_pad_points` (:369), `_pad_neighbors` (:378) and `assemble_batch`
(:399), running on the port's own host subsample and radius search (the
native library where it is built, ops/native.py). Random draws follow
the JAX package's order, so one numpy seed gives both packages the same
plan, small-sphere bucket included, and the same host batches. The
measured band windows are not ported (the port's kernels are exact): a
plan written by the JAX package loads without them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from weasal_tpu_torch.data.batch import PyramidBatch
from weasal_tpu_torch.kernels.kernel_points import create_3d_rotations
from weasal_tpu_torch.ops.neighbors import radius_search
from weasal_tpu_torch.ops.subsample import SHADOW_COORD, grid_subsample


@dataclasses.dataclass
class ShapePlan:
    """Static shape budgets for one config's pyramid."""
    num_points: List[int]          # N_l per level
    conv_neighbors: List[int]      # K_l per level
    pool_neighbors: List[int]      # width of pools[l] (levels 0..L-2)
    up_neighbors: int = 1          # only column 0 is read (closest_pool)
    max_regions: int = 0           # R (weak-label sub-regions per sphere)
    max_region_points: int = 0     # P (points per sub-region)
    # Optional small-sphere bucket ({"num_points": [N_l], "cut": int},
    # config.plan_bucket_percentile > 0): training batches whose every
    # sphere has <= `cut` level-0 points run at these budgets, nothing
    # cropped
    small: Optional[Dict] = None

    @property
    def num_layers(self) -> int:
        return len(self.num_points)

    def derive_small(self) -> Optional["ShapePlan"]:
        """The small bucket's plan: its per-level point budgets, every
        other field inherited; None without a bucket."""
        if not self.small:
            return None
        return ShapePlan(num_points=list(self.small["num_points"]),
                         conv_neighbors=self.conv_neighbors,
                         pool_neighbors=self.pool_neighbors,
                         up_neighbors=self.up_neighbors,
                         max_regions=self.max_regions,
                         max_region_points=self.max_region_points)

    @classmethod
    def from_dict(cls, d: Dict) -> "ShapePlan":
        """A plan from its JSON fields; the JAX package's `bands`, which
        the port has no use for, are dropped."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path: str) -> "ShapePlan":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def payload_meta(payload: Dict, n0: int) -> Dict:
    """Host-side metadata of one sphere that every batch source attaches:
    `has_regions` lets the weak-label loop skip a batch without labels
    from host data, `n_real` and `input_inds` drive the vote scatter."""
    return dict(cloud_ind=payload["cloud_ind"],
                input_inds=payload["input_inds"],
                center=payload["center"],
                has_regions=bool(payload.get("regions")),
                n_real=min(payload["input_inds"].shape[0], n0))


def fill_region_row(region_inds_b: np.ndarray,
                    region_point_masks_b: np.ndarray,
                    region_masks_b: np.ndarray,
                    region_lb_b: np.ndarray,
                    regions, limit: int,
                    rng: np.random.Generator) -> None:
    """Fill one sphere's rows of the padded region tables: drop members
    past the kept-point `limit`, random-subsample crowded regions to P."""
    R, P = region_inds_b.shape
    for ri, (inds, lb) in enumerate((regions or [])[:R]):
        inds = np.asarray(inds, dtype=np.int64)
        inds = inds[inds < limit]
        if inds.size == 0:
            continue
        if inds.size > P:
            inds = rng.choice(inds, size=P, replace=False)
        region_inds_b[ri, :inds.size] = inds
        region_point_masks_b[ri, :inds.size] = True
        region_masks_b[ri] = True
        region_lb_b[ri] = lb


def grid_rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """[n, 3, 3] random vertical-axis rotations for voxel de-aliasing."""
    theta = rng.random(n) * 2 * np.pi
    c, s = np.cos(theta), np.sin(theta)
    rotations = np.zeros((n, 3, 3), np.float32)
    rotations[:, 0, 0] = c
    rotations[:, 0, 1] = -s
    rotations[:, 1, 0] = s
    rotations[:, 1, 1] = c
    rotations[:, 2, 2] = 1.0
    return rotations


def _round_up(x, m: int) -> int:
    return ((int(x) + m - 1) // m) * m


def layer_radii(config) -> Tuple[List[float], List[float], List[float]]:
    """Per-level (conv, pool, upsample) radii in meters: r_l = dl_l *
    conv_radius with dl_l = first_subsampling_dl * 2^l; deform layers
    widen by deform_radius / conv_radius."""
    conv_r, pool_r, up_r = [], [], []
    r_normal = config.first_subsampling_dl * config.conv_radius
    deform_layers = getattr(config, "deform_layers", None) or \
        [False] * config.num_layers
    for l in range(config.num_layers):
        if deform_layers[l]:
            r = r_normal * config.deform_radius / config.conv_radius
        else:
            r = r_normal
        conv_r.append(r)
        pool_r.append(r)
        up_r.append(2 * r_normal)
        r_normal *= 2
    return conv_r, pool_r, up_r


def search_edges(config, plan: ShapePlan
                 ) -> List[Tuple[str, int, int, float, int]]:
    """(name, query level, support level, radius, K) of the 3L - 2 radius
    searches of one pyramid: conv_l within level l, pool_l from level
    l + 1 into level l, up_l from level l into level l + 1."""
    conv_r, pool_r, up_r = layer_radii(config)
    edges = []
    for l in range(plan.num_layers):
        edges.append((f"conv{l}", l, l, conv_r[l], plan.conv_neighbors[l]))
        if l < plan.num_layers - 1:
            edges.append((f"pool{l}", l + 1, l, pool_r[l],
                          plan.pool_neighbors[l]))
            edges.append((f"up{l}", l, l + 1, up_r[l], plan.up_neighbors))
    return edges


def pyramid_grid_rotations(rng: np.random.Generator, config
                           ) -> List[np.ndarray]:
    """The random grid orientation of each level past the first, three
    uniforms a level from `rng`: every draw `build_sphere_pyramid` makes.
    A data-parallel rank that skips another rank's sphere calls this alone
    to keep the shared `rng` in step."""
    rotations = []
    for _ in range(config.num_layers - 1):
        theta = rng.random() * 2 * np.pi
        phi = (rng.random() - 0.5) * np.pi
        u = np.array([[np.cos(theta) * np.cos(phi),
                       np.sin(theta) * np.cos(phi),
                       np.sin(phi)]])
        alpha = np.array([rng.random() * 2 * np.pi])
        rotations.append(create_3d_rotations(u, alpha)[0].astype(np.float32))
    return rotations


def build_sphere_pyramid(points: np.ndarray, config,
                         rng: Optional[np.random.Generator] = None,
                         max_neighbors: Optional[Sequence[int]] = None,
                         max_pool_neighbors: Optional[Sequence[int]] = None,
                         random_grid_orient: bool = True,
                         with_upsamples: bool = True) -> Dict:
    """Host pyramid of one sphere: per-level points ('points') and index
    lists ('neighbors' into level l, 'pools' from l+1 into l, 'upsamples'
    from l into l+1). Widths follow the data unless capped."""
    rng = rng or np.random.default_rng()
    conv_r, pool_r, up_r = layer_radii(config)
    L = config.num_layers
    rotations = (pyramid_grid_rotations(rng, config) if random_grid_orient
                 else None)

    level_points = [np.asarray(points, dtype=np.float32)]
    for l in range(L - 1):
        dl = config.first_subsampling_dl * (2 ** (l + 1))
        pts = level_points[l]
        if rotations is not None:
            R = rotations[l]
            sub = grid_subsample(pts @ R.T, dl=dl) @ R
        else:
            sub = grid_subsample(pts, dl=dl)
        level_points.append(sub.astype(np.float32))

    neighbors, pools, upsamples = [], [], []
    for l in range(L):
        cap = max_neighbors[l] if max_neighbors is not None else 0
        neighbors.append(radius_search(level_points[l], level_points[l],
                                       conv_r[l], max_count=cap))
        if l < L - 1:
            pool_cap = (max_pool_neighbors[l]
                        if max_pool_neighbors is not None else cap)
            pools.append(radius_search(level_points[l + 1], level_points[l],
                                       pool_r[l], max_count=pool_cap))
            if with_upsamples:
                upsamples.append(radius_search(
                    level_points[l], level_points[l + 1], up_r[l],
                    max_count=1))
    return {"points": level_points, "neighbors": neighbors,
            "pools": pools, "upsamples": upsamples}


def calibrate_shape_plan(sphere_point_clouds: Sequence[np.ndarray], config,
                         untouched_ratio: float = 0.9,
                         point_percentile: float = 100.0,
                         region_budget: Tuple[int, int] = (0, 0),
                         rng: Optional[np.random.Generator] = None,
                         bucket_percentile: float = 0.0) -> ShapePlan:
    """Static budgets from sampled spheres: N_l at `point_percentile` of
    the level-0 counts (p100 above level 0), padded ~10% and rounded up to
    a multiple of 8; K_l keeps `untouched_ratio` of neighborhoods whole.
    `bucket_percentile` in (0, 100) adds the small-sphere bucket: the
    level-0 `cut` at that percentile and p100 budgets of the spheres at or
    below it, per level from their own counts; none when every sphere or
    none falls in it, or when it would not be smaller at level 0."""
    rng = rng or np.random.default_rng(0)
    L = config.num_layers
    counts: List[List[int]] = [[] for _ in range(L)]
    conv_hist: List[List[np.ndarray]] = [[] for _ in range(L)]
    pool_hist: List[List[np.ndarray]] = [[] for _ in range(L - 1)]

    for pts in sphere_point_clouds:
        pyr = build_sphere_pyramid(pts, config, rng=rng)
        for l in range(L):
            n_s = pyr["points"][l].shape[0]
            counts[l].append(n_s)
            conv_hist[l].append(np.sum(pyr["neighbors"][l] < n_s, axis=1))
        for l in range(L - 1):
            n_s = pyr["points"][l].shape[0]
            pool_hist[l].append(np.sum(pyr["pools"][l] < n_s, axis=1))

    def percentile_width(rows: List[np.ndarray]) -> int:
        return int(np.quantile(np.concatenate(rows), untouched_ratio)) + 1

    num_points = [
        _round_up(np.percentile(counts[l],
                                point_percentile if l == 0 else 100.0)
                  * 1.1 + 1, 8)
        for l in range(L)]

    small = None
    if 0.0 < bucket_percentile < 100.0:
        counts0 = np.asarray(counts[0])
        cut = int(np.percentile(counts0, bucket_percentile))
        in_bucket = counts0 <= cut
        if 0 < int(in_bucket.sum()) < len(counts0):
            small_points = [
                _round_up(np.asarray(counts[l])[in_bucket].max() * 1.1 + 1, 8)
                for l in range(L)]
            # every sphere routed by `cut` fits the bucket's level 0
            small_points[0] = max(small_points[0], _round_up(cut + 1, 8))
            if small_points[0] < num_points[0]:
                small = {"num_points": small_points, "cut": cut}
    return ShapePlan(
        num_points=num_points,
        conv_neighbors=[percentile_width(conv_hist[l]) for l in range(L)],
        pool_neighbors=[percentile_width(pool_hist[l])
                        for l in range(L - 1)],
        max_regions=region_budget[0],
        max_region_points=region_budget[1], small=small)


def _pad_points(pts: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    k = min(pts.shape[0], n)
    out = np.full((n, 3), SHADOW_COORD, dtype=np.float32)
    out[:k] = pts[:k]
    mask = np.zeros(n, dtype=bool)
    mask[:k] = True
    return out, mask


def _pad_neighbors(inds: np.ndarray, n_rows: int, width: int,
                   n_support_real: int, n_support_pad: int) -> np.ndarray:
    """Crop or pad an index matrix to [n_rows, width]: rows are
    distance-sorted, so a crop keeps the nearest. The input shadow
    (n_support_real) and supports past the padded level size (points a
    level crop dropped) become the output shadow n_support_pad."""
    rows = min(inds.shape[0], n_rows)
    out = np.full((n_rows, width), n_support_pad, dtype=np.int32)
    w = min(inds.shape[1], width)
    block = inds[:rows, :w].astype(np.int32).copy()
    block[block >= min(n_support_real, n_support_pad)] = n_support_pad
    out[:rows, :w] = block
    return out


def _pad_pyramids(pyramids: Sequence[Dict], plan: ShapePlan,
                  with_upsamples: bool) -> Dict:
    """The padded per-level arrays of B sphere pyramids: points, masks,
    lengths, neighbors, pools and (with_upsamples) upsamples."""
    B, L = len(pyramids), plan.num_layers
    points = [np.zeros((B, plan.num_points[l], 3), np.float32)
              for l in range(L)]
    masks = [np.zeros((B, plan.num_points[l]), bool) for l in range(L)]
    neighbors = [np.zeros((B, plan.num_points[l], plan.conv_neighbors[l]),
                          np.int32) for l in range(L)]
    pools = [np.zeros((B, plan.num_points[l + 1], plan.pool_neighbors[l]),
                      np.int32) for l in range(L - 1)]
    upsamples = [np.zeros((B, plan.num_points[l], plan.up_neighbors),
                          np.int32) for l in range(L - 1)] \
        if with_upsamples else []
    lengths = [np.zeros((B,), np.int32) for _ in range(L)]
    for b, pyr in enumerate(pyramids):
        for l in range(L):
            pts = pyr["points"][l]
            points[l][b], masks[l][b] = _pad_points(pts, plan.num_points[l])
            lengths[l][b] = min(pts.shape[0], plan.num_points[l])
            neighbors[l][b] = _pad_neighbors(
                pyr["neighbors"][l], plan.num_points[l],
                plan.conv_neighbors[l], pts.shape[0], plan.num_points[l])
        for l in range(L - 1):
            pts = pyr["points"][l]
            pools[l][b] = _pad_neighbors(
                pyr["pools"][l], plan.num_points[l + 1],
                plan.pool_neighbors[l], pts.shape[0], plan.num_points[l])
            if with_upsamples:
                upsamples[l][b] = _pad_neighbors(
                    pyr["upsamples"][l], plan.num_points[l],
                    plan.up_neighbors, pyr["points"][l + 1].shape[0],
                    plan.num_points[l + 1])
    return dict(points=tuple(points), masks=tuple(masks),
                neighbors=tuple(neighbors), pools=tuple(pools),
                upsamples=tuple(upsamples), lengths=tuple(lengths))


def assemble_classification_batch(clouds: Sequence[Dict],
                                  plan: ShapePlan) -> PyramidBatch:
    """Dense classification batch (the reference's
    `classification_inputs`): conv and pool indices, no upsamples, one
    label per cloud in `cloud_label`.

    Each element of `clouds`: {'pyramid': build_sphere_pyramid(...,
    with_upsamples=False), 'features': [n0, F], 'label': int, 'center':
    [3] optional}. Returns a PyramidBatch of numpy arrays."""
    B = len(clouds)
    n0 = plan.num_points[0]
    F = clouds[0]["features"].shape[1]
    levels = _pad_pyramids([c["pyramid"] for c in clouds], plan,
                           with_upsamples=False)
    features = np.zeros((B, n0, F), np.float32)
    centers = np.zeros((B, 3), np.float32)
    cloud_label = np.full((B,), -1, np.int32)
    for b, s in enumerate(clouds):
        k0 = min(s["pyramid"]["points"][0].shape[0], n0)
        features[b, :k0] = s["features"][:k0]
        centers[b] = s.get("center", np.zeros(3))
        cloud_label[b] = int(s["label"])
    return PyramidBatch(**levels, features=features,
                        labels=np.full((B, n0), -1, np.int32),
                        center_pts=centers, cloud_label=cloud_label)


def assemble_batch(spheres: Sequence[Dict], plan: ShapePlan,
                   num_classes: int,
                   rng: Optional[np.random.Generator] = None
                   ) -> PyramidBatch:
    """Pad B sphere pyramids and payloads into one PyramidBatch of numpy
    arrays (the host-pyramid path's batch).

    Each element of `spheres`: {'pyramid': build_sphere_pyramid output,
    'features': [n0, F], 'labels': [n0] (label-to-idx mapped, optional),
    'center': [3], 'cloud_lb': [C] multi-hot (optional), 'regions':
    [(member indices, multi-hot label)] (optional)}. Level 0 is cropped
    to the plan (the sampler thins oversized spheres before their
    pyramid); regions go through `fill_region_row`, whose draws come
    from `rng` in sphere order."""
    rng = rng or np.random.default_rng()
    B = len(spheres)
    n0 = plan.num_points[0]
    F = spheres[0]["features"].shape[1]
    levels = _pad_pyramids([s["pyramid"] for s in spheres], plan,
                           with_upsamples=True)
    features = np.zeros((B, n0, F), np.float32)
    labels = np.full((B, n0), -1, np.int32)
    centers = np.zeros((B, 3), np.float32)
    R, P = max(plan.max_regions, 1), max(plan.max_region_points, 1)
    cloud_lb = np.zeros((B, num_classes), np.float32)
    region_inds = np.full((B, R, P), n0, np.int32)
    region_masks = np.zeros((B, R), bool)
    region_point_masks = np.zeros((B, R, P), bool)
    region_lb = np.zeros((B, R, num_classes), np.float32)
    for b, s in enumerate(spheres):
        k0 = min(s["pyramid"]["points"][0].shape[0], n0)
        features[b, :k0] = s["features"][:k0]
        if s.get("labels") is not None:
            labels[b, :k0] = s["labels"][:k0]
        centers[b] = s.get("center", np.zeros(3))
        if s.get("cloud_lb") is not None:
            cloud_lb[b] = s["cloud_lb"]
        fill_region_row(region_inds[b], region_point_masks[b],
                        region_masks[b], region_lb[b], s.get("regions"), k0,
                        rng)
    return PyramidBatch(**levels, features=features, labels=labels,
                        center_pts=centers, cloud_lb=cloud_lb,
                        region_inds=region_inds, region_masks=region_masks,
                        region_point_masks=region_point_masks,
                        region_lb=region_lb)


def sphere_batch(payloads: Sequence[Dict], pyramids: Sequence[Dict],
                 plan: ShapePlan, num_classes: int,
                 rng: np.random.Generator,
                 own: Optional[Tuple[int, int]] = None):
    """(assemble_batch of the payloads' pyramids, the metas of every
    payload): the end of `next_batch` of the datasets and of
    `ParallelSphereBuilder`. With `own` = (lo, hi), `pyramids` holds those
    of spheres [lo, hi) only and the batch is rows [lo, hi) of the whole
    one, with the same draws from `rng`: `assemble_batch` draws only in
    `fill_region_row`, sphere by sphere, so the other spheres' region
    draws run on scratch rows in their place."""
    n0 = plan.num_points[0]
    lo, hi = own or (0, len(payloads))
    R, P = max(plan.max_regions, 1), max(plan.max_region_points, 1)

    def skip_regions(p):
        fill_region_row(np.full((R, P), n0, np.int32),
                        np.zeros((R, P), bool), np.zeros(R, bool),
                        np.zeros((R, num_classes), np.float32),
                        p.get("regions"), min(p["points"].shape[0], n0), rng)

    for p in payloads[:lo]:
        skip_regions(p)
    spheres = [dict(pyramid=pyr, features=p["features"],
                    labels=p["labels"], center=p["center"],
                    cloud_lb=p["cloud_lb"], regions=p["regions"])
               for p, pyr in zip(payloads[lo:hi], pyramids)]
    batch = assemble_batch(spheres, plan, num_classes, rng=rng)
    for p in payloads[hi:]:
        skip_regions(p)
    return batch, [payload_meta(p, n0) for p in payloads]
