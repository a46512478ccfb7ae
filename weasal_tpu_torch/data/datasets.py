"""Cloud-segmentation datasets: preparation, caches, anchors and the
potential-driven sphere sampler.

Counterpart of weasal_tpu/data/datasets.py: `CloudSegmentationDataset`
(:42-781) for the splits 'training', 'validation' and 'test' (with
`test_on_train`, the training clouds voted on for pseudo-labels and
active learning), `_Vaihingen3DBase` (:787-841),
`Vaihingen3DWLDataset` (:843) and `Vaihingen3DPLDataset` (:848-873),
whose training split reads the refined pseudo labels and overlays the
ground truth of its point ledger, and the multi-tile, colorless DALES
datasets `_DALESBase` (:880-958), `DALESWLDataset` (:961) and
`DALESPLDataset` (:966-975), whose test split is a list of tiles. The
sampler draws the same random numbers in the same order as the JAX
package, so one seed gives both the same spheres (a cloud without colors
draws no color drop). Differences by design:

- scipy's cKDTree replaces sklearn's KDTree; radius queries return each
  row sorted ascending (ops/neighbors.query_radius), where sklearn
  returns its tree's order. Thinning and region positions follow that
  order.
- The caches are the port's own, never the JAX package's sklearn
  pickles: `input_{dl:.3f}_torch/` holds the subsampled ply, the coarse
  potential points, the projection indices and the anchor sets (numpy
  arrays and dicts) and the pseudo-label stage's ground-truth ledger
  (`<cloud>_al_groundTruth_IDs.pkl`), and the trees are rebuilt from
  them; shape plans go to `shape_plans_torch.json`.
- Anchor subsampling draws from `random.Random(ANCHOR_SEED)`.
- The plan has no band windows.
The 'ERF' split (which the JAX tester refuses to vote on) is not ported.
"""

from __future__ import annotations

import json
import os
import pickle
import random
import time
from os.path import exists, join
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from weasal_tpu_torch.data import anchors as anchor_ops
from weasal_tpu_torch.data.batching import ShapePlan, calibrate_shape_plan
from weasal_tpu_torch.kernels.kernel_points import create_3d_rotations
from weasal_tpu_torch.ops.neighbors import query_radius
from weasal_tpu_torch.ops.subsample import grid_subsample
from weasal_tpu_torch.utils.ply import read_ply, write_ply

# Seed of the initial anchor budget's random draws (subsample_anchors)
ANCHOR_SEED = 0


class CloudSegmentationDataset:
    """In-memory subsampled clouds and the potential sphere sampler.

    Subclasses define the label nomenclature, the file lists and the
    feature assembly. `split` is 'training', 'validation' or 'test';
    `test_on_train` makes the test split the training clouds (labels
    kept).
    """

    name: str = ""
    label_to_names: Dict[int, str] = {}
    ignored_label_values: Tuple[int, ...] = ()
    train_dir = "Training"
    validation_dir = "Validation"
    test_dir = "Test"
    cloud_names: List[str] = []
    all_splits: List[int] = []
    validation_split: int = 1
    weak_labels = False          # WL datasets: anchors + regions

    def __init__(self, config, split: str = "training",
                 al_iteration: int = 0, data_root: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None,
                 test_on_train: bool = False):
        if split not in ("training", "validation", "test"):
            raise NotImplementedError(
                f"split {split!r}: only 'training', 'validation' and 'test' "
                "are ported")
        self.config = config
        self.split = split
        self.test_on_train = test_on_train
        self.al_iteration = al_iteration
        self.rng = rng or np.random.default_rng()

        self.path = data_root or join("data", self.name)
        self.num_classes = len(self.label_to_names)
        self.label_values = np.sort(
            [k for k in self.label_to_names]).astype(np.int32)
        self.ignored_labels = np.array(self.ignored_label_values,
                                       dtype=np.int32)
        self.label_to_idx = {l: i for i, l in enumerate(self.label_values)}
        if 10 in self.label_to_idx:
            # PL stage: an uncertain pseudo label keeps its raw value 10,
            # which the contrast loss reads as unlabeled
            self.label_to_idx[10] = 10

        config.num_classes = self.num_classes - len(self.ignored_labels)
        config.dataset_task = "cloud_segmentation"

        self.test_split = self._test_split(test_on_train)
        self.prepare_ply()
        self.files, self.cloud_names_split = self._select_files()
        self.input_trees: List[cKDTree] = []
        self.input_colors: List[Optional[np.ndarray]] = []
        self.input_labels: List[np.ndarray] = []
        self.pot_trees: List[cKDTree] = []
        self.test_proj: List[np.ndarray] = []
        self.validation_labels: List[np.ndarray] = []
        # Host seconds of the set-up stages (caches built or read)
        self.setup_seconds: Dict[str, float] = {}
        t0 = time.perf_counter()
        self.load_subsampled_clouds()
        self.setup_seconds["subsample"] = time.perf_counter() - t0
        self.num_clouds = len(self.input_trees)

        if self.weak_labels and split == "training":
            t0 = time.perf_counter()
            self._init_anchors()
            self.setup_seconds["anchors"] = time.perf_counter() - t0
        self._init_potentials()

    # ------------------------------------------------------------------
    # File selection / preparation
    # ------------------------------------------------------------------

    def _test_split(self, test_on_train: bool):
        raise NotImplementedError

    def _split_dir(self) -> str:
        if self.split == "test":
            return join(self.path, self.test_dir)
        if self.split == "validation":
            return join(self.path, self.validation_dir)
        return join(self.path, self.train_dir)

    def _in_split(self, i: int) -> bool:
        # a multi-tile dataset's test split is a list of tiles
        test_split = self.test_split
        in_test = (self.all_splits[i] in test_split
                   if isinstance(test_split, (list, tuple, set))
                   else self.all_splits[i] == test_split)
        if self.split == "test":
            return in_test
        if self.split == "validation":
            return self.all_splits[i] == self.validation_split
        return self.all_splits[i] != self.validation_split and not in_test

    @property
    def has_labels(self) -> bool:
        """False for the test split's own clouds (no labels are read)."""
        return not (self.split == "test" and not self.test_on_train)

    def _select_files(self):
        ply_dir = self._split_dir()
        files, names = [], []
        for i, f in enumerate(self.cloud_names):
            if self._in_split(i):
                files.append(join(ply_dir, f + ".ply"))
                names.append(f)
        return files, names

    def prepare_ply(self):
        raise NotImplementedError

    def _sub_has_colors(self) -> bool:
        """Whether the prepared plys carry an `intensity` column."""
        return True

    # ------------------------------------------------------------------
    # Subsampled cloud caches
    # ------------------------------------------------------------------

    @property
    def tree_path(self) -> str:
        return join(self.path, "input_{:.3f}_torch".format(
            self.config.first_subsampling_dl))

    def load_subsampled_clouds(self):
        dl = self.config.first_subsampling_dl
        os.makedirs(self.tree_path, exist_ok=True)

        has_colors = self._sub_has_colors()
        for i, file_path in enumerate(self.files):
            t0 = time.time()
            cloud_name = self.cloud_names_split[i]
            sub_ply_file = join(self.tree_path, f"{cloud_name}.ply")
            sub_colors = None
            if exists(sub_ply_file):
                data = read_ply(sub_ply_file)
                sub_points = np.vstack((data["x"], data["y"], data["z"])).T
                sub_labels = data["class"].astype(np.int32)
                if has_colors:
                    sub_colors = data["intensity"].astype(np.float32)[:, None]
            else:
                data = read_ply(file_path)
                points = np.vstack((data["x"], data["y"],
                                    data["z"])).T.astype(np.float32)
                labels = data["class"].astype(np.int32)
                fields, names = [], ["x", "y", "z"]
                if has_colors:
                    colors = data["intensity"].astype(np.float32)[:, None]
                    sub_points, sub_colors, sub_labels = grid_subsample(
                        points, dl, features=colors, labels=labels)
                    sub_colors = sub_colors / 255.0
                    fields.append(sub_colors.astype(np.float32))
                    names.append("intensity")
                else:
                    sub_points, sub_labels = grid_subsample(
                        points, dl, labels=labels)
                write_ply(sub_ply_file,
                          [sub_points, *fields, sub_labels.astype(np.int32)],
                          names + ["class"])

            sub_labels = self._training_labels(cloud_name, sub_labels)
            self.input_trees.append(cKDTree(sub_points))
            self.input_colors.append(sub_colors)
            self.input_labels.append(sub_labels)
            print(f"{cloud_name}: {sub_labels.shape[0]} subsampled points "
                  f"({time.time() - t0:.1f}s)")

        # Coarse potential clouds (pot_dl = in_radius / 10)
        pot_dl = self.config.in_radius / 10
        for i in range(len(self.files)):
            coarse_file = join(self.tree_path,
                               f"{self.cloud_names_split[i]}_coarse.npy")
            if exists(coarse_file):
                coarse = np.load(coarse_file)
            else:
                coarse = grid_subsample(self._cloud_points_f32(i), pot_dl)
                np.save(coarse_file, coarse)
            self.pot_trees.append(cKDTree(coarse))

        # Reprojection indices for full-cloud evaluation
        if self.split in ("validation", "test"):
            for i, file_path in enumerate(self.files):
                proj_file = join(self.tree_path,
                                 f"{self.cloud_names_split[i]}_proj.pkl")
                if exists(proj_file):
                    with open(proj_file, "rb") as f:
                        proj_inds, labels = pickle.load(f)
                else:
                    data = read_ply(file_path)
                    points = np.vstack((data["x"], data["y"],
                                        data["z"])).T.astype(np.float32)
                    labels = data["class"].astype(np.int32)
                    proj_inds = self.input_trees[i].query(points)[1].astype(
                        np.int32)
                    with open(proj_file, "wb") as f:
                        pickle.dump([proj_inds, labels], f)
                self.test_proj.append(proj_inds)
                self.validation_labels.append(labels)

    def _training_labels(self, cloud_name: str,
                         sub_labels: np.ndarray) -> np.ndarray:
        """Hook: the pseudo-label datasets swap in refined pseudo labels
        for training."""
        return sub_labels

    def load_evaluation_points(self, file_path: str) -> np.ndarray:
        """The points of a split's prepared ply (f64 [N, 3])."""
        data = read_ply(file_path)
        return np.vstack((data["x"], data["y"], data["z"])).T

    # ------------------------------------------------------------------
    # Anchors (weak-label datasets)
    # ------------------------------------------------------------------

    def _init_anchors(self):
        cfg = self.config
        self.anchors, self.anchor_dicts = [], []
        self.anchor_trees, self.anchor_lbs = [], []
        for i, tree in enumerate(self.input_trees):
            cloud_name = self.cloud_names_split[i]
            anchors_file = join(
                self.tree_path,
                f"{cloud_name}_anchors_{cfg.anchor_method}.pkl")
            if exists(anchors_file):
                with open(anchors_file, "rb") as f:
                    anchor, anchors_dict, anchor_lb = pickle.load(f)
                anchor_tree = cKDTree(anchor)
            else:
                anchor = anchor_ops.get_anchors(tree.data, cfg.sub_radius,
                                                method=cfg.anchor_method)
                anchor, anchor_tree, anchors_dict, anchor_lb = \
                    anchor_ops.anchors_with_points(
                        tree, anchor, self.input_labels[i], cfg.sub_radius,
                        cfg.num_classes)
                if not cfg.subsample_labels:
                    anchor, anchor_tree, anchors_dict, anchor_lb = \
                        anchor_ops.update_anchors(
                            tree, anchor, anchor_tree, anchors_dict,
                            anchor_lb, cfg.sub_radius)
                with open(anchors_file, "wb") as f:
                    pickle.dump([anchor, anchors_dict, anchor_lb], f)

            if cfg.subsample_labels:
                sub_file = join(self.tree_path,
                                f"{cloud_name}_subsampled_anchors.pkl")
                if not self.al_iteration:
                    (anchor, anchor_tree, anchors_dict, anchor_lb,
                     anchor_inds_sub) = anchor_ops.subsample_anchors(
                         anchor, anchors_dict, anchor_lb,
                         cfg.initial_labels_per_file, cfg.subsample_method,
                         random.Random(ANCHOR_SEED))
                    with open(sub_file, "wb") as f:
                        pickle.dump(anchor_inds_sub, f)
                else:
                    with open(sub_file, "rb") as f:
                        anchor_inds_sub = pickle.load(f)
                    anchor, anchor_tree, anchors_dict, anchor_lb = \
                        anchor_ops.select_anchors(anchor, anchors_dict,
                                                  anchor_lb, anchor_inds_sub)
                anchor, anchor_tree, anchors_dict, anchor_lb = \
                    anchor_ops.update_anchors(
                        tree, anchor, anchor_tree, anchors_dict,
                        anchor_lb, cfg.sub_radius)

            self.anchors.append(anchor)
            self.anchor_dicts.append(anchors_dict)
            self.anchor_trees.append(anchor_tree)
            self.anchor_lbs.append(anchor_lb)

    # ------------------------------------------------------------------
    # Potential sampling (single writer: the loader's producer thread)
    # ------------------------------------------------------------------

    def _init_potentials(self):
        self.potentials = [self.rng.random(t.data.shape[0]) * 1e-3
                           for t in self.pot_trees]
        self.min_potentials = [float(p.min()) for p in self.potentials]
        self.argmin_potentials = [int(p.argmin()) for p in self.potentials]

    def min_potential(self) -> float:
        return min(self.min_potentials)

    def _sample_center(self, rng) -> Tuple[int, int, np.ndarray]:
        r = self.config.in_radius
        cloud_ind = int(np.argmin(self.min_potentials))
        point_ind = self.argmin_potentials[cloud_ind]
        pot_points = np.asarray(self.pot_trees[cloud_ind].data, dtype=float)
        center = pot_points[point_ind].reshape(1, -1).copy()
        center += rng.normal(scale=r / 10, size=center.shape)

        pot_inds, dists = query_radius(self.pot_trees[cloud_ind], center, r,
                                       return_distance=True)
        d2s, pot_inds = np.square(dists[0]), pot_inds[0]
        tukeys = np.square(1 - d2s / np.square(r))
        tukeys[d2s > np.square(r)] = 0
        if self.split != "training":
            self.potentials[cloud_ind][pot_inds] += tukeys
        else:
            self.potentials[cloud_ind][point_ind] += 0.01
        min_ind = int(self.potentials[cloud_ind].argmin())
        self.min_potentials[cloud_ind] = float(
            self.potentials[cloud_ind][min_ind])
        self.argmin_potentials[cloud_ind] = min_ind
        return cloud_ind, point_ind, center

    # ------------------------------------------------------------------
    # Augmentation
    # ------------------------------------------------------------------

    def augmentation_params(self, rng, dim: int = 3):
        """Rotation and scale draws, shared by the host transform and the
        resident path (which applies them on the device)."""
        cfg = self.config
        R = np.eye(dim, dtype=np.float32)
        if dim == 3:
            if cfg.augment_rotation == "vertical":
                theta = rng.random() * 2 * np.pi
                c, s = np.cos(theta), np.sin(theta)
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                             dtype=np.float32)
            elif cfg.augment_rotation == "all":
                theta = rng.random() * 2 * np.pi
                phi = (rng.random() - 0.5) * np.pi
                u = np.array([[np.cos(theta) * np.cos(phi),
                               np.sin(theta) * np.cos(phi), np.sin(phi)]])
                alpha = np.array([rng.random() * 2 * np.pi])
                R = create_3d_rotations(u, alpha)[0].astype(np.float32)

        min_s, max_s = cfg.augment_scale_min, cfg.augment_scale_max
        if cfg.augment_scale_anisotropic:
            scale = rng.random(dim) * (max_s - min_s) + min_s
        else:
            scale = np.full(dim, rng.random() * (max_s - min_s) + min_s)
        symmetries = np.array(cfg.augment_symmetries).astype(np.int32)
        symmetries = symmetries * rng.integers(2, size=dim)
        scale = (scale * (1 - symmetries * 2)).astype(np.float32)
        return scale, R

    def augmentation_transform(self, points, rng):
        scale, R = self.augmentation_params(rng, points.shape[1])
        noise = (rng.standard_normal(points.shape)
                 * self.config.augment_noise).astype(np.float32)
        return (points @ R) * scale + noise, scale, R

    # ------------------------------------------------------------------
    # Sphere -> payload
    # ------------------------------------------------------------------

    def _sphere_features(self, colors, aug_points, center) -> np.ndarray:
        raise NotImplementedError

    def _cloud_points_f32(self, cloud_ind: int) -> np.ndarray:
        """Each cloud's points as f32, converted once (the trees hold
        f64)."""
        cache = self.__dict__.setdefault("_pts_f32", {})
        if cloud_ind not in cache:
            cache[cloud_ind] = np.asarray(self.input_trees[cloud_ind].data,
                                          dtype=np.float32)
        return cache[cloud_ind]

    def _label_table(self) -> np.ndarray:
        """Raw label -> training index, as a lookup table."""
        table = getattr(self, "_lbl_table", None)
        if table is None:
            table = np.full(int(max(self.label_to_idx)) + 1, -1, np.int32)
            for raw, idx in self.label_to_idx.items():
                table[raw] = idx
            self._lbl_table = table
        return table

    def sample_sphere(self, rng, augment: bool = True,
                      max_points: int = 0, gather: bool = True) -> Dict:
        """Draw one input sphere; returns its payload dict.

        `augment` holds on every split (validation smoothing averages over
        augmentations). With ``gather=False`` (the resident path,
        data/resident.py) the per-point columns (points, features,
        labels) are left out, since the device gathers them, and the
        payload carries the augmentation parameters (`rot`, `scale`,
        `color_keep`) instead; sampling, potential updates, thinning and
        regions are the same.
        """
        cfg = self.config
        for _attempt in range(100 * max(cfg.batch_num, 1)):
            cloud_ind, point_ind, center = self._sample_center(rng)
            input_inds = query_radius(self.input_trees[cloud_ind], center,
                                      cfg.in_radius)[0]
            if input_inds.shape[0] >= 2:
                break
        else:
            raise ValueError("This dataset only contains empty input spheres")

        regions = None
        if self.weak_labels and self.split == "training":
            regions = self._sphere_regions(cloud_ind, center, input_inds)

        if max_points and input_inds.shape[0] > max_points:
            keep = np.sort(rng.choice(input_inds.shape[0], size=max_points,
                                      replace=False))
            # Remap sphere-local region indices through the thinning
            if regions:
                remap = -np.ones(input_inds.shape[0], dtype=np.int64)
                remap[keep] = np.arange(max_points)
                new_regions = []
                for inds, lb in regions:
                    new = remap[inds]
                    new = new[new >= 0]
                    if new.size:
                        new_regions.append((new, lb))
                regions = new_regions
            input_inds = input_inds[keep]

        has_labels = self.has_labels
        if not gather:
            cloud_lb = None
            if has_labels:
                raw_present = np.unique(
                    self.input_labels[cloud_ind][input_inds])
                cloud_lb = np.zeros(cfg.num_classes, np.float32)
                for l in raw_present:
                    idx = self.label_to_idx[l]
                    if 0 <= idx < cfg.num_classes:
                        cloud_lb[idx] = 1
            if augment:
                scale, R = self.augmentation_params(rng)
            else:
                scale, R = np.ones(3, np.float32), np.eye(3, dtype=np.float32)
            color_keep = 1.0
            if (augment and self.input_colors[cloud_ind] is not None
                    and rng.random() > cfg.augment_color):
                color_keep = 0.0
            return dict(points=None, features=None, labels=None,
                        input_inds=input_inds, cloud_ind=cloud_ind,
                        center=center[0].astype(np.float32),
                        cloud_lb=cloud_lb, regions=regions, scale=scale,
                        rot=R, color_keep=color_keep)

        points = self._cloud_points_f32(cloud_ind)
        input_points = (points[input_inds] - center).astype(np.float32)
        colors = (self.input_colors[cloud_ind][input_inds]
                  if self.input_colors[cloud_ind] is not None else None)

        if has_labels:
            raw = self.input_labels[cloud_ind][input_inds]
            labels = self._label_table()[np.asarray(raw, np.int64)]
            cloud_lb = np.zeros(cfg.num_classes, np.float32)
            present = np.unique(labels)
            cloud_lb[present[present < cfg.num_classes]] = 1
        else:
            labels = cloud_lb = None

        if augment:
            aug_points, scale, R = self.augmentation_transform(
                input_points, rng)
        else:
            aug_points, scale, R = input_points, np.ones(3, np.float32), \
                np.eye(3, dtype=np.float32)

        if augment and colors is not None \
                and rng.random() > cfg.augment_color:
            colors = colors * 0

        features = self._sphere_features(colors, aug_points, center)
        return dict(points=aug_points, features=features,
                    labels=labels, input_inds=input_inds,
                    cloud_ind=cloud_ind, center=center[0].astype(np.float32),
                    cloud_lb=cloud_lb, regions=regions, scale=scale, rot=R)

    def _sphere_regions(self, cloud_ind, center, input_inds):
        """Anchors inside the sphere -> sphere-local member positions and
        labels."""
        cfg = self.config
        adict = self.anchor_dicts[cloud_ind]
        albs = self.anchor_lbs[cloud_ind]
        a_inds = query_radius(self.anchor_trees[cloud_ind], center,
                              cfg.in_radius - cfg.sub_radius - 0.01)[0]
        if len(a_inds) == 0:
            return []

        # One cloud-sized remap per sphere (a cached buffer, reset after)
        n_cloud = self.input_labels[cloud_ind].shape[0]
        buf = getattr(self, "_region_remap", None)
        if buf is None or buf.shape[0] < n_cloud:
            buf = np.full(max(n_cloud, 1), -1, np.int64)
            self._region_remap = buf
        buf[input_inds] = np.arange(input_inds.shape[0])
        regions = []
        for aa in a_inds:
            pos = buf[adict[aa][0][0]]
            pos = pos[pos >= 0]
            if pos.size == 0:
                continue
            regions.append((pos, albs[aa].astype(np.float32)))
        buf[input_inds] = -1
        return regions

    # ------------------------------------------------------------------
    # Shape-plan calibration
    # ------------------------------------------------------------------

    @property
    def plan_file(self) -> str:
        return join(self.path, "shape_plans_torch.json")

    def _plan_key(self) -> str:
        cfg = self.config
        key = "potentials_{:.3f}_{:.3f}_{:d}_{:d}".format(
            cfg.in_radius, cfg.first_subsampling_dl, cfg.batch_num,
            cfg.num_layers)
        pct = float(getattr(cfg, "plan_point_percentile", 100.0))
        if pct != 100.0:
            key += "_p{:g}".format(pct)
        bkt = float(getattr(cfg, "plan_bucket_percentile", 0.0))
        if bkt > 0.0:
            key += "_b{:g}".format(bkt)
        deform = getattr(cfg, "deform_layers", None) or []
        if any(deform):
            # deformable layers search wider (data/batching.layer_radii):
            # their neighbor budgets are their own
            key += "_d{}_{:.3f}".format(
                "".join("1" if d else "0" for d in deform),
                cfg.deform_radius / cfg.conv_radius)
        return key

    def _load_plans(self) -> Dict:
        if not exists(self.plan_file):
            return {}
        with open(self.plan_file) as f:
            return json.load(f)

    def save_plan(self, plan: ShapePlan) -> None:
        plans = self._load_plans()
        plans[self._plan_key()] = json.loads(json.dumps(plan.__dict__))
        with open(self.plan_file, "w") as f:
            json.dump(plans, f, indent=2)

    def calibration(self, num_samples: int = 40, force_redo: bool = False,
                    untouched_ratio: float = 0.9,
                    verbose: bool = False) -> ShapePlan:
        """The shape plan of this config, from the cache or from
        `num_samples` spheres drawn on `default_rng(0)` with the
        potentials restored afterwards."""
        cfg = self.config
        plans = self._load_plans()
        key = self._plan_key()
        if key in plans and not force_redo:
            return ShapePlan.from_dict(plans[key])

        t0 = time.time()
        rng = np.random.default_rng(0)
        clouds, region_counts, region_sizes = \
            self._sample_calibration_clouds(num_samples, rng)
        if region_sizes:
            r_budget = (int(np.quantile(region_counts, 0.98)) + 2,
                        int(np.quantile(region_sizes, 0.95)) + 1)
        else:
            r_budget = (0, 0)
        plan = calibrate_shape_plan(
            clouds, cfg, untouched_ratio=untouched_ratio,
            point_percentile=float(getattr(cfg, "plan_point_percentile",
                                           100.0)),
            region_budget=r_budget, rng=rng,
            bucket_percentile=float(getattr(cfg, "plan_bucket_percentile",
                                            0.0)))
        self.save_plan(plan)
        if verbose:
            print(f"Calibrated shape plan in {time.time() - t0:.1f}s: "
                  f"{plan}")
        return plan

    def _sample_calibration_clouds(self, num_samples: int,
                                   rng: np.random.Generator):
        """Calibration spheres, drawn without disturbing the training
        order (the potentials are restored after)."""
        clouds, region_counts, region_sizes = [], [], []
        pots = [p.copy() for p in self.potentials]
        for _ in range(num_samples):
            payload = self.sample_sphere(rng, augment=True)
            clouds.append(payload["points"])
            if payload["regions"] is not None:
                region_counts.append(len(payload["regions"]))
                region_sizes += [r[0].size for r in payload["regions"]]
        self.potentials = pots
        self.min_potentials = [float(p.min()) for p in self.potentials]
        self.argmin_potentials = [int(p.argmin()) for p in self.potentials]
        return clouds, region_counts, region_sizes


# ----------------------------------------------------------------------------
# Vaihingen3D
# ----------------------------------------------------------------------------

class _Vaihingen3DBase(CloudSegmentationDataset):
    label_to_names = {0: "Powerline", 1: "LowVegetation",
                      2: "ImperviousSurfaces", 3: "Car", 4: "Fence/Hedge",
                      5: "Roof", 6: "Facade", 7: "Shrub", 8: "Tree"}
    cloud_names = ["Vaihingen3D_Training", "Vaihingen3D_Training",
                   "Vaihingen3D_Testing"]
    all_splits = [0, 1, 2]
    validation_split = 1

    def _test_split(self, test_on_train: bool):
        return 0 if test_on_train else 2

    def prepare_ply(self):
        """Offset-reduce the split's raw cloud into its prepared ply
        (points relative to the training cloud's first point): the
        testing cloud for the test split on its own clouds, else the
        training cloud."""
        ply_dir = self._split_dir()
        os.makedirs(ply_dir, exist_ok=True)
        data = read_ply(join(self.path, self.cloud_names[0] + ".ply"))
        self.coord_offset = np.vstack((data["x"][0], data["y"][0],
                                       data["z"][0])).T
        cloud_name = self.cloud_names[
            2 if self.split == "test" and not self.test_on_train else 0]
        cloud_file = join(ply_dir, cloud_name + ".ply")
        if exists(cloud_file):
            return
        if cloud_name != self.cloud_names[0]:
            data = read_ply(join(self.path, cloud_name + ".ply"))
        points = np.vstack((data["x"], data["y"], data["z"])).T
        points = (points - self.coord_offset).astype(np.float32)
        intensity = data["scalar_Intensity"].astype(np.uint8)
        classes = data["scalar_Classification"].astype(np.int32)
        write_ply(cloud_file, [points, intensity, classes],
                  ["x", "y", "z", "intensity", "class"])

    def _sphere_features(self, colors, aug_points, center):
        # [intensity, absolute height, reduced height] -> select by dim
        feats = np.hstack((
            colors,
            aug_points[:, 2:] + center[:, 2:].astype(np.float32),
            aug_points[:, 2:])).astype(np.float32)
        ones = np.ones((aug_points.shape[0], 1), np.float32)
        fdim = self.config.in_features_dim
        if fdim == 1:
            return ones
        if fdim == 2:
            return np.hstack((ones, feats[:, :1]))
        if fdim == 4:
            return np.hstack((ones, feats[:, :3]))
        raise ValueError("Vaihingen3D supports in_features_dim 1, 2 or 4")


class Vaihingen3DWLDataset(_Vaihingen3DBase):
    name = "Vaihingen3D"
    weak_labels = True


class PseudoLabelLedger:
    """The pseudo-label stage's training labels, shared by its datasets:
    the training split trains on `<data_root>/PseudoLabels/
    <weak_label_log>/<cloud>_t<thd>_pseudo.txt` with the ground truth of
    the points in the cloud's ledger (`<cloud>_al_groundTruth_IDs.pkl` in
    the port's cache, extended by each acquisition) written over it;
    iteration 0 starts an empty ledger."""

    def gt_ledger_file(self, cloud_name: str) -> str:
        return join(self.tree_path, cloud_name + "_al_groundTruth_IDs.pkl")

    def _training_labels(self, cloud_name, sub_labels):
        if self.split != "training":
            return sub_labels
        cfg = self.config
        pseudo_file = join(
            self.path, "PseudoLabels", cfg.weak_label_log,
            f"{cloud_name}_t{int(cfg.contrast_thd)}_pseudo.txt")
        labels = np.genfromtxt(pseudo_file).astype(np.int32)
        if labels.shape != sub_labels.shape:
            raise ValueError(
                f"{pseudo_file}: {labels.shape[0]} pseudo labels for "
                f"{sub_labels.shape[0]} subsampled points")
        gt_file = self.gt_ledger_file(cloud_name)
        if self.al_iteration:
            with open(gt_file, "rb") as f:
                gt_ids = np.asarray(pickle.load(f), dtype=np.int64)
            labels[gt_ids] = sub_labels[gt_ids]
        else:
            with open(gt_file, "wb") as f:
                pickle.dump([], f)
        return labels


class Vaihingen3DPLDataset(PseudoLabelLedger, _Vaihingen3DBase):
    """The pseudo-label stage's Vaihingen3D: the class 10 'Ignore' marks
    points without a pseudo label (PseudoLabelLedger)."""
    name = "Vaihingen3D"
    label_to_names = {**_Vaihingen3DBase.label_to_names, 10: "Ignore"}
    ignored_label_values = (10,)


# ----------------------------------------------------------------------------
# DALES
# ----------------------------------------------------------------------------

class _DALESBase(CloudSegmentationDataset):
    """DALES: many tiles, no color. The 29 training and validation tiles
    and the 11 test tiles of the real dataset, or, for a root without
    them, the layout discovered from its plys: the sorted `test_*` tiles
    are the test split, the lexically last of the other tiles is the
    validation tile (as 5190_54400 is among the real names), the rest
    train."""
    label_to_names = {0: "Unknown", 1: "Ground", 2: "Vegetation", 3: "Cars",
                      4: "Trucks", 5: "Power", 6: "Fences", 7: "Poles",
                      8: "Buildings"}
    cloud_names = ["5080_54435", "5085_54320", "5095_54440", "5095_54455",
                   "5100_54495", "5105_54405", "5105_54460", "5110_54320",
                   "5110_54460", "5110_54475", "5110_54495", "5115_54480",
                   "5130_54355", "5135_54495", "5140_54445", "5145_54340",
                   "5145_54405", "5145_54460", "5145_54470", "5145_54480",
                   "5150_54340", "5160_54330", "5165_54390", "5165_54395",
                   "5180_54435", "5180_54485", "5185_54390", "5185_54485",
                   "5190_54400",
                   "test_5080_54400", "test_5080_54470", "test_5100_54440",
                   "test_5100_54490", "test_5120_54445", "test_5135_54430",
                   "test_5135_54435", "test_5140_54390", "test_5150_54325",
                   "test_5155_54335", "test_5175_54395"]
    all_splits = list(range(40))
    validation_split = 28
    # index of the first test tile: the number of training and validation
    # tiles
    _n_trainval = 29

    def __init__(self, config, *args, data_root: Optional[str] = None,
                 **kwargs):
        path = data_root or join("data", self.name)
        real_layout = all(exists(join(path, n + ".ply"))
                          for n in _DALESBase.cloud_names)
        if not real_layout and os.path.isdir(path):
            names = sorted(
                f[:-4] for f in os.listdir(path)
                if f.endswith(".ply") and os.path.isfile(join(path, f)))
            trainval = [n for n in names if not n.startswith("test_")]
            test = [n for n in names if n.startswith("test_")]
            if len(trainval) >= 2 and test:
                self.cloud_names = trainval + test
                self.all_splits = list(range(len(self.cloud_names)))
                self.validation_split = len(trainval) - 1
                self._n_trainval = len(trainval)
            # else the real names stay, and their missing files raise
        super().__init__(config, *args, data_root=data_root, **kwargs)

    def _test_split(self, test_on_train: bool):
        if test_on_train:
            return list(range(0, self._n_trainval - 1))
        return list(range(self._n_trainval, len(self.cloud_names)))

    def _sub_has_colors(self) -> bool:
        return False

    def prepare_ply(self):
        """Offset-reduce the split's raw tiles into its prepared plys
        (points relative to the first tile's first point)."""
        ply_dir = self._split_dir()
        os.makedirs(ply_dir, exist_ok=True)
        data = read_ply(join(self.path, self.cloud_names[0] + ".ply"))
        self.coord_offset = np.vstack((data["x"][0], data["y"][0],
                                       data["z"][0])).T
        for i, cloud_name in enumerate(self.cloud_names):
            if not self._in_split(i):
                continue
            cloud_file = join(ply_dir, cloud_name + ".ply")
            if exists(cloud_file):
                continue
            data = read_ply(join(self.path, cloud_name + ".ply"))
            points = np.vstack((data["x"], data["y"], data["z"])).T
            points = (points - self.coord_offset).astype(np.float32)
            classes = data["scalar_Classification"].astype(np.int32)
            write_ply(cloud_file, [points, classes], ["x", "y", "z", "class"])

    def _sphere_features(self, colors, aug_points, center):
        # [ones, absolute height, reduced height]
        ones = np.ones((aug_points.shape[0], 1), np.float32)
        fdim = self.config.in_features_dim
        if fdim == 1:
            return ones
        if fdim == 3:
            return np.hstack((
                ones, aug_points[:, 2:] + center[:, 2:].astype(np.float32),
                aug_points[:, 2:])).astype(np.float32)
        raise ValueError("DALES supports in_features_dim 1 or 3")


class DALESWLDataset(_DALESBase):
    name = "DALES"
    weak_labels = True


class DALESPLDataset(PseudoLabelLedger, _DALESBase):
    """The pseudo-label stage's DALES: the class 10 'Ignore' marks points
    without a pseudo label (PseudoLabelLedger)."""
    name = "DALES"
    label_to_names = {**_DALESBase.label_to_names, 10: "Ignore"}
    ignored_label_values = (10,)
