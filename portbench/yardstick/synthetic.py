"""Synthetic aerial-LiDAR scenes in the raw Vaihingen3D format: the
benchmark's frozen copy of weasal_tpu_torch/data/synthetic.py, so that a
change to the program cannot change the tiles its cells train and vote
on. One seed writes the same plys as the program's generator did when the
copy was made: a smooth terrain, buildings with roofs and facades, trees,
shrubs, cars, fences and powerlines, labeled with the Vaihingen3D 9-class
nomenclature.
"""

from __future__ import annotations

import os
from os.path import join
from typing import Tuple

import numpy as np

from portbench.reference.utils.ply import write_ply

# Vaihingen3D class ids
POWERLINE, LOW_VEG, SURFACE, CAR, FENCE, ROOF, FACADE, SHRUB, TREE = range(9)


#: Default scene style. `district_style` randomizes these per district so a
#: composed tile contains structurally distinct neighborhoods (a single
#: homogeneous tile makes long training runs degenerate: the model
#: memorizes it).
DEFAULT_STYLE = dict(
    terrain_amp=(1.5, 1.0, 0.3),        # sin/cos/sin amplitudes
    terrain_wave=(17.0, 23.0, 5.0),     # wavelength divisors
    terrain_phase=1.7,
    veg_wave=(7.0, 9.0),                # low-veg patch pattern
    veg_thresh=0.3,
    building_area=450.0,                # m^2 of tile per building
    building_h=(4.0, 10.0),
    gable_p=0.5,
    tree_area=200.0,                    # m^2 per tree
    crown_h=(6.0, 14.0),
    crown_r=(1.5, 3.5),
    shrub_area=300.0,
    car_area=500.0,
    fence_per_m=20.0,                   # m of tile-extent per fence
    power_lines=2,
    power_h=12.0,
)


def district_style(rng: np.random.Generator) -> dict:
    """A randomized style: one structurally distinct 'neighborhood'."""
    return dict(
        terrain_amp=tuple(rng.uniform([0.5, 0.3, 0.1], [2.5, 1.8, 0.6])),
        terrain_wave=tuple(rng.uniform([11.0, 15.0, 3.5],
                                       [25.0, 33.0, 7.0])),
        terrain_phase=float(rng.uniform(0, 2 * np.pi)),
        veg_wave=tuple(rng.uniform([5.0, 6.0], [11.0, 13.0])),
        veg_thresh=float(rng.uniform(0.0, 0.55)),
        building_area=float(rng.uniform(250.0, 800.0)),
        building_h=(float(rng.uniform(3.0, 6.0)),
                    float(rng.uniform(8.0, 16.0))),
        gable_p=float(rng.uniform(0.15, 0.85)),
        tree_area=float(rng.uniform(120.0, 420.0)),
        crown_h=(float(rng.uniform(4.0, 8.0)),
                 float(rng.uniform(10.0, 18.0))),
        crown_r=(float(rng.uniform(1.0, 2.0)),
                 float(rng.uniform(2.5, 4.5))),
        shrub_area=float(rng.uniform(180.0, 500.0)),
        car_area=float(rng.uniform(280.0, 900.0)),
        fence_per_m=float(rng.uniform(12.0, 32.0)),
        power_lines=int(rng.integers(1, 4)),
        power_h=float(rng.uniform(9.0, 16.0)),
    )


def synthetic_scene(rng: np.random.Generator,
                    extent: float = 60.0,
                    density: float = 8.0,
                    style: dict = None) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """One synthetic tile. Returns (points [N,3], intensity [N], labels [N]).

    `density` is points per square meter of ground surface. With the default
    style the rng draw order is unchanged from the original generator.
    """
    st = dict(DEFAULT_STYLE, **(style or {}))
    n_ground = int(extent * extent * density)

    ta, tw, tp = st["terrain_amp"], st["terrain_wave"], st["terrain_phase"]

    def terrain(xy):
        return (ta[0] * np.sin(xy[:, 0] / tw[0])
                + ta[1] * np.cos(xy[:, 1] / tw[1])
                + ta[2] * np.sin(xy[:, 0] / tw[2] + tp))

    pts, labels = [], []

    # Ground: impervious surfaces + low vegetation patches
    xy = rng.uniform(0, extent, size=(n_ground, 2))
    z = terrain(xy) + rng.normal(0, 0.03, n_ground)
    ground = np.column_stack([xy, z])
    veg_patch = (np.sin(xy[:, 0] / st["veg_wave"][0])
                 * np.cos(xy[:, 1] / st["veg_wave"][1])) > st["veg_thresh"]
    g_labels = np.where(veg_patch, LOW_VEG, SURFACE)
    g_z_bump = np.where(veg_patch, rng.uniform(0, 0.3, n_ground), 0.0)
    ground[:, 2] += g_z_bump
    pts.append(ground)
    labels.append(g_labels)

    # Buildings: flat/gabled roofs + facades
    n_buildings = max(2, int(extent * extent / st["building_area"]))
    for _ in range(n_buildings):
        max_side = min(14.0, extent / 2.5)
        w, d = rng.uniform(min(6, max_side * 0.6), max_side, 2)
        cx, cy = rng.uniform(w, extent - w), rng.uniform(d, extent - d)
        h = rng.uniform(*st["building_h"])
        ground_z = terrain(np.array([[cx, cy]]))[0]
        n_roof = int(w * d * density)
        rxy = rng.uniform([-w / 2, -d / 2], [w / 2, d / 2], size=(n_roof, 2))
        gable = rng.random() < st["gable_p"]
        rz = ground_z + h + (np.abs(rxy[:, 0]) / (w / 2) * -1.5 if gable
                             else 0.0) + rng.normal(0, 0.03, n_roof)
        pts.append(np.column_stack([rxy[:, 0] + cx, rxy[:, 1] + cy, rz]))
        labels.append(np.full(n_roof, ROOF))
        # Facades: vertical walls on two sides
        n_fac = int(2 * (w + d) * h * density / 8)
        side = rng.integers(0, 4, n_fac)
        t = rng.uniform(-0.5, 0.5, n_fac)
        fx = np.where(side < 2, t * w, np.where(side == 2, -w / 2, w / 2))
        fy = np.where(side < 2, np.where(side == 0, -d / 2, d / 2), t * d)
        fz = ground_z + rng.uniform(0, h, n_fac)
        pts.append(np.column_stack([fx + cx, fy + cy, fz]))
        labels.append(np.full(n_fac, FACADE))

    # Trees: spherical crowns + sparse trunks
    n_trees = max(3, int(extent * extent / st["tree_area"]))
    for _ in range(n_trees):
        cx, cy = rng.uniform(2, extent - 2, 2)
        ground_z = terrain(np.array([[cx, cy]]))[0]
        ch = rng.uniform(*st["crown_h"])  # crown center height
        cr = rng.uniform(*st["crown_r"])  # crown radius
        n_crown = int(40 * cr * density / 8)
        sph = rng.normal(size=(n_crown, 3))
        sph = sph / np.linalg.norm(sph, axis=1, keepdims=True)
        sph = sph * (cr * rng.random((n_crown, 1)) ** 0.4)
        pts.append(sph + np.array([cx, cy, ground_z + ch]))
        labels.append(np.full(n_crown, TREE))

    # Shrubs: small low blobs
    n_shrubs = max(3, int(extent * extent / st["shrub_area"]))
    for _ in range(n_shrubs):
        cx, cy = rng.uniform(1, extent - 1, 2)
        ground_z = terrain(np.array([[cx, cy]]))[0]
        n_s = int(10 * density / 8)
        blob = rng.normal(scale=[0.8, 0.8, 0.4], size=(n_s, 3))
        pts.append(blob + np.array([cx, cy, ground_z + 0.7]))
        labels.append(np.full(n_s, SHRUB))

    # Cars: small boxes on the surface
    n_cars = max(2, int(extent * extent / st["car_area"]))
    for _ in range(n_cars):
        cx, cy = rng.uniform(3, extent - 3, 2)
        ground_z = terrain(np.array([[cx, cy]]))[0]
        n_c = int(15 * density / 8)
        box = rng.uniform([-2, -1, 0], [2, 1, 1.6], size=(n_c, 3))
        pts.append(box + np.array([cx, cy, ground_z]))
        labels.append(np.full(n_c, CAR))

    # Fences: thin vertical strips
    n_fences = max(2, int(extent / st["fence_per_m"]))
    for _ in range(n_fences):
        x0, y0 = rng.uniform(2, extent - 2, 2)
        ang = rng.uniform(0, np.pi)
        length = rng.uniform(5, 15)
        n_f = int(length * density / 2)
        t = rng.uniform(0, length, n_f)
        fx, fy = x0 + t * np.cos(ang), y0 + t * np.sin(ang)
        fz = terrain(np.column_stack([fx, fy])) + rng.uniform(0, 1.2, n_f)
        pts.append(np.column_stack([fx, fy, fz]))
        labels.append(np.full(n_f, FENCE))

    # Powerlines: catenary-ish wires high up
    for _ in range(st["power_lines"]):
        y0 = rng.uniform(5, extent - 5)
        n_p = int(extent * density / 8)
        px = rng.uniform(0, extent, n_p)
        pz = st["power_h"] + 2 * np.cos((px - extent / 2) / extent * np.pi) \
            + rng.normal(0, 0.05, n_p)
        pts.append(np.column_stack([px, np.full(n_p, y0)
                                    + rng.normal(0, 0.1, n_p), pz]))
        labels.append(np.full(n_p, POWERLINE))

    points = np.vstack(pts).astype(np.float64)
    labels = np.concatenate(labels).astype(np.int32)
    intensity = np.clip(rng.normal(120, 40, points.shape[0]),
                        0, 255).astype(np.float64)
    order = rng.permutation(points.shape[0])
    return points[order], intensity[order], labels[order]


def composed_scene(rng: np.random.Generator,
                   districts: int,
                   extent: float = 60.0,
                   density: float = 8.0) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Compose `districts` structurally distinct scenes into one contiguous
    tile (laid out on a grid, like the real Vaihingen tile's mixed urban
    fabric). Keeps the single-training-ply file contract of the reference
    (Vaihingen3D_WeakLabel.py:626-685) while giving long-budget runs
    non-degenerate variety."""
    if districts <= 1:
        return synthetic_scene(rng, extent, density)
    gcols = int(np.ceil(np.sqrt(districts)))
    pts, inten, lbl = [], [], []
    for d in range(districts):
        drng = np.random.default_rng(rng.integers(2 ** 31))
        style = district_style(drng)
        p, i, l = synthetic_scene(drng, extent, density, style)
        p[:, 0] += (d % gcols) * extent
        p[:, 1] += (d // gcols) * extent
        pts.append(p)
        inten.append(i)
        lbl.append(l)
    points = np.vstack(pts)
    intensity = np.concatenate(inten)
    labels = np.concatenate(lbl)
    order = rng.permutation(points.shape[0])
    return points[order], intensity[order], labels[order]


def make_vaihingen_like_root(root: str,
                             extent: float = 60.0,
                             density: float = 8.0,
                             seed: int = 0,
                             offset=(496000.0, 5419000.0, 200.0),
                             districts: int = 1,
                             test_districts: int = None) -> str:
    """Write raw Vaihingen3D-format plys (training + testing tiles) to root.

    Raw fields per the ISPRS export: x/y/z float64 with large UTM-like
    coordinates, scalar_Intensity, scalar_Classification
    (reference prepare_Vaihingen3D_ply, Vaihingen3D_WeakLabel.py:626-685).

    `districts` > 1 composes that many structurally distinct neighborhoods
    into the training tile (and `test_districts`, default half, into the
    testing tile) — same file contract, non-degenerate content.
    """
    os.makedirs(root, exist_ok=True)
    if test_districts is None:
        test_districts = max(1, districts // 2)
    for i, (name, nd) in enumerate([("Vaihingen3D_Training", districts),
                                    ("Vaihingen3D_Testing", test_districts)]):
        path = join(root, name + ".ply")
        if os.path.exists(path):
            continue
        rng = np.random.default_rng(seed + i)
        pts, inten, lbl = composed_scene(rng, nd, extent, density)
        pts = pts + np.asarray(offset)
        write_ply(path,
                  [pts.astype(np.float64), inten, lbl.astype(np.int32)],
                  ["x", "y", "z", "scalar_Intensity",
                   "scalar_Classification"])
    return root
