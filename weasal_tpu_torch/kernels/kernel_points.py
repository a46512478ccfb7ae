"""Kernel-point dispositions: generate, cache and load them, and give each
conv a random pose.

Counterpart of weasal_tpu/kernels/kernel_points.py: `create_3d_rotations`
(:36), `_random_ball_points` (:60), `_apply_fixed` (:72),
`spherical_lloyd` (:82, Monte-Carlo Lloyd relaxation, used above 30
points), `optimize_kernel_points` (:122, repulsive-potential descent over
100 candidates at once) and `load_kernels` (:187). The disposition file
`dispositions/k_015_center_3D.ply` is a copy of the JAX package's (every
shipped config uses 15 kernel points fixed at the center); any other
size is generated on a cache miss from the caller's rng, in the JAX
package's order (the generation's draws, then the pose's), and written
with `utils/ply.write_ply` beside it, or into `dispositions_dir`, so that
later convs read the file. The files are the JAX package's byte for byte
from one seed (tests/test_torch_kernel_points.py).
"""

from __future__ import annotations

from os import makedirs
from os.path import dirname, exists, join

import numpy as np

from weasal_tpu_torch.utils.ply import read_ply, write_ply

_DISPOSITION_DIR = join(dirname(__file__), "dispositions")


def create_3d_rotations(axis: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotation matrices from axes [N, 3] and angles [N] (Rodrigues form,
    in the transposed convention of the reference: points multiply on the
    right, pts @ R)."""
    axis = np.asarray(axis, dtype=np.float64)
    angle = np.asarray(angle, dtype=np.float64).reshape(-1)
    c = np.cos(angle)[:, None, None]
    s = np.sin(angle)[:, None, None]
    u = axis[:, :, None]
    outer = u @ np.transpose(u, (0, 2, 1))
    zeros = np.zeros_like(angle)
    ux, uy, uz = axis[:, 0], axis[:, 1], axis[:, 2]
    cross = np.stack([
        np.stack([zeros, -uz, uy], axis=-1),
        np.stack([uz, zeros, -ux], axis=-1),
        np.stack([-uy, ux, zeros], axis=-1),
    ], axis=1)
    R = c * np.eye(3)[None] + (1 - c) * outer \
        + s * np.transpose(cross, (0, 2, 1))
    return R.astype(np.float64)


def _random_ball_points(n: int, dim: int, rng: np.random.Generator,
                        r_min: float = 0.0, r_max: float = 1.0) -> np.ndarray:
    """Rejection-sample n points uniformly from a (shell of a) ball."""
    out = np.zeros((0, dim))
    while out.shape[0] < n:
        cand = rng.uniform(-r_max, r_max, size=(2 * n, dim))
        d2 = np.sum(cand ** 2, axis=1)
        keep = (d2 < r_max ** 2) & (d2 >= r_min ** 2)
        out = np.vstack((out, cand[keep]))
    return out[:n]


def _apply_fixed(points: np.ndarray, fixed: str) -> None:
    """Pin special kernel points in place (in-place)."""
    if fixed == "center":
        points[..., 0, :] = 0.0
    elif fixed == "verticals":
        points[..., :3, :] = 0.0
        points[..., 1, -1] = 2.0 / 3.0
        points[..., 2, -1] = -2.0 / 3.0


def spherical_lloyd(radius: float, num_cells: int, dimension: int = 3,
                    fixed: str = "center", approx_n: int = 5000,
                    max_iter: int = 500, momentum: float = 0.9,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Lloyd relaxation of `num_cells` sites in the unit ball (Monte-Carlo).

    Each iteration redraws approx_n uniform samples, assigns them to the
    nearest site, and moves sites toward their cell centroids with a momentum
    low-pass filter; fixed points are re-pinned after every move.
    """
    rng = rng or np.random.default_rng()
    sites = _random_ball_points(num_cells, dimension, rng, r_min=0.9)
    _apply_fixed(sites, fixed)

    for _ in range(max_iter):
        X = rng.uniform(-1.0, 1.0, size=(approx_n, dimension))
        X = X[np.sum(X ** 2, axis=1) < 1.0]

        d2 = np.sum((X[:, None, :] - sites[None]) ** 2, axis=2)
        cell = np.argmin(d2, axis=1)

        # Per-cell centroid via bincount (empty cells keep their site)
        counts = np.bincount(cell, minlength=num_cells).astype(np.float64)
        centers = np.stack([
            np.bincount(cell, weights=X[:, d], minlength=num_cells)
            for d in range(dimension)], axis=1)
        has_pts = counts > 0
        centers[has_pts] /= counts[has_pts, None]
        centers[~has_pts] = sites[~has_pts]

        sites += (1 - momentum) * (centers - sites)
        if fixed == "center":
            sites[0] = 0.0
        elif fixed == "verticals":
            sites[0] = 0.0
            sites[:3, :-1] = 0.0

    return sites * radius


def optimize_kernel_points(radius: float, num_points: int,
                           num_kernels: int = 100, dimension: int = 3,
                           fixed: str = "center", ratio: float = 0.66,
                           rng: np.random.Generator | None = None):
    """Repulsive-potential descent for `num_kernels` candidate dispositions.

    Points repel each other with an inverse-square force and are attracted
    toward the origin; the candidate whose final max gradient norm is lowest
    should be selected by the caller. Returns (kernels [nk, np, dim],
    final_grad_norms [nk]).
    """
    rng = rng or np.random.default_rng()
    kernel_points = _random_ball_points(
        num_kernels * num_points, dimension, rng,
        r_max=1.0)
    # Keep candidates well inside the ball like the reference (d2 < 0.5 r^2)
    d2 = np.sum(kernel_points ** 2, axis=1)
    resample = d2 >= 0.5
    while np.any(resample):
        kernel_points[resample] = rng.uniform(
            -1.0, 1.0, size=(int(resample.sum()), dimension))
        d2 = np.sum(kernel_points ** 2, axis=1)
        resample = d2 >= 0.5
    kernel_points = kernel_points.reshape(num_kernels, num_points, dimension)
    _apply_fixed(kernel_points, fixed)

    moving_factor = 1e-2
    decay = 0.9995
    thresh = 1e-5
    clip = 0.05

    old_norms = np.zeros((num_kernels, num_points))
    grad_norms = old_norms
    for _ in range(10000):
        A = kernel_points[:, :, None, :]
        B = kernel_points[:, None, :, :]
        diff = A - B
        interd2 = np.sum(diff ** 2, axis=-1)
        inter_grads = diff / (interd2[..., None] ** 1.5 + 1e-6)
        gradients = np.sum(inter_grads, axis=2) + 10 * kernel_points

        if fixed == "verticals":
            gradients[:, 1:3, :-1] = 0

        grad_norms = np.sqrt(np.sum(gradients ** 2, axis=-1))

        moving = slice(1, None) if fixed == "center" else (
            slice(3, None) if fixed == "verticals" else slice(None))
        if np.max(np.abs(old_norms[:, moving] - grad_norms[:, moving])) < thresh:
            break
        old_norms = grad_norms

        moving_dists = np.minimum(moving_factor * grad_norms, clip)
        if fixed in ("center", "verticals"):
            moving_dists[:, 0] = 0
        kernel_points -= (moving_dists[..., None] * gradients
                          / (grad_norms[..., None] + 1e-6))
        moving_factor *= decay

    # Rescale so moving points sit at `ratio` of the radius on average
    r = np.sqrt(np.sum(kernel_points ** 2, axis=-1))
    kernel_points *= ratio / np.mean(r[:, 1:])
    return kernel_points * radius, np.max(grad_norms, axis=1)


def load_kernels(radius: float, num_kpoints: int, dimension: int,
                 fixed: str, lloyd: bool = False,
                 rng: np.random.Generator | None = None,
                 dispositions_dir: str | None = None) -> np.ndarray:
    """The cached disposition of `num_kpoints` points (generated and
    written on a miss: `spherical_lloyd` when `lloyd` or above 30 points,
    else the best of `optimize_kernel_points`' candidates) scaled to
    `radius`, rotated about the vertical axis and jittered with
    N(0, 0.01), drawing from `rng` in the same order as the JAX package.
    Returns float32 [num_kpoints, dimension]."""
    rng = rng or np.random.default_rng()
    kernel_dir = dispositions_dir or _DISPOSITION_DIR
    if not exists(kernel_dir):
        makedirs(kernel_dir)
    if num_kpoints > 30:
        lloyd = True
    kernel_file = join(kernel_dir,
                       f"k_{num_kpoints:03d}_{fixed:s}_{dimension:d}D.ply")
    if not exists(kernel_file):
        if lloyd:
            kernel_points = spherical_lloyd(
                1.0, num_kpoints, dimension=dimension, fixed=fixed, rng=rng)
        else:
            candidates, grad_norms = optimize_kernel_points(
                1.0, num_kpoints, num_kernels=100, dimension=dimension,
                fixed=fixed, rng=rng)
            kernel_points = candidates[np.argmin(grad_norms)]
        write_ply(kernel_file, kernel_points.astype(np.float32),
                  ["x", "y", "z"][:dimension] if dimension <= 3
                  else [f"c{i}" for i in range(dimension)])
    else:
        data = read_ply(kernel_file)
        names = data.dtype.names
        kernel_points = np.vstack([data[n] for n in names[:dimension]]).T

    R = np.eye(dimension)
    theta = rng.random() * 2 * np.pi
    if dimension == 2 and fixed != "vertical":
        c, s = np.cos(theta), np.sin(theta)
        R = np.array([[c, -s], [s, c]])
    elif dimension == 3:
        if fixed != "vertical":
            c, s = np.cos(theta), np.sin(theta)
            R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        else:
            phi = (rng.random() - 0.5) * np.pi
            u = np.array([np.cos(theta) * np.cos(phi),
                          np.sin(theta) * np.cos(phi),
                          np.sin(phi)])
            alpha = rng.random() * 2 * np.pi
            R = create_3d_rotations(u[None], np.array([alpha]))[0]

    kernel_points = kernel_points + rng.normal(scale=0.01,
                                               size=kernel_points.shape)
    kernel_points = radius * kernel_points
    return np.matmul(kernel_points, R).astype(np.float32)
