"""Kernel-point dispositions: load the shipped one and give it a random pose.

Counterpart of weasal_tpu/kernels/kernel_points.py `load_kernels` (:187)
and `create_3d_rotations` (:36). The disposition file
`dispositions/k_015_center_3D.ply` is a copy of the JAX package's; every
shipped config uses 15 kernel points fixed at the center. Generating a
new disposition is not ported, so other kernel sizes raise.
"""

from __future__ import annotations

from os.path import dirname, exists, join

import numpy as np

from weasal_tpu_torch.utils.ply import read_ply

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


def load_kernels(radius: float, num_kpoints: int, dimension: int,
                 fixed: str, rng: np.random.Generator | None = None,
                 dispositions_dir: str | None = None) -> np.ndarray:
    """Shipped disposition scaled to `radius`, rotated about the vertical
    axis and jittered with N(0, 0.01), drawing from `rng` in the same
    order as the JAX package. Returns float32 [num_kpoints, dimension]."""
    rng = rng or np.random.default_rng()
    kernel_file = join(dispositions_dir or _DISPOSITION_DIR,
                       f"k_{num_kpoints:03d}_{fixed:s}_{dimension:d}D.ply")
    if not exists(kernel_file):
        raise FileNotFoundError(
            f"no shipped kernel disposition {kernel_file}; generating "
            "dispositions is not ported")
    data = read_ply(kernel_file)
    kernel_points = np.vstack([data[n] for n in data.dtype.names[:dimension]]).T

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
