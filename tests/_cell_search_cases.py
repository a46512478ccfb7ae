"""Point sets built to break kernel A's column rule (radius search by
columns of a 2-D grid, weasal_tpu_torch/csrc/radius_search.cu), shared by
the CPU test of the rule (tests/test_torch_cell_search.py) and the card
tests (tests/test_torch_cuda.py). Imports no JAX: the card's machine has
none. Each function takes a numpy Generator and the radius and returns
numpy (queries [B,Nq,3], supports [B,Ns,3], q_mask, s_mask); `CASES` maps
a name to (function, radius, K).
"""

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda.radius_search import support_grid


def as_tensors(q, s, qm, sm):
    return (torch.from_numpy(np.ascontiguousarray(q, np.float32)),
            torch.from_numpy(np.ascontiguousarray(s, np.float32)),
            torch.from_numpy(np.ascontiguousarray(qm, bool)),
            torch.from_numpy(np.ascontiguousarray(sm, bool)))


def _masks(rng, b, nq, ns, p=0.1):
    return rng.random((b, nq)) > p, rng.random((b, ns)) > p


def lattice(rng, radius):
    """Points of a lattice of spacing r (exact distance ties at r, r*sqrt2,
    ...), queried at lattice points and at half-offsets."""
    g = np.stack(np.meshgrid(np.arange(-6, 7), np.arange(-6, 7),
                             np.arange(0, 3), indexing="ij"), -1)
    s = (g.reshape(-1, 3) * np.float32(radius)).astype(np.float32)
    q = np.concatenate([s[::3], s[1::5] + np.float32(radius / 2)])
    s, q = s[None].repeat(2, 0), q[None].repeat(2, 0)
    return (q, s, *_masks(rng, 2, q.shape[1], s.shape[1]))


def ulp_shell(rng, radius):
    """Supports at f32 steps around distance r from queries placed far
    from the origin (so that the differences round), along the axes and
    the diagonals: the f32 test keeps some and drops their neighbors one
    ulp out."""
    centers = np.array([[17.3, -4.1, 2.0], [-21.7, 13.9, 0.5],
                        [0.01, 0.02, 0.0]], np.float32)
    dirs = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [1, 1, 0], [-1, 1, 0], [1, -1, 1], [0, 0, 1]],
                    np.float64)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    pts = []
    for c in centers:
        for d in dirs:
            p = (c.astype(np.float64) + radius * d).astype(np.float32)
            for step in range(-3, 4):
                axis = int(np.argmax(np.abs(d)))
                v = p.copy()
                for _ in range(abs(step)):
                    v[axis] = np.nextafter(v[axis], np.float32(
                        np.sign(step) * np.sign(d[axis]) * np.inf))
                pts.append(v)
    s = np.stack(pts)[None]
    q = centers[None]
    return (q, s, np.ones((1, 3), bool), np.ones((1, s.shape[1]), bool))


def _step(v, direction):
    return np.nextafter(np.float32(v), np.float32(direction * np.inf))


def column_boundaries(rng, radius):
    """Supports on the first f32 value of a column and one step below it,
    and queries one radius away across that boundary (in x and in y, from
    either side, at r and r -+ 1 ulp): a reach a hair short of r, or a
    column index computed another way for queries than for supports,
    misses some of them. Four frame points fix the grid."""
    frame = np.array([[-20, -20, 0], [20, 20, 0], [-20, 20, 0],
                      [20, -20, 0]], np.float32)
    ones = np.ones((1, 4), bool)
    x0, y0, inv_h, _ = (np.float32(v[0]) for v in support_grid(
        *as_tensors(frame[None], frame[None], ones, ones)[1::2], radius))

    def col(v, origin):
        return np.floor(np.float32(np.float32(v) - origin) * inv_h)

    def first_of(i, origin):
        v = np.float32(origin + np.float32(i) / inv_h)
        while col(v, origin) >= i:
            v = _step(v, -1)
        while col(v, origin) < i:
            v = _step(v, 1)
        return v

    r = np.float32(radius)
    reach = (_step(r, -1), r, _step(r, 1))
    s, q = list(frame), []
    for axis, origin in ((0, x0), (1, y0)):
        for i in range(3, 60, 4):
            edge = first_of(i, origin)
            for v in (edge, _step(edge, -1)):
                p = np.array([rng.uniform(-15, 15)] * 2 + [0.0], np.float32)
                p[axis] = v
                s.append(p)
                for t in reach:
                    for sign in (1, -1):
                        c = p.copy()
                        c[axis] = np.float32(v + np.float32(sign * t))
                        q.append(c)
    s, q = np.stack(s)[None], np.stack(q)[None]
    return (q, s, np.ones(q.shape[:2], bool), np.ones(s.shape[:2], bool))


def wide_extent(rng, radius):
    """A 300 m sphere (wider than GRID_SIDE * r) of clustered points, so
    that the column side grows beyond the reach."""
    centers = rng.uniform(-150, 150, (40, 3)).astype(np.float32)
    centers[:, 2] = 0
    s = (centers[rng.integers(0, 40, 1500)]
         + rng.normal(0, radius, (1500, 3))).astype(np.float32)
    q = (s[rng.permutation(1500)[:300]]
         + rng.normal(0, radius / 3, (300, 3))).astype(np.float32)
    q, s = q[None].repeat(2, 0), s[None].repeat(2, 0)
    return (q, s, *_masks(rng, 2, 300, 1500))


def one_column(rng, radius):
    """Every point in one column: a 5 cm square in (x, y), 0-3 m in z."""
    s = np.concatenate([rng.uniform(4.0, 4.05, (1, 700, 2)),
                        rng.uniform(0, 3, (1, 700, 1))], -1).astype(
                            np.float32)
    q = s[:, ::5].copy()
    return (q, s, *_masks(rng, 1, q.shape[1], 700))


def empty_spheres(rng, radius):
    """Three spheres: a normal one, one whose supports are all masked,
    one with no valid query or support."""
    s = rng.uniform(-3, 3, (3, 400, 3)).astype(np.float32)
    q = s[:, :150] + np.float32(0.01)
    qm, sm = _masks(rng, 3, 150, 400)
    sm[1] = False
    qm[2] = sm[2] = False
    return q, s, qm, sm


def random_sphere(rng, radius):
    s = rng.uniform(-4, 4, (2, 500, 3)).astype(np.float32)
    s[..., 2] *= 0.2
    q = s[:, rng.permutation(500)[:200]] + rng.normal(
        0, 0.1, (2, 200, 3)).astype(np.float32)
    return (q, s, *_masks(rng, 2, 200, 500))


CASES = {
    "lattice-r0.5": (lattice, 0.5, 30),
    "lattice-r0.6": (lattice, 0.6, 30),
    "ulp-shell": (ulp_shell, 0.6, 64),
    "column-boundaries": (column_boundaries, 0.6, 20),
    "wide-extent": (wide_extent, 0.5, 16),
    "one-column": (one_column, 0.3, 256),
    "empty-and-masked": (empty_spheres, 0.9, 12),
    "k1": (random_sphere, 0.8, 1),
    "k256": (random_sphere, 2.5, 256),
}
