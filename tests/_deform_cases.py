"""Inputs of the deformable chain's pair work and the comparison of its
kernels with the plain chain. JAX-free: shared by the CPU tests
(tests/test_torch_deform_fused.py), the card tests
(tests/test_torch_cuda.py) and chip_smoke.py's phase 11."""

import numpy as np
import torch

from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda import deform_kpconv as dk

EXT = 0.5


def planted_case(dtype, kp=4, k=7, cin=3, cout=2, nq=5, ns=9, seed=0):
    """Dyadic inputs (exact in f32 and f64) of two spheres. Row (0, 0)
    has deformed kernel points d0 (0, 0, 0), d1 (0.25, 0, 0), d2 (0, 0.5,
    0), d3 (-0.5, -0.5, 0.25) around its query; slot 0 at (0.5, 0, 0)
    lies exactly at d0's extent (1 - sqrt(d2) / ext = 0, outside d0's
    range) and inside d1's; slots 1 and 2 tie for d2's minimum; slots 4..
    are shadows. Row (1, nq - 1) is all shadows; the others draw their
    neighbors (shadows among them) at random."""
    rng = np.random.default_rng(seed)

    def grid(lim, size, step):
        n = int(lim / step)
        return rng.integers(-n, n + 1, size) * step

    b = 2
    q = grid(1.0, (b, nq, 3), 1 / 32)
    s = grid(1.0, (b, ns, 3), 1 / 32)
    kpts = grid(0.5, (kp, 3), 1 / 16)
    off = grid(0.25, (b, nq, kp, 3), 1 / 64)
    inds = rng.integers(0, ns + 1, (b, nq, k))
    q[0, 0] = (0.5, 0.25, 0.0)
    off[0, 0, :4] = np.array([(0, 0, 0), (0.25, 0, 0), (0, 0.5, 0),
                              (-0.5, -0.5, 0.25)]) - kpts[:4]
    for j, rel in enumerate([(0.5, 0, 0), (0.125, 0.5, 0),
                             (-0.125, 0.5, 0), (-0.25, -0.375, 0.125)]):
        s[0, j] = q[0, 0] + rel
        inds[0, 0, j] = j
    inds[0, 0, 4:] = ns
    inds[1, -1] = ns
    x = grid(1.0, (b, ns, cin), 1 / 64)
    w = grid(1.0, (kp, cin, cout), 1 / 64)
    mods = rng.uniform(0.1, 1.9, (b, nq, kp))
    g_out = grid(1.0, (b, nq, cout), 1 / 64)
    g_min = grid(1.0, (b, nq, kp), 1 / 64)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dtype)

    return dict(q=t(q), s=t(s), inds=torch.from_numpy(inds).to(torch.int32),
                kpts=t(kpts), off=t(off), x=t(x), w=t(w), mods=t(mods),
                g_out=t(g_out), g_min=t(g_min), ns=ns)


def seeded_case(dtype, seed=1):
    """Seeded f32-scale inputs at the deformable cell's 15 kernel points,
    spheres of radius 1.5 ext with shadow slots."""
    rng = np.random.default_rng(seed)
    b, nq, ns, k, kp, cin, cout = 2, 24, 30, 20, 15, 8, 6
    q = rng.uniform(-1, 1, (b, nq, 3))
    s = rng.uniform(-1, 1, (b, ns, 3))
    inds = rng.integers(0, ns + 1, (b, nq, k))
    inds[:, -2:] = ns

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dtype)

    return dict(q=t(q), s=t(s), inds=torch.from_numpy(inds).to(torch.int32),
                kpts=t(rng.uniform(-0.6, 0.6, (kp, 3))),
                off=t(rng.normal(0, 0.2, (b, nq, kp, 3))),
                x=t(rng.normal(size=(b, ns, cin))),
                w=t(rng.normal(size=(kp, cin, cout))),
                mods=t(rng.uniform(0.1, 1.9, (b, nq, kp))),
                g_out=t(rng.normal(size=(b, nq, cout))),
                g_min=t(rng.normal(size=(b, nq, kp))), ns=ns)


def run_chain(chain, c, params, inverse=None):
    """(out, min_sq, {name: gradient}) of `chain` (kpconv_dense,
    kpconv_fused or deformable_kpconv) on the case `c`, for the loss
    <out, g_out> + <min_sq, g_min>."""
    leaves = {n: c[n].clone().requires_grad_()
              for n in ("x", "off", "w", "mods")}
    out, min_sq = chain(
        c["q"], c["s"], c["inds"], leaves["x"], c["kpts"], leaves["w"],
        params, offsets=leaves["off"],
        modulations=leaves["mods"] if params.modulated else None,
        inverse=inverse)
    ((out * c["g_out"]).sum() + (min_sq * c["g_min"]).sum()).backward()
    grads = {n: t.grad for n, t in leaves.items() if t.grad is not None}
    return out.detach(), min_sq.detach(), grads



def chain_errors(c, params, inverse):
    """The kernels of a deformable conv against the plain chain on the
    card, on the case `c` (its tensors on the card): whether the in-range
    flags and the minima of `deform_pairs_fwd` equal `ops.in_range` and
    `ops.nearest` of the plain squared distances bit for bit, and the
    largest error of `kpconv_fused` against `kpconv_dense` (under
    `plain_ops`) relative to the largest value, for the output, the
    minima and the gradients of x, the offsets, the weights and the
    modulations (`run_chain`'s loss); and the share of the real slots
    inside the range (the slots whose dX and dot products the backward
    computes)."""
    from weasal_tpu_torch.utils.device import plain_ops
    with torch.no_grad():
        _, mins, mask = dk.deform_pairs_fwd(
            c["q"], c["s"], c["inds"], c["x"], c["kpts"], c["off"],
            params.kp_extent, params.influence, with_mask=True)
        _, d2 = dk.pair_geometry(c["q"], c["s"], c["inds"], c["kpts"],
                                 c["off"])
        equal = dict(in_range=torch.equal(mask,
                                          ops.in_range(d2, params.kp_extent)),
                     nearest=torch.equal(mins, ops.nearest(d2)))
        real = (c["inds"] >= 0) & (c["inds"] < c["s"].shape[1])
        share = float(mask[real].float().mean()) if bool(real.any()) else 0.0
    got = run_chain(ops.kpconv_fused, c, params, inverse)
    with plain_ops():
        want = run_chain(ops.kpconv_dense, c, params, inverse)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    errors = dict(out=rel(got[0], want[0]), min_sq=rel(got[1], want[1]))
    errors.update({f"d{n}": rel(got[2][n], want[2][n]) for n in want[2]})
    return equal, errors, share
