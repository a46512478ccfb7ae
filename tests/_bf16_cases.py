"""The flip criterion that holds a result of compute_dtype "bfloat16" to a
reference that sums in another order (JAX-free: the CPU tests, the card
tests and chip_smoke.py import it).

A bf16 intermediate (KPConv's aggregate y, dW, a slot's gradient) is an
f32 sum rounded to bf16. Two implementations sum in different orders, so
where the f32 sum lands near a rounding boundary their bf16 values differ
by one bf16 ulp (2^-8 relative); elsewhere they are equal. Where the sum
cancels (a result far smaller than the sum of its terms' magnitudes, as
in dW's sums over 17k rows of both signs) the two f32 sums differ by
their rounding at the terms' scale, which can exceed a bf16 ulp of the
result: with the terms' absolute sum T given, a result is measured at no
less than CANCEL_SCALE * T, where one bf16 ulp (2^-16 T) exceeds that
rounding (about 2^-24 sqrt(depth) T). The criterion: every element that
differs lies within one bf16 ulp of the larger of the two magnitudes
(and CANCEL_SCALE * T), and no more elements differ than FLIP_SHARE_MAX
of them allows, with three standard deviations of counting noise (a
dW of 3,840 elements may show 5 flips where 1e-3 expects 4). The f32
results computed from those intermediates (KPConv's output, dX) are held
to a relative L2 error of OUT_REL_L2_MAX against JAX; on the card, where
C's products are f32-grade but not f32-exact (more of the roundings of
sums that cancel turn), their distance to an f64 evaluation of the same
rounding points may reach REF_RATIO times the plain version's where that
passes OUT_REL_L2_MAX (`within_plain`).
"""

from __future__ import annotations

import numpy as np
import torch

FLIP_SHARE_MAX = 1e-3
OUT_REL_L2_MAX = 1e-4
CANCEL_SCALE = 2.0 ** -8
REF_RATIO = 2.0


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64)
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def bf16_ulp(m: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at magnitudes m (f64): 2^(floor(log2 m) - 7)."""
    e = torch.floor(torch.log2(m.clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def is_bf16_valued(x) -> bool:
    """Every element of x is a bf16 value."""
    t = _tensor(x).float()
    return bool(torch.equal(t, t.to(torch.bfloat16).float()))


def flips(got, want, terms=None) -> dict:
    """The elements of two bf16-valued arrays that differ (`differ`, a
    `share` of `n`), and how many of them differ by more than one bf16 ulp
    of the larger magnitude (`beyond`); `terms`, where given, the sums of
    the terms' magnitudes, whose CANCEL_SCALE is the least magnitude
    measured."""
    g, w = _tensor(got), _tensor(want)
    if g.shape != w.shape:
        raise ValueError(f"shapes differ: {tuple(g.shape)} {tuple(w.shape)}")
    differ = g != w
    mag = torch.maximum(g.abs(), w.abs())
    if terms is not None:
        mag = torch.maximum(mag, CANCEL_SCALE * _tensor(terms).abs())
    beyond = differ & ((g - w).abs() > bf16_ulp(mag))
    n = max(w.numel(), 1)
    return dict(share=float(differ.sum()) / n, differ=int(differ.sum()),
                beyond=int(beyond.sum()), n=w.numel())


def flip_allowance(n: int) -> float:
    """The most elements of n that may differ: FLIP_SHARE_MAX of them and
    three standard deviations of a count of that mean."""
    mean = FLIP_SHARE_MAX * n
    return mean + 3.0 * mean ** 0.5 + 1.0


def flips_ok(report: dict) -> bool:
    return (report["beyond"] == 0
            and report["differ"] <= flip_allowance(report["n"]))


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in f64 (0 for two zero arrays)."""
    g, w = _tensor(got), _tensor(want)
    norm = float(w.norm())
    diff = float((g - w).norm())
    return diff / norm if norm > 0 else diff


def within_plain(got, plain, ref) -> dict:
    """`got`'s relative L2 distance to `ref` (an f64 evaluation of the
    same rounding points) beside the plain version's; ok within REF_RATIO
    of it or within OUT_REL_L2_MAX."""
    err, err_plain = rel_l2(got, ref), rel_l2(plain, ref)
    return dict(rel_l2=err, plain_rel_l2=err_plain,
                ok=err <= max(REF_RATIO * err_plain, OUT_REL_L2_MAX))
