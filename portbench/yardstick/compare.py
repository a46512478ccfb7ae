"""The numbers that decide `correct`, and the control's precision.

Training (the steps the reference follows, from the same weights and
inputs):
- `loss_gap`: the largest |loss_program - loss_reference| / |loss_reference|
  over the followed steps;
- `grad_gap`: the first gradient as the optimizer gets it (clipped, from
  the momentum after step 1 less weight decay times the weights), by the
  worst leaf: the gap between the program's norm and the reference's,
  over the larger of that leaf's reference norm and the median leaf's;
- `step_gap`: the parameters' change after the followed steps, by the
  worst leaf, the same way.
Leaves whose reference gradient is under `NOUGHT` of the median leaf's
(gradients nought to rounding, which move by weight decay alone) are left
out of both, by that rule and not by name.

Voting: `probs_gap`, the largest |p_program - p_reference| over the real
points of the sampled batches, and `vote_gap`, the largest difference of
the vote buffer after those batches' updates.

Every cell: `resident_mismatch`, the entries of the program's resident
clouds that differ from the reference's own subsample of the raw tile.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

NOUGHT = 1e-3


def counted_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient norm is at least NOUGHT of the
    median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    return sorted(k for k, n in norms.items() if n >= NOUGHT * med)


def leaf_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor],
              leaves: Iterable[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, |norm_program - norm_reference|, over
    the larger of that leaf's reference norm and the median leaf's."""
    leaves = list(leaves)
    ref = {k: float(reference[k].double().norm()) for k in leaves}
    got = {k: float(program[k].double().norm()) for k in leaves}
    med = statistics.median(ref.values())
    return {k: abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in leaves}


def worst(gaps: Dict[str, float], n: int) -> List[Tuple[str, float]]:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


def median(gaps: Dict[str, float]) -> float:
    return statistics.median(gaps.values())


def loss_gap(program: List[float], reference: List[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        checks[name] = {"value": (float("nan") if value is None
                                  else float(value)),
                        "limit": float(limit)}
    return ok, checks


# ----------------------------------------------------------------------
# The control: the reference in TF32
# ----------------------------------------------------------------------

def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits (to nearest, ties to even)."""
    if t.dtype != torch.float32:
        return t
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32Products(TorchDispatchMode):
    """Products whose f32 inputs are rounded to TF32 (f32 accumulation):
    what the card's TF32 mode computes, on any device."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            args = tuple(to_tf32(a) if isinstance(a, torch.Tensor) else a
                         for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32_products(device: torch.device):
    """The control's precision: on the card, cuBLAS in TF32 (every
    product, the backward's in autograd's own thread included); on the
    CPU, the same rounding of the products' inputs by a dispatch mode."""
    if device.type == "cuda":
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old
        return
    with _TF32Products():
        yield
