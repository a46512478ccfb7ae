"""Operations and bytes of the work the port's kernels B and C do, and the
model FLOPs of a step, computed from shapes.

The counts are of the algorithm, not of an implementation: each input
is read once and each output written once, and a product of M x K by
K x N counts 2MNK once, whatever split of it the card runs (the GEMM
core's 3xTF32 is not counted three times). Rows are the rows the captured
graph computes: the calibrated plan's padded widths, shadow rows
included.

KPConv of a conv with M query rows, H neighbors a row, Kp kernel points,
Cin -> Cout channels and Ns support rows:
- forward (kernel B): influences, M H Kp (INFLUENCE_OPS); aggregation
  y = sum_h infl * x, 2 M H Kp Cin; the product y @ W, 2 M (Kp Cin) Cout.
  Bytes: x, the support and query points, the neighbor indices, the
  kernel points and W in; the output out.
- backward (kernel C): the influences and y again (the forward keeps
  neither), dW = y^T g and g W^T, two products of 2 M (Kp Cin) Cout, and
  where the input needs a gradient its dX contributions,
  2 M H Kp Cin. Bytes: the forward's inputs and g in; dW and dX out.
A linear map of `rows` x Cin -> Cout is 2 rows Cin Cout.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from portbench.yardstick.peaks import (F32_FLOP_PER_S, HBM_BYTES_PER_S,
                                       TF32_FLOP_PER_S)

F32 = 4
# Operations of one neighbor's influence on one kernel point: 3
# differences, 3 squares, 2 adds, a square root, a division by the
# extent, a subtraction from 1 and a clamp at 0
INFLUENCE_OPS = 12


def conv_bytes(c: Dict, backward: bool) -> float:
    n_in = (c["supports"] * (c["cin"] + 3) + c["rows"] * 3
            + c["rows"] * c["neighbors"] + c["kernel_points"] * 3
            + c["kernel_points"] * c["cin"] * c["cout"])
    if not backward:
        return F32 * (n_in + c["rows"] * c["cout"])
    n_out = c["kernel_points"] * c["cin"] * c["cout"]
    if c["need_dx"]:
        n_out += c["supports"] * c["cin"]
    return F32 * (n_in + c["rows"] * c["cout"] + n_out)


def conv_work(c: Dict, backward: bool = False) -> Dict[str, float]:
    """{"products", "other", "bytes"} of one call of kernel B (forward)
    or C (backward) on conv `c` (a `work_log` record)."""
    m, h, kp = c["rows"], c["neighbors"], c["kernel_points"]
    cin, cout = c["cin"], c["cout"]
    influences = m * h * kp * INFLUENCE_OPS
    aggregate = 2.0 * m * h * kp * cin
    product = 2.0 * m * kp * cin * cout
    if not backward:
        return dict(products=product, other=influences + aggregate,
                    bytes=conv_bytes(c, False))
    other = influences + aggregate + (aggregate if c["need_dx"] else 0.0)
    return dict(products=2 * product, other=other,
                bytes=conv_bytes(c, True))


def bound_s(work: Dict[str, float]) -> Tuple[float, str]:
    """(least seconds, what bounds it) of `work` on one H100: its bytes
    at the HBM's rate, its products at the TF32 tensor-core peak, its
    other f32 operations at the CUDA cores' peak; the largest."""
    parts = {"bytes": work["bytes"] / HBM_BYTES_PER_S,
             "products": work["products"] / TF32_FLOP_PER_S,
             "other": work["other"] / F32_FLOP_PER_S}
    by = max(parts, key=parts.get)
    return parts[by], by


def kpconv_bound_s(calls: Iterable[Tuple[str, Dict]],
                   training: bool) -> float:
    """Summed bounds of the kernel B (and, training, C) calls of one step
    or batch."""
    total = 0.0
    for kind, c in calls:
        if kind != "conv":
            continue
        total += bound_s(conv_work(c))[0]
        if training:
            total += bound_s(conv_work(c, backward=True))[0]
    return total


def model_flops(calls: Iterable[Tuple[str, Dict]], training: bool) -> float:
    """Model FLOPs of one step or batch: KPConv's aggregations and weight
    products and the linear maps, forward, plus, training, twice each
    product for the backward (dX and dW); recomputation not counted."""
    total = 0.0
    for kind, c in calls:
        if kind == "conv":
            product = 2.0 * c["rows"] * c["kernel_points"] * c["cin"] \
                * c["cout"]
            total += 2.0 * c["rows"] * c["neighbors"] \
                * c["kernel_points"] * c["cin"] + product
        else:
            product = 2.0 * c["rows"] * c["cin"] * c["cout"]
            total += product
        if training:
            total += 2 * product
    return total
