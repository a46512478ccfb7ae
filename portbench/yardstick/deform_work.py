"""The deformable chain of a training step: its device time between the
program's marks, and the operations and bytes of its work from the
program's counters.

Time. The program brackets each deformable conv's plain chain with
empty kernels (`deform_fwd_begin` ... `deform_fwd_end` in the forward,
`deform_bwd_begin` ... `deform_bwd_end` in the backward), which a device
trace of a graph replay shows. A bracket runs from a begin mark's end to
the next end mark's start of its direction; an end mark with no open
begin, and a begin that the next begin of its direction or the
stretch's end leaves open, bracket nothing. The chain's time is the
union of the device intervals inside the brackets (the marks left out).

Work. The program's span table counts, per chain and direction,
`deform.<fwd|bwd>.<part>` (weasal_tpu_torch/ops/kpconv.chain_work):
`calls`; `pairs`, rows K Kp (rows = B Nq at the plan's padded widths,
as `reference/work_log.py` counts rows); `aggregate`, rows K Kp Cin;
`gemm`, rows Kp Cin Cout; `in_elems` and `out_elems`. The count is of
the algorithm, whatever implements it:
- forward: the aggregate (2 rows K Kp Cin) and the GEMM (2 rows Kp Cin
  Cout) as products at the TF32 peak; per pair the influence
  (work.INFLUENCE_OPS), the in-range test, its reduction over the kernel
  points and the mask's product (3), and the minimum over the neighbors
  (1) as f32 operations; bytes: each input read once, each output
  written once, 4 bytes an element, none of the [B, Nq, K, Kp, 3]
  intermediates;
- backward: the two products of each of the forward's (the aggregate's
  gradients to the influences and to the features, the GEMM's to the
  aggregate and to the weights); per pair the forward's operations
  again (it keeps none, as `work.py` counts kernel C) and the gradient
  to the deformed kernel points (BWD_PAIR_OPS: the influence's slope,
  the mask, the minimum's share, three products with the differences
  and two of the three sums over the neighbors' axis, counted once a
  pair); bytes: the forward's inputs and the outputs' gradients in, the
  inputs' gradients out.
A direction's bound is `work.bound_s` of its summed work (the largest of
bytes, products and other operations at their peaks); the step's is the
two directions' sum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from portbench.yardstick.work import F32, INFLUENCE_OPS, bound_s

# (begin, end) mark names of each direction
MARKS = (("deform_fwd_begin", "deform_fwd_end"),
         ("deform_bwd_begin", "deform_bwd_end"))
PREFIX = "deform."
# The counters of each direction
PARTS = ("calls", "pairs", "aggregate", "gemm", "in_elems", "out_elems")
# f32 operations a pair: the in-range test, its reduction and the mask's
# product; the minimum over the neighbors
FWD_PAIR_OPS = INFLUENCE_OPS + 3 + 1
BWD_PAIR_OPS = 8

Interval = Tuple[str, float, float]


def _mark(name: str) -> Optional[Tuple[int, int]]:
    """(direction, 0 begin | 1 end) of a mark's kernel name, else None."""
    for d, pair in enumerate(MARKS):
        for side, mark in enumerate(pair):
            if mark in name:
                return d, side
    return None


def brackets(device: Sequence[Interval]) -> List[Tuple[float, float]]:
    """The chain's brackets among the device intervals (by start), merged
    where they overlap."""
    opened: Dict[int, float] = {}
    found = []
    for name, start, end in sorted(device, key=lambda r: r[1]):
        m = _mark(name)
        if m is None:
            continue
        d, side = m
        if side == 0:
            opened[d] = end
        elif d in opened:
            found.append((opened.pop(d), start))
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(found):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
        else:
            merged.append((lo, hi))
    return merged


def chain_us(device: Sequence[Interval]) -> Optional[float]:
    """The union (us) of the device intervals inside the brackets; None
    where no bracket closes."""
    windows = brackets(device)
    if not windows:
        return None
    work = sorted(((s, e) for name, s, e in device if _mark(name) is None))
    total = 0.0
    for lo, hi in windows:
        reach = lo
        for s, e in work:
            if e <= reach or s >= hi:
                continue
            s = max(s, reach)
            reach = min(max(e, reach), hi)
            total += max(reach - s, 0.0)
    return total


def counted(spans: Dict[str, Dict[str, float]]) -> Dict[str, int]:
    """The chain's counters of a span table ({name: {"count", ...}})."""
    return {k[len(PREFIX):]: int(v["count"]) for k, v in spans.items()
            if k.startswith(PREFIX)}


def chain_work(counts: Dict[str, float], backward: bool
               ) -> Dict[str, float]:
    """{"products", "other", "bytes"} of the counts of one direction
    ({part: n} of `counted`, less its "fwd." / "bwd." prefix)."""
    aggregate, gemm = 2.0 * counts["aggregate"], 2.0 * counts["gemm"]
    pairs = float(counts["pairs"])
    products = aggregate + gemm
    other = pairs * FWD_PAIR_OPS
    if backward:
        products *= 2
        other += pairs * BWD_PAIR_OPS
    return dict(products=products, other=other,
                bytes=F32 * float(counts["in_elems"] + counts["out_elems"]))


def step_bound_s(counts: Dict[str, int], steps: int) -> Optional[float]:
    """The least seconds of one step's chains on one H100: each
    direction's `bound_s` of its counts over `steps`, summed; None where
    a direction lacks a counter."""
    total = 0.0
    for d, backward in (("fwd", False), ("bwd", True)):
        part = {k.split(".", 1)[1]: v / steps for k, v in counts.items()
                if k.startswith(d + ".")}
        if not part.get("calls") or not set(PARTS) <= set(part):
            return None
        total += bound_s(chain_work(part, backward))[0]
    return total


def chain_ms(record: Dict) -> Optional[float]:
    """Device ms a training step inside the brackets, over the traced
    stretch's steps; None without a stretch or a bracket."""
    from portbench.yardstick.layers import _stretch
    st = _stretch(record, "train")
    us = None if st is None else chain_us(st["device"])
    return None if us is None else us / 1e3 / st["units"]


def roofline(record: Dict) -> Optional[float]:
    """% of `chain_ms` that the step's bound, from the program's counters
    over the window's steps, accounts for; None without either."""
    from portbench.yardstick.spans import window_spans
    ms = chain_ms(record)
    spans = window_spans()
    if not ms or spans is None or record.get("steps", 0) <= 0:
        return None
    bound = step_bound_s(counted(spans), record["steps"])
    return None if bound is None else 100.0 * bound * 1e3 / ms
