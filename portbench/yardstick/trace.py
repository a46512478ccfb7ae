"""Readers of torch.profiler's events: device intervals, their union,
kernel families and the host range open during each idle gap.

A frozen copy of the interval and family arithmetic of
weasal_tpu_torch/utils/profiling.py (`named_intervals`, `union_us`,
`FAMILIES`, `categorize_op`) and of the kernel names by which chip_smoke.py
counted each wrapper's calls (`OBSERVED_KERNEL`), reading the profiler's
events in memory instead of a Chrome trace file.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# A split-K sum launch of the GEMM core is named after the tile kernel
# launched before it
SPLITK_SUM = "splitk_sum_kernel"
GEMM_TILES = ("tf32x3_gemm_kernel", "bf16_gemm_kernel")

# Kernel families: (label, substrings of the kernel name); the first
# match wins, anything else is "other"
FAMILIES = (
    ("A radius_search", ("bin_supports_kernel", "search_kernel")),
    ("B aggregate", ("aggregate_kernel",)),
    ("B GEMM y@W (3xTF32)", ("tf32x3_gemm_kernel<true, false,",)),
    ("B GEMM y@W (bf16)", ("bf16_gemm_kernel",)),
    ("B bf16 cast of W", ("cast_transpose_bf16_kernel",)),
    ("C GEMM g@W^T (3xTF32)", ("tf32x3_gemm_kernel<true, true,",)),
    ("C dX contributions", ("dx_contrib_kernel",)),
    ("C, D dX row sums", ("inverse_sum_kernel",)),
    ("row sums (gathers, voxels)", ("list_sum_kernel", "run_sum_kernel")),
    ("inverse lists", ("inverse_build_kernel",)),
    ("C GEMM y^T@g (3xTF32)", ("tf32x3_gemm_kernel<false, false,",)),
    ("D maxpool_bwd", ("maxpool_bwd_kernel",)),
    ("collective", ("nccl",)),
    ("cuBLAS/CUTLASS GEMMs", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce_kernel",)),
    ("softmax", ("SoftMax",)),
    ("gathers, scatters, index", ("gather", "scatter", "index")),
    ("sorts", ("sort", "Sort", "radix")),
    ("copies, fills", ("Memcpy", "Memset", "copy", "fill")),
    ("elementwise", ("elementwise",)),
)
# The families of kernels B and C (their GEMM core products included)
KPCONV_FAMILIES = ("B aggregate", "B GEMM y@W (3xTF32)", "B GEMM y@W (bf16)",
                   "B bf16 cast of W", "C GEMM g@W^T (3xTF32)",
                   "C dX contributions", "C GEMM y^T@g (3xTF32)")
# The families of the program's hand-written kernels (A-D, the inverse
# lists and the row sums) and its collectives; the rest is plain PyTorch
KERNEL_FAMILIES = KPCONV_FAMILIES + (
    "A radius_search", "C, D dX row sums", "row sums (gathers, voxels)",
    "inverse lists", "D maxpool_bwd", "collective")
# One kernel name a call of each counted wrapper launches once
OBSERVED_KERNEL = {"radius_search": ("search_kernel",),
                   "kpconv_fwd": ("aggregate_kernel",),
                   "kpconv_bwd": ("tf32x3_gemm_kernel<false, false,",),
                   "maxpool_bwd": ("maxpool_bwd_kernel",),
                   "build_inverse_lists": ("inverse_build_kernel",),
                   "inverse_sum": ("list_sum_kernel", "run_sum_kernel")}

Interval = Tuple[str, float, float]


def named_intervals(intervals: Iterable[Interval]) -> List[Interval]:
    """(name, start, end) by start; a split-K sum is named
    "splitk_sum_kernel after <the tile kernel before it>"."""
    out, tile = [], ""
    for name, start, end in sorted(intervals, key=lambda r: r[1]):
        if any(t in name for t in GEMM_TILES):
            tile = name
        elif SPLITK_SUM in name:
            name = f"{SPLITK_SUM} after {tile}"
        out.append((name, start, end))
    return out


def union_us(named: Sequence[Interval],
             window: Optional[Tuple[float, float]] = None) -> float:
    """The length of the union of the intervals (by start); with `window`
    only of their parts inside it."""
    lo, hi = window if window is not None else (float("-inf"),
                                                float("inf"))
    busy, reach = 0.0, lo
    for _, start, end in named:
        start = max(start, reach)
        reach = max(min(end, hi), reach)
        busy += max(reach - start, 0.0)
    return busy


def categorize_op(name: str) -> str:
    """The family of a device event's name; a split-K sum belongs to its
    tile's family."""
    return next((label for label, keys in FAMILIES
                 if any(k in name for k in keys)), "other")


def family_us(named: Sequence[Interval]) -> Dict[str, float]:
    """Summed device time (us) by family."""
    sums: Dict[str, float] = {}
    for name, start, end in named:
        fam = categorize_op(name)
        sums[fam] = sums.get(fam, 0.0) + (end - start)
    return sums


def observed_calls(named: Sequence[Interval]) -> Dict[str, int]:
    """Calls of each counted wrapper that the device events show."""
    return {fn: sum(1 for name, _, _ in named
                    if any(key in name for key in keys)
                    and not name.startswith(SPLITK_SUM))
            for fn, keys in OBSERVED_KERNEL.items()}


def idle_gaps(named: Sequence[Interval], window: Tuple[float, float],
              ranges: Sequence[Interval]) -> Dict[str, float]:
    """Idle device time (us) inside `window`, by the name of the host
    range (`record_function`) open at the gap's middle ("host" where
    none is)."""
    gaps, reach = [], window[0]
    for _, start, end in named:
        if start > reach:
            gaps.append((reach, min(start, window[1])))
        reach = max(reach, end)
        if reach >= window[1]:
            break
    if reach < window[1]:
        gaps.append((reach, window[1]))
    out: Dict[str, float] = {}
    for lo, hi in gaps:
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        name = next((n for n, s, e in ranges if s <= mid <= e), "host")
        out[name] = out.get(name, 0.0) + (hi - lo)
    return out


def profiler_intervals(events, ranges: Sequence[str]
                       ) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, the host ranges named in `ranges`) in us of
    torch.profiler's FunctionEvents."""
    device, host = [], []
    for e in events:
        on_device = str(e.device_type).endswith("CUDA")
        if on_device and e.self_device_time_total > 0 and \
                not getattr(e, "is_user_annotation", False):
            device.append((e.key, e.time_range.start, e.time_range.end))
        elif not on_device and e.name in ranges:
            host.append((e.name, e.time_range.start, e.time_range.end))
    return named_intervals(device), sorted(host, key=lambda r: r[1])
