"""Phase timing on the host clock, and device traces and their readers.

Counterpart of weasal_tpu/utils/profiling.py:
- `StepTimer` (:18-62): exponential moving averages of named phases,
  shown at most once a display interval. On a card the host clock
  measures the enqueue unless a phase ends in a synchronization.
- `device_trace` (:64-85): a torch.profiler window (the CPU, and CUDA on
  a card) that writes a Chrome trace, `trace_<tag>.json`, into a
  directory. The trainer's `WEASAL_TRACE_DIR` window goes through it.
- the readers (:88-185): `module_times_us`, `op_self_times_us`,
  `categorize_op`, `stage_breakdown`, with the JAX contracts, reading
  that Chrome trace where the JAX ones read xplane.pb, and `busy_us`,
  the union of the kernels' intervals. A "module" here is a host range
  of `torch.profiler.record_function`: the port names its programs
  after the JAX ones that `bench.py` and `scripts/` filter on,
  `step_core` (one training-step body, train/step.step_body),
  `train_step_k` (one run of a StepGraph's K steps, a replay on the
  card) and `eval_step` (one eval body, or one EvalGraph replay).
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import itertools
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple


class StepTimer:
    """Exponential-moving-average phase timer.

        timer = StepTimer(["data", "step", "log"])
        with timer.phase("data"): ...
        if timer.should_display(): print(timer.summary())

    A phase's average starts at its first duration and smooths from the
    third pass of the last phase on."""

    def __init__(self, phases: List[str], smoothing: float = 0.9,
                 display_interval: float = 1.0):
        self.phases = phases
        self.smoothing = smoothing
        self.display_interval = display_interval
        self.ema: Dict[str, float] = {}
        self._last_display = time.time()
        self._count = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if name in self.ema and self._count >= 2:
            self.ema[name] = (self.smoothing * self.ema[name]
                              + (1 - self.smoothing) * dt)
        else:
            self.ema[name] = dt
        if name == self.phases[-1]:
            self._count += 1

    def should_display(self) -> bool:
        """True at most once a `display_interval` seconds."""
        if time.time() - self._last_display > self.display_interval:
            self._last_display = time.time()
            return True
        return False

    def summary(self) -> str:
        return " ".join(f"{p}={1000 * self.ema.get(p, 0):.1f}ms"
                        for p in self.phases)

    def total_ms(self) -> float:
        return 1000 * sum(self.ema.values())


# The names of `device_trace` files that a call gives (pid, call number)
_TRACE_CALLS = itertools.count()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = "weasal_trace",
                 enabled: bool = True, tag: Optional[str] = None):
    """A torch.profiler window: the CPU activity, plus CUDA where a card
    is present; yields the profile (None when disabled). On exit it
    synchronizes the card, stops the profiler and writes the Chrome trace
    to `log_dir/trace_<tag>.json` (tag: "<pid>_<n>" by default; no file
    with `log_dir` None, for a caller that reads the profile's events in
    memory: the export of a long window takes seconds). Raises where the
    profiler cannot start; does nothing when disabled."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    if tag is None:
        tag = f"{os.getpid()}_{next(_TRACE_CALLS)}"
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir,
                                                  f"trace_{tag}.json"))


# ---------------------------------------------------------------------------
# Chrome trace readers
# ---------------------------------------------------------------------------
# Device events are the kernels, copies and fills on the card; each
# carries the correlation id of the host call that launched it (a kernel
# of a CUDA graph replay, that of its cudaGraphLaunch)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# A split-K sum launch of the GEMM core (csrc/kpconv_common.cuh) is named
# after the tile kernel launched before it
SPLITK_SUM = "splitk_sum_kernel"
GEMM_TILES = ("tf32x3_gemm_kernel", "bf16_gemm_kernel")


def trace_events(trace_dir: str) -> List[dict]:
    """The complete ("X") events of every trace_*.json under trace_dir."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "trace_*.json"),
                             recursive=True))
    if not paths:
        raise RuntimeError(f"no trace_*.json under {trace_dir}")
    events = []
    for path in paths:
        with open(path) as f:
            events.extend(e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X")
    return events


def named_intervals(intervals: Iterable[Tuple[str, float, float]]
                    ) -> List[Tuple[str, float, float]]:
    """(name, start, end) of device events (from a Chrome trace, or from
    torch.profiler's own events), by start; a split-K sum is named
    "splitk_sum_kernel after <the tile kernel before it>"."""
    out, tile = [], ""
    for name, start, end in sorted(intervals, key=lambda r: r[1]):
        if any(t in name for t in GEMM_TILES):
            tile = name
        elif SPLITK_SUM in name:
            name = f"{SPLITK_SUM} after {tile}"
        out.append((name, start, end))
    return out


def device_events(events: Iterable[dict]) -> List[Tuple[str, float, float]]:
    """`named_intervals` (us) of a trace's kernels, copies and fills."""
    return named_intervals(
        (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events if e.get("cat") in DEVICE_CATEGORIES)


def rows_of(named) -> List[Tuple[str, int, float]]:
    """[(name, launches, summed ms)] of `named_intervals` in us, largest
    first."""
    sums: Dict[str, Tuple[int, float]] = {}
    for name, start, end in named:
        n, t = sums.get(name, (0, 0.0))
        sums[name] = (n + 1, t + (end - start) / 1e3)
    return sorted(((k, n, t) for k, (n, t) in sums.items()),
                  key=lambda r: -r[2])


def kernel_rows(trace_dir: str) -> List[Tuple[str, int, float]]:
    """[(device event name, launches, summed ms)] of a trace, largest
    first."""
    return rows_of(device_events(trace_events(trace_dir)))


def op_self_times_us(trace_dir: str) -> Dict[str, float]:
    """Summed device time (us) by kernel, copy or fill name over a trace
    (device events only; split-K sums named after their tile kernel)."""
    return {name: ms * 1e3 for name, _, ms in kernel_rows(trace_dir)}


def host_ranges(trace_dir: str, name_filter: str = ""
                ) -> List[Tuple[str, float, float]]:
    """(name, start us, end us) of the `record_function` ranges whose name
    holds `name_filter`, by start."""
    return sorted(((e["name"], float(e["ts"]),
                    float(e["ts"]) + float(e["dur"]))
                   for e in trace_events(trace_dir)
                   if e.get("cat") == "user_annotation"
                   and name_filter in e["name"]), key=lambda r: r[1])


def module_times_us(trace_dir: str, name_filter: str = "") -> List[float]:
    """One device duration (us) per execution of each named program: for
    each `record_function` range whose name holds `name_filter`, the span
    on the card from the first start to the last end of the device events
    launched inside it. Launches are found by time inside the range, on
    any thread of its process (a backward launches from autograd's
    thread), and tied to their device events by correlation id, so a
    CUDA graph replay counts every kernel of the graph. A range that
    launched nothing on the card gives no duration."""
    events = trace_events(trace_dir)
    launches = sorted((float(e["ts"]), e["pid"], e["args"]["correlation"])
                      for e in events
                      if e.get("cat") in LAUNCH_CATEGORIES
                      and "correlation" in e.get("args", {}))
    spans: Dict[int, Tuple[float, float]] = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in DEVICE_CATEGORIES and corr is not None:
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            lo, hi = spans.get(corr, (start, end))
            spans[corr] = (min(lo, start), max(hi, end))
    times = [t for t, _, _ in launches]
    out = []
    for e in sorted((e for e in events
                     if e.get("cat") == "user_annotation"
                     and name_filter in e["name"]), key=lambda e: e["ts"]):
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        window = launches[bisect.bisect_left(times, start):
                          bisect.bisect_right(times, end)]
        inside = [spans[c] for _, pid, c in window
                  if pid == e["pid"] and c in spans]
        if inside:
            out.append(max(h for _, h in inside) - min(l for l, _ in inside))
    return out


def union_us(named, window: Optional[Tuple[float, float]] = None
             ) -> float:
    """The length of the union of `named_intervals` (where kernels
    overlap, less than the sum of their times); with `window`, a (start,
    end) in their clock, of their parts inside it."""
    lo, hi = window if window is not None else (float("-inf"),
                                                float("inf"))
    busy, reach = 0.0, lo
    for _, start, end in named:
        start = max(start, reach)
        reach = max(min(end, hi), reach)
        busy += max(reach - start, 0.0)
    return busy


def busy_us(trace_dir: str, window: Optional[Tuple[float, float]] = None
            ) -> float:
    """The device's busy time (us) in a trace: `union_us` of its device
    events; `window` in the trace's clock (us)."""
    return union_us(device_events(trace_events(trace_dir)), window)


# Kernel families of the card's device time: (label, substrings of the
# kernel name); the first match wins, anything else is "other". The GEMM
# core's three products are named by the operand layouts <A K-major,
# B K-major> of its tile kernel, and come before the generic "gemm" match.
GEMM_FAMILIES = ("B GEMM y@W (3xTF32)", "C GEMM g@W^T (3xTF32)",
                 "C GEMM y^T@g (3xTF32)")
# B's product under compute_dtype "bfloat16" (the bf16 core)
BF16_GEMM_FAMILY = "B GEMM y@W (bf16)"
FAMILIES = (
    ("A radius_search", ("bin_supports_kernel", "search_kernel")),
    ("B aggregate", ("aggregate_kernel",)),
    (GEMM_FAMILIES[0], ("tf32x3_gemm_kernel<true, false,",)),
    (BF16_GEMM_FAMILY, ("bf16_gemm_kernel",)),
    ("B bf16 cast of W", ("cast_transpose_bf16_kernel",)),
    (GEMM_FAMILIES[1], ("tf32x3_gemm_kernel<true, true,",)),
    ("C dX contributions", ("dx_contrib_kernel",)),
    ("C, D dX row sums", ("inverse_sum_kernel",)),
    ("row sums (gathers, voxels)", ("list_sum_kernel", "run_sum_kernel")),
    ("inverse lists", ("inverse_build_kernel",)),
    (GEMM_FAMILIES[2], ("tf32x3_gemm_kernel<false, false,",)),
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


def categorize_op(name: str) -> str:
    """The family (FAMILIES label) of a device event's name; a split-K
    sum, named after its tile kernel, belongs to the tile's family."""
    return next((label for label, keys in FAMILIES
                 if any(k in name for k in keys)), "other")


def kernel_families(rows) -> List[Tuple[str, int, float]]:
    """[(family, launches, ms)] of `kernel_rows`, largest first."""
    sums: Dict[str, Tuple[int, float]] = {}
    for name, count, ms in rows:
        label = categorize_op(name)
        n, t = sums.get(label, (0, 0.0))
        sums[label] = (n + count, t + ms)
    return sorted(((k, n, t) for k, (n, t) in sums.items()),
                  key=lambda r: -r[2])


def stage_breakdown(trace_dir: str, steps: int) -> Dict[str, float]:
    """Device time (us a step) by family over a trace, largest first."""
    return {label: ms * 1e3 / steps
            for label, _, ms in kernel_families(kernel_rows(trace_dir))}
