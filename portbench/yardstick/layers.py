"""Per-layer quantities of a traced stretch (`drivers/stretch.Stretch.
read`), per step or vote batch, for the metric readers."""

from __future__ import annotations

from typing import Dict, Optional

from portbench.yardstick import trace, work
from portbench.yardstick.peaks import TF32_FLOP_PER_S


def _stretch(record: Dict, kind: str) -> Optional[Dict]:
    """The traced stretch of a `kind` run that ran work on the card."""
    st = record.get("stretch")
    if record.get("kind") != kind or not st or st["units"] <= 0 \
            or st["busy_us"] <= 0:
        return None
    return st


def plain_torch_ms(record: Dict, kind: str) -> Optional[float]:
    """Device ms a unit in the families outside the program's kernels."""
    st = _stretch(record, kind)
    if st is None:
        return None
    us = sum(v for k, v in st["families"].items()
             if k not in trace.KERNEL_FAMILIES)
    return us / 1e3 / st["units"]


def kpconv_roofline(record: Dict, kind: str) -> Optional[float]:
    """% of B's (and C's) device time that their bounds account for."""
    st = _stretch(record, kind)
    if st is None or not record.get("calls"):
        return None
    us = sum(v for k, v in st["families"].items()
             if k in trace.KPCONV_FAMILIES)
    if us <= 0:
        return None
    bound = work.kpconv_bound_s(record["calls"], training=kind == "train")
    return 100.0 * bound * st["units"] / (us / 1e6)


def device_idle(record: Dict, kind: str) -> Optional[float]:
    st = _stretch(record, kind)
    if st is None:
        return None
    return 100.0 * (1.0 - st["busy_us"] / st["wall_us"])


def mfu(record: Dict, kind: str) -> Optional[float]:
    """Model FLOPs of the stretch's units over its wall at the TF32
    peak."""
    st = _stretch(record, kind)
    if st is None or not record.get("calls"):
        return None
    flops = work.model_flops(record["calls"], training=kind == "train")
    return 100.0 * flops * st["units"] / (st["wall_us"] / 1e6
                                          * TF32_FLOP_PER_S)
