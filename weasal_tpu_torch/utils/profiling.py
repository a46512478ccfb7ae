"""Phase timing of a loop on the host clock.

Counterpart of `StepTimer` in weasal_tpu/utils/profiling.py:18-62:
exponential moving averages of named phases, shown at most once a
display interval. The JAX module's profile readers and `device_trace`
are TPU tools; the port's device trace is the trainer's
`WEASAL_TRACE_DIR` profiler window (train/trainer.py). On a card the
host clock measures the enqueue unless a phase ends in a
synchronization.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


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
