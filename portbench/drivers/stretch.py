"""The traced stretches of a `--trace 1` run: torch.profiler over a
steady part of the window, opened and closed where the card has caught
up (the harness synchronizes there), read after the window.

A stretch is kept when its kernel events count every call that the
program's launch counters (`weasal_tpu_torch.train.graphs.
launch_counts`) added during it; the profiler has lost kernel events on
an H100, so the run takes `tries` stretches and reads the first whole
one, and says on standard error where one was not.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import torch

from portbench.yardstick import trace

MARK = "portbench: stretch start"
# The host ranges an idle gap is named by
RANGES = ("train_step_k", "eval_step", "step_core", MARK)


def launch_counts() -> Dict[str, int]:
    from weasal_tpu_torch.train.graphs import launch_counts as counts
    return counts()


class Stretch:
    """Profiled stretches of `params["units"]` steps or batches, the first
    once `params["start_share"]` of the window has passed, then one after
    another, `params["tries"]` in all."""

    def __init__(self, device: torch.device, params: Dict, seconds: float):
        self.device = device
        self.units = int(params["units"])
        self.start_s = float(params["start_share"]) * seconds
        self.tries = int(params["tries"])
        self.t0: Optional[float] = None
        self.taken: List[Dict] = []
        self._open: Optional[Dict] = None
        self._done = 0
        # host seconds the stretches' starts and stops took in the window
        self.overhead_s = 0.0
        self._warm_up()

    def _warm_up(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initializes the tracing, which takes seconds."""
        self._start(0)
        self._sync()
        self._open["prof"].__exit__(None, None, None)
        self._open = None

    def open_window(self, t0: float) -> None:
        self.t0 = t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def at_flush(self, done: int, room: int = 1 << 30) -> None:
        """At a point where the card has caught up: `done` units so far,
        `room` units left before the next epoch's end."""
        self._done = done
        if self.t0 is None:
            return
        t = time.perf_counter()
        if self._open is None:
            if len(self.taken) >= self.tries or t - self.t0 < self.start_s \
                    or room < self.units + 25:
                return
            self._start(done)
        elif done - self._open["begin"] >= self.units:
            self._stop(done)
        else:
            return
        self.overhead_s += time.perf_counter() - t

    def at_unit(self, done: int) -> None:
        """After a unit whose work may still run on the card."""
        self._done = done
        if self._open is None and (
                self.t0 is None or len(self.taken) >= self.tries
                or time.perf_counter() - self.t0 < self.start_s):
            return
        if self._open is None or done - self._open["begin"] >= self.units:
            self._sync()
            self.at_flush(done)

    def _start(self, done: int) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
        with record_function(MARK):
            tb = time.perf_counter()
        self._open = dict(prof=prof, tb=tb, begin=done,
                          launches=launch_counts())

    def _stop(self, done: int) -> None:
        self._sync()
        te = time.perf_counter()
        st = self._open
        self._open = None
        after = launch_counts()
        st["prof"].__exit__(None, None, None)
        st.update(te=te, units=done - st["begin"],
                  launches={k: after[k] - st["launches"][k] for k in after})
        self.taken.append(st)

    def close(self) -> None:
        """Stop a stretch that the window's end left open: kept where it
        holds a unit."""
        if self._open is None:
            return
        if self._done > self._open["begin"]:
            self._stop(self._done)
            self.taken[-1]["cut"] = True
        else:
            self._sync()
            self._open["prof"].__exit__(None, None, None)
            self._open = None

    def read(self) -> Optional[Dict]:
        """The stretch to read: the first whose kernel events match the
        counters, else the one that lost the fewest, a stretch that the
        window's end cut short only where no other was taken: {"units",
        "wall_us", "device" (intervals inside it), "families" (us),
        "busy_us", "idle" (us by host range), "whole"}; None where no
        stretch was taken."""
        self.close()
        read = []
        for i, st in enumerate(self.taken):
            r = self._read_one(st)
            if r is None:
                print(f"portbench: traced stretch {i + 1}: no start mark "
                      f"among its events", file=sys.stderr)
                continue
            print(f"portbench: traced stretch {i + 1} of {len(self.taken)}"
                  f": {r['units']} units, "
                  f"{r['wall_us'] / 1e3 / max(r['units'], 1):.3f} ms a "
                  f"unit, busy {100 * r['busy_us'] / r['wall_us']:.1f} %, "
                  f"kernel events {r['observed']} against the launch "
                  f"counters {r['counted']}"
                  + ("" if r["whole"] else ": the profiler lost events")
                  + ("; cut short by the window's end" if st.get("cut")
                     else ""), file=sys.stderr)
            read.append((bool(st.get("cut")), r["lost"], i, r))
        if not read:
            return None
        cut, lost, i, chosen = min(read, key=lambda t: t[:3])
        print(f"portbench: reading traced stretch {i + 1}"
              + ("" if chosen["whole"] else
                 f", {lost} kernel events lost"), file=sys.stderr)
        return chosen

    def _read_one(self, st: Dict) -> Optional[Dict]:
        events = st["prof"].events()
        device, host = trace.profiler_intervals(events, RANGES)
        mark = next((s for n, s, _ in host if n == MARK), None)
        if mark is None:
            return None
        window = (mark, mark + (st["te"] - st["tb"]) * 1e6)
        inside = [iv for iv in device
                  if iv[2] > window[0] and iv[1] < window[1]]
        observed = trace.observed_calls(
            [iv for iv in inside if iv[1] >= window[0]])
        counted = dict(st["launches"])
        lost = sum(max(v - observed.get(k, 0), 0)
                   for k, v in counted.items())
        clipped = [(n, max(s, window[0]), min(e, window[1]))
                   for n, s, e in inside]
        return dict(units=st["units"], wall_us=window[1] - window[0],
                    device=clipped, families=trace.family_us(clipped),
                    busy_us=trace.union_us(clipped, window),
                    idle=trace.idle_gaps(clipped, window, host),
                    whole=lost == 0 and observed == counted, lost=lost,
                    observed=observed, counted=counted)
