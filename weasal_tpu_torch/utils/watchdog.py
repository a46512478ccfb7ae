"""Stall watchdog: turn silent hangs into restartable crashes.

Counterpart of weasal_tpu/utils/watchdog.py. A training process that
blocks forever (a device call that never returns, a producer thread
wedged in native code) raises nothing, so only liveness monitoring
catches it. `StallWatchdog` is a daemon thread armed with a heartbeat:
the loops call `beat()` whenever real progress completes (a flush
returned, an epoch saved, a validation pass done). If no beat arrives for
`timeout_s` (3x that before the first beat), it writes a diagnostic to
stderr and hard-exits the process with `EXIT_STALLED` -- `os._exit`,
because the main thread may be wedged in native code and unable to run
Python signal handlers or atexit hooks. Per-epoch checkpoints and
`--resume` make the restart cheap.

`beat()` also touches the file named by `WEASAL_HEARTBEAT_FILE` (every
5 s at most), so that an outer process can kill a process whose in-process
watchdog cannot run, and re-arms a `faulthandler` stack dump at 1.5x the
timeout, which shows where a process that slipped past the thread was
wedged.
"""

from __future__ import annotations

import faulthandler
import os
import threading
import time

EXIT_STALLED = 86

# faulthandler.dump_traceback_later is one timer per process: the first
# live watchdog owns it, others run their kill thread only
_fh_lock = threading.Lock()
_fh_owner = None


def _fh_acquire(inst) -> bool:
    global _fh_owner
    with _fh_lock:
        if _fh_owner is None:
            _fh_owner = inst
        return _fh_owner is inst


def _fh_release(inst) -> bool:
    global _fh_owner
    with _fh_lock:
        if _fh_owner is inst:
            _fh_owner = None
            return True
        return False


class StallWatchdog:
    """Hard-exit the process when no heartbeat arrives for `timeout_s`.

    :param timeout_s: stall threshold in seconds; <= 0 disables
    :param label: printed in the stall diagnostic
    """

    @classmethod
    def from_config(cls, config, label: str, device) -> "StallWatchdog":
        """Armed with `config.stall_watchdog_s` on a CUDA device; disarmed
        on the CPU, where a slow run must not be killed."""
        timeout = float(getattr(config, "stall_watchdog_s", 0) or 0)
        if getattr(device, "type", str(device)) != "cuda":
            timeout = 0.0
        return cls(timeout, label=label)

    def __init__(self, timeout_s: float = 900.0, label: str = "train"):
        self.timeout_s = float(timeout_s)
        self.label = label
        self._last = time.monotonic()
        self._beaten = False
        self._stop = threading.Event()
        self._thread = None
        self._hb_file = os.environ.get("WEASAL_HEARTBEAT_FILE")
        self._hb_touched = 0.0
        self._fh_owned = False
        if self.timeout_s > 0:
            if self._hb_file:
                try:
                    with open(self._hb_file, "a"):
                        pass
                except OSError:
                    self._hb_file = None
            self._fh_owned = _fh_acquire(self)
            if self._fh_owned:
                faulthandler.dump_traceback_later(self.timeout_s * 1.5,
                                                  exit=False)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def beat(self) -> None:
        now = time.monotonic()
        self._last = now
        self._beaten = True
        if self.timeout_s > 0 and now - self._hb_touched > 5.0:
            self._hb_touched = now
            if self._hb_file:
                try:
                    os.utime(self._hb_file)
                except OSError:
                    pass
            if self._fh_owned:
                faulthandler.dump_traceback_later(self.timeout_s * 1.5,
                                                  exit=False)

    def stop(self) -> None:
        self._stop.set()
        if self.timeout_s > 0 and _fh_release(self):
            faulthandler.cancel_dump_traceback_later()

    def _run(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4, 60.0)):
            stale = time.monotonic() - self._last
            # The first beat may follow kernel builds and graph captures
            threshold = (self.timeout_s if self._beaten
                         else 3.0 * self.timeout_s)
            if stale > threshold:
                # A raw write and _exit: print() would take the stdout
                # lock, which a wedged main thread may hold
                msg = (f"[watchdog] {self.label}: no progress for "
                       f"{stale:.0f} s (> {threshold:.0f} s); exiting "
                       f"{EXIT_STALLED} for a checkpoint resume.\n")
                try:
                    os.write(2, msg.encode())
                except OSError:
                    pass
                os._exit(EXIT_STALLED)
