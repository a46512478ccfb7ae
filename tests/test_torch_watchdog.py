"""The port's stall watchdog (weasal_tpu_torch/utils/watchdog.py): the
cases of tests/test_aux_utils.py's `TestStallWatchdog` on the port's
copy, and its arming rule (CUDA only)."""

import os
import subprocess
import sys

import torch

from weasal_tpu_torch.utils.watchdog import EXIT_STALLED, StallWatchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_beats_keep_it_alive_and_stall_exits_86():
    """Run in a subprocess: the stall path hard-exits via os._exit."""
    code = (
        "import time\n"
        "from weasal_tpu_torch.utils.watchdog import StallWatchdog\n"
        "wd = StallWatchdog(timeout_s=0.4, label='t')\n"
        "for _ in range(4):\n"
        "    time.sleep(0.2); wd.beat()\n"
        "print('ALIVE', flush=True)\n"
        "time.sleep(5)\n"
        "print('NEVER', flush=True)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == EXIT_STALLED == 86, (r.returncode, r.stdout,
                                                r.stderr)
    assert "ALIVE" in r.stdout
    assert "NEVER" not in r.stdout
    assert "watchdog" in r.stderr


def test_disabled_never_fires():
    wd = StallWatchdog(timeout_s=0)
    assert wd._thread is None
    wd.beat()
    wd.stop()


def test_armed_on_cuda_only():
    class Cfg:
        stall_watchdog_s = 900
    cpu = StallWatchdog.from_config(Cfg(), "t", torch.device("cpu"))
    assert cpu.timeout_s == 0 and cpu._thread is None
    cuda = StallWatchdog.from_config(Cfg(), "t", torch.device("cuda"))
    try:
        assert cuda.timeout_s == 900 and cuda._thread.is_alive()
    finally:
        cuda.stop()
    assert not cuda._thread.is_alive() or cuda._stop.is_set()
