"""Helper of the port's CPU parity tests (not collected: no test_ prefix)."""

import contextlib

import torch


def warm_cpu_math() -> None:
    """Run torch's f32 sqrt, rsqrt, exp, pow and softmax CPU kernels twice.

    On some x86 hosts the first multi-threaded call of a vectorized f32
    sqrt or exp in a process has returned values with about 1.2e-4
    relative error (torch 2.13 CPU build, about one process in four);
    every later call was exact. The parity tests compare at 1e-5, so they
    take that first call here instead."""
    x = torch.rand(1 << 22, generator=torch.Generator().manual_seed(0)) + 0.5
    for _ in range(2):
        torch.sqrt(x)
        torch.rsqrt(x)
        torch.exp(-x)
        torch.pow(x, 0.5)
        torch.softmax(x.view(1024, -1), dim=-1)


@contextlib.contextmanager
def cpu_torch():
    """One intra-op thread for torch, with its math kernels warmed, for the
    duration of a test module. The port's CPU tests run at tiny shapes, and
    the suite's multi-device JAX tests (XLA:CPU collectives) stall when the
    host's cores are oversubscribed; the thread count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        warm_cpu_math()
        yield
    finally:
        torch.set_num_threads(threads)
