"""Device resolution and kernel routing.

Counterpart of weasal_tpu/utils/platform.py:52 (`resolve_pallas_flag`).
The JAX package probes the backend to decide whether its Pallas kernels
run; here the decision follows the tensor: a CUDA tensor goes through the
hand-written Hopper kernel, a CPU tensor through the kernel's plain
PyTorch version. Nothing probes a backend, and nothing moves silently
between devices.

Entry points take an explicit `device`. Left out, it is ``cuda``, and a
machine without CUDA raises instead of running on the CPU.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_PLAIN_OPS = contextvars.ContextVar("weasal_tpu_torch_plain_ops",
                                    default=False)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another one. Raises when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "weasal_tpu_torch runs on CUDA by default, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def configure_precision() -> None:
    """Full f32 on the card: no TF32 in matmuls or convolutions. Geometry
    (rotations, distances) must stay f32, and the feature products are
    compared against f32 references."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def plain_ops():
    """Route CUDA tensors through the plain PyTorch versions instead of
    the kernels while the block runs. Used to build the on-card reference
    a kernel run is compared against; nothing on the main path enters it."""
    token = _PLAIN_OPS.set(True)
    try:
        yield
    finally:
        _PLAIN_OPS.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True when `t` lies on a CUDA device and no `plain_ops` block is
    active: the caller then launches the kernel (or raises)."""
    return t.is_cuda and not _PLAIN_OPS.get()
