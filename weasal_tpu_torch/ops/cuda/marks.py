"""Marks on the device's clock (csrc/marks.cu).

A mark is the launch of an empty kernel whose name says where it stands:
`deform_fwd_begin` / `deform_fwd_end` bracket a deformable conv's plain
chain in the forward, `deform_bwd_begin` / `deform_bwd_end` its
backward (ops/kpconv.deformable_kpconv). Launched on the current stream,
a mark is captured into a CUDA graph like any kernel, so a device trace
of a replay shows it where the host's ranges see nothing. It never
synchronizes, and it is not one of the kernels that
`train/graphs.launch_counts` counts. Off the card a mark does nothing.
"""

from __future__ import annotations

import ctypes

import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library

MARKS = ("deform_fwd_begin", "deform_fwd_end", "deform_bwd_begin",
         "deform_bwd_end")

_lib = None


def _launcher():
    global _lib
    if _lib is None:
        lib = load_library("marks")
        lib.mark_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.mark_launch.restype = ctypes.c_int
        _lib = lib
    return _lib.mark_launch


def mark(name: str, device: torch.device) -> None:
    """Launch the mark `name` (one of MARKS) on `device`'s current
    stream; nothing where `device` is not a card."""
    which = MARKS.index(name)
    if device.type != "cuda":
        return
    check(_launcher()(which, torch.cuda.current_stream(device).cuda_stream),
          f"mark {name}")
