"""The reference's device and precision."""

from __future__ import annotations

import torch


def configure_precision() -> None:
    """Full f32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
