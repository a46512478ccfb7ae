"""Dense static-shape sphere batch (counterpart of weasal_tpu/data/batch.py:29).

Every pyramid level l holds B spheres padded to N_l rows. Shadow rules are
the JAX package's: padded points sit at 1e6, a shadow neighbor index
equals N_l and selects an appended far-away / zero-feature row inside the
ops, padded labels are -1. Index tensors are sphere-local int32.

The device pyramid (ops/pyramid.py) makes one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class PyramidBatch:
    """B spheres with their multi-scale pyramid; tuples run over levels."""

    points: Tuple[torch.Tensor, ...]      # [B, N_l, 3] float32
    masks: Tuple[torch.Tensor, ...]       # [B, N_l] bool
    neighbors: Tuple[torch.Tensor, ...]   # [B, N_l, K_l] int32
    pools: Tuple[torch.Tensor, ...]       # [B, N_{l+1}, K_l] int32 into level l
    upsamples: Tuple[torch.Tensor, ...]   # [B, N_l, U] int32 into level l+1

    features: torch.Tensor                # [B, N_0, F] float32
    labels: torch.Tensor                  # [B, N_0] int32, -1 = padding

    lengths: Tuple[torch.Tensor, ...]     # [B] int32 real counts per level
    center_pts: torch.Tensor              # [B, 3] float32

    # Classification payload: one label per cloud (KPCNN)
    cloud_label: Optional[torch.Tensor] = None         # [B] int32

    cloud_lb: Optional[torch.Tensor] = None            # [B, C]
    region_inds: Optional[torch.Tensor] = None         # [B, R, P] into N_0
    region_masks: Optional[torch.Tensor] = None        # [B, R] bool
    region_point_masks: Optional[torch.Tensor] = None  # [B, R, P] bool
    region_lb: Optional[torch.Tensor] = None           # [B, R, C]

    # Per-edge search-overflow counts [3L-2] of the device pyramid; all
    # zero, because the port's radius search is exact (layout:
    # ops/pyramid.search_slot). None for a host-built batch
    search_overflow: Optional[torch.Tensor] = None


