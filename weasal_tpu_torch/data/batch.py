"""Dense static-shape sphere batch (counterpart of weasal_tpu/data/batch.py:29).

Every pyramid level l holds B spheres padded to N_l rows. Shadow rules are
the JAX package's: padded points sit at 1e6, a shadow neighbor index
equals N_l and selects an appended far-away / zero-feature row inside the
ops, padded labels are -1. Index tensors are sphere-local int32.

The device pyramid (ops/pyramid.py) makes one of tensors on the device;
the host pyramid (data/batching.assemble_batch) one of numpy arrays,
which `to` moves onto a device and `arrays` / `from_arrays` turn into a
flat dict of arrays and back, the form in which the prefetcher pins it
and a captured graph's static inputs hold it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse


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

    # The inverse neighbor lists of each edge, made on first request and
    # built when a backward on the card first asks (ops/cuda/inverse_lists)
    _inverse: Dict = dataclasses.field(default_factory=dict, init=False,
                                       repr=False, compare=False)

    def inverse(self, edge: str, l: int) -> LazyInverse:
        """The LazyInverse of `edge` ("neighbors", "pools", "upsamples",
        or "regions" with l = 0) at level l, one per batch and edge, so
        that every op on the edge shares its lists. Supports: level l for
        neighbors and pools, level l+1 for upsamples (column 0 only), the
        level-0 points for the region members."""
        key = (edge, l)
        if key not in self._inverse:
            if edge == "regions":
                inds, ns, k = self.region_inds, self.points[0].shape[1], None
            else:
                inds = getattr(self, edge)[l]
                ns = self.points[l + 1 if edge == "upsamples" else l].shape[1]
                k = 1 if edge == "upsamples" else None
            self._inverse[key] = LazyInverse(inds, ns, k)
        return self._inverse[key]

    def arrays(self) -> Dict:
        """The batch as one flat dict (`points_0`, `neighbors_0`, ...,
        `features`, ...), without the fields that are None."""
        out = {}
        for edge in _PER_LEVEL:
            for l, v in enumerate(getattr(self, edge)):
                out[f"{edge}_{l}"] = v
        for name in _SINGLE:
            v = getattr(self, name)
            if v is not None:
                out[name] = v
        return out

    @classmethod
    def from_arrays(cls, arrays: Mapping) -> "PyramidBatch":
        """The batch of a dict that `arrays` made (numpy arrays or
        tensors, as given)."""
        fields = {}
        for edge in _PER_LEVEL:
            n = 0
            while f"{edge}_{n}" in arrays:
                n += 1
            fields[edge] = tuple(arrays[f"{edge}_{l}"] for l in range(n))
        for name in _SINGLE:
            fields[name] = arrays.get(name)
        return cls(**fields)

    def to(self, device, non_blocking: bool = True) -> "PyramidBatch":
        """The batch as tensors on `device`: numpy arrays are copied
        through page-locked host memory (when `device` is CUDA) with
        `non_blocking` copies; the index tensors stay int32, so
        `inverse` builds its lists on the device."""
        device = torch.device(device)

        def move(v):
            if v is None:
                return None
            t = torch.as_tensor(np.ascontiguousarray(v)) \
                if isinstance(v, np.ndarray) else v
            if device.type == "cuda" and t.device.type == "cpu" \
                    and not t.is_pinned():
                t = t.pin_memory()
            return t.to(device, non_blocking=non_blocking)

        return PyramidBatch.from_arrays(
            {k: move(v) for k, v in self.arrays().items()})

    @property
    def num_layers(self) -> int:
        return len(self.points)

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]


# The per-level and the single fields of `PyramidBatch.arrays`
_PER_LEVEL = ("points", "masks", "neighbors", "pools", "upsamples",
              "lengths")
_SINGLE = ("features", "labels", "center_pts", "cloud_label", "cloud_lb",
           "region_inds", "region_masks", "region_point_masks", "region_lb",
           "search_overflow")


def is_host_pyramid(inputs: Mapping) -> bool:
    """True for the flat dict of a host-built batch (`arrays`)."""
    return "neighbors_0" in inputs
