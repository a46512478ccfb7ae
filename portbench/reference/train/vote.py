"""Vote buffers on the device, for validation smoothing and voting.

Counterpart of weasal_tpu/train/vote.py:32-151 (`DeviceVoteAccumulator`)
on torch tensors: one flat `[S, C]` f32 buffer aligned row for row with
the resident clouds (data/resident.ResidentClouds: the same per-cloud
bases and trailing shadow row). Each batch's probabilities are smoothed
in sphere by sphere, in order, as the JAX package's `lax.scan` does:
spheres of one batch may overlap, and a single scatter over the batch
would give another answer there. Pad rows all write back the shadow
row's own value, so their duplicate writes are harmless. The tester's
radius mask reads the squared norms `d2` of the augmented points
(`use_d2`, as the reference masks augmented coordinates); without them
it measures the resident points from each sphere's center. The host
reads the buffer only through `materialize`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class DeviceVoteAccumulator:
    """Full-cloud vote buffers on the resident clouds' device.

    :param resident: the split's ResidentClouds
    :param num_classes: probability columns
    :param smooth: exponential smoothing factor (0.95 for validation)
    :param radius_sq: optional squared radius; when set, only points with
        ``|p - center|^2 < radius_sq`` are updated (the voting tester's
        mask; validation passes None)
    """

    def __init__(self, resident, num_classes: int, smooth: float = 0.95,
                 radius_sq: Optional[float] = None):
        self.resident = resident
        self.num_classes = int(num_classes)
        res_points = resident.arrays["res_points"]
        self._S = int(res_points.shape[0])
        self.smooth = float(smooth)
        self.radius_sq = None if radius_sq is None else float(radius_sq)
        self._flat = torch.zeros((self._S, self.num_classes),
                                 dtype=torch.float32,
                                 device=res_points.device)

    @torch.no_grad()
    def update(self, probs: torch.Tensor, batch,
               d2: Optional[torch.Tensor] = None) -> None:
        """Smooth one batch's probabilities [B, N0, C] (in `input_inds`
        order) into the buffer. The radius mask compares `d2` [B, N0]
        (squared norms of the augmented points, `input_inds` order) when
        given, else the resident points' squared distances from each
        sphere's center."""
        shadow = self._S - 1
        flat_inds = batch["flat_inds"].long()
        probs = probs.to(torch.float32)
        for b in range(flat_inds.shape[0]):
            idx = flat_inds[b]
            valid = idx < shadow
            if self.radius_sq is not None and d2 is not None:
                valid = valid & (d2[b] < self.radius_sq)
            elif self.radius_sq is not None:
                rel = batch["res_points"][idx] - batch["center_pts"][b][None, :]
                valid = valid & ((rel * rel).sum(dim=1) < self.radius_sq)
            tgt = torch.where(valid, idx, torch.full_like(idx, shadow))
            cur = self._flat[tgt]
            new = self.smooth * cur + (1.0 - self.smooth) * probs[b]
            self._flat[tgt] = torch.where(valid[:, None], new, cur)


