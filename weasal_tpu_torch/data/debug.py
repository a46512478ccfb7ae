"""Checks of the data layer: sampling speed, index ranges, pyramid dumps
and neighbor budgets.

Counterpart of weasal_tpu/data/debug.py:18-101 (after the reference's
dataset debug functions `debug_timing`, `debug_upsampling`,
`debug_show_clouds`, `debug_batch_and_neighbors_calib`), on the port's
datasets and plans: each takes a dataset whose `next_batch(rng, plan)`
gives host-pyramid batches (data/datasets.py) and its `ShapePlan`. The
cloud dump writes a ply a level and the one-file HTML viewer
(utils/html_viewer.py) where the JAX package also draws png previews
with matplotlib, which the port does not import.
"""

from __future__ import annotations

import os
import time
from os.path import join
from typing import Optional

import numpy as np

from weasal_tpu_torch.utils.html_viewer import export_html
from weasal_tpu_torch.utils.ply import write_ply


def debug_timing(dataset, plan, num_batches: int = 20,
                 rng: Optional[np.random.Generator] = None):
    """Host batch generation's throughput (spheres/s, points/s) and batch
    times over `num_batches` batches."""
    rng = rng or np.random.default_rng(0)
    t0 = time.perf_counter()
    spheres = points = 0
    dts = []
    for _ in range(num_batches):
        t1 = time.perf_counter()
        batch, metas = dataset.next_batch(rng, plan)
        dts.append(time.perf_counter() - t1)
        spheres += len(metas)
        points += int(np.sum(np.asarray(batch.lengths[0])))
    total = time.perf_counter() - t0
    stats = dict(batches=num_batches, spheres_per_s=spheres / total,
                 points_per_s=points / total,
                 mean_batch_ms=1000 * np.mean(dts),
                 p95_batch_ms=1000 * np.percentile(dts, 95))
    print("debug_timing:", stats)
    return stats


def _check(ok: bool, message: str) -> None:
    if not ok:
        raise ValueError(message)


def debug_upsampling(dataset, plan, num_batches: int = 3,
                     rng: Optional[np.random.Generator] = None):
    """Check the pyramid's indices: every list within its level (the
    shadow index at most), and under 5 % of a level's real points with
    no upsample source; raises ValueError otherwise."""
    rng = rng or np.random.default_rng(1)
    for _ in range(num_batches):
        batch, _ = dataset.next_batch(rng, plan)
        L = batch.num_layers
        for l in range(L):
            nb = np.asarray(batch.neighbors[l])
            n_l = batch.points[l].shape[1]
            _check(nb.min() >= 0 and nb.max() <= n_l,
                   f"conv indices out of range at level {l}")
        for l in range(L - 1):
            pools = np.asarray(batch.pools[l])
            ups = np.asarray(batch.upsamples[l])
            _check(pools.max() <= batch.points[l].shape[1],
                   f"pool indices out of range at level {l}")
            _check(ups.max() <= batch.points[l + 1].shape[1],
                   f"upsample indices out of range at level {l}")
            mask = np.asarray(batch.masks[l])
            real_up = ups[..., 0][mask]
            frac_shadow = np.mean(real_up == batch.points[l + 1].shape[1])
            print(f"level {l}: upsample shadow fraction "
                  f"{100 * frac_shadow:.2f}%")
            _check(frac_shadow < 0.05,
                   f"{100 * frac_shadow:.2f}% dangling upsamples at "
                   f"level {l}")
    print("debug_upsampling: OK")


def debug_show_clouds(dataset, plan, out_dir: str = "debug_clouds",
                      rng: Optional[np.random.Generator] = None,
                      sphere: int = 0):
    """Dump every pyramid level of one sphere of one batch as
    `sphere<s>_level<l>.ply` and one `sphere<s>_levels.html` whose arrow
    keys step through the levels; returns the paths written."""
    rng = rng or np.random.default_rng(2)
    batch, _ = dataset.next_batch(rng, plan)
    os.makedirs(out_dir, exist_ok=True)
    outputs, frames = [], []
    for l in range(batch.num_layers):
        pts = np.asarray(batch.points[l][sphere])
        mask = np.asarray(batch.masks[l][sphere])
        path = join(out_dir, f"sphere{sphere}_level{l}.ply")
        write_ply(path, [pts[mask].astype(np.float32)], ["x", "y", "z"])
        outputs.append(path)
        frames.append((f"level {l}", pts[mask], None, 1.5))
    outputs.append(export_html(join(out_dir, f"sphere{sphere}_levels.html"),
                               frames=frames,
                               title=f"sphere {sphere} pyramid levels"))
    return outputs


def debug_batch_and_neighbors_calib(dataset, plan, num_batches: int = 10,
                                    rng: Optional[np.random.Generator] = None):
    """Observed neighbor counts against the plan's budgets: per level the
    real rows whose list is full (saturated) and the share of real
    points; returns (saturated rows, real rows) per level."""
    rng = rng or np.random.default_rng(3)
    L = plan.num_layers
    clipped = [0] * L
    totals = [0] * L
    occupancy = [[] for _ in range(L)]
    for _ in range(num_batches):
        batch, _ = dataset.next_batch(rng, plan)
        for l in range(L):
            nb = np.asarray(batch.neighbors[l])
            mask = np.asarray(batch.masks[l])
            n_l = batch.points[l].shape[1]
            counts = np.sum(nb < n_l, axis=2)[mask]
            full = counts == plan.conv_neighbors[l]
            clipped[l] += int(np.sum(full))
            totals[l] += counts.size
            occupancy[l].append(mask.mean())
    for l in range(L):
        frac = clipped[l] / max(totals[l], 1)
        print(f"level {l}: K={plan.conv_neighbors[l]} "
              f"saturated rows {100 * frac:.1f}% "
              f"(target <= ~10%), point occupancy "
              f"{100 * np.mean(occupancy[l]):.0f}%")
    return clipped, totals
