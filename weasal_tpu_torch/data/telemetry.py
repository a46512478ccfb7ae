"""Shape-plan saturation audit: make the plan's silent caps visible.

Counterpart of weasal_tpu/data/telemetry.py:25-129 on the port's own host
pyramid (data/batching.build_sphere_pyramid). The static plan truncates
what exceeds its budgets: level point counts beyond N_l, neighbor rows
beyond K_l, sub-regions beyond R, region members beyond P. Once per epoch
the trainer samples a few fresh spheres, builds their pyramids with each
search capped at the plan's own width (no upsample searches) and compares
the sizes with the plan; the dataset's potentials are restored
afterwards, so the audit never moves the sampling schedule.

A row searched at width K holds K real entries exactly when the support
has K or more neighbors, so `real >= K` reads the same as on an uncapped
row (the JAX package's searches are uncapped). A capped search runs the
native library where it is built (`ops/neighbors.radius_search`); the
counters `audit.search_native` and `audit.search_fallback` (utils/
profiling) count the audit's searches by path, a cap of 0 (uncapped)
taking the cKDTree fallback.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from weasal_tpu_torch.data.batching import build_sphere_pyramid
from weasal_tpu_torch.ops import native
from weasal_tpu_torch.utils.profiling import counter


def _count_searches(caps) -> None:
    """Count the searches at `caps` by the path `radius_search` takes."""
    fast = native.available()
    for cap in caps:
        counter("audit.search_native" if cap and fast
                else "audit.search_fallback")


def audit_plan_saturation(dataset, plan, num_spheres: int = 4,
                          rng: Optional[np.random.Generator] = None,
                          untouched_ratio: float = 0.9) -> Dict:
    """Per-level observations of `num_spheres` sphere pyramids, searched
    at the plan's widths, against `plan`, and a `warnings` list: a level
    whose points exceed N_l, more than (1 - untouched_ratio) + 5 % of conv
    or pool rows at their cap, spheres with more regions than R."""
    rng = rng or np.random.default_rng(0)
    cfg = dataset.config
    L = plan.num_layers

    snap = None
    if getattr(dataset, "potentials", None) is not None:
        snap = ([p.copy() for p in dataset.potentials],
                list(dataset.min_potentials),
                list(dataset.argmin_potentials))

    level_counts: List[List[int]] = [[] for _ in range(L)]
    conv_sat: List[List[float]] = [[] for _ in range(L)]
    pool_sat: List[List[float]] = [[] for _ in range(L - 1)]
    regions_over, region_pts_over = 0, 0
    pts_truncated = [0] * L
    conv_caps, pool_caps = list(plan.conv_neighbors), list(plan.pool_neighbors)
    try:
        for _ in range(num_spheres):
            payload = dataset.sample_sphere(rng, augment=False)
            pyr = build_sphere_pyramid(
                payload["points"], cfg, rng=rng, max_neighbors=conv_caps,
                max_pool_neighbors=pool_caps, with_upsamples=False)
            _count_searches(conv_caps[:L] + pool_caps[:L - 1])
            for l in range(L):
                n_l = pyr["points"][l].shape[0]
                level_counts[l].append(n_l)
                if n_l > plan.num_points[l]:
                    pts_truncated[l] += 1
                real = np.sum(pyr["neighbors"][l] < n_l, axis=1)
                conv_sat[l].append(
                    float(np.mean(real >= plan.conv_neighbors[l])))
            for l in range(L - 1):
                n_l = pyr["points"][l].shape[0]
                real = np.sum(pyr["pools"][l] < n_l, axis=1)
                pool_sat[l].append(
                    float(np.mean(real >= plan.pool_neighbors[l])))
            regions = payload.get("regions") or []
            if len(regions) > plan.max_regions > 0:
                regions_over += 1
            region_pts_over += sum(
                1 for inds, _ in regions
                if np.size(inds) > plan.max_region_points > 0)
    finally:
        if snap is not None:
            dataset.potentials, dataset.min_potentials, \
                dataset.argmin_potentials = snap

    report = {
        "num_spheres": num_spheres,
        "plan_points": list(plan.num_points),
        "max_points_seen": [int(max(c)) for c in level_counts],
        "points_truncated_spheres": pts_truncated,
        "conv_saturation": [float(np.mean(s)) for s in conv_sat],
        "pool_saturation": [float(np.mean(s)) for s in pool_sat],
        "spheres_with_region_overflow": regions_over,
        "regions_with_member_subsample": region_pts_over,
        "warnings": [],
    }
    sat_budget = (1.0 - untouched_ratio) + 0.05
    for l in range(L):
        if pts_truncated[l]:
            report["warnings"].append(
                f"level {l}: {pts_truncated[l]}/{num_spheres} spheres "
                f"exceed N_{l}={plan.num_points[l]} "
                f"(max seen {report['max_points_seen'][l]}) — points are "
                "being dropped; rerun calibration(force_redo=True)")
        if report["conv_saturation"][l] > sat_budget:
            report["warnings"].append(
                f"level {l}: {100 * report['conv_saturation'][l]:.0f}% of "
                f"conv neighborhoods hit K_{l}={plan.conv_neighbors[l]} "
                f"(calibration assumed <= {100 * (1 - untouched_ratio):.0f}%"
                " cropped); rerun calibration(force_redo=True)")
    for l in range(L - 1):
        if report["pool_saturation"][l] > sat_budget:
            report["warnings"].append(
                f"level {l}: {100 * report['pool_saturation'][l]:.0f}% of "
                f"pool neighborhoods hit cap {plan.pool_neighbors[l]}; "
                "rerun calibration(force_redo=True)")
    if regions_over:
        report["warnings"].append(
            f"{regions_over}/{num_spheres} spheres carry more sub-regions "
            f"than R={plan.max_regions} (extra regions dropped)")
    return report


def format_saturation_line(epoch: int, report: Dict) -> str:
    """One line per epoch for plan_saturation.txt."""
    conv = "/".join(f"{s:.2f}" for s in report["conv_saturation"])
    pool = "/".join(f"{s:.2f}" for s in report["pool_saturation"])
    trunc = "/".join(str(t) for t in report["points_truncated_spheres"])
    return (f"epoch {epoch} conv_sat {conv} pool_sat {pool} "
            f"pts_trunc {trunc} region_overflow "
            f"{report['spheres_with_region_overflow']} warnings "
            f"{len(report['warnings'])}\n")
