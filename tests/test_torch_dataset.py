"""The port's data layer against the JAX package's on one synthetic scene.

Each package writes the scene into a root of its own from one seed, then
prepares, subsamples, builds anchors, calibrates and samples with the
same seeds. The JAX side runs with sorted KD rows, a seeded anchor
generator and the port's choice of native or numpy geometry
(tests/_torch_data_setup.py).
Everything is held exactly: the plys byte for byte; the subsampled
points, colors and labels; the anchor sets (centers to 1e-6); the
projection indices; the calibrated plan; and twenty successive sphere
payloads on each split, in both the gathered and the resident form, with
the potentials after each. Payload points and features may differ by
1e-6 (f32 arithmetic in the same order).
"""

import dataclasses
import os

import numpy as np
import pytest

from weasal_tpu.ops.subsample import grid_subsample_numpy
from weasal_tpu_torch.data.batching import ShapePlan, payload_meta
from weasal_tpu_torch.ops.subsample import grid_subsample
from tests._torch_data_setup import (
    JaxSynthConfig, jax_dataset_patches, jax_datasets_for, make_roots,
    port_config_class, port_datasets_for)

N_SPHERES = 20


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """((JAX train, JAX val), (port train, port val), roots)."""
    jroot, proot = make_roots(tmp_path_factory, "dataset")
    with jax_dataset_patches():
        jds = jax_datasets_for(JaxSynthConfig(), jroot)
        pds = port_datasets_for(port_config_class()(), proot)
        yield jds, pds, (jroot, proot)


def test_synthetic_plys_are_byte_equal(both):
    _, _, (jroot, proot) = both
    for name in ("Vaihingen3D_Training.ply", "Vaihingen3D_Testing.ply",
                 os.path.join("Training", "Vaihingen3D_Training.ply"),
                 os.path.join("Validation", "Vaihingen3D_Training.ply")):
        with open(os.path.join(jroot, name), "rb") as f:
            want = f.read()
        with open(os.path.join(proot, name), "rb") as f:
            assert f.read() == want, name


@pytest.mark.parametrize("n_lbl", [1, 9])
def test_grid_subsample_with_features_and_labels_equals_numpy(n_lbl):
    rng = np.random.default_rng(n_lbl)
    pts = (rng.random((3000, 3)) * 5).astype(np.float32)
    feats = rng.random((3000, 2)).astype(np.float32) * 255
    labels = rng.integers(0, n_lbl, 3000).astype(np.int32)
    got = grid_subsample(pts, 0.3, features=feats, labels=labels)
    want = grid_subsample_numpy(pts, feats, labels, 0.3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # Points alone: the calibration's call is unchanged
    np.testing.assert_array_equal(grid_subsample(pts, 0.3),
                                  grid_subsample_numpy(pts, dl=0.3))


@pytest.mark.parametrize("split", [0, 1])
def test_subsampled_clouds_equal(both, split):
    jds, pds, _ = both
    j, p = jds[split], pds[split]
    assert j.cloud_names_split == p.cloud_names_split
    for i in range(j.num_clouds):
        np.testing.assert_array_equal(np.asarray(p.input_trees[i].data),
                                      np.asarray(j.input_trees[i].data))
        np.testing.assert_array_equal(p.input_labels[i], j.input_labels[i])
        np.testing.assert_array_equal(p.input_colors[i], j.input_colors[i])
        np.testing.assert_array_equal(np.asarray(p.pot_trees[i].data),
                                      np.asarray(j.pot_trees[i].data))
        np.testing.assert_array_equal(p.potentials[i], j.potentials[i])
    if split == 1:
        for i in range(j.num_clouds):
            np.testing.assert_array_equal(p.test_proj[i], j.test_proj[i])
            np.testing.assert_array_equal(p.validation_labels[i],
                                          j.validation_labels[i])


def _assert_anchor_sets_equal(got, want):
    (a_p, d_p, l_p), (a_j, d_j, l_j) = got, want
    np.testing.assert_allclose(a_p, a_j, rtol=0, atol=1e-6)
    assert sorted(d_p) == sorted(d_j) == list(range(len(a_j)))
    for k in d_j:
        np.testing.assert_array_equal(d_p[k][0][0], d_j[k][0][0])
        np.testing.assert_allclose(d_p[k][1][0], d_j[k][1][0], atol=1e-6)
        np.testing.assert_array_equal(l_p[k], l_j[k])


def test_anchors_equal(both):
    import pickle
    jds, pds, _ = both
    j, p = jds[0], pds[0]
    cfg = j.config
    # The full anchor set before the budget (each package's cache)
    name = f"Vaihingen3D_Training_anchors_{cfg.anchor_method}.pkl"
    with open(os.path.join(j.tree_path, name), "rb") as f:
        a_j, _tree, d_j, l_j = pickle.load(f)
    with open(os.path.join(p.tree_path, name), "rb") as f:
        a_p, d_p, l_p = pickle.load(f)
    _assert_anchor_sets_equal((a_p, d_p, l_p), (a_j, d_j, l_j))
    # The training anchors: the budget subsampled, intersections added
    assert len(j.anchors[0]) > cfg.initial_labels_per_file
    _assert_anchor_sets_equal(
        (p.anchors[0], p.anchor_dicts[0], p.anchor_lbs[0]),
        (j.anchors[0], j.anchor_dicts[0], j.anchor_lbs[0]))
    np.testing.assert_array_equal(np.asarray(p.anchor_trees[0].data),
                                  np.asarray(j.anchor_trees[0].data))


def test_calibrated_plan_equal_and_cached(both):
    jds, pds, (jroot, proot) = both
    jplan = jds[0].calibration(num_samples=12)
    pplan = pds[0].calibration(num_samples=12)
    assert ShapePlan.from_dict(vars(jplan)) == pplan
    assert os.path.exists(os.path.join(proot, "shape_plans_torch.json"))
    assert not os.path.exists(os.path.join(proot, "shape_plans.json"))
    assert pds[0].calibration(num_samples=1) == pplan     # from the cache
    # JSON: the port's own round trip (with and without a small-sphere
    # bucket), and a plan the JAX package saved (its `bands` dropped, its
    # `small` kept)
    pplan.save(os.path.join(proot, "plan.json"))
    assert ShapePlan.load(os.path.join(proot, "plan.json")) == pplan
    small = {"num_points": [8, 8, 8], "cut": 1}
    bucketed = dataclasses.replace(pplan, small=small)
    bucketed.save(os.path.join(proot, "plan_small.json"))
    loaded = ShapePlan.load(os.path.join(proot, "plan_small.json"))
    assert loaded == bucketed and loaded.derive_small().num_points == [8] * 3
    jplan.bands, jplan.small = {"kpconv": None}, small
    jplan.save(os.path.join(jroot, "plan.json"))
    assert ShapePlan.load(os.path.join(jroot, "plan.json")) == bucketed
    # The potentials are those from before the calibration
    np.testing.assert_array_equal(pds[0].potentials[0],
                                  jds[0].potentials[0])


@pytest.mark.parametrize("tight", [False, True])
def test_plan_saturation_audit_equals_jax(both, tight):
    """The port's audit (data/telemetry.py) and the JAX package's on the
    same plan and seed: equal reports, warnings included (a plan cut to
    half its budgets makes some), its line for plan_saturation.txt equal,
    and the potentials of both datasets unmoved."""
    from weasal_tpu.data.telemetry import (
        audit_plan_saturation as jax_audit,
        format_saturation_line as jax_line)
    from weasal_tpu_torch.data.telemetry import (audit_plan_saturation,
                                                 format_saturation_line)
    jds, pds, _ = both
    plan = pds[0].calibration(num_samples=12)
    if tight:
        plan = dataclasses.replace(
            plan, num_points=[n // 2 for n in plan.num_points],
            conv_neighbors=[k // 2 for k in plan.conv_neighbors],
            max_regions=1)
    before = [p.copy() for p in pds[0].potentials]
    got = audit_plan_saturation(pds[0], plan, rng=np.random.default_rng(9))
    want = jax_audit(jds[0], plan, rng=np.random.default_rng(9))
    assert got == want
    assert bool(got["warnings"]) == tight
    assert format_saturation_line(3, got) == jax_line(3, want)
    for a, b, c in zip(pds[0].potentials, before, jds[0].potentials):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# A five-level architecture, as the pseudo-label KPFCNN's
PL_SHAPED_ARCHITECTURE = (
    ["simple", "resnetb"] + ["resnetb_strided", "resnetb"] * 4
    + ["nearest_upsample", "unary"] * 4)


@pytest.fixture(scope="module")
def pl_shaped(both):
    """A port training dataset of the same scene under a five-level
    (pseudo-label shaped) architecture."""
    _, _, (_, proot) = both
    cfg = port_config_class(architecture=PL_SHAPED_ARCHITECTURE)()
    assert cfg.num_layers == 5
    return port_datasets_for(cfg, proot, splits=("training",))[0]


def _uncapped_audit(monkeypatch, dataset, plan, seed):
    """The oracle: the audit over uncapped pyramids with their upsample
    searches (the JAX package's computation, and the port's before it
    searched at the plan's widths); also the longest real row seen on
    each conv and pool edge, {(kind, level): count}."""
    from weasal_tpu_torch.data import telemetry
    from weasal_tpu_torch.data.batching import build_sphere_pyramid
    longest = {}

    def uncapped(points, cfg, rng=None, **_caps):
        pyr = build_sphere_pyramid(points, cfg, rng=rng)
        for kind in ("neighbors", "pools"):
            for l, rows in enumerate(pyr[kind]):
                real = np.sum(rows < pyr["points"][l].shape[0], axis=1)
                longest[kind, l] = max(longest.get((kind, l), 0),
                                       int(real.max(initial=0)))
        return pyr
    with monkeypatch.context() as mp:
        mp.setattr(telemetry, "build_sphere_pyramid", uncapped)
        report = telemetry.audit_plan_saturation(
            dataset, plan, rng=np.random.default_rng(seed))
    return report, longest


@pytest.mark.parametrize("shape", ["wl", "pl"])
def test_plan_capped_audit_equals_uncapped(both, pl_shaped, monkeypatch,
                                           shape):
    """The audit searches each edge at the plan's width and reads the same
    report and plan_saturation.txt line as over uncapped pyramids, on
    several seeds and plans: the calibrated one, one whose widths equal
    the longest row seen on each edge, that less one (the `>=` on real
    rows), and one with an uncapped (0) pool edge. The cKDTree fallback
    runs only for a cap of 0 where the native library is built; the
    counters count every search, 4 spheres x (2L - 1) an audit."""
    from weasal_tpu_torch.data import telemetry
    from weasal_tpu_torch.ops import native, neighbors
    from weasal_tpu_torch.utils import profiling
    ds = both[1][0] if shape == "wl" else pl_shaped
    base = ds.calibration(num_samples=12)
    L = base.num_layers
    assert L == (3 if shape == "wl" else 5)
    fallbacks = []
    scipy_search = neighbors.radius_search_scipy

    def counted(*args, **kwargs):
        fallbacks.append(1)
        return scipy_search(*args, **kwargs)
    monkeypatch.setattr(neighbors, "radius_search_scipy", counted)
    before = [p.copy() for p in ds.potentials]
    for seed in (3, 9, 27):
        _, longest = _uncapped_audit(monkeypatch, ds, base, seed)

        def widths(d):
            return dataclasses.replace(
                base,
                conv_neighbors=[longest["neighbors", l] + d
                                for l in range(L)],
                pool_neighbors=[longest["pools", l] + d
                                for l in range(L - 1)])
        plans = [base, widths(0), widths(-1), dataclasses.replace(
            base, pool_neighbors=[0] + list(base.pool_neighbors[1:]))]
        reports = []
        for i, plan in enumerate(plans):
            want, _ = _uncapped_audit(monkeypatch, ds, plan, seed)
            fallbacks.clear()
            mark = profiling.mark()
            got = telemetry.audit_plan_saturation(
                ds, plan, rng=np.random.default_rng(seed))
            counts = profiling.span_totals(since=mark)
            assert got == want, (seed, i)
            assert telemetry.format_saturation_line(7, got) == \
                telemetry.format_saturation_line(7, want)
            caps = list(plan.conv_neighbors) + list(plan.pool_neighbors)
            n_native, n_fallback = (
                counts.get(f"audit.search_{p}", {}).get("count", 0)
                for p in ("native", "fallback"))
            assert n_native + n_fallback == 4 * (2 * L - 1)
            assert n_fallback == len(fallbacks)
            if native.available():
                assert n_fallback == 4 * caps.count(0)
            else:
                assert n_native == 0
            reports.append(got)
        # the widths of the longest rows saturate some rows on every edge,
        # the widths one less at least as many
        for kind in ("conv_saturation", "pool_saturation"):
            assert all(0 < a <= b for a, b in
                       zip(reports[1][kind], reports[2][kind])), kind
    for a, b in zip(ds.potentials, before):
        np.testing.assert_array_equal(a, b)


def _assert_payload_equal(got, want):
    for key in ("cloud_ind", "input_inds", "center", "scale", "rot",
                "labels", "cloud_lb", "color_keep"):
        if want.get(key) is None:
            assert got.get(key) is None, key
            continue
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("points", "features"):
        if want.get(key) is None:
            assert got.get(key) is None, key
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    if want["regions"] is None:
        assert got["regions"] is None
    else:
        assert len(got["regions"]) == len(want["regions"])
        for (gi, gl), (wi, wl) in zip(got["regions"], want["regions"]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("split,gather", [(0, True), (0, False),
                                          (1, True), (1, False)])
def test_twenty_sphere_payloads_equal(both, split, gather):
    jds, pds, _ = both
    j, p = jds[split], pds[split]
    max_points = 700
    rj, rp = np.random.default_rng(100 + split), \
        np.random.default_rng(100 + split)
    thinned = 0
    for _ in range(N_SPHERES):
        want = j.sample_sphere(rj, augment=True, max_points=max_points,
                               gather=gather)
        got = p.sample_sphere(rp, augment=True, max_points=max_points,
                              gather=gather)
        _assert_payload_equal(got, want)
        assert payload_meta(got, max_points)["n_real"] == \
            min(len(want["input_inds"]), max_points)
        thinned += len(want["input_inds"]) == max_points
        for i in range(j.num_clouds):
            np.testing.assert_array_equal(p.potentials[i], j.potentials[i])
        assert p.min_potentials == j.min_potentials
        assert p.argmin_potentials == j.argmin_potentials
    assert thinned > 0                          # the thinning ran
    assert rj.random() == rp.random()           # same draws consumed


@pytest.mark.parametrize("on_train", [True, False])
def test_test_split_equals_jax(both, on_train):
    """The 'test' split: with `test_on_train` the training cloud (labels
    kept), else the testing cloud (no labels read into payloads); files,
    subsampled clouds, projection indices, evaluation labels and points,
    and five payloads equal."""
    from weasal_tpu.data import datasets as jax_datasets
    from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
    _, _, (jroot, proot) = both
    with jax_dataset_patches():
        j = jax_datasets.Vaihingen3DWLDataset(
            JaxSynthConfig(), split="test", test_on_train=on_train,
            data_root=jroot, rng=np.random.default_rng(0))
        p = Vaihingen3DWLDataset(port_config_class()(), split="test",
                                 test_on_train=on_train, data_root=proot,
                                 rng=np.random.default_rng(0))
    assert p.has_labels == on_train
    assert [os.path.relpath(f, proot) for f in p.files] == \
        [os.path.relpath(f, jroot) for f in j.files] == \
        [os.path.join("Test", "Vaihingen3D_Training.ply" if on_train
                      else "Vaihingen3D_Testing.ply")]
    with open(j.files[0], "rb") as f:
        want = f.read()
    with open(p.files[0], "rb") as f:
        assert f.read() == want
    np.testing.assert_array_equal(np.asarray(p.input_trees[0].data),
                                  np.asarray(j.input_trees[0].data))
    np.testing.assert_array_equal(p.input_labels[0], j.input_labels[0])
    np.testing.assert_array_equal(p.test_proj[0], j.test_proj[0])
    np.testing.assert_array_equal(p.validation_labels[0],
                                  j.validation_labels[0])
    np.testing.assert_array_equal(p.load_evaluation_points(p.files[0]),
                                  j.load_evaluation_points(j.files[0]))
    jr, pr = np.random.default_rng(4), np.random.default_rng(4)
    for _ in range(5):
        a = j.sample_sphere(jr, augment=True)
        b = p.sample_sphere(pr, augment=True)
        np.testing.assert_array_equal(b["input_inds"], a["input_inds"])
        np.testing.assert_allclose(b["points"], a["points"], atol=1e-6)
        if on_train:
            np.testing.assert_array_equal(b["labels"], a["labels"])
            np.testing.assert_array_equal(b["cloud_lb"], a["cloud_lb"])
        else:
            assert b["labels"] is None and a["labels"] is None
            assert b["cloud_lb"] is None and a["cloud_lb"] is None
        assert b["regions"] is None and a["regions"] is None
    for k in range(p.num_clouds):
        np.testing.assert_array_equal(p.potentials[k], j.potentials[k])
