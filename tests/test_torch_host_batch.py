"""The port's host-pyramid batches against the JAX package's.

Each package writes one synthetic scene into a root of its own and
samples it with the same seeds (tests/_torch_data_setup.py: sorted KD
rows, a seeded anchor generator, and native or numpy geometry alike on
both sides). Checked:
- `assemble_batch` and `assemble_classification_batch` bit-equal to
  JAX's on the same sphere pyramids, at a plan that crops points, rows
  and regions (the region subsample's draws included);
- `next_batch` of the training (augmented) and validation splits and
  `ParallelSphereBuilder` batches equal to JAX's from one seed, three
  successive batches each with their metas and the potentials after
  them: points and features to 1e-6 (f32 arithmetic in the same order),
  every index array equal;
- the 'ERF' split: the assertions of tests/test_datasets.py:274-293 on
  the port (validation files, no potential update, no center noise, no
  labels) and its spheres and batches equal to JAX's;
- the port's native geometry library bit-equal to JAX's (the same
  source) and to the port's numpy / scipy versions at the tolerances of
  tests/test_native.py;
- `demo_batch` equal to JAX's; `PyramidBatch.arrays` / `from_arrays` /
  `to` keep every field.
"""

import numpy as np
import pytest
import torch

from weasal_tpu.data import batching as jax_batching
from weasal_tpu.data import demo as jax_demo
from weasal_tpu.data.loader import ParallelSphereBuilder as JaxBuilder
from weasal_tpu.ops import native as jax_native
from weasal_tpu_torch.data import batching, demo
from weasal_tpu_torch.data.batch import PyramidBatch, is_host_pyramid
from weasal_tpu_torch.data.loader import (HostPyramidSource,
                                          ParallelSphereBuilder)
from weasal_tpu_torch.ops import native, neighbors, subsample
from tests._torch_data_setup import (
    JaxSynthConfig, jax_dataset_patches, jax_datasets_for, make_roots,
    port_config_class, port_datasets_for)
from tests.test_datasets import SynthWLConfig

N_BATCHES = 3
LEVEL_FIELDS = ("points", "masks", "neighbors", "pools", "upsamples",
                "lengths")
SINGLE_FIELDS = ("features", "labels", "center_pts", "cloud_label",
                 "cloud_lb", "region_inds", "region_masks",
                 "region_point_masks", "region_lb")


def assert_batch_equal(got, want, atol=0.0):
    """Every field of a port batch against a JAX one: floats to `atol`,
    everything else equal."""
    for name in LEVEL_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert len(g) == len(w), name
        for l, (a, b) in enumerate(zip(g, w)):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (name, l)
            if a.dtype == np.float32 and atol:
                np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                           err_msg=f"{name}[{l}]")
            else:
                np.testing.assert_array_equal(a, b, f"{name}[{l}]")
    for name in SINGLE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.float32 and atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, name)


def assert_metas_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], k)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """((JAX train, JAX val), (port train, port val), roots, plan), the
    JAX side's geometry patched for the whole module."""
    jroot, proot = make_roots(tmp_path_factory, "host_batch")
    with jax_dataset_patches():
        jds = jax_datasets_for(JaxSynthConfig(), jroot)
        pds = port_datasets_for(port_config_class()(), proot)
        jplan = jds[0].calibration()
        plan = pds[0].calibration()
        assert plan.num_points == jplan.num_points
        assert plan.conv_neighbors == jplan.conv_neighbors
        yield jds, pds, (jroot, proot), plan, jplan


def _pyramid_spheres(seed, config, n_spheres=3):
    """Sphere dicts (JAX demo payloads with JAX host pyramids)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_spheres):
        p = jax_demo.demo_sphere(rng, config, density=6.0)
        pyr = jax_batching.build_sphere_pyramid(p["points"], config, rng=rng)
        out.append(dict(pyramid=pyr, features=p["features"],
                        labels=p["labels"], center=p["center"],
                        cloud_lb=p["cloud_lb"], regions=p["regions"]))
    return out


def _cropping_plan(spheres, L):
    """A plan below the spheres' sizes: points, widths and region
    members cropped."""
    sizes = [min(s["pyramid"]["points"][l].shape[0] for s in spheres)
             for l in range(L)]
    return batching.ShapePlan(
        num_points=[max(8, (3 * n) // 4) for n in sizes],
        conv_neighbors=[6] * L, pool_neighbors=[5] * (L - 1),
        max_regions=4, max_region_points=9)


def test_assemble_batch_equals_jax():
    config = SynthWLConfig()
    config.num_classes = 9
    spheres = _pyramid_spheres(3, config)
    plan = _cropping_plan(spheres, config.num_layers)
    jplan = jax_batching.ShapePlan(**vars(plan))
    got = batching.assemble_batch(spheres, plan, config.num_classes,
                                  rng=np.random.default_rng(8))
    want = jax_batching.assemble_batch(spheres, jplan, config.num_classes,
                                       rng=np.random.default_rng(8))
    assert got.region_point_masks.sum() > 0
    assert (got.region_point_masks.sum(-1) == plan.max_region_points).any()
    assert_batch_equal(got, want)
    # level sizes above the plan: the shadows of cropped supports
    assert (got.neighbors[0] == plan.num_points[0]).any()


def test_assemble_classification_batch_equals_jax():
    config = SynthWLConfig()
    config.num_classes = 9
    rng = np.random.default_rng(5)
    clouds = []
    for i in range(3):
        p = jax_demo.demo_sphere(rng, config, density=6.0)
        clouds.append(dict(
            pyramid=jax_batching.build_sphere_pyramid(
                p["points"], config, rng=rng, with_upsamples=False),
            features=p["features"], label=i + 2))
    plan = _cropping_plan(clouds, config.num_layers)
    got = batching.assemble_classification_batch(clouds, plan)
    want = jax_batching.assemble_classification_batch(
        clouds, jax_batching.ShapePlan(**vars(plan)))
    assert list(got.cloud_label) == [2, 3, 4]
    assert_batch_equal(got, want)


@pytest.mark.parametrize("split", [0, 1])
def test_next_batch_equals_jax(scene, split):
    jds, pds, _, plan, jplan = scene
    j, p = jds[split], pds[split]
    jrng, prng = np.random.default_rng(21), np.random.default_rng(21)
    regions = 0
    for _ in range(N_BATCHES):
        want, wmetas = j.next_batch(jrng, jplan)
        got, gmetas = p.next_batch(prng, plan)
        assert_batch_equal(got, want, atol=1e-6)
        assert_metas_equal(gmetas, wmetas)
        regions += int(got.region_masks.sum())
    # the training split's batches carry regions, the validation's none
    assert (regions > 0) == (split == 0)
    for a, b in zip(p.potentials, j.potentials):
        np.testing.assert_array_equal(a, b)


def test_parallel_sphere_builder_equals_jax(scene):
    jds, pds, _, plan, jplan = scene
    jbuild, pbuild = JaxBuilder(jds[0], 2), ParallelSphereBuilder(pds[0], 2)
    jrng, prng = np.random.default_rng(5), np.random.default_rng(5)
    try:
        for _ in range(N_BATCHES):
            want, wmetas = jbuild.next_batch(jrng, jplan)
            got, gmetas = pbuild.next_batch(prng, plan)
            assert_batch_equal(got, want, atol=1e-6)
            assert_metas_equal(gmetas, wmetas)
    finally:
        pbuild.close()
    assert jrng.bit_generator.state == prng.bit_generator.state
    # the loop's source: ParallelSphereBuilder batches as flat dicts
    source = HostPyramidSource(pds[0], plan, threads=2)
    arrays, metas = source.next_batch(np.random.default_rng(0))
    assert is_host_pyramid(arrays) and len(metas) == pds[0].config.batch_num
    assert source.batches == 1 and source.seconds > 0
    # another source's builds are its own
    other = HostPyramidSource(pds[0], plan)
    other.next_batch(np.random.default_rng(2))
    assert source.batches == 1 and other.batches == 1
    source.close()
    assert source.builder.pool is None
    # a batch after close starts new workers
    source.next_batch(np.random.default_rng(1))
    assert source.builder.pool is not None
    source.close()


def test_erf_split_deterministic_unlabeled_and_equal_jax(scene):
    from weasal_tpu.data.datasets import Vaihingen3DWLDataset as JaxWL
    from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
    jds, pds, (jroot, proot), plan, jplan = scene
    pcfg = port_config_class()()
    ds = Vaihingen3DWLDataset(pcfg, split="ERF", data_root=proot,
                              rng=np.random.default_rng(3))
    val = Vaihingen3DWLDataset(pcfg, split="validation", data_root=proot,
                               rng=np.random.default_rng(3))
    assert ds.cloud_names_split == val.cloud_names_split
    assert not ds.has_labels and len(ds.test_proj) == ds.num_clouds

    pots_before = [p.copy() for p in ds.potentials]
    p1 = ds.sample_sphere(np.random.default_rng(0), augment=False)
    p2 = ds.sample_sphere(np.random.default_rng(99), augment=False)
    # No potential updates and no center noise -> identical spheres
    for before, after in zip(pots_before, ds.potentials):
        np.testing.assert_array_equal(before, after)
    np.testing.assert_array_equal(p1["center"], p2["center"])
    np.testing.assert_array_equal(p1["input_inds"], p2["input_inds"])
    assert p1["labels"] is None and p1["cloud_lb"] is None

    with jax_dataset_patches():
        jerf = JaxWL(JaxSynthConfig(), split="ERF", data_root=jroot,
                     rng=np.random.default_rng(3))
        want = jerf.sample_sphere(np.random.default_rng(0), augment=True)
        got = ds.sample_sphere(np.random.default_rng(0), augment=True)
        for k in ("input_inds", "cloud_ind", "center", "scale", "rot"):
            np.testing.assert_array_equal(got[k], want[k], k)
        np.testing.assert_allclose(got["points"], want["points"], atol=1e-6)
        np.testing.assert_allclose(got["features"], want["features"],
                                   atol=1e-6)
        wbatch, wmetas = jerf.next_batch(np.random.default_rng(1), jplan)
        gbatch, gmetas = ds.next_batch(np.random.default_rng(1), plan)
    assert_batch_equal(gbatch, wbatch, atol=1e-6)
    assert_metas_equal(gmetas, wmetas)
    assert (gbatch.labels == -1).all() and not gbatch.cloud_lb.any()


def test_native_library_equals_jax_and_numpy():
    if not (native.available() and jax_native.available()):
        pytest.skip("native geometry library unavailable")
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 6, size=(4000, 3)).astype(np.float32)
    feats = rng.normal(size=(4000, 2)).astype(np.float32)
    labels = rng.integers(0, 9, 4000).astype(np.int32)
    got = native.grid_subsample_native(pts, 0.7, features=feats,
                                       labels=labels)
    want = jax_native.grid_subsample_native(pts, feats, labels, 0.7)
    ref = subsample.grid_subsample_numpy(pts, 0.7, features=feats,
                                         labels=labels)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-4)
    np.testing.assert_array_equal(got[2], ref[2])
    assert native.grid_subsample_native(pts, 0.5, max_out=64).shape == \
        (64, 3)

    q = rng.uniform(-3, 3, size=(200, 3)).astype(np.float32)
    s = rng.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    got = native.radius_search_native(q, s, 0.9, 24)
    np.testing.assert_array_equal(got, jax_native.radius_search_native(
        q, s, 0.9, 24))
    np.testing.assert_array_equal(got, neighbors.radius_search_scipy(
        q, s, 0.9, 24))
    # queries outside the supports' bounds
    s = rng.uniform(0, 1, size=(100, 3)).astype(np.float32)
    q = np.array([[5.0, 5.0, 5.0], [0.5, 0.5, 0.5], [-0.4, 0.5, 0.5]],
                 np.float32)
    np.testing.assert_array_equal(
        native.radius_search_native(q, s, 0.6, 50),
        neighbors.radius_search_scipy(q, s, 0.6, 50))
    # the routed entry points take the native library
    np.testing.assert_array_equal(neighbors.radius_search(q, s, 0.6, 50),
                                  native.radius_search_native(q, s, 0.6, 50))


def test_numpy_fallback_without_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, size=(3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(subsample.grid_subsample(pts, 0.8),
                                  subsample.grid_subsample_numpy(pts, 0.8))
    np.testing.assert_array_equal(
        neighbors.radius_search(pts[:50], pts, 0.9, 12),
        neighbors.radius_search_scipy(pts[:50], pts, 0.9, 12))


def test_demo_batch_equals_jax():
    config = SynthWLConfig()
    config.num_classes = 9
    got, plan = demo.demo_batch(config, batch_size=2, seed=4, density=6.0)
    want, jplan = jax_demo.demo_batch(config, batch_size=2, seed=4,
                                      density=6.0)
    assert plan.num_points == jplan.num_points
    assert plan.max_region_points == jplan.max_region_points
    assert_batch_equal(got, want)


def test_pyramid_batch_arrays_round_trip():
    config = SynthWLConfig()
    config.num_classes = 9
    batch, _ = demo.demo_batch(config, batch_size=2, seed=1, density=6.0)
    arrays = batch.arrays()
    assert is_host_pyramid(arrays) and "search_overflow" not in arrays
    back = PyramidBatch.from_arrays(arrays)
    assert_batch_equal(back, batch)
    moved = batch.to("cpu")
    assert all(isinstance(t, torch.Tensor) for t in moved.neighbors)
    assert moved.neighbors[0].dtype == torch.int32
    assert_batch_equal(PyramidBatch.from_arrays(
        {k: v.numpy() for k, v in moved.arrays().items()}), batch)
    # the inverse lists of host-built rows (plain version on the CPU)
    inv = moved.inverse("neighbors", 0)
    assert inv is moved.inverse("neighbors", 0)
