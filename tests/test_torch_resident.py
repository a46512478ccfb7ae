"""The port's resident input and vote buffers against the JAX package's.

- `pack_payloads`: equal arrays from the same gather-less payloads and
  seed.
- `assemble_level0_device` (on the CPU here) against the JAX function,
  each drawing its own jitter from the shipped seeds (utils/prng: JAX's
  threefry bits, normals within a few ulp): each sphere's points and
  features in `input_inds` order (each side gathered back through its
  own `unsort`) to 1e-5, labels and masks exactly, region members by
  their points; and `unsort` brings the rows back to `input_inds` order.
- `DeviceVoteAccumulator`: the same buffers after the same updates, with
  and without the radius mask, with spheres of one batch overlapping,
  to 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weasal_tpu.data import resident as jres
from weasal_tpu.train.vote import DeviceVoteAccumulator as JaxVotes
from weasal_tpu_torch.data import resident as pres
from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
from tests._torch_data_setup import (
    JaxSynthConfig, jax_dataset_patches, jax_datasets_for, make_roots,
    port_config_class, port_datasets_for)
from tests._warm_torch import cpu_torch


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "resident")
    with jax_dataset_patches(), cpu_torch():
        jtrain, jval = jax_datasets_for(JaxSynthConfig(), jroot)
        ptrain, pval = port_datasets_for(port_config_class()(), proot)
        plan = ptrain.calibration(num_samples=8)
        yield dict(j=(jtrain, jval), p=(ptrain, pval), plan=plan)


def _payloads(ds, seed, n, plan):
    rng = np.random.default_rng(seed)
    return [ds.sample_sphere(rng, augment=True,
                             max_points=plan.num_points[0], gather=False)
            for _ in range(n)]


def test_pack_payloads_equal(setup):
    ptrain = setup["p"][0]
    plan = setup["plan"]
    src = pres.ResidentBatchSource(ptrain, plan, "cpu")
    payloads = _payloads(ptrain, 1, 3, plan)
    assert any(p["regions"] for p in payloads)
    got = pres.pack_payloads(copy.deepcopy(payloads), plan, ptrain.config,
                             np.random.default_rng(5), base=src.resident.base,
                             shadow=src.resident.shadow)
    want = jres.pack_payloads(copy.deepcopy(payloads), plan, ptrain.config,
                              np.random.default_rng(5),
                              base=src.resident.base,
                              shadow=src.resident.shadow)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_noise(noise_seed, n0):
    return np.array(jax.vmap(lambda s: jax.random.normal(
        jax.random.PRNGKey(s), (n0, 3), jnp.float32))(
            jnp.asarray(noise_seed)))


def _in_input_order(out, key):
    a = np.asarray(out[key])
    unsort = np.asarray(out["unsort"])
    return np.take_along_axis(
        a, unsort.reshape(*unsort.shape, *([1] * (a.ndim - 2))), axis=1)


@pytest.mark.parametrize("split", [0, 1])
def test_assemble_level0_device_equals_jax(setup, split):
    pds = setup["p"][split]
    jds = setup["j"][split]
    plan = setup["plan"]
    cfg = pds.config
    src = pres.ResidentBatchSource(pds, plan, "cpu")
    jsrc_arrays = {k: jnp.asarray(v.numpy())
                   for k, v in src.resident.arrays.items()}
    small, metas = src.next_batch(np.random.default_rng(3 + split),
                                  augment=True)
    spec = pres.feature_spec(pds.name, cfg.in_features_dim)
    assert spec == jres.feature_spec(jds.name, cfg.in_features_dim)
    n0 = plan.num_points[0]
    noise = _jax_noise(small["noise_seed"], n0)

    batch_t = {k: torch.from_numpy(v.astype(np.int64) if k == "noise_seed"
                                   else v)
               for k, v in small.items()}
    got = pres.assemble_level0_device({**batch_t, **src.resident.arrays},
                                      cfg, plan, True, spec)
    want = jax.jit(lambda b: jres.assemble_level0_device(
        b, cfg, plan, True, spec))({**{k: jnp.asarray(v)
                                       for k, v in small.items()},
                                    **jsrc_arrays})
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}

    np.testing.assert_array_equal(got["mask0"], want["mask0"])
    for key in ("rotations", "center_pts", "cloud_lb", "region_masks",
                "region_point_masks", "region_lb"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(_in_input_order(got, "labels"),
                                  _in_input_order(want, "labels"))
    for key in ("points0", "features"):
        np.testing.assert_allclose(_in_input_order(got, key),
                                   _in_input_order(want, key), rtol=0,
                                   atol=1e-5, err_msg=key)

    # Region members: the same points on both sides
    for b in range(len(metas)):
        gp = np.vstack([got["points0"][b], np.zeros((1, 3), np.float32)])
        wp = np.vstack([want["points0"][b], np.zeros((1, 3), np.float32)])
        for r in range(got["region_inds"].shape[1]):
            gsel = got["region_inds"][b, r]
            wsel = want["region_inds"][b, r]
            np.testing.assert_array_equal(gsel < n0, wsel < n0)
            np.testing.assert_allclose(gp[gsel], wp[wsel], atol=1e-5)

    # `unsort` restores input_inds order: the augmented sphere points
    for b, meta in enumerate(metas):
        n = meta["n_real"]
        raw = (pds._cloud_points_f32(meta["cloud_ind"])
               [meta["input_inds"][:n]] - meta["center"])
        expect = ((raw @ small["aug_rot"][b]) * small["aug_scale"][b]
                  + noise[b, :n] * cfg.augment_noise)
        np.testing.assert_allclose(_in_input_order(got, "points0")[b, :n],
                                   expect, atol=1e-4)
        assert got["mask0"][b, :n].all() and not got["mask0"][b, n:].any()


def test_seeded_jitter_is_deterministic(setup):
    a = pres.sphere_noise(torch.tensor([5, 7]), 40)
    b = pres.sphere_noise(torch.tensor([5, 9]), 40)
    assert a.shape == (2, 40, 3)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
    # each sphere's jitter is JAX's draw for its seed (within a few ulp)
    np.testing.assert_allclose(a.numpy(), _jax_noise(np.array([5, 7],
                                                              np.uint32), 40),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("radius", [None, 0.7 * 8.0])
def test_vote_accumulator_equals_jax(setup, radius):
    pds, jds = setup["p"][1], setup["j"][1]
    plan = setup["plan"]
    nc = pds.config.num_classes
    src = pres.ResidentBatchSource(pds, plan, "cpu")
    jres_clouds = jres.ResidentClouds(jds)
    np.testing.assert_array_equal(
        np.asarray(jres_clouds.arrays["res_points"]),
        src.resident.arrays["res_points"].numpy())
    r_sq = None if radius is None else radius ** 2
    acc = DeviceVoteAccumulator(src.resident, nc, smooth=0.95,
                                radius_sq=r_sq)
    jacc = JaxVotes(jres_clouds, nc, smooth=0.95, radius_sq=r_sq)
    start = [np.random.default_rng(1).random((n, nc)).astype(np.float32)
             for n in src.resident.sizes]
    acc.load(start)
    jacc.load(start)
    rng = np.random.default_rng(9)
    n0 = plan.num_points[0]
    for it in range(3):
        small, metas = src.next_batch(rng, augment=False)
        if it == 1:
            # Sphere 1 repeats sphere 0 with a shifted center: overlapping
            # writes in one batch must apply in sphere order
            for k in ("flat_inds", "center_pts"):
                small[k][1] = small[k][0]
            small["center_pts"][1] += 1.5
        probs = np.random.default_rng(100 + it).random(
            (len(metas), n0, nc)).astype(np.float32)
        acc.update(torch.from_numpy(probs),
                   {"flat_inds": torch.from_numpy(small["flat_inds"]),
                    "center_pts": torch.from_numpy(small["center_pts"]),
                    **src.resident.arrays})
        jacc.update(jnp.asarray(probs),
                    {"flat_inds": jnp.asarray(small["flat_inds"]),
                     "center_pts": jnp.asarray(small["center_pts"]),
                     **jres_clouds.arrays})
    for got, want, s in zip(acc.materialize(), jacc.materialize(), start):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert not np.array_equal(got, s)
