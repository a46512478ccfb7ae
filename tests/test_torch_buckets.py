"""The small-sphere plan bucket against the JAX package's.

- `calibrate_shape_plan(bucket_percentile=...)` on the same spheres and
  seed: equal plans, `small` included (a percentile of 100 makes none);
- the datasets' calibration with `plan_bucket_percentile` 80 on the
  synthetic scene: equal plans with a bucket, under JAX's cache key;
- `ResidentBatchSource(bucketed=True)`: twenty batches equal array for
  array, with equal `bucket` tags, both buckets among them;
- a bucketed epoch of the port's trainer (resident input, K = 1, on the
  CPU) against the JAX trainer's from the same initial weights, both with
  `augment_noise` 0 (see tests/test_torch_dispatch.py): the same steps,
  their losses to rtol 1e-4 and the log rows to atol 2e-3 (as in
  tests/test_torch_loop.py), and the same dispatches per bucket.
"""

import re

import jax
import numpy as np
import pytest

from weasal_tpu.data import resident as jres
from weasal_tpu.data.batching import calibrate_shape_plan as jax_calibrate
from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu_torch import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.data import resident as pres
from weasal_tpu_torch.data.batching import ShapePlan, calibrate_shape_plan
from weasal_tpu_torch.data.demo import demo_sphere
from weasal_tpu_torch.train.trainer import ModelTrainer
from tests._torch_data_setup import (
    JaxSynthConfig, jax_dataset_patches, jax_datasets_for, make_roots,
    port_config_class, port_datasets_for)
from tests._warm_torch import cpu_torch
from tests.test_torch_loop import _capture_losses, _log_rows
from tests.test_torch_model import _as_dicts

BUCKET = 80.0
LOOP = dict(max_epoch=1, epoch_steps=8, validation_size=1, saving=True,
            resident_clouds=True, plan_bucket_percentile=BUCKET,
            augment_noise=0.0)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "buckets")
    with jax_dataset_patches(), cpu_torch():
        jcfg = JaxSynthConfig()
        jcfg.device_pyramid = True
        for k, v in LOOP.items():
            setattr(jcfg, k, v)
        pcfg = port_config_class(**LOOP)()
        jds = jax_datasets_for(jcfg, jroot, splits=("training",))[0]
        pds = port_datasets_for(pcfg, proot, splits=("training",))[0]
        yield dict(jds=jds, pds=pds, jcfg=jcfg, pcfg=pcfg, roots=(jroot,
                                                                  proot),
                   base=tmp_path_factory.mktemp("bucket_logs"))


@pytest.mark.parametrize("percentile", [50.0, 80.0, 100.0])
def test_calibrate_shape_plan_bucket_equals_jax(percentile):
    cfg = port_config_class(num_classes=9)()
    rng = np.random.default_rng(3)
    clouds = [demo_sphere(rng, cfg, density=d)["points"]
              for d in (2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0, 11.0)]
    got = calibrate_shape_plan(clouds, cfg, region_budget=(4, 16),
                               rng=np.random.default_rng(1),
                               bucket_percentile=percentile)
    want = jax_calibrate(clouds, cfg, region_budget=(4, 16),
                         rng=np.random.default_rng(1),
                         bucket_percentile=percentile)
    assert ShapePlan.from_dict(vars(want)) == got
    assert (got.small is None) == (percentile == 100.0)
    if got.small is not None:
        assert got.derive_small().num_points == got.small["num_points"]
        assert got.small["num_points"][0] < got.num_points[0]


def test_dataset_calibration_with_bucket_equals_jax(both):
    jplan = both["jds"].calibration()
    pplan = both["pds"].calibration()
    assert pplan.small is not None
    assert ShapePlan.from_dict(vars(jplan)) == pplan
    assert both["pds"]._plan_key() == both["jds"]._plan_key()
    assert both["pds"]._plan_key().endswith("_b80")


def test_bucketed_source_batches_equal_jax(both):
    jds, pds = both["jds"], both["pds"]
    plan = pds.calibration()
    psrc = pres.ResidentBatchSource(pds, plan, "cpu", bucketed=True)
    jsrc = jres.ResidentBatchSource(jds, jds.calibration(), bucketed=True)
    prng, jrng = np.random.default_rng(21), np.random.default_rng(21)
    tags = []
    for _ in range(20):
        got, gmetas = psrc.next_batch(prng, augment=True)
        want, wmetas = jsrc.next_batch(jrng, augment=True)
        assert [m["bucket"] for m in gmetas] == \
            [m["bucket"] for m in wmetas]
        tags.append(gmetas[0]["bucket"])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n0 = (psrc.small_plan if tags[-1] == "small" else plan).num_points[0]
        assert got["flat_inds"].shape[1] == n0
    assert {"small", "large"} <= set(tags)
    for a, b in zip(pds.potentials, jds.potentials):
        np.testing.assert_array_equal(a, b)


def _bucket_line(text):
    return re.findall(r"\[buckets\] epoch 0 dispatches: (.*)", text)


def test_bucketed_epoch_matches_jax_trainer(both, capsys):
    jroot, proot = both["roots"]
    base = both["base"]
    with jax_dataset_patches(), cpu_torch():
        jcfg = both["jcfg"]
        jcfg.saving_path = str(base / "jax")
        jtrain = jax_datasets_for(jcfg, jroot, splits=("training",))[0]
        jt = JaxTrainer(jcfg, jtrain)
        assert jt.plan_small is not None
        init_vars = _as_dicts(jax.device_get(
            {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
             "constants": jt.state.constants}))
        init_opt = jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(jt.state.opt_state))
        jseen = _capture_losses(jt, 2)
        capsys.readouterr()
        jt.train(jtrain, None)
        jlines = _bucket_line(capsys.readouterr().out)

        pcfg = port_config_class(saving_path=str(base / "port"), **LOOP)()
        ptrain = port_datasets_for(pcfg, proot, splits=("training",))[0]
        pt = ModelTrainer(pcfg, ptrain, device="cpu")
        assert pt.plan_small is not None
        assert pt.plan_small.num_points == jt.plan_small.num_points
        pt.model.load_state_dict(from_jax_variables(init_vars))
        pt.opt_state = from_jax_opt_state(init_opt)
        pseen = _capture_losses(pt, 2)
        pt.train(ptrain, None)
        plines = _bucket_line(capsys.readouterr().out)

    assert plines == jlines and len(plines) == 1
    buckets = pt.epoch_times[0]["buckets"]
    assert buckets.get("small", 0) >= 1 and buckets.get("large", 0) >= 1
    assert plines[0] == " ".join(f"{t}={c}" for t, c in
                                 sorted(buckets.items()))
    assert len(pseen) == len(jseen) == sum(buckets.values())
    for (pe, ps, pl), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
    prow, jrow = _log_rows(pcfg.saving_path), _log_rows(jcfg.saving_path)
    assert len(prow) == len(jrow)
    for p, j in zip(prow, jrow):
        np.testing.assert_allclose([float(v) for v in p[:5]],
                                   [float(v) for v in j[:5]], atol=2e-3)
