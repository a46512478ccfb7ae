"""Multi-step dispatch: the port's trainer with `steps_per_dispatch` 3
against itself with K = 1 and against the JAX trainer with K = 3.

Counterpart of tests/test_resident.py's
`test_packed_dispatch_matches_sequential`, on the resident input (the
port's jitter is JAX's threefry draw, utils/prng), one epoch of 4 batches
(one full pack of 3 and a tail of 1), from the JAX trainer's initial
weights. On the CPU the port runs its step bodies eagerly on the same
static input tensors a captured graph would use, so:
- K = 3 against K = 1 in the port: the same steps in the same order, so
  losses, log rows (all but the time column) and the final state are
  bit for bit equal;
- the port's K = 3 against the JAX trainer's K = 3, both with
  `augment_noise` 0, at that test's tolerances: log rows to atol 2e-3,
  the losses at full precision to rtol 1e-4 (f32 sums in other orders,
  as in tests/test_torch_loop.py), and the final parameters to rtol
  1e-4, atol 1e-5. With the jitter on, the two packages' normals differ
  by up to 4 ulp (tests/test_torch_prng.py: XLA's log1p and fused
  multiply-adds round otherwise); that moves points across voxel
  boundaries of the pyramid and the parameters apart by ~1e-3 relative
  in 4 steps, which says nothing of the dispatch.
"""

import os

import jax
import numpy as np
import pytest
import torch

from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu_torch import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.train.trainer import ModelTrainer
from tests._torch_data_setup import (
    JaxSynthConfig, jax_dataset_patches, jax_datasets_for, make_roots,
    port_config_class, port_datasets_for)
from tests._warm_torch import cpu_torch
from tests.test_torch_loop import _capture_losses, _log_rows
from tests.test_torch_model import _as_dicts

LOOP = dict(max_epoch=1, epoch_steps=4, validation_size=1, saving=True,
            resident_clouds=True)
K = 3


def _capture_packed_losses(trainer):
    """`_capture_losses` for the JAX trainer's packed log entries (a [K]
    loss vector and the count of its real steps per entry)."""
    seen = []
    flush = trainer._flush_log

    def recording(pending, log_file, al_iteration):
        for p in pending:
            losses = np.atleast_1d(np.asarray(p[2]))
            seen.extend((p[0], p[1] + i, float(losses[i]))
                        for i in range(p[6]))
        return flush(pending, log_file, al_iteration)

    trainer._flush_log = recording
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "dispatch")
    base = tmp_path_factory.mktemp("dispatch_logs")
    with jax_dataset_patches(), cpu_torch():
        jcfg = JaxSynthConfig()
        jcfg.device_pyramid = True
        jcfg.steps_per_dispatch = K
        for k, v in LOOP.items():
            setattr(jcfg, k, v)
        jcfg.augment_noise = 0.0
        jcfg.saving_path = str(base / "jax")
        (jtrain,) = jax_datasets_for(jcfg, jroot, splits=("training",))
        jt = JaxTrainer(jcfg, jtrain)
        init_vars = _as_dicts(jax.device_get(
            {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
             "constants": jt.state.constants}))
        init_opt = jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(jt.state.opt_state))
        jseen = _capture_packed_losses(jt)
        jt.train(jtrain, None)

        # The jitter-free run first: its calibration (on jittered spheres
        # otherwise) makes the plan the JAX trainer made, and the root's
        # plan cache then serves it to the other two
        port = {}
        for k, noise in ((K, 0.0), (1, None), (K, None)):
            extra = {} if noise is None else dict(augment_noise=noise)
            cfg = port_config_class(steps_per_dispatch=k,
                                    saving_path=str(base / f"port{k}_{noise}"),
                                    **LOOP, **extra)()
            (ptrain,) = port_datasets_for(cfg, proot, splits=("training",))
            pt = ModelTrainer(cfg, ptrain, device="cpu")
            assert pt.plan == port.get((K, 0.0), (pt,))[0].plan
            assert pt.resident and not pt.graphed
            assert pt._resolve_steps_per_dispatch() == k
            pt.model.load_state_dict(from_jax_variables(init_vars))
            pt.opt_state = from_jax_opt_state(init_opt)
            seen = _capture_losses(pt, 2)
            pt.train(ptrain, None)
            port[k, noise] = (pt, cfg, seen)
        yield dict(jax=(jt, jcfg, jseen), port=port)


def _jax_state(jt):
    return from_jax_variables(_as_dicts(jax.device_get(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
         "constants": jt.state.constants})))


def test_packed_dispatch_equals_single_steps(runs):
    (p1, c1, s1), (p3, c3, s3) = runs["port"][1, None], runs["port"][K, None]
    assert len(s1) == len(s3) >= K + 1        # a full pack and a tail
    assert s1 == s3
    r1, r3 = _log_rows(c1.saving_path), _log_rows(c3.saving_path)
    assert [r[:5] for r in r1] == [r[:5] for r in r3]
    assert p1.epoch_times[0]["steps"] == p3.epoch_times[0]["steps"] \
        == len(r1)
    want = p1.model.state_dict()
    for key, value in p3.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    for key, value in p3.opt_state.items():
        assert torch.equal(value, p1.opt_state[key]), key
    # the K-step runner once a full pack, the one-step runner for the tail
    n = len(s3)
    assert p3.graph_counts()["train_runs_by"] == {f"large x{K}": n // K,
                                                  "large x1": n % K}


def test_packed_dispatch_matches_jax_trainer(runs):
    jt, jcfg, jseen = runs["jax"]
    pt, pcfg, pseen = runs["port"][K, 0.0]
    assert pt.plan.num_points == jt.plan.num_points
    assert len(pseen) == len(jseen) >= K + 1
    for (pe, ps, pl), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
    prow, jrow = _log_rows(pcfg.saving_path), _log_rows(jcfg.saving_path)
    assert len(prow) == len(jrow)
    for p, j in zip(prow, jrow):
        np.testing.assert_allclose([float(v) for v in p[:5]],
                                   [float(v) for v in j[:5]], atol=2e-3)
    want = _jax_state(jt)
    got = pt.model.state_dict()
    params = {n for n, _ in pt.model.named_parameters()}
    for key in params:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)



def test_entry_point_packs_buckets_audits_and_traces(tmp_path, monkeypatch):
    """The entry point's `--steps_per_dispatch` and `--plan_buckets` on
    the CPU (quick preset, one epoch of 10 batches): the config takes
    them (parameters.txt records the bucket, the plan has one; on the
    CPU's level-0 input only the full plan trains, as in the JAX
    trainer), the steps run in packs of 2, plan_saturation.txt gets one
    line with
    `kernel_drops 0`, and `WEASAL_TRACE_DIR` writes the profiler window
    of epoch 0 (its start moved from step 20 to step 2, so that a short
    epoch reaches it, and a flush after every pack: opened at the first
    flush past it, closed 2 steps later)."""
    from weasal_tpu_torch.train import trainer as port_trainer
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    root = make_vaihingen_like_root(str(tmp_path / "Vaihingen3D"),
                                    extent=30.0, density=5.0, seed=3)
    log, traces = str(tmp_path / "log"), tmp_path / "traces"
    monkeypatch.setenv("WEASAL_TRACE_DIR", str(traces))
    monkeypatch.setattr(port_trainer, "TRACE_START", 2)
    monkeypatch.setattr(port_trainer, "TRACE_STEPS", 2)
    monkeypatch.setattr(port_trainer, "FLUSH_STEPS", 2)  # a flush a pack
    with cpu_torch():
        trainer = run([log, "--data_root", root, "--preset", "quick",
                       "--device", "cpu", "--epoch_steps", "10", "--seed",
                       "0", "--steps_per_dispatch", "2", "--plan_buckets",
                       "80", "--validation_size", "1"])
    cfg = trainer.config
    assert cfg.steps_per_dispatch == 2 and cfg.plan_bucket_percentile == 80
    assert trainer._resolve_steps_per_dispatch() == 2
    with open(os.path.join(log, "parameters.txt")) as f:
        assert "plan_bucket_percentile = 80.000000\n" in f.read()
    assert trainer.plan.small is not None and trainer.plan_small is None
    steps = trainer.epoch_times[0]["steps"]
    assert steps >= 4 and len(_log_rows(log)) == steps
    assert trainer.epoch_times[0]["buckets"] == {"large": steps}
    runs_by = trainer.graph_counts()["train_runs_by"]
    assert runs_by["large x2"] == steps // 2
    assert runs_by.get("large x1", 0) == steps % 2
    assert set(runs_by) <= {"large x1", "large x2"}
    with open(os.path.join(log, "plan_saturation.txt")) as f:
        lines = f.readlines()
    assert len(lines) == 1 and lines[0].startswith("epoch 1 conv_sat ")
    assert lines[0].rstrip().endswith("kernel_drops 0")
    assert sorted(os.listdir(traces)) == ["trace_epoch0.json"]
