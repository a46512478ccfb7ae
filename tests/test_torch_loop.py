"""The port's weak-label training loop against the JAX package's.

One JAX `ModelTrainer` (device pyramid, level-0 input, 2 epochs of 3
steps, 2 validation batches an epoch) and the port's trainer on its
level-0 input train from the same initial weights and optimizer state
(carried across by `from_jax_variables` and `from_jax_opt_state`) on the
same synthetic scene, each package with a root of its own. Tolerances:
- the losses of each step, captured before they are written, rtol 1e-4
  (f32 sums in other orders; the JAX pyramid's radius search expands
  |q|^2 + |s|^2 - 2 q.s where the port's is exact), and the printed
  training logs one unit of their last digit apart;
- the smoothed validation probabilities 1e-3, the mIoU 1 point;
- the final parameters rtol 1e-3, atol 1e-5 x the largest change of any
  parameter over the run, and the BatchNorm statistics rtol 1e-3, atol
  1e-5 x their largest |value| (see the test).
Then the port alone: its resident and level-0 inputs give the same
losses with `augment_noise` 0 (rtol 1e-5, each epoch from one state: see
the test); a checkpoint restores
parameters, statistics, momentum, epoch and learning rate exactly, and a
run resumed at `max_epoch` still writes `current_chkp.tar`; removing the
kill file stops training and leaves a checkpoint;
`parameters.txt` loads across the packages both ways; and the entry point
runs end to end with `--preset quick --device cpu`.
"""

import os

import jax
import numpy as np
import pytest
import torch

from weasal_tpu.config import Config as JaxConfig
from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu_torch import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.config import Config as PortConfig
from weasal_tpu_torch.data import level0 as port_level0
from weasal_tpu_torch.train import trainer as port_trainer
from weasal_tpu_torch.train.trainer import ModelTrainer
from tests._torch_data_setup import (
    JaxSynthConfig, jax_dataset_patches, jax_datasets_for, make_roots,
    port_config_class, port_datasets_for)
from tests._warm_torch import cpu_torch
from tests.test_torch_model import _as_dicts

LOOP = dict(max_epoch=2, epoch_steps=3, validation_size=2,
            lr_decays={1: 0.5}, saving=True)


def _capture_losses(trainer, loss_at):
    """Wrap the trainer's `_flush_log` to record (epoch, step, loss) of
    every step at full precision before the log rounds it."""
    seen = []
    flush = trainer._flush_log

    def recording(pending, log_file, al_iteration):
        seen.extend((p[0], p[1], float(p[loss_at])) for p in pending)
        return flush(pending, log_file, al_iteration)

    trainer._flush_log = recording
    return seen


def _log_rows(path):
    with open(os.path.join(path, "training_iteration0.txt")) as f:
        return [r.split() for r in f.readlines()[1:]]


def _mious(path):
    with open(os.path.join(path, "val_IoUs.txt")) as f:
        return [100 * np.mean([float(v) for v in line.split()])
                for line in f]


def _port_state(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "loop")
    base = tmp_path_factory.mktemp("loop_logs")
    with jax_dataset_patches(), cpu_torch():
        jcfg = JaxSynthConfig()
        jcfg.device_pyramid = True
        jcfg.resident_clouds = False
        for k, v in LOOP.items():
            setattr(jcfg, k, v)
        jcfg.saving_path = str(base / "jax")
        jtrain, jval = jax_datasets_for(jcfg, jroot)
        jt = JaxTrainer(jcfg, jtrain)
        init_vars = _as_dicts(jax.device_get(
            {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
             "constants": jt.state.constants}))
        init_opt = jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(jt.state.opt_state))
        jseen = _capture_losses(jt, 2)
        jt.train(jtrain, jval)

        defaults = dict(resident_clouds=False,
                        saving_path=str(base / "port"), **LOOP)

        def make_cfg(**overrides):
            return port_config_class(**{**defaults, **overrides})()

        pcfg = make_cfg()
        ptrain, pval = port_datasets_for(pcfg, proot)
        pt = ModelTrainer(pcfg, ptrain, device="cpu")
        assert jt.plan.num_points == pt.plan.num_points
        pt.model.load_state_dict(from_jax_variables(init_vars))
        pt.opt_state = from_jax_opt_state(init_opt)
        pseen = _capture_losses(pt, 2)
        pt.train(ptrain, pval)
        yield dict(jax=(jt, jcfg, jseen), port=(pt, pcfg, pseen),
                   init_vars=init_vars,
                   datasets=(ptrain, pval), make_cfg=make_cfg, base=base,
                   proot=proot)


def test_losses_match_jax_trainer(runs):
    jt, jcfg, jseen = runs["jax"]
    pt, pcfg, pseen = runs["port"]
    assert len(pseen) == len(jseen) >= 4
    for (pe, ps, pl), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
    prow, jrow = _log_rows(pcfg.saving_path), _log_rows(jcfg.saving_path)
    assert len(prow) == len(jrow) == len(jseen)
    for p, j in zip(prow, jrow):
        assert p[:2] == j[:2]
        assert abs(float(p[2]) - float(j[2])) <= 1.0e-3 + 1e-9
        assert float(p[3]) == float(j[3]) == 0.0
    assert pt.epoch == jt.epoch == 2
    assert pt.lr == jt.lr == pcfg.learning_rate * 0.5


def test_validation_matches_jax_trainer(runs):
    jt, jcfg, _ = runs["jax"]
    pt, pcfg, _ = runs["port"]
    assert len(pt.validation_probs) == len(jt.validation_probs)
    for got, want in zip(pt.validation_probs, jt.validation_probs):
        assert got.shape == want.shape
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    pm, jm = _mious(pcfg.saving_path), _mious(jcfg.saving_path)
    assert len(pm) == len(jm) == 2
    np.testing.assert_allclose(pm, jm, rtol=0, atol=1.0)


def test_final_parameters_match_jax_trainer(runs):
    jt, _, _ = runs["jax"]
    pt, _, _ = runs["port"]
    want = from_jax_variables(_as_dicts(jax.device_get(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
         "constants": jt.state.constants})))
    got = pt.model.state_dict()
    assert set(got) == set(want)
    # atol: a trained parameter's error is the learning rate times the
    # error of its accumulated gradients, which follows the largest terms
    # of the gradients, not the parameter's own size (the elevation head's
    # BatchNorm biases stay ~1e-7, all of it update noise, and how XLA
    # splits its reductions alone moves their error across 1e-3 of that).
    # So parameters take 1e-5 x the largest change of any parameter in the
    # run; buffers (BatchNorm statistics, kernel points) 1e-5 x their own
    # largest |value|.
    init = from_jax_variables(runs["init_vars"])
    params = {n for n, _ in pt.model.named_parameters()}
    moved = max(float((want[k] - init[k]).abs().max()) for k in params)
    # so the atol is tighter than 1e-5 x the model's largest |parameter|
    assert 0 < moved < max(float(want[k].abs().max()) for k in params)
    for key, ref in want.items():
        scale = moved if key in params else float(ref.abs().max())
        np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=1e-3,
                                   atol=1e-5 * scale, err_msg=key)


def test_parameters_txt_loads_across_packages(runs):
    _, jcfg, _ = runs["jax"]
    _, pcfg, _ = runs["port"]
    with open(os.path.join(jcfg.saving_path, "parameters.txt")) as f:
        jtext = f.read()
    with open(os.path.join(pcfg.saving_path, "parameters.txt")) as f:
        assert f.read() == jtext
    for saver, loader_cls in ((jcfg, PortConfig), (pcfg, JaxConfig)):
        loaded = loader_cls()
        loaded.load(saver.saving_path)
        keys = [line.split()[0] for line in jtext.splitlines()
                if len(line.split()) > 2 and line[0] != "#"]
        assert len(keys) > 50
        for key in keys:
            if key == "lr_decay_epochs":
                assert loaded.lr_decays == saver.lr_decays
            elif key.startswith("contrast_thd"):
                continue
            else:
                want = getattr(saver, key)
                got = getattr(loaded, key)
                if isinstance(want, float):
                    assert got == pytest.approx(want, rel=1e-6), key
                else:
                    assert got == want, key


def test_checkpoint_restores_training_state(runs, tmp_path):
    pt, pcfg, _ = runs["port"]
    ptrain, pval = runs["datasets"]
    chkp = os.path.join(pcfg.saving_path, "checkpoints", "current_chkp.tar")
    cfg = runs["make_cfg"](saving_path=str(tmp_path / "resumed"),
                           num_classes=pcfg.num_classes)
    with cpu_torch():
        resumed = ModelTrainer(cfg, ptrain, chkp_path=chkp, device="cpu",
                               generator=torch.Generator().manual_seed(7))
        assert resumed.epoch == pt.epoch == 2
        want = _port_state(pt)
        got = resumed.model.state_dict()
        assert any(k.endswith(".var") for k in want)
        for key in want:
            assert torch.equal(got[key], want[key]), key
        assert set(resumed.opt_state) == set(pt.opt_state)
        for key in pt.opt_state:
            assert torch.equal(resumed.opt_state[key], pt.opt_state[key])
        # Resumed at max_epoch: no epoch runs, the learning rate is the
        # decayed one, and current_chkp.tar is written all the same
        resumed.train(ptrain, None)
    assert resumed.lr == pt.lr
    assert resumed.epoch == 2
    assert os.path.exists(os.path.join(cfg.saving_path, "checkpoints",
                                       "current_chkp.tar"))
    assert not os.path.exists(os.path.join(cfg.saving_path,
                                           "running_PID.txt"))


def test_removing_the_kill_file_stops_training(runs, tmp_path,
                                               monkeypatch):
    cfg = runs["make_cfg"](saving_path=str(tmp_path / "killed"))
    ptrain, _ = port_datasets_for(cfg, runs["proot"])
    pid_file = os.path.join(cfg.saving_path, "running_PID.txt")

    class Killing(port_level0.Level0BatchSource):
        """Removes the kill file while it samples the second batch."""
        calls = 0

        def next_batch(self, rng, augment=None):
            Killing.calls += 1
            if Killing.calls == 2:
                os.remove(pid_file)
            return super().next_batch(rng, augment)

    monkeypatch.setattr(port_trainer, "Level0BatchSource", Killing)
    with cpu_torch():
        trainer = ModelTrainer(cfg, ptrain, device="cpu")
        trainer.train(ptrain, None)
    # Stopped inside epoch 0, after at most the batch sampled before the
    # removal; the state is still saved for a resume
    assert trainer.epoch == 0 and trainer.step <= 1
    assert len(_log_rows(cfg.saving_path)) == trainer.step
    assert not os.path.exists(pid_file)
    saved = torch.load(os.path.join(cfg.saving_path, "checkpoints",
                                    "current_chkp.tar"), weights_only=True)
    assert saved["epoch"] == 0


class _AlignedLevel0Source(port_level0.Level0BatchSource):
    """The level-0 source drawing what the resident source draws: one
    `noise_seed` per sphere after packing."""

    def next_batch(self, rng, augment=None):
        arrays, metas = super().next_batch(rng, augment)
        rng.integers(0, 2 ** 31, size=len(metas))
        return arrays, metas


def _no_jitter_draw(ds):
    """With augment_noise 0 the jitter is 0 on both inputs, but the
    level-0 sampler still draws it: skip that draw."""
    def transform(points, rng):
        scale, R = ds.augmentation_params(rng, points.shape[1])
        return (points @ R) * scale, scale, R
    ds.augmentation_transform = transform


def test_resident_and_level0_inputs_give_the_same_losses(runs, tmp_path,
                                                         monkeypatch):
    trainers = {}
    with cpu_torch():
        for resident in (True, False):
            cfg = runs["make_cfg"](
                resident_clouds=resident, augment_noise=0.0,
                saving_path=str(tmp_path / f"res{int(resident)}"))
            ptrain, pval = port_datasets_for(cfg, runs["proot"])
            if not resident:
                monkeypatch.setattr(port_trainer, "Level0BatchSource",
                                    _AlignedLevel0Source)
                _no_jitter_draw(ptrain)
                _no_jitter_draw(pval)
            trainer = ModelTrainer(cfg, ptrain, device="cpu")
            assert trainer.resident == resident
            trainers[resident] = (trainer, ptrain, pval,
                                  _capture_losses(trainer, 2))
        # One ulp between the inputs (the host subtracts the f64 center,
        # the device the f32 one; numpy's matmul against per-component
        # sums) grows over the updates, from 1e-7 in epoch 0 to 6e-5 by
        # the end of a second epoch: so each epoch starts the level-0
        # trainer from the resident one's state (parameters, statistics,
        # momentum), and each epoch's losses are held to rtol 1e-5
        res, lev = trainers[True][0], trainers[False][0]
        for epoch in range(LOOP["max_epoch"]):
            lev.model.load_state_dict(res.model.state_dict())
            lev.opt_state = {k: v.clone() for k, v in res.opt_state.items()}
            for trainer, ptrain, pval, _ in trainers.values():
                trainer.config.max_epoch = epoch + 1
                trainer.train(ptrain, pval)
                assert trainer.epoch == epoch + 1
    seen = {k: v[3] for k, v in trainers.items()}
    assert len(seen[True]) == len(seen[False]) >= 4
    assert {a[0] for a in seen[True]} == set(range(LOOP["max_epoch"]))
    for (a, b) in zip(seen[True], seen[False]):
        assert a[:2] == b[:2]
        np.testing.assert_allclose(a[2], b[2], rtol=1e-5)
    np.testing.assert_allclose(res.last_mIoU, lev.last_mIoU, atol=0.1)


def test_entry_point_quick_preset_on_cpu(tmp_path):
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    root = make_vaihingen_like_root(str(tmp_path / "Vaihingen3D"),
                                    extent=30.0, density=5.0, seed=3)
    log = str(tmp_path / "log")
    with cpu_torch():
        trainer = run([log, "--data_root", root, "--preset", "quick",
                       "--device", "cpu"])
        with pytest.raises(NotImplementedError, match="slice D"):
            run([log, "--data_root", root, "--device", "cpu",
                 "--al_iterations", "2"])
    rows = _log_rows(log)
    assert len(rows) == sum(e["steps"] for e in trainer.epoch_times) >= 1
    assert all(np.isfinite(float(r[2])) for r in rows)
    assert len(_mious(log)) == 1
    assert os.path.exists(os.path.join(log, "checkpoints",
                                       "current_chkp.tar"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run([log, "--data_root", root, "--preset", "quick"])


def test_entry_point_seed_fixes_the_potentials(tmp_path):
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    root = make_vaihingen_like_root(str(tmp_path / "Vaihingen3D"),
                                    extent=30.0, density=5.0, seed=3)
    pots = []
    with cpu_torch():
        for i, seed in enumerate(("5", "5", "6")):
            trainer = run([str(tmp_path / f"log{i}"), "--data_root", root,
                           "--preset", "quick", "--device", "cpu",
                           "--max_epoch", "0", "--seed", seed])
            pots.append([p.copy() for ds in trainer.datasets
                         for p in ds.potentials])
    assert all(np.array_equal(a, b) for a, b in zip(pots[0], pots[1]))
    assert not all(np.array_equal(a, b) for a, b in zip(pots[0], pots[2]))


@pytest.mark.parametrize("value,device,want", [
    ("auto", "cuda", True), ("auto", "cpu", False),
    (True, "cpu", True), (False, "cuda", False)])
def test_resolve_resident(value, device, want):
    assert port_trainer.resolve_resident(value, torch.device(device)) == want


@pytest.mark.parametrize("value", ["on", "true", "1", ""])
def test_resolve_resident_refuses_other_values(value):
    with pytest.raises(ValueError, match="'auto' or a bool"):
        port_trainer.resolve_resident(value, torch.device("cpu"))
