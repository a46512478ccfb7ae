"""The port's host-pyramid path (`device_pyramid = False`) against the
JAX package's, on the CPU.

Both packages sample one synthetic scene (each a root of its own, the
same seeds, tests/_torch_data_setup.py), so their host batches are equal
(tests/test_torch_host_batch.py) and the steps below differ only by f32
sums in other orders. From the JAX trainer's initial state, carried
across by `from_jax_variables` / `from_jax_opt_state`:
- one weak-label and one pseudo-label step on a host batch against the
  JAX `step_core` with `device_pyramid=False` (trainer.py:257-275, no
  search-overflow count): the loss rtol 1e-4; the parameters, the
  BatchNorm statistics and the momentum trace after the step (the
  clipped gradients plus weight decay, the trace starting at zero) rtol
  1e-4, atol 1e-5 x each tensor's largest |value|; the drop vector zero;
- the eval probabilities of a host batch, atol 1e-5;
- one weak-label epoch (3 steps through `ParallelSphereBuilder`, 2
  input threads, then 2 validation batches smoothed on the host) and one pseudo-label epoch of `ModelTrainer` against the JAX
  trainer's host path: each step's loss rtol 1e-4 (WL) and 1e-5 (PL),
  as tests/test_torch_dales_loop.py holds the fused path's; the smoothed
  validation probabilities atol 1e-4;
- the tester's host votes (the JAX tester's host branch, its
  `test_radius_ratio` mask on the augmented points) on the training
  clouds, atol 1e-5, and the acquisition's anchor ledger equal;
- `--host_pyramid --device cpu --preset quick --al_iterations 0`
  through both training entry points and `test_models --host_pyramid`.
torch runs on one intra-op thread.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weasal_tpu.data import datasets as jax_datasets
from weasal_tpu.train.tester import ModelTester as JaxTester
from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu_torch import (eval_step, from_jax_opt_state,
                              from_jax_variables, train_step)
from weasal_tpu_torch.data.datasets import (Vaihingen3DPLDataset,
                                            Vaihingen3DWLDataset)
from weasal_tpu_torch.data.loader import HostPyramidSource
from weasal_tpu_torch.models.architectures import model_for_config
from weasal_tpu_torch.train.optim import init_opt_state
from weasal_tpu_torch.train.tester import ModelTester
from weasal_tpu_torch.train.trainer import ModelTrainer
from tests._torch_data_setup import (
    POTENTIAL_SEED, JaxSynthConfig, jax_dataset_patches, jax_datasets_for,
    make_roots, port_config_class, port_datasets_for)
from tests._warm_torch import cpu_torch
from tests.test_torch_loop import _capture_losses, _log_rows
from tests.test_torch_model import _as_dicts
from tests.test_torch_pl_loop import (_datasets, _jax_ds, configs,
                                      write_pseudo_labels)
from tests.test_torch_train import _assert_close, _np_tree

# Two builder threads (a ParallelSphereBuilder in both packages): the
# suite's multi-device JAX tests stall when the host is oversubscribed
EPOCH = dict(max_epoch=1, epoch_steps=3, validation_size=2, saving=True,
             resident_clouds=False, device_pyramid=False, input_threads=2)
VOTE = dict(in_radius=6.0, validation_size=3, saving=False,
            resident_clouds=False, device_pyramid=False,
            added_labels_per_epoch=4)


def _init_state(jt):
    variables = _as_dicts(jax.device_get(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
         "constants": jt.state.constants}))
    opt = jax.tree_util.tree_map(np.asarray,
                                 jax.device_get(jt.state.opt_state))
    return variables, opt


def _port_model(pcfg, ds, variables, opt):
    model = model_for_config(pcfg, ds.label_values, ds.ignored_labels)
    model.load_state_dict(from_jax_variables(variables))
    state = init_opt_state(model)
    for k, v in from_jax_opt_state(opt).items():
        state[k].copy_(v)
    return model, state


def _one_step(jt, jds, pcfg, pds, variables, opt, weak):
    """One step of each package on the same host batch (one with regions
    in weak mode) from the initial state, and the eval probabilities of
    the batch after it: (port, JAX) pairs by name."""
    jrng, prng = np.random.default_rng(3), np.random.default_rng(3)
    plan = pds.calibration()
    while True:
        jbatch, _ = jds.next_batch(jrng, jt.plan)
        pbatch, _ = pds.next_batch(prng, plan)
        if not weak or pbatch.region_masks.any():
            break
    new, jloss, _reg, jacc, jdrops = jt._train_step(
        jt.state, jbatch, jnp.float32(jt.lr), jax.random.PRNGKey(0))
    model, state = _port_model(pcfg, pds, variables, opt)
    loss, acc, drops = train_step(model, state, pbatch, pcfg, plan,
                                  pcfg.learning_rate, device="cpu")
    jprobs = np.asarray(jt._eval_step(new, jbatch)[0])
    probs = eval_step(model, pbatch, pcfg, plan, device="cpu").numpy()
    mask = pbatch.masks[0]
    return dict(
        loss=(float(loss), float(jloss)), acc=(float(acc), float(jacc)),
        drops=(drops.numpy(), np.asarray(jdrops)),
        state=({k: v.clone() for k, v in model.state_dict().items()},
               from_jax_variables({
                   "params": _np_tree(new.params),
                   "batch_stats": _np_tree(new.batch_stats),
                   "constants": variables["constants"]})),
        trace=(state, from_jax_opt_state(_np_tree(new.opt_state))),
        probs=(probs[mask], jprobs[mask]))


def _assert_step(seen):
    np.testing.assert_allclose(*seen["loss"], rtol=1e-4)
    np.testing.assert_allclose(*seen["acc"], rtol=1e-5)
    assert not any(d.any() for d in seen["drops"])
    _assert_close(*seen["state"], rtol=1e-4, atol_rel=1e-5)
    _assert_close(*seen["trace"], rtol=1e-4, atol_rel=1e-5)
    np.testing.assert_allclose(*seen["probs"], rtol=0, atol=1e-5)


def _trainers(jcfg, pcfg, jtrain, ptrain, stage_dir):
    """A JAX trainer and the port's with its initial state."""
    jt = JaxTrainer(jcfg, jtrain, stage_dir=stage_dir)
    variables, opt = _init_state(jt)
    pt = ModelTrainer(pcfg, ptrain, device="cpu", stage_dir=stage_dir)
    assert not pt.device_pyramid and not pt.resident
    assert pt.plan.num_points == jt.plan.num_points
    pt.model.load_state_dict(from_jax_variables(variables))
    pt.opt_state = from_jax_opt_state(opt)
    return jt, pt, variables, opt


@pytest.fixture(scope="module")
def wl(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "host_loop")
    base = tmp_path_factory.mktemp("host_loop_logs")
    with jax_dataset_patches(), cpu_torch():
        jcfg = JaxSynthConfig()
        for k, v in EPOCH.items():
            setattr(jcfg, k, v)
        jcfg.saving_path = str(base / "jax")
        pcfg = port_config_class(**EPOCH, saving_path=str(base / "port"))()
        jtrain, jval = jax_datasets_for(jcfg, jroot)
        ptrain, pval = port_datasets_for(pcfg, proot)
        jt, pt, variables, opt = _trainers(jcfg, pcfg, jtrain, ptrain,
                                           "WeakLabel")
        # the step on datasets of their own, so the epoch's are untouched
        jstep, pstep = (jax_datasets_for(jcfg, jroot, ("training",))[0],
                        port_datasets_for(pcfg, proot, ("training",))[0])
        step = _one_step(jt, jstep, pcfg, pstep, variables, opt, weak=True)
        jseen, pseen = _capture_losses(jt, 2), _capture_losses(pt, 2)
        jt.train(jtrain, jval)
        pt.train(ptrain, pval)
        yield dict(jax=(jt, jseen), port=(pt, pseen), step=step,
                   roots=(jroot, proot))


def test_weak_label_host_step_and_eval_match_jax(wl):
    _assert_step(wl["step"])


def test_weak_label_host_epoch_matches_jax_trainer(wl):
    jt, jseen = wl["jax"]
    pt, pseen = wl["port"]
    assert isinstance(pt._train_source[0], HostPyramidSource)
    assert pt._train_source[0].builder.__class__.__name__ == \
        "ParallelSphereBuilder"
    # training's end stops the builder's workers
    assert pt._train_source[0].builder.pool is None
    assert pt._val_acc is None
    assert len(pseen) == len(jseen) >= 2
    for (pe, ps, pl), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pt.epoch_drops == [0.0]
    assert len(pt.validation_probs) == len(jt.validation_probs) == 1
    for got, want in zip(pt.validation_probs, jt.validation_probs):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_host_path_runs_one_step_a_dispatch(wl, capsys):
    pt = wl["port"][0]
    pt.config.steps_per_dispatch = 4
    try:
        assert pt._resolve_steps_per_dispatch() == 1
    finally:
        pt.config.steps_per_dispatch = "auto"
    assert "running unpacked" in capsys.readouterr().out


def _anchor_ledger(tree_path):
    with open(os.path.join(tree_path, "Vaihingen3D_Training_"
                           "subsampled_anchors.pkl"), "rb") as f:
        return [int(v) for v in pickle.load(f)]


def test_host_votes_match_jax_tester(wl, tmp_path):
    jroot, proot = wl["roots"]
    with jax_dataset_patches(), cpu_torch():
        jcfg = JaxSynthConfig()
        for k, v in VOTE.items():
            setattr(jcfg, k, v)
        (jtrain,) = jax_datasets_for(jcfg, jroot, splits=("training",))
        jt = JaxTrainer(jcfg, jtrain)
        jchkp = str(tmp_path / "jax")
        jt.save_checkpoint(jchkp)
        variables, _ = _init_state(jt)
        jtest = jax_datasets.Vaihingen3DWLDataset(
            jcfg, split="test", test_on_train=True, data_root=jroot,
            rng=np.random.default_rng(POTENTIAL_SEED))
        jtester = JaxTester(jcfg, jtest,
                            os.path.join(jchkp, "current_chkp.tar"))
        jtester.cloud_segmentation_test(jtest, 1, active_learning=True,
                                        test_on_train=True)

        pcfg = port_config_class(**VOTE)()
        (ptrain,) = port_datasets_for(pcfg, proot, splits=("training",))
        ptrain.calibration()
        pchkp = str(tmp_path / "port.tar")
        torch.save({"epoch": 0,
                    "model_state_dict": from_jax_variables(variables)},
                   pchkp)
        ptest = Vaihingen3DWLDataset(
            pcfg, split="test", test_on_train=True, data_root=proot,
            rng=np.random.default_rng(POTENTIAL_SEED))
        ptester = ModelTester(pcfg, ptest, pchkp, device="cpu")
        assert not ptester.device_pyramid
        assert isinstance(ptester.vote_parts(ptest)[0], HostPyramidSource)
        ptester.cloud_segmentation_test(ptest, 1, active_learning=True,
                                        test_on_train=True)
    j, p = jtester.test_probs[0], ptester.test_probs[0]
    assert p.shape == j.shape
    assert (np.abs(j).sum(axis=1) > 0).mean() > 0.9
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)
    assert _anchor_ledger(ptest.tree_path) == _anchor_ledger(jtest.tree_path)


@pytest.fixture(scope="module")
def pl(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "host_pl")
    base = tmp_path_factory.mktemp("host_pl_logs")
    jcfg, pcfg = configs(max_epoch=1, device_pyramid=False,
                         input_threads=2)
    jcfg.device_pyramid = False
    jcfg.saving_path = str(base / "jax")
    pcfg.saving_path = str(base / "port")
    (val,) = _datasets(Vaihingen3DPLDataset, pcfg, proot,
                       splits=("validation",))
    truth = val.input_labels[0]
    pseudo = np.where(np.random.default_rng(17).random(truth.shape[0]) < 0.3,
                      10, truth)
    for root in (jroot, proot):
        write_pseudo_labels(root, pseudo)
    jtrain, jval = _jax_ds(jcfg, jroot)
    with jax_dataset_patches(), cpu_torch():
        ptrain, pval = _datasets(Vaihingen3DPLDataset, pcfg, proot)
        jt, pt, variables, opt = _trainers(jcfg, pcfg, jtrain, ptrain,
                                           "PseudoLabel")
        assert pt.mode == jt.mode == "pseudo"
        jstep = _jax_ds(jcfg, jroot, splits=("training",))[0]
        pstep = _datasets(Vaihingen3DPLDataset, pcfg, proot,
                          splits=("training",))[0]
        step = _one_step(jt, jstep, pcfg, pstep, variables, opt,
                         weak=False)
        jseen, pseen = _capture_losses(jt, 2), _capture_losses(pt, 2)
        jt.train(jtrain, jval)
        pt.train(ptrain, pval)
    yield dict(jax=(jt, jseen), port=(pt, pseen), step=step)


def test_pseudo_label_host_step_and_eval_match_jax(pl):
    _assert_step(pl["step"])


def test_pseudo_label_host_epoch_matches_jax_trainer(pl):
    jt, jseen = pl["jax"]
    pt, pseen = pl["port"]
    assert len(pseen) == len(jseen) == 3
    for (pe, ps, pl_), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl_, jl, rtol=1e-5)
    for got, want in zip(pt.validation_probs, jt.validation_probs):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_entry_points_with_host_pyramid(tmp_path, monkeypatch):
    from weasal_tpu_torch import test_models
    from weasal_tpu_torch.config import VaihingenPLConfig, VaihingenWLConfig
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train_Vaihingen3D_PseudoLabel import run as run_pl
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run as run_wl
    root = make_vaihingen_like_root(str(tmp_path / "Vaihingen3D"),
                                    extent=30.0, density=5.0, seed=3)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(test_models, "VOTE_EPOCH_BATCHES", 20)
    for cls in (VaihingenWLConfig, VaihingenPLConfig):
        monkeypatch.setattr(cls, "input_threads", 2)
    wl_log = os.path.join("results", "WeakLabel", "Log_2026-01-01_00-00")
    pl_log = os.path.join("results", "PseudoLabel", "Log_2026-01-01_00-01")
    common = ["--data_root", root, "--preset", "quick", "--device", "cpu",
              "--al_iterations", "0", "--host_pyramid", "--seed", "0"]
    with cpu_torch():
        wl_run = run_wl([wl_log, *common])
        assert not wl_run.device_pyramid
        assert isinstance(wl_run._train_source[0], HostPyramidSource)
        rows = _log_rows(wl_log)
        assert len(rows) >= 1 and all(np.isfinite(float(r[2]))
                                      for r in rows)
        voted = test_models.main(["--log", "last_Vaihingen3DWL", "--on",
                                  "validation", "--data_root", root,
                                  "--device", "cpu", "--num_votes", "0",
                                  "--host_pyramid"])
        assert not voted.device_pyramid
        assert np.isfinite(voted.test_probs[0]).all()
        assert np.abs(voted.test_probs[0]).sum() > 0

        # the quick preset's geometry
        quick = configs(in_radius=7.0, first_subsampling_dl=0.45)[1]
        (val,) = _datasets(Vaihingen3DPLDataset, quick, root,
                           splits=("validation",))
        truth = val.input_labels[0]
        labels = np.where(np.random.default_rng(1).random(truth.shape[0])
                          < 0.3, 10, truth)
        write_pseudo_labels(root, labels)
        pl_run = run_pl([pl_log, "--weak_label_log", "WL", *common])
    assert pl_run.mode == "pseudo" and not pl_run.device_pyramid
    rows = _log_rows(pl_log)
    assert len(rows) >= 1 and all(np.isfinite(float(r[2])) for r in rows)
