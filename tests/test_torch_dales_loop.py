"""The port's DALES stages against the JAX package's, and the DALES
workflow through the port's entry points, on the CPU.

The root (each package a root of its own from one seed): 3 training and
validation tiles of 40 m and 2 test tiles, without intensity.
- One weak-label epoch (3 steps, 2 validation batches) of `ModelTrainer`
  against the JAX `ModelTrainer` (device pyramid, level-0 input) from the
  same initial weights and optimizer state carried across: every step's
  loss rtol 1e-4 and the smoothed validation probabilities 1e-3, as
  tests/test_torch_loop.py holds Vaihingen3D's.
- One pseudo-label epoch on refined labels both roots share (each
  training tile's subsampled ground truth with a seeded 30 % set to 10):
  every loss rtol 1e-5 with dropout 0 and the contrast loss off, as
  tests/test_torch_pl_loop.py holds Vaihingen3D's.
- The workflow: `train_DALES_WeakLabel --preset quick --device cpu`,
  `test_models --on train` (one prediction ply per training tile), the
  refinement at its DALES default threshold 10 (one pseudo-label file per
  training tile and `DALES_t10_weight.txt`), `train_DALES_PseudoLabel
  --preset quick --device cpu` on labels written from the ground truth
  (20 quick steps leave the refinement no confident label) with the
  refinement's class weights, and `test_models --on test` on its log (one
  ply per test tile, in each of predictions/, probs/ and potentials/).
  The votes run epochs of 20 batches to a minimum potential past 0.5
  (`--num_votes 0`), to keep the CPU's all-pairs searches short.
torch runs on one intra-op thread.
"""

import os

import jax
import numpy as np
import pytest

from weasal_tpu.config import Config as JaxConfig
from weasal_tpu.data import datasets as jax_datasets
from weasal_tpu.data.synthetic import make_dales_like_root as jax_make
from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu_torch import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.config import Config as PortConfig
from weasal_tpu_torch.data import datasets as port_datasets
from weasal_tpu_torch.data.synthetic import make_dales_like_root
from weasal_tpu_torch.train.trainer import ModelTrainer
from weasal_tpu_torch.utils.ply import read_ply
from tests._torch_data_setup import POTENTIAL_SEED, jax_dataset_patches
from tests._warm_torch import cpu_torch
from tests.test_torch_dales import ATTRS as WL_ATTRS
from tests.test_torch_loop import _capture_losses
from tests.test_torch_model import _as_dicts

TILES = dict(extent=40.0, density=3.0, seed=9, train_tiles=3, test_tiles=2)
TRAINING = ["tile_00", "tile_01"]
TEST = ["test_tile_00", "test_tile_01"]
LOG = "WL"
EPOCH = dict(max_epoch=1, epoch_steps=3, validation_size=2, saving=True,
             resident_clouds=False)
PL_ATTRS = dict(
    WL_ATTRS, dataset="DALESPL", first_features_dim=8,
    architecture=["simple", "resnetb", "resnetb_strided", "resnetb",
                  "resnetb_strided", "resnetb", "nearest_upsample",
                  "unary", "nearest_upsample", "unary"],
    learning_rate=0.01, momentum=0.98, grad_clip_norm=100.0,
    model_name="KPFCNN", dropout=0.0, contrast_start=100, contrast_thd=10,
    weak_label_log=LOG, class_w=[1.0] * 9)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("dales_loop")
    jroot, proot = str(base / "jax" / "DALES"), str(base / "port" / "DALES")
    jax_make(jroot, **TILES)
    make_dales_like_root(proot, **TILES)
    return jroot, proot


def _epoch(roots, tmp, attrs, jax_cls, port_cls, stage_dir):
    """One epoch of each package's trainer from the JAX initial state;
    returns (JAX trainer, its losses, port trainer, its losses)."""
    attrs = {**attrs, **EPOCH}
    jcfg = type("JaxDALES", (JaxConfig,), dict(attrs,
                                               device_pyramid=True))()
    pcfg = type("PortDALES", (PortConfig,), attrs)()
    jcfg.saving_path = str(tmp / "jax")
    pcfg.saving_path = str(tmp / "port")
    with jax_dataset_patches(), cpu_torch():
        jtrain, jval = [jax_cls(jcfg, split=s, data_root=roots[0],
                                rng=np.random.default_rng(POTENTIAL_SEED))
                        for s in ("training", "validation")]
        jt = JaxTrainer(jcfg, jtrain, stage_dir=stage_dir)
        init_vars = _as_dicts(jax.device_get(
            {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
             "constants": jt.state.constants}))
        init_opt = jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(jt.state.opt_state))
        jseen = _capture_losses(jt, 2)
        jt.train(jtrain, jval)

        ptrain, pval = [port_cls(pcfg, split=s, data_root=roots[1],
                                 rng=np.random.default_rng(POTENTIAL_SEED))
                        for s in ("training", "validation")]
        pt = ModelTrainer(pcfg, ptrain, device="cpu", stage_dir=stage_dir)
        assert pt.plan.num_points == jt.plan.num_points
        pt.model.load_state_dict(from_jax_variables(init_vars))
        pt.opt_state = from_jax_opt_state(init_opt)
        pseen = _capture_losses(pt, 2)
        pt.train(ptrain, pval)
    assert ptrain.cloud_names_split == TRAINING
    return jt, jseen, pt, pseen


def test_weak_label_epoch_matches_jax_trainer(roots, tmp_path):
    jt, jseen, pt, pseen = _epoch(roots, tmp_path, WL_ATTRS,
                                  jax_datasets.DALESWLDataset,
                                  port_datasets.DALESWLDataset, "WeakLabel")
    assert pt.mode == "weak"
    assert len(pseen) == len(jseen) >= 2
    for (pe, ps, pl), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert len(pt.validation_probs) == len(jt.validation_probs) == 1
    for got, want in zip(pt.validation_probs, jt.validation_probs):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _write_labels(root, log, dl):
    """Refined labels (t10) of the training tiles under
    `root`/PseudoLabels/`log`: each tile's subsampled ground truth (the
    port's cache at `dl`), a seeded 30 % set to 10."""
    folder = os.path.join(root, "PseudoLabels", log)
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(17)
    for name in TRAINING:
        truth = read_ply(os.path.join(root, f"input_{dl:.3f}_torch",
                                      name + ".ply"))["class"]
        np.savetxt(os.path.join(folder, f"{name}_t10_pseudo.txt"),
                   np.where(rng.random(truth.shape[0]) < 0.3, 10, truth),
                   fmt="%i")


def test_pseudo_label_epoch_matches_jax_trainer(roots, tmp_path):
    # the port's cache of the training tiles (the same points as JAX's)
    with cpu_torch():
        port_datasets.DALESWLDataset(
            type("PortDALES", (PortConfig,), dict(WL_ATTRS))(),
            split="training", data_root=roots[1])
    _write_labels(roots[1], LOG, WL_ATTRS["first_subsampling_dl"])
    folder = os.path.join("PseudoLabels", LOG)
    os.makedirs(os.path.join(roots[0], folder), exist_ok=True)
    for name in TRAINING:
        f = os.path.join(folder, f"{name}_t10_pseudo.txt")
        with open(os.path.join(roots[1], f)) as src, \
                open(os.path.join(roots[0], f), "w") as dst:
            dst.write(src.read())
    jt, jseen, pt, pseen = _epoch(roots, tmp_path, PL_ATTRS,
                                  jax_datasets.DALESPLDataset,
                                  port_datasets.DALESPLDataset,
                                  "PseudoLabel")
    assert pt.mode == jt.mode == "pseudo"
    assert len(pseen) == len(jseen) == 3
    for (pe, ps, pl), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)


def _prediction_plys(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".ply"))


def test_workflow_through_the_entry_points(tmp_path, monkeypatch):
    from weasal_tpu_torch import pseudoLabel_refinement, test_models
    from weasal_tpu_torch.train_DALES_PseudoLabel import run as run_pl
    from weasal_tpu_torch.train_DALES_WeakLabel import run as run_wl
    root = make_dales_like_root(str(tmp_path / "DALES"), **TILES)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(test_models, "VOTE_EPOCH_BATCHES", 20)
    wl_log = os.path.join("results", "WeakLabel", "Log_2026-01-01_00-00")
    pl_log = os.path.join("results", "PseudoLabel", "Log_2026-01-01_00-01")
    vote = ["--data_root", root, "--device", "cpu", "--num_votes", "0"]
    with cpu_torch():
        wl = run_wl([wl_log, "--data_root", root, "--preset", "quick",
                     "--device", "cpu", "--al_iterations", "0",
                     "--seed", "0"])
        assert wl.config.dataset == "DALESWL" and wl.mode == "weak"
        assert wl.datasets[0].cloud_names_split == TRAINING
        assert len(wl.datasets[0].anchors) == len(TRAINING)
        voted = test_models.main(["--log", "last_DALESWL", "--on", "train",
                                  *vote])
        assert voted.dataset.cloud_names_split == TRAINING
        assert voted.dataset.has_labels
        out = os.path.join("test", "WeakLabel", os.path.basename(wl_log))
        assert _prediction_plys(os.path.join(out, "predictions")) == [
            n + ".ply" for n in TRAINING]
        refined = pseudoLabel_refinement.main(
            ["--weak_label_log", os.path.basename(wl_log),
             "--data_root", root])
        assert sorted(os.listdir(refined)) == sorted(
            [f"{n}_t10_pseudo.txt" for n in TRAINING]
            + ["DALES_t10_weight.txt"])
        for i, name in enumerate(TRAINING):
            labels = np.loadtxt(os.path.join(refined,
                                             f"{name}_t10_pseudo.txt"))
            assert labels.shape == wl.datasets[0].input_labels[i].shape
        weights = np.loadtxt(os.path.join(refined, "DALES_t10_weight.txt"))
        assert weights.shape == (9,) and np.isfinite(weights).all()

        # the PL stage trains on labels written from the ground truth, with
        # the refinement's class weights
        _write_labels(root, os.path.basename(wl_log),
                      wl.config.first_subsampling_dl)
        pl = run_pl([pl_log, "--data_root", root, "--weak_label_log",
                     os.path.basename(wl_log), "--preset", "quick",
                     "--device", "cpu", "--seed", "0"])
    assert pl.config.dataset == "DALESPL" and pl.mode == "pseudo"
    assert pl.config.class_w == pytest.approx(list(weights), abs=1e-3)
    with open(os.path.join(pl_log, "training_iteration0.txt")) as f:
        rows = f.readlines()[1:]
    assert rows and all(np.isfinite(float(r.split()[2])) for r in rows)
    with cpu_torch():
        tested = test_models.main(["--log", "last_DALESPL", "--on", "test",
                                   *vote])
    assert tested.dataset.cloud_names_split == TEST
    assert not tested.dataset.has_labels
    out = os.path.join("test", "PseudoLabel", os.path.basename(pl_log))
    for sub in ("predictions", "probs", "potentials"):
        assert _prediction_plys(os.path.join(out, sub)) == [
            n + ".ply" for n in TEST], sub
    for i, name in enumerate(TEST):
        n = read_ply(os.path.join(out, "probs", name + ".ply"))["x"].shape[0]
        assert n == tested.dataset.validation_labels[i].shape[0]
        assert np.isfinite(tested.test_probs[i]).all()
