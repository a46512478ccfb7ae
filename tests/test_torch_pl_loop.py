"""The port's pseudo-label stage against the JAX package's, on one
synthetic scene (tests/_torch_data_setup.py: 30 m, each package with a
root of its own, sorted KD rows and the numpy grid subsample on the JAX
side).

Both roots get the same refined pseudo labels
(`PseudoLabels/WL/Vaihingen3D_Training_t20_pseudo.txt`: the subsampled
ground truth with a seeded 30 % set to 10) and class weights. Checked:
- `Vaihingen3DPLDataset`'s training labels equal JAX's at iteration 0
  (and the empty ledger written) and after a ledger overlay;
- two epochs of `ModelTrainer` in pseudo mode against the JAX
  `ModelTrainer` on the level-0 input (3 steps an epoch, 2 validation
  batches), from the same initial weights and optimizer state carried
  across, with dropout 0 and `contrast_start` past `max_epoch`, so that
  neither package draws: every step's loss rtol 1e-5, the printed logs
  one unit of their last digit apart, the log header's ground-truth
  count, the validation mIoU within 1 point; and `parameters.txt` of the
  JAX trainer loads into the port's Config with the same values;
- the 'pseudo' testers of both packages, from the JAX trainer's final
  state, voting on the training clouds: votes atol 1e-5, and the
  ground-truth ledgers that `_extend_gt_ledger` extends equal in the
  entropy arm (each package's own votes) and the random arm (the same
  votes);
- the entry point `--preset quick --device cpu --al_iterations 1`: two
  iterations, the ledger grown by `--added_labels`, iteration 1 training
  on it; and `test_models.model_choice` resolves `last_Vaihingen3DPL`.
"""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from weasal_tpu.config import Config as JaxConfig
from weasal_tpu.data import datasets as jax_datasets
from weasal_tpu.train.tester import ModelTester as JaxTester
from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu_torch import from_jax_opt_state, from_jax_variables
from weasal_tpu_torch.config import Config as PortConfig
from weasal_tpu_torch.data.datasets import Vaihingen3DPLDataset
from weasal_tpu_torch.train.tester import ModelTester
from weasal_tpu_torch.train.trainer import ModelTrainer
from tests._torch_data_setup import (POTENTIAL_SEED, jax_dataset_patches,
                                     make_roots)
from tests._warm_torch import cpu_torch
from tests.test_torch_loop import _capture_losses, _log_rows, _mious
from tests.test_torch_model import _as_dicts

LOG = "WL"
CLOUD = "Vaihingen3D_Training"
CLASS_W = [0.6, 1.4, 0.9, 2.0, 1.1, 0.8, 1.7, 1.2, 0.5]
ATTRS = dict(
    dataset="Vaihingen3DPL", num_classes=None, in_features_dim=4,
    first_features_dim=8, num_kernel_points=15, in_radius=8.0,
    first_subsampling_dl=0.4, conv_radius=2.5,
    architecture=["simple", "resnetb", "resnetb_strided", "resnetb",
                  "resnetb_strided", "resnetb", "nearest_upsample",
                  "unary", "nearest_upsample", "unary"],
    batch_num=2, epoch_steps=3, validation_size=2, max_epoch=2,
    lr_decays={1: 0.5}, learning_rate=0.01, momentum=0.98,
    grad_clip_norm=100.0, augment_rotation="vertical",
    augment_scale_min=0.2, augment_scale_max=1.8, augment_noise=0.01,
    augment_symmetries=[True, True, True], augment_color=0.7,
    model_name="KPFCNN", dropout=0.0, contrast_start=100, contrast_thd=20,
    weak_label_log=LOG, class_w=CLASS_W, active_learning_iterations=0,
    added_labels_per_epoch=20, saving=True, resident_clouds=False)


def configs(**overrides):
    attrs = {**ATTRS, **overrides}
    jcfg = type("JaxSynthPL", (JaxConfig,),
                dict(attrs, device_pyramid=True))()
    pcfg = type("PortSynthPL", (PortConfig,), attrs)()
    return jcfg, pcfg


def write_pseudo_labels(root, labels):
    folder = os.path.join(root, "PseudoLabels", LOG)
    os.makedirs(folder, exist_ok=True)
    np.savetxt(os.path.join(folder, f"{CLOUD}_t20_pseudo.txt"), labels,
               fmt="%i")
    np.savetxt(os.path.join(folder, "Vaihingen3D_t20_weight.txt"),
               np.asarray(CLASS_W)[None], fmt="%.3f")


def _datasets(cls, cfg, root, splits=("training", "validation"), **kw):
    return [cls(cfg, split=s, data_root=root,
                rng=np.random.default_rng(POTENTIAL_SEED), **kw)
            for s in splits]


def _jax_ds(cfg, root, **kw):
    with jax_dataset_patches():
        return _datasets(jax_datasets.Vaihingen3DPLDataset, cfg, root, **kw)


def _ledger(ds):
    with open(ds.tree_path + f"/{CLOUD}_al_groundTruth_IDs.pkl", "rb") as f:
        return [int(v) for v in np.asarray(pickle.load(f)).ravel()]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "pl")
    _, pcfg = configs()
    (val,) = _datasets(Vaihingen3DPLDataset, pcfg, proot,
                       splits=("validation",))
    truth = val.input_labels[0]
    rng = np.random.default_rng(17)
    pseudo = np.where(rng.random(truth.shape[0]) < 0.3, 10, truth)
    for root in (jroot, proot):
        write_pseudo_labels(root, pseudo)
    return dict(jroot=jroot, proot=proot, truth=truth, pseudo=pseudo)


@pytest.mark.parametrize("al_iteration", [0, 1])
def test_pl_dataset_labels_match_jax(scene, al_iteration):
    jcfg, pcfg = configs()
    if al_iteration:
        ids = np.random.default_rng(3).choice(scene["truth"].shape[0], 40,
                                              replace=False)
        for folder in (os.path.join(scene["jroot"], "input_0.400"),
                       os.path.join(scene["proot"], "input_0.400_torch")):
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(
                    folder, f"{CLOUD}_al_groundTruth_IDs.pkl"), "wb") as f:
                pickle.dump(ids.astype(np.int64), f)
    (jds,) = _jax_ds(jcfg, scene["jroot"], splits=("training",),
                     al_iteration=al_iteration)
    with cpu_torch():
        (pds,) = _datasets(Vaihingen3DPLDataset, pcfg, scene["proot"],
                           splits=("training",), al_iteration=al_iteration)
    np.testing.assert_array_equal(pds.input_labels[0], jds.input_labels[0])
    assert pds.label_to_idx == jds.label_to_idx
    assert pds.label_to_idx[10] == 10
    np.testing.assert_array_equal(pds.label_values, jds.label_values)
    labels = pds.input_labels[0]
    if al_iteration:
        np.testing.assert_array_equal(labels[ids], scene["truth"][ids])
        assert (labels != scene["pseudo"]).sum() > 0
    else:
        np.testing.assert_array_equal(labels, scene["pseudo"])
        assert _ledger(pds) == _ledger(jds) == []
    # the resident label table keeps raw 10 (unlabeled for the contrast)
    assert pds._label_table()[10] == 10


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    base = tmp_path_factory.mktemp("pl_logs")
    jcfg, pcfg = configs()
    jcfg.saving_path = str(base / "jax")
    pcfg.saving_path = str(base / "port")
    jtrain, jval = _jax_ds(jcfg, scene["jroot"])
    with jax_dataset_patches(), cpu_torch():
        jt = JaxTrainer(jcfg, jtrain, stage_dir="PseudoLabel")
        init_vars = _as_dicts(jax.device_get(
            {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
             "constants": jt.state.constants}))
        init_opt = jax.tree_util.tree_map(np.asarray,
                                          jax.device_get(jt.state.opt_state))
        jseen = _capture_losses(jt, 2)
        jt.train(jtrain, jval)

        ptrain, pval = _datasets(Vaihingen3DPLDataset, pcfg, scene["proot"])
        pt = ModelTrainer(pcfg, ptrain, device="cpu",
                          stage_dir="PseudoLabel")
        assert pt.mode == "pseudo" and jt.mode == "pseudo"
        assert jt.plan.num_points == pt.plan.num_points
        pt.model.load_state_dict(from_jax_variables(init_vars))
        pt.opt_state = from_jax_opt_state(init_opt)
        pseen = _capture_losses(pt, 2)
        pt.train(ptrain, pval)
    yield dict(jax=(jt, jcfg, jseen, jtrain), port=(pt, pcfg, pseen, ptrain),
               base=base)


def test_two_epochs_match_jax_trainer(runs):
    jt, jcfg, jseen, _ = runs["jax"]
    pt, pcfg, pseen, _ = runs["port"]
    assert len(pseen) == len(jseen) == 6
    for (pe, ps, pl), (je, js, jl) in zip(pseen, jseen):
        assert (pe, ps) == (je, js)
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
    prow, jrow = _log_rows(pcfg.saving_path), _log_rows(jcfg.saving_path)
    assert len(prow) == len(jrow) == len(jseen)
    for p, j in zip(prow, jrow):
        assert p[:2] == j[:2]
        assert abs(float(p[2]) - float(j[2])) <= 1.0e-3 + 1e-9
    for cfg in (pcfg, jcfg):
        with open(os.path.join(cfg.saving_path,
                               "training_iteration0.txt")) as f:
            assert f.readline().rstrip().endswith("ground truth labels: 0")
    assert pt.epoch == jt.epoch == 2
    np.testing.assert_allclose(_mious(pcfg.saving_path),
                               _mious(jcfg.saving_path), rtol=0, atol=1.0)
    assert os.path.exists(os.path.join(pcfg.saving_path, "checkpoints",
                                       "current_chkp.tar"))


def test_pl_parameters_txt_loads_into_the_port(runs):
    _, jcfg, _, _ = runs["jax"]
    loaded = PortConfig()
    loaded.load(jcfg.saving_path)
    for key in ("dataset", "num_classes", "architecture", "model_name",
                "dropout", "contrast_start", "contrast_thd",
                "weak_label_log", "grad_clip_norm", "batch_num",
                "first_features_dim", "augment_scale_max", "class_w",
                "added_labels_per_epoch", "active_learning_iterations"):
        want, got = getattr(jcfg, key), getattr(loaded, key)
        if isinstance(want, float):
            assert got == pytest.approx(want, rel=1e-6), key
        elif key == "class_w":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert got == want, key
    assert loaded.lr_decays == jcfg.lr_decays


@pytest.fixture(scope="module")
def votes(runs, scene):
    """Both packages' 'pseudo' testers, from the JAX trainer's final
    state, voting on the training clouds (active learning)."""
    jt, jcfg, _, _ = runs["jax"]
    base = runs["base"]
    vote = dict(validation_size=3, saving=False)
    jcfg, pcfg = configs(**vote)
    jchkp = str(base / "jax_vote")
    jt.save_checkpoint(jchkp)
    final = _as_dicts(jax.device_get(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
         "constants": jt.state.constants}))
    pchkp = str(base / "port_vote.tar")
    torch.save({"epoch": 2, "model_state_dict": from_jax_variables(final)},
               pchkp)
    with jax_dataset_patches(), cpu_torch():
        (jtrain,) = _jax_ds(jcfg, scene["jroot"], splits=("training",))
        jtest = jax_datasets.Vaihingen3DPLDataset(
            jcfg, split="test", test_on_train=True, data_root=scene["jroot"],
            rng=np.random.default_rng(POTENTIAL_SEED))
        jtester = JaxTester(jcfg, jtest,
                            os.path.join(jchkp, "current_chkp.tar"))
        (ptrain,) = _datasets(Vaihingen3DPLDataset, pcfg, scene["proot"],
                              splits=("training",))
        ptest = Vaihingen3DPLDataset(
            pcfg, split="test", test_on_train=True, data_root=scene["proot"],
            rng=np.random.default_rng(POTENTIAL_SEED))
        ptester = ModelTester(pcfg, ptest, pchkp, device="cpu")
        assert ptester.mode == jtester.mode == "pseudo"
        ledger0 = (_ledger(jtrain), _ledger(ptrain))
        jtester.cloud_segmentation_test(jtest, 1, active_learning=True,
                                        test_on_train=True)
        ptester.cloud_segmentation_test(ptest, 1, active_learning=True,
                                        test_on_train=True)
    yield dict(jax=(jtester, jtest, jcfg), port=(ptester, ptest, pcfg),
               ledger0=ledger0)


def test_pseudo_votes_match_jax_tester(votes):
    jtester, ptester = votes["jax"][0], votes["port"][0]
    j, p = jtester.test_probs[0], ptester.test_probs[0]
    assert p.shape == j.shape and p.shape[1] == 9
    assert (np.abs(j).sum(axis=1) > 0).mean() > 0.9
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)


def test_entropy_gt_ledger_matches_jax_tester(votes):
    j0, p0 = votes["ledger0"]
    assert j0 == p0 == []
    j, p = _ledger(votes["jax"][1]), _ledger(votes["port"][1])
    assert len(p) == votes["port"][2].added_labels_per_epoch
    assert len(set(p)) == len(p)
    assert p == j


def test_random_gt_ledger_matches_jax_tester(votes):
    probs = {f"{CLOUD}.ply": votes["port"][0].test_probs[0]}
    results = []
    for key in ("jax", "port"):
        tester, dataset, cfg = votes[key]
        path = dataset.tree_path + f"/{CLOUD}_al_groundTruth_IDs.pkl"
        shutil.copy(path, path + ".entropy")
        try:
            cfg.al_acquisition = "random"
            tester._extend_gt_ledger(dataset, probs)
            results.append(_ledger(dataset))
        finally:
            cfg.al_acquisition = "entropy"
            shutil.move(path + ".entropy", path)
    n_add = votes["port"][2].added_labels_per_epoch
    assert len(results[1]) == 2 * n_add
    assert len(set(results[1])) == len(results[1])
    assert results[0] == results[1]


def test_entry_point_quick_preset_with_one_acquisition(tmp_path,
                                                      monkeypatch):
    from weasal_tpu_torch import test_models
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train_Vaihingen3D_PseudoLabel import run
    root = make_vaihingen_like_root(str(tmp_path / "Vaihingen3D"),
                                    extent=30.0, density=5.0, seed=3)
    _, pcfg = configs(in_radius=7.0, first_subsampling_dl=0.45)
    with cpu_torch():
        (val,) = _datasets(Vaihingen3DPLDataset, pcfg, root,
                           splits=("validation",))
    truth = val.input_labels[0]
    write_pseudo_labels(root, np.where(
        np.random.default_rng(1).random(truth.shape[0]) < 0.3, 10, truth))
    log = str(tmp_path / "results" / "PseudoLabel" / "Log_2026-01-01_00-00")
    added = 30
    with cpu_torch():
        trainer = run([log, "--data_root", root, "--weak_label_log", LOG,
                       "--preset", "quick", "--device", "cpu",
                       "--al_iterations", "1", "--added_labels", str(added),
                       "--seed", "0"])
    assert trainer.mode == "pseudo" and trainer.al_iteration == 1
    assert trainer.config.class_w == pytest.approx(CLASS_W, abs=1e-3)
    assert len(trainer.testers) == 1
    ledger = _ledger(trainer.datasets[0])
    assert len(ledger) == len(set(ledger)) == added
    labels = trainer.datasets[0].input_labels[0]
    np.testing.assert_array_equal(labels[ledger], truth[ledger])
    for it, gt in ((0, 0), (1, added)):
        path = os.path.join(log, f"training_iteration{it}.txt")
        with open(path) as f:
            rows = f.readlines()
        assert rows[0].rstrip().endswith(f"ground truth labels: {gt}")
        assert len(rows) > 1 and all(np.isfinite(float(r.split()[2]))
                                     for r in rows[1:])
    assert os.path.exists(os.path.join(log, "checkpoints",
                                       "current_chkp.tar"))
    monkeypatch.chdir(tmp_path)
    assert test_models.model_choice("last_Vaihingen3DPL") == os.path.join(
        "results", "PseudoLabel", os.path.basename(log))
