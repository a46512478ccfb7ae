"""The port's voting tester against the JAX package's `ModelTester`.

Both testers restore the same weights (the JAX trainer's initial state,
carried across by `from_jax_variables`) and vote on the training clouds
(the test split with `test_on_train`, the active-learning pass) of the
same synthetic scene, each package with a root of its own, on level-0
batches with the votes smoothed on the host. Checked:
- the voted probabilities (`test_probs`) to atol 1e-5: the forward passes
  agree to f32 rounding (tests/test_torch_model.py) and the smoothing is
  the same numpy code in f64;
- the anchor ledgers that the acquisition extends, equal for the entropy
  arm and for the random arm (the latter on the same votes);
- then the port alone: a vote interrupted after its first vote
  checkpoint and resumed from `vote_chkp_train.pkl` equals an
  uninterrupted one; the 'pseudo' mode on a weak-label configuration and
  the 'ERF' split raise;
- the vote update's `d2` mask (the squared norms of the augmented
  points) against the JAX `DeviceVoteAccumulator`'s `use_d2` branch on
  one batch, bit for bit.
"""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from weasal_tpu.data import datasets as jax_datasets
from weasal_tpu.train.tester import ModelTester as JaxTester
from weasal_tpu.train.trainer import ModelTrainer as JaxTrainer
from weasal_tpu_torch import from_jax_variables
from weasal_tpu_torch.data.datasets import Vaihingen3DWLDataset
from weasal_tpu_torch.train import tester as port_tester
from weasal_tpu_torch.train.tester import ModelTester
from tests._torch_data_setup import (
    POTENTIAL_SEED, JaxSynthConfig, jax_dataset_patches, jax_datasets_for,
    make_roots, port_config_class, port_datasets_for)
from tests._warm_torch import cpu_torch
from tests.test_torch_model import _as_dicts

VOTE = dict(in_radius=6.0, validation_size=3, saving=False,
            resident_clouds=False, added_labels_per_epoch=4)
NUM_VOTES = 1


def _ledger(tree_path):
    with open(os.path.join(tree_path, "Vaihingen3D_Training_"
                           "subsampled_anchors.pkl"), "rb") as f:
        return [int(v) for v in pickle.load(f)]


def _all_probs(tester, dataset):
    probs = {"Vaihingen3D_Training.ply": tester.test_probs[0]}
    return probs, {k: np.argmax(v, axis=1) for k, v in probs.items()}


@pytest.fixture(scope="module")
def votes(tmp_path_factory):
    jroot, proot = make_roots(tmp_path_factory, "tester")
    base = tmp_path_factory.mktemp("tester_logs")
    with jax_dataset_patches(), cpu_torch():
        jcfg = JaxSynthConfig()
        jcfg.device_pyramid = True
        for k, v in VOTE.items():
            setattr(jcfg, k, v)
        (jtrain,) = jax_datasets_for(jcfg, jroot, splits=("training",))
        jt = JaxTrainer(jcfg, jtrain)
        jchkp = str(base / "jax")
        jt.save_checkpoint(jchkp)
        init_vars = _as_dicts(jax.device_get(
            {"params": jt.state.params, "batch_stats": jt.state.batch_stats,
             "constants": jt.state.constants}))
        jtest = jax_datasets.Vaihingen3DWLDataset(
            jcfg, split="test", test_on_train=True, data_root=jroot,
            rng=np.random.default_rng(POTENTIAL_SEED))
        jledger0 = _ledger(jtest.tree_path)
        jtester = JaxTester(jcfg, jtest,
                            os.path.join(jchkp, "current_chkp.tar"))
        jtester.cloud_segmentation_test(jtest, NUM_VOTES,
                                        active_learning=True,
                                        test_on_train=True)

        pcfg = port_config_class(**VOTE)()
        (ptrain,) = port_datasets_for(pcfg, proot, splits=("training",))
        ptrain.calibration()        # the plan the JAX trainer calibrated
        pchkp = str(base / "port.tar")
        torch.save({"epoch": 0, "model_state_dict": from_jax_variables(
            init_vars)}, pchkp)
        ptest = Vaihingen3DWLDataset(
            pcfg, split="test", test_on_train=True, data_root=proot,
            rng=np.random.default_rng(POTENTIAL_SEED))
        pledger0 = _ledger(ptest.tree_path)
        ptester = ModelTester(pcfg, ptest, pchkp, device="cpu")
        ptester.cloud_segmentation_test(ptest, NUM_VOTES,
                                        active_learning=True,
                                        test_on_train=True)
        yield dict(jax=(jtester, jtest, jcfg, jledger0),
                   port=(ptester, ptest, pcfg, pledger0), pchkp=pchkp,
                   proot=proot, base=base)


def test_test_split_plan_and_clouds_match(votes):
    jtester, jtest = votes["jax"][:2]
    ptester, ptest = votes["port"][:2]
    assert jtester.plan.num_points == ptester.plan.num_points
    assert jtest.files[0].endswith("Test/Vaihingen3D_Training.ply")
    assert [os.path.basename(f) for f in ptest.files] == \
        [os.path.basename(f) for f in jtest.files]


def test_test_probs_match_jax_tester(votes):
    jtester, ptester = votes["jax"][0], votes["port"][0]
    assert len(jtester.test_probs) == len(ptester.test_probs) == 1
    j, p = jtester.test_probs[0], ptester.test_probs[0]
    assert p.shape == j.shape
    voted = np.abs(j).sum(axis=1) > 0
    assert voted.mean() > 0.9
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)


def test_entropy_ledger_matches_jax_tester(votes):
    jledger0, pledger0 = votes["jax"][3], votes["port"][3]
    assert jledger0 == pledger0
    j = _ledger(votes["jax"][1].tree_path)
    p = _ledger(votes["port"][1].tree_path)
    n_add = votes["port"][2].added_labels_per_epoch
    assert len(p) == len(pledger0) + n_add
    assert len(set(p)) == len(p)
    assert p == j


def test_random_ledger_matches_jax_tester(votes):
    results = []
    for key in ("jax", "port"):
        tester, dataset, cfg, ledger0 = votes[key]
        sub = os.path.join(dataset.tree_path,
                           "Vaihingen3D_Training_subsampled_anchors.pkl")
        shutil.copy(sub, sub + ".entropy")
        try:
            with open(sub, "wb") as f:
                pickle.dump(ledger0, f)
            cfg.al_acquisition = "random"
            with jax_dataset_patches():
                tester._extend_anchor_ledger(dataset,
                                             *_all_probs(tester, dataset))
            results.append(_ledger(dataset.tree_path))
        finally:
            cfg.al_acquisition = "entropy"
            shutil.move(sub + ".entropy", sub)
    assert len(results[1]) == len(votes["port"][3]) + \
        votes["port"][2].added_labels_per_epoch
    assert len(set(results[1])) == len(results[1])
    assert results[0] == results[1]


def test_vote_resumes_from_its_checkpoint(votes, tmp_path, monkeypatch):
    """Interrupted after its first vote checkpoint and resumed, a saving
    vote ends with the votes of the module's uninterrupted pass (the same
    draws: the vote's rng and the potentials' seed)."""
    cfg = port_config_class(**{**VOTE, "saving": True})()
    cfg.saving_path = str(tmp_path / "log")
    monkeypatch.chdir(tmp_path)
    chkp = os.path.join(cfg.saving_path, "vote_chkp_train.pkl")

    def vote(resume=False):
        ds = Vaihingen3DWLDataset(cfg, split="test", test_on_train=True,
                                  data_root=votes["proot"],
                                  rng=np.random.default_rng(POTENTIAL_SEED))
        tester = ModelTester(cfg, ds, votes["pchkp"], device="cpu")
        return tester.cloud_segmentation_test(ds, NUM_VOTES,
                                              test_on_train=True,
                                              resume=resume)

    made = port_tester.BatchPrefetcher
    epochs = []

    def stop_after_first_checkpoint(*args, **kwargs):
        if os.path.exists(chkp):
            raise KeyboardInterrupt("stopped after a vote checkpoint")
        epochs.append(1)
        return made(*args, **kwargs)

    with cpu_torch():
        monkeypatch.setattr(port_tester, "BatchPrefetcher",
                            stop_after_first_checkpoint)
        with pytest.raises(KeyboardInterrupt):
            vote()
        assert os.path.exists(chkp) and epochs
        monkeypatch.setattr(port_tester, "BatchPrefetcher", made)
        resumed = vote(resume=True)
    assert not os.path.exists(chkp)            # removed once complete
    whole = votes["port"][0].test_probs
    assert len(whole) == len(resumed) == 1
    np.testing.assert_array_equal(resumed[0], whole[0])
    out = tmp_path / "test" / "WeakLabel" / "log"
    for sub in ("predictions", "probs", "potentials"):
        assert (out / sub / "Vaihingen3D_Training.ply").exists()


def test_pseudo_mode_and_erf_split_raise(votes):
    ptester, ptest, pcfg = votes["port"][:3]
    # a weak-label configuration builds a KPFCNN_mprm, which the 'pseudo'
    # mode (KPFCNN, tests/test_torch_pl_loop.py) does not vote with
    with pytest.raises(ValueError, match="pseudo"):
        ModelTester(pcfg, ptest, votes["pchkp"], mode="pseudo",
                    device="cpu")

    class ERF:
        split = "ERF"

    with pytest.raises(ValueError, match="ERF"):
        ptester.cloud_segmentation_test(ERF(), NUM_VOTES)
    with pytest.raises(NotImplementedError, match="ERF"):
        Vaihingen3DWLDataset(pcfg, split="ERF", data_root=votes["proot"])


def test_d2_mask_matches_jax_use_d2_branch():
    from types import SimpleNamespace
    from weasal_tpu.train.vote import DeviceVoteAccumulator as JaxAcc
    from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
    rng = np.random.default_rng(5)
    sizes = np.array([50, 40])
    S = int(sizes.sum()) + 1
    res_points = rng.normal(size=(S, 3)).astype(np.float32)
    B, n0, C = 3, 30, 4
    flat_inds = rng.integers(0, S, size=(B, n0)).astype(np.int32)
    flat_inds[:, -4:] = S - 1                    # pad rows: the shadow
    probs = rng.random((B, n0, C)).astype(np.float32)
    # squared norms around the radius, some of them exactly on it
    d2 = rng.uniform(0.0, 2.0, size=(B, n0)).astype(np.float32)
    d2[0, :3] = np.float32(0.7 ** 2)
    centers = rng.normal(size=(B, 3)).astype(np.float32)
    r_sq = 0.7 ** 2
    resident = SimpleNamespace(arrays={"res_points": res_points},
                               base=np.array([0, 50]), sizes=sizes)
    jacc = JaxAcc(resident, C, radius_sq=r_sq)
    batch = {"flat_inds": flat_inds, "center_pts": centers,
             "res_points": res_points}
    jacc.update(probs, batch, d2=d2)
    president = SimpleNamespace(
        arrays={"res_points": torch.from_numpy(res_points)},
        base=resident.base, sizes=sizes)
    pacc = DeviceVoteAccumulator(president, C, radius_sq=r_sq)
    pacc.update(torch.from_numpy(probs),
                {k: torch.from_numpy(v) for k, v in batch.items()},
                d2=torch.from_numpy(d2))
    for a, b in zip(jacc.materialize(), pacc.materialize()):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the center-distance branch differs: the d2 mask decided here
    cacc = DeviceVoteAccumulator(president, C, radius_sq=r_sq)
    cacc.update(torch.from_numpy(probs),
                {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not all(np.array_equal(a, b) for a, b in
                   zip(cacc.materialize(), pacc.materialize()))
