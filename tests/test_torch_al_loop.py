"""The port's active-learning loop through its entry point, on the CPU.

`python -m weasal_tpu_torch.train_Vaihingen3D_WeakLabel --al_iterations 1
--preset quick --device cpu` on a synthetic 30 m scene: iteration 0
trains, the tester votes on the training clouds and extends the anchor
ledger by `added_labels` unused anchors, iteration 1 trains on the larger
budget. Then `--resume` continues the log at its last
`training_iteration*` file, and `test_models.model_choice` resolves the
`last_<DS>` aliases. (The vote itself is held to the JAX tester in
tests/test_torch_tester.py.)
"""

import os
import pickle

import numpy as np
import pytest

from tests._warm_torch import cpu_torch

ADDED = 5          # --preset quick's added_labels_per_epoch


def _ledger(root):
    path = os.path.join(root, "input_0.450_torch",
                        "Vaihingen3D_Training_subsampled_anchors.pkl")
    with open(path, "rb") as f:
        return [int(v) for v in pickle.load(f)]


@pytest.fixture(scope="module")
def al_run(tmp_path_factory):
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    base = tmp_path_factory.mktemp("al_loop")
    root = make_vaihingen_like_root(str(base / "Vaihingen3D"), extent=30.0,
                                    density=5.0, seed=3)
    log = str(base / "results" / "WeakLabel" / "Log_2026-01-01_00-00-00")
    seen = {}
    from weasal_tpu_torch.train import tester as tester_mod
    extend = tester_mod.ModelTester._extend_anchor_ledger

    def recording(self, dataset, all_probs, all_pseudo_lbs):
        seen["before"] = _ledger(root)
        extend(self, dataset, all_probs, all_pseudo_lbs)
        seen["after"] = _ledger(root)

    tester_mod.ModelTester._extend_anchor_ledger = recording
    try:
        with cpu_torch():
            trainer = run([log, "--data_root", root, "--preset", "quick",
                           "--al_iterations", "1", "--device", "cpu",
                           "--seed", "0"])
    finally:
        tester_mod.ModelTester._extend_anchor_ledger = extend
    return dict(trainer=trainer, log=log, root=root, base=base, seen=seen,
                run=run)


def test_al_iterations_write_their_logs(al_run):
    log = al_run["log"]
    names = sorted(f for f in os.listdir(log)
                   if f.startswith("training_iteration"))
    assert names == ["training_iteration0.txt", "training_iteration1.txt"]
    for name in names:
        with open(os.path.join(log, name)) as f:
            rows = [r.split() for r in f.readlines()[1:]]
        assert rows and all(np.isfinite(float(r[2])) for r in rows)
    with open(os.path.join(log, "val_IoUs.txt")) as f:
        assert len(f.readlines()) == 2           # one epoch an iteration
    trainer = al_run["trainer"]
    assert trainer.al_iteration == 1
    assert len(trainer.testers) == 1
    votes = trainer.testers[0].vote_times
    assert len(votes) == 1 and votes[0]["batches"] > 0


def test_acquisition_grows_the_ledger_by_added_labels(al_run):
    before, after = al_run["seen"]["before"], al_run["seen"]["after"]
    assert len(before) == 40                     # --preset quick's budget
    assert len(after) == len(before) + ADDED
    assert after[:len(before)] == before
    assert len(set(after)) == len(after)         # no anchor reused
    # iteration 1 trained on the larger budget: its dataset selected the
    # extended ledger's anchors
    train_ds = al_run["trainer"].datasets[0]
    assert train_ds.al_iteration == 1
    with open(os.path.join(al_run["log"], "training_iteration1.txt")) as f:
        header = f.readline()
    assert f"({40 + ADDED})" in header


def test_resume_continues_at_the_last_iteration(al_run, tmp_path):
    resumed_log = str(tmp_path / "resumed")
    with cpu_torch():
        trainer = al_run["run"]([resumed_log, "--resume", al_run["log"],
                                 "--data_root", al_run["root"],
                                 "--preset", "quick", "--al_iterations",
                                 "1", "--device", "cpu"])
    assert trainer.al_iteration == 1
    assert trainer.epoch == 1                   # restored, nothing left
    assert os.listdir(resumed_log).count("training_iteration1.txt") == 1
    assert "training_iteration0.txt" not in os.listdir(resumed_log)
    assert not trainer.testers                  # the last iteration: no vote
    assert len(_ledger(al_run["root"])) == 40 + ADDED


def test_model_choice_resolves_last_aliases(al_run, monkeypatch):
    from weasal_tpu_torch.config import Config
    from weasal_tpu_torch.test_models import model_choice
    base = al_run["base"]
    monkeypatch.chdir(base)
    newer = base / "results" / "WeakLabel" / "Log_2026-02-01_00-00-00"
    cfg = Config()
    cfg.load(al_run["log"])
    cfg.dataset = "DALESWL"
    cfg.saving_path = str(newer)
    cfg.save()
    assert model_choice("last_Vaihingen3DWL") == os.path.join(
        "results", "WeakLabel", os.path.basename(al_run["log"]))
    assert model_choice("last_DALESWL") == os.path.join(
        "results", "WeakLabel", newer.name)
    assert model_choice(al_run["log"]) == al_run["log"]
    with pytest.raises(ValueError, match="does not exist"):
        model_choice(str(base / "nowhere"))
    (base / "results" / "PseudoLabel").mkdir(exist_ok=True)
    with pytest.raises(ValueError, match="No log"):
        model_choice("last_Vaihingen3DPL")
