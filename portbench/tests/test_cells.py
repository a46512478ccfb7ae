"""Tiny runs of each cell through the harness on the CPU: the result
line's schema, the program's plain path equal to the reference, the
control (the reference in TF32) failing a limit, and the timed path
broken underneath failing `correct`, once for each fault a cell can
have (one chip: no exchange between chips to leave out)."""

import math

import pytest
import torch

from portbench.tests._tiny import bench, control_readings, run_cell  # noqa

TRAIN = ["v3d_wl.train", "v3d_pl.train"]
CELLS = TRAIN + ["v3d_pl.vote"]


def _schema(line, trace):
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("workload", CELLS)
def test_plain_path_equals_the_reference(bench, capsys, monkeypatch,
                                         workload):
    line, err = run_cell(bench, workload, 2 ** 31 + 11, capsys,
                         monkeypatch, control=True)
    _schema(line, trace=False)
    assert line["correct"]
    # the same plain code on the same inputs: equal, but for the step
    # gap's sum of per-step changes against the program's total change
    for name, c in line["checks"].items():
        assert c["value"] <= (1e-7 if name == "step_gap" else 0.0), name
    assert "setup_s" in line["metrics"]
    # the control, judged as a run is, fails at least one of the limits
    control = control_readings(err)
    assert control["correct"] is False, control
    assert any(c["value"] > c["limit"] for c in control["checks"].values())
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(l.startswith("check ") for l in last)


def test_traced_line_schema(bench, capsys, monkeypatch):
    line, _ = run_cell(bench, "v3d_pl.vote", 5, capsys, monkeypatch,
                       trace=1)
    _schema(line, trace=True)


def _no_update(*args, **kwargs):
    return None


def _half_batch_mprm(orig):
    def loss(cam, region_inds, region_masks, *args, **kwargs):
        masks = region_masks.clone()
        masks[masks.shape[0] // 2:] = False
        return orig(cam, region_inds, masks, *args, **kwargs)
    return loss


def _half_batch_ce(orig):
    def loss(logits, targets, class_w=None):
        targets = targets.clone()
        targets[targets.shape[0] // 2:] = -1
        return orig(logits, targets, class_w)
    return loss


def _loss_altered(orig):
    def loss(*args, **kwargs):
        return orig(*args, **kwargs) * 1.01
    return loss


def _apply_train_fault(monkeypatch, workload, fault):
    from weasal_tpu_torch.models import losses
    from weasal_tpu_torch.train import step
    name = ("region_mprm_loss" if workload.startswith("v3d_wl")
            else "softmax_cross_entropy")
    if fault == "state_unchanged":
        monkeypatch.setattr(step, "sgd_step", _no_update)
    elif fault == "half_batch":
        wrap = _half_batch_mprm if name == "region_mprm_loss" \
            else _half_batch_ce
        monkeypatch.setattr(losses, name, wrap(getattr(losses, name)))
    else:
        monkeypatch.setattr(losses, name,
                            _loss_altered(getattr(losses, name)))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "loss_altered"])
@pytest.mark.parametrize("workload", TRAIN)
def test_training_fault_fails(bench, capsys, monkeypatch, workload, fault):
    _apply_train_fault(monkeypatch, workload, fault)
    line, _ = run_cell(bench, workload, 3, capsys, monkeypatch)
    assert line["correct"] is False, line["checks"]


def _altered_probs(orig):
    def probs(model, batch):
        p = orig(model, batch)
        return torch.roll(p, 1, dims=-1)
    return probs


def _half_votes(orig):
    def update(self, probs, batch, d2=None):
        half = {k: (v[: v.shape[0] // 2] if k in ("flat_inds",
                                                   "center_pts") else v)
                for k, v in batch.items()}
        return orig(self, probs[: probs.shape[0] // 2], half,
                    d2=None if d2 is None else d2[: d2.shape[0] // 2])
    return update


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch",
                                   "state_unchanged"])
def test_vote_fault_fails(bench, capsys, monkeypatch, fault):
    from weasal_tpu_torch import infer
    from weasal_tpu_torch.train.vote import DeviceVoteAccumulator
    if fault == "answer_altered":
        monkeypatch.setattr(infer, "_probs", _altered_probs(infer._probs))
    elif fault == "half_batch":
        monkeypatch.setattr(DeviceVoteAccumulator, "update",
                            _half_votes(DeviceVoteAccumulator.update))
    else:
        monkeypatch.setattr(DeviceVoteAccumulator, "update", _no_update)
    line, _ = run_cell(bench, "v3d_pl.vote", 4, capsys, monkeypatch)
    assert line["correct"] is False, line["checks"]
