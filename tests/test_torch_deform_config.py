"""The deformable KP-FCNN as a configuration of the port, and the marks and
counters of its chains, on the CPU (no JAX).

- `VaihingenPLDeformConfig`: the PL architecture with blocks 7-9
  deformable, equal to the benchmark's `portbench/configs/
  v3d_pl_deform.json`, deform flags on layers 3 and 4, every other value
  the PL configuration's; `deformable_last_layers` on other depths;
- the PL entry point's `--deformable` selects it (DALES's refuses it),
  its quick preset keeps the last two layers deformable, a quick CPU run
  trains the deformable network and `test_models` votes its log;
- a mark does nothing on the CPU; a deformable training step marks each
  chain four times and counts its work forward and backward
  (`ops/kpconv.chain_work`, by hand at one conv); a rigid network marks
  and counts nothing; the `[loop-stats]` line prints the counters a step
  only where there are some.
"""

import json
import os
from os.path import dirname, join

import numpy as np
import pytest
import torch

from weasal_tpu_torch import KPFCNN, init_opt_state
from weasal_tpu_torch.config import (VaihingenPLConfig,
                                     VaihingenPLDeformConfig,
                                     deformable_last_layers)
from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda import marks
from weasal_tpu_torch.train import stage
from weasal_tpu_torch.train.step import step_on_batch
from weasal_tpu_torch.train.trainer import loop_stats_line
from weasal_tpu_torch.utils import profiling
from tests._warm_torch import cpu_torch
from tests.test_torch_deform_reference import QUICK_ARCH, _pyramid

REPO = dirname(dirname(os.path.abspath(__file__)))
LABELS = tuple(range(9)) + (10,)


def test_config_is_the_benchmark_configuration():
    with open(join(REPO, "portbench", "configs", "v3d_pl_deform.json")) as f:
        spec = json.load(f)
    assert spec["program"]["config_class"] == "VaihingenPLDeformConfig"
    cfg = VaihingenPLDeformConfig()
    assert cfg.architecture == spec["config"]["architecture"]
    assert cfg.deform_layers == [False, False, False, True, True]
    rigid = VaihingenPLConfig()
    assert [i for i, (a, b) in enumerate(zip(cfg.architecture,
                                             rigid.architecture))
            if a != b] == [7, 8, 9]
    assert cfg.architecture[7:10] == ["resnetb_deformable",
                                      "resnetb_deformable_strided",
                                      "resnetb_deformable"]
    # every other value is inherited
    assert set(vars(VaihingenPLDeformConfig)) - {"__doc__", "__module__"} \
        == {"architecture"}


def test_deformable_last_layers_of_other_depths():
    arch = deformable_last_layers(QUICK_ARCH)
    assert arch[3:6] == ["resnetb_deformable", "resnetb_deformable_strided",
                         "resnetb_deformable"]
    assert arch[:3] == QUICK_ARCH[:3] and arch[6:] == QUICK_ARCH[6:]
    assert deformable_last_layers(arch) == arch
    with pytest.raises(ValueError):
        deformable_last_layers(["simple", "resnetb", "resnetb_strided",
                                "resnetb", "nearest_upsample", "unary"])


def test_entry_point_switch_selects_the_class():
    from weasal_tpu_torch import train_DALES_PseudoLabel as dales
    from weasal_tpu_torch import train_Vaihingen3D_PseudoLabel as pl
    args = stage.parse_args(pl.STAGE, ["--deformable"])
    assert pl.STAGE.config_for(args) is VaihingenPLDeformConfig
    args = stage.parse_args(pl.STAGE, [])
    assert pl.STAGE.config_for(args) is None
    cfg = VaihingenPLDeformConfig()
    pl.quick(cfg)
    assert cfg.architecture == deformable_last_layers(QUICK_ARCH)
    assert cfg.deform_layers == [False, True, True]
    rigid = VaihingenPLConfig()
    pl.quick(rigid)
    assert rigid.architecture == QUICK_ARCH
    with pytest.raises(ValueError, match="deformable"):
        dales.run(["--deformable", "--device", "cpu"])


def test_entry_point_trains_and_votes_the_deformable_network(tmp_path,
                                                             monkeypatch):
    from weasal_tpu_torch import test_models
    from weasal_tpu_torch.data.datasets import Vaihingen3DPLDataset
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train_Vaihingen3D_PseudoLabel import run
    root = make_vaihingen_like_root(str(tmp_path / "Vaihingen3D"),
                                    extent=30.0, density=5.0, seed=3)
    cfg = VaihingenPLConfig()
    cfg.in_radius, cfg.first_subsampling_dl = 7.0, 0.45
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(test_models, "VOTE_EPOCH_BATCHES", 4)
    log = join("results", "PseudoLabel", "Log_2026-01-01_00-00")
    with cpu_torch():
        val = Vaihingen3DPLDataset(cfg, split="validation", data_root=root,
                                   rng=np.random.default_rng(0))
        truth = val.input_labels[0]
        folder = join(root, "PseudoLabels", "WL")
        os.makedirs(folder)
        np.savetxt(join(folder, "Vaihingen3D_Training_t20_pseudo.txt"),
                   np.where(np.random.default_rng(1).random(truth.shape[0])
                            < 0.3, 10, truth), fmt="%i")
        trainer = run([log, "--data_root", root, "--weak_label_log", "WL",
                       "--preset", "quick", "--device", "cpu",
                       "--al_iterations", "0", "--seed", "0",
                       "--deformable"])
        assert isinstance(trainer.config, VaihingenPLDeformConfig)
        assert trainer.config.deform_layers == [False, True, True]
        assert sum(m.params.deformable for m in trainer.model.modules()
                   if hasattr(m, "params")) == 3
        with open(join(log, "training_iteration0.txt")) as f:
            rows = f.readlines()[1:]
        # the offset loss is logged, finite and positive
        assert rows and all(float(r.split()[3]) > 0 for r in rows)
        tester = test_models.main(["--log", log, "--on", "validation",
                                   "--data_root", root, "--device", "cpu",
                                   "--num_votes", "0"])
    assert tester.config.architecture == trainer.config.architecture
    assert sum(m.params.deformable for m in tester.model.modules()
               if hasattr(m, "params")) == 3


def test_a_mark_does_nothing_off_the_card(monkeypatch):
    def refuse(name):
        raise AssertionError(f"built {name}")
    monkeypatch.setattr(marks, "load_library", refuse)
    for name in marks.MARKS:
        assert marks.mark(name, torch.device("cpu")) is None
    with pytest.raises(ValueError):
        marks.mark("deform_begin", torch.device("cpu"))


def test_chain_work_by_hand():
    b, nq, ns, k, kp, cin, cout = 2, 5, 7, 4, 3, 6, 8
    fwd, bwd = ops.chain_work(torch.zeros(b, nq, 3), torch.zeros(b, ns, 3),
                              torch.zeros(b, nq, k, dtype=torch.int32),
                              torch.zeros(b, ns, cin),
                              torch.zeros(kp, cin, cout), modulated=False)
    rows = 10
    assert fwd["deform.fwd.calls"] == bwd["deform.bwd.calls"] == 1
    assert fwd["deform.fwd.pairs"] == rows * k * kp == 120
    assert fwd["deform.fwd.aggregate"] == 120 * cin == 720
    assert fwd["deform.fwd.gemm"] == rows * kp * cin * cout == 1440
    # q 30, s 42, neighbors 40, x 84, kernel points 9, offsets 90, W 144
    assert fwd["deform.fwd.in_elems"] == 30 + 42 + 40 + 84 + 9 + 90 + 144
    # out 80, minima 30
    assert fwd["deform.fwd.out_elems"] == 80 + 30
    assert bwd["deform.bwd.in_elems"] == 439 + 110
    # dX 84, d offsets 90, dW 144
    assert bwd["deform.bwd.out_elems"] == 84 + 90 + 144


def _small(deformable: bool):
    from tests.test_torch_deform_reference import SmallDeform
    cfg = SmallDeform()
    if not deformable:
        cfg.architecture = list(QUICK_ARCH)
        cfg.__init__()
    return cfg


@pytest.mark.parametrize("deformable", [True, False])
def test_training_step_marks_and_counts(monkeypatch, deformable):
    launched = []
    monkeypatch.setattr(ops, "mark", lambda name, dev: launched.append(name))
    with cpu_torch():
        cfg = _small(deformable)
        pyr = _pyramid(cfg)
        model = KPFCNN(cfg, LABELS, (10,),
                       generator=torch.Generator().manual_seed(0))
        before = profiling.mark()
        step_on_batch(model, init_opt_state(model), pyr, cfg,
                      cfg.learning_rate, seed=torch.tensor(1),
                      use_contrast=True, with_offset_loss=True)
    counts = {k: v["count"] for k, v in profiling.span_totals(before).items()
              if k.startswith("deform.")}
    if not deformable:
        assert launched == [] and counts == {}
        return
    assert sorted(launched) == sorted(list(marks.MARKS) * 3)
    assert launched[:2] == ["deform_fwd_begin", "deform_fwd_end"]
    assert counts["deform.fwd.calls"] == counts["deform.bwd.calls"] == 3
    for part in ("pairs", "aggregate", "gemm"):
        assert counts[f"deform.fwd.{part}"] == counts[f"deform.bwd.{part}"] \
            > 0


def test_loop_stats_prints_work_counters_only_where_counted():
    spans = {"epoch_end": dict(seconds=0.5, self_seconds=0.5, count=1)}
    record = dict(epoch=0, seconds=2.0, steps=4, wait_batch=0.1,
                  dispatch=1.0, flush=0.1, spans=spans)
    assert "deform" not in loop_stats_line(record)
    spans["deform.fwd.calls"] = dict(seconds=0.0, self_seconds=0.0,
                                     count=12)
    spans["deform.fwd.aggregate"] = dict(seconds=0.0, self_seconds=0.0,
                                         count=4 * 1234567891)
    line = loop_stats_line(record)
    assert line.endswith("| deform.* a step: fwd.aggregate=1234567891 "
                         "fwd.calls=3")
