"""The deformable cell `v3d_pl_deform.train` run tiny on the CPU.

`_tiny.tiny_bench` gives every KPFCNN configuration the rigid tiny
architecture; here the cell's tiny configuration keeps deformable blocks
on its last two layers (the pattern of `VaihingenPLDeformConfig`), so
the program's deformable chains, offset convs, regularizer and deform
group run against the reference's. Checked: `correct` on the plain path,
the control (the reference in TF32) not correct, and the traced line's
schema with `deform_conv_ms.train` and `deform_roofline.train`. A CPU
trace has no device events (and the tiny epochs hold no stretch of the
mix's units), so the traced run reads a stretch of two steps of marked
device intervals in place of its own (three deformable chains a step, 6
us of work inside the marks); the roofline reads the program's own
counters of the tiny window.
"""

import json
import math

import pytest

from portbench import run
from portbench.drivers import stretch as stretch_mod
from portbench.tests._tiny import control_readings, run_cell, tiny_bench
from portbench.tests.test_cells import _schema
from portbench.yardstick import spans as window
from portbench.yardstick import trace

CELL = "v3d_pl_deform.train"
TINY_DEFORM_ARCH = ["simple", "resnetb", "resnetb_strided",
                    "resnetb_deformable", "resnetb_deformable_strided",
                    "resnetb_deformable", "nearest_upsample", "unary",
                    "nearest_upsample", "unary"]
NEW = ("deform_conv_ms.train", "deform_roofline.train")
UNITS = 2


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """(the tiny BENCHMARK.json with the cell's deformable tiny
    configuration, a data cache of its own)."""
    d = tmp_path_factory.mktemp("portbench_deform")
    path = tiny_bench(str(d))
    with open(path) as f:
        manifest = json.load(f)
    (config,) = [c for c in manifest["configs"]
                 if c["name"] == "v3d_pl_deform"]
    with open(config["file"]) as f:
        spec = json.load(f)
    spec["config"]["architecture"] = TINY_DEFORM_ARCH
    with open(config["file"], "w") as f:
        json.dump(spec, f)
    return path, str(d / "cache")


def test_deform_cell_equals_the_reference(bench, capsys, monkeypatch):
    line, err = run_cell(bench, CELL, 2 ** 31 + 13, capsys, monkeypatch,
                         control=True)
    _schema(line, trace=False)
    assert line["correct"], line["checks"]
    for name, c in line["checks"].items():
        assert c["value"] <= (1e-7 if name == "step_gap" else 0.0), name
    # peak_mem_gib reads the card's allocator: none on the CPU
    assert {"setup_s", "train_step_ms"} <= set(line["metrics"])
    control = control_readings(err)
    assert control["correct"] is False, control


def _marked(units: int):
    """A device record of `units` steps, each three chains forward and
    backward with 1 us of work inside each forward bracket and 1 us
    inside each backward one, plus work outside the brackets."""
    device, t = [], 0.0
    for _ in range(units):
        for _ in range(3):
            for d in ("fwd", "bwd"):
                device += [(f"deform_{d}_begin", t, t + 1.0),
                           ("elementwise_kernel", t + 1.0, t + 1.5),
                           ("reduce_kernel", t + 1.2, t + 2.0),
                           (f"deform_{d}_end", t + 2.0, t + 3.0),
                           ("gemm", t + 3.5, t + 5.0)]
                t += 6.0
    return device


def test_traced_line_has_the_deform_metrics(bench, capsys, monkeypatch):
    def laid_over(self):
        # the tiny window's epochs are too short for a stretch of its
        # units: a stretch of two steps in its place
        self.close()
        device = _marked(UNITS)
        return dict(units=UNITS, wall_us=device[-1][2] + 1.0, device=device,
                    families=trace.family_us(device),
                    busy_us=trace.union_us(device), idle={}, whole=True,
                    lost=0, observed={}, counted={})

    monkeypatch.setattr(stretch_mod.Stretch, "read", laid_over)
    records = []
    line_of = run.result_line

    def keep(ctx, cell, result):
        line = line_of(ctx, cell, result)
        records.append(result)
        return line

    monkeypatch.setattr(run, "result_line", keep)
    line, _ = run_cell(bench, CELL, 2 ** 31 + 17, capsys, monkeypatch,
                       trace=1)
    _schema(line, trace=True)
    metrics = line["metrics"]
    assert set(NEW) <= set(metrics)
    assert metrics["deform_conv_ms.train"]["unit"] == "ms"
    assert metrics["deform_conv_ms.train"]["value"] == pytest.approx(6e-3)
    roof = metrics["deform_roofline.train"]
    assert roof["unit"] == "%" and math.isfinite(roof["value"]) \
        and roof["value"] > 0
    # the window's counters: three chains a step, forward and backward
    (record,) = records
    counts = {k: v["count"] for k, v in window.window_spans().items()
              if k.startswith("deform.")}
    assert counts["deform.fwd.calls"] == 3 * record["steps"]
    assert counts["deform.bwd.calls"] == 3 * record["steps"]
