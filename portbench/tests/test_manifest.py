"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, limits and metric readers are found by name, so that a new
cell or metric is new files and entries; the imports the contract
forbids."""

import json
import os
import subprocess
import sys
from os.path import exists, join

import pytest

from portbench import run
from portbench.tests._tiny import REPO

with open(join(REPO, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)


def test_every_cell_finds_its_files_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in names
        found = run.load_cell(cell["name"], join(REPO, "BENCHMARK.json"))
        assert found["spec"]["name"] == cell["config"]
        assert exists(join(REPO, "portbench", "drivers",
                           found["traffic"]["driver"] + ".py"))
        assert found["end_to_end"] and found["per_layer"]
        assert set(found["limits"]) >= {"resident_mismatch"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_a_new_cell_is_new_files_and_entries(tmp_path, monkeypatch):
    """A mix, a metric and a cell added as files and entries only."""
    pb = tmp_path / "portbench"
    for sub in ("traffic", "metrics", "limits"):
        (pb / sub).mkdir(parents=True)
    (pb / "traffic" / "new_mix.json").write_text(
        json.dumps({"driver": "train_loop", "followed_steps": 3}))
    (pb / "limits" / "v3d_wl.new.json").write_text(
        json.dumps({"resident_mismatch": 0}))
    (pb / "metrics" / "new_metric.x.py").write_text(
        "def read(record):\n    return 1.5\n")
    bench = json.loads(json.dumps(BENCH))
    for c in bench["configs"]:
        c["file"] = join(REPO, c["file"])
    bench["workloads"].append(dict(name="v3d_wl.new", config="v3d_wl",
                                   traffic="new_mix", chips=1, why="x"))
    bench["per_layer"].append(dict(
        name="new_metric.x", unit="%", better="higher", source="x",
        layer="x", moves="train_step_ms", workloads=["v3d_wl.new"]))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    monkeypatch.setattr(run, "HERE", str(pb))
    cell = run.load_cell("v3d_wl.new", str(path))
    assert cell["traffic"]["driver"] == "train_loop"
    assert [m["name"] for m in cell["per_layer"]] == ["new_metric.x"]
    assert run.reader("new_metric.x")({}) == 1.5


def test_manifest_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in BENCH["workloads"]:
        assert len(cell["why"]) <= 200 and cell["chips"] == 1


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in "
                          "sys.modules}))"], cwd=REPO, capture_output=True,
                         text=True, check=True, env=dict(os.environ))
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    found = _modules_after(
        "import portbench.run, portbench.drivers.train_loop, "
        "portbench.drivers.vote_pass, weasal_tpu_torch.train.trainer, "
        "weasal_tpu_torch.train.tester")
    assert not found & set(run.FORBIDDEN)
    assert "weasal_tpu_torch" in found


def test_the_reference_imports_nothing_of_the_program():
    found = _modules_after(
        "import portbench.reference.train.step, "
        "portbench.reference.infer, portbench.reference.train.vote, "
        "portbench.reference.models.architectures, "
        "portbench.reference.data.resident, portbench.yardstick.compare, "
        "portbench.yardstick.synthetic")
    assert not found & (set(run.FORBIDDEN) | {"weasal_tpu_torch"})


@pytest.mark.parametrize("names,bad", [
    (["jax.numpy", "torch"], ["jax"]),
    (["weasal_tpu_torch.ops", "numpy"], []),
    (["weasal_tpu.ops"], ["weasal_tpu"]),
    (["optax"], ["optax"]),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, names, bad):
    fake = {n: object() for n in names}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == bad
