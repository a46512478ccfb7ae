"""Tiny cells for the CPU tests: the benchmark's own configuration files
with small spheres, widths and tiles, run by the harness on the CPU
(`--device cpu`, the program's plain path on the resident input)."""

from __future__ import annotations

import json
import os
from os.path import dirname, join

import pytest

REPO = dirname(dirname(dirname(os.path.abspath(__file__))))
# Small spheres, widths and epochs; enough weak labels that batches
# have regions
TINY = {"in_radius": 7.0, "first_subsampling_dl": 0.45,
        "first_features_dim": 16, "batch_num": 2, "epoch_steps": 4,
        "validation_size": 4, "initial_labels_per_file": 40,
        "added_labels_per_epoch": 5}
TINY_PL_ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb",
                "resnetb_strided", "resnetb", "nearest_upsample", "unary",
                "nearest_upsample", "unary"]


# The vote pass's cell and its metrics. BENCHMARK.json leaves them out
# (the pass is paced by the host, and its rate spreads beyond any bound
# a check allows: PERF.md); the tiny benchmark keeps them, so that the
# driver, its comparison and its readers stay tested for a later cell.
VOTE_CELL = {"name": "v3d_pl.vote", "config": "v3d_pl",
             "traffic": "vote_pass", "chips": 1, "why": "the vote pass"}
VOTE_METRICS = {
    "end_to_end": [{"name": "vote_points_per_s", "unit": "points/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock",
                    "workloads": ["v3d_pl.vote"]}],
    "per_layer": [{"name": name, "unit": unit, "better": better,
                   "source": "device_trace", "layer": layer,
                   "moves": "vote_points_per_s",
                   "workloads": ["v3d_pl.vote"]}
                  for name, unit, better, layer in (
                      ("plain_torch_ms.vote", "ms", "lower",
                       "plain PyTorch model ops"),
                      ("kpconv_roofline.vote", "%", "higher",
                       "kernels B and C"),
                      ("device_idle.vote", "%", "lower", "device"),
                      ("mfu.vote", "%", "higher", "whole step"))]}


def tiny_bench(directory: str) -> str:
    """A BENCHMARK.json of the repo's cells and the vote pass's, whose
    configuration files are their tiny versions, in `directory`; returns
    its path."""
    with open(join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if all(w["name"] != VOTE_CELL["name"] for w in bench["workloads"]):
        bench["workloads"].append(VOTE_CELL)
        for key, entries in VOTE_METRICS.items():
            bench[key] += entries
    for c in bench["configs"]:
        with open(join(REPO, c["file"])) as f:
            spec = json.load(f)
        spec["name"] = "tiny_" + spec["name"]
        spec["config"].update(TINY)
        if spec["config"]["model_name"] == "KPFCNN":
            spec["config"]["architecture"] = TINY_PL_ARCH
        spec["data"].update(extent_m=30.0, density_per_m2=5.0)
        c["file"] = join(directory, c["name"] + ".json")
        with open(c["file"], "w") as f:
            json.dump(spec, f)
    path = join(directory, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="session")
def bench(tmp_path_factory):
    """(the tiny BENCHMARK.json, a data cache shared by the session)."""
    d = tmp_path_factory.mktemp("portbench")
    return tiny_bench(str(d)), str(d / "cache")


def run_cell(bench, workload: str, seed: int, capsys, monkeypatch,
             trace: int = 0, control: bool = False, seconds: float = 3.0):
    """One tiny run of `workload` in this process: (its last line, its
    standard error)."""
    from portbench import run
    from portbench.drivers import common
    path, cache = bench
    monkeypatch.setattr(common, "CACHE", cache)
    monkeypatch.setenv("OMP_NUM_THREADS", "4")
    capsys.readouterr()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace), "--device", "cpu",
            "--bench", path] + (["--control"] if control else [])
    assert run.main(argv) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


def control_readings(err: str):
    """The control's judgement that a `--control` run printed:
    {"correct", "checks": {name: {"value", "limit"}}}."""
    line = next(l for l in err.splitlines() if l.startswith("control "))
    return json.loads(line[len("control "):])
