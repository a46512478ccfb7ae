"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. The cell names a
configuration (portbench/configs/<config>.json) and a traffic mix
(portbench/traffic/<traffic>.json); the mix names the driver that runs
it (portbench/drivers/<driver>.py), and each per-layer metric is read by
portbench/metrics/<metric>.py. The limits of the numbers that decide
`correct` are portbench/limits/<workload>.json. Nothing here names a
cell: a new cell is new files and entries.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`: each compared number with its limit);
the last lines of standard error give the same numbers and limits. A run
without a card, without the program, or that finds JAX or the JAX
package loaded prints no result and exits with another code than 0.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from os.path import dirname, exists, join  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

HERE = dirname(os.path.abspath(__file__))
# Modules that may not be loaded in the process that prints the result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "weasal_tpu")


def cache_environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own kernels build into weasal_tpu_torch/_build)."""
    cache = join(HERE, "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = join(cache, sub)
    os.environ.setdefault("USE_FLAX", "0")


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_cell(workload: str, bench_path: str) -> Dict:
    """The cell's entries and files, found by name."""
    if not exists(bench_path):
        fail(f"no {bench_path}")
    with open(bench_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        fail(f"no workload {workload!r} in {bench_path}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(configs[cell["config"]]["file"]) as f:
        spec = json.load(f)
    with open(join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(join(HERE, "limits", workload + ".json")) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    layers = [m for m in bench["per_layer"]
              if workload in m.get("workloads", [workload])]
    return dict(bench=bench, cell=cell, spec=spec, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layers)


def reader(metric: str):
    """The `read(record)` of portbench/metrics/<metric>.py."""
    path = join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


class Context:
    """What a driver gets: the cell, the run's arguments, its device."""

    def __init__(self, args, cell: Dict, device):
        self.workload = args.workload
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.control = bool(args.control)
        self.spec = cell["spec"]
        self.traffic = cell["traffic"]
        self.device = device

    def clock(self) -> float:
        return time.perf_counter() - _START

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        import torch
        return int(torch.cuda.max_memory_allocated(self.device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control (the reference in TF32 in the program's place) beside
    # the program; for setting limits, not for the benchmark's runs
    parser.add_argument("--control", action="store_true",
                        help=argparse.SUPPRESS)
    # tests: another device or manifest than the card and BENCHMARK.json
    parser.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    parser.add_argument("--bench", default="BENCHMARK.json",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    cache_environment()
    cell = load_cell(args.workload, args.bench)
    import torch
    device = torch.device(args.device)
    chips = int(cell["cell"]["chips"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is False", 3)
        if torch.cuda.device_count() < chips:
            fail(f"{torch.cuda.device_count()} cards, the cell needs "
                 f"{chips}", 3)
    try:
        import weasal_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the program (weasal_tpu_torch) is not here: {exc}", 4)

    ctx = Context(args, cell, device)
    driver = importlib.import_module(
        "portbench.drivers." + cell["traffic"]["driver"])
    result = driver.run(ctx)

    found = forbidden_modules()
    if found:
        fail(f"modules loaded that the port may not load: {found}", 5)
    line = result_line(ctx, cell, result)
    found = forbidden_modules()
    if found:
        fail(f"modules loaded that the port may not load: {found}", 5)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


def result_line(ctx, cell: Dict, result: Dict) -> Dict:
    """The run's last line: with `--trace 1` the per-layer metrics and
    the breakdown of the traced stretch, else the end-to-end metrics;
    the compared numbers last."""
    from portbench.yardstick import compare
    import torch
    ok, checks = compare.judge(result["numbers"], cell["limits"])
    if ctx.control and result.get("control") is not None:
        # the control judged as a run is: it has to come out not correct
        control = result["control"]
        c_ok, c_checks = compare.judge(
            control, {k: v for k, v in cell["limits"].items()
                      if k in control})
        print("control " + json.dumps({"correct": c_ok,
                                       "checks": c_checks}),
              file=sys.stderr)
    record = dict(result)
    if ctx.trace:
        stretch = result.get("stretch")
        record["stretch"] = stretch.read() if stretch is not None else None
    metrics: Dict[str, Dict] = {}
    for m in cell["per_layer" if ctx.trace else "end_to_end"]:
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = ctx.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(ctx.device) if cuda
              else "cpu",
              "count": int(cell["cell"]["chips"]) if cuda else 1,
              "memory_peak_bytes": int(result["memory_peak_bytes"])}
    st = record.get("stretch")
    if ctx.trace:
        device["busy_s"] = st["busy_us"] / 1e6 if st else 0.0
        device["window_s"] = st["wall_us"] / 1e6 if st else 0.0
    card = power_limit() if cuda else None
    if card:
        device["card"] = card       # its name and power limit
    line = {"correct": bool(ok), "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": metrics,
            "device": device}
    if st is not None:
        line["breakdown"] = breakdown(st)
    line["checks"] = checks
    return line


def breakdown(st: Dict) -> Dict:
    """The stretch's device families and idle gaps, in seconds, at most 10
    of each, largest first."""
    ops = sorted(st["families"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(st["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e6] for k, v in ops],
            "idle_gaps": [[k, v / 1e6] for k, v in gaps]}


if __name__ == "__main__":
    sys.exit(main())
