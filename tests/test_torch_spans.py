"""The span table (weasal_tpu_torch/utils/profiling.py) and the spans of
the training loop and its batch producer, on the CPU.

The table's arithmetic runs on a stand-in clock: totals, self time under
nesting, per-thread tables summed (an ended thread's kept), counters,
marks; no update is lost with many threads. With no profiler open a
span opens no `record_function` range; under torch.profiler the calling
thread's spans are ranges of its trace.
A short weak-label run of the entry point (quick preset, two epochs with
a checkpoint and a validation each) gives every epoch_times entry its
`spans`, every part of the epoch's end among them, with `wait_batch`,
`dispatch` and `flush` the loop.* totals; the WEASAL_TRACE_DIR window
holds the loop's ranges. JAX-free.
"""

import contextlib
import io
import os
import sys
import threading

import pytest
import torch

from weasal_tpu_torch.ops import native
from weasal_tpu_torch.utils import profiling
from weasal_tpu_torch.utils.profiling import (add, counter, mark, span,
                                              span_totals)
from tests._warm_torch import cpu_torch


class _Clock:
    """time.perf_counter's stand-in: `now`, moved by the test."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(profiling, "time", c)
    return c


def test_totals_self_time_threads_and_counters(clock):
    start = mark()
    with span("t.outer"):
        clock.now += 1.0
        with span("t.inner"):
            clock.now += 2.0
        clock.now += 3.0
        with span("t.inner"):
            clock.now += 0.5
        # a block the caller timed itself: a closed child of t.outer
        clock.now += 1.5
        add("t.inner", 1.5)
    counter("t.count", 3)

    def worker():
        with span("t.inner"):
            clock.now += 4.0
        counter("t.count")

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    got = span_totals(since=start)
    assert set(got) == {"t.outer", "t.inner", "t.count"}
    assert got["t.outer"] == dict(seconds=8.0, self_seconds=4.0, count=1)
    # three on this thread, one on the ended worker's table
    assert got["t.inner"] == dict(seconds=8.0, self_seconds=8.0, count=4)
    assert got["t.count"] == dict(seconds=0.0, self_seconds=0.0, count=4)
    # a named mark: only what came after it
    mark("t.later")
    with span("t.inner"):
        clock.now += 1.0
    assert span_totals("t.later") == {
        "t.inner": dict(seconds=1.0, self_seconds=1.0, count=1)}
    assert span_totals(since=start)["t.inner"]["count"] == 5
    with pytest.raises(KeyError):
        span_totals("t.no_such_mark")


def test_no_update_is_lost_across_threads():
    """More threads than cores add spans and counts while this thread
    reads the table, with a short switch interval: every count is kept,
    those of ended threads included."""
    threads, rounds = 2 * (os.cpu_count() or 4), 2000
    start = mark()

    def worker():
        for _ in range(rounds):
            with span("t.stress"):
                counter("t.stress.count")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker) for _ in range(threads)]
        for t in pool:
            t.start()
        while any(t.is_alive() for t in pool):
            span_totals(since=start)
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    got = span_totals(since=start)
    assert got["t.stress"]["count"] == threads * rounds
    assert got["t.stress.count"]["count"] == threads * rounds


def test_a_span_is_a_profiler_range_only_while_one_is_open(monkeypatch):
    opened = []
    real = profiling._autograd_profiler.record_function

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        recording)
    with span("t.off"):
        pass
    assert opened == []
    from torch.profiler import ProfilerActivity, profile
    seen = {}

    def worker():
        with span("t.producer"):
            seen["ran"] = True

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.loop"):
            torch.ones(4).sum()
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    assert seen and opened == ["t.loop", "t.producer"]
    names = {e.name for e in prof.events()}
    assert "t.loop" in names


@pytest.fixture(scope="module")
def wl_run(tmp_path_factory):
    """A quick WL run of two epochs of 6 batches, a checkpoint and a
    validation batch an epoch, with WEASAL_LOOP_STATS and the
    WEASAL_TRACE_DIR window (steps 2-4 of epoch 0, a flush a step)."""
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.train import trainer as port_trainer
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    tmp = tmp_path_factory.mktemp("spans")
    root = make_vaihingen_like_root(str(tmp / "Vaihingen3D"), extent=30.0,
                                    density=5.0, seed=3)
    traces = str(tmp / "traces")
    mp = pytest.MonkeyPatch()
    mp.setenv("WEASAL_LOOP_STATS", "1")
    mp.setenv("WEASAL_TRACE_DIR", traces)
    mp.setattr(port_trainer, "TRACE_START", 2)
    mp.setattr(port_trainer, "TRACE_STEPS", 2)
    mp.setattr(port_trainer, "FLUSH_STEPS", 1)
    out = io.StringIO()
    try:
        with cpu_torch(), contextlib.redirect_stdout(out):
            trainer = run([str(tmp / "log"), "--data_root", root,
                           "--preset", "quick", "--device", "cpu",
                           "--epoch_steps", "6", "--seed", "0",
                           "--validation_size", "1", "--max_epoch", "2",
                           "--al_iterations", "0"])
        window = span_totals("train")
    finally:
        mp.undo()
    return trainer, window, traces, out.getvalue().splitlines()


def test_epoch_entries_carry_their_spans(wl_run):
    trainer, window, _, printed = wl_run
    assert len(trainer.epoch_times) == 2
    summed = {}
    for e in trainer.epoch_times:
        spans = e["spans"]
        for part in ("drops", "audit", "checkpoint", "validation"):
            assert spans[f"epoch_end.{part}"]["count"] == 1, part
        end = spans["epoch_end"]
        parts = sum(spans[f"epoch_end.{p}"]["seconds"] for p in
                    ("drops", "audit", "checkpoint", "validation"))
        assert end["seconds"] >= parts
        assert end["self_seconds"] == pytest.approx(end["seconds"] - parts)
        assert spans["epoch_start"]["count"] == 1
        # the audit's searches, 4 spheres x (2L - 1) edges, by path
        searches = [spans.get(f"audit.search_{p}", {}).get("count", 0)
                    for p in ("native", "fallback")]
        assert sum(searches) == 4 * (2 * trainer.plan.num_layers - 1)
        assert searches[0] == (sum(searches) if native.available() else 0)
        # the keys the loop's readers read are the loop.* totals
        for key in ("wait_batch", "dispatch", "flush"):
            assert e[key] == spans[f"loop.{key}"]["seconds"], key
        # and the epoch's time in none of them
        assert spans["loop.other"]["count"] == 1
        assert spans["loop.other"]["seconds"] == pytest.approx(
            e["seconds"] - e["wait_batch"] - e["dispatch"] - e["flush"])
        # one wait a pack (the end's is not counted); one load a step
        # (K = 1)
        dispatches = len(e["dispatch_stamps"])
        assert spans["loop.wait_batch"]["count"] == dispatches
        assert spans["loop.dispatch"]["count"] == dispatches
        assert spans["loop.load"]["count"] == e["steps"] == dispatches
        # the producer's: every sampled batch kept or skipped (the
        # validation's batch among them)
        skipped = spans.get("batch.skipped", {}).get("count", 0)
        assert spans["batch.sample"]["count"] == \
            spans["batch.produced"]["count"] + skipped
        assert spans["batch.pin"]["count"] == spans["batch.produced"]["count"]
        assert spans["batch.produced"]["count"] == e["steps"] + 1
        for k, v in spans.items():
            n = summed.setdefault(k, [0.0, 0])
            n[0] += v["seconds"]
            n[1] += v["count"]
    # the training call's table is its epochs' tables summed
    for k, (seconds, count) in summed.items():
        assert window[k]["count"] == count, k
        assert window[k]["seconds"] == pytest.approx(seconds), k
    lines = [l for l in printed if l.startswith("[loop-stats]")]
    assert len(lines) == 2 and all(
        "epoch_end=" in l and "checkpoint=" in l and "validation=" in l
        and "audit searches native=" in l and "sample=" in l
        and "other=" in l for l in lines)


def test_trace_window_holds_the_loop_ranges(wl_run):
    _, _, traces, _ = wl_run
    assert os.listdir(traces) == ["trace_epoch0.json"]
    names = {r[0] for r in profiling.host_ranges(traces)}
    assert {"loop.wait_batch", "loop.dispatch", "loop.load",
            "loop.flush"} <= names
