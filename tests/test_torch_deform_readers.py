"""The benchmark's readers of the deformable chain
(`portbench/yardstick/deform_work.py`, `portbench/metrics/
deform_conv_ms.train.py` and `deform_roofline.train.py`) on hand-made
traced stretches and counters: begin and end marks paired by direction,
the union of the intervals inside the brackets, unmatched marks, a
stretch without marks giving nothing, and the chain's operations and
bytes against a hand count. No program runs here."""

import pytest

from portbench import run
from portbench.yardstick import deform_work, peaks, work

CONV = dict(calls=1, pairs=120, aggregate=720, gemm=1440, in_elems=439,
            out_elems=110)


def _record(device, units=1, steps=1):
    return dict(kind="train", steps=steps,
                stretch=dict(units=units, device=device, busy_us=1.0,
                             wall_us=100.0))


def test_brackets_pair_begin_and_end_by_direction():
    device = [("deform_fwd_begin", 0.0, 1.0),
              ("elementwise_kernel", 1.0, 3.0),
              ("deform_bwd_end", 3.0, 4.0),        # no open bwd bracket
              ("deform_fwd_end", 4.0, 5.0),
              ("gemm_kernel", 5.0, 9.0),           # outside
              ("deform_bwd_begin", 9.0, 10.0),
              ("reduce_kernel", 10.0, 12.0),
              ("reduce_kernel", 11.0, 13.0),       # overlaps: union
              ("deform_bwd_end", 14.0, 15.0)]
    assert deform_work.brackets(device) == [(1.0, 4.0), (10.0, 14.0)]
    # forward 1-3 (the stray end mark left out), backward 10-13
    assert deform_work.chain_us(device) == pytest.approx(2.0 + 3.0)


def test_unmatched_marks_bracket_nothing():
    device = [("deform_fwd_begin", 0.0, 1.0), ("k", 1.0, 2.0),
              ("deform_fwd_begin", 2.0, 3.0), ("k", 3.0, 5.0),
              ("deform_fwd_end", 5.0, 6.0),
              ("deform_bwd_begin", 6.0, 7.0), ("k", 7.0, 9.0)]
    # the first begin is replaced by the second; the backward never closes
    assert deform_work.brackets(device) == [(3.0, 5.0)]
    assert deform_work.chain_us(device) == pytest.approx(2.0)
    assert deform_work.chain_us([("deform_fwd_end", 0.0, 1.0),
                                 ("k", 1.0, 2.0)]) is None


def test_intervals_are_clipped_to_the_brackets():
    device = [("k", 0.0, 2.0), ("deform_fwd_begin", 1.0, 1.5),
              ("k", 1.5, 6.0), ("deform_fwd_end", 4.0, 4.5)]
    # 1.5-4.0 inside; the kernel running across the begin counts from 1.5
    assert deform_work.chain_us(device) == pytest.approx(2.5)


def test_readers_on_hand_made_stretches(monkeypatch):
    ms = run.reader("deform_conv_ms.train")
    roof = run.reader("deform_roofline.train")
    device = [("deform_fwd_begin", 0.0, 1.0), ("k", 1.0, 3.0),
              ("deform_fwd_end", 3.0, 4.0), ("deform_bwd_begin", 4.0, 5.0),
              ("k", 5.0, 9.0), ("deform_bwd_end", 9.0, 10.0)]
    # two units: 6 us of chain in all, 3 us = 0.003 ms a step
    assert ms(_record(device, units=2)) == pytest.approx(3e-3)
    # no marks, no stretch, another kind: nothing
    assert ms(_record([("k", 0.0, 5.0)])) is None
    assert ms(dict(kind="train", steps=1, stretch=None)) is None
    assert ms(dict(_record(device), kind="vote")) is None
    # the roofline from the window's counters (two steps of one conv)
    from portbench.yardstick import spans
    table = {f"deform.{d}.{k}": dict(seconds=0.0, self_seconds=0.0,
                                     count=2 * v)
             for d in ("fwd", "bwd") for k, v in CONV.items()}
    monkeypatch.setattr(spans, "window_spans", lambda: table)
    record = _record(device, units=2, steps=2)
    bound = deform_work.step_bound_s(deform_work.counted(table), 2)
    assert roof(record) == pytest.approx(100 * bound * 1e3 / 3e-3)
    # a program without the counters gives nothing
    monkeypatch.setattr(spans, "window_spans", lambda: {})
    assert roof(record) is None
    monkeypatch.setattr(spans, "window_spans", lambda: None)
    assert roof(record) is None


def test_chain_work_by_hand():
    fwd = deform_work.chain_work(CONV, backward=False)
    # aggregate 2*720, GEMM 2*1440
    assert fwd["products"] == 1440 + 2880
    # influences 12, the in-range test, its reduction, the mask 3, the
    # minimum 1, a pair
    assert fwd["other"] == 120 * 16
    assert fwd["bytes"] == 4 * (439 + 110)
    bwd = deform_work.chain_work(CONV, backward=True)
    assert bwd["products"] == 2 * (1440 + 2880)
    assert bwd["other"] == 120 * (16 + 8)
    counts = {f"{d}.{k}": v for d in ("fwd", "bwd") for k, v in CONV.items()}
    bwd_counts = dict(counts, **{"bwd.in_elems": 549, "bwd.out_elems": 318})
    bwd = deform_work.chain_work(
        {k[4:]: v for k, v in bwd_counts.items() if k.startswith("bwd.")},
        backward=True)
    assert bwd["bytes"] == 4 * (549 + 318)
    # one step: each direction's bound (here its bytes) summed
    assert deform_work.step_bound_s(bwd_counts, 1) == pytest.approx(
        work.bound_s(fwd)[0] + work.bound_s(bwd)[0])
    assert work.bound_s(fwd) == (max(
        4 * 549 / peaks.HBM_BYTES_PER_S, 4320 / peaks.TF32_FLOP_PER_S,
        1920 / peaks.F32_FLOP_PER_S), "bytes")
    assert deform_work.step_bound_s({"fwd.calls": 1}, 1) is None
