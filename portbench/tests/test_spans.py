"""The readers of the program's span table (yardstick/spans.py) on a
tiny traced training run: `epoch_end_ms.train` and `batch_host_ms.train`
are in the line, the window's table is the loop's own record of its
waits, `wait_batch_share.train` reads that record as before, and a
program without the table (the parent of the span table) gives no
number and no error."""

import pytest

from portbench import run
from portbench.tests._tiny import bench, run_cell  # noqa
from portbench.yardstick import spans as window

NEW = ("epoch_end_ms.train", "batch_host_ms.train")


@pytest.mark.parametrize("workload", ["v3d_wl.train", "v3d_pl.train"])
def test_span_readers_on_a_traced_run(bench, capsys, monkeypatch, workload):
    records = []
    line_of = run.result_line

    def keep(ctx, cell, result):
        line = line_of(ctx, cell, result)
        records.append(result)
        return line

    monkeypatch.setattr(run, "result_line", keep)
    line, _ = run_cell(bench, workload, 2 ** 31 + 7, capsys, monkeypatch,
                       trace=1)
    (record,) = records
    metrics = line["metrics"]
    for name in NEW:
        assert metrics[name]["unit"] == "ms" and metrics[name]["value"] > 0
    spans = window.window_spans()
    steps = record["steps"]
    assert spans["loop.dispatch"]["count"] >= steps
    assert metrics["epoch_end_ms.train"]["value"] == pytest.approx(
        1e3 * (spans["epoch_end"]["seconds"]
               + spans["epoch_start"]["seconds"]) / steps)
    assert metrics["batch_host_ms.train"]["value"] == pytest.approx(
        1e3 * (spans["batch.sample"]["seconds"]
               + spans["batch.pin"]["seconds"]) / steps)
    # the loop's wait for batches, as the accepted reader reads it
    assert record["wait_batch_s"] == pytest.approx(
        spans["loop.wait_batch"]["seconds"])
    assert metrics["wait_batch_share.train"]["value"] == pytest.approx(
        100 * record["wait_batch_s"] / record["loop_s"])

    # a program without the span table: nothing, and no error
    from weasal_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "span_totals")
    assert all(run.reader(name)(record) is None for name in NEW)
