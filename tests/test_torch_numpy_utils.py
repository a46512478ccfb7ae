"""The port's numpy utilities against the JAX package's, on the CPU.

`utils/conf_matrix` (`create`, `analyze`, `print_to_file`),
`utils/metrics` (`metrics_from_confusions`, `smooth_metrics`),
`utils/html_viewer` (`colors_to_rgb`, `export_html`) and the
`utils/convergence` loaders take the same seeded inputs in both packages
and give equal arrays and equal bytes; the loaders read a log that the
port's trainer wrote; the four `data/debug` functions run on a synthetic
DALES dataset, timed by the span table of `utils/profiling`. No test reads
the reference implementation's files.
"""

import os

import numpy as np
import pytest

from weasal_tpu.utils import conf_matrix as jax_cm
from weasal_tpu.utils import convergence as jax_conv
from weasal_tpu.utils import html_viewer as jax_html
from weasal_tpu.utils import metrics as jax_metrics
from weasal_tpu_torch.data import debug
from weasal_tpu_torch.data.synthetic import (make_dales_like_root,
                                             make_vaihingen_like_root)
from weasal_tpu_torch.utils import conf_matrix, convergence, html_viewer
from weasal_tpu_torch.utils import metrics
from weasal_tpu_torch.utils.profiling import mark, span, span_totals
from tests._warm_torch import cpu_torch

NAMES = {0: "Powerline", 1: "LowVegetation", 2: "ImperviousSurfaces",
         3: "Car", 4: "Fence/Hedge", 5: "Roof"}


def _labels(seed, n=500, values=6):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, values, n).astype(np.int32),
            rng.integers(0, values, n).astype(np.int32))


@pytest.mark.parametrize("asymmetric", [False, True])
def test_conf_matrix_create_and_analyze_equal_jax(asymmetric):
    gt, pred = _labels(0)
    kwargs = {}
    if asymmetric:
        gt[::17] = -1                           # an ignore label
        pred[::13] = 7                          # past the largest
        kwargs = dict(label_values=[0, 1, 2, 3, 4, 5],
                      pred_label_values=[0, 1, 2, 3])
    got = conf_matrix.create(gt, pred, **kwargs)
    want = jax_cm.create(gt, pred, **kwargs)
    np.testing.assert_array_equal(got, want)
    if asymmetric:
        assert got.shape == (6, 4)
        return
    a, b = conf_matrix.analyze(got), jax_cm.analyze(want)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_print_to_file_equal_bytes(tmp_path):
    gt, pred = _labels(1)
    conf = conf_matrix.create(gt, pred)
    conf_matrix.print_to_file(conf, NAMES, str(tmp_path / "port.txt"))
    jax_cm.print_to_file(conf, NAMES, str(tmp_path / "jax.txt"))
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert got.startswith(b"confusion (rows = ground truth):\nPowerline")


@pytest.mark.parametrize("ignore", [False, True])
@pytest.mark.parametrize("smooth_n", [0, 2])
def test_metrics_from_confusions_and_smooth_metrics_equal_jax(ignore,
                                                               smooth_n):
    rng = np.random.default_rng(2)
    confs = rng.integers(0, 50, (3, 7, 6, 6))   # [runs, epochs, C, C]
    for got, want in zip(
            metrics.metrics_from_confusions(confs, ignore),
            jax_metrics.metrics_from_confusions(confs, ignore)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(metrics.smooth_metrics(confs, smooth_n, ignore),
                         jax_metrics.smooth_metrics(confs, smooth_n,
                                                    ignore)):
        np.testing.assert_array_equal(got, want)


def test_html_viewer_equal_bytes(tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    colors = [None, rng.integers(0, 12, 300), rng.random(300),
              rng.random((300, 3)), rng.integers(0, 256, (300, 3))]
    for c in colors:
        np.testing.assert_array_equal(html_viewer.colors_to_rgb(pts, c),
                                      jax_html.colors_to_rgb(pts, c))
    kwargs = dict(layers=[("cloud", pts, colors[1], 1.5)],
                  frames=[(f"f{i}", pts, c, 2.0 + i)
                          for i, c in enumerate(colors[2:])],
                  title="a </script> title", legend=["a", "b", "c"],
                  max_points=200)
    html_viewer.export_html(str(tmp_path / "port" / "v.html"), **kwargs)
    jax_html.export_html(str(tmp_path / "jax" / "v.html"), **kwargs)
    got = (tmp_path / "port" / "v.html").read_bytes()
    assert got == (tmp_path / "jax" / "v.html").read_bytes()
    with pytest.raises(ValueError, match="at least one"):
        html_viewer.export_html(str(tmp_path / "empty.html"))


def test_convergence_loaders_read_the_port_trainers_log(tmp_path,
                                                        monkeypatch):
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    root = make_vaihingen_like_root(str(tmp_path / "V3D"), extent=30.0,
                                    density=5.0)
    monkeypatch.chdir(tmp_path)
    log = os.path.join("results", "WeakLabel", "Log_2026-01-01_00-00")
    with cpu_torch():
        run([log, "--data_root", root, "--preset", "quick", "--device",
             "cpu", "--al_iterations", "0", "--seed", "0"])
    got = convergence.load_training_iterations(log)
    want = jax_conv.load_training_iterations(log)
    assert list(got) == [0] == list(want)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape[1] == 6 and 1 <= got[0].shape[0] <= 3
    ious = convergence.load_val_ious(log)
    np.testing.assert_array_equal(ious, jax_conv.load_val_ious(log))
    assert ious.shape == (1, 9)
    for kwargs in ({}, dict(stage="WeakLabel"),
                   dict(dataset_prefix="Vaihingen3DWL"),
                   dict(dataset_prefix="DALES")):
        assert convergence.find_logs("results", **kwargs) == \
            jax_conv.find_logs("results", **kwargs)
    assert convergence.find_logs("results") == [log]
    x = np.random.default_rng(4).random(40)
    for n in (0, 3, 25):
        np.testing.assert_array_equal(convergence.running_mean(x, n),
                                      jax_conv.running_mean(x, n))


def test_step_timer_and_debug_functions_on_a_synthetic_dataset(tmp_path):
    from weasal_tpu_torch.config import DALESWLConfig
    from weasal_tpu_torch.data.datasets import DALESWLDataset
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import quick
    root = make_dales_like_root(str(tmp_path / "DALES"), extent=40.0,
                                density=3.0, seed=9, train_tiles=2,
                                test_tiles=1)
    cfg = DALESWLConfig()
    quick(cfg)
    ds = DALESWLDataset(cfg, split="training", data_root=root,
                        rng=np.random.default_rng(0))
    plan = ds.calibration()

    start = mark()
    for _ in range(3):
        with span("debug.data"):
            stats = debug.debug_timing(ds, plan, num_batches=2)
        with span("debug.step"):
            debug.debug_upsampling(ds, plan, num_batches=1)
    assert stats["batches"] == 2 and stats["spheres_per_s"] > 0
    timed = span_totals(since=start)
    assert {k: v["count"] for k, v in timed.items()
            if k.startswith("debug.")} == {"debug.data": 3, "debug.step": 3}
    assert all(timed[k]["seconds"] > 0 for k in ("debug.data", "debug.step"))

    paths = debug.debug_show_clouds(ds, plan, out_dir=str(tmp_path / "dbg"))
    assert len(paths) == plan.num_layers + 1
    assert all(os.path.getsize(p) > 0 for p in paths)
    clipped, totals = debug.debug_batch_and_neighbors_calib(
        ds, plan, num_batches=2)
    assert len(totals) == plan.num_layers and all(t > 0 for t in totals)
    assert all(0 <= c <= t for c, t in zip(clipped, totals))
