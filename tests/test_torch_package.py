"""Port package hygiene and device rules: no JAX and nothing of weasal_tpu
on import, CUDA by default with no silent CPU fallback, and kernel
wrappers that raise instead of computing where they cannot launch."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from weasal_tpu_torch import KPFCNN_mprm, VaihingenWLConfig, eval_step
from weasal_tpu_torch.data.batching import ShapePlan
from weasal_tpu_torch.ops.cuda import build
from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd
from weasal_tpu_torch.ops.cuda.radius_search import radius_search
from weasal_tpu_torch.utils.device import (plain_ops, resolve_device,
                                           use_kernel)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|weasal_tpu|sklearn"
                       r"|matplotlib)\b", re.M)


def test_import_loads_no_jax_or_weasal_tpu():
    code = ("import sys, weasal_tpu_torch, weasal_tpu_torch.infer, "
            "weasal_tpu_torch.ops.pyramid, weasal_tpu_torch.data.demo, "
            "weasal_tpu_torch.data.level0, chip_smoke, "
            "weasal_tpu_torch.train_Vaihingen3D_WeakLabel, "
            "weasal_tpu_torch.train_Vaihingen3D_PseudoLabel, "
            "weasal_tpu_torch.train_DALES_WeakLabel, "
            "weasal_tpu_torch.train_DALES_PseudoLabel, "
            "weasal_tpu_torch.test_models, "
            "weasal_tpu_torch.export_torch_checkpoint, "
            "weasal_tpu_torch.utils.checkpoint, "
            "weasal_tpu_torch.utils.torch_interop\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'weasal_tpu', 'sklearn', "
            "'matplotlib')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_import_no_jax_or_weasal_tpu():
    files = sorted((ROOT / "weasal_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        assert not FORBIDDEN.search(f.read_text()), f


def test_entry_point_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    model = KPFCNN_mprm(VaihingenWLConfig(), tuple(range(9)), ())
    plan = ShapePlan(num_points=[8, 8, 8], conv_neighbors=[2, 2, 2],
                     pool_neighbors=[2, 2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_step(model, {}, VaihingenWLConfig(), plan)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernels_raise_instead_of_computing_without_a_library():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    for name in build.SOURCES:
        with pytest.raises(RuntimeError):
            build.load_library(name)
    # Tensors on a device that is neither cpu nor cuda never reach the
    # plain versions either
    q = torch.zeros(1, 4, 3, device="meta")
    m = torch.ones(1, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        radius_search(q, q, m, m, 1.0, 2)
    nb = torch.zeros(1, 4, 2, dtype=torch.int32, device="meta")
    x = torch.zeros(1, 4, 5, device="meta")
    with pytest.raises(ValueError):
        kpconv_fwd(q, q, nb, x, torch.zeros(15, 3, device="meta"),
                   torch.zeros(15, 5, 6, device="meta"), 1.0)


def test_kernel_routing_follows_the_tensor():
    t = torch.zeros(2)
    assert not use_kernel(t)
    with plain_ops():
        assert not use_kernel(t)


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_vaihingen_config_values():
    cfg = VaihingenWLConfig()
    assert cfg.num_layers == 3
    assert (cfg.first_features_dim, cfg.in_features_dim,
            cfg.num_kernel_points) == (64, 4, 15)
    assert (cfg.in_radius, cfg.first_subsampling_dl, cfg.conv_radius) == \
        (18.0, 0.24, 2.5)
    assert cfg.compute_dtype == "float32" and cfg.batch_num == 3
    assert np.isclose(cfg.augment_scale_max, 1.2)
