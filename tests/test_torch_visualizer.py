"""The port's visualizer (weasal_tpu_torch/utils/visualizer.py) and
`MaxPoolBlock` against the JAX package, on the CPU.

Inputs are `tests/test_deformable.py`'s `DeformConfig` network and its
2-sphere `demo_batch` (tests/test_torch_deformable.py's `setup`: the JAX
model's `jit_init` weights with BatchNorm, gamma and offset-bias values
randomized from numpy, carried across by `from_jax_variables`).

- `ModelVisualizer.show_deformable_kernels` writes the JAX inspector's
  file names (but its matplotlib PNG) and returns its frame list; each
  kernel ply's coordinates lie within 2e-4 x its conv's kernel extent
  of the JAX package's (the eval forward's summation order differs in
  every product, as in tests/test_torch_deformable.py);
- `show_point_cloud` and `show_batch` write plys and viewers equal byte
  for byte to the JAX package's; `interactive=True` raises;
- `MaxPoolBlock` (the 'max_pool' block, `pools[layer_ind + 1]`): its
  forward bit-equal to the JAX block's on integer-valued features (ties
  and shadow maxima occur), its VJP within 1e-6; both packages'
  `KPFCNN_mprm` fail on an architecture that holds it.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from weasal_tpu.data.demo import demo_batch
from weasal_tpu.models import blocks as jblocks
from weasal_tpu.models.architectures import KPFCNN_mprm as JaxModel
from weasal_tpu.models.init import jit_init
from weasal_tpu.utils import visualizer as jvis
from weasal_tpu_torch import KPFCNN_mprm
from weasal_tpu_torch.models import blocks
from weasal_tpu_torch.utils import visualizer
from weasal_tpu_torch.utils.ply import read_ply
from tests._warm_torch import cpu_torch
from tests.test_deformable import DeformConfig
from tests.test_torch_deformable import (PortDeformConfig, _port_model,
                                         setup)  # noqa: F401 (a fixture)
from tests.test_torch_pl_model import _port_batch

MAXPOOL_ARCH = ["simple", "resnetb", "max_pool", "resnetb",
                "resnetb_strided", "resnetb", "nearest_upsample",
                "nearest_upsample"]


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


class _JittedEval:
    """The JAX model with its eval apply jitted (an eager flax apply
    dispatches thousands of small CPU ops); the inspector calls
    `apply(variables, batch, train=False, mutable=["deform"])`."""

    def __init__(self, model):
        self.config = model.config
        self._fn = jax.jit(lambda v, b: model.apply(
            v, b, train=False, mutable=["deform"]))

    def apply(self, variables, batch, train, mutable):
        assert not train and mutable == ["deform"]
        return self._fn(variables, batch)


def _coords(path):
    ply = read_ply(path)
    return np.stack([ply["x"], ply["y"], ply["z"]], axis=1)


def test_deformable_kernels_match_jax(setup, tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    variables = jax.tree_util.tree_map(jnp.asarray, setup["variables"])
    want = jvis.ModelVisualizer(_JittedEval(setup["jmodel"]),
                                variables).show_deformable_kernels(
        setup["jbatch"], jdir, sphere=1, query_indices=(0, 2, 5, 10 ** 6))
    model = _port_model(setup)
    model.train()
    got = visualizer.ModelVisualizer(model).show_deformable_kernels(
        setup["batch"], pdir, sphere=1, query_indices=(0, 2, 5, 10 ** 6))
    assert model.training                      # the mode is restored
    assert all(m.regularizer_inputs is None
               for _, m in blocks.kpconv_modules(model))
    assert [os.path.relpath(p, pdir) for p in got] == \
        [os.path.relpath(p, jdir) for p in want]
    assert len(got) == 3 * 4                   # 3 convs: 3 plys, 1 html
    assert sorted(os.listdir(pdir)) == sorted(
        f for f in os.listdir(jdir) if not f.endswith(".png"))
    extents = [m.params.kp_extent
               for _, m in blocks.kpconv_modules(model) if m.params.deformable]
    plys = [p for p in got if p.endswith(".ply")]
    for i, path in enumerate(plys):
        ref = _coords(os.path.join(jdir, os.path.relpath(path, pdir)))
        np.testing.assert_allclose(_coords(path), ref, rtol=0,
                                   atol=2e-4 * extents[i // 3],
                                   err_msg=path)
    for name in ("input.ply", "input.html"):
        with open(os.path.join(pdir, name), "rb") as a, \
                open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_rigid_model_has_nothing_to_show(tmp_path, capsys):
    cfg = PortDeformConfig()
    cfg.architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                        "nearest_upsample"]
    jcfg = DeformConfig()
    jcfg.architecture = cfg.architecture
    jbatch, _ = demo_batch(jcfg, batch_size=1, seed=0, density=6.0)
    model = KPFCNN_mprm(cfg, tuple(range(5)), ())
    assert visualizer.ModelVisualizer(model).show_deformable_kernels(
        _port_batch(jbatch), str(tmp_path)) == []
    assert "no deformable" in capsys.readouterr().out


def test_point_cloud_and_batch_files_equal_jax(setup, tmp_path):
    jbatch = setup["jbatch"]
    pts = np.asarray(jbatch.points[0][0])[np.asarray(jbatch.masks[0][0])]
    labels = np.random.default_rng(2).integers(0, 6, len(pts))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jvis.show_point_cloud(pts, labels, out_prefix=str(jdir / "cloud"))
    assert visualizer.show_point_cloud(
        pts, labels, out_prefix=str(pdir / "cloud")) == str(pdir / "cloud") \
        + ".ply"
    want = jvis.show_batch(jbatch, str(jdir / "batch"), sphere=1)
    got = visualizer.show_batch(setup["batch"], str(pdir / "batch"),
                                sphere=1)
    assert [os.path.relpath(p, pdir) for p in got] == \
        [os.path.relpath(p, jdir) for p in want]
    files = ["cloud.ply", "cloud.html"] + [os.path.relpath(p, pdir)
                                          for p in got]
    for name in files:
        assert (pdir / name).read_bytes() == (jdir / name).read_bytes(), \
            name
    assert not list(pdir.rglob("*.png"))
    with pytest.raises(NotImplementedError, match="mayavi"):
        visualizer.show_point_cloud(pts, out_prefix=str(pdir / "i"),
                                    interactive=True)


@pytest.mark.parametrize("name", ["max_pool", "max_pool_wide"])
def test_max_pool_block_matches_jax(setup, name):
    """The decider's block on level 0's features of the demo batch,
    pooled over pools[1] (level 1 -> level 2): forward bit-equal, VJP
    within 1e-6."""
    jbatch, batch = setup["jbatch"], setup["batch"]
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, (2, jbatch.points[0].shape[1], 8)).astype(
        np.float32)
    g = rng.normal(0, 1, (2, jbatch.points[2].shape[1], 8)).astype(
        np.float32)
    jblock = jblocks.block_decider(name, 1.0, 8, 8, 0, DeformConfig())
    want, vjp = jax.vjp(lambda v: jblock.apply({}, v, jbatch, False),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    block = blocks.block_decider(name, 1.0, 8, 8, 0, PortDeformConfig(), (),
                                 torch.Generator())
    assert isinstance(block, blocks.MaxPoolBlock)
    xt = torch.from_numpy(x).requires_grad_()
    out = block(xt, batch)
    assert out.shape == (2, jbatch.points[2].shape[1], 8)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=0, atol=1e-6)
    # the shared shadow row of the edge is a real row of level 0
    assert float(np.abs(np.asarray(want_dx)[:, jbatch.points[1].shape[1]])
                 .sum()) > 0


def test_models_with_a_max_pool_block_fail_in_both_packages(setup):
    jcfg = DeformConfig()
    jcfg.architecture = MAXPOOL_ARCH
    jbatch, _ = demo_batch(jcfg, batch_size=2, seed=0, density=6.0)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jit_init(JaxModel(jcfg, tuple(range(5)), ()),
                 jax.random.PRNGKey(0), jbatch)
    cfg = PortDeformConfig()
    cfg.architecture = MAXPOOL_ARCH
    model = KPFCNN_mprm(cfg, tuple(range(5)), ())
    assert any(isinstance(m, blocks.MaxPoolBlock) for m in model.modules())
    with pytest.raises(RuntimeError, match="size of tensor"):
        model(_port_batch(jbatch))
