"""The port's kernel-point dispositions against the JAX package's.

Generation from one numpy seed (`spherical_lloyd`, `optimize_kernel_points`
and `load_kernels` on a cache miss, then a hit, at 5 and 40 points, the
sizes of tests/test_kernel_points.py): the arrays within 1e-12 and the
written `.ply` files bit-equal. Each package writes into a temporary
directory of its own, never into either package.

A KPFCNN_mprm forward at `num_kernel_points` 5 and 20 against the JAX
model with the weights carried by `from_jax_variables`: logits rtol 1e-4,
atol 1e-5 on valid rows. Both packages start from the same disposition
state (JAX's `load_kernels` draws the generation from the first conv's
pose rng, so a model's kernel points depend on whether the cache
existed): at 5 points from empty directories, where both generate (and
the port's fresh kernel points equal the flax constants); at 20 points
from one pre-written file in each, since generating 20 points by descent
takes ~40 s a package on this CPU.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from weasal_tpu.data.demo import demo_batch
from weasal_tpu.kernels import kernel_points as jkp
from weasal_tpu.models.architectures import KPFCNN_mprm as JaxModel
from weasal_tpu.models.init import jit_init
from weasal_tpu_torch import KPFCNN_mprm, from_jax_variables
from weasal_tpu_torch.kernels import kernel_points as tkp
from tests._warm_torch import cpu_torch
from tests.test_torch_model import TinyConfig, _as_dicts, _randomize
from tests.test_torch_pl_model import _port_batch


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _same(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [5, 40])
def test_spherical_lloyd_equals_jax(n):
    got = tkp.spherical_lloyd(1.0, n, fixed="center", max_iter=60,
                              rng=np.random.default_rng(5))
    want = jkp.spherical_lloyd(1.0, n, fixed="center", max_iter=60,
                               rng=np.random.default_rng(5))
    _same(got, want)


@pytest.mark.parametrize("fixed", ["center", "verticals", "none"])
def test_optimize_kernel_points_equals_jax(fixed):
    got = tkp.optimize_kernel_points(1.0, 7, num_kernels=4, fixed=fixed,
                                     rng=np.random.default_rng(3))
    want = jkp.optimize_kernel_points(1.0, 7, num_kernels=4, fixed=fixed,
                                      rng=np.random.default_rng(3))
    _same(got[0], want[0])
    _same(got[1], want[1])


@pytest.mark.parametrize("n", [5, 40])
def test_load_kernels_miss_then_hit_equals_jax(tmp_path, n):
    dirs = {k: tmp_path / k for k in ("torch", "jax")}
    name = f"k_{n:03d}_center_3D.ply"
    for seed in (0, 1):          # a miss (generates and writes), a hit
        got = tkp.load_kernels(1.3, n, 3, "center",
                               rng=np.random.default_rng(seed),
                               dispositions_dir=str(dirs["torch"]))
        want = jkp.load_kernels(1.3, n, 3, "center",
                                rng=np.random.default_rng(seed),
                                dispositions_dir=str(dirs["jax"]))
        assert got.dtype == np.float32 and got.shape == (n, 3)
        _same(got, want)
        assert ((dirs["torch"] / name).read_bytes()
                == (dirs["jax"] / name).read_bytes())


def _tiny_pair(n_kp):
    jcfg = graft._tiny_config()
    jcfg.num_kernel_points = n_kp
    cfg = TinyConfig()
    cfg.num_kernel_points = n_kp
    return jcfg, cfg


@pytest.mark.parametrize("n_kp", [5, 20])
def test_kpfcnn_forward_at_other_kernel_sizes_matches_jax(tmp_path,
                                                         monkeypatch, n_kp):
    dirs = {k: tmp_path / k for k in ("torch", "jax")}
    monkeypatch.setattr(tkp, "_DISPOSITION_DIR", str(dirs["torch"]))
    monkeypatch.setattr(jkp, "_DISPOSITION_DIR", str(dirs["jax"]))
    if n_kp == 20:
        # one disposition of 20 points, written into both directories
        jkp.load_kernels(1.0, 20, 3, "center", lloyd=True,
                         rng=np.random.default_rng(8),
                         dispositions_dir=str(dirs["jax"]))
        dirs["torch"].mkdir()
        name = "k_020_center_3D.ply"
        (dirs["torch"] / name).write_bytes((dirs["jax"] / name).read_bytes())
    jcfg, cfg = _tiny_pair(n_kp)
    jbatch, _plan = demo_batch(jcfg, batch_size=2, seed=0, density=8.0)
    jmodel = JaxModel(jcfg, tuple(range(9)), ())
    variables = _as_dicts(jax.device_get(
        jit_init(jmodel, jax.random.PRNGKey(0), jbatch)))
    rng = np.random.default_rng(1)
    _randomize(variables["params"], rng)
    _randomize(variables["batch_stats"], rng)
    carried = from_jax_variables(variables)

    model = KPFCNN_mprm(cfg, tuple(range(9)), ())
    fresh = model.state_dict()
    for key, value in carried.items():
        assert tuple(fresh[key].shape) == tuple(value.shape), key
        if key.endswith("kernel_points"):
            assert value.shape[0] == n_kp
            np.testing.assert_array_equal(fresh[key].numpy(), value.numpy())
    model.load_state_dict(carried, strict=True)
    model.eval()
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jbatch)
    with torch.no_grad():
        logits = model(_port_batch(jbatch))[0]
    mask0 = np.asarray(jbatch.masks[0])
    np.testing.assert_allclose(logits.numpy()[mask0],
                               np.asarray(want[0])[mask0],
                               rtol=1e-4, atol=1e-5)
