"""Port KPFCNN_mprm and the whole inference step against the JAX package.

Weights come from a `jit_init`'d flax model (the `__graft_entry__.entry()`
forward: KPFCNN_mprm at tiny width, 2 spheres) and are carried across by
`from_jax_variables`. Attention `gamma` and every BatchNorm scale, bias and
running statistic are set to random non-trivial values from numpy in both
packages, since their init values (0, 1, 0, 0/1) would hide mistakes.

Tolerances, f32: model outputs on the same JAX-built PyramidBatch
rtol 1e-4, atol 1e-4 (summation order differs in every product; valid
rows only, since padded query rows of the spatial attention are not
defined outputs); the whole step against the JAX forward of
`entry()` on the same level-0 arrays, probabilities atol 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from weasal_tpu.data.demo import demo_batch
from weasal_tpu.models.architectures import KPFCNN_mprm as JaxModel
from weasal_tpu.ops.pyramid import batch_from_device_pyramid as jax_pyramid
from weasal_tpu_torch import KPFCNN_mprm, eval_step, from_jax_variables
from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data.batch import PyramidBatch
from weasal_tpu_torch.infer import to_device
from weasal_tpu_torch.models.blocks import kpconv_modules
from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
from tests._warm_torch import cpu_torch


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


class TinyConfig(Config):
    """The port's copy of __graft_entry__._tiny_config."""
    num_classes = 9
    in_features_dim = 4
    first_features_dim = 16
    in_radius = 5.0
    first_subsampling_dl = 0.5
    architecture = ["simple", "resnetb", "resnetb_strided", "resnetb",
                    "resnetb_strided", "resnetb",
                    "nearest_upsample", "nearest_upsample"]


def _as_dicts(tree):
    return {k: _as_dicts(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


def _tensor(x):
    return torch.from_numpy(np.array(x))


def _randomize(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize(v, rng)
        elif k == "gamma":
            tree[k] = rng.normal(0, 1, v.shape).astype(np.float32)
        elif k == "scale":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k == "bias":
            tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif k == "mean":
            tree[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.3, 2.0, v.shape).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    forward, (variables, arrays) = graft.entry()
    jcfg = graft._tiny_config()
    _, plan = demo_batch(jcfg, batch_size=2, seed=0, density=8.0)
    variables = _as_dicts(variables)
    rng = np.random.default_rng(1)
    _randomize(variables["params"], rng)
    _randomize(variables["batch_stats"], rng)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    model = KPFCNN_mprm(TinyConfig(), tuple(range(9)), ())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return forward, jvars, variables, arrays, jcfg, plan, model


def test_fresh_init_poses_and_names_match_flax(setup):
    _, _, variables, _, _, _, _ = setup
    fresh = KPFCNN_mprm(TinyConfig(), tuple(range(9)), (),
                        generator=torch.Generator().manual_seed(3))
    carried = from_jax_variables(variables)
    state = fresh.state_dict()
    assert set(state) == set(carried)
    for key, value in carried.items():
        assert tuple(state[key].shape) == tuple(value.shape), key
        if key.endswith("kernel_points"):
            np.testing.assert_array_equal(state[key].numpy(), value.numpy())
    assert len(kpconv_modules(fresh)) == 12


def test_model_outputs_match_flax(setup):
    _, jvars, _, arrays, jcfg, plan, model = setup
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    jbatch = jax_pyramid(a["points0"], a["mask0"], a["features"],
                         a["labels"], jcfg, plan, a["center_pts"],
                         rotations=a["rotations"])
    jmodel = JaxModel(jcfg, tuple(range(9)), ())
    want = jmodel.apply(jvars, jbatch, train=False)
    t = _tensor
    batch = PyramidBatch(
        points=tuple(map(t, jbatch.points)),
        masks=tuple(map(t, jbatch.masks)),
        neighbors=tuple(map(t, jbatch.neighbors)),
        pools=tuple(map(t, jbatch.pools)),
        upsamples=tuple(map(t, jbatch.upsamples)),
        features=t(jbatch.features), labels=t(jbatch.labels),
        lengths=tuple(map(t, jbatch.lengths)),
        center_pts=t(jbatch.center_pts))
    model.eval()
    with torch.no_grad():
        logits, cla_logits, cam = model(batch)
    mask0 = np.asarray(jbatch.masks[0])
    np.testing.assert_allclose(logits.numpy()[mask0],
                               np.asarray(want[0])[mask0],
                               rtol=1e-4, atol=1e-4)
    for got, ref in zip(cla_logits, want[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
    for got, ref in zip(cam, want[2]):
        np.testing.assert_allclose(got.numpy()[mask0],
                                   np.asarray(ref)[mask0],
                                   rtol=1e-4, atol=1e-4)
    assert float(np.abs(np.asarray(want[0])[mask0]).max()) > 0.1


def test_eval_step_matches_graft_entry_forward(setup):
    forward, jvars, _, arrays, _, plan, model = setup
    logits, _ = jax.jit(forward)(jvars, arrays)
    want = np.asarray(jax.nn.softmax(logits, axis=-1))
    got = eval_step(model, arrays, TinyConfig(), plan, device="cpu")
    mask0 = arrays["mask0"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[mask0], want[mask0], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy()[mask0].sum(-1), 1.0, atol=1e-5)


def test_training_mode_is_refused(setup):
    *_, arrays, _, plan, model = setup
    model.train()
    try:
        t = to_device(arrays, "cpu")
        batch = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"],
            TinyConfig(), plan, t["center_pts"], rotations=t["rotations"])
        with pytest.raises(NotImplementedError):
            model(batch)
    finally:
        model.eval()
