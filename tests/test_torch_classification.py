"""The port's KPCNN classifier on host-built classification batches
against the JAX package's (tests/test_classification.py's pipeline).

- `synthetic_shape_cloud` and `assemble_classification_batch` make the
  same clouds and the same batch from one numpy seed in both packages
  (equal arrays);
- the forward in training mode (BatchNorm on batch statistics) and in
  eval mode (running statistics set to random values in both packages)
  at `ClsConfig`, with the JAX `jit_init` weights carried across by
  `from_jax_variables`: logits rtol 1e-4, atol 1e-5, and the updated
  running statistics;
- one SGD step's gradients of the cross-entropy on `cloud_label`
  against `jax.grad` (rtol 1e-4, atol 1e-5);
- the learning smoke of `test_kpcnn_learns_shapes` on the port alone:
  60 SGD steps (lr 5e-3, momentum 0.9, as optax.sgd), mean accuracy of
  the last 10 above 0.65.
torch runs on one intra-op thread.
"""

import jax
import numpy as np
import pytest
import torch

from weasal_tpu.data.batching import (
    assemble_classification_batch as jax_assemble,
    build_sphere_pyramid as jax_pyramid,
    calibrate_shape_plan as jax_calibrate)
from weasal_tpu.data.synthetic import synthetic_shape_cloud as jax_shape
from weasal_tpu.models import losses as jax_losses
from weasal_tpu.models.architectures import KPCNN as JaxKPCNN
from weasal_tpu.models.init import jit_init
from weasal_tpu_torch import KPCNN, from_jax_variables
from weasal_tpu_torch.config import ShapeClsConfig as PortClsConfig
from weasal_tpu_torch.data.batching import (
    assemble_classification_batch, build_sphere_pyramid,
    calibrate_shape_plan)
from weasal_tpu_torch.data.synthetic import synthetic_shape_cloud
from weasal_tpu_torch.models import losses
from tests._warm_torch import cpu_torch
from tests.test_classification import ClsConfig
from tests.test_torch_model import _as_dicts

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def cls_batch(shape, pyramid, assemble, cfg, plan, rng, b=6):
    """tests/test_classification.py's make_cls_batch with one package's
    functions."""
    clouds = []
    for _ in range(b):
        label = int(rng.integers(3))
        pts = shape(rng, label, n=160)
        clouds.append(dict(
            pyramid=pyramid(pts, cfg, rng=rng, with_upsamples=False),
            features=np.ones((pts.shape[0], 1), np.float32), label=label))
    return assemble(clouds, plan)


def port_batch(cfg, plan, rng, b=6):
    return cls_batch(synthetic_shape_cloud, build_sphere_pyramid,
                     assemble_classification_batch, cfg, plan, rng, b)


def _plan(calibrate, shape, cfg, seed):
    rng = np.random.default_rng(seed)
    calib = [shape(rng, i % 3, n=160) for i in range(6)]
    return calibrate(calib, cfg), rng


@pytest.fixture(scope="module")
def both():
    """(JAX config, plan, batch, variables; port config, plan, batch)
    from seed 0, each package's own pipeline."""
    jcfg, pcfg = ClsConfig(), PortClsConfig()
    jplan, jrng = _plan(jax_calibrate, jax_shape, jcfg, 0)
    pplan, prng = _plan(calibrate_shape_plan, synthetic_shape_cloud, pcfg, 0)
    jbatch = cls_batch(jax_shape, jax_pyramid, jax_assemble, jcfg, jplan,
                       jrng)
    pbatch = port_batch(pcfg, pplan, prng)
    variables = _as_dicts(jax.device_get(
        jit_init(JaxKPCNN(jcfg), jax.random.PRNGKey(0), jbatch)))
    return jcfg, jplan, jbatch, variables, pcfg, pplan, pbatch


def _port_model(pcfg, variables):
    model = KPCNN(pcfg)
    model.load_state_dict(from_jax_variables(variables))
    return model


def _batch_tensors(pbatch):
    return pbatch.to("cpu")


def test_shapes_and_batch_equal_jax(both):
    for name, value in vars(ClsConfig).items():
        if not name.startswith("_"):
            assert getattr(PortClsConfig, name) == value, name
    rng_j, rng_p = np.random.default_rng(4), np.random.default_rng(4)
    for shape_id in range(3):
        np.testing.assert_array_equal(
            synthetic_shape_cloud(rng_p, shape_id, n=97),
            jax_shape(rng_j, shape_id, n=97))
    jcfg, jplan, jbatch, _, pcfg, pplan, pbatch = both
    assert pplan.num_points == jplan.num_points
    assert pplan.conv_neighbors == jplan.conv_neighbors
    assert pplan.pool_neighbors == jplan.pool_neighbors
    assert pbatch.upsamples == () and jbatch.upsamples == ()
    for name in ("points", "masks", "neighbors", "pools", "lengths"):
        for got, want in zip(getattr(pbatch, name), getattr(jbatch, name)):
            np.testing.assert_array_equal(got, np.asarray(want), name)
    for name in ("features", "labels", "center_pts", "cloud_label"):
        np.testing.assert_array_equal(getattr(pbatch, name),
                                      np.asarray(getattr(jbatch, name)),
                                      name)


def test_forward_matches_jax(both):
    jcfg, _, jbatch, variables, pcfg, _, pbatch = both
    jmodel = JaxKPCNN(jcfg)
    rng = np.random.default_rng(2)
    stats = variables["batch_stats"]

    def randomize(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomize(v)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    randomize(stats)
    model = _port_model(pcfg, variables)
    batch = _batch_tensors(pbatch)

    want, mutated = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=True, mutable=["batch_stats"]))(variables, jbatch)
    model.train()
    with torch.no_grad():
        got = model(batch)
    assert tuple(got.shape) == (6, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    new_stats = from_jax_variables(
        {"batch_stats": _as_dicts(jax.device_get(mutated["batch_stats"]))})
    state = model.state_dict()
    for key, value in new_stats.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)

    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, jbatch)
    model = _port_model(pcfg, variables).eval()
    with torch.no_grad():
        got = model(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_sgd_step_gradients_match_jax(both):
    jcfg, _, jbatch, variables, pcfg, _, pbatch = both
    jmodel = JaxKPCNN(jcfg)

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"],
             "constants": variables["constants"]},
            jbatch, train=True, mutable=["batch_stats"])
        return jax_losses.softmax_cross_entropy(out, jbatch.cloud_label)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    want = from_jax_variables({"params": _as_dicts(jax.device_get(jgrads))})

    model = _port_model(pcfg, variables).train()
    batch = _batch_tensors(pbatch)
    loss = losses.softmax_cross_entropy(model(batch),
                                        batch.cloud_label.long())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    params = dict(model.named_parameters())
    assert set(params) == set(want)
    for key, value in want.items():
        grad = params[key].grad
        assert grad is not None, key
        np.testing.assert_allclose(grad.numpy(), value.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=key)


def test_kpcnn_learns_shapes():
    cfg = PortClsConfig()
    plan, rng = _plan(calibrate_shape_plan, synthetic_shape_cloud, cfg, 0)
    model = KPCNN(cfg, generator=torch.Generator().manual_seed(0)).train()
    trace = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    accs = []
    for _ in range(60):
        batch = _batch_tensors(port_batch(cfg, plan, rng))
        model.zero_grad(set_to_none=True)
        out = model(batch)
        target = batch.cloud_label.long()
        losses.softmax_cross_entropy(out, target).backward()
        with torch.no_grad():
            for k, p in model.named_parameters():
                trace[k].mul_(0.9).add_(p.grad)
                p.sub_(5e-3 * trace[k])
        accs.append(float((out.argmax(-1) == target).float().mean()))
    # chance is 1/3; the tiny net must clearly separate the shapes
    assert np.mean(accs[-10:]) > 0.65, f"final accs: {accs[-10:]}"
