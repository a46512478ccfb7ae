"""The port's pseudo-label network, losses and step against the JAX package.

A tiny pseudo-label configuration (3 levels, `first_features_dim` 8, two
spheres of 5 m): the JAX `KPFCNN`'s `jit_init` weights, with every
BatchNorm parameter and statistic randomized from numpy (as in
test_torch_model.py), carried across by `from_jax_variables`; the labels
of the level-0 batch are the dataset's raw indices, about 30 % of them
the 'Ignore' class 10. Both packages run on the pyramid that the JAX
package builds from those arrays, so that only the network, the losses
and the update are compared.

- The forward, eval and train mode (outputs and updated statistics):
  rtol 1e-4, atol 1e-5; dropout 0, and dropout 0.5 with one keep mask on
  both sides (flax's `Dropout` replaced by a test-local module that
  applies the injected mask).
- `softmax_cross_entropy` and `contrast_loss` with injected `slc_idx`,
  values and gradients: rtol 1e-5 (atol 1e-7 on the gradients).
- The contrast draw: only certain points are drawn, the fallback to the
  valid points when none is certain, 0 when none is valid, and indices
  equal to the inverse CDF's on the same uniforms; the dropout mask of
  seed s equals `jax.random.bernoulli(PRNGKey(s))`, as flax draws it.
- One step with the contrast loss and `grad_clip_norm` low enough that the
  clamp by value acts: loss rtol 1e-5; gradients and momentum rtol 1e-3,
  atol 1e-5 x the model's largest |gradient| (as tests/test_torch_train.py
  holds the weak-label step: the momentum holds the clamped gradients,
  whose error that atol bounds); parameters and BatchNorm statistics
  rtol 1e-3, atol 1e-5 x the tensor's max |value|.
"""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from weasal_tpu.config import Config as JaxConfig
from weasal_tpu.data.demo import demo_batch, demo_sphere, thin_payload
from weasal_tpu.data.level0 import assemble_level0
from weasal_tpu.models import losses as jlosses
from weasal_tpu.models.architectures import KPFCNN as JaxKPFCNN
from weasal_tpu.models.architectures import valid_label_mapper as jax_mapper
from weasal_tpu.models.init import jit_init
from weasal_tpu.ops.pyramid import batch_from_device_pyramid as jax_pyramid
from weasal_tpu.train.trainer import make_optimizer
from weasal_tpu_torch import (KPFCNN, from_jax_opt_state, from_jax_variables,
                              init_opt_state)
from weasal_tpu_torch.config import Config
from weasal_tpu_torch.data.batch import PyramidBatch
from weasal_tpu_torch.models import losses
from weasal_tpu_torch.models.blocks import dropout_keep
from weasal_tpu_torch.train.step import step_on_batch
from weasal_tpu_torch.utils import prng
from tests._warm_torch import cpu_torch
from tests.test_torch_model import _as_dicts, _randomize
from tests.test_torch_train import _assert_close, _np_tree

LABELS, IGNORED = tuple(range(9)) + (10,), (10,)
CLASS_W = [0.6, 1.4, 0.9, 2.0, 1.1, 0.8, 1.7, 1.2, 0.5]
ATTRS = dict(
    dataset="Vaihingen3DPL", num_classes=9, in_features_dim=4,
    first_features_dim=8, num_kernel_points=15, in_radius=5.0,
    first_subsampling_dl=0.5, conv_radius=2.5,
    architecture=["simple", "resnetb", "resnetb_strided", "resnetb",
                  "resnetb_strided", "resnetb", "nearest_upsample",
                  "unary", "nearest_upsample", "unary"],
    use_batch_norm=True, batch_norm_momentum=0.02, model_name="KPFCNN",
    learning_rate=0.01, momentum=0.98, weight_decay=1e-3,
    grad_clip_norm=100.0, class_w=CLASS_W, dropout=0.0, contrast_start=0,
    contrast_thd=20)


def configs(**overrides):
    attrs = {**ATTRS, **overrides}
    jcfg = type("JaxTinyPL", (JaxConfig,), dict(attrs, device_pyramid=True))()
    pcfg = type("PortTinyPL", (Config,), attrs)()
    return jcfg, pcfg


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


class InjectedDropout(fnn.Module):
    """flax Dropout with the module-level KEEP mask instead of a draw."""
    rate: float

    @fnn.compact
    def __call__(self, x, deterministic=None, rng=None):
        if deterministic:
            return x
        return jnp.where(jnp.asarray(InjectedDropout.KEEP),
                         x / (1.0 - self.rate), jnp.zeros_like(x))


def _port_batch(jbatch) -> PyramidBatch:
    def t(x):
        return torch.from_numpy(np.array(x))
    return PyramidBatch(
        points=tuple(map(t, jbatch.points)),
        masks=tuple(map(t, jbatch.masks)),
        neighbors=tuple(map(t, jbatch.neighbors)),
        pools=tuple(map(t, jbatch.pools)),
        upsamples=tuple(map(t, jbatch.upsamples)),
        features=t(jbatch.features), labels=t(jbatch.labels),
        lengths=tuple(map(t, jbatch.lengths)),
        center_pts=t(jbatch.center_pts))


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = configs()
    _, plan = demo_batch(jcfg, batch_size=2, seed=0, density=8.0)
    rng = np.random.default_rng(5)
    arrays = assemble_level0(
        [thin_payload(demo_sphere(rng, jcfg, density=8.0),
                      plan.num_points[0], rng) for _ in range(2)],
        plan, jcfg.num_classes, rng)
    labels = arrays["labels"]
    unlabeled = (rng.random(labels.shape) < 0.3) & arrays["mask0"]
    arrays["labels"] = np.where(unlabeled, 10, labels).astype(np.int32)
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    jbatch = jax_pyramid(a["points0"], a["mask0"], a["features"],
                         a["labels"], jcfg, plan, a["center_pts"],
                         rotations=a["rotations"])
    variables = _as_dicts(jax.device_get(jit_init(
        JaxKPFCNN(jcfg, LABELS, IGNORED), jax.random.PRNGKey(0), jbatch)))
    rng = np.random.default_rng(1)
    _randomize(variables["params"], rng)
    _randomize(variables["batch_stats"], rng)
    return dict(jbatch=jbatch, batch=_port_batch(jbatch),
                variables=variables)


def _port_model(setup, **overrides):
    _, pcfg = configs(**overrides)
    model = KPFCNN(pcfg, LABELS, IGNORED)
    model.load_state_dict(from_jax_variables(setup["variables"]),
                          strict=True)
    return model, pcfg


def _jvars(setup):
    return jax.tree_util.tree_map(jnp.asarray, setup["variables"])


def _keep_mask(setup, seed=9):
    b, n0 = setup["batch"].labels.shape
    return np.random.default_rng(seed).random((b, n0, 8)) < 0.5


def test_fresh_init_names_and_shapes_match_flax(setup):
    carried = from_jax_variables(setup["variables"])
    _, pcfg = configs()
    state = KPFCNN(pcfg, LABELS, IGNORED,
                   generator=torch.Generator().manual_seed(3)).state_dict()
    assert set(state) == set(carried)
    assert {"head_mlp.mlp.weight", "head_mlp.batch_norm.bias",
            "head_softmax.mlp.weight",
            "head_softmax.batch_norm.bias"} <= set(state)
    assert any(k.startswith("decoder_blocks.") and "mlp" in k
               for k in state)
    for key, value in carried.items():
        assert tuple(state[key].shape) == tuple(value.shape), key
        if key.endswith("kernel_points"):
            np.testing.assert_array_equal(state[key].numpy(), value.numpy())


@pytest.mark.parametrize("train,rate", [(False, 0.0), (True, 0.0),
                                        (True, 0.5)])
def test_forward_matches_flax(setup, monkeypatch, train, rate):
    jcfg, _ = configs(dropout=rate)
    keep = _keep_mask(setup)
    if rate:
        monkeypatch.setattr(fnn, "Dropout", InjectedDropout)
        monkeypatch.setattr(InjectedDropout, "KEEP", keep, raising=False)
    want, mutated = JaxKPFCNN(jcfg, LABELS, IGNORED).apply(
        _jvars(setup), setup["jbatch"], train=train,
        mutable=["batch_stats"])
    model, _ = _port_model(setup, dropout=rate)
    model.train(train)
    with torch.no_grad():
        got = model(setup["batch"], dropout_keep=torch.from_numpy(keep))
    mask0 = np.asarray(setup["jbatch"].masks[0])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy()[mask0], np.asarray(want)[mask0],
                               rtol=1e-4, atol=1e-5)
    assert float(np.abs(np.asarray(want)[mask0]).max()) > 0.1
    if train:
        stats = from_jax_variables({"batch_stats": _np_tree(
            mutated["batch_stats"])})
        state = model.state_dict()
        assert len(stats) > 10
        for key, ref in stats.items():
            np.testing.assert_allclose(state[key].numpy(), ref.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=key)


def _loss_inputs(seed=3, n=300, c=9):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(n, c)) * 2.0).astype(np.float32)
    raw = rng.integers(0, 9, size=n)
    raw = np.where(rng.random(n) < 0.4, 10, raw)
    valid = rng.random(n) < 0.9
    raw = np.where(valid, raw, -1)
    labels = np.where(raw >= 0, raw, c + 1).astype(np.int32)
    slc = rng.choice(np.flatnonzero(valid), size=60).astype(np.int32)
    return logits, raw.astype(np.int32), labels, valid, slc


def test_cross_entropy_and_gradient_match_jax():
    logits, raw, _, _, _ = _loss_inputs()
    table = jax_mapper(LABELS, IGNORED)
    targets = np.where(raw >= 0, table[np.clip(raw, 0, None)], -1)
    w = np.asarray(CLASS_W, np.float32)

    def jfn(x):
        return jlosses.softmax_cross_entropy(x, jnp.asarray(targets),
                                             jnp.asarray(w))
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = losses.softmax_cross_entropy(
        x, losses.label_targets(torch.from_numpy(raw),
                                torch.from_numpy(table)),
        torch.from_numpy(w))
    got.backward()
    assert (targets == -1).sum() > 50
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("threshold", [0.2, 0.6])
def test_contrast_loss_and_gradient_match_jax(threshold):
    logits, _, labels, valid, slc = _loss_inputs()

    def jfn(x):
        return jlosses.contrast_loss(x, jnp.asarray(labels),
                                     jnp.asarray(valid), None, 9, threshold,
                                     slc_idx=jnp.asarray(slc))
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = losses.contrast_loss(x, torch.from_numpy(labels),
                               torch.from_numpy(valid), 9, threshold,
                               slc_idx=torch.from_numpy(slc))
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-7)


def test_contrast_draw_follows_the_inverse_cdf():
    rng = np.random.default_rng(4)
    n = 500
    certain = rng.random(n) < 0.3
    valid = certain | (rng.random(n) < 0.5)
    seed = torch.tensor(1234)
    u = prng.uniform(seed.reshape(1), 1000, losses.CONTRAST_STREAM)[0]
    got = losses.contrast_draw(torch.from_numpy(certain),
                               torch.from_numpy(valid), u).numpy()
    # the k-th certain point, k = ceil((1 - u) * certain points): the
    # inverse CDF of jax.random.choice's uniform p on the same uniforms
    k = np.ceil((1.0 - u.numpy()) * np.float32(certain.sum()))
    want = np.flatnonzero(certain)[k.astype(np.int64) - 1]
    np.testing.assert_array_equal(got, want)
    assert certain[got].all() and len(np.unique(got)) > 100
    # nothing certain: drawn among the valid points
    none = np.zeros(n, bool)
    got = losses.contrast_draw(torch.from_numpy(none),
                               torch.from_numpy(valid), u).numpy()
    assert valid[got].all() and len(np.unique(got)) > 100


def test_contrast_loss_falls_back_and_is_zero_without_valid_points():
    logits, _, labels, valid, _ = _loss_inputs()
    seed = torch.tensor(7)
    # every label unlabeled and a threshold above every softmax maximum:
    # no point is certain, the draw falls back to the valid points
    unl = np.full_like(labels, 10)
    x = torch.from_numpy(logits).requires_grad_()
    loss = losses.contrast_loss(x, torch.from_numpy(unl),
                                torch.from_numpy(valid), 9, 1.0, seed=seed)
    loss.backward()
    assert float(loss.detach()) == 0.0 and float(x.grad.abs().sum()) == 0.0
    want = jlosses.contrast_loss(jnp.asarray(logits), jnp.asarray(unl),
                                 jnp.asarray(valid), jax.random.PRNGKey(0),
                                 9, 1.0)
    assert float(want) == 0.0
    # no valid point at all
    none = np.zeros_like(valid)
    loss = losses.contrast_loss(torch.from_numpy(logits),
                                torch.from_numpy(labels),
                                torch.from_numpy(none), 9, 0.2, seed=seed)
    assert float(loss) == 0.0
    # a drawn loss is positive and finite, the same for the same seed
    a, b = (float(losses.contrast_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(valid), 9, 0.2, seed=seed)) for _ in range(2))
    assert a == b and np.isfinite(a) and a > 0


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
def test_dropout_mask_is_flax_bernoulli_of_the_seed(seed):
    shape = (2, 37, 8)
    got = dropout_keep(shape, 0.5, torch.tensor(seed, dtype=torch.int64))
    want = jax.random.bernoulli(jax.random.PRNGKey(seed), 0.5, shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.4 < float(got.float().mean()) < 0.6


def test_pl_step_matches_jax(setup, monkeypatch):
    rate, clip, lr = 0.5, 2e-3, 0.01
    jcfg, _ = configs(dropout=rate, grad_clip_norm=clip)
    keep = _keep_mask(setup)
    monkeypatch.setattr(fnn, "Dropout", InjectedDropout)
    monkeypatch.setattr(InjectedDropout, "KEEP", keep, raising=False)
    jbatch = setup["jbatch"]
    mask_flat = np.asarray(jbatch.masks[0]).reshape(-1)
    slc = np.random.default_rng(2).choice(np.flatnonzero(mask_flat),
                                          size=200).astype(np.int32)
    table = jnp.asarray(jax_mapper(LABELS, IGNORED))
    class_w = jnp.asarray(np.asarray(CLASS_W, np.float32))
    model = JaxKPFCNN(jcfg, LABELS, IGNORED)
    jv = _jvars(setup)
    params = jv["params"]
    tx = make_optimizer(jcfg, params, clip_mode="value")
    opt = tx.init(params)

    # the pseudo branch of step_core (weasal_tpu/train/trainer.py:317-343)
    def loss_fn(p):
        out, mutated = model.apply(
            {"params": p, "constants": jv["constants"],
             "batch_stats": jv["batch_stats"]}, jbatch, train=True,
            mutable=["batch_stats"])
        raw = jbatch.labels
        targets = jnp.where(raw >= 0, table[jnp.clip(raw, 0, None)], -1)
        loss = jlosses.softmax_cross_entropy(out, targets, class_w)
        c = out.shape[-1]
        flat_labels = jnp.where(raw.reshape(-1) >= 0, raw.reshape(-1),
                                jcfg.num_classes + 1)
        loss = loss + jlosses.contrast_loss(
            out.reshape(-1, c), flat_labels, jbatch.masks[0].reshape(-1),
            None, jcfg.num_classes, jcfg.contrast_thd / 100.0,
            slc_idx=jnp.asarray(slc))
        return loss, mutated["batch_stats"]

    (jloss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    updates, new_opt = tx.update(grads, opt, params)
    updates = jax.tree_util.tree_map(lambda u: -lr * u, updates)
    new_params = optax.apply_updates(params, updates)
    gmax = max(float(jnp.abs(g).max()) for g in
               jax.tree_util.tree_leaves(grads))
    assert gmax > 10 * clip          # the clamp acts

    net, pcfg = _port_model(setup, dropout=rate, grad_clip_norm=clip)
    state = init_opt_state(net)
    loss, _acc = step_on_batch(
        net, state, setup["batch"], pcfg, lr, use_contrast=True,
        dropout_keep=torch.from_numpy(keep), slc_idx=torch.from_numpy(slc))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_close({n: p.grad for n, p in net.named_parameters()},
                  from_jax_variables({"params": _np_tree(grads)}),
                  rtol=1e-3, atol_rel=1e-5, global_scale=True)
    _assert_close(net.state_dict(), from_jax_variables(
        {"params": _np_tree(new_params), "batch_stats": _np_tree(new_bs),
         "constants": setup["variables"]["constants"]}),
        rtol=1e-3, atol_rel=1e-5)
    # the momentum holds the clamped gradients (plus the decay), whose
    # error the gradients' atol bounds
    want = from_jax_opt_state(
        jax.tree_util.tree_map(np.asarray, jax.device_get(new_opt)))
    assert set(state) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(state[key].numpy(), ref.numpy(),
                                   rtol=1e-3, atol=1e-5 * gmax, err_msg=key)
