"""Deformable, modulated and closest-aggregation KPConv, the fitting
regularizer and the deform group against the JAX package, on the CPU.

The network is `tests/test_deformable.py`'s `DeformConfig` (a tiny
`KPFCNN_mprm` with three `resnetb_deformable[_strided]` blocks, 2 spheres
of `demo_batch`): the JAX model's `jit_init` weights with every BatchNorm
parameter and statistic, every `gamma` and every `offset_bias` randomized
from numpy, carried across by `from_jax_variables`; both packages run on
the pyramid the JAX package builds. Tolerances, f32:

- the train-mode forward (outputs and updated statistics) and the
  regularizer: rtol 1e-4, atol 1e-5 (valid rows; as
  tests/test_torch_model.py, the summation order differs in every
  product);
- one step (region loss + regularizer, the deform group's update):
  loss and offset loss rtol 1e-5; gradients and momentum rtol 1e-3, atol
  1e-5 x the model's largest |gradient|; parameters and statistics rtol
  1e-3, atol 1e-5 x the tensor's max |value| (tests/test_torch_train.py's
  tolerances for the rigid step);
- `p2p_fitting_regularizer` alone, value and gradients: rtol 1e-5, atol
  1e-7;
- `kpconv_dense` (deformable, modulated, 'closest', rigid 'sum') against
  JAX's `ops.kpconv` on seeded inputs, output and min_sq rtol 1e-5, atol
  1e-6 x max |output|; gradients rtol 1e-4, atol 1e-6 x max |gradient|;
- the deform group's SGD update against `make_optimizer`'s optax chain
  over three updates: rtol 1e-6, atol 1e-7 (as the rigid update's test).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from weasal_tpu.data.demo import demo_batch
from weasal_tpu.models import blocks as jblocks
from weasal_tpu.models import losses as jlosses
from weasal_tpu.models.architectures import KPFCNN_mprm as JaxModel
from weasal_tpu.models.init import jit_init
from weasal_tpu.ops import kpconv as jops
from weasal_tpu.train.trainer import make_optimizer
from weasal_tpu_torch import (KPFCNN_mprm, from_jax_opt_state,
                              from_jax_variables, init_opt_state)
from weasal_tpu_torch.config import Config
from weasal_tpu_torch.models import blocks, losses
from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.train.optim import sgd_step
from weasal_tpu_torch.train.step import step_on_batch
from tests._warm_torch import cpu_torch
from tests.test_deformable import DeformConfig
from tests.test_torch_model import _as_dicts, _randomize
from tests.test_torch_pl_model import _port_batch
from tests.test_torch_train import _assert_close, _np_tree

ATTRS = {k: getattr(DeformConfig, k) for k in (
    "dataset", "num_classes", "in_features_dim", "first_features_dim",
    "in_radius", "first_subsampling_dl", "conv_radius", "deform_radius",
    "architecture", "use_batch_norm", "batch_norm_momentum",
    "deform_fitting_power", "deform_lr_factor", "repulse_extent",
    "learning_rate", "momentum", "weight_decay", "grad_clip_norm")}


# The port's copy of DeformConfig
PortDeformConfig = type("PortDeformConfig", (Config,), dict(
    ATTRS, loss_type="region_mprm_loss", class_w=[]))


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _randomize_offsets(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _randomize_offsets(v, rng)
        elif k == "offset_bias":
            tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jcfg = DeformConfig()
    jbatch, _plan = demo_batch(jcfg, batch_size=2, seed=0, density=6.0)
    jmodel = JaxModel(jcfg, tuple(range(5)), ())
    init = jax.device_get(jit_init(jmodel, jax.random.PRNGKey(0), jbatch))
    variables = _as_dicts({k: init[k] for k in ("params", "batch_stats",
                                                "constants")})
    rng = np.random.default_rng(1)
    _randomize(variables["params"], rng)
    _randomize(variables["batch_stats"], rng)
    _randomize_offsets(variables["params"], rng)
    regions = {k: torch.from_numpy(np.array(getattr(jbatch, k)))
               for k in ("cloud_lb", "region_inds", "region_masks",
                         "region_point_masks", "region_lb")}
    batch = dataclasses.replace(_port_batch(jbatch), **regions)
    return dict(jcfg=jcfg, jbatch=jbatch, jmodel=jmodel,
                variables=variables, batch=batch)


def _port_model(setup):
    model = KPFCNN_mprm(PortDeformConfig(), tuple(range(5)), ())
    model.load_state_dict(from_jax_variables(setup["variables"]),
                          strict=True)
    return model


def _jax_forward(setup, params=None):
    v = jax.tree_util.tree_map(jnp.asarray, setup["variables"])
    if params is not None:
        v = dict(v, params=params)
    return jax.jit(lambda v, b: setup["jmodel"].apply(
        v, b, train=True, mutable=["batch_stats", "deform"]))(
        v, setup["jbatch"])


def test_deformable_blocks_carry_offset_convs(setup):
    model = _port_model(setup)
    convs = blocks.kpconv_modules(model)
    deformable = [n for n, m in convs if m.params.deformable]
    assert deformable == ["encoder_blocks.3.KPConv",
                          "encoder_blocks.4.KPConv",
                          "encoder_blocks.5.KPConv"]
    for name in deformable:
        conv = dict(convs)[name]
        assert tuple(conv.offset_conv.weights.shape[1:]) == (
            conv.weights.shape[1], 3 * 15)
        assert not conv.offset_conv.params.deformable
    # the offset convs' poses are the JAX package's (pose_seed + 1)
    fresh = KPFCNN_mprm(PortDeformConfig(), tuple(range(5)), ())
    carried = from_jax_variables(setup["variables"])
    for key in carried:
        if key.endswith("kernel_points"):
            assert torch.equal(fresh.state_dict()[key], carried[key]), key


def test_deformable_forward_matches_jax(setup):
    (logits_j, cla_j, cam_j), mutated = _jax_forward(setup)
    model = _port_model(setup)
    model.train()
    with torch.no_grad():
        logits, cla, cam = model(setup["batch"])
        terms = blocks.deform_terms(model)
    mask0 = np.asarray(setup["jbatch"].masks[0])
    np.testing.assert_allclose(logits.numpy()[mask0],
                               np.asarray(logits_j)[mask0],
                               rtol=1e-4, atol=1e-5)
    for got, ref in zip(cla, cla_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)
    for got, ref in zip(cam, cam_j):
        np.testing.assert_allclose(got.numpy()[mask0], np.asarray(ref)[mask0],
                                   rtol=1e-4, atol=1e-5)
    stats = from_jax_variables(
        {"batch_stats": _np_tree(mutated["batch_stats"])})
    state = model.state_dict()
    for key, ref in stats.items():
        np.testing.assert_allclose(state[key].numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert len(terms) == 3 and blocks.deform_terms(model) == []
    reg = losses.p2p_fitting_regularizer(terms, 1.2, 1.0)
    jreg = jlosses.p2p_fitting_regularizer(mutated["deform"], 1.2, 1.0)
    assert float(reg) > 0
    np.testing.assert_allclose(float(reg), float(jreg), rtol=1e-4)


def test_deformable_training_step_matches_jax(setup):
    jcfg, jbatch = setup["jcfg"], setup["jbatch"]
    lr = jcfg.learning_rate
    v = jax.tree_util.tree_map(jnp.asarray, setup["variables"])
    params = v["params"]
    tx = make_optimizer(jcfg, params)
    opt = tx.init(params)

    # the weak branch of step_core with the regularizer
    # (weasal_tpu/train/trainer.py:304-309, 343)
    def loss_fn(p):
        (_logits, _cla, cam), mutated = setup["jmodel"].apply(
            dict(v, params=p), jbatch, train=True,
            mutable=["batch_stats", "deform"])
        out_loss = jlosses.region_mprm_loss(
            cam, jbatch.region_inds, jbatch.region_masks,
            jbatch.region_point_masks, jbatch.region_lb)
        reg = jlosses.p2p_fitting_regularizer(
            mutated["deform"], jcfg.repulse_extent,
            jcfg.deform_fitting_power)
        return out_loss + reg, (mutated["batch_stats"], out_loss, reg)

    grads, (new_bs, jloss, jreg) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params)
    updates, new_opt = tx.update(grads, opt, params)
    updates = jax.tree_util.tree_map(lambda u: -lr * u, updates)
    new_params = optax.apply_updates(params, updates)
    gmax = max(float(jnp.abs(g).max())
               for g in jax.tree_util.tree_leaves(grads))

    net = _port_model(setup)
    state = init_opt_state(net)
    cfg = PortDeformConfig()
    loss, _acc, reg = step_on_batch(net, state, setup["batch"], cfg, lr,
                                    with_offset_loss=True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(reg), float(jreg), rtol=1e-5)
    assert float(reg) > 0
    port_grads = {n: p.grad for n, p in net.named_parameters()}
    want_grads = from_jax_variables({"params": _np_tree(grads)})
    _assert_close(port_grads, want_grads, rtol=1e-3, atol_rel=1e-5,
                  global_scale=True)
    offset_grads = [k for k, g in port_grads.items()
                    if "offset" in k and float(g.abs().max()) > 0]
    assert len(offset_grads) == 6
    _assert_close(net.state_dict(), from_jax_variables(
        {"params": _np_tree(new_params), "batch_stats": _np_tree(new_bs),
         "constants": setup["variables"]["constants"]}),
        rtol=1e-3, atol_rel=1e-5)
    want = from_jax_opt_state(_np_tree(new_opt))
    assert set(state) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(state[key].numpy(), ref.numpy(),
                                   rtol=1e-3, atol=1e-5 * gmax, err_msg=key)


def test_p2p_regularizer_and_its_gradient_match_jax():
    rng = np.random.default_rng(7)
    terms_np = []
    for n in (30, 17):
        min_sq = rng.uniform(0, 2, (2, n, 15)).astype(np.float32)
        kp = rng.normal(0, 0.8, (2, n, 15, 3)).astype(np.float32)
        valid = (rng.random((2, n)) < 0.8).astype(np.float32)
        terms_np.append((min_sq, kp, valid))

    def jax_reg(pairs):
        aux = {f"conv{i}": {"min_sq": (m,), "deformed_kp": (k,),
                            "q_valid": (jnp.asarray(q),)}
               for i, ((m, k), (_, _, q)) in enumerate(zip(pairs, terms_np))}
        return jlosses.p2p_fitting_regularizer(aux, 1.2, 0.7)

    jpairs = [(jnp.asarray(m), jnp.asarray(k)) for m, k, _ in terms_np]
    want, jgrads = jax.value_and_grad(jax_reg)(jpairs)
    tpairs = [(torch.from_numpy(m).requires_grad_(),
               torch.from_numpy(k).requires_grad_()) for m, k, _ in terms_np]
    got = losses.p2p_fitting_regularizer(
        [(m, k, torch.from_numpy(q)) for (m, k), (_, _, q)
         in zip(tpairs, terms_np)], 1.2, 0.7)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for (m, k), (jm, jk) in zip(tpairs, jgrads):
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(jm),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(k.grad.numpy(), np.asarray(jk),
                                   rtol=1e-5, atol=1e-7)
    assert losses.p2p_fitting_regularizer([], 1.2, 0.7) == 0.0


CONV_CASES = {
    "deformable": dict(deformable=True),
    "deformable modulated": dict(deformable=True, modulated=True),
    "deformable closest": dict(deformable=True, aggregation="closest"),
    "rigid closest": dict(aggregation="closest"),
    "rigid sum, gaussian": dict(influence="gaussian"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_dense_kpconv_matches_jax_ops(case):
    """`kpconv_dense` against weasal_tpu.ops.kpconv (its XLA path):
    output, min_sq and the gradients of x, the weights, the offsets and
    the modulations, on seeded spheres with shadow neighbors."""
    kw = CONV_CASES[case]
    rng = np.random.default_rng(sorted(CONV_CASES).index(case))
    b, nq, ns, k, kp, cin, cout, extent = 2, 40, 50, 12, 15, 6, 5, 1.2
    q = rng.uniform(-3, 3, (b, nq, 3)).astype(np.float32)
    s = rng.uniform(-3, 3, (b, ns, 3)).astype(np.float32)
    inds = rng.integers(0, ns + 1, (b, nq, k)).astype(np.int32)
    inds[:, -3:] = ns                       # all-shadow query rows
    x = rng.normal(size=(b, ns, cin)).astype(np.float32)
    kpts = rng.uniform(-1, 1, (kp, 3)).astype(np.float32)
    w = rng.normal(size=(kp, cin, cout)).astype(np.float32)
    offsets = rng.normal(0, 0.5, (b, nq, kp, 3)).astype(np.float32)
    mods = rng.uniform(0.1, 1.9, (b, nq, kp)).astype(np.float32)
    jparams = jops.KPConvParams(kp_extent=extent, **kw)
    deformable = kw.get("deformable", False)
    modulated = kw.get("modulated", False)

    def jax_fn(x, w, off, mod):
        out, min_sq = jops.kpconv(
            jnp.asarray(q), jnp.asarray(s), jnp.asarray(inds), x,
            jnp.asarray(kpts), w, jparams,
            offsets=off if deformable else None,
            modulations=mod if modulated else None)
        reg = 0.0 if min_sq is None else jnp.sum(min_sq * 0.01)
        return jnp.sum(out * out) + reg, (out, min_sq)

    (_, (jout, jmin)), jgrads = jax.value_and_grad(
        jax_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(offsets),
        jnp.asarray(mods))
    tx, tw, toff, tmod = (torch.from_numpy(a).requires_grad_()
                          for a in (x, w, offsets, mods))
    params = ops.KPConvParams(kp_extent=extent, **kw)
    out, min_sq = ops.kpconv_dense(
        torch.from_numpy(q), torch.from_numpy(s), torch.from_numpy(inds), tx,
        torch.from_numpy(kpts), tw, params,
        offsets=toff if deformable else None,
        modulations=tmod if modulated else None)
    loss = (out * out).sum() + (0.0 if min_sq is None
                                else (min_sq * 0.01).sum())
    loss.backward()
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6 * scale)
    assert (min_sq is None) == (jmin is None)
    if min_sq is not None:
        np.testing.assert_allclose(min_sq.detach().numpy(), np.asarray(jmin),
                                   rtol=1e-5, atol=1e-6)
    used = [(tx, 0), (tw, 1)] + ([(toff, 2)] if deformable else []) + (
        [(tmod, 3)] if modulated else [])
    for t, i in used:
        ref = np.asarray(jgrads[i])
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(ref).max()))
    if not deformable and kw.get("aggregation", "sum") == "sum":
        # the rigid sum conv through kernel B's plain version agrees
        with torch.no_grad():
            via_kernel = ops.kpconv(
                torch.from_numpy(q), torch.from_numpy(s),
                torch.from_numpy(inds), tx, torch.from_numpy(kpts), tw,
                params)
        np.testing.assert_allclose(via_kernel.numpy(),
                                   out.detach().numpy(), rtol=1e-5,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("base,alias", [
    ("simple", "simple_invariant"), ("simple", "simple_equivariant"),
    ("simple_strided", "simple_invariant_strided"),
    ("simple_strided", "simple_equivariant_strided"),
    ("resnetb", "resnetb_invariant"), ("resnetb", "resnetb_equivariant"),
    ("resnetb_strided", "resnetb_invariant_strided"),
    ("resnetb_strided", "resnetb_equivariant_strided"),
    ("simple", "simple_deformable"),
    ("simple_strided", "simple_deformable_strided"),
    ("resnetb", "resnetb_deformable"),
    ("resnetb_strided", "resnetb_deformable_strided")])
def test_block_decider_aliases_build_the_plain_blocks(base, alias):
    """An alias builds the module class the JAX decider picks for it
    (the base name's), with the base name's parameters, plus the offset
    conv and bias of a deformable name."""
    cfg = PortDeformConfig()
    gen = torch.Generator().manual_seed(0)

    def build(name):
        return blocks.block_decider(name, 1.25, 18, 36, 1, cfg, ("b",), gen)

    got, want = build(alias), build(base)
    jmod = jblocks.block_decider(alias, 1.25, 18, 36, 1, DeformConfig())
    assert type(got) is type(want)
    assert type(got).__name__ == type(jmod).__name__
    keys = set(got.state_dict())
    extra = {k for k in keys if "offset" in k}
    assert keys - extra == set(want.state_dict())
    if "deformable" in alias:
        assert extra == {"KPConv.offset_bias", "KPConv.offset_conv.weights",
                         "KPConv.offset_conv.kernel_points"}
    else:
        assert not extra


def test_deform_group_update_matches_optax():
    """The deform group: parameters whose name holds "offset" take
    deform_lr_factor times the shared momentum trace, as
    make_optimizer's masked optax.scale does; three updates with the
    global norm above and below the clip."""
    rng = np.random.default_rng(9)
    cfg = PortDeformConfig()
    names = ("weights", "offset_bias", "offset_conv")
    params = {n: rng.normal(size=(4, 3)).astype(np.float32) for n in names}
    grads = [{n: (s * rng.normal(size=(4, 3))).astype(np.float32)
              for n in names} for s in (3.0, 0.8, 0.01)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = make_optimizer(DeformConfig(), jp)
    opt = tx.init(jp)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for n in names:
                setattr(self, n, torch.nn.Parameter(
                    torch.from_numpy(params[n].copy())))

    net = Net()
    state = init_opt_state(net)
    for g in grads:
        updates, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 opt, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(
            lambda u: -cfg.learning_rate * u, updates))
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(g[n])
        sgd_step(net, state, cfg, cfg.learning_rate)
        for n, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[n]), rtol=1e-6,
                                       atol=1e-7, err_msg=n)
        trace = from_jax_opt_state(_np_tree(opt))
        for n in names:
            np.testing.assert_allclose(state[n].numpy(), trace[n].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
    moved = {n: np.abs(net.state_dict()[n].numpy() - params[n]).max()
             for n in names}
    assert moved["offset_bias"] < 0.5 * moved["weights"]
