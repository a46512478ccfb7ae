"""The port's weak-label training step against the JAX package.

The JAX reference is composed from the JAX package's own pieces, as
weasal_tpu/train/trainer.py:257-365 composes its step: the device
pyramid, `model.apply(train=True, mutable=[...])`, `region_mprm_loss`,
`jax.grad`, `make_optimizer` and the -lr update. Weights come from the
`__graft_entry__.entry()` model at tiny width with every BatchNorm
statistic and attention gamma randomized (as in test_torch_model.py), and
are carried across by `from_jax_variables`. Inputs are made from numpy
seeds and handed to both packages.

Tolerances, f32:
- BatchNorm in training mode (outputs and running statistics), the losses
  and the accuracy: rtol 1e-5, atol 1e-6 (summation order only);
- the optimizer over 3 updates: rtol 1e-6, atol 1e-7 (elementwise ops in
  the same order; the global norm sums in another order);
- the whole step, each package building its own pyramid: loss rtol 1e-5;
  gradients rtol 1e-3, atol 1e-5 x the largest |gradient| of the model
  (the elevation attention's saturated softmax gives gradients of 1e-13 to
  1e-4 whose f32 rounding error follows the size of the terms that cancel,
  not their own: an f64 run of the port puts both packages 1e-6 from the
  truth there), and the same for the momentum buffers, which sum
  gradients; parameters and BatchNorm running statistics after 1 and
  after 3 steps rtol 1e-3, atol 1e-5 x that tensor's max |value|.
"""

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from torch import nn

import __graft_entry__ as graft
from weasal_tpu.data.demo import demo_batch, demo_sphere, thin_payload
from weasal_tpu.data.level0 import assemble_level0
from weasal_tpu.models import losses as jlosses
from weasal_tpu.models.architectures import KPFCNN_mprm as JaxModel
from weasal_tpu.models.architectures import valid_label_mapper as jax_mapper
from weasal_tpu.models.blocks import MaskedBatchNorm as JaxBatchNorm
from weasal_tpu.ops.pyramid import batch_from_device_pyramid as jax_pyramid
from weasal_tpu.train.trainer import make_optimizer
from weasal_tpu_torch import (KPFCNN_mprm, from_jax_opt_state,
                              from_jax_variables, init_opt_state,
                              train_step)
from weasal_tpu_torch.data import demo as port_demo
from weasal_tpu_torch.data import level0 as port_level0
from weasal_tpu_torch.data.batching import calibrate_shape_plan
from weasal_tpu_torch.infer import to_device
from weasal_tpu_torch.models import losses
from weasal_tpu_torch.models.blocks import MaskedBatchNorm
from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
from weasal_tpu_torch.train.optim import sgd_step
from weasal_tpu_torch.train.step import (class_weights, label_table,
                                         step_body, step_outputs)
from tests._warm_torch import cpu_torch
from tests.test_torch_model import TinyConfig, _as_dicts, _randomize


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------- BatchNorm

class _TwiceBN(fnn.Module):
    """One flax BatchNorm applied to two inputs in one step."""
    momentum: float

    @fnn.compact
    def __call__(self, x1, x2, mask):
        bn = JaxBatchNorm(True, self.momentum, name="bn")
        return bn(x1, mask, True), bn(x2, mask, True)


@pytest.mark.parametrize("masked", [True, False])
def test_batch_norm_train_mode_matches_flax(masked):
    rng = np.random.default_rng(0)
    x1 = rng.normal(1.0, 2.0, (2, 30, 6)).astype(np.float32)
    x2 = rng.normal(-0.5, 0.5, (2, 30, 6)).astype(np.float32)
    mask = (rng.random((2, 30)) > 0.3) if masked else None
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.2, 6).astype(np.float32)
    mean = rng.normal(0, 0.2, 6).astype(np.float32)
    var = rng.uniform(0.3, 2.0, 6).astype(np.float32)
    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean, "var": var}}}
    jmask = None if mask is None else jnp.asarray(mask)
    (w1, w2), mutated = _TwiceBN(0.02).apply(
        variables, jnp.asarray(x1), jnp.asarray(x2), jmask,
        mutable=["batch_stats"])

    bn = MaskedBatchNorm(6, True, 0.02)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in
                        dict(scale=scale, bias=bias, mean=mean,
                             var=var).items()})
    bn.train()
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        g1 = bn(torch.from_numpy(x1), tmask)
        g2 = bn(torch.from_numpy(x2), tmask)
    for got, want in ((g1, w1), (g2, w2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(stats["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(stats["var"]),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(bn.var.numpy(), var)


# ------------------------------------------------------------------- losses

def _loss_inputs(seed=3, b=2, n0=40, r=5, p=7, c=9):
    rng = np.random.default_rng(seed)
    cam = [rng.normal(0, 2, (b, n0, c)).astype(np.float32) for _ in range(4)]
    region_inds = rng.integers(0, n0 + 1, (b, r, p)).astype(np.int32)
    region_point_masks = (region_inds < n0) & (rng.random((b, r, p)) > 0.2)
    region_masks = rng.random((b, r)) > 0.3
    region_lb = (rng.random((b, r, c)) > 0.6).astype(np.float32)
    cloud_lb = (rng.random((b, c)) > 0.5).astype(np.float32)
    class_w = rng.uniform(0.5, 2.0, c).astype(np.float32)
    labels = rng.integers(-1, c, (b, n0)).astype(np.int32)
    mask0 = rng.random((b, n0)) > 0.2
    return dict(cam=cam, region_inds=region_inds,
                region_point_masks=region_point_masks,
                region_masks=region_masks, region_lb=region_lb,
                cloud_lb=cloud_lb, class_w=class_w, labels=labels,
                mask0=mask0)


def _loss_pair(name, d):
    """(port function, JAX function) of the differentiable input `cam`."""
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
         for k, v in d.items()}
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in d.items()}
    if name == "bce_with_logits":
        return (lambda cam: losses.bce_with_logits(
                    cam[0][:, :5], t["region_lb"], t["class_w"],
                    mask=t["region_masks"]),
                lambda cam: jlosses.bce_with_logits(
                    cam[0][:, :5], j["region_lb"], j["class_w"],
                    mask=j["region_masks"]))
    if name == "class_logits_loss":
        return (lambda cam: losses.class_logits_loss(
                    [x.mean(1) for x in cam], t["cloud_lb"], t["class_w"]),
                lambda cam: jlosses.class_logits_loss(
                    [x.mean(1) for x in cam], j["cloud_lb"], j["class_w"]))
    keys = ("region_inds", "region_masks", "region_point_masks",
            "region_lb")
    return (lambda cam: losses.region_mprm_loss(
                cam, *[t[k] for k in keys], t["class_w"]),
            lambda cam: jlosses.region_mprm_loss(
                cam, *[j[k] for k in keys], j["class_w"]))


@pytest.mark.parametrize("name", ["bce_with_logits", "class_logits_loss",
                                  "region_mprm_loss"])
def test_losses_and_their_gradients_match_jax(name):
    d = _loss_inputs()
    port_fn, jax_fn = _loss_pair(name, d)
    cam_t = [torch.from_numpy(c).requires_grad_() for c in d["cam"]]
    loss = port_fn(cam_t)
    grads = torch.autograd.grad(loss, cam_t, allow_unused=True)
    want, jgrads = jax.value_and_grad(jax_fn)([jnp.asarray(c)
                                               for c in d["cam"]])
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5,
                               atol=1e-6)
    for got, ref in zip(grads, jgrads):
        got = np.zeros(ref.shape, np.float32) if got is None else got.numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_accuracy_and_label_mapper_match_jax():
    d = _loss_inputs()
    lbl_values, ign = (0, 1, 2, 3, 4, 5, 6, 7, 8, 10), (10,)
    table = losses.valid_label_mapper(lbl_values, ign)
    np.testing.assert_array_equal(table, jax_mapper(lbl_values, ign))
    targets = losses.label_targets(torch.from_numpy(d["labels"]),
                                   torch.from_numpy(table))
    jt = jnp.where(d["labels"] >= 0,
                   jnp.asarray(table)[np.clip(d["labels"], 0, None)], -1)
    np.testing.assert_array_equal(targets.numpy(), np.asarray(jt))
    got = losses.accuracy(torch.from_numpy(d["cam"][0]), targets,
                          torch.from_numpy(d["mask0"]))
    want = jlosses.accuracy(jnp.asarray(d["cam"][0]), jt,
                            jnp.asarray(d["mask0"]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------- optimizer

class _TwoParams(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))


def test_sgd_matches_make_optimizer_over_three_updates():
    rng = np.random.default_rng(4)
    cfg = TinyConfig()
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    # global norms well above, above and below grad_clip_norm = 1
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.8, 0.01)]
    tx = make_optimizer(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jp)
    model = _TwoParams(params["a"], params["b"])
    state = init_opt_state(model)
    norms = []
    for g in grads:
        norms.append(float(optax.global_norm(g)))
        updates, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 opt, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(
            lambda u: -cfg.learning_rate * u, updates))
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name])
        sgd_step(model, state, cfg, cfg.learning_rate)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[name]),
                                       rtol=1e-6, atol=1e-7)
        trace = from_jax_opt_state(_np_tree(opt))
        for name in state:
            np.testing.assert_allclose(state[name].numpy(),
                                       trace[name].numpy(),
                                       rtol=1e-6, atol=1e-7)
    assert norms[0] > 1.0 > norms[2]


def test_sgd_with_a_tensor_lr_matches_optax_across_an_lr_change():
    """The learning rate as a 0-d tensor (what a captured step reads),
    changed in place between updates as the trainer's per-epoch decay
    does, against make_optimizer and optax's -lr * u, p + u with the
    same f32 learning rates: parameters and momentum to rtol 1e-6, atol
    1e-7, as the float-lr test above."""
    rng = np.random.default_rng(6)
    cfg = TinyConfig()
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.8, 0.01)]
    rates = [cfg.learning_rate, cfg.learning_rate,
             cfg.learning_rate * 0.98]
    tx = make_optimizer(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jp)
    model = _TwoParams(params["a"], params["b"])
    state = init_opt_state(model)
    lr_t = torch.full((), rates[0], dtype=torch.float32)
    for g, lr in zip(grads, rates):
        updates, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 opt, jp)
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(
            lambda u: -jnp.float32(lr) * u, updates))
        lr_t.fill_(lr)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name])
        sgd_step(model, state, cfg, lr_t)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[name]),
                                       rtol=1e-6, atol=1e-7)
        trace = from_jax_opt_state(_np_tree(opt))
        for name in state:
            np.testing.assert_allclose(state[name].numpy(),
                                       trace[name].numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_sgd_refuses_deformable_offsets_and_foreign_state():
    class Offsets(nn.Module):
        def __init__(self):
            super().__init__()
            self.offset_mlp = nn.Parameter(torch.zeros(3))
    with pytest.raises(NotImplementedError):
        init_opt_state(Offsets())
    model = _TwoParams(np.zeros((2, 2), np.float32),
                       np.zeros(2, np.float32))
    with pytest.raises(ValueError):
        sgd_step(model, {"a": torch.zeros(2, 2)}, TinyConfig(), 0.01)


# ----------------------------------------------------------- the whole step

def _jax_step_fn(jcfg, plan, constants, lr, tx):
    model = JaxModel(jcfg, tuple(range(9)), ())

    @jax.jit
    def step(params, batch_stats, opt_state, a):
        batch = jax_pyramid(
            a["points0"], a["mask0"], a["features"], a["labels"], jcfg,
            plan, a["center_pts"], rotations=a["rotations"],
            cloud_lb=a["cloud_lb"], region_inds=a["region_inds"],
            region_masks=a["region_masks"],
            region_point_masks=a["region_point_masks"],
            region_lb=a["region_lb"])

        def loss_fn(p):
            out, mutated = model.apply(
                {"params": p, "constants": constants,
                 "batch_stats": batch_stats}, batch, train=True,
                mutable=["batch_stats", "deform", "telemetry"])
            logits, _cla_logits, cam = out
            loss = jlosses.region_mprm_loss(
                cam, batch.region_inds, batch.region_masks,
                batch.region_point_masks, batch.region_lb, None)
            targets = jnp.where(batch.labels >= 0, batch.labels, -1)
            acc = jlosses.accuracy(logits, targets, batch.masks[0])
            return loss, (mutated["batch_stats"], acc)

        grads, (new_bs, acc) = jax.grad(loss_fn, has_aux=True)(params)
        loss = loss_fn(params)[0]
        updates, new_opt = tx.update(grads, opt_state, params)
        updates = jax.tree_util.tree_map(lambda u: -lr * u, updates)
        return (optax.apply_updates(params, updates), new_bs, new_opt,
                loss, acc, grads)

    return step


@pytest.fixture(scope="module")
def three_steps():
    """Three steps in both packages from one randomized state, on three
    level-0 batches; returns what each package saw after steps 1 and 3."""
    _forward, (variables, arrays0) = graft.entry()
    jcfg = graft._tiny_config()
    _, plan = demo_batch(jcfg, batch_size=2, seed=0, density=8.0)
    variables = _as_dicts(variables)
    rng = np.random.default_rng(1)
    _randomize(variables["params"], rng)
    _randomize(variables["batch_stats"], rng)
    rng = np.random.default_rng(5)
    batches = [arrays0] + [assemble_level0(
        [thin_payload(demo_sphere(rng, jcfg, density=8.0),
                      plan.num_points[0], rng) for _ in range(2)],
        plan, jcfg.num_classes, rng) for _ in range(2)]
    lr = jcfg.learning_rate

    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    params, bstats = jv["params"], jv["batch_stats"]
    tx = make_optimizer(jcfg, params)
    opt = tx.init(params)
    jstep = _jax_step_fn(jcfg, plan, jv["constants"], lr, tx)

    cfg = TinyConfig()
    model = KPFCNN_mprm(cfg, tuple(range(9)), ())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    state = init_opt_state(model)

    seen = []
    for arrays in batches:
        params, bstats, opt, jloss, jacc, jgrads = jstep(params, bstats,
                                                         opt, arrays)
        loss, acc, drops = train_step(model, state, arrays, cfg, plan, lr,
                                      device="cpu")
        seen.append(dict(
            loss=(float(loss), float(jloss)), acc=(float(acc), float(jacc)),
            drops=drops.numpy(),
            grads=({n: p.grad.clone() for n, p in model.named_parameters()},
                   from_jax_variables({"params": _np_tree(jgrads)})),
            state=({k: v.clone() for k, v in model.state_dict().items()},
                   from_jax_variables({"params": _np_tree(params),
                                       "batch_stats": _np_tree(bstats),
                                       "constants": variables["constants"]})),
            trace=({k: v.clone() for k, v in state.items()},
                   from_jax_opt_state(_np_tree(opt)))))
    return seen


def _assert_close(got, want, rtol, atol_rel, global_scale=False) -> float:
    """Assert per tensor; returns the smallest rtol that would pass with
    this atol (0 when every element is within atol)."""
    assert set(got) == set(want)
    scale = max(float(v.abs().max()) for v in want.values())
    needed = 0.0
    for key, ref in want.items():
        s = scale if global_scale else float(ref.abs().max())
        a, r = got[key].detach().numpy(), ref.numpy()
        np.testing.assert_allclose(a, r, rtol=rtol, atol=atol_rel * s,
                                   err_msg=key)
        excess = np.abs(a - r).astype(np.float64) - atol_rel * s
        over = excess > 0
        if over.any():
            needed = max(needed, float((excess[over] / np.abs(r[over])).max()))
    return needed


@pytest.mark.parametrize("step", [1, 3])
def test_train_step_matches_jax(three_steps, step, record_property):
    seen = three_steps[step - 1]
    np.testing.assert_allclose(*seen["loss"], rtol=1e-5)
    np.testing.assert_allclose(*seen["acc"], rtol=1e-6)
    assert seen["drops"].shape == (5 + 7,) and not seen["drops"].any()
    record_property("loss_rel_err", abs(seen["loss"][0] / seen["loss"][1]
                                        - 1.0))
    for part, global_scale in (("grads", True), ("state", False),
                               ("trace", True)):
        record_property(f"{part}_rtol_needed", _assert_close(
            *seen[part], rtol=1e-3, atol_rel=1e-5,
            global_scale=global_scale))


def test_train_step_moves_params_and_statistics(three_steps):
    first, last = three_steps[0]["state"][0], three_steps[2]["state"][0]
    changed = [k for k in first if not torch.equal(first[k], last[k])]
    assert any(k.endswith(".var") for k in changed)
    assert any(k.endswith("KPConv.weights") for k in changed)
    assert not any(k.endswith("kernel_points") for k in changed)
    assert all(np.isfinite(v.numpy()).all() for v in last.values())


def test_static_step_body_equals_train_step_bit_for_bit():
    """`step_body` on preallocated outputs (what the trainer runs eagerly
    or captures) against `train_step` from one state on one batch, on
    the CPU: loss, accuracy, drops, parameters, statistics and momentum
    bit for bit, with the learning rate as a tensor in one and a float in
    the other."""
    cfg = TinyConfig()
    rng = np.random.default_rng(8)
    plan = calibrate_shape_plan(
        [port_demo.demo_sphere(rng, cfg, density=8.0)["points"]
         for _ in range(3)], cfg, region_budget=(8, 64), rng=rng)
    arrays = port_level0.assemble_level0(
        [port_demo.thin_payload(port_demo.demo_sphere(rng, cfg, density=8.0),
                                plan.num_points[0], rng) for _ in range(2)],
        plan, cfg.num_classes, rng)
    runs = []
    for static in (False, True):
        model = KPFCNN_mprm(cfg, tuple(range(9)), (),
                            generator=torch.Generator().manual_seed(4))
        state = init_opt_state(model)
        if static:
            out = step_outputs(plan, "cpu", steps=2)
            row = {k: v[1] for k, v in out.items()}
            step_body(model, state, to_device(arrays, "cpu"), cfg, plan,
                      torch.full((), cfg.learning_rate), row,
                      class_weights(cfg, "cpu"), label_table(model, "cpu"))
            loss, acc, drops = row["stats"][0], row["stats"][1], row["drops"]
            assert not out["stats"][0].any()          # row 0 untouched
        else:
            loss, acc, drops = train_step(model, state, arrays, cfg, plan,
                                          cfg.learning_rate, device="cpu")
        runs.append((loss.clone(), acc.clone(), drops.clone(),
                     {k: v.clone() for k, v in model.state_dict().items()},
                     {k: v.clone() for k, v in state.items()}))
    (la, aa, da, sa, ta), (lb, ab, db, sb, tb) = runs
    assert torch.equal(la, lb) and torch.equal(aa, ab)
    assert torch.equal(da, db) and not da.any()
    for key in sa:
        assert torch.equal(sa[key], sb[key]), key
    for key in ta:
        assert torch.equal(ta[key], tb[key]), key


def test_train_step_takes_the_class_logits_loss_by_config():
    class ClassLogits(TinyConfig):
        loss_type = "class_logits_loss"

    cfg = ClassLogits()
    rng = np.random.default_rng(7)
    plan = calibrate_shape_plan(
        [port_demo.demo_sphere(rng, cfg, density=8.0)["points"]
         for _ in range(3)], cfg, region_budget=(8, 64), rng=rng)
    arrays = port_level0.assemble_level0(
        [port_demo.thin_payload(port_demo.demo_sphere(rng, cfg, density=8.0),
                                plan.num_points[0], rng) for _ in range(2)],
        plan, cfg.num_classes, rng)
    model = KPFCNN_mprm(cfg, tuple(range(9)), (),
                        generator=torch.Generator().manual_seed(2))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loss, acc, _ = train_step(model, init_opt_state(model), arrays, cfg,
                              plan, cfg.learning_rate, device="cpu")
    model.load_state_dict(before)
    model.train()
    t = to_device(arrays, "cpu")
    batch = batch_from_device_pyramid(
        t["points0"], t["mask0"], t["features"], t["labels"], cfg, plan,
        t["center_pts"], rotations=t["rotations"], cloud_lb=t["cloud_lb"])
    with torch.no_grad():
        _, cla_logits, _ = model(batch)
    want = losses.class_logits_loss(cla_logits, batch.cloud_lb,
                                     torch.ones(9))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)
    assert 0.0 <= float(acc) <= 1.0

    class Unknown(TinyConfig):
        loss_type = "softmax_cross_entropy"
    with pytest.raises(ValueError):
        train_step(model, init_opt_state(model), arrays, Unknown(), plan,
                   0.01, device="cpu")
