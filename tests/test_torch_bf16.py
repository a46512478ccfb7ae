"""compute_dtype "bfloat16" in the port against the JAX package's XLA path.

The JAX package's Pallas kernel ignores compute_dtype (it runs only on a
TPU; in interpret mode it computes in f32), so its XLA path, which every
CPU and GPU run and every deformable or 'closest' conv takes, is the
reference. Its casts (weasal_tpu/ops/kpconv.py:206-233) and their
transposes under `jax.grad` put bf16 rounding at these points, read off
its jaxpr here so that a change of JAX cannot move them silently:
forward bf(h), bf(x_k), bf(y), bf(W); backward bf(dr) = bf(g @ bf(W)^T),
bf(dW), bf(each slot's gradient), and g is not rounded.

- One rigid conv: the port's plain versions (kpconv_fwd_plain_with_y,
  kpconv_bwd_plain) against `ops.kpconv`, forward and VJP. Each support
  is one neighbor slot of one query, so dX holds the slots' rounded
  gradients themselves; with W the identity, the output is y. The bf16
  results (y, dW, the slots' gradients) by the flip criterion of
  tests/_bf16_cases.py (equal but for one-ulp flips in at most 1e-3 of
  the elements); the f32 output within relative L2 1e-4.
- One deformable modulated conv: `kpconv_dense` under autograd against
  `ops.kpconv` with offsets and modulations: the same criteria for out,
  dW and dX, relative L2 1e-4 for the offsets' and modulations'
  gradients.
- One weak-label step (tiny KPFCNN_mprm, 2 spheres) and one
  pseudo-label step (tiny KPFCNN, cross-entropy and contrast loss) from
  one randomized state against the JAX step: loss rtol 1e-3; every
  parameter and BatchNorm statistic after the update within relative L2
  1e-2 of JAX's, a tensor's norm floored at 1e-3 of the largest. The PL
  step's gradients likewise. The WL step's gradients are held to JAX's
  own spread: the same JAX step with the two spheres swapped (the same
  arithmetic in another f32 sum order) moves them by 5.5 % (relative L2
  over all of them; 6.6e-6 in f32), because each bf16 rounding in the
  backward turns a difference at f32 rounding into one at bf16 rounding
  wherever it crosses a boundary, layer after layer, and this randomized
  attention network amplifies that. The port's distance to JAX must stay
  within twice that spread (measured 5.4 % against 5.5 %). Eval
  probabilities within atol 1e-3.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import __graft_entry__ as graft
from weasal_tpu.data.demo import demo_batch
from weasal_tpu.models import losses as jlosses
from weasal_tpu.models.architectures import KPFCNN as JaxKPFCNN
from weasal_tpu.models.architectures import KPFCNN_mprm as JaxModel
from weasal_tpu.models.architectures import valid_label_mapper as jax_mapper
from weasal_tpu.ops.kpconv import KPConvParams as JaxParams
from weasal_tpu.ops.kpconv import kpconv as jax_kpconv
from weasal_tpu.train.trainer import make_optimizer
from weasal_tpu_torch import (KPFCNN, KPFCNN_mprm, from_jax_variables,
                              init_opt_state, train_step)
from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd_plain
from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd_plain_with_y
from weasal_tpu_torch.train.step import step_on_batch
from tests._bf16_cases import (OUT_REL_L2_MAX, flips, flips_ok,
                               is_bf16_valued, rel_l2)
from tests._warm_torch import cpu_torch
from tests.test_torch_model import TinyConfig, _as_dicts, _randomize
from tests.test_torch_pl_model import (CLASS_W, IGNORED, LABELS, _port_batch,
                                       configs, setup)  # noqa: F401
from tests.test_torch_train import _jax_step_fn, _np_tree

STEP_REL_L2 = 1e-2
NORM_FLOOR = 1e-3
BF16 = "bfloat16"


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


# ------------------------------------------------------------- one conv

def _conv_inputs(seed, b=2, nq=60, k=10, kp=15, cin=8, cout=24,
                 identity=False):
    """Queries in a 4 m box, each with k supports of its own within 0.5 m
    (per axis), shuffled, 10 % of the slots shadows: every support is the
    neighbor of one (query, slot) at most."""
    rng = np.random.default_rng(seed)
    ns = nq * k
    q = rng.uniform(-2, 2, (b, nq, 3)).astype(np.float32)
    own = q[:, :, None, :] + rng.uniform(-0.5, 0.5, (b, nq, k, 3))
    s = np.empty((b, ns, 3), np.float32)
    nb = np.empty((b, nq, k), np.int32)
    for i in range(b):
        perm = rng.permutation(ns)
        s[i, perm] = own[i].reshape(ns, 3)
        nb[i] = perm.reshape(nq, k)
    nb[rng.random(nb.shape) < 0.1] = ns
    x = rng.normal(size=(b, ns, cin)).astype(np.float32)
    kpts = rng.uniform(-0.4, 0.4, (kp, 3)).astype(np.float32)
    if identity:
        cout = kp * cin
        w = np.eye(cout, dtype=np.float32).reshape(kp, cin, cout)
    else:
        w = (rng.normal(size=(kp, cin, cout)) / np.sqrt(cin)).astype(
            np.float32)
    g = rng.normal(size=(b, nq, cout)).astype(np.float32)
    return q, s, nb, x, kpts, w, g


def _jax_conv(q, s, nb, x, kpts, w, g, extra=(), **params):
    """JAX's conv (XLA path, bf16) and its VJP for the cotangent g with
    respect to x, w and the `extra` inputs (offsets, modulations)."""
    p = JaxParams(kp_extent=0.6, influence="linear", compute_dtype=BF16,
                  **params)

    def f(x, w, *extra):
        return jax_kpconv(jnp.asarray(q), jnp.asarray(s), jnp.asarray(nb),
                          x, jnp.asarray(kpts), w, p, *extra)[0]

    primals = [jnp.asarray(v) for v in (x, w, *extra)]
    out, vjp = jax.vjp(f, *primals)
    return [np.asarray(out)] + [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rigid_conv_matches_jax_xla_path():
    # W = identity: the output is y itself, bf16 on both sides
    q, s, nb, x, kpts, w, g = _conv_inputs(0, identity=True)
    y_jax = _jax_conv(q, s, nb, x, kpts, w, g)[0].reshape(-1, w.shape[0]
                                                          * w.shape[1])
    _, y = kpconv_fwd_plain_with_y(*map(_t, (q, s, nb, x, kpts, w)), 0.6,
                                   "linear", BF16)
    assert y.dtype == torch.bfloat16 and is_bf16_valued(y_jax)
    report = flips(y, y_jax)
    assert flips_ok(report), report

    q, s, nb, x, kpts, w, g = _conv_inputs(1)
    out_j, dx_j, dw_j = _jax_conv(q, s, nb, x, kpts, w, g)
    args = list(map(_t, (q, s, nb, x, kpts, w)))
    out, y = kpconv_fwd_plain_with_y(*args, 0.6, "linear", BF16)
    dx, dw = kpconv_bwd_plain(*args[:3], y, args[4], args[5], _t(g), 0.6,
                              "linear", compute_dtype=BF16)
    assert rel_l2(out, out_j) <= OUT_REL_L2_MAX
    # each dX row is one slot's rounded gradient (or zero)
    assert is_bf16_valued(dx_j) and is_bf16_valued(dw_j)
    terms = (y.float().abs().t() @ _t(np.abs(g)).reshape(-1, g.shape[2]))
    for got, want, t in ((dx, dx_j, None),
                         (dw, dw_j, terms.reshape(dw.shape))):
        report = flips(got, want, t)
        assert flips_ok(report), report


def test_deformable_modulated_conv_matches_jax_xla_path():
    q, s, nb, x, kpts, w, g = _conv_inputs(2)
    rng = np.random.default_rng(3)
    b, nq = q.shape[:2]
    kp = kpts.shape[0]
    offsets = rng.normal(0, 0.1, (b, nq, kp, 3)).astype(np.float32)
    mods = rng.uniform(0.2, 1.8, (b, nq, kp)).astype(np.float32)
    out_j, dx_j, dw_j, doff_j, dmod_j = _jax_conv(
        q, s, nb, x, kpts, w, g, extra=(offsets, mods), deformable=True,
        modulated=True)
    params = ops.KPConvParams(kp_extent=0.6, influence="linear",
                              deformable=True, modulated=True,
                              compute_dtype=BF16)
    leaves = [_t(a).requires_grad_() for a in (x, w, offsets, mods)]
    out, _ = ops.kpconv_dense(_t(q), _t(s), _t(nb), leaves[0], _t(kpts),
                              leaves[1], params, offsets=leaves[2],
                              modulations=leaves[3])
    out.backward(_t(g))
    dx, dw, doff, dmod = (v.grad for v in leaves)
    assert rel_l2(out.detach(), out_j) <= OUT_REL_L2_MAX
    for got, want in ((dx, dx_j), (dw, dw_j)):
        assert is_bf16_valued(want)
        report = flips(got, want)
        assert flips_ok(report), report
    assert rel_l2(doff, doff_j) <= OUT_REL_L2_MAX
    assert rel_l2(dmod, dmod_j) <= OUT_REL_L2_MAX


def _bf16_converts(jaxpr):
    """Shapes of every convert to bf16 in a jaxpr and its sub-jaxprs."""
    found = []
    for eqn in jaxpr.eqns:
        if (eqn.primitive.name == "convert_element_type"
                and eqn.params["new_dtype"] == jnp.bfloat16):
            found.append(tuple(eqn.outvars[0].aval.shape))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    found += _bf16_converts(inner)
    return found


def test_jax_rounding_points_are_the_ports():
    """Where jax.grad of the XLA conv rounds: the port's plain versions
    put `bf` at these points (ops/cuda/kpconv_fwd.py, kpconv_bwd.py)."""
    b, nq, k, kp, cin, cout = 2, 7, 5, 3, 4, 6
    q, s, nb, x, kpts, w, g = _conv_inputs(4, b=b, nq=nq, k=k, kp=kp,
                                           cin=cin, cout=cout)
    p = JaxParams(kp_extent=0.6, compute_dtype=BF16)

    def f(x, w):
        return jax_kpconv(jnp.asarray(q), jnp.asarray(s), jnp.asarray(nb),
                           x, jnp.asarray(kpts), w, p)[0]

    fwd = _bf16_converts(jax.make_jaxpr(f)(jnp.asarray(x),
                                           jnp.asarray(w)).jaxpr)
    assert sorted(fwd) == sorted([
        (b, nq, kp, k),            # bf(h)
        (b, nq, k, cin),           # bf(x) of each neighbor slot
        (b * nq, kp * cin),        # bf(y)
        (kp * cin, cout)])         # bf(W)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    bwd = _bf16_converts(jax.make_jaxpr(vjp)(jnp.asarray(g)).jaxpr)
    # g [B, Nq, Cout] is not rounded; dr, dW and each slot's gradient are
    assert sorted(bwd) == sorted([
        (b * nq, kp * cin),        # dr = bf(g @ bf(W)^T)
        (kp * cin, cout),          # dW = bf(bf(y)^T @ g)
        (b, nq, k, cin)])          # bf(sum_p bf(h_p) dr_p), per slot


# ------------------------------------------------------------ whole steps

def _rel_l2_each(got, want):
    """Relative L2 error of each tensor, its norm floored at NORM_FLOOR of
    the largest norm among `want`."""
    assert set(got) == set(want)
    top = max(float(v.double().norm()) for v in want.values())
    worst = 0.0
    for key, ref in want.items():
        diff = float((got[key].detach().double() - ref.double()).norm())
        rel = diff / max(float(ref.double().norm()), NORM_FLOOR * top)
        assert rel <= STEP_REL_L2, (key, rel)
        worst = max(worst, rel)
    return worst


def _wl_setup():
    _forward, (variables, arrays) = graft.entry()
    jcfg = graft._tiny_config()
    jcfg.compute_dtype = BF16
    _, plan = demo_batch(jcfg, batch_size=2, seed=0, density=8.0)
    variables = _as_dicts(variables)
    rng = np.random.default_rng(1)
    _randomize(variables["params"], rng)
    _randomize(variables["batch_stats"], rng)
    cfg = TinyConfig()
    cfg.compute_dtype = BF16
    model = KPFCNN_mprm(cfg, tuple(range(9)), ())
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return jcfg, cfg, plan, variables, arrays, model


def _rel_l2_all(got, want):
    """Relative L2 error over every tensor of `want` together."""
    diff = sum(float((got[k].detach().double() - v.double()).norm()) ** 2
               for k, v in want.items())
    norm = sum(float(v.double().norm()) ** 2 for v in want.values())
    return (diff / norm) ** 0.5


def test_wl_step_in_bf16_matches_jax(record_property):
    jcfg, cfg, plan, variables, arrays, model = _wl_setup()
    lr = jcfg.learning_rate
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = make_optimizer(jcfg, jv["params"])
    jstep = _jax_step_fn(jcfg, plan, jv["constants"], lr, tx)
    params, bstats, _opt, jloss, _jacc, jgrads = jstep(
        jv["params"], jv["batch_stats"], tx.init(jv["params"]), arrays)
    # the same JAX step with the two spheres swapped: another f32 order
    swapped = {k: (np.ascontiguousarray(np.asarray(v)[::-1])
                   if np.ndim(v) and np.shape(v)[0] == 2 else v)
               for k, v in arrays.items()}
    jgrads_swapped = jstep(jv["params"], jv["batch_stats"],
                           tx.init(jv["params"]), swapped)[5]
    state = init_opt_state(model)
    loss, _acc, _drops = train_step(model, state, arrays, cfg, plan, lr,
                                    device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    record_property("loss_rel_err", abs(float(loss) / float(jloss) - 1))
    want = from_jax_variables({"params": _np_tree(jgrads)})
    spread = _rel_l2_all(
        from_jax_variables({"params": _np_tree(jgrads_swapped)}), want)
    ours = _rel_l2_all({n: p.grad for n, p in model.named_parameters()},
                       want)
    record_property("grads_rel_l2", ours)
    record_property("jax_spread_rel_l2", spread)
    assert ours <= 2.0 * spread, (ours, spread)
    want = from_jax_variables({"params": _np_tree(params),
                               "batch_stats": _np_tree(bstats),
                               "constants": variables["constants"]})
    record_property("state_rel_l2", _rel_l2_each(model.state_dict(), want))


def test_pl_step_in_bf16_matches_jax(setup, record_property):
    jcfg, pcfg = configs(compute_dtype=BF16)
    jbatch, lr = setup["jbatch"], 0.01
    mask_flat = np.asarray(jbatch.masks[0]).reshape(-1)
    slc = np.random.default_rng(2).choice(np.flatnonzero(mask_flat),
                                          size=200).astype(np.int32)
    table = jnp.asarray(jax_mapper(LABELS, IGNORED))
    class_w = jnp.asarray(np.asarray(CLASS_W, np.float32))
    model = JaxKPFCNN(jcfg, LABELS, IGNORED)
    jv = jax.tree_util.tree_map(jnp.asarray, setup["variables"])
    params = jv["params"]
    tx = make_optimizer(jcfg, params, clip_mode="value")

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

    (jloss, new_bs), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(
        params, jax.tree_util.tree_map(lambda u: -lr * u, updates))

    net = KPFCNN(pcfg, LABELS, IGNORED)
    net.load_state_dict(from_jax_variables(setup["variables"]), strict=True)
    state = init_opt_state(net)
    loss, _acc = step_on_batch(net, state, setup["batch"], pcfg, lr,
                               use_contrast=True,
                               slc_idx=torch.from_numpy(slc))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3)
    record_property("loss_rel_err", abs(float(loss) / float(jloss) - 1))
    record_property("grads_rel_l2", _rel_l2_each(
        {n: p.grad for n, p in net.named_parameters()},
        from_jax_variables({"params": _np_tree(grads)})))
    want = from_jax_variables(
        {"params": _np_tree(new_params), "batch_stats": _np_tree(new_bs),
         "constants": setup["variables"]["constants"]})
    record_property("state_rel_l2", _rel_l2_each(net.state_dict(), want))


def test_eval_probabilities_in_bf16_match_jax(record_property):
    jcfg, _cfg, _plan, variables, _arrays, model = _wl_setup()
    jbatch, _ = demo_batch(jcfg, batch_size=2, seed=0, density=8.0)
    jmodel = JaxModel(jcfg, tuple(range(9)), ())
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        jax.tree_util.tree_map(jnp.asarray, variables), jbatch)
    model.eval()
    with torch.no_grad():
        logits = model(_port_batch(jbatch))[0]
    mask0 = np.asarray(jbatch.masks[0])
    got = torch.softmax(logits, dim=-1).numpy()[mask0]
    ref = np.asarray(jax.nn.softmax(want[0], axis=-1))[mask0]
    record_property("probs_max_abs_err", float(np.abs(got - ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
