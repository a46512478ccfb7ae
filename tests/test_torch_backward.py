"""Kernels C (KPConv backward) and D (max-pool backward): their plain
versions on the CPU against the JAX package's gradients, and the autograd
Functions that route to them.

Tolerances, f32, on the gradients of sum(out * g) for a seeded g:
- kpconv_bwd_plain against jax.grad of the XLA KPConv
  (weasal_tpu/ops/kpconv.py, the same direct differences): rtol 1e-4,
  atol 1e-5 x the gradient's scale; only the summation order differs;
- against jax.grad through the banded Pallas kernel in interpret mode:
  rtol 2e-4, atol 2e-4 x scale, the bound of tests/test_kpconv_banded.py
  (its separable distance expansion loses up to ~2e-5 per influence);
- against torch autograd of kpconv_fwd_plain, and KPConvFunction against
  kpconv_bwd_plain: rtol 1e-6, atol 1e-7 x scale (the same products);
- maxpool_bwd_plain against jax.grad through max_pool_banded in
  interpret mode and through the dense jnp.max route: rtol 1e-6,
  atol 1e-6 x the gradient's scale (ties split by g / ties here and by
  g * (1 / ties) there, and the shares of one support are summed in
  another order: a sum that cancels keeps only absolute accuracy).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from weasal_tpu.ops import kpconv as jops
from weasal_tpu.ops.pallas.kpconv_banded import kpconv_banded
from weasal_tpu.ops.pallas.maxpool_banded import max_pool_banded
from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd, kpconv_bwd_plain
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd_plain,
                                                  kpconv_fwd_plain_with_y)
from weasal_tpu_torch.ops.cuda.maxpool_bwd import (maxpool_bwd,
                                                   maxpool_bwd_plain)
from tests._warm_torch import cpu_torch

INFLUENCES = ["linear", "constant", "gaussian"]


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def _conv_problem(seed, b=2, nq=90, ns=240, k=12, kp=15, cin=8, cout=16):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.uniform(-2, 2, (b, ns, 3)).astype(np.float32), axis=1)
    q = (s[:, :nq] + rng.normal(0, 0.05, (b, nq, 3))).astype(np.float32)
    nb = rng.integers(0, ns + 1, (b, nq, k)).astype(np.int32)
    nb[:, :, -2:] = ns                           # shadow slots
    nb[:, -3:, :] = ns                           # all-shadow rows
    x = rng.normal(size=(b, ns, cin)).astype(np.float32)
    kpts = rng.uniform(-0.6, 0.6, (kp, 3)).astype(np.float32)
    w = (rng.normal(size=(kp, cin, cout)) / np.sqrt(cin)).astype(np.float32)
    g = rng.normal(size=(b, nq, cout)).astype(np.float32)
    return q, s, nb, x, kpts, w, g


def _port_grads(args, extent, influence, need_dx=True):
    q, s, nb, x, kpts, w, g = [torch.from_numpy(a) for a in args]
    _, y = kpconv_fwd_plain_with_y(q, s, nb, x, kpts, w, extent, influence)
    return kpconv_bwd_plain(q, s, nb, y, kpts, w, g, extent, influence,
                            need_dx)


def _jax_grads(args, forward):
    q, s, nb, x, kpts, w, g = [jnp.asarray(a) for a in args]
    return jax.grad(lambda x_, w_: jnp.sum(
        forward(q, s, nb, x_, kpts, w_) * g), argnums=(0, 1))(x, w)


def _assert_grads(got, want, rtol, atol_rel):
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                                   atol=atol_rel * float(np.abs(b).max()))


@pytest.mark.parametrize("influence", INFLUENCES)
def test_kpconv_bwd_plain_matches_jax_xla_grad(influence):
    args = _conv_problem(0)
    params = jops.KPConvParams(kp_extent=0.9, influence=influence)
    want = _jax_grads(args, lambda *a: jops.kpconv(*a, params)[0])
    got = _port_grads(args, 0.9, influence)
    _assert_grads(got, want, 1e-4, 1e-5)
    assert float(np.abs(np.asarray(want[0])).max()) > 0.1


@pytest.mark.parametrize("influence", INFLUENCES)
def test_kpconv_bwd_plain_matches_jax_banded_pallas_grad(influence):
    args = _conv_problem(1)
    want = _jax_grads(args, lambda *a: kpconv_banded(
        *a, 0.9, influence=influence, interpret=True)[0])
    got = _port_grads(args, 0.9, influence)
    _assert_grads(got, want, 2e-4, 2e-4)


@pytest.mark.parametrize("influence", INFLUENCES)
def test_kpconv_bwd_plain_matches_torch_autograd(influence):
    args = _conv_problem(2)
    q, s, nb, x, kpts, w, g = [torch.from_numpy(a) for a in args]
    x.requires_grad_()
    w.requires_grad_()
    out = kpconv_fwd_plain(q, s, nb, x, kpts, w, 0.9, influence)
    want = torch.autograd.grad(out, (x, w), g)
    got = _port_grads(args, 0.9, influence)
    _assert_grads([t.numpy() for t in got], [t.numpy() for t in want],
                  1e-6, 1e-7)


def test_kpconv_function_routes_to_kernel_c_plain_version():
    args = _conv_problem(3)
    q, s, nb, x, kpts, w, g = [torch.from_numpy(a) for a in args]
    x.requires_grad_()
    w.requires_grad_()
    out = ops.kpconv(q, s, nb, x, kpts, w, ops.KPConvParams(0.9))
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (x, w), g)
    want = _port_grads(args, 0.9, "linear")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    # an input that needs no gradient skips dX
    dx, dw = _port_grads(args, 0.9, "linear", need_dx=False)
    assert dx is None
    torch.testing.assert_close(dw, want[1], rtol=0, atol=0)
    out2 = ops.kpconv(q, s, nb, x.detach(), kpts, w, ops.KPConvParams(0.9))
    (dw2,) = torch.autograd.grad(out2, (w,), g)
    torch.testing.assert_close(dw2, want[1], rtol=1e-6, atol=0)


def test_kpconv_bwd_wrapper_on_cpu_is_the_plain_version():
    args = _conv_problem(4)
    q, s, nb, x, kpts, w, g = [torch.from_numpy(a) for a in args]
    _, y = kpconv_fwd_plain_with_y(q, s, nb, x, kpts, w, 0.9, "gaussian")
    got = kpconv_bwd(q, s, nb, y, kpts, w, g, 0.9, "gaussian")
    want = kpconv_bwd_plain(q, s, nb, y, kpts, w, g, 0.9, "gaussian")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _pool_problem(seed, b=2, nq=40, ns=37, k=6, c=8):
    """Integer-valued features (exact ties), negatives (so the shadow's 0.0
    wins), a column that is 0 wherever it is not negative (a maximum of 0
    shared with shadows), banded neighbor lists with shadows."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 3, (b, ns, c)).astype(np.float32)
    x[:, :, 0] = np.minimum(x[:, :, 0], 0.0)
    x[:, :, 1] = -1.0 - rng.integers(0, 2, (b, ns))
    base = (np.arange(nq) * ns / nq).astype(np.int32)
    nb = base[None, :, None] + rng.integers(-4, 5, (b, nq, k))
    nb = np.clip(nb, 0, ns)
    nb[rng.random(nb.shape) < 0.15] = ns
    g = rng.normal(size=(b, nq, c)).astype(np.float32)
    return x, nb.astype(np.int32), g


def test_pool_problem_has_ties_and_shared_zero_maxima():
    x, nb, g = _pool_problem(0)
    pooled = np.where((nb < x.shape[1])[..., None],
                      x[np.arange(2)[:, None, None],
                        np.minimum(nb, x.shape[1] - 1)], 0.0)
    top = pooled.max(axis=2, keepdims=True)
    ties = (pooled == top).sum(axis=2)
    assert (ties > 1).mean() > 0.3
    shadow = (nb >= x.shape[1])[..., None]
    assert ((top[:, :, 0] == 0) & ((pooled == 0) & shadow).any(2)).any()
    assert ((top[:, :, 0] == 0) & ((pooled == 0) & ~shadow).any(2)).any()


@pytest.mark.parametrize("route", ["banded_pallas", "dense"])
def test_maxpool_bwd_plain_matches_jax_grad(route):
    x, nb, g = _pool_problem(1)
    xj, nbj, gj = jnp.asarray(x), jnp.asarray(nb), jnp.asarray(g)
    if route == "dense":
        fwd = lambda v: jops.max_pool(v, nbj, route="dense")  # noqa: E731
    else:
        fwd = lambda v: max_pool_banded(v, nbj, 0, 128, True)  # noqa: E731
    want = jax.grad(lambda v: jnp.sum(fwd(v) * gj))(xj)
    got = maxpool_bwd_plain(torch.from_numpy(x), torch.from_numpy(nb),
                            torch.from_numpy(g))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def test_max_pool_function_routes_to_kernel_d_plain_version():
    x, nb, g = _pool_problem(2, b=3, nq=70, ns=64, k=9, c=16)
    xt = torch.from_numpy(x).requires_grad_()
    nbt, gt = torch.from_numpy(nb), torch.from_numpy(g)
    out = ops.max_pool(xt, nbt)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, xt, gt)
    want = maxpool_bwd_plain(xt.detach(), nbt, gt)
    assert torch.equal(got, want)
    assert torch.equal(maxpool_bwd(xt.detach(), nbt, gt), want)


def _dx_two_stage(contrib, neighb_inds, ns):
    """Kernels C's and D's two stages for dX in plain PyTorch: contrib
    [B, Nq, K, D] (stage 1's workspace) summed into [B, Ns, D] over the
    inverse neighbor lists (build_inverse_lists_plain), each support's
    slots added one at a time in ascending order from 0.0, as
    `inverse_sum_kernel` adds them."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import (
        build_inverse_lists_plain, segment_ids)
    b, nq, k, d = contrib.shape
    inv = build_inverse_lists_plain(neighb_inds, ns, k)
    offsets = inv.offsets.long()
    counts = offsets[1:] - offsets[:-1]
    rows = b * ns
    total = int(offsets[-1])
    seg = segment_ids(inv.offsets, total)
    rank = torch.arange(total, dtype=torch.int64) - offsets[seg]
    src = contrib.reshape(-1, d)
    out = torch.zeros((rows, d), dtype=contrib.dtype)
    depth = int(counts.max()) if rows else 0
    for j in range(depth):
        at = rank == j
        out[seg[at]] = out[seg[at]] + src[inv.entries[:total][at].long()]
    return out.reshape(b, ns, d)


# Kernel C's and D's dX in two stages (a workspace of each slot's
# contribution, then each support's slots added in ascending order over
# its inverse neighbor list) against `index_add_`, at phase 4's (K,
# channels) of the main path: the convs' K 15 / 31 / 34 with their input
# widths and the pools' K 14 / 29, at fewer points (300 queries on 400
# supports, a third of the slots shadows)
@pytest.mark.parametrize("k,c", [(15, 4), (15, 32), (15, 64), (31, 64),
                                 (31, 128), (34, 128), (34, 256), (34, 512),
                                 (14, 64), (29, 128)])
def test_two_stage_dx_equals_index_add(k, c):
    from weasal_tpu_torch.ops.cuda.inverse_lists import scatter_rows
    g = torch.Generator().manual_seed(k * 1000 + c)
    b, nq, ns = 3, 300, 400
    nb = torch.randint(0, ns, (b, nq, k), generator=g, dtype=torch.int32)
    nb[torch.rand(nb.shape, generator=g) < 0.33] = ns
    contrib = torch.randn((b, nq, k, c), generator=g)
    got = _dx_two_stage(contrib, nb, ns)
    want = scatter_rows(contrib, nb, ns)
    torch.testing.assert_close(got, want, rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, want)        # both add in ascending slot order


def test_gather_rows_backward_equals_gather_autograd():
    """The row gather of the region loss and of nearest upsampling
    (`GatherRows`): values and gradient on the CPU equal the autograd of
    the plain gather it replaces, bit for bit; `inverse_sum_plain` over
    the plain inverse lists gives the same gradient."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import (
        build_inverse_lists_plain, gather_rows, inverse_sum_plain)
    g = torch.Generator().manual_seed(9)
    b, ns, d, r, p = 2, 50, 9, 7, 12
    x = torch.randn((b, ns, d), generator=g, requires_grad=True)
    inds = torch.randint(0, ns + 1, (b, r, p), generator=g,
                         dtype=torch.int32)
    gout = torch.randn((b, r, p, d), generator=g)
    got = gather_rows(x, inds)
    (dx,) = torch.autograd.grad(got, x, gout)
    padded = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    flat = inds.reshape(b, -1).long()
    want = padded.gather(1, flat[:, :, None].expand(-1, -1, d))
    (dx_want,) = torch.autograd.grad(want, x, gout.reshape(b, -1, d))
    assert torch.equal(got.reshape(b, -1, d), want)
    assert torch.equal(dx, dx_want)
    inv = build_inverse_lists_plain(inds, ns)
    dx_inv = inverse_sum_plain(gout.reshape(-1, d), inv, b * ns)
    assert torch.equal(dx_inv.reshape(b, ns, d), dx_want)


def test_card_backwards_take_their_inverse_lists_from_the_caller():
    """A dX on the card sums over the inverse lists its caller passes
    (`require_lists`): none raises, lists of another edge raise, and a
    LazyInverse of the indices gives the stable sort's lists."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import (
        LazyInverse, build_inverse_lists_plain, require_lists)
    g = torch.Generator().manual_seed(10)
    b, nq, ns, k = 2, 30, 20, 6
    inds = torch.randint(0, ns + 1, (b, nq, k), generator=g,
                         dtype=torch.int32)
    with pytest.raises(ValueError, match="inverse lists"):
        require_lists(None, b * ns, "kpconv_bwd")
    with pytest.raises(ValueError, match="another shape"):
        require_lists(LazyInverse(inds, ns + 1), b * ns, "maxpool_bwd")
    got = require_lists(LazyInverse(inds, ns), b * ns, "gather_rows")
    want = build_inverse_lists_plain(inds, ns)
    assert torch.equal(got.offsets, want.offsets)
    assert torch.equal(got.entries, want.entries)
