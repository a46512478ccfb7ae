"""Kernels A-D on the card against their plain versions, at small shapes
with shadows, masks, ties (a maximum of 0 shared with shadows for D) and
all three influences, and the autograd Functions that launch C and D.
Tolerances: B and C rtol 1e-4, atol 1e-5 x output scale (f32 sums in
another order); D rtol 1e-6, atol 1e-6 x scale (atomics add the shares of
one support in another order). Needs an NVIDIA GPU with nvcc; skips
elsewhere. On the machine with the card (which has no JAX) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd, kpconv_bwd_plain
from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd,
                                                  kpconv_fwd_plain,
                                                  kpconv_fwd_plain_with_y,
                                                  kpconv_fwd_with_y)
from weasal_tpu_torch.ops.cuda.maxpool_bwd import (maxpool_bwd,
                                                   maxpool_bwd_plain)
from weasal_tpu_torch.ops.cuda.radius_search import (radius_search,
                                                     radius_search_plain)
from weasal_tpu_torch.utils.device import plain_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("grid,k", [(False, 12), (True, 10), (False, 200)])
def test_radius_search_kernel_equals_plain(dev, grid, k):
    g = torch.Generator(device=dev).manual_seed(0)
    b, nq, ns = 2, 333, 777
    if grid:
        s = torch.randint(-3, 4, (b, ns, 3), generator=g, device=dev).float()
    else:
        s = torch.rand((b, ns, 3), generator=g, device=dev) * 6 - 3
    q = s[:, :nq].contiguous()
    qm = torch.rand((b, nq), generator=g, device=dev) > 0.1
    sm = torch.rand((b, ns), generator=g, device=dev) > 0.1
    got, ovf = radius_search(q, s, qm, sm, 1.3, k)
    want = radius_search_plain(q, s, qm, sm, 1.3, k)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert float(ovf.sum()) == 0.0


@pytest.mark.parametrize("influence", ["linear", "constant", "gaussian"])
def test_kpconv_kernel_matches_plain(dev, influence):
    g = torch.Generator(device=dev).manual_seed(1)
    b, nq, ns, k, kp, cin, cout = 2, 300, 500, 20, 15, 24, 40
    s = torch.rand((b, ns, 3), generator=g, device=dev) * 4 - 2
    q = (s[:, :nq] + 0.05).contiguous()
    nb = torch.randint(0, ns + 1, (b, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    x = torch.randn((b, ns, cin), generator=g, device=dev)
    kpts = torch.rand((kp, 3), generator=g, device=dev) - 0.5
    w = torch.randn((kp, cin, cout), generator=g, device=dev)
    got, oob = kpconv_fwd(q, s, nb, x, kpts, w, 0.8, influence)
    want = kpconv_fwd_plain(q, s, nb, x, kpts, w, 0.8, influence)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    assert float(oob.sum()) == 0.0


def test_kpconv_kernel_rejects_other_dtypes(dev):
    q = torch.zeros(1, 4, 3, device=dev)
    nb = torch.zeros(1, 4, 2, dtype=torch.int32, device=dev)
    x = torch.zeros(1, 4, 5, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        kpconv_fwd(q, q, nb, x, torch.zeros(15, 3, device=dev),
                   torch.zeros(15, 5, 6, device=dev), 1.0)


def _conv_problem(dev, seed, b=2, nq=300, ns=500, k=20, kp=15, cin=24,
                  cout=40):
    g = torch.Generator(device=dev).manual_seed(seed)
    s = torch.rand((b, ns, 3), generator=g, device=dev) * 4 - 2
    q = (s[:, :nq] + 0.05).contiguous()
    nb = torch.randint(0, ns + 1, (b, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    nb[:, -5:] = ns                                # all-shadow rows
    x = torch.randn((b, ns, cin), generator=g, device=dev)
    kpts = torch.rand((kp, 3), generator=g, device=dev) - 0.5
    w = torch.randn((kp, cin, cout), generator=g, device=dev)
    grad = torch.randn((b, nq, cout), generator=g, device=dev)
    return q, s, nb, x, kpts, w, grad


def _close(got, want, rtol, atol_rel):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol_rel * float(want.abs().max()))


@pytest.mark.parametrize("influence", ["linear", "constant", "gaussian"])
def test_kpconv_bwd_kernel_matches_plain(dev, influence):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 2)
    out, y = kpconv_fwd_with_y(q, s, nb, x, kpts, w, 0.8, influence)
    _, y_plain = kpconv_fwd_plain_with_y(q, s, nb, x, kpts, w, 0.8,
                                         influence)
    _close(y, y_plain, 1e-4, 1e-5)
    dx, dw = kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8, influence)
    dx_p, dw_p = kpconv_bwd_plain(q, s, nb, y, kpts, w, grad, 0.8,
                                  influence)
    torch.cuda.synchronize()
    _close(dx, dx_p, 1e-4, 1e-5)
    _close(dw, dw_p, 1e-4, 1e-5)
    none, dw2 = kpconv_bwd(q, s, nb, y, kpts, w, grad, 0.8, influence,
                           need_dx=False)
    assert none is None
    _close(dw2, dw_p, 1e-4, 1e-5)


def test_maxpool_bwd_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    b, nq, ns, k, c = 2, 400, 600, 14, 80
    # integer values: exact ties; column 0 is never positive, so its
    # maximum is often the 0 that real rows share with shadow slots
    x = torch.randint(-3, 3, (b, ns, c), generator=g, device=dev).float()
    x[:, :, 0] = x[:, :, 0].clamp(max=0)
    nb = torch.randint(0, ns + 1, (b, nq, k), generator=g, device=dev,
                       dtype=torch.int32)
    nb[torch.rand(nb.shape, generator=g, device=dev) < 0.2] = ns
    grad = torch.randn((b, nq, c), generator=g, device=dev)
    got = maxpool_bwd(x, nb, grad)
    want = maxpool_bwd_plain(x, nb, grad)
    torch.cuda.synchronize()
    _close(got, want, 1e-6, 1e-6)


def test_autograd_functions_launch_kernels_c_and_d(dev):
    q, s, nb, x, kpts, w, grad = _conv_problem(dev, 4)
    x.requires_grad_()
    w.requires_grad_()
    gen = torch.Generator(device=dev).manual_seed(5)
    pools = torch.randint(0, q.shape[1] + 1, (q.shape[0], 200, 9),
                          generator=gen, device=dev, dtype=torch.int32)
    c0, d0 = kpconv_bwd.launches, maxpool_bwd.launches
    out = ops.kpconv(q, s, nb, x, kpts, w, ops.KPConvParams(0.8))
    assert out.grad_fn is not None
    pooled = ops.max_pool(out, pools)
    assert pooled.grad_fn is not None
    loss = (pooled * grad[:, :200]).sum()
    dx, dw = torch.autograd.grad(loss, (x, w))
    assert dx is not None and dw is not None
    assert float(dx.abs().max()) > 0 and float(dw.abs().max()) > 0
    assert kpconv_bwd.launches == c0 + 1
    assert maxpool_bwd.launches == d0 + 1
    xp = x.detach().clone().requires_grad_()
    wp = w.detach().clone().requires_grad_()
    with plain_ops():
        outp = ops.kpconv(q, s, nb, xp, kpts, wp, ops.KPConvParams(0.8))
        lossp = (ops.max_pool(outp, pools) * grad[:, :200]).sum()
    dxp, dwp = torch.autograd.grad(lossp, (xp, wp))
    assert kpconv_bwd.launches == c0 + 1
    assert maxpool_bwd.launches == d0 + 1
    _close(dw, dwp, 1e-3, 1e-5)
    _close(dx, dxp, 1e-3, 1e-5)
