"""Kernels A and B on the card against their plain versions, at small
shapes with shadows, masks, ties and all three influences. Needs an
NVIDIA GPU with nvcc; skips elsewhere. On the machine with the card (which
has no JAX) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from weasal_tpu_torch.ops.cuda.kpconv_fwd import kpconv_fwd, kpconv_fwd_plain
from weasal_tpu_torch.ops.cuda.radius_search import (radius_search,
                                                     radius_search_plain)

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
