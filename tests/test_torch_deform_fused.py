"""The deformable chain's pair work (`ops/kpconv.DeformPairsFunction`,
ops/cuda/deform_kpconv.py) on the CPU, no JAX.

- `deform_aggregate_reference` and its hand-derived backward, through
  `kpconv_fused`, against autograd through `kpconv_dense` in f64 on
  planted kinks: a neighbor exactly at a deformed kernel point's extent
  while inside another's, two neighbors tied for a kernel point's
  minimum, shadow slots and an all-shadow row; linear, gaussian and
  constant influences, modulated and not, with and without the edge's
  inverse lists. The forward is bit-equal, the gradients within 1e-10;
  on seeded f32 inputs at the deformable cell's 15 kernel points within
  the f32 tolerances of tests/test_torch_deformable.py;
- a neighbor on its deformed kernel point (d2 = 0): NaN in the same
  offset gradients on both sides;
- the CPU route of `deformable_kpconv` is today's chain (`kpconv_dense`)
  bit for bit, and counts no `deform.fused.*`;
- routing, with the card's route forced: f32 deformable convs, modulated
  or not, take the Function (one `deform.fused.fwd` and one `.bwd` a
  chain); bf16 and 'closest' deformable convs take `kpconv_dense`, rigid
  convs `KPConvFunction`;
- the kernel wrappers refuse CPU tensors, a wrong device, dtype,
  contiguity or shape, and sizes past the card's shared memory.
"""

import numpy as np
import pytest
import torch

from weasal_tpu_torch.ops import kpconv as ops
from weasal_tpu_torch.ops.cuda import deform_kpconv as dk
from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
from weasal_tpu_torch.utils import profiling
from tests._deform_cases import (EXT, planted_case, run_chain,
                                 seeded_case)
from tests._warm_torch import cpu_torch

# An H100's shared memory a block, opted in (bytes)
H100_SMEM = 232448


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with cpu_torch():
        yield


REFERENCE_CASES = {
    "linear": dict(influence="linear"),
    "linear modulated, inverse lists": dict(influence="linear",
                                            modulated=True, inverse=True),
    "gaussian": dict(influence="gaussian"),
    "constant modulated": dict(influence="constant", modulated=True),
    "linear, seeded f32": dict(influence="linear", seeded=True),
}


@pytest.mark.parametrize("case", list(REFERENCE_CASES))
def test_reference_matches_autograd_through_the_plain_chain(case):
    """The Function's plain route (the reference's forward and its
    hand-derived backward) inside `kpconv_fused` against autograd through
    `kpconv_dense`: the forward bit for bit; the gradients of x, the
    offsets, the weights and the modulations within 1e-10 in f64 on the
    planted kinks, within f32 tolerances on seeded f32 inputs."""
    kw = dict(REFERENCE_CASES[case])
    seeded = kw.pop("seeded", False)
    inverse = kw.pop("inverse", False)
    c = seeded_case(torch.float32) if seeded else planted_case(torch.float64)
    params = ops.KPConvParams(kp_extent=EXT, deformable=True, **kw)
    lists = LazyInverse(c["inds"], c["ns"]) if inverse else None
    want = run_chain(ops.kpconv_dense, c, params, lists)
    got = run_chain(ops.kpconv_fused, c, params, lists)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(got[2]) == set(want[2]) == (
        {"x", "off", "w"} | ({"mods"} if params.modulated else set()))
    for name, ref in want[2].items():
        scale = float(ref.abs().max())
        rtol, atol = (1e-4, 1e-6 * scale) if seeded else (1e-10, 1e-12 * scale)
        torch.testing.assert_close(got[2][name], ref, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
    if not seeded:
        # the planted kinks are there: slot 0 at d0's extent, inside d1's;
        # slots 1 and 2 tied for d2's minimum; an all-shadow row
        _, d2 = dk.pair_geometry(c["q"], c["s"], c["inds"], c["kpts"],
                                 c["off"])
        assert float(d2[0, 0, 0, 0]) == EXT ** 2
        assert float(d2[0, 0, 0, 1]) < EXT ** 2
        assert d2[0, 0, 1, 2] == d2[0, 0, 2, 2] == d2[0, 0, :, 2].min()
        assert bool((c["inds"][1, -1] == c["ns"]).all())
        assert float(got[2]["off"][0, 0].abs().sum()) > 0


def test_coinciding_neighbor_gives_nan_as_the_plain_chain():
    """A neighbor on its deformed kernel point (d2 = 0, inside the range):
    sqrt's gradient divides by zero, and both the plain chain under
    autograd and the Function's backward give NaN in the same offset
    gradients, finite ones elsewhere."""
    c = planted_case(torch.float64)
    c["s"][0, 4] = c["q"][0, 0]                 # on d0 = (0, 0, 0)
    c["inds"][0, 0, 4] = 4
    params = ops.KPConvParams(kp_extent=EXT, deformable=True)
    want = run_chain(ops.kpconv_dense, c, params)[2]["off"]
    got = run_chain(ops.kpconv_fused, c, params)[2]["off"]
    assert bool(want[0, 0, 0].isnan().all())
    assert torch.equal(got.isnan(), want.isnan())
    fine = ~want.isnan()
    torch.testing.assert_close(got[fine], want[fine], rtol=1e-10,
                               atol=1e-12 * float(want[fine].abs().max()))


@pytest.mark.parametrize("modulated", [False, True])
def test_cpu_route_is_todays_chain(modulated):
    """On the CPU `deformable_kpconv` of an f32 deformable conv runs
    today's chain: output, minima and every gradient bit-equal to
    `kpconv_dense`'s, and no `deform.fused.*` counted."""
    c = seeded_case(torch.float32, seed=2)
    params = ops.KPConvParams(kp_extent=EXT, deformable=True,
                              modulated=modulated)
    assert ops.deform_kernel_eligible(params)
    before = profiling.counts("deform.fused.")
    got = run_chain(ops.deformable_kpconv, c, params)
    want = run_chain(ops.kpconv_dense, c, params)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(got[2]) == set(want[2])
    for name in want[2]:
        assert torch.equal(got[2][name], want[2][name]), name
    assert profiling.counts("deform.fused.") == before


ROUTES = {
    "f32": (dict(deformable=True), "fused"),
    "f32 modulated": (dict(deformable=True, modulated=True), "fused"),
    "bf16": (dict(deformable=True, compute_dtype="bfloat16"), "dense"),
    "closest": (dict(deformable=True, aggregation="closest"), "dense"),
    "rigid": (dict(), "rigid"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routing_with_the_cards_route(case, monkeypatch):
    """With the card's route forced (`use_kernel` true, the reference in
    place of the kernels' wrappers): f32 deformable convs take
    `DeformPairsFunction`'s kernels, forward and backward, counting one
    `deform.fused.fwd` and one `.bwd`, with values within f32 tolerance
    of `kpconv_dense`; bf16 and 'closest' deformable convs take
    `kpconv_dense`, rigid convs `KPConvFunction`, and launch neither."""
    kw, route = ROUTES[case]
    calls = []

    def fwd(*args):
        calls.append("fwd")
        return dk.deform_aggregate_reference(*args)

    def bwd(*args, **flags):
        calls.append("bwd")
        return dk.deform_aggregate_reference_bwd(*args, **flags)

    monkeypatch.setattr(ops, "use_kernel", lambda t: True)
    monkeypatch.setattr(ops, "deform_pairs_fwd", fwd)
    monkeypatch.setattr(ops, "deform_pairs_bwd", bwd)
    rigid = []
    apply = ops.KPConvFunction.apply
    monkeypatch.setattr(ops.KPConvFunction, "apply",
                        lambda *a: rigid.append(1) or apply(*a))
    c = seeded_case(torch.float32, seed=3)
    params = ops.KPConvParams(kp_extent=EXT, **kw)
    before = profiling.counts("deform.fused.")
    if route == "rigid":
        x = c["x"].clone().requires_grad_()
        out = ops.kpconv(c["q"], c["s"], c["inds"], x, c["kpts"], c["w"],
                         params)
        (out * c["g_out"]).sum().backward()
        assert not ops.deform_kernel_eligible(params)
        assert rigid and not calls
        assert profiling.counts("deform.fused.") == before
        return
    assert ops.deform_kernel_eligible(params) == (route == "fused")
    got = run_chain(ops.deformable_kpconv, c, params)
    counted = {k: n - before.get(k, 0)
               for k, n in profiling.counts("deform.fused.").items()}
    assert not rigid
    if route == "fused":
        assert calls == ["fwd", "bwd"]
        assert counted == {"deform.fused.fwd": 1, "deform.fused.bwd": 1}
        want = run_chain(ops.kpconv_dense, c, params)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for name, ref in want[2].items():
            torch.testing.assert_close(
                got[2][name], ref, rtol=1e-4,
                atol=1e-6 * float(ref.abs().max()))
    else:
        assert calls == [] and not any(counted.values())


def _inputs(**changes):
    c = seeded_case(torch.float32, seed=4)
    args = dict(q_pts=c["q"], s_pts=c["s"], neighb_inds=c["inds"],
                x=c["x"], kernel_points=c["kpts"], offsets=c["off"])
    args.update(changes)
    return args


def _check(args, limit=H100_SMEM, backward=False):
    k, cin = args["neighb_inds"].shape[2], args["x"].shape[2]
    f32 = torch.float32
    tensors = tuple((n, t, torch.int32 if n == "neighb_inds" else f32)
                    for n, t in args.items())
    dk.check_deform_inputs(
        "deform_pairs", tensors, args["q_pts"], args["s_pts"],
        args["neighb_inds"], args["x"], args["kernel_points"],
        args["offsets"], dk.pair_smem_bytes(
            args["kernel_points"].shape[0], k, cin, backward), limit)


REFUSALS = {
    "cpu tensors": (lambda: dk.deform_pairs_fwd(
        **_inputs(), kp_extent=EXT), ValueError, "cuda tensors"),
    "cpu tensors, backward": (lambda: dk.deform_pairs_bwd(
        **_inputs(), dy=torch.zeros(2, 24, 15, 8), dmin=None,
        kp_extent=EXT), ValueError, "cuda tensors"),
    "wrong device": (lambda: _check(_inputs(
        x=torch.empty((2, 30, 8), device="meta"))), ValueError, "is on"),
    "dtype": (lambda: _check(_inputs(
        x=torch.zeros((2, 30, 8), dtype=torch.float64))), TypeError,
        "float32 only"),
    "contiguity": (lambda: _check(_inputs(
        offsets=torch.zeros((2, 24, 3, 15)).transpose(2, 3))), ValueError,
        "contiguous"),
    "shape": (lambda: _check(_inputs(offsets=torch.zeros((2, 24, 14, 3)))),
              ValueError, "offsets"),
    "K past the card's shared memory": (lambda: _check(_inputs(
        neighb_inds=torch.zeros((2, 24, 4000), dtype=torch.int32))),
        ValueError, "shared memory"),
    "K past it in the backward only": (lambda: _check(_inputs(
        neighb_inds=torch.zeros((2, 24, 1800), dtype=torch.int32)),
        backward=True), ValueError, "shared memory"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrappers_refuse_bad_inputs(case):
    """The kernel wrappers raise on CPU tensors; their input check on a
    wrong device, dtype, contiguity or shape, and on sizes whose block
    passes the card's shared memory (the forward's tile at K 1800 fits,
    the backward's does not)."""
    fn, exc, text = REFUSALS[case]
    with pytest.raises(exc, match=text):
        fn()
    if case == "K past it in the backward only":
        _check(_inputs(neighb_inds=torch.zeros((2, 24, 1800),
                                               dtype=torch.int32)))
