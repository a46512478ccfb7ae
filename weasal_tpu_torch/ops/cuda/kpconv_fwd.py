"""Kernel B: rigid KPConv forward, sum aggregation (csrc/kpconv_fwd.cu).

Replaces the forward of the Pallas TPU kernel `kpconv_banded`
(weasal_tpu/ops/pallas/kpconv_banded.py:572 -> `kpconv_banded_pallas`
:414 -> `_fwd_impl` :435, body `_fwd_kernel` :247). The TPU kernel read
supports through a window around each query tile and counted neighbors
outside it (`oob`); this kernel gathers the neighbor rows, so it is exact
and `oob` is always zero. `band`, `tile` and `pblk_skip` are accepted and
ignored.

What bounds it on the H100: at the wide levels the contraction
[rows, Kp*Cin] @ [Kp*Cin, Cout] (operations; it runs on the tensor cores
through the 3xTF32 split of csrc/kpconv_common.cuh, f32-grade error); at
level 0 the gather of K neighbor rows. The source describes the design.
The wrapper allocates the GEMM's split-K workspace, whose size the
library computes (`kpconv_fwd_workspace`).

`kpconv_fwd_plain` is the same function in plain PyTorch: the chain of
weasal_tpu/ops/kpconv.py:171-237 (gather with a far-away / zero pad row,
direct differences to the kernel points, influence, per-kernel-point
aggregation, one folded GEMM). The CPU path and the tests use it;
`chip_smoke.py` compares the kernel with it on the card.

`compute_dtype` "bfloat16" (the JAX package's `KPConvParams.compute_dtype`)
rounds the two products' inputs to bf16 where its XLA path does
(:206-233): y = bf(sum_k bf(h_pk) * bf(x_k)), summed in f32 and kept as a
bf16 tensor, then out = y @ bf(W) in f32. The kernel runs that through its
bf16 variant (`kpconv_fwd_bf16_launch`: the bf16 aggregate and the bf16
wgmma core). Geometry and influences stay f32 in either mode. Kp and K
have no limit of their own: the launch raises only where the influence
tile [Kp, K] passes the card's shared memory (`kpconv_smem_limit`, 227 KB
on an H100).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library
from weasal_tpu_torch.ops.subsample import SHADOW_COORD

INFLUENCES = {"constant": 0, "linear": 1, "gaussian": 2}
COMPUTE_DTYPES = ("float32", "bfloat16")
# kKpChunk of csrc/kpconv_common.cuh: kernel points a thread holds at once
KP_CHUNK = 16
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
_BF16_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
                  + [ctypes.c_void_p] * 4
                  + [ctypes.c_longlong, ctypes.c_void_p])


def check_compute_dtype(compute_dtype: str) -> bool:
    """True for "bfloat16", False for "float32"; raises on any other."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"Unknown compute_dtype: {compute_dtype!r} "
                         f"(known: {COMPUTE_DTYPES})")
    return compute_dtype == "bfloat16"


def bf(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest bf16 (ties to even), in t's dtype: the
    cast of the JAX package's `mxu()`; differentiable, its gradient
    rounded the same way (the transpose of a cast)."""
    return t.to(torch.bfloat16).to(t.dtype)


def workspace_floats(lib, name: str, *sizes) -> int:
    """Floats of split-K workspace that the library's
    `<name>_workspace(*sizes)` asks for (0: none)."""
    fn = getattr(lib, f"{name}_workspace")
    fn.argtypes = ([ctypes.c_longlong]
                   + [ctypes.c_int] * (len(sizes) - 1))
    fn.restype = ctypes.c_longlong
    return int(fn(*sizes))


def workspace(lib, name: str, *sizes, device) -> torch.Tensor | None:
    """The split-K workspace of `workspace_floats`, or None when it needs
    none."""
    n = workspace_floats(lib, name, *sizes)
    return (torch.empty(n, dtype=torch.float32, device=device)
            if n > 0 else None)


def workspace_args(ws: torch.Tensor | None):
    """(pointer, length in floats) of a workspace, as the launches take
    it."""
    return (None, 0) if ws is None else (ws.data_ptr(), ws.numel())


def gather_neighbors(values: torch.Tensor, inds: torch.Tensor,
                     pad_value: float) -> torch.Tensor:
    """Gather [B, Ns, D] rows by [B, Nq, K] sphere-local indices; index Ns
    (the shadow) selects an appended constant `pad_value` row."""
    b, ns, d = values.shape
    pad = torch.full((b, 1, d), pad_value, dtype=values.dtype,
                     device=values.device)
    flat = torch.cat([values, pad], dim=1).reshape(b * (ns + 1), d)
    offs = (torch.arange(b, device=inds.device, dtype=torch.int64)
            * (ns + 1))[:, None, None]
    idx = inds.to(torch.int64) + offs
    out = flat.index_select(0, idx.reshape(-1))
    return out.reshape(b, inds.shape[1], inds.shape[2], d)


def gaussian_denominator(kp_extent: float) -> float:
    sigma = kp_extent * 0.3
    return 2 * sigma ** 2 + 1e-9


def reciprocals(kp_extent: float):
    """(1 / ext, 1 / den) in double, as the launches take them: PyTorch
    on the card divides by a Python scalar as a product with its
    reciprocal computed in double and rounded to f32 (ctypes rounds)."""
    return 1.0 / kp_extent, 1.0 / gaussian_denominator(kp_extent)


def influence_weights(sq_distances: torch.Tensor, kp_extent: float,
                      influence: str) -> torch.Tensor:
    """[B, Nq, K, Kp] squared distances -> [B, Nq, Kp, K] influences."""
    if influence == "constant":
        w = torch.ones_like(sq_distances)
    elif influence == "linear":
        w = torch.clamp(1.0 - torch.sqrt(sq_distances) / kp_extent, min=0.0)
    elif influence == "gaussian":
        w = torch.exp(-sq_distances / gaussian_denominator(kp_extent))
    else:
        raise ValueError(f"Unknown KP influence: {influence}")
    return w.transpose(-1, -2)


def neighbor_influences(q_pts, s_pts, neighb_inds, kernel_points,
                        kp_extent: float, influence: str) -> torch.Tensor:
    """[B, Nq, Kp, K] influences h_p(s[nb_k] - q) from direct differences
    s - q - kp_p (each axis rounded separately); a shadow neighbor sits at
    the far-away pad coordinate."""
    neighbors = gather_neighbors(s_pts, neighb_inds, SHADOW_COORD)
    neighbors = neighbors - q_pts[:, :, None, :]
    diffs = neighbors[:, :, :, None, :] - kernel_points[None, None, None]
    sq = diffs * diffs
    sq_distances = sq[..., 0] + sq[..., 1] + sq[..., 2]     # [B,Nq,K,Kp]
    return influence_weights(sq_distances, kp_extent, influence)


def kpconv_fwd_plain_with_y(q_pts, s_pts, neighb_inds, x, kernel_points,
                            weights, kp_extent: float,
                            influence: str = "linear",
                            compute_dtype: str = "float32"):
    """Rigid sum-aggregation KPConv: (out [B, Nq, Cout], y [B*Nq, Kp*Cin]),
    y the per-kernel-point aggregate that the backward's dW reads (a bf16
    tensor under compute_dtype "bfloat16")."""
    use_bf16 = check_compute_dtype(compute_dtype)
    all_weights = neighbor_influences(q_pts, s_pts, neighb_inds,
                                      kernel_points, kp_extent, influence)
    neighb_x = gather_neighbors(x, neighb_inds, 0.0)         # [B,Nq,K,Cin]
    if use_bf16:
        all_weights, neighb_x = bf(all_weights), bf(neighb_x)
    weighted = torch.einsum("bqpk,bqkc->bqpc", all_weights, neighb_x)
    b, nq = weighted.shape[:2]
    kp, cin, cout = weights.shape
    y = weighted.reshape(b * nq, kp * cin)
    w2 = weights.reshape(kp * cin, cout)
    if use_bf16:
        y = y.to(torch.bfloat16)
        out = y.to(w2.dtype) @ bf(w2)
    else:
        out = y @ w2
    return out.reshape(b, nq, cout), y


def kpconv_fwd_plain(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                     kp_extent: float, influence: str = "linear",
                     compute_dtype: str = "float32"):
    """Rigid sum-aggregation KPConv: [B, Nq, Cout]."""
    return kpconv_fwd_plain_with_y(q_pts, s_pts, neighb_inds, x,
                                   kernel_points, weights, kp_extent,
                                   influence, compute_dtype)[0]


@functools.lru_cache(maxsize=None)
def influence_smem_limit(lib) -> int:
    """Bytes of shared memory the card gives a block (the influence tile's
    limit), from the kernel library; read once a library."""
    fn = lib.kpconv_smem_limit
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return int(fn())


def check_kpconv_inputs(what: str, tensors, q_pts, s_pts, neighb_inds,
                       kernel_points, weights, cin: int,
                       smem_limit: int) -> None:
    """Raise unless every (name, tensor, dtype) of `tensors` lies on
    q_pts's device with that dtype, contiguous, and the shapes are
    q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K], kp [Kp,3], W [Kp,Cin,Cout] with
    Kp >= 1 and the influence tile, (Kp * K + K) floats, within
    `smem_limit` bytes (the card's shared memory a block)."""
    for name, t, dtype in tensors:
        if t.device != q_pts.device:
            raise ValueError(f"{name} is on {t.device}, q_pts on "
                             f"{q_pts.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what} takes {name} as {dtype} only, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, nq, _ = q_pts.shape
    kp, _, _ = weights.shape
    k = neighb_inds.shape[2]
    if (q_pts.shape[2] != 3 or s_pts.shape[0] != b or s_pts.shape[2] != 3
            or tuple(neighb_inds.shape[:2]) != (b, nq)
            or tuple(kernel_points.shape) != (kp, 3)
            or weights.shape[1] != cin):
        raise ValueError("expected q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K], "
                         "x [B,Ns,Cin], kp [Kp,3], W [Kp,Cin,Cout]")
    if kp < 1:
        raise ValueError(f"{what} needs at least one kernel point")
    need = (kp * k + k) * 4
    if need > smem_limit:
        raise ValueError(
            f"{what}: the influence tile of {kp} kernel points x {k} "
            f"neighbors needs {need} bytes of shared memory a block, past "
            f"the card's limit of {smem_limit} bytes")


def _launch(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
            kp_extent, influence, compute_dtype):
    b, nq, _ = q_pts.shape
    ns, cin = x.shape[1:]
    kp, _, cout = weights.shape
    k = neighb_inds.shape[2]
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP influence: {influence}")
    use_bf16 = check_compute_dtype(compute_dtype)
    lib = load_library("kpconv_fwd")
    check_kpconv_inputs(
        "kpconv_fwd", (("q_pts", q_pts, torch.float32),
                       ("s_pts", s_pts, torch.float32),
                       ("neighb_inds", neighb_inds, torch.int32),
                       ("x", x, torch.float32),
                       ("kernel_points", kernel_points, torch.float32),
                       ("weights", weights, torch.float32)),
        q_pts, s_pts, neighb_inds, kernel_points, weights, cin,
        influence_smem_limit(lib))
    if tuple(x.shape[:2]) != (b, ns):
        raise ValueError("expected x [B,Ns,Cin]")
    dev = q_pts.device
    out = torch.empty((b, nq, cout), dtype=torch.float32, device=dev)
    y = torch.empty((b * nq, kp * cin),
                    dtype=torch.bfloat16 if use_bf16 else torch.float32,
                    device=dev)
    if b * nq == 0:
        return out, y
    name = "kpconv_fwd_bf16" if use_bf16 else "kpconv_fwd"
    ws = workspace(lib, name, b * nq, kp * cin, cout, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    inv_ext, inv_den = reciprocals(kp_extent)
    head = (q_pts.data_ptr(), s_pts.data_ptr(), neighb_inds.data_ptr(),
            x.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
            b, nq, ns, k, kp, cin, cout, inv_ext, INFLUENCES[influence],
            inv_den)
    kpconv_fwd.launches += 1
    if use_bf16:
        # the cast W, transposed, for the bf16 core
        wt = torch.empty((cout, kp * cin), dtype=torch.bfloat16, device=dev)
        fn = lib.kpconv_fwd_bf16_launch
        fn.argtypes, fn.restype = _BF16_ARGTYPES, ctypes.c_int
        status = fn(*head, y.data_ptr(), wt.data_ptr(), out.data_ptr(),
                    *workspace_args(ws), stream)
    else:
        fn = lib.kpconv_fwd_launch
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        status = fn(*head, y.data_ptr(), out.data_ptr(), *workspace_args(ws),
                    stream)
    check(status, name)
    return out, y


def kpconv_fwd_with_y(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                      kp_extent: float, influence: str = "linear",
                      compute_dtype: str = "float32"):
    """(out [B, Nq, Cout], y [B*Nq, Kp*Cin]) of the rigid KPConv forward
    (y bf16 under compute_dtype "bfloat16"). A CPU tensor runs
    `kpconv_fwd_plain_with_y`; a CUDA tensor launches the kernel (its bf16
    variant under "bfloat16") or raises."""
    if q_pts.device.type == "cpu":
        return kpconv_fwd_plain_with_y(q_pts, s_pts, neighb_inds, x,
                                       kernel_points, weights, kp_extent,
                                       influence, compute_dtype)
    if not q_pts.is_cuda:
        raise ValueError(f"kpconv_fwd runs on cpu or cuda tensors, got "
                         f"{q_pts.device}")
    return _launch(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                   kp_extent, influence, compute_dtype)


def kpconv_fwd(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
               kp_extent: float, influence: str = "linear", band: int = 0,
               tile: int = 128, pblk_skip: bool = False,
               compute_dtype: str = "float32"):
    """Rigid KPConv forward over a padded sphere batch.

    :param q_pts: [B, Nq, 3]; s_pts: [B, Ns, 3]; neighb_inds: [B, Nq, K]
        int32 (>= Ns = shadow); x: [B, Ns, Cin]; kernel_points: [Kp, 3];
        weights: [Kp, Cin, Cout]; all f32 except the indices
    :param compute_dtype: "float32" or "bfloat16" (the products' inputs
        rounded to bf16, as the JAX package's XLA path)
    :return: (out [B, Nq, Cout] f32, oob [B] f32, always 0)

    A CPU tensor runs `kpconv_fwd_plain`; a CUDA tensor launches the
    kernel or raises. band, tile and pblk_skip are ignored.
    """
    out, _ = kpconv_fwd_with_y(q_pts, s_pts, neighb_inds, x, kernel_points,
                               weights, kp_extent, influence, compute_dtype)
    oob = torch.zeros(q_pts.shape[0], dtype=torch.float32,
                      device=q_pts.device)
    return out, oob


kpconv_fwd.launches = 0
