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
"""

from __future__ import annotations

import ctypes

import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library
from weasal_tpu_torch.ops.subsample import SHADOW_COORD

INFLUENCES = {"constant": 0, "linear": 1, "gaussian": 2}
MAX_KP = 16
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p])


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
                            influence: str = "linear"):
    """Rigid sum-aggregation KPConv: (out [B, Nq, Cout], y [B*Nq, Kp*Cin]),
    y the per-kernel-point aggregate that the backward's dW reads."""
    all_weights = neighbor_influences(q_pts, s_pts, neighb_inds,
                                      kernel_points, kp_extent, influence)
    neighb_x = gather_neighbors(x, neighb_inds, 0.0)         # [B,Nq,K,Cin]
    weighted = torch.einsum("bqpk,bqkc->bqpc", all_weights, neighb_x)
    b, nq = weighted.shape[:2]
    kp, cin, cout = weights.shape
    y = weighted.reshape(b * nq, kp * cin)
    out = y @ weights.reshape(kp * cin, cout)
    return out.reshape(b, nq, cout), y


def kpconv_fwd_plain(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                     kp_extent: float, influence: str = "linear"):
    """Rigid sum-aggregation KPConv: [B, Nq, Cout]."""
    return kpconv_fwd_plain_with_y(q_pts, s_pts, neighb_inds, x,
                                   kernel_points, weights, kp_extent,
                                   influence)[0]


def check_kpconv_inputs(what: str, tensors, q_pts, s_pts, neighb_inds,
                       kernel_points, weights, cin: int) -> None:
    """Raise unless every (name, tensor, dtype) of `tensors` lies on
    q_pts's device with that dtype, contiguous, and the shapes are
    q [B,Nq,3], s [B,Ns,3], nb [B,Nq,K], kp [Kp,3], W [Kp,Cin,Cout] with
    1 <= Kp <= MAX_KP and K small enough for the influence tile."""
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
    if not 1 <= kp <= MAX_KP:
        raise ValueError(f"{what} takes 1..{MAX_KP} kernel points, "
                         f"got {kp}")
    if (kp * k + k) * 4 > 48 * 1024:
        raise ValueError(f"neighbor width {k} too large for {kp} kernel "
                         "points")


def _launch(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
            kp_extent, influence):
    b, nq, _ = q_pts.shape
    ns, cin = x.shape[1:]
    kp, _, cout = weights.shape
    k = neighb_inds.shape[2]
    if influence not in INFLUENCES:
        raise ValueError(f"Unknown KP influence: {influence}")
    check_kpconv_inputs(
        "kpconv_fwd", (("q_pts", q_pts, torch.float32),
                       ("s_pts", s_pts, torch.float32),
                       ("neighb_inds", neighb_inds, torch.int32),
                       ("x", x, torch.float32),
                       ("kernel_points", kernel_points, torch.float32),
                       ("weights", weights, torch.float32)),
        q_pts, s_pts, neighb_inds, kernel_points, weights, cin)
    if tuple(x.shape[:2]) != (b, ns):
        raise ValueError("expected x [B,Ns,Cin]")
    out = torch.empty((b, nq, cout), dtype=torch.float32,
                      device=q_pts.device)
    y = torch.empty((b * nq, kp * cin), dtype=torch.float32,
                    device=q_pts.device)
    if b * nq == 0:
        return out, y
    lib = load_library("kpconv_fwd")
    ws = workspace(lib, "kpconv_fwd", b * nq, kp * cin, cout,
                   device=q_pts.device)
    fn = lib.kpconv_fwd_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    kpconv_fwd.launches += 1
    check(fn(q_pts.data_ptr(), s_pts.data_ptr(), neighb_inds.data_ptr(),
             x.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
             b, nq, ns, k, kp, cin, cout, float(kp_extent),
             INFLUENCES[influence], gaussian_denominator(kp_extent),
             y.data_ptr(), out.data_ptr(), *workspace_args(ws),
             torch.cuda.current_stream(q_pts.device).cuda_stream),
          "kpconv_fwd")
    return out, y


def kpconv_fwd_with_y(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                      kp_extent: float, influence: str = "linear"):
    """(out [B, Nq, Cout], y [B*Nq, Kp*Cin]) of the rigid KPConv forward.
    A CPU tensor runs `kpconv_fwd_plain_with_y`; a CUDA tensor launches
    the kernel or raises."""
    if q_pts.device.type == "cpu":
        return kpconv_fwd_plain_with_y(q_pts, s_pts, neighb_inds, x,
                                       kernel_points, weights, kp_extent,
                                       influence)
    if not q_pts.is_cuda:
        raise ValueError(f"kpconv_fwd runs on cpu or cuda tensors, got "
                         f"{q_pts.device}")
    return _launch(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                   kp_extent, influence)


def kpconv_fwd(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
               kp_extent: float, influence: str = "linear", band: int = 0,
               tile: int = 128, pblk_skip: bool = False):
    """Rigid KPConv forward over a padded sphere batch.

    :param q_pts: [B, Nq, 3]; s_pts: [B, Ns, 3]; neighb_inds: [B, Nq, K]
        int32 (>= Ns = shadow); x: [B, Ns, Cin]; kernel_points: [Kp, 3];
        weights: [Kp, Cin, Cout]; all f32 except the indices
    :return: (out [B, Nq, Cout] f32, oob [B] f32, always 0)

    A CPU tensor runs `kpconv_fwd_plain`; a CUDA tensor launches the
    kernel or raises. band, tile and pblk_skip are ignored.
    """
    out, _ = kpconv_fwd_with_y(q_pts, s_pts, neighb_inds, x, kernel_points,
                               weights, kp_extent, influence)
    oob = torch.zeros(q_pts.shape[0], dtype=torch.float32,
                      device=q_pts.device)
    return out, oob


kpconv_fwd.launches = 0
