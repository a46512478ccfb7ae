"""Inverse neighbor lists and fixed-order row sums (csrc/inverse_lists.cu).

The dX of kernels C and D, and every other sum of the training step whose
plain PyTorch form is a scatter-add, add their terms in a fixed order on
the card, so that a seeded run repeats bit for bit as the JAX package's
does (its Pallas kernels sum by membership products, XLA's scatter-adds
run in order on one TPU core). A scatter-add on CUDA adds with f32
atomics in the order the threads reach them.

- `build_inverse_lists(inds, ns, k)`: for index rows inds [B, Nq, >=k]
  (column j < k; an index outside 0..ns-1 is a shadow), each support's
  slots (b*Nq + q)*k + j in ascending order, as CSR offsets [B*ns + 1]
  and entries. Kernel: a memset and one launch in four phases (an
  atomic count that gives each slot an arrival in its segment, a
  multi-block scan, a fill at offset + arrival into scratch, then each
  segment's slots written at their ranks by one warp); plain version: a
  stable sort of the slots by support.
- `inverse_sum(src, inv, rows)`: row r of the result is the sum of the
  rows src[e] over r's list, added in the list's order from 0.0. Kernel:
  a group of lanes per row (a warp for C > 16, 1-4 lanes below);
  plain version: `index_add_` (in order on the CPU).
- `run_sums(src, seg, n_out)`: the sums of src [B, N, C] over the runs of
  equal values of a non-decreasing seg [B, N] (the grid subsample's
  voxels), and the runs' lengths. Kernel: the row sums with each run's
  bounds found by binary search in the launch, which writes the lengths
  too; plain version: `scatter_add_`.
- `GatherRows`: x[b, inds[b, q, j]] (a zero row for a shadow) whose
  backward is `inverse_sum` over the inverse lists on the card and
  `scatter_rows` (`index_add_`, in order on the CPU) elsewhere, which is
  also the plain version of C's and D's dX.

`LazyInverse` builds a tensor's inverse lists on first use and keeps
them: a pyramid batch holds one per edge (data/batch.PyramidBatch), which
the convs, pools and gathers on that edge share, and it is built only
where a backward on the card asks for it. The caller makes it: a
backward on the card that is given none raises (`require_lists`).

The kernels are bounded by bytes (indices and rows read once, rows
written once); both read nothing back to the host, so a CUDA graph
captures them. A CPU tensor runs the plain versions; a CUDA tensor
launches the kernels or raises. Each C function is resolved, with its
argument types, once per process (`_c_function`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from weasal_tpu_torch.ops.cuda.build import check, load_library
from weasal_tpu_torch.ops.cuda import kpconv_fwd
from weasal_tpu_torch.utils.device import use_kernel


_C_ARGS = {
    "inverse_lists_build_scratch_words": (ctypes.c_longlong,
                                          [ctypes.c_longlong] * 2),
    "inverse_lists_build_launch": (
        ctypes.c_int, [ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3),
    "inverse_sum_launch": (ctypes.c_int, [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_int]
                           + [ctypes.c_void_p] * 2),
    "run_sums_launch": (ctypes.c_int, [ctypes.c_void_p] + [ctypes.c_int] * 3
                        + [ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 3),
}
_c_functions = {}


def _c_function(name: str):
    """The C function `name` of the library, its types set once."""
    fn = _c_functions.get(name)
    if fn is None:
        fn = getattr(load_library("inverse_lists"), name)
        fn.restype, fn.argtypes = _C_ARGS[name]
        _c_functions[name] = fn
    return fn


class InverseLists(NamedTuple):
    """CSR inverse of an index tensor: support r's slots are
    entries[offsets[r]:offsets[r + 1]], in ascending order."""
    offsets: torch.Tensor     # [B*ns + 1] int32
    entries: torch.Tensor     # [B*Nq*k] int32 (the first offsets[-1] used)


def _support_keys(inds: torch.Tensor, ns: int, k: int) -> torch.Tensor:
    """[B*Nq*k] int64: b*ns + s for each slot, B*ns for a shadow."""
    b = inds.shape[0]
    s = inds[:, :, :k].to(torch.int64)
    base = (torch.arange(b, device=inds.device, dtype=torch.int64)
            * ns)[:, None, None]
    keys = torch.where((s >= 0) & (s < ns), s + base,
                       torch.full_like(s, b * ns))
    return keys.reshape(-1)


def build_inverse_lists_plain(inds: torch.Tensor, ns: int,
                              k: Optional[int] = None) -> InverseLists:
    """The inverse lists by a stable sort of the slots by support."""
    k = inds.shape[2] if k is None else k
    keys = _support_keys(inds, ns, k)
    sorted_keys, order = torch.sort(keys, stable=True)
    bounds = torch.arange(inds.shape[0] * ns + 1, device=inds.device,
                          dtype=torch.int64)
    offsets = torch.searchsorted(sorted_keys, bounds)
    return InverseLists(offsets.to(torch.int32), order.to(torch.int32))


def build_inverse_lists(inds: torch.Tensor, ns: int,
                        k: Optional[int] = None) -> InverseLists:
    """Inverse lists of inds [B, Nq, ld] int32 over its first k columns
    (default all) for ns supports per sphere; see the module docstring."""
    k = inds.shape[2] if k is None else k
    if not use_kernel(inds):
        return build_inverse_lists_plain(inds, ns, k)
    if inds.dtype != torch.int32 or inds.dim() != 3 \
            or not inds.is_contiguous():
        raise ValueError("build_inverse_lists takes contiguous int32 "
                         "[B, Nq, ld] indices")
    if not 1 <= k <= inds.shape[2]:
        raise ValueError(f"k={k} outside 1..{inds.shape[2]}")
    b, nq, ld = inds.shape
    dev = inds.device
    words = _c_function("inverse_lists_build_scratch_words")(b * ns,
                                                            b * nq * k)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    offsets = torch.empty(b * ns + 1, dtype=torch.int32, device=dev)
    entries = torch.empty(max(b * nq * k, 1), dtype=torch.int32, device=dev)
    build_inverse_lists.launches += 1
    check(_c_function("inverse_lists_build_launch")(
        inds.data_ptr(), b, nq, k, ld, ns, scratch.data_ptr(), words,
        offsets.data_ptr(), entries.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream), "build_inverse_lists")
    return InverseLists(offsets, entries)


build_inverse_lists.launches = 0


class LazyInverse:
    """The inverse lists of `inds` (its first k columns, ns supports),
    built at the first `get()` and kept."""

    def __init__(self, inds: torch.Tensor, ns: int,
                 k: Optional[int] = None):
        self.inds, self.ns, self.k = inds, int(ns), k
        self._lists: Optional[InverseLists] = None

    def get(self) -> InverseLists:
        if self._lists is None:
            inds = self.inds
            if inds.dtype != torch.int32 or not inds.is_contiguous():
                inds = inds.to(torch.int32).contiguous()
            self._lists = build_inverse_lists(inds, self.ns, self.k)
        return self._lists


def require_lists(inverse: Optional[LazyInverse], rows: int,
                  name: str) -> InverseLists:
    """The lists of `inverse`, checked to hold `rows` supports. A dX on
    the card sums over them, so its caller passes them: the batch's
    (data/batch.PyramidBatch.inverse) on the main path, a LazyInverse of
    the same indices elsewhere."""
    if inverse is None:
        raise ValueError(f"{name} on the card takes the inverse lists of "
                         "its indices: inverse=LazyInverse(inds, ns)")
    inv = inverse.get()
    if inv.offsets.shape[0] != rows + 1:
        raise ValueError(f"{name}: inverse lists of another shape than "
                         "the indices'")
    return inv


def segment_ids(offsets: torch.Tensor, n_entries: int) -> torch.Tensor:
    """[n_entries] int64: the row of each list entry (entries past the
    last list get the row count)."""
    rows = offsets.shape[0] - 1
    pos = torch.arange(n_entries, device=offsets.device, dtype=torch.int64)
    return torch.searchsorted(offsets.to(torch.int64), pos, right=True) - 1 \
        if rows > 0 else torch.zeros_like(pos)


def inverse_sum_plain(src: torch.Tensor, inv: InverseLists,
                      rows: int) -> torch.Tensor:
    """[rows, C]: each row's list of src rows summed by `index_add_`."""
    n = inv.entries.shape[0]
    seg = segment_ids(inv.offsets, n)
    keep = seg < rows
    out = torch.zeros((rows + 1, src.shape[1]), dtype=src.dtype,
                      device=src.device)
    out.index_add_(0, torch.where(keep, seg, torch.full_like(seg, rows)),
                   src.index_select(0, inv.entries.long().clamp(
                       0, max(src.shape[0] - 1, 0))))
    return out[:rows]


def _check_src(src: torch.Tensor):
    if src.dtype != torch.float32 or src.dim() != 2 \
            or not src.is_contiguous():
        raise ValueError("inverse_sum takes contiguous f32 [E, C] rows")


def inverse_sum(src: torch.Tensor, inv: InverseLists,
                rows: int) -> torch.Tensor:
    """[rows, C]: row r = the sum of src[e] over r's list, in its order
    from 0.0 (see the module docstring)."""
    if not use_kernel(src):
        return inverse_sum_plain(src, inv, rows)
    _check_src(src)
    if inv.offsets.shape[0] != rows + 1:
        raise ValueError(f"{inv.offsets.shape[0] - 1} lists for {rows} rows")
    dst = torch.empty((rows, src.shape[1]), dtype=torch.float32,
                      device=src.device)
    inverse_sum.launches += 1
    check(_c_function("inverse_sum_launch")(
        inv.offsets.data_ptr(), inv.entries.data_ptr(), src.data_ptr(),
        rows, src.shape[1], dst.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream), "inverse_sum")
    return dst


inverse_sum.launches = 0


def run_sums_plain(src: torch.Tensor, seg: torch.Tensor, n_out: int):
    """(sums [B, n_out, C], counts [B, n_out]) by `scatter_add_`; a seg
    value of n_out or more is dropped."""
    b, n, c = src.shape
    seg = seg.clamp(max=n_out)
    sums = torch.zeros((b, n_out + 1, c), dtype=src.dtype, device=src.device)
    sums.scatter_add_(1, seg[..., None].expand(b, n, c), src)
    counts = torch.zeros((b, n_out + 1), dtype=src.dtype, device=src.device)
    counts.scatter_add_(1, seg, torch.ones_like(src[..., 0]))
    return sums[:, :n_out], counts[:, :n_out]


def run_sums(src: torch.Tensor, seg: torch.Tensor, n_out: int):
    """(sums [B, n_out, C], counts [B, n_out] as src's dtype) of the runs
    of src [B, N, C] rows over a non-decreasing seg [B, N] (values >=
    n_out dropped), each summed in row order from 0.0."""
    if not use_kernel(src):
        return run_sums_plain(src, seg, n_out)
    b, n, c = src.shape
    flat = src.reshape(b * n, c)
    _check_src(flat)
    if seg.dtype != torch.int64 or tuple(seg.shape) != (b, n) \
            or not seg.is_contiguous():
        raise ValueError("run_sums takes a contiguous int64 [B, N] seg")
    sums = torch.empty((b, n_out, c), dtype=torch.float32, device=src.device)
    counts = torch.empty((b, n_out), dtype=torch.float32, device=src.device)
    inverse_sum.launches += 1
    check(_c_function("run_sums_launch")(
        seg.data_ptr(), b, n, n_out, flat.data_ptr(), c, sums.data_ptr(),
        counts.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream),
        "run_sums")
    return sums, counts


def scatter_rows(values: torch.Tensor, inds: torch.Tensor,
                 ns: int) -> torch.Tensor:
    """Sum [B, Nq, K, D] values into [B, Ns, D] rows by the sphere-local
    indices [B, Nq, K]; a shadow index (outside 0..Ns-1) is dropped."""
    b, nq, k, d = values.shape
    inds = inds.to(torch.int64)
    rows = torch.where((inds >= 0) & (inds < ns), inds,
                       torch.full_like(inds, ns))
    offs = (torch.arange(b, device=inds.device, dtype=torch.int64)
            * (ns + 1))[:, None, None]
    out = torch.zeros((b * (ns + 1), d), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, (rows + offs).reshape(-1), values.reshape(-1, d))
    return out.reshape(b, ns + 1, d)[:, :ns]


class GatherRows(torch.autograd.Function):
    """[B, Ns, D] values gathered by [B, Nq, >=k] indices (first k
    columns; a shadow gives a zero row) -> [B, Nq, k, D]. Its backward
    sums each support's rows over its inverse lists on the card
    (`inverse`, a LazyInverse of the same indices, shared by the callers
    on one edge), by `index_add_` on the CPU."""

    @staticmethod
    def forward(ctx, values, inds, k: int, inverse: Optional[LazyInverse]):
        ctx.kernel = use_kernel(values)
        ctx.save_for_backward(inds)
        ctx.k, ctx.ns, ctx.inverse = k, values.shape[1], inverse
        return kpconv_fwd.gather_neighbors(values, inds[:, :, :k], 0.0)

    @staticmethod
    def backward(ctx, g):
        (inds,) = ctx.saved_tensors
        g = g.contiguous()
        if not ctx.kernel:
            return scatter_rows(g, inds[:, :, :ctx.k], ctx.ns), None, None, \
                None
        b, d = g.shape[0], g.shape[-1]
        inv = require_lists(ctx.inverse, b * ctx.ns, "gather_rows")
        dx = inverse_sum(g.reshape(-1, d), inv, b * ctx.ns)
        return dx.reshape(b, ctx.ns, d), None, None, None


def gather_rows(values: torch.Tensor, inds: torch.Tensor,
                k: Optional[int] = None,
                inverse: Optional[LazyInverse] = None) -> torch.Tensor:
    """`GatherRows` of values by the first k columns of inds."""
    k = inds.shape[2] if k is None else k
    return GatherRows.apply(values, inds, k, inverse)
