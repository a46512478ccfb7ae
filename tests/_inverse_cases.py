"""Index tensors that stress the inverse-list build and the fixed-order
row sums (weasal_tpu_torch/csrc/inverse_lists.cuh), the order the row
sums promise, in plain PyTorch, and the replay of a captured CUDA graph
that the build is held to. JAX-free: shared by the CPU tests
(tests/test_torch_inverse_lists.py), the card tests
(tests/test_torch_cuda.py) and chip_smoke.py's checks of the build and
the row sums."""

import numpy as np
import torch


def _hot(rng):
    """A support referenced by thousands of slots (segments far past 32
    slots), B*Ns a multiple of no tile."""
    nb = rng.integers(0, 997, (3, 701, 16))
    nb[rng.random(nb.shape) < 0.4] = 5
    return nb, 997, None


def _skewed(rng):
    """Geometric support choice: a few long segments, many short ones."""
    nb = np.minimum(rng.geometric(0.02, (2, 900, 12)) - 1, 600)
    return nb, 601, None


def _duplicates(rng):
    """Repeated supports within rows, shadows on both sides (-1, >= Ns)."""
    nb = rng.integers(-2, 40, (2, 333, 9))
    nb[:, ::3] = nb[:, ::3, :1]
    return nb, 37, None


def _all_shadows(rng):
    return np.full((3, 513, 9), 1201), 1201, None


def _k1_of_wider(rng):
    """The first column of rows of 7, as an upsample edge uses it."""
    return rng.integers(0, 612, (3, 1001, 7)), 611, 1


def _no_slots(rng):
    return np.zeros((2, 0, 4)), 33, None


def _no_supports(rng):
    return rng.integers(0, 3, (2, 5, 3)), 0, None


def _random(rng):
    return rng.integers(0, 1501, (3, 2000, 12)), 1500, None


CASES = {"hot": _hot, "skewed": _skewed, "duplicates": _duplicates,
         "all_shadows": _all_shadows, "k1_of_wider": _k1_of_wider,
         "no_slots": _no_slots, "no_supports": _no_supports,
         "random": _random}


def run_case(seed=0):
    """(seg [3, 1001] int64 tensor on the CPU, n_out): voxel runs of a
    non-decreasing seg as the grid subsample gives them, one of 400 rows,
    rows dropped past n_out (value n_out) and a sphere with no run."""
    b, n, n_out = 3, 1001, 350
    new = np.random.default_rng(seed).random((b, n)) < 0.3
    new[:, 0] = True
    new[1, 100:500] = False                       # one run of 400 rows
    seg = np.cumsum(new, axis=1) - 1
    seg[0, 700:] = n_out                          # dropped rows
    seg[2] = n_out                                # a sphere with no run
    return torch.from_numpy(np.minimum(seg, n_out).astype(np.int64)), n_out


def index_case(name, seed=0):
    """(nb [B, Nq, ld] int32 tensor on the CPU, ns, k) of case `name`."""
    nb, ns, k = CASES[name](np.random.default_rng(seed))
    return torch.from_numpy(np.ascontiguousarray(nb, dtype=np.int32)), ns, k


def ordered_row_sums(src, offsets, entries, rows):
    """[rows, C]: row r = the rows src[entries[e]] over r's list
    [offsets[r], offsets[r + 1]) added one at a time in list order from
    0.0, rank by rank (one f32 add per rank, rounded to nearest): the
    order the row-sum kernels promise."""
    offsets = offsets.long()
    dev = src.device
    counts = offsets[1:] - offsets[:-1]
    total = int(offsets[-1])
    seg = torch.repeat_interleave(torch.arange(rows, device=dev), counts)
    rank = torch.arange(total, device=dev) - offsets[seg]
    ent = entries[:total].long()
    out = torch.zeros((rows, src.shape[1]), dtype=src.dtype, device=dev)
    for j in range(int(counts.max()) if rows else 0):
        at = (rank == j).nonzero().squeeze(1)
        dst = seg[at]
        out[dst] = out[dst] + src[ent[at]]
    return out


def ordered_run_sums(src, seg, n_out):
    """(sums [B, n_out, C], counts [B, n_out]) of `run_sums` by
    `ordered_row_sums` over the runs' lists: the plain build of seg as
    [B, N, 1] indices over n_out supports (a value >= n_out a shadow),
    whose slots are the flat rows."""
    from weasal_tpu_torch.ops.cuda.inverse_lists import (
        build_inverse_lists_plain)
    b, n, c = src.shape
    lists = build_inverse_lists_plain(
        seg.clamp(max=n_out).to(torch.int32)[..., None], n_out, 1)
    sums = ordered_row_sums(src.reshape(b * n, c), lists.offsets,
                            lists.entries, b * n_out)
    counts = (lists.offsets[1:] - lists.offsets[:-1]).to(src.dtype)
    return sums.reshape(b, n_out, c), counts.reshape(b, n_out)


def graph_replay(fn):
    """fn()'s tensors as one replay of fn() captured in a CUDA graph
    computes them (after an eager warm-up on the capture's stream)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    out = [t.clone() for t in out]
    del graph
    return out
