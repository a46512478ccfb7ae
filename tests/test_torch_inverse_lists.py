"""The inverse-list build and the fixed-order row sums
(weasal_tpu_torch/csrc/inverse_lists.cuh) on the CPU: plain emulations of
the kernels' rules held to what the kernels promise, and the plain
versions held to `scatter_add_` / `index_add_` and to the JAX package's
voxel sums.

- The build's placement rule: per-support counts whose atomics run in an
  arbitrary order (a seeded permutation stands for the order the atomics
  give), each slot's arrival the count it found; each tile's offsets, a
  scan of its counts plus the sums of the tiles before it (the scan's
  carries); each slot at its segment's offset plus its arrival; then
  each segment's slots written at their ranks, counted 32 slots a pass
  (a warp's passes of shuffles). Equal to the stable
  sort's lists on random, skewed, duplicated, all-shadow and empty
  inputs, segments far past 32 slots among them, at the kernel's tile of
  2048 counts and at a tile of 16 (many carries on small inputs).
- The row sums' lane mapping: each row served by a group of G lanes
  (the whole warp above C = 16, 1, 2 or 4 lanes at or below), each lane
  P chunks of VEC channels, the entries' loads U at a time. Every
  (row, channel) is written by one lane, and each row's terms add in
  list order: equal bit for bit to the sums added rank by rank.
- The plain versions: `inverse_sum` and `run_sums` on CPU tensors equal
  `index_add_` / `scatter_add_` and the sums in list order bit for bit,
  and the voxel sums equal the JAX package's `.at[seg].add` of
  `grid_subsample_fixed` (weasal_tpu/ops/subsample.py:183-201) on the
  same seeded points.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weasal_tpu.ops.subsample import grid_extent_cells
from weasal_tpu_torch.ops.cuda.inverse_lists import (
    build_inverse_lists, build_inverse_lists_plain, inverse_sum,
    inverse_sum_plain, run_sums, run_sums_plain)
from tests._inverse_cases import CASES, index_case, ordered_row_sums
from tests._warm_torch import cpu_torch

SCAN_TILE = 2048            # kScanTile of inverse_lists.cuh


@pytest.fixture(autouse=True, scope="module")
def _cpu_torch():
    with cpu_torch():
        yield


def emulate_build(nb, ns, k, tile, seed):
    """(offsets, entries) by the phases of `inverse_build_kernel`."""
    nb = nb.numpy().astype(np.int64)
    b, nq, ld = nb.shape
    segs, slots = b * ns, b * nq * k
    i = np.arange(slots)
    row, j = i // k, i % k
    s = nb.reshape(-1)[row * ld + j] if slots else np.zeros(0, np.int64)
    sup = np.where((s >= 0) & (s < ns), row // max(nq, 1) * ns + s, -1)
    # 0. counts, each slot's arrival the count it found, the atomics in
    # an arbitrary order of the slots
    count = np.zeros(segs, np.int64)
    arrival = np.zeros(slots, np.int64)
    for x in np.random.default_rng(seed).permutation(slots):
        if sup[x] >= 0:
            arrival[x] = count[sup[x]]
            count[sup[x]] += 1
    # 1. each tile: a scan of its counts plus the sums of the tiles before
    n_tiles = max(1, math.ceil(segs / tile))
    tile_sum = [int(count[t * tile:(t + 1) * tile].sum())
                for t in range(n_tiles)]
    off = np.zeros(segs + 1, np.int64)
    for t in range(n_tiles):
        c = count[t * tile:(t + 1) * tile]
        run = sum(tile_sum[:t]) + np.cumsum(c)
        off[t * tile:t * tile + len(c)] = run - c
        if t == n_tiles - 1:
            off[segs] = run[-1] if len(c) else sum(tile_sum[:t])
    # 2. fill: each slot at its segment's offset plus its arrival
    fill = np.full(slots, -1, np.int64)
    real = sup >= 0
    fill[off[sup[real]] + arrival[real]] = i[real]
    # 3. order: each slot at its rank in its segment, 32 slots a pass
    ent = np.full(slots, -1, np.int64)
    for g in range(segs):
        lo, n = off[g], off[g + 1] - off[g]
        vals = fill[lo:lo + n]
        for b0 in range(0, n, 32):
            mine = vals[b0:b0 + 32]
            rank = np.zeros(len(mine), np.int64)
            for c0 in range(0, n, 32):
                rank += (vals[None, c0:c0 + 32] < mine[:, None]).sum(1)
            ent[lo + rank] = mine
    assert not (fill[:off[segs]] < 0).any()
    return off, ent, fill


@pytest.mark.parametrize("tile", [16, SCAN_TILE])
@pytest.mark.parametrize("case", list(CASES))
def test_build_placement_rule_equals_stable_sort(case, tile):
    nb, ns, k = index_case(case)
    k = nb.shape[2] if k is None else k
    off, ent, fill = emulate_build(nb, ns, k, tile, seed=1)
    want = build_inverse_lists_plain(nb, ns, k)
    total = int(want.offsets[-1])
    assert np.array_equal(off, want.offsets.numpy())
    assert np.array_equal(ent[:total], want.entries[:total].numpy())
    assert torch.equal(build_inverse_lists(nb, ns, k).offsets, want.offsets)
    lengths = np.diff(off)
    if case in ("hot", "skewed", "random"):
        # long segments, and a fill order that the ranks had to repair
        assert lengths.max() > 32
        assert not np.array_equal(fill[:total], ent[:total])


def row_shape(c_dim):
    """(VEC, G, P) of `with_row_shape` for an aligned src and dst."""
    if c_dim <= 16:
        g = {1: 1, 2: 2}.get(c_dim, 4)
        return 1, g, 1 if c_dim <= 4 else 2 if c_dim <= 8 else 4
    vec = 4 if c_dim % 4 == 0 and c_dim >= 128 else \
        2 if c_dim % 2 == 0 and c_dim >= 64 else 1
    chunks = math.ceil(c_dim / (32 * vec))
    return vec, 32, 1 if chunks <= 1 else 2 if chunks <= 2 else 4


def emulate_row_sums(src, offsets, entries, rows):
    """The row sums lane by lane as `row_sum` maps them: (sums, times
    each (row, channel) was written)."""
    c_dim = src.shape[1]
    vec, g, p = row_shape(c_dim)
    u = 2 if p * vec >= 16 else 4
    per_warp = 32 // g
    out = torch.zeros((rows, c_dim))
    written = torch.zeros((rows, c_dim), dtype=torch.int64)
    for warp in range(math.ceil(rows / per_warp)):
        for lane in range(32):
            row, lane_g = warp * per_warp + lane // g, lane % g
            if row >= rows:
                continue
            e0, e1 = int(offsets[row]), int(offsets[row + 1])
            if g == 32:
                # 32 entries at a time: whole groups of u, then singles
                groups = []
                for base in range(e0, e1, 32):
                    n = min(32, e1 - base)
                    whole = n - n % u
                    groups += [(base + j, base + j + u)
                               for j in range(0, whole, u)]
                    groups += [(base + j, base + j + 1)
                               for j in range(whole, n)]
            else:
                groups = [(e, min(e + u, e1)) for e in range(e0, e1, u)]
            for c0 in range(0, c_dim, g * p * vec):
                chans = [c0 + (q * g + lane_g) * vec + v for q in range(p)
                         for v in range(vec)
                         if c0 + (q * g + lane_g) * vec < c_dim]
                acc = torch.zeros(len(chans))
                for lo, hi in groups:
                    vals = src[entries[lo:hi].long()][:, chans]
                    for val in vals:             # loaded together, added
                        acc = acc + val          # one at a time, in order
                out[row, chans] = acc
                written[row, chans] += 1
    return out, written


@pytest.mark.parametrize("c_dim", [1, 2, 3, 5, 9, 16, 36, 64, 128, 256,
                                   512])
def test_row_sum_lane_groups_add_in_list_order(c_dim):
    gen = torch.Generator().manual_seed(c_dim)
    nb = torch.randint(0, 41, (2, 40, 9), generator=gen, dtype=torch.int32)
    nb[0, :, 1] = 3                                # a segment of 40 slots
    inv = build_inverse_lists_plain(nb, 40)
    src = torch.randn((nb.numel(), c_dim), generator=gen)
    got, written = emulate_row_sums(src, inv.offsets, inv.entries, 80)
    assert torch.equal(written, torch.ones_like(written))
    assert torch.equal(got, ordered_row_sums(src, inv.offsets, inv.entries,
                                             80))


@pytest.mark.parametrize("c_dim", [3, 9, 64])
@pytest.mark.parametrize("case", ["hot", "duplicates", "all_shadows",
                                  "k1_of_wider", "no_slots"])
def test_inverse_sum_plain_equals_index_add(case, c_dim):
    """On the CPU `inverse_sum` is `index_add_`, which adds in index
    order: equal to each support's slots summed into it one at a time and
    to the sums in list order, bit for bit."""
    nb, ns, k = index_case(case)
    k = nb.shape[2] if k is None else k
    b, nq = nb.shape[:2]
    src = torch.randn((b * nq * k, c_dim),
                      generator=torch.Generator().manual_seed(3))
    inv = build_inverse_lists(nb, ns, k)
    got = inverse_sum(src, inv, b * ns)
    assert torch.equal(got, inverse_sum_plain(src, inv, b * ns))
    want = torch.zeros((b * ns + 1, c_dim))
    s = nb[:, :, :k].long()
    dst = torch.where((s >= 0) & (s < ns),
                      s + torch.arange(b)[:, None, None] * ns,
                      torch.full_like(s, b * ns)).reshape(-1)
    want.index_add_(0, dst, src)
    assert torch.equal(got, want[:b * ns])
    assert torch.equal(got, ordered_row_sums(src, inv.offsets, inv.entries,
                                             b * ns))


def _sorted_runs(seed, b=3, n=900, dl=0.5, max_out=400):
    """The grid subsample's sorted points and voxel runs of seeded
    spheres, by the JAX package's steps (subsample.py:179-195)."""
    rng = np.random.default_rng(seed)
    pts = (rng.random((b, n, 3)) * 8 - 4).astype(np.float32)
    mask = rng.random((b, n)) < 0.8
    n_cells = grid_extent_cells(4.0, dl)
    big = n_cells ** 3
    srcs, segs = [], []
    for p, m in zip(jnp.asarray(pts), jnp.asarray(mask)):
        origin = jnp.min(jnp.where(m[:, None], p, jnp.inf), axis=0)
        vox = jnp.clip(jnp.floor((p - origin) / dl).astype(jnp.int32), 0,
                       n_cells - 1)
        lin = (vox[:, 0] * n_cells + vox[:, 1]) * n_cells + vox[:, 2]
        lin = jnp.where(m, lin, big)
        order = jnp.argsort(lin)
        sorted_lin, sorted_pts = lin[order], p[order]
        valid = sorted_lin < big
        is_new = jnp.concatenate([jnp.ones((1,), bool),
                                  sorted_lin[1:] != sorted_lin[:-1]]) & valid
        seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
        segs.append(np.asarray(jnp.where(valid, jnp.minimum(seg, max_out),
                                         max_out)))
        srcs.append(np.asarray(jnp.where(valid[:, None], sorted_pts, 0.0)))
    return np.stack(srcs), np.stack(segs)


@pytest.mark.parametrize("dl,max_out", [(0.5, 400), (0.9, 60)])
def test_voxel_sums_equal_jax_at_seg_add(dl, max_out):
    """`run_sums` on the CPU (and its plain version) against the JAX
    package's `.at[seg].add` sums and counts on the same sorted points,
    bit for bit, and against the sums in list order; the second case
    drops voxels past max_out."""
    src, seg = _sorted_runs(11, dl=dl, max_out=max_out)
    want_sums = np.stack([
        np.asarray(jnp.zeros((max_out + 1, 3), jnp.float32).at[s].add(x))
        for x, s in zip(src, seg)])[:, :max_out]
    want_counts = np.stack([
        np.asarray(jnp.zeros((max_out + 1,), jnp.float32).at[s].add(
            (s < max_out).astype(np.float32)))
        for s in seg])[:, :max_out]
    src_t, seg_t = torch.from_numpy(src), torch.from_numpy(seg).long()
    sums, counts = run_sums(src_t, seg_t, max_out)
    plain = run_sums_plain(src_t, seg_t, max_out)
    assert torch.equal(sums, plain[0]) and torch.equal(counts, plain[1])
    assert np.array_equal(sums.numpy(), want_sums)
    assert np.array_equal(counts.numpy(), want_counts)
    b, n = seg.shape
    runs = build_inverse_lists_plain(
        seg_t.clamp(max=max_out).to(torch.int32)[..., None], max_out, 1)
    ordered = ordered_row_sums(src_t.reshape(b * n, 3), runs.offsets,
                               runs.entries, b * max_out)
    assert torch.equal(sums.reshape(-1, 3), ordered)
    assert int((counts > 0).sum()) > b * 10
