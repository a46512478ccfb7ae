"""Times design variants of kernels A and D at the main path's shapes.

    python -m weasal_tpu_torch.tools.kernel_variants [--out report.json]
        [--baseline other/weasal_tpu_torch/csrc/radius_search.cu]

Run it from the repository's root (it reads chip_smoke.py's deformable
configuration). Each variant is the kernel's source under csrc/ with
named text substitutions (each must match), built with nvcc like the
port's own libraries into weasal_tpu_torch/_build/variants/ and called
through the same C interface; `--baseline` adds kernel A's source of
another tree (the parent's, unpacked by `git archive`) as the variant
"baseline", so that an old design is timed against this one in one run.
The shapes are the full-width Vaihingen3D weak-label batch of
chip_smoke.py (3 spheres, seeded synthetic scenes): the 7 radius-search
edges of one pyramid and the 2 strided max-pool backwards (leaky-ReLU'd
normal features, normal output gradients); and for A the 13 edges of a
pyramid of the deformable pseudo-label configuration (chip_smoke.py's
phase 11: layers 3 and 4 search within 11.52 and 23.04 m at K of
several hundred), on 4 spheres cut from the synthetic tile of phase 6
(150 m at 8 points / m^2, seed 0) with a plan calibrated on 8. The variants
run in turns (A B C, C B A, ...); each is timed by the device time of
its kernels and memsets under torch.profiler (median over turns of the
mean of 5 calls) and by CUDA events around one call (median), and the
exact variants are first held to the plain versions. Needs one NVIDIA
GPU with nvcc; prints the card line and one row per shape and variant.

The variants answer the design questions the kernels' source notes
record: for A, K-best in registers only (K <= 48; not run above), on
the warp path only, and without the 4-slot register list; for D,
branches instead of selects in the maximum pass, 64-bit winner masks
only, and the kernel without its gathers or stopped after its index and
gradient loads (these two give wrong results and are timed only). D
runs on inverse lists built once a shape and a workspace of its (row,
slot) contributions, as the main path calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda import build

RADIUS = "radius_search"
MAXPOOL = "maxpool_bwd"

_NO_K4 = ("if (k <= 4)", "if (k <= 0)")
_REGISTERS_ABOVE_16 = (
    "  return launch_warp_search(q, q_mask, sorted, params, starts, n, nq, "
    "ns, k,\n                            r2, out, st);",
    "  if (k <= 32)\n    return launch_search<32>(q, q_mask, sorted, "
    "params, starts, n, nq, ns,\n                              k, r2, out, "
    "st);\n  return launch_search<48>(q, q_mask, sorted, params, starts, "
    "n, nq, ns, k,\n                           r2, out, st);")
_SELECTS = """        const bool above = v.v[e] > m[e], tie = v.v[e] == m[e];
        m[e] = above ? v.v[e] : m[e];
        ties[e] = above ? 1 : ties[e] + (int)tie;
        win[e] = above ? bit : (tie ? win[e] | bit : win[e]);"""
_BRANCHES = """        if (v.v[e] > m[e]) {
          m[e] = v.v[e];
          ties[e] = 1;
          win[e] = bit;
        } else if (v.v[e] == m[e]) {
          ++ties[e];
          win[e] |= bit;
        }"""
_GATHER = "        v = load_vec<VEC>(xb + (size_t)n * c_dim + c);"
_NO_GATHER = ("#pragma unroll\n        for (int e = 0; e < VEC; ++e) "
              "v.v[e] = (float)((n * 7 + c + e) & 15);")
_PASSES = "    float m[VEC];\n"
_NO_PASSES = "    if (any) return;\n    float m[VEC];\n"

# kernel: {variant: (substitutions, exact)}; BASELINE is added by
# --baseline
VARIANTS = {
    RADIUS: {
        "as built": ((), True),
        "warp path only": ((_NO_K4, ("kRegisterK = 16;", "kRegisterK = 0;")),
                           True),
        "registers only (K <= 48)": ((_REGISTERS_ABOVE_16,), True),
        "no 4-slot registers": ((_NO_K4,), True),
    },
    MAXPOOL: {
        "as built": ((), True),
        "branches": (((_SELECTS, _BRANCHES),), True),
        "no gathers": (((_GATHER, _NO_GATHER),), False),
        "loads only": (((_PASSES, _NO_PASSES),), False),
        "64-bit masks only": ((("  if (k <= 32)\n", "  if (k <= 0)\n"),),
                              True),
    },
}
BASELINE = "baseline"
# the largest K a variant computes (it is not run above)
MAX_K = {(RADIUS, "registers only (K <= 48)"): 48}


def build_variants(baseline: str = ""):
    """{(kernel, variant): ctypes library}, one nvcc per variant, all at
    once; `baseline`: kernel A's source of another tree, built as
    BASELINE."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel, variants in VARIANTS.items():
        text = (build.CSRC_DIR / f"{kernel}.cu").read_text()
        for i, (name, (subs, _)) in enumerate(variants.items()):
            src = (Path(baseline).read_text()
                   if name == BASELINE else text)
            for old, new in subs:
                if old not in src:
                    raise ValueError(f"{kernel} / {name}: {old!r} not found")
                src = src.replace(old, new)
            path = out_dir / f"{kernel}_{i}.cu"
            path.write_text(src)
            lib = out_dir / f"lib{kernel}_{i}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                   "-o", str(lib), str(path)]
            jobs[kernel, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def main_path_batch(dev):
    """(config, plan, batch) of chip_smoke.py's first inference batch, its
    pyramid built by the plain versions."""
    from weasal_tpu_torch import VaihingenWLConfig
    from weasal_tpu_torch.data.batching import calibrate_shape_plan
    from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
    from weasal_tpu_torch.data.level0 import assemble_level0
    from weasal_tpu_torch.infer import to_device
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.device import plain_ops
    config = VaihingenWLConfig()
    rng = np.random.default_rng(0)
    calib = [demo_sphere(rng, config) for _ in range(2 * config.batch_num)]
    plan = calibrate_shape_plan([p["points"] for p in calib], config,
                                region_budget=(8, 64), rng=rng)
    arrays = assemble_level0(
        [thin_payload(demo_sphere(rng, config), plan.num_points[0], rng)
         for _ in range(config.batch_num)], plan, config.num_classes, rng)
    t = to_device(arrays, dev)
    with torch.no_grad(), plain_ops():
        batch = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t["rotations"])
    return config, plan, batch


def deformable_batch(dev, n_calib: int = 8):
    """(config, plan, batch) of chip_smoke.py's deformable pseudo-label
    configuration on spheres of its loop tile (`synthetic_scene` at
    LOOP_EXTENT and LOOP_DENSITY, seed SEED, grid-subsampled at the first
    dl): a plan calibrated on `n_calib` spheres of in_radius around
    seeded points, and a pyramid of batch_num of them built by the plain
    versions."""
    import chip_smoke
    from weasal_tpu_torch.data.batching import calibrate_shape_plan
    from weasal_tpu_torch.data.demo import thin_payload
    from weasal_tpu_torch.data.level0 import assemble_level0
    from weasal_tpu_torch.data.synthetic import synthetic_scene
    from weasal_tpu_torch.infer import to_device
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.ops.subsample import grid_subsample
    from weasal_tpu_torch.utils.device import plain_ops
    config = chip_smoke.deformable_pl_config()()
    config.num_classes = 9
    pts, _, _ = synthetic_scene(np.random.default_rng(chip_smoke.SEED),
                                extent=chip_smoke.LOOP_EXTENT,
                                density=chip_smoke.LOOP_DENSITY)
    tile = grid_subsample(pts.astype(np.float32),
                          dl=config.first_subsampling_dl)
    rng = np.random.default_rng(0)

    def sphere():
        c = tile[rng.integers(tile.shape[0])]
        p = tile[np.linalg.norm(tile - c, axis=1) < config.in_radius] - c
        n = p.shape[0]
        return dict(points=p.astype(np.float32),
                    features=np.ones((n, config.in_features_dim),
                                     np.float32),
                    labels=np.zeros(n, np.int32),
                    center=np.zeros(3, np.float32),
                    cloud_lb=np.zeros(config.num_classes, np.float32),
                    regions=[])

    calib = [sphere() for _ in range(n_calib)]
    plan = calibrate_shape_plan([p["points"] for p in calib], config,
                                rng=rng)
    arrays = assemble_level0(
        [thin_payload(p, plan.num_points[0], rng)
         for p in calib[:config.batch_num]], plan, config.num_classes, rng)
    t = to_device(arrays, dev)
    with torch.no_grad(), plain_ops():
        batch = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t["rotations"])
    return config, plan, batch


def radius_shapes(config, plan, batch, prefix=""):
    """(label, call(lib), plain output, K) of each radius-search edge."""
    from weasal_tpu_torch.data.batching import search_edges
    from weasal_tpu_torch.ops.cuda.radius_search import radius_search_plain
    shapes = []
    for name, lq, ls, r, k in search_edges(config, plan):
        args_ = (batch.points[lq], batch.points[ls], batch.masks[lq],
                 batch.masks[ls], r, k)
        shapes.append((f"{prefix}{name} K={k}",
                       lambda lib, a=args_: call_radius(lib, *a),
                       radius_search_plain(*args_), k))
    return shapes


def call_radius(lib, q, s, qm, sm, r, k):
    from weasal_tpu_torch.ops.cuda import radius_search as rs
    b, nq, ns = q.shape[0], q.shape[1], s.shape[1]
    out = torch.empty((b, nq, k), dtype=torch.int32, device=q.device)
    rs.declare(lib)
    scratch = torch.empty(lib.radius_search_scratch_words(b, ns),
                          dtype=torch.int32, device=q.device)
    fn = lib.radius_search_launch
    build.check(fn(q.data_ptr(), s.data_ptr(), qm.data_ptr(), sm.data_ptr(),
                   b, nq, ns, k, rs._r2(r), out.data_ptr(),
                   scratch.data_ptr(), scratch.numel(),
                   torch.cuda.current_stream().cuda_stream), "variant")
    return out


def call_maxpool(lib, x, nb, g, inv):
    from weasal_tpu_torch.ops.cuda import maxpool_bwd as mp
    b, ns, c = x.shape
    nq, k = nb.shape[1:]
    dx = torch.empty_like(x)
    ws = torch.empty((max(b * nq * k, 1), c), dtype=torch.float32,
                     device=x.device)
    fn = lib.maxpool_bwd_launch
    fn.argtypes, fn.restype = mp._ARGTYPES, ctypes.c_int
    build.check(fn(x.data_ptr(), nb.data_ptr(), g.data_ptr(), b, nq, ns, k,
                   c, inv.offsets.data_ptr(), inv.entries.data_ptr(),
                   ws.data_ptr(), dx.data_ptr(),
                   torch.cuda.current_stream().cuda_stream), "variant")
    return dx


def device_ms(calls, turns=3, per_turn=5):
    """{name: device ms per call}: kernels and memsets under
    torch.profiler, `per_turn` calls a turn, variants in turns."""
    from torch.profiler import ProfilerActivity, profile
    names = list(calls)
    times = {n: [] for n in names}
    for n in names:
        calls[n]()
    torch.cuda.synchronize()
    for _ in range(turns):
        for n in names + names[::-1]:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(per_turn):
                    calls[n]()
                torch.cuda.synchronize()
            total = sum(e.self_device_time_total for e in prof.events()
                        if str(e.device_type).endswith("CUDA"))
            times[n].append(total / per_turn / 1e3)
    return {n: statistics.median(v) for n, v in times.items()}


def event_ms(calls, turns=10):
    """{name: ms per call} by CUDA events around one call, in turns."""
    names = list(calls)
    times = {n: [] for n in names}
    for n in names:
        calls[n]()
    for _ in range(turns):
        for n in names + names[::-1]:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            calls[n]()
            end.record()
            end.synchronize()
            times[n].append(start.elapsed_time(end))
    return {n: statistics.median(v) for n, v in times.items()}


def compare(kernel, shapes, libs, log, what="one step's shapes"):
    """Rows of (shape, variant, device ms, event ms) over `shapes`, each
    (label, call(lib), plain output, K or None), and the sums over the
    shapes (of each variant run at all of them)."""
    rows, sums = [], {}
    skipped = set()
    for label, call, want, k in shapes:
        calls = {}
        for name, (_, exact) in VARIANTS[kernel].items():
            if k is not None and k > MAX_K.get((kernel, name), k):
                skipped.add(name)
                continue
            lib = libs[kernel, name]
            if exact:
                got = call(lib)
                torch.cuda.synchronize()
                ok = (torch.equal(got, want) if kernel == RADIUS else
                      torch.allclose(got, want, rtol=1e-6,
                                     atol=1e-6 * float(want.abs().max())))
                if not ok:
                    raise AssertionError(f"{kernel} / {name} at {label} "
                                         "differs from the plain version")
            calls[name] = (lambda lib=lib: call(lib))
        dev, ev = device_ms(calls), event_ms(calls)
        for name in calls:
            rows.append(dict(kernel=kernel, shape=label, variant=name,
                             device_ms=dev[name], event_ms=ev[name]))
            s = sums.setdefault(name, [0.0, 0.0])
            s[0] += dev[name]
            s[1] += ev[name]
        log(f"{kernel} {label}: " + "; ".join(
            f"{n} {dev[n]:.4f} / {ev[n]:.4f}" for n in calls))
    sums = {n: s for n, s in sums.items() if n not in skipped}
    log(f"{kernel} summed over {what} (device / event ms): "
        + "; ".join(f"{n} {d:.4f} / {e:.4f}" for n, (d, e) in sums.items()))
    return rows, sums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the rows as JSON")
    ap.add_argument("--baseline", default="",
                    help="kernel A's source of another tree, timed as the "
                    "variant 'baseline'")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
    from weasal_tpu_torch.ops.cuda.maxpool_bwd import maxpool_bwd_plain

    def log(msg):
        print(msg, flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    if args.baseline:
        VARIANTS[RADIUS][BASELINE] = ((), True)
    libs = build_variants(args.baseline)
    dev = torch.device("cuda")
    config, plan, batch = main_path_batch(dev)
    a_rows, a_sums = compare(RADIUS, radius_shapes(config, plan, batch),
                             libs, log)
    d_config, d_plan, d_batch = deformable_batch(dev)
    log(f"deformable PL batch: {d_plan}")
    rows, deform_sums = compare(
        RADIUS, radius_shapes(d_config, d_plan, d_batch, "deform "), libs,
        log, what="the deformable pyramid's shapes")
    a_rows += rows

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = []
    for level, c in ((0, config.first_features_dim),
                     (1, 2 * config.first_features_dim)):
        nb = batch.pools[level]
        b, ns = batch.points[level].shape[:2]
        x = torch.nn.functional.leaky_relu(
            torch.randn((b, ns, c), generator=gen, device=dev), 0.1)
        g = torch.randn((b, nb.shape[1], c), generator=gen, device=dev)
        inv = LazyInverse(nb, ns).get()
        shapes.append((f"pool{level} K={nb.shape[2]} C={c}",
                       lambda lib, a=(x, nb, g, inv): call_maxpool(lib, *a),
                       maxpool_bwd_plain(x, nb, g), None))
    d_rows, d_sums = compare(MAXPOOL, shapes, libs, log)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=a_rows + d_rows,
                           sums={RADIUS: a_sums, MAXPOOL: d_sums,
                                 "radius_search deformable": deform_sums},
                           deformable_plan=vars(d_plan)), f, indent=1)
    log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
