"""Times design variants of kernels A and D at the main path's shapes.

    python -m weasal_tpu_torch.tools.kernel_variants [--out report.json]

Each variant is the kernel's source under csrc/ with named text
substitutions (each must match), built with nvcc like the port's own
libraries into weasal_tpu_torch/_build/variants/ and called through the
same C interface. The shapes are the full-width Vaihingen3D weak-label
batch of chip_smoke.py (3 spheres, seeded synthetic scenes): the 7
radius-search edges of one pyramid and the 2 strided max-pool backwards
(leaky-ReLU'd normal features, normal output gradients). The variants
run in turns (A B C, C B A, ...); each is timed by the device time of
its kernels and memsets under torch.profiler (median over turns of the
mean of 5 calls) and by CUDA events around one call (median), and the
exact variants are first held to the plain versions. Needs one NVIDIA
GPU with nvcc; prints the card line and one row per shape and variant.

The variants answer the design questions the kernels' source notes
record: for A, K-best in registers only, in shared-memory lists only,
and without the 4-slot register list; for D, branches instead of
selects in the maximum pass, and the kernel without its atomics, without
its gathers, without both, or stopped after its index and gradient
loads (these four give wrong results and are timed only).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda import build

RADIUS = "radius_search"
MAXPOOL = "maxpool_bwd"

_NO_K4 = ("if (k <= 4)", "if (k <= 0)")
_REGISTERS_ABOVE_16 = (
    "  return launch_search<0>(q, q_mask, sorted, params, starts, n, nq, "
    "ns, k,\n                          r2, out, st);",
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
_ATOMIC = "          atomicAdd(dxb + (size_t)n * c_dim + c + e, share[e]);"
_NO_ATOMIC = ("          if (share[e] == 1.2345e-37f) "
              "dxb[(size_t)n * c_dim + c + e] = share[e];")
_GATHER = "        v = load_vec<VEC>(xb + (size_t)n * c_dim + c);"
_NO_GATHER = ("#pragma unroll\n        for (int e = 0; e < VEC; ++e) "
              "v.v[e] = (float)((n * 7 + c + e) & 15);")
_PASSES = "    float m[VEC];\n"
_NO_PASSES = "    if (any) return;\n    float m[VEC];\n"

# kernel: {variant: (substitutions, exact)}
VARIANTS = {
    RADIUS: {
        "as built": ((), True),
        "lists only": ((_NO_K4, ("kRegisterK = 16;", "kRegisterK = 0;")),
                       True),
        "registers only (K <= 48)": ((_REGISTERS_ABOVE_16,), True),
        "no 4-slot registers": ((_NO_K4,), True),
    },
    MAXPOOL: {
        "as built": ((), True),
        "branches": (((_SELECTS, _BRANCHES),), True),
        "no atomics": (((_ATOMIC, _NO_ATOMIC),), False),
        "no gathers": (((_GATHER, _NO_GATHER),), False),
        "neither": (((_ATOMIC, _NO_ATOMIC), (_GATHER, _NO_GATHER)), False),
        "loads only": (((_PASSES, _NO_PASSES),), False),
        "64-bit masks only": ((("  if (k <= 32)\n", "  if (k <= 0)\n"),),
                              True),
    },
}


def build_variants():
    """{(kernel, variant): ctypes library}, one nvcc per variant, all at
    once."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel, variants in VARIANTS.items():
        text = (build.CSRC_DIR / f"{kernel}.cu").read_text()
        for i, (name, (subs, _)) in enumerate(variants.items()):
            src = text
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


def call_maxpool(lib, x, nb, g):
    from weasal_tpu_torch.ops.cuda import maxpool_bwd as mp
    b, ns, c = x.shape
    nq, k = nb.shape[1:]
    dx = torch.empty_like(x)
    fn = lib.maxpool_bwd_launch
    fn.argtypes, fn.restype = mp._ARGTYPES, ctypes.c_int
    build.check(fn(x.data_ptr(), nb.data_ptr(), g.data_ptr(), b, nq, ns, k,
                   c, dx.data_ptr(), torch.cuda.current_stream().cuda_stream),
                "variant")
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


def compare(kernel, shapes, libs, log):
    """Rows of (shape, variant, device ms, event ms) over `shapes`, each
    (label, call(lib), plain output), and the sums over the shapes."""
    rows, sums = [], {}
    for label, call, want in shapes:
        calls = {}
        for name, (_, exact) in VARIANTS[kernel].items():
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
    log(f"{kernel} summed over one step's shapes (device / event ms): "
        + "; ".join(f"{n} {d:.4f} / {e:.4f}" for n, (d, e) in sums.items()))
    return rows, sums


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from weasal_tpu_torch.data.batching import search_edges
    from weasal_tpu_torch.ops.cuda.maxpool_bwd import maxpool_bwd_plain
    from weasal_tpu_torch.ops.cuda.radius_search import radius_search_plain

    def log(msg):
        print(msg, flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    libs = build_variants()
    dev = torch.device("cuda")
    config, plan, batch = main_path_batch(dev)

    shapes = []
    for name, lq, ls, r, k in search_edges(config, plan):
        args_ = (batch.points[lq], batch.points[ls], batch.masks[lq],
                 batch.masks[ls], r, k)
        shapes.append((f"{name} K={k}",
                       lambda lib, a=args_: call_radius(lib, *a),
                       radius_search_plain(*args_)))
    a_rows, a_sums = compare(RADIUS, shapes, libs, log)

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = []
    for level, c in ((0, config.first_features_dim),
                     (1, 2 * config.first_features_dim)):
        nb = batch.pools[level]
        b, ns = batch.points[level].shape[:2]
        x = torch.nn.functional.leaky_relu(
            torch.randn((b, ns, c), generator=gen, device=dev), 0.1)
        g = torch.randn((b, nb.shape[1], c), generator=gen, device=dev)
        shapes.append((f"pool{level} K={nb.shape[2]} C={c}",
                       lambda lib, a=(x, nb, g): call_maxpool(lib, *a),
                       maxpool_bwd_plain(x, nb, g)))
    d_rows, d_sums = compare(MAXPOOL, shapes, libs, log)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=a_rows + d_rows,
                           sums={RADIUS: a_sums, MAXPOOL: d_sums}), f,
                      indent=1)
    log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
