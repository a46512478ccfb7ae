"""Holds design variants of the GEMM core of kernels B and C to an f64
training step, and times them; and, as a control, plain PyTorch forwards
that differ from the plain version only in their rounding.

    python -m weasal_tpu_torch.tools.gemm_core_variants [--out report.json]
        [--turns 3]

Run from the repository's root (it takes its checks from chip_smoke.py).
Each variant is csrc/kpconv_common.cuh with named text substitutions
(each must match), built with kpconv_fwd.cu and kpconv_bwd.cu like the
port's own libraries into weasal_tpu_torch/_build/variants/core_<i>/; a
variant is used by putting its two libraries in the loader's cache, so
the port's own wrappers call it. The variants run in turns (A B C, C B
A, ...), and in each turn:

- the core's drift: chip_smoke.check_gemm_bias (mean relative error to
  f64 on positive operands at the widest conv);
- the f64 step of chip_smoke.py's phase 5 (its plan and pyramid, the
  seeded initial state): the largest share of the f64 allowance that the
  kernel step uses (chip_smoke.compare_train_steps);
- the same on LOOP_BATCHES batches of the training loop's resident
  source at its plan (chip_smoke.py's phase 6 tile, seed and arguments,
  the trainer made by the entry point with no epoch run);
- the device time of a phase 5 training step's GEMM-core launches (tile
  and split-K sum kernels) and of the whole step, under torch.profiler.

The controls (CONTROLS) run the same f64 steps with the kernels of the
build as it is, but with kernel B's forward replaced by plain PyTorch
that differs from B's plain version only in rounding: the plain version
itself, its neighbor sum in the reverse order, and its neighbor sum in
f64 rounded once. The f64 and plain steps take the kernel step's
branches (chip_smoke.Branches: leaky-ReLU signs, max-pool winners and
the losses' and deformable convs' discrete choices), so a turned branch
no longer reads as a share above 1.

C's and D's scatters add with f32 atomics, so a share moves from run to
run; the turns show by how much. Needs one NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from weasal_tpu_torch.ops.cuda import build

LOOP_BATCHES = 6

_CHAINS = """#pragma unroll
    for (int s = 0; s < 4; ++s) {
      fence_operands(acc);
      fence_operands(fa);
      wgmma_fence();
      if (s == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if constexpr (kMode != kABf16)
            wgmma_tf32<BN>(acc, fa[1][t], sw128_desc(planes + t * 8), t > 0);
          if constexpr (kMode != kBRoundBf16)
            wgmma_tf32<BN>(acc, fa[0][t], sw128_desc(planes + kB + t * 8),
                           kMode == kABf16 ? t > 0 : 1);
        }
      }
      wgmma_tf32<BN>(acc, fa[0][s], sw128_desc(planes + s * 8), s == 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc);
      fence_operands(fa);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j)
        sum[j] = __fadd_rn(sum[j], untruncate(acc[j]));
    }"""
# The core before its chains were cut (PR 3 to 6): a stage's twelve wgmmas
# in one chain, its result added as it is
_ONE_CHAIN = """fence_operands(acc);
    fence_operands(fa);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32<BN>(acc, fa[1][s], sw128_desc(planes + s * 8), s > 0);
      wgmma_tf32<BN>(acc, fa[0][s], sw128_desc(planes + kB + s * 8), 1);
      wgmma_tf32<BN>(acc, fa[0][s], sw128_desc(planes + s * 8), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(fa);
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) sum[j] = __fadd_rn(sum[j], acc[j]);"""
_UNTRUNCATE = "  return __uint_as_float(u + (u & 1u));"
_NO_UNTRUNCATE = "  (void)u;\n  return x;"

# (The PR 6 variants of the influences by a true division went when the
# launches came to take the reciprocals: the core no longer sees ext.)
VARIANTS = {
    "as built": (),
    "4 chains, truncated": ((_UNTRUNCATE, _NO_UNTRUNCATE),),
    "one chain a stage": ((_CHAINS, _ONE_CHAIN),),
}


def _plain_forward(order: str):
    """Kernel B's plain version with its neighbor sum as is ("plain"),
    reversed, or in f64 rounded once ("exact")."""
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import (gather_neighbors,
                                                      neighbor_influences)

    def forward(q, s, nb, x, kp, w, ext, influence="linear",
                compute_dtype="float32"):
        if compute_dtype != "float32":
            raise ValueError("the controls are f32 forwards")
        h = neighbor_influences(q, s, nb, kp, ext, influence)
        nx = gather_neighbors(x, nb, 0.0)
        if order == "reversed":
            h, nx = h.flip(-1), nx.flip(2)
        if order == "exact":
            h, nx = h.double(), nx.double()
        y = torch.einsum("bqpk,bqkc->bqpc", h, nx).float()
        b, nq = y.shape[:2]
        n_kp, cin, cout = w.shape
        y = y.reshape(b * nq, n_kp * cin)
        return (y @ w.reshape(n_kp * cin, cout)).reshape(b, nq, cout), y

    return forward


CONTROLS = {
    "control: B's plain version": "plain",
    "control: plain, neighbor sum reversed": "reversed",
    "control: plain, neighbor sum rounded once": "exact",
}


@contextlib.contextmanager
def forward_route(forward):
    """Kernel B's forward replaced by `forward` inside the block."""
    from weasal_tpu_torch.ops import kpconv as ops
    saved = ops.kpconv_fwd_with_y
    ops.kpconv_fwd_with_y = forward
    try:
        yield
    finally:
        ops.kpconv_fwd_with_y = saved


def build_core_variants():
    """{variant: {"kpconv_fwd": lib, "kpconv_bwd": lib}}, one nvcc per
    library, all at once."""
    header = (build.CSRC_DIR / "kpconv_common.cuh").read_text()
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = header
        for old, new in subs:
            if old not in text:
                raise ValueError(f"{name}: {old[:60]!r} not found")
            text = text.replace(old, new)
        out = build.BUILD_DIR / "variants" / f"core_{i}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "kpconv_common.cuh").write_text(text)
        for src in ("kpconv_fwd", "kpconv_bwd"):
            shutil.copy(build.CSRC_DIR / f"{src}.cu", out / f"{src}.cu")
            lib = out / f"lib{src}.so"
            # -fno-gnu-unique: the static locals of the header's inline
            # functions (the once-per-kernel attribute calls) stay each
            # library's own, where the loader would share them
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xcompiler",
                   "-fno-gnu-unique", "-o", str(lib), str(out / f"{src}.cu")]
            jobs[name, src] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {name: {} for name in VARIANTS}
    for (name, src), (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} / {src}:\n{log}")
        libs[name][src] = ctypes.CDLL(str(lib))
    return libs


def use(libs) -> None:
    """Make the port's B and C wrappers launch these libraries."""
    build._libs.update(libs)


def phase5_setup(cs, dev):
    """(config, plan, model, pyramid) of chip_smoke.py's phase 5
    comparison: its plan, seeded model and first batch."""
    from weasal_tpu_torch import KPFCNN_mprm, VaihingenWLConfig
    from weasal_tpu_torch.data.batching import calibrate_shape_plan
    from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
    from weasal_tpu_torch.data.level0 import assemble_level0
    from weasal_tpu_torch.infer import to_device
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    config = VaihingenWLConfig()
    rng = np.random.default_rng(cs.SEED)
    calib = [demo_sphere(rng, config) for _ in range(2 * config.batch_num)]
    plan = calibrate_shape_plan([p["points"] for p in calib], config,
                                region_budget=(8, 64), rng=rng)
    arrays = assemble_level0(
        [thin_payload(demo_sphere(rng, config), plan.num_points[0], rng)
         for _ in range(config.batch_num)], plan, config.num_classes, rng)
    t = to_device(arrays, dev)
    with torch.no_grad():
        pyr = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t["rotations"],
            cloud_lb=t["cloud_lb"], region_inds=t["region_inds"],
            region_masks=t["region_masks"],
            region_point_masks=t["region_point_masks"],
            region_lb=t["region_lb"])
    model = KPFCNN_mprm(config, tuple(range(config.num_classes)), (),
                        generator=torch.Generator().manual_seed(cs.SEED))
    return config, plan, model.to(dev), pyr


def loop_setup(cs, work, dev):
    """(config, (label values, ignored labels), pyramids) of LOOP_BATCHES
    batches with regions of the training loop's resident source, each
    assembled on the card and built into a pyramid by the plain
    versions, as chip_smoke.check_loop_shapes does."""
    from weasal_tpu_torch.data.loader import BatchPrefetcher
    from weasal_tpu_torch.data.resident import (ResidentBatchSource,
                                                assemble_level0_device)
    from weasal_tpu_torch.data.synthetic import make_vaihingen_like_root
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.train_Vaihingen3D_WeakLabel import run
    from weasal_tpu_torch.utils.device import plain_ops
    root = make_vaihingen_like_root(
        os.path.join(work, "Vaihingen3D"), extent=cs.LOOP_EXTENT,
        density=cs.LOOP_DENSITY, seed=cs.SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = run([os.path.join(work, "log"), "--data_root", root,
                       *cs.LOOP_ARGS, "--max_epoch", "0"])
    config, plan, ds = trainer.config, trainer.plan, trainer.datasets[0]
    source = ResidentBatchSource(ds, plan, dev)
    extra = source.resident.arrays
    pyramids = []
    for batch, metas in BatchPrefetcher(source, 4 * LOOP_BATCHES, dev,
                                        rng=np.random.default_rng(cs.SEED),
                                        extra_arrays=extra):
        if len(pyramids) == LOOP_BATCHES or \
                not any(m["has_regions"] for m in metas):
            continue
        with torch.no_grad():
            t = assemble_level0_device(batch, config, plan, augment=True,
                                       spec=trainer.spec)
            with plain_ops():
                pyramids.append(batch_from_device_pyramid(
                    t["points0"], t["mask0"], t["features"], t["labels"],
                    config, plan, t["center_pts"], rotations=t["rotations"],
                    cloud_lb=t["cloud_lb"], region_inds=t["region_inds"],
                    region_masks=t["region_masks"],
                    region_point_masks=t["region_point_masks"],
                    region_lb=t["region_lb"]))
    labels = (tuple(int(v) for v in ds.label_values),
              tuple(int(v) for v in ds.ignored_labels))
    return config, labels, pyramids


def f64_share(cs, config, make_model, pyr) -> float:
    """The largest share of the f64 allowance the kernel step uses, from
    a fresh seeded model (chip_smoke.compare_train_steps)."""
    from weasal_tpu_torch import init_opt_state
    model = make_model()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        r = cs.compare_train_steps(model, init_opt_state(model), pyr, config,
                                   lambda msg: None)
    cs.FAILED.clear()
    return r["share"]


def step_times(cs, config, model, pyr) -> dict:
    """Device ms of one training step's GEMM-core launches and of the
    whole step (torch.profiler, one warm-up step first)."""
    from weasal_tpu_torch import init_opt_state
    from weasal_tpu_torch.train.step import step_on_batch
    opt = init_opt_state(model)

    def step():
        step_on_batch(model, opt, pyr, config, config.learning_rate)

    step()
    rows, *_ = cs.profiled_kernels(step)
    core = sum(ms for name, _, ms in rows
               if "tf32x3_gemm_kernel" in name or
               name.startswith(cs.SPLITK_SUM))
    return dict(core_ms=core, step_ms=sum(r[2] for r in rows))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the rows as JSON")
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_core_variants: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from weasal_tpu_torch import KPFCNN_mprm
    from weasal_tpu_torch.utils.device import configure_precision

    def log(msg):
        print(msg, flush=True)

    card = cs.card_line()
    log(f"card: {card}")
    build.build_all()
    libs = build_core_variants()
    configure_precision()
    dev = torch.device("cuda")
    config, plan, model, pyr = phase5_setup(cs, dev)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    work = tempfile.mkdtemp(prefix="gemm_core_variants_")
    try:
        loop_config, labels, loop_pyrs = loop_setup(cs, work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 5 plan {plan}; {len(loop_pyrs)} loop batches")

    def phase5_model():
        model.load_state_dict(state0)
        return model

    def loop_model():
        return KPFCNN_mprm(loop_config, *labels,
                           generator=torch.Generator().manual_seed(0)).to(dev)

    names = list(VARIANTS) + list(CONTROLS)
    rows = {name: dict(bias=None, phase5=[], loop=[], core_ms=[],
                       step_ms=[]) for name in names}
    for turn in range(args.turns):
        for name in (names if turn % 2 == 0 else names[::-1]):
            control = CONTROLS.get(name)
            use(libs[next(iter(VARIANTS)) if control else name])
            r = rows[name]
            with (forward_route(_plain_forward(control)) if control
                  else contextlib.nullcontext()):
                if r["bias"] is None and not control:
                    r["bias"] = {k: v["core"]["mean"] for k, v in
                                 cs.check_gemm_bias(lambda msg: None,
                                                    cs.SEED).items()}
                r["phase5"].append(f64_share(cs, config, phase5_model, pyr))
                r["loop"].append([f64_share(cs, loop_config, loop_model, p)
                                  for p in loop_pyrs])
                if not control:
                    t = step_times(cs, config, phase5_model(), pyr)
                    r["core_ms"].append(t["core_ms"])
                    r["step_ms"].append(t["step_ms"])
            log(f"turn {turn} {name}: phase 5 share {r['phase5'][-1]:.3f}, "
                f"loop shares {[round(v, 3) for v in r['loop'][-1]]}")
    cs.FAILED.clear()
    for name in names:
        r = rows[name]
        loop_max = [max(v) for v in r["loop"]]
        timing = (f"; GEMM core {statistics.median(r['core_ms']):.3f} ms, "
                  f"step {statistics.median(r['step_ms']):.3f} ms (device, "
                  "median)" if r["core_ms"] else "")
        drift = (" drift " + ", ".join(f"{k} {v:+.2e}"
                                       for k, v in r["bias"].items()) + ";"
                 if r["bias"] else "")
        log(f"[{card}] {name}:{drift} phase 5 shares "
            f"{[round(v, 3) for v in r['phase5']]}; loop shares "
            f"{[[round(v, 3) for v in t] for t in r['loop']]}; largest "
            f"per turn {[round(v, 3) for v in loop_max]}{timing}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, rows=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
