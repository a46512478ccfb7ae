"""Times kernels B and C (f32) at chip_smoke.py's phase 2 WL shapes with
the package of the working directory, so that two trees compare in one
call on one card:

    cd <tree> && python -m weasal_tpu_torch.tools.time_kpconv

(unpack the other tree with `git archive` into a directory git ignores
and run it there too, in turns). Per conv the median of 20 CUDA-event
timings of one call of each kernel (dX as the training step asks), their
sums over the 12 convs, and the device ms of each launch of B and C at
the widest conv by kernel name (torch.profiler, mean of 10 calls).
Needs one NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import os
import statistics
import sys

import numpy as np
import torch


def _ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _by_name(fn, calls: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    sums = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            name = e.key.split("(")[0]
            sums[name] = sums.get(name, 0.0) + e.self_device_time_total / 1e3
    return {k: v / calls for k, v in sums.items()}


def main() -> int:
    sys.path.insert(0, os.getcwd())
    from weasal_tpu_torch import KPFCNN_mprm, VaihingenWLConfig
    from weasal_tpu_torch.data.batching import calibrate_shape_plan
    from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
    from weasal_tpu_torch.data.level0 import assemble_level0
    from weasal_tpu_torch.infer import to_device
    from weasal_tpu_torch.models.blocks import conv_inputs, kernel_convs
    from weasal_tpu_torch.ops.cuda import build
    from weasal_tpu_torch.ops.cuda.inverse_lists import LazyInverse
    from weasal_tpu_torch.ops.cuda.kpconv_bwd import kpconv_bwd
    from weasal_tpu_torch.ops.cuda.kpconv_fwd import (kpconv_fwd,
                                                      kpconv_fwd_with_y)
    from weasal_tpu_torch.ops.pyramid import batch_from_device_pyramid
    from weasal_tpu_torch.utils.device import configure_precision, plain_ops
    if not torch.cuda.is_available():
        print("time_kpconv: needs a CUDA device", file=sys.stderr)
        return 1
    build.build_all()
    configure_precision()
    dev = torch.device("cuda")
    # chip_smoke.py's phase 2: its seed, plan and demo batch
    config = VaihingenWLConfig()
    rng = np.random.default_rng(0)
    calib = [demo_sphere(rng, config) for _ in range(2 * config.batch_num)]
    plan = calibrate_shape_plan([p["points"] for p in calib], config,
                                region_budget=(8, 64), rng=rng)
    model = KPFCNN_mprm(config, tuple(range(config.num_classes)), (),
                        generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    arrays = assemble_level0(
        [thin_payload(demo_sphere(rng, config), plan.num_points[0], rng)
         for _ in range(config.batch_num)], plan, config.num_classes, rng)
    t = to_device(arrays, dev)
    with torch.no_grad(), plain_ops():
        pyr = batch_from_device_pyramid(
            t["points0"], t["mask0"], t["features"], t["labels"], config,
            plan, t["center_pts"], rotations=t["rotations"])
    gen = torch.Generator(device=dev).manual_seed(0)
    total_b = total_c = 0.0
    widest, width = None, -1
    with torch.no_grad():
        for name, conv in kernel_convs(model):
            q, s, nb, _ = conv_inputs(conv.strided, conv.layer_ind, pyr)
            kp, w = conv.kernel_points, conv.weights.detach()
            x = torch.randn((s.shape[0], s.shape[1], w.shape[1]),
                            generator=gen, device=dev)
            g = torch.randn((q.shape[0], q.shape[1], w.shape[2]),
                            generator=gen, device=dev)
            ext, infl = conv.params.kp_extent, conv.params.influence
            y = kpconv_fwd_with_y(q, s, nb, x, kp, w, ext, infl)[1]
            inv = LazyInverse(nb, s.shape[1])
            inv.get()

            def b_call():
                return kpconv_fwd(q, s, nb, x, kp, w, ext, infl)

            def c_call():
                return kpconv_bwd(q, s, nb, y, kp, w, g, ext, infl,
                                  inverse=inv)

            b_ms, c_ms = _ms(b_call), _ms(c_call)
            total_b, total_c = total_b + b_ms, total_c + c_ms
            print(f"  {name}: B {b_ms:.3f} ms, C {c_ms:.3f} ms")
            if w.shape[0] * w.shape[1] > width:
                widest, width = (name, b_call, c_call), w.shape[0] * w.shape[1]
        name, b_call, c_call = widest
        for label, fn in (("B", b_call), ("C", c_call)):
            for kernel, ms in sorted(_by_name(fn).items(),
                                     key=lambda kv: -kv[1]):
                print(f"  {name} {label}: {ms:.4f} ms {kernel[:90]}")
    print(f"{os.path.basename(os.getcwd())}: B {total_b:.3f} ms, "
          f"C {total_c:.3f} ms (12 convs, f32)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
