"""One kernel training step under `torch.use_deterministic_algorithms`.

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python -m \\
        weasal_tpu_torch.tools.deterministic_step [--seed S]

Builds the Vaihingen3D weak-label model at full width
(`VaihingenWLConfig`, weights from a seeded generator), a shape plan and
one level-0 batch of synthetic `demo_sphere` scenes (as chip_smoke.py's
phase 1 does), and runs one `train_step` on the card with
`torch.use_deterministic_algorithms(True)`: PyTorch then raises at any
of its operations that is known to be non-deterministic on CUDA, and
cuBLAS needs the workspace setting above. Prints the loss; exits non-zero
on any error. It runs in a process of its own because the mode is global
to the process. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("deterministic_step: needs a CUDA device", file=sys.stderr)
        return 1
    from weasal_tpu_torch import (KPFCNN_mprm, VaihingenWLConfig,
                                  init_opt_state, train_step)
    from weasal_tpu_torch.data.batching import calibrate_shape_plan
    from weasal_tpu_torch.data.demo import demo_sphere, thin_payload
    from weasal_tpu_torch.data.level0 import assemble_level0
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda")
    config = VaihingenWLConfig()
    rng = np.random.default_rng(args.seed)
    calib = [demo_sphere(rng, config) for _ in range(2 * config.batch_num)]
    plan = calibrate_shape_plan([p["points"] for p in calib], config,
                                region_budget=(8, 64), rng=rng)
    batch = assemble_level0(
        [thin_payload(demo_sphere(rng, config), plan.num_points[0], rng)
         for _ in range(config.batch_num)], plan, config.num_classes, rng)
    model = KPFCNN_mprm(config, tuple(range(config.num_classes)), (),
                        generator=torch.Generator().manual_seed(args.seed))
    model = model.to(dev)
    loss, _acc, _drops = train_step(model, init_opt_state(model), batch,
                                    config, plan, config.learning_rate,
                                    device=dev)
    torch.cuda.synchronize()
    print(f"deterministic step: loss {float(loss):.7f}, plan {plan}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
