"""Export a checkpoint to the reference implementation's torch format.

Counterpart of scripts/export_torch_checkpoint.py: reads a checkpoint of
any format the port reads (its own, the JAX package's `.tar`, the
reference's; utils/checkpoint.py) and writes the reference's `torch.save`
payload (utils/torch_interop.save_reference_checkpoint), which the
reference's strict restore and the JAX package's loader read. The run's
parameters.txt, read through the port's `Config.load`, gives the SGD
groups' learning rate, momentum, weight decay and deform factor, the
model name and the class weights.

    python -m weasal_tpu_torch.export_torch_checkpoint \\
        results/WeakLabel/Log_x/checkpoints/current_chkp.tar out_chkp.tar \\
        [--log results/WeakLabel/Log_x]

`--log` defaults to the checkpoint's grandparent directory. Runs on the
CPU: nothing is computed.
"""

from __future__ import annotations

import argparse
import os
import sys

from weasal_tpu_torch.config import Config
from weasal_tpu_torch.utils.checkpoint import load_checkpoint_file
from weasal_tpu_torch.utils.torch_interop import save_reference_checkpoint


def main(argv=None) -> str:
    """Parse `argv` and export; returns the output path."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint")
    parser.add_argument("out")
    parser.add_argument("--log", default=None,
                        help="results dir with parameters.txt (default: "
                             "the checkpoint's grandparent)")
    args = parser.parse_args(argv)
    log = args.log or os.path.dirname(
        os.path.dirname(os.path.abspath(args.checkpoint)))
    config, model_name, class_w = None, "KPFCNN_mprm", None
    if os.path.exists(os.path.join(log, "parameters.txt")):
        config = Config()
        config.load(log)
        model_name = getattr(config, "model_name", model_name)
        if getattr(config, "class_w", None):
            class_w = list(config.class_w)
    payload = load_checkpoint_file(args.checkpoint)
    save_reference_checkpoint(args.out, payload["model_state_dict"],
                              epoch=payload.get("epoch", 0),
                              saving_path=payload.get("saving_path"),
                              config=config, class_weights=class_w,
                              model_name=model_name)
    print(f"wrote {args.out} (epoch {payload.get('epoch', 0)}, model "
          f"{model_name})")
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
