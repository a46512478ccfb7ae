"""Refine the pseudo labels of a weak-label log with its weak labels.

Counterpart of the root pseudoLabel_refinement.py: combines the vote on
the training clouds (`python -m weasal_tpu_torch.test_models --on train`)
with the point-wise weak-label masks (train/refinement.py) and writes
the refined pseudo-label txt files and the class-weight file of the
pseudo-label stage. Host numpy only; it runs the same on any machine.

    python -m weasal_tpu_torch.pseudoLabel_refinement \\
        --weak_label_log Log_... [--threshold 20] [--data_root ...]
"""

from __future__ import annotations

import argparse
import sys

from weasal_tpu_torch.train.refinement import refine_pseudo_labels


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--weak_label_log", required=True)
    parser.add_argument("--threshold", type=int, default=20,
                        help="max-probability cutoff in percent "
                             "(default 20; 10 for DALES)")
    parser.add_argument("--data_root", default=None)
    args = parser.parse_args(argv)
    return refine_pseudo_labels(args.weak_label_log, args.threshold,
                                data_root=args.data_root)


if __name__ == "__main__":
    main(sys.argv[1:])
