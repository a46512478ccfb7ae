"""% of kernel B's and C's device time that their bounds (bytes, products at the
TF32 peak, other f32 operations; yardstick/work.py) account for, over the
traced stretch."""

from portbench.yardstick.layers import kpconv_roofline


def read(record):
    return kpconv_roofline(record, "train")
