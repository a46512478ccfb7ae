"""Model FLOPs of the traced stretch's steps over its wall at 495 TFLOP/s
(yardstick/work.model_flops: KPConv aggregations and products, linear
maps, and twice the products for the backward)."""

from portbench.yardstick.layers import mfu


def read(record):
    return mfu(record, "train")
