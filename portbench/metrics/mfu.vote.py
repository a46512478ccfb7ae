"""Model FLOPs of the traced stretch's vote batches over its wall at 495 TFLOP/s
(yardstick/work.model_flops: KPConv aggregations and products, linear
maps)."""

from portbench.yardstick.layers import mfu


def read(record):
    return mfu(record, "vote")
