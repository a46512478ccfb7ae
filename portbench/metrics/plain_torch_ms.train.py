"""Device ms a training step in plain PyTorch ops: the families outside kernels A-D,
the inverse lists and the row sums, over the traced stretch."""

from portbench.yardstick.layers import plain_torch_ms


def read(record):
    return plain_torch_ms(record, "train")
