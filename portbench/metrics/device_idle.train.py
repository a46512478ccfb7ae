"""% of the traced stretch's wall in which no operation ran on the card."""

from portbench.yardstick.layers import device_idle


def read(record):
    return device_idle(record, "train")
