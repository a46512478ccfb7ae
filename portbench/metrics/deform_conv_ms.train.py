"""Device ms a training step inside the deformable chains' marks, forward
and backward: the union of the device intervals between each begin mark
and its end, over the traced stretch's steps (yardstick/deform_work.py).
A program without the marks gives nothing."""

from portbench.yardstick.deform_work import chain_ms


def read(record):
    return chain_ms(record)
