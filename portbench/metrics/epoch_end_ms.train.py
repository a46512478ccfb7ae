"""Host ms a training step that the window's epoch ends and starts took:
the program's `epoch_end` spans (the drops read, the plan audit, the
checkpoint; the card's drain is the epoch's final flush, before them)
and `epoch_start` spans (a new batch producer through its first batch),
over the window's steps, in the unit of `train_step_ms`."""

from portbench.yardstick.spans import span_ms_a_step


def read(record):
    return span_ms_a_step(record, ("epoch_end", "epoch_start"))
