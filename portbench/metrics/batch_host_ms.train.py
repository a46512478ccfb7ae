"""Host ms a training step that the batch producer's thread spent making
batches in the window: the program's `batch.sample` spans (the sampler,
skipped weak-label batches included) and `batch.pin` spans (stacking and
pinning a pack), over the window's steps."""

from portbench.yardstick.spans import span_ms_a_step


def read(record):
    return span_ms_a_step(record, ("batch.sample", "batch.pin"))
