"""torch.cuda.max_memory_allocated() over the whole run (set-up
included), in GiB, read when the window closes."""


def read(record):
    peak = record["memory_peak_bytes"]
    return peak / 2 ** 30 if peak > 0 else None
