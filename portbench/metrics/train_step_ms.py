"""The window's wall time over the training steps completed in it, the
card synchronized at both ends."""


def read(record):
    if record["kind"] != "train" or record["steps"] <= 0:
        return None
    return 1e3 * record["window_s"] / record["steps"]
