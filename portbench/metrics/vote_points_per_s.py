"""Real points of the spheres voted in the window over its wall time."""


def read(record):
    if record["kind"] != "vote" or record["window_s"] <= 0:
        return None
    return record["points"] / record["window_s"]
