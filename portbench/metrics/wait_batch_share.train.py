"""% of the window's epochs that the loop spent waiting for batches
(the trainer's WEASAL_LOOP_STATS `wait_batch`)."""


def read(record):
    if record["kind"] != "train" or not record.get("loop_s"):
        return None
    return 100.0 * record["wait_batch_s"] / record["loop_s"]
