"""``engine.queue_wait_share`` (%, program span): the consumer thread's
``queue`` seconds (waiting for the next staged batch) over the window: how
long the device side of ``runtime/engine`` waited for the host.
"""


def read(rec):
    seconds = rec["stages"].get("queue")
    if seconds is None:
        return None
    return 100.0 * seconds / rec["seconds"]
