"""``loader.queue_wait_share`` (%, program span): the seconds of the
``queue`` stage of the ``StageTimers`` passed to ``iter_decode_batches`` as
``timers=`` in the traced window, over the window: the share of the window
in which the consuming thread (the training step) sat waiting for its next
staged batch (layer entry points).
"""


def read(rec):
    seconds = rec["stages"].get("queue")
    if seconds is None or not rec["seconds"]:
        return None
    return 100.0 * seconds / rec["seconds"]
