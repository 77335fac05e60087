"""``loader.scan_ms_per_image`` (ms/image, program span): the seconds of the
``scan`` stage of the ``StageTimers`` passed to ``iter_decode_batches`` as
``timers=`` in the traced window, summed over threads, per image completed
in the window: the Python marker scan (layer codec), on the prefetch thread
that stages the batch.
"""


def read(rec):
    seconds = rec["stages"].get("scan")
    if seconds is None or not rec["images"]:
        return None
    return 1e3 * seconds / rec["images"]
