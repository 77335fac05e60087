"""``loader.h2d_ms_per_image`` (ms/image, program span): the seconds of the
``h2d`` stage of the ``StageTimers`` passed to ``iter_decode_batches`` as
``timers=`` in the traced window, summed over threads, per image completed
in the window: the host-to-device copy (layer parallel/sharding),
synchronised when traced.
"""


def read(rec):
    seconds = rec["stages"].get("h2d")
    if seconds is None or not rec["images"]:
        return None
    return 1e3 * seconds / rec["images"]
