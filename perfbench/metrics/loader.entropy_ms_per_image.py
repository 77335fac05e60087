"""``loader.entropy_ms_per_image`` (ms/image, program span): the seconds of
the ``entropy`` stage of the ``StageTimers`` passed to
``iter_decode_batches`` as ``timers=`` in the traced window, summed over
threads, per image completed in the window: the C++ entropy decode into the
transport buffer (layer native): the wall time of each batch's decode over
its pool of threads.
"""


def read(rec):
    seconds = rec["stages"].get("entropy")
    if seconds is None or not rec["images"]:
        return None
    return 1e3 * seconds / rec["images"]
