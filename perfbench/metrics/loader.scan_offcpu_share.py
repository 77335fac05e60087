"""``loader.scan_offcpu_share`` (%, program span): 100 x (1 - the thread
CPU seconds of the ``scan`` stage of the ``StageTimers`` passed to
``iter_decode_batches`` as ``timers=`` (``scan.cpu``) over its wall
seconds) in the traced window: the share of the Python marker scan's wall
time (layer codec) that its prefetch thread spent off a CPU, waiting for
the GIL or descheduled.
"""


def read(rec):
    wall = rec["stages"].get("scan")
    cpu = rec["stages"].get("scan.cpu")
    if wall is None or cpu is None or wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)
