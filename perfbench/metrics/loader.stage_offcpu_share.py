"""``loader.stage_offcpu_share`` (%, program span): 100 x (1 - the thread
CPU seconds of the ``stage`` stage of the ``StageTimers`` passed to
``iter_decode_batches`` as ``timers=`` (``stage.cpu``) over its wall
seconds) in the traced window: the share of staging's wall time (layer
staging) that its prefetch thread spent off a CPU, waiting for the GIL
after the C++ wire compaction, blocked in the CUDA runtime while
page-locking, or descheduled.
"""


def read(rec):
    wall = rec["stages"].get("stage")
    cpu = rec["stages"].get("stage.cpu")
    if wall is None or cpu is None or wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)
