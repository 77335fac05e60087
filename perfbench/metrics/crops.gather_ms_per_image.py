"""``crops.gather_ms_per_image`` (ms/image, program span): the seconds of the
``crop_gather`` stage of the ``StageTimers`` passed to
``iter_decode_batch_crops`` as ``timers=`` in the traced window (the copy
of each crop's covering MCU sub-grid out of its whole-image coefficients,
in ``models/input_pipeline._host_stage_crops``), summed over threads, per
image completed in the window.  Nothing where the program has no such
stage.
"""


def read(rec):
    seconds = rec["stages"].get("crop_gather")
    if seconds is None or not rec["images"]:
        return None
    return 1e3 * seconds / rec["images"]
