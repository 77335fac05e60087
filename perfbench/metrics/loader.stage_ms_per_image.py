"""``loader.stage_ms_per_image`` (ms/image, program span): the seconds of the
``stage`` stage of the ``StageTimers`` passed to ``iter_decode_batches`` as
``timers=`` in the traced window, summed over threads, per image completed
in the window: staging (runtime/batching.compact_wire and the page-locking
in models/input_pipeline._transport).
"""


def read(rec):
    seconds = rec["stages"].get("stage")
    if seconds is None or not rec["images"]:
        return None
    return 1e3 * seconds / rec["images"]
