"""``crops.mode_groups_per_batch`` (launches/batch, program counter): the
decode launches the crop path staged (the counter ``crop.mode_groups`` of
``StageTimers.counters()``: one a sampling mode a batch) over the batches
it staged in the traced window (one ``crop_gather`` stage each).  Nothing
where the program has no such counter or stage.
"""


def read(rec):
    groups = (rec.get("counters") or {}).get("crop.mode_groups")
    batches = rec.get("batches_staged")
    if groups is None or not batches:
        return None
    return groups / batches
