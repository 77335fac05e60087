"""``crops.shipped_mcu_share`` (%, program counters): the MCUs the crop path
sent to the card over the MCUs it entropy-decoded on the host, in the traced
window (the counters ``crop.mcus_shipped`` and ``crop.mcus_decoded`` of
``StageTimers.counters()``): the share of the host's entropy decode that
the card uses.  Nothing where the program has no such counters.
"""


def read(rec):
    counters = rec.get("counters") or {}
    shipped = counters.get("crop.mcus_shipped")
    decoded = counters.get("crop.mcus_decoded")
    if shipped is None or not decoded:
        return None
    return 100.0 * shipped / decoded
