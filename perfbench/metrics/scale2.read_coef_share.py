"""``scale2.read_coef_share`` (%, program counters): the coefficients the
reduced IDCT reads over those the host places on the wire, in the traced
window (the counters ``scale.coefs_read`` and ``scale.coefs_shipped`` of
``StageTimers.counters()``, counted over the images' MCUs of each batch
staged at scale 2).  At 4:2:0 the reduced IDCT reads the top-left 4x4 of a
luma block and all 64 of a chroma block, so 50%: the rest of the wire
crosses the link for nothing.  Nothing where the program has no such
counters.
"""


def read(rec):
    counters = rec.get("counters") or {}
    read_ = counters.get("scale.coefs_read")
    shipped = counters.get("scale.coefs_shipped")
    if read_ is None or not shipped:
        return None
    return 100.0 * read_ / shipped
