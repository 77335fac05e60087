"""``engine.finish_ms_per_mp`` (ms/MP, program span): the ``d2h`` and
``write`` stages of ``runtime/engine`` (waiting for the D2H copy, then the
host raster assembly; ``write`` times the finish also when no file is
written), summed over the window's calls, per megapixel decoded.
"""


def read(rec):
    st = rec["stages"]
    if "write" not in st or not rec["megapixels"]:
        return None
    return 1e3 * (st.get("d2h", 0.0) + st["write"]) / rec["megapixels"]
