"""``engine.prepare_ms_per_mp`` (ms/MP, program span): the engine's own
``prepare`` stage (``runtime/engine.py``, ``DecodeEngine._prepare``: the
marker scan and the C++ entropy decode of a file, layers codec and native),
summed over its threads and the window's calls, per megapixel decoded.
"""


def read(rec):
    seconds = rec["stages"].get("prepare")
    if seconds is None or not rec["megapixels"]:
        return None
    return 1e3 * seconds / rec["megapixels"]
