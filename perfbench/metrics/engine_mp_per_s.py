"""``engine_mp_per_s`` (MP/s, host clock): megapixels of the files returned
decoded by the calls of the window, over the whole window (from the first
call's start to the last call's return).
"""


from harness import arith


def read(rec):
    return arith.rate(rec["megapixels"], rec["seconds"])
