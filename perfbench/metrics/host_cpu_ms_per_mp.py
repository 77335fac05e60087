"""``host_cpu_ms_per_mp`` (ms/MP, host clock): the process's CPU time (user
and system, every thread) over the window, per megapixel of the input
images decoded in it.
"""


def read(rec):
    if rec["megapixels"] <= 0:
        return None
    return 1e3 * rec["cpu_s"] / rec["megapixels"]
