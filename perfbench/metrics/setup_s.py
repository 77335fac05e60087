"""``setup_s`` (s, host clock): from the process's start to the first timed
call: imports, CUDA initialisation, the build or load of the program's
libraries, the corpus from the seed and the warm-up calls of the cell's own
traffic.
"""


def read(rec):
    return rec["setup_s"]
