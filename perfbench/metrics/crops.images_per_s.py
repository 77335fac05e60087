"""``crops.images_per_s`` (images/s, host clock): crops of every batch that
came back ready on the card in the traced window, over the whole window
(from the first ``next()`` to the last batch's event).  Read under the
profiler and the program's stage timers, so it runs below an untraced
run's rate.
"""

from harness import arith


def read(rec):
    return arith.rate(rec["images"], rec["seconds"])
