"""``loader.images_per_s`` (images/s, host clock): images of every batch that
came back ready on the card in the traced window, over the whole window
(from the first ``next()`` to the last batch's event).  Read under the
profiler and the program's synchronising stage timers, so it runs below an
untraced run's rate; it stands per layer because untraced runs of this
host-bound cell spread too widely for a bound (``PERF.md``).
"""


from harness import arith


def read(rec):
    return arith.rate(rec["images"], rec["seconds"])
