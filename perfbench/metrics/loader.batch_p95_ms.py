"""``loader.batch_p95_ms`` (ms, host clock): the 95th percentile over every
batch of the traced window of the time from the consumer's ``next()`` to the
batch being ready on the card (an event recorded behind the yielded tensor,
waited on).  Per layer for the reason ``loader.images_per_s`` gives.
"""

from harness import arith


def read(rec):
    if not rec["latencies"]:
        return None
    return 1e3 * arith.percentile(rec["latencies"], 95)
