"""``device.idle_share.loader`` (%, device trace): one minus the union of the
kernel, memcpy and memset intervals on the card over the profiled window.
"""


def read(rec):
    trace = rec["trace"]
    return None if trace is None else trace.idle_share()
