"""``loader_kernel_us_per_image`` (us/image, device trace): the card's
compute time that the batch loader takes, per image of the batches that
came back ready in the window: the summed durations of every kernel on the
card in the window, over the images.  A training job that shares the card
with its input pipeline gives this time up to it.

Copies are left out: they run on the copy engines beside the card's compute,
and their time over the PCIe link swings by a tenth between runs of one
machine.  Every kernel of the window is the program's: the benchmark's own
device work in the window is copies of the batches it keeps.  Untraced runs
record the device's activity alone (no host operations), so that the host
path runs as it would unprofiled.
"""


def read(rec):
    trace = rec["trace"]
    if trace is None or rec["images"] <= 0:
        return None
    seconds = trace.kernel_seconds()
    return 1e6 * seconds / rec["images"] if seconds > 0 else None
