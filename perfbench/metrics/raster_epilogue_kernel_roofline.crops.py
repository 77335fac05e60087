"""``raster_epilogue_kernel_roofline.crops`` (%, device trace).

The least time the card could take for the window's
``raster_epilogue_kernel`` launches of the crop loader (its banded form with
crop origins, one launch a sampling mode a batch, each writing its images
into their rows of the batch), over the time they took.

A launch's bound is the larger of its bytes over 3.35 TB/s (HBM3, NVIDIA's
H100 SXM data sheet) and its operations over their peak: float32 operations
(subtract the mean, multiply by 1/std: 2 an element) over 67 TFLOP/s.
Bytes: the kernel RGB of the MCUs each crop's pixels touch, read once, and
the bfloat16 batch written once, summed over the modes of the window's work
(``harness/arith.epilogue_counts`` a mode). Which term bounds it is logged
with each traced run (``detail``).
"""

from harness import arith, roofline


def parts(rec) -> list:
    """The bound and time of the window's epilogue launches; nothing where
    the run has no trace or no such launch."""
    if rec["trace"] is None:
        return []
    launches = rec["trace"].launches("raster_epilogue_kernel")
    if not launches:
        return []
    work = rec["work"]
    images = sum(work["images"].values())
    nbytes = flops = 0.0
    for g, mcus in work["mcus"].items():
        b, f = arith.epilogue_counts(
            mcus, g, work["out_elements"] * work["images"][g] / images,
            work["out_bytes"])
        nbytes += b
        flops += f
    t, term = arith.bound_s(nbytes, flops, arith.FP32_FLOPS)
    return [(t, sum(e.seconds for _, e in launches), {term: t})]


def read(rec):
    return roofline.share(parts(rec))


def detail(rec):
    return roofline.describe(parts(rec))
