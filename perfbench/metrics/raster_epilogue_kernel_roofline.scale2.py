"""``raster_epilogue_kernel_roofline.scale2`` (%, device trace).

The least time the card could take for the window's
``raster_epilogue_kernel`` launches over the scaled decode's output (kernel
RGB at 1/2 to the normalised bfloat16 batch; the banded form, since an MCU
row of 4-point blocks is no whole 16-pixel run), over the time they took.

A launch's bound is the larger of its bytes over 3.35 TB/s (HBM3, NVIDIA's
H100 SXM data sheet) and its operations over their peak: float32
operations (subtract the mean, multiply by 1/std: 2 an element) over 67
TFLOP/s.  Bytes: the scaled kernel RGB of the files' MCUs read once (3 gy
n^2 bytes an MCU, ``harness/arith_scaled.epilogue_counts``) and the batch
written once.  Which term bounds it is logged with each traced run
(``detail``).
"""

from harness import arith, arith_scaled, roofline


def parts(rec) -> list:
    """The bound and time of the window's epilogue launches; nothing where
    the run has no trace or no such launch."""
    if rec["trace"] is None:
        return []
    launches = rec["trace"].launches("raster_epilogue_kernel")
    if not launches:
        return []
    work = rec["work"]
    (g, mcus), = work["mcus"].items()
    nbytes, flops = arith_scaled.epilogue_counts(
        mcus, arith.LUMA_BLOCKS[g], 8 // work["scale"],
        work["out_elements"], work["out_bytes"])
    t, term = arith.bound_s(nbytes, flops, arith.FP32_FLOPS)
    return [(t, sum(e.seconds for _, e in launches), {term: t})]


def read(rec):
    return roofline.share(parts(rec))


def detail(rec):
    return roofline.describe(parts(rec))
