"""``raster_epilogue_kernel_roofline.loader`` (%, device trace).

The least time the card could take for the window's
``raster_epilogue_kernel`` launches (kernel RGB to the normalised bfloat16
batch), over the time they took.

A launch's bound is the larger of its bytes over 3.35 TB/s (HBM3, NVIDIA's
H100 SXM data sheet) and its operations over their peak: float32 operations
(subtract the mean, multiply by 1/std: 2 an element) over 67 TFLOP/s.
Bytes: the kernel RGB read once and the bfloat16 batch written once. In the
chip runs that set up the benchmark (NVIDIA H100 80GB HBM3, 700 W) the
share came out bytes-bound. Which term bounds it is logged with each traced
run (``detail``).
"""

from harness import roofline


def read(rec):
    return roofline.share(roofline.epilogue_parts(rec))


def detail(rec):
    return roofline.describe(roofline.epilogue_parts(rec))
