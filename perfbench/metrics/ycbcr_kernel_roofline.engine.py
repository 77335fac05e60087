"""``ycbcr_kernel_roofline.engine`` (%, device trace).

The least time the card could take for the window's ``ycbcr_kernel``
launches (4:2:0 files: YCbCr planes back to the host), over the time they
took.

A launch's bound is the larger of its bytes over 3.35 TB/s (HBM3, NVIDIA's
H100 SXM data sheet) and its operations over their peak: integer operations
over 33.5 T op/s (derived in ``harness/arith.py``: the data sheet's 67
TFLOP/s of float32 count an FMA as two). Bytes: the coefficients on the
wire, the quantizer indices, each image's quantizer rows and the output,
each once. The work is the MCUs of the files decoded in the window: MCUs a
batch is padded with count in the kernel's time and not in its bound. In
the chip runs that set up the benchmark (NVIDIA H100 80GB HBM3, 700 W) the
share came out bytes-bound (int16 wire at quality 90). Which term bounds it
is logged with each traced run (``detail``).
"""

from harness import roofline


def read(rec):
    return roofline.share(roofline.decode_parts(rec, "ycbcr_kernel"))


def detail(rec):
    return roofline.describe(roofline.decode_parts(rec, "ycbcr_kernel"))
