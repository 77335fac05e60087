"""``rgb_kernel_roofline.crops`` (%, device trace).

The least time the card could take for the window's ``rgb_kernel``
launches of the crop loader (one a sampling mode a batch: 4:2:0 and 4:4:4),
over the time they took.

A launch's bound is the larger of its bytes over 3.35 TB/s (HBM3, NVIDIA's
H100 SXM data sheet) and its operations over their peak: integer operations
over 33.5 T op/s (derived in ``harness/arith.py``). Bytes: the coefficients
on the wire, the quantizer indices, each image's quantizer rows and the
output, each once. The work is the MCUs each crop's pixels touch (14 or 15
a side at 4:2:0, 28 or 29 at 4:4:4, from the driver's ``work``), shared
among a mode's launches by their grids: the slack MCUs of the staged
sub-grid count in the kernel's time and not in its bound. Which term bounds
it is logged with each traced run (``detail``).
"""

from harness import roofline


def read(rec):
    return roofline.share(roofline.decode_parts(rec, "rgb_kernel"))


def detail(rec):
    return roofline.describe(roofline.decode_parts(rec, "rgb_kernel"))
