"""``rgb_scaled_kernel_roofline.scale2`` (%, device trace).

The least time the card could take for the window's ``rgb_scaled_kernel``
launches (the reduced-IDCT decode at 1/2, RGB for the epilogue), over the
time they took.

A launch's sampling mode, points and wire come from its demangled name
(``rgb_scaled_kernel<T, H, V, NC, N, VEC16>``: T ``short`` for the int16
wire, ``signed char`` for int8), its MCU count from its grid (32 MCUs a
block).  The work is the MCUs of the files decoded in the window, shared
among a mode's launches in proportion to their grids, so MCUs a launch is
padded with count in its time and not in its bound.  A launch's bound is
the larger of its bytes over 3.35 TB/s (HBM3, NVIDIA's H100 SXM data
sheet) and its integer operations over 33.5 T op/s (derived in
``harness/arith.py``), with the bytes and operations of
``harness/arith_scaled.decode_mcu_counts`` an MCU (the sectors of the rows
the reduced IDCT reads, the quantizer index, the output) and each image's
quantizer rows once.  Which term bounds it is logged with each traced run
(``detail``).
"""

from collections import defaultdict

from harness import arith, arith_scaled, roofline

KERNEL = "rgb_scaled_kernel"


def parts(rec) -> list:
    """The bound and time of the window's launches; nothing where the run
    has no trace or no such launch."""
    if rec["trace"] is None:
        return []
    groups = defaultdict(lambda: [0, 0.0])   # (h, v, nc, n, wire) -> M, s
    for args, e in rec["trace"].launches(KERNEL):
        key = (int(args[1]), int(args[2]), int(args[3]), int(args[4]),
               roofline._WIRE_BYTES[args[0]])
        groups[key][0] += e.grid[0] * roofline.TILE_MCUS
        groups[key][1] += e.seconds
    launched = defaultdict(int)
    for (h, v, nc, _, _), (m, _) in groups.items():
        launched[h * v + 2 if nc == 3 else 1] += m
    out = []
    for (h, v, nc, n, wire), (m, sec) in groups.items():
        g = h * v + 2 if nc == 3 else 1
        share = m / launched[g]
        mcus = rec["work"]["mcus"].get(g, 0) * share
        images = rec["work"]["images"].get(g, 0) * share
        nbytes, ops = arith_scaled.decode_mcu_counts(h, v, nc, n, wire)
        t, term = arith.bound_s(mcus * nbytes
                                + images * arith.quantizer_bytes(g),
                                mcus * ops, arith.INT32_OPS)
        out.append((t, sec, {term: t}))
    return out


def read(rec):
    return roofline.share(parts(rec))


def detail(rec):
    return roofline.describe(parts(rec))
