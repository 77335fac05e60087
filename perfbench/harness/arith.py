"""The benchmark's own arithmetic: peaks of the card, the bytes and
operations of each kernel launch from its shapes, percentiles and rates.

Later changes to the program do not change any of this.

Peaks (one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at the full 700 W
power limit):

- HBM3: 3.35 TB/s.
- float32 outside the tensor cores: 67 TFLOP/s.
- int32: not published.  Derived: the sheet's 67 TFLOP/s count an FMA as
  two operations on the 128 lanes each SM issues to every clock (4
  schedulers, one warp instruction each); an integer add, multiply, shift
  or compare is one operation on the same lanes, and no instruction mix
  issues more, so integer operations peak at 67 / 2 = 33.5 T op/s.

A launch's bound is the larger of its bytes over the HBM rate and its
operations over the peak that bounds them: each input byte read once, each
output byte written once (inputs read again from the cache are free).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
INT32_OPS = FP32_FLOPS / 2

# Integer operations of the decode spec, counted from its definition:
# one 8-point Loeffler pass is 56 (even part 16, odd part 24, 8 adds and 8
# rounding shifts out), a block 16 passes and 2 x 64 clamps; dequantize a
# multiply and 2 clamps a coefficient; fixed-point BT.601 21 an RGB pixel
# (level shift 1; R and B: multiply, bias, shift, add, 2 clamps; G: 2
# multiplies, 2 adds, shift, add, 2 clamps); a YCbCr sample's level shift 1.
IDCT_BLOCK_OPS = 16 * 56 + 2 * 64
DEQUANT_COEF_OPS = 3
COLOR_PIXEL_OPS = 21
LEVEL_SHIFT_OPS = 1
# The epilogue's float32 work an output element: subtract the mean,
# multiply by 1/std (the conversions in and out are not counted).
NORM_ELEMENT_FLOPS = 2

# Blocks an MCU (g) -> luma blocks (gy), for the modes the traffic has.
LUMA_BLOCKS = {1: 1, 3: 1, 4: 2, 6: 4}


def decode_mcu_counts(kind: str, g: int, wire_bytes: int
                      ) -> Tuple[float, float]:
    """``(bytes, int32 operations)`` of one MCU through ``rgb_kernel`` or
    ``ycbcr_kernel``: its coefficients on the wire, its quantizer index
    (4 bytes) and its output (RGB: 3 bytes a luma pixel; YCbCr: one a
    sample); dequantize, IDCT and BT.601 (RGB) or the level shift
    (YCbCr)."""
    gy = LUMA_BLOCKS[g]
    read = g * 64 * wire_bytes + 4
    if kind == "rgb":
        written = 3 * gy * 64
        colour = gy * 64 * (COLOR_PIXEL_OPS if g > 1 else 1)
    elif kind == "ycbcr":
        written = g * 64
        colour = g * 64 * LEVEL_SHIFT_OPS
    else:
        raise ValueError(f"no counts for kernel {kind!r}")
    ops = g * (IDCT_BLOCK_OPS + 64 * DEQUANT_COEF_OPS) + colour
    return read + written, ops


def quantizer_bytes(g: int) -> int:
    """One image's quantizer rows, read once: g x 64 int32."""
    return g * 64 * 4


def epilogue_counts(mcus: int, g: int, out_elements: int,
                    out_bytes_each: int) -> Tuple[float, float]:
    """``(bytes, float32 operations)`` of the raster epilogue over ``mcus``
    MCUs of kernel RGB ([3, gy, 64, M] uint8, read once) into
    ``out_elements`` elements of ``out_bytes_each`` bytes."""
    read = 3 * LUMA_BLOCKS[g] * 64 * mcus
    return (read + out_elements * out_bytes_each,
            out_elements * NORM_ELEMENT_FLOPS)


def bound_s(nbytes: float, ops: float, op_rate: float) -> Tuple[float, str]:
    """``(seconds, "bytes" | "operations")``: the least time the card
    could take, and which term sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / op_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    order statistics (rank q/100 * (n - 1))."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    rank = q / 100.0 * (len(xs) - 1)
    lo = math.floor(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return work / seconds


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cursor = [], lo
    for a, b in sorted(intervals):
        if a > cursor:
            out.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        out.append((cursor, hi))
    return [(a, b) for a, b in out if b > a]


def stage_delta(after: Dict[str, Tuple[float, int]],
                before: Dict[str, Tuple[float, int]]) -> Dict[str, float]:
    """Seconds of each stage between two ``StageTimers.snapshot()``s."""
    return {k: v[0] - before.get(k, (0.0, 0))[0] for k, v in after.items()}
