"""The benchmark's own counts of the scaled decode: the bytes and int32
operations of one MCU through ``rgb_scaled_kernel``, and of the raster
epilogue over its output, counted from the work (the program's spec,
"Reduced (scaled) IDCT") and not from how a kernel does it.  Peaks and the
bound are ``harness/arith.py``'s.

Per MCU of the decode, at n = 8 / scale points:

- bytes: the 32-byte sectors that hold the rows of each block that the
  reduced IDCT reads (rows 0..n-1 of a luma block, 0..f_y n - 1 of a chroma
  block sampled f_y times below luma down; a block's rows are contiguous on
  the wire, and a block starts on a sector), the quantizer index (4
  bytes), and its output, 3 bytes a luma pixel (3 gy n^2); each image's
  quantizer rows once (``arith.quantizer_bytes``);
- operations: a dequantize (multiply and 2 clamps) of each coefficient
  read, each reduced IDCT in the fewest integer operations that give the
  definition's result (the rounded basis by its even/odd split, which is
  exact in int32's wrap-around; a descale of 2 an output of each pass; 2
  clamps a sample), and BT.601 (21 a pixel; gray a level shift).

The raster epilogue over scaled kernel RGB reads 3 gy n^2 bytes an MCU
once, writes its output elements once, and takes 2 float32 operations an
element (``arith.NORM_ELEMENT_FLOPS``).

Padding MCUs count as time and not as work: callers count the MCUs of the
files decoded.
"""

from __future__ import annotations

from typing import Tuple

from harness import arith

SECTOR = 32


def reduced_pass_ops(n: int) -> int:
    """Integer operations of the sums of one n-point pass: the n/2-point
    pass of the even-indexed inputs, (n/2)^2 multiplies and n/2 (n/2 - 1)
    adds for the odd sums, n adds to combine the halves; one multiply at
    n = 1."""
    if n == 1:
        return 1
    h = n // 2
    return reduced_pass_ops(h) + h * h + h * (h - 1) + n


def reduced_idct_ops(ny: int, nx: int) -> int:
    """One (ny x nx)-point reduced IDCT: nx passes of ny points and ny of
    nx points, a descale (add, shift) an output of each, 2 clamps a
    sample."""
    return (nx * (reduced_pass_ops(ny) + 2 * ny)
            + ny * (reduced_pass_ops(nx) + 2 * nx) + 2 * ny * nx)


def _blocks(h: int, v: int, nc: int, n: int):
    """``(count, points down, points across)`` of an MCU's block kinds."""
    out = [(h * v, n, n)]
    if nc == 3:
        out.append((2, min(8, v * n), min(8, h * n)))
    return out


def coefs_read(h: int, v: int, nc: int, n: int) -> int:
    """Coefficients of one MCU that the reduced IDCTs read."""
    return sum(k * ny * nx for k, ny, nx in _blocks(h, v, nc, n))


def decode_mcu_counts(h: int, v: int, nc: int, n: int, wire_bytes: int
                      ) -> Tuple[int, int]:
    """``(bytes, int32 operations)`` of one MCU through
    ``rgb_scaled_kernel`` at n points (luma sampling h x v, nc
    components)."""
    gy = h * v
    wire = sum(k * -(-ny * 8 * wire_bytes // SECTOR) * SECTOR
               for k, ny, _ in _blocks(h, v, nc, n))
    idct = sum(k * reduced_idct_ops(ny, nx)
               for k, ny, nx in _blocks(h, v, nc, n))
    deq = arith.DEQUANT_COEF_OPS * coefs_read(h, v, nc, n)
    colour = gy * n * n * (arith.COLOR_PIXEL_OPS if nc == 3
                           else arith.LEVEL_SHIFT_OPS)
    return wire + 4 + 3 * gy * n * n, idct + deq + colour


def epilogue_counts(mcus: int, gy: int, n: int, out_elements: int,
                    out_bytes_each: int) -> Tuple[int, int]:
    """``(bytes, float32 operations)`` of the raster epilogue over
    ``mcus`` MCUs of scaled kernel RGB ([3, gy, n^2, M] uint8, read once)
    into ``out_elements`` elements of ``out_bytes_each`` bytes."""
    return (3 * gy * n * n * mcus + out_elements * out_bytes_each,
            out_elements * arith.NORM_ELEMENT_FLOPS)
