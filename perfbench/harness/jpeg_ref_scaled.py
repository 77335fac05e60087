"""The benchmark's plain reference decoder at a reduced scale: baseline JPEG
-> ``[ceil(H/scale), ceil(W/scale), 3]`` RGB, for scale 2, 4 or 8.

Written for the benchmark alone, in plain Python and NumPy: it imports
nothing of the program and takes nothing the program made.  The markers
and the Huffman-coded data are read by ``jpeg_ref`` (``parse``,
``coefficients``).  The scaled decode is written here from its definition
(the program's spec, "Reduced (scaled) IDCT"), as libjpeg's
``scale_denom`` decode does it:

- each block of a component whose sampling factors are f_y, f_x times
  below luma's takes an (f_y n) x (f_x n)-point inverse transform of its
  top-left frequencies, n = 8 / scale (luma n x n; 4:2:0 chroma at scale 2
  all 8 x 8), so chroma reaches the luma grid with no upsampling;
- the transform's basis is ``round(b * 2^13)`` with ``b[k, u] = 1/2 C_u
  cos((2k + 1) u pi / 2N)``, ``C_0 = 1/sqrt(2)``; pass 1 runs down each
  column of frequencies and descales by 11 bits, pass 2 along each row and
  descales by 15, each in int32 with wrap-around (pass 2's sums of
  extreme blocks overflow it; pass 1's stay within about half its range),
  rounding ``(x + 2^(s-1)) >> s``; samples are clamped to [-128, 127];
- dequantized coefficients are clamped to int16 first, and the colour is
  fixed-point BT.601 at 2^16, as ``jpeg_ref`` converts it.

At scale 1 it is ``jpeg_ref``'s full decode (the Loeffler transform, which
the n = 8 matrix would not reproduce).
"""

from __future__ import annotations

import math

import numpy as np

from harness import jpeg_ref

CONST_BITS = 13
PASS1_SHIFT = 11       # CONST_BITS - 2 pass bits
PASS2_SHIFT = 15       # CONST_BITS + 2 pass bits


def basis(points: int) -> np.ndarray:
    """``[points (k), points (u)]`` int64 basis of the reduced transform."""
    out = np.zeros((points, points), np.int64)
    for k in range(points):
        for u in range(points):
            c = 1.0 / math.sqrt(2.0) if u == 0 else 1.0
            out[k, u] = round(0.5 * c * math.cos(
                (2 * k + 1) * u * math.pi / (2 * points)) * (1 << CONST_BITS))
    return out


def _wrap32(x: np.ndarray) -> np.ndarray:
    """int64 values taken modulo 2^32 into int32's range."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _descale(x: np.ndarray, shift: int) -> np.ndarray:
    """An int32 sum (as int64) rounded and shifted as int32 arithmetic
    does it: the rounding constant added with wrap-around."""
    return _wrap32(_wrap32(x) + (1 << (shift - 1))) >> shift


def reduced_idct(deq: np.ndarray, ny: int, nx: int) -> np.ndarray:
    """``[..., 8, 8]`` dequantized blocks (row = vertical frequency) ->
    ``[..., ny, nx]`` samples centred at 0, clamped."""
    x = deq[..., :ny, :nx].astype(np.int64)
    cols = _descale(np.einsum("kv,...vu->...ku", basis(ny), x), PASS1_SHIFT)
    rows = _descale(np.einsum("pu,...ku->...kp", basis(nx), cols),
                    PASS2_SHIFT)
    return np.clip(rows, -128, 127)


def decode_rgb(data: bytes, idct: str = "int", scale: int = 2
               ) -> np.ndarray:
    """A baseline JPEG at 1/``scale`` -> ``[ceil(H/scale), ceil(W/scale),
    3]`` uint8 RGB."""
    if idct != "int":
        raise jpeg_ref.RefJpegError(f"no {idct!r} form of the scaled "
                                    "decode")
    if scale == 1:
        return jpeg_ref.decode_rgb(data)
    if scale not in (2, 4, 8):
        raise jpeg_ref.RefJpegError(f"scale must be 1, 2, 4 or 8, not "
                                    f"{scale}")
    n = 8 // scale
    info = jpeg_ref.parse(data)
    frame = info["frame"]
    comps = frame["comps"]
    blocks, _, _ = jpeg_ref.coefficients(info)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    planes = []
    for comp, blk in zip(comps, blocks):
        qt = info["qt"].get(comp["tq"])
        if qt is None:
            raise jpeg_ref.RefJpegError("missing quantization table")
        ny, nx = vmax // comp["v"] * n, hmax // comp["h"] * n
        if max(ny, nx) > 8:
            raise jpeg_ref.RefJpegError("a component sampled more than 2x "
                                        "below luma at this scale")
        deq = np.clip(blk.astype(np.int64) * qt.reshape(8, 8), -32768,
                      32767)
        spat = reduced_idct(deq, ny, nx)
        rows, cols = blk.shape[:2]
        planes.append(spat.transpose(0, 2, 1, 3).reshape(rows * ny,
                                                         cols * nx))
    height = -(-frame["height"] // scale)
    width = -(-frame["width"] // scale)
    y = planes[0][:height, :width]
    if len(comps) == 1:
        v = np.clip(y + 128, 0, 255).astype(np.uint8)
        return np.stack([v, v, v], axis=-1)
    cb, cr = (p[:height, :width] for p in planes[1:])
    y128 = y + 128
    rgb = np.stack([y128 + jpeg_ref.descale16(91881 * cr),
                    y128 + jpeg_ref.descale16(-22554 * cb - 46802 * cr),
                    y128 + jpeg_ref.descale16(116130 * cb)], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
