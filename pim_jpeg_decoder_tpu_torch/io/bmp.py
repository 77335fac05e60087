"""24bpp BMP writer (BITMAPCOREHEADER, BITMAPINFOHEADER above 64K px).

Output serializer with the exact file format of the reference's
``write_BMP`` (reference: src/bmp_writer.cpp:19-67): 14-byte file header,
12-byte BITMAPCOREHEADER (pixel data offset 0x1A), bottom-up rows, BGR byte
order, rows padded to 4-byte multiples (pad = width % 4, which equals the
24bpp padding (4 - 3*width % 4) % 4 — see SURVEY.md C23).

BITMAPCOREHEADER stores 16-bit dimensions; images with a dimension at or
above 65,536 px fall back to the 40-byte BITMAPINFOHEADER (32-bit signed
dims).  The remaining ceiling is the BMP FORMAT's own: 32-bit unsigned
file-size fields cap any BMP at 4 GiB (~1.43 gigapixels at 24bpp), which
the writer rejects with a clean error.  The reference shares the 16-bit
header and therefore the lower ceiling; the fallback is a superset, not a
format divergence, for every file the reference can produce.

Unlike the reference, which walks pixel-by-pixel re-deriving the
(dpu, block, position) scatter per pixel (reference: src/bmp_writer.cpp:51-60),
this writer takes a dense ``[H, W, 3]`` RGB array and emits rows with
vectorized NumPy — the layout inversion already happened on device/host
during raster assembly.

Also includes a strict reader for round-trip tests.
"""

from __future__ import annotations

import struct
import threading

import numpy as np

_CORE_OFFSET = 26  # 14-byte file header + 12-byte BITMAPCOREHEADER
_INFO_OFFSET = 54  # 14-byte file header + 40-byte BITMAPINFOHEADER


# Fused YCbCr->BMP writes completed (engagement evidence: tests pin that
# the engine's write path actually reaches the one-pass native serializer
# rather than silently falling back to the two-pass raster route).
# Finish-pool workers increment concurrently; += is not atomic.
_fused_ycbcr_writes = 0
_fused_lock = threading.Lock()


def fused_write_count() -> int:
    return _fused_ycbcr_writes


def _bmp_scaffold(height: int, width: int):
    """Header-complete BMP buffer + a writable view of its pixel rows:
    ``(buf, rows, row_bytes)`` with ``rows`` shaped [height, row_bytes]."""
    if width >= 1 << 31 or height >= 1 << 31:
        raise ValueError(
            f"BMP stores 32-bit signed dimensions; {width}x{height} too large")
    pad = width % 4
    row_bytes = width * 3 + pad

    if width < 1 << 16 and height < 1 << 16:
        # Reference-exact format (reference: src/bmp_writer.cpp:19-44).
        offset = _CORE_OFFSET
        dib = struct.pack("<IHHHH", 12, width, height, 1, 24)
    else:
        offset = _INFO_OFFSET
        dib = None  # packed below, after the file-size check
    file_size = offset + height * row_bytes
    if file_size > 0xFFFFFFFF:
        # bfSize/biSizeImage are unsigned 32-bit: the BMP FORMAT caps files
        # at 4 GiB, so such an image has no valid BMP encoding at all.
        raise ValueError(
            f"BMP files cap at 4 GiB (32-bit size fields); {width}x{height}"
            f" needs {file_size} bytes")
    if dib is None:
        dib = struct.pack("<IiiHHIIiiII", 40, width, height, 1, 24,
                          0, height * row_bytes, 2835, 2835, 0, 0)
    buf = bytearray(file_size)
    struct.pack_into("<2sIII", buf, 0, b"BM", file_size, 0, offset)
    buf[14:offset] = dib
    rows = np.frombuffer(buf, np.uint8, height * row_bytes,
                         offset).reshape(height, row_bytes)
    return buf, rows, row_bytes


def encode_bmp(rgb: np.ndarray) -> bytes:
    """Encode an ``[H, W, 3]`` uint8 RGB array as a 24bpp BMP byte string."""
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"expected [H, W, 3] uint8 RGB, got {rgb.shape} {rgb.dtype}")
    height, width = rgb.shape[:2]
    buf, rows, _row_bytes = _bmp_scaffold(height, width)

    # Bottom-up BGR rows with padding, straight into the output buffer.
    # The C++ fast path does the flip+swizzle in ONE memory-bound pass
    # (~6x the NumPy fallback's reverse-strided gather + copy + tobytes).
    native_ok = False
    if height > 0 and width > 0:  # degenerate dims: NumPy path only
        try:
            from pim_jpeg_decoder_tpu_torch.native.binding import bmp_rows_cpp
            native_ok = bmp_rows_cpp(np.ascontiguousarray(rgb), rows)
        except ImportError:
            pass
    if not native_ok:
        rows[:, width * 3:] = 0
        rows[:, : width * 3] = rgb[::-1, :, ::-1].reshape(height, width * 3)
    return bytes(buf)


def write_bmp(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_bmp(rgb))


def write_bmp_ycbcr(path: str, planes: np.ndarray, mcu_off: int, v: int,
                    h: int, ncomp: int, mcu_rows: int, mcu_cols: int,
                    height: int, width: int) -> None:
    """Write a BMP straight from the device's YCbCr wire planes.

    Fuses nearest-neighbor upsample + fixed-point BT.601 + the bottom-up
    BGR row serialization into ONE native pass over the output buffer —
    byte-identical to ``write_bmp(path, assemble_raster_ycbcr(...))``
    (tested) while skipping the intermediate [H, W, 3] raster that the
    two-pass route writes and re-reads (~6 B/px less memory traffic; the
    BMP path's largest non-entropy host cost, VERDICT r3 item 7).
    Requires the native library; callers gate on ``native_available()``.
    """
    global _fused_ycbcr_writes
    from pim_jpeg_decoder_tpu_torch.native.binding import ycbcr_to_bmp_rows_cpp
    buf, rows, row_bytes = _bmp_scaffold(height, width)
    ycbcr_to_bmp_rows_cpp(planes, mcu_off, v, h, ncomp, mcu_rows, mcu_cols,
                          height, width, row_bytes, rows)
    with _fused_lock:
        _fused_ycbcr_writes += 1
    with open(path, "wb") as f:
        f.write(buf)


def read_bmp(data) -> np.ndarray:
    """Parse a 24bpp BMP (CORE or INFO header) back into ``[H, W, 3]`` RGB.

    Accepts the file bytes or a filesystem path.
    """
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = f.read()
    magic, _file_size, _reserved, offset = struct.unpack_from("<2sIII", data, 0)
    if magic != b"BM":
        raise ValueError("not a BMP file")
    hdr_size = struct.unpack_from("<I", data, 14)[0]
    if hdr_size == 12:
        width, height, planes, bpp = struct.unpack_from("<HHHH", data, 18)
    elif hdr_size == 40:
        width, height, planes, bpp, compression = struct.unpack_from(
            "<iiHHI", data, 18)
        if compression != 0:
            raise ValueError(f"unsupported BMP compression {compression}")
        if width < 0 or height < 0:
            raise ValueError("top-down / negative-dim BMPs unsupported")
    else:
        raise ValueError(f"expected BITMAPCOREHEADER (12) or BITMAPINFOHEADER "
                         f"(40), got header size {hdr_size}")
    if planes != 1 or bpp != 24:
        raise ValueError(f"unsupported BMP: planes={planes} bpp={bpp}")
    pad = width % 4
    row_bytes = width * 3 + pad
    pixels = np.frombuffer(data, dtype=np.uint8, count=height * row_bytes, offset=offset)
    rows = pixels.reshape(height, row_bytes)[:, : width * 3]
    return rows.reshape(height, width, 3)[::-1, :, ::-1].copy()
