"""The single-image JPEG decode pipeline on PyTorch.

Counterpart of ``pim_jpeg_decoder_tpu/models/pipeline.py`` (which imports
the Pallas kernel module).  The host stages are the port's own copies of
the JAX package's host layer, at the same relative paths:

  scan_jpeg (marker parse)            codec/scanner.py
  entropy decode (C++ fast path)      native/ (or codec/progressive.py)
  quant pool                          build_qpool below
  device decode                       ops.decode_kernel.decode_mcus (CUDA)
  raster assembly / BMP               native.binding C++ finishers, io/bmp.py

Every device is explicit: ``device="cuda"`` on a machine without a card
raises instead of running on the CPU.  ``decode_scaled`` (reduced-IDCT
kernel) and ``decode_region`` (crop box) are the JAX package's
single-image variants; device-resident batches are in
``models/input_pipeline.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from pim_jpeg_decoder_tpu_torch.codec.header import JpegHeader
from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu_torch.io.bmp import write_bmp
from pim_jpeg_decoder_tpu_torch.native import native_available
from pim_jpeg_decoder_tpu_torch.native.binding import (raster_rgb_cpp,
                                                       ycbcr_to_rgb_cpp)
from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (coeffs_to_device,
                                                          decode_mcus,
                                                          qpool_to_device)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def entropy_decode(header: JpegHeader, out=None,
                   threads: int = 1) -> np.ndarray:
    """``[num_mcus, g, 64]`` int16 natural-order coefficients (baseline via
    the native C++ decoder, progressive via the multi-scan decoder)."""
    if header.progressive:
        from pim_jpeg_decoder_tpu_torch.codec.progressive import (
            decode_progressive)
        coeffs = decode_progressive(header, threads=threads)
        if out is not None:
            out[...] = coeffs
            return out
        return coeffs
    from pim_jpeg_decoder_tpu_torch.native import decode_scan_native
    return decode_scan_native(header, out=out, threads=threads)


def build_qpool(headers: Sequence[JpegHeader], mode: S.ModeSpec) -> np.ndarray:
    """Per-image, per-slot quantizer rows: ``[num_images, g, 64]`` float32."""
    qpool = np.zeros((len(headers), mode.g, 64), dtype=np.float32)
    for i, header in enumerate(headers):
        for s, (ci, _, _) in enumerate(header.slot_components()):
            qpool[i, s] = header.component_qt(header.components[ci])
    return qpool


def _require_native() -> None:
    if not native_available():
        raise RuntimeError("the native C++ host library is unavailable "
                           "(needs g++; PIM_JPEG_TPU_NO_NATIVE unset)")


def assemble_raster_raw(header: JpegHeader, raw_rgb: np.ndarray,
                        mcu_off: int = 0) -> np.ndarray:
    """Kernel RGB output ``[3, luma_slots, 64, M]`` -> ``[H, W, 3]``,
    reading the image's MCUs at ``mcu_off`` of the (multi-image) batch."""
    return assemble_raster_raw_scaled(header, raw_rgb, 1, mcu_off)


def assemble_raster_raw_scaled(header: JpegHeader, raw_rgb: np.ndarray,
                               scale: int, mcu_off: int = 0) -> np.ndarray:
    """Scaled-decode kernel output ``[3, luma_slots, nn, M]`` ->
    ``[ceil(H/scale), ceil(W/scale), 3]`` (nn = (8/scale)^2); ``mcu_off``
    as in :func:`assemble_raster_raw`."""
    _require_native()
    mode = S.mode_for(header.mode_key)
    out = raster_rgb_cpp(raw_rgb, mode.v, mode.h, 8 // scale,
                         header.mcu_rows, header.mcu_cols,
                         -(-header.height // scale), -(-header.width // scale),
                         mcu_off=mcu_off)
    if out is None:
        raise ValueError(f"raw RGB {raw_rgb.shape} {raw_rgb.dtype} does not "
                         f"hold {header.num_mcus} {mode.name} MCUs at "
                         f"{mcu_off} for scale {scale} (or is not "
                         f"C-contiguous)")
    return out


def assemble_raster_ycbcr(header: JpegHeader, planes: np.ndarray,
                          mcu_off: int = 0) -> np.ndarray:
    """Kernel YCbCr output ``[g, 64, M]`` -> ``[H, W, 3]``: the host finishes
    upsample + BT.601 with the same integer spec (bit-identical to the RGB
    kernel)."""
    _require_native()
    mode = S.mode_for(header.mode_key)
    return ycbcr_to_rgb_cpp(planes, mcu_off, mode.v, mode.h, mode.ncomp,
                            header.mcu_rows, header.mcu_cols, header.height,
                            header.width)


@dataclasses.dataclass
class DecodeResult:
    rgb: np.ndarray
    header: JpegHeader


def _decode_grid(header: JpegHeader, coeffs: np.ndarray, dev: torch.device,
                 **kw) -> np.ndarray:
    """Decode one image's (or sub-grid's) coefficients on ``dev`` with the
    image's own quantizers; returns the kernel output on the host."""
    mode = S.mode_for(header.mode_key)
    x = coeffs_to_device(coeffs, dev)
    qidx = torch.zeros(coeffs.shape[0], dtype=torch.int32, device=dev)
    qpool = qpool_to_device(build_qpool([header], mode), dev)
    return decode_mcus(x, qidx, qpool, mode, **kw).cpu().numpy()


class TorchJpegDecoder:
    """Single-stream decoder: one image per device call on ``device``.

    ``transport`` picks the kernel as in the JAX package: "auto" fetches
    YCbCr planes when they are fewer bytes than RGB (every mode but 4:4:4),
    "rgb" / "ycbcr" force one.  For many images use
    :class:`pim_jpeg_decoder_tpu_torch.runtime.engine.DecodeEngine`.
    """

    def __init__(self, device="cuda", transport: str = "auto"):
        if transport not in ("auto", "rgb", "ycbcr"):
            raise ValueError(
                f"transport must be auto/rgb/ycbcr, got {transport!r}")
        self.device = resolve_device(device)
        self.transport = transport

    def decode(self, data: bytes) -> DecodeResult:
        header = scan_jpeg(data)
        coeffs = entropy_decode(header)
        mode = S.mode_for(header.mode_key)
        ycbcr = (self.transport == "ycbcr"
                 or (self.transport == "auto" and mode.ycbcr_saves_bytes))
        host = _decode_grid(header, coeffs, self.device, raw=not ycbcr,
                            ycbcr=ycbcr)
        if ycbcr:
            return DecodeResult(assemble_raster_ycbcr(header, host), header)
        return DecodeResult(assemble_raster_raw(header, host), header)


def decode_bytes(data: bytes, device="cuda") -> np.ndarray:
    """Decode one JPEG byte string to an ``[H, W, 3]`` uint8 RGB array."""
    return TorchJpegDecoder(device).decode(data).rgb


def decode_scaled(data: bytes, scale: int, device="cuda") -> np.ndarray:
    """Scaled decode: ``[ceil(H/scale), ceil(W/scale), 3]`` for scale
    2/4/8 through the reduced-IDCT kernel (scale 1 is a full decode).
    Counterpart of the JAX package's ``decode_scaled``."""
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")
    if scale == 1:
        return decode_bytes(data, device)
    dev = resolve_device(device)
    header = scan_jpeg(data)
    raw = _decode_grid(header, entropy_decode(header), dev, raw=True,
                       scale=scale)
    return assemble_raster_raw_scaled(header, raw, scale)


def decode_region(data: bytes, y0: int, x0: int, height: int, width: int,
                  device="cuda") -> np.ndarray:
    """Decode only the crop box ``[y0:y0+height, x0:x0+width]``: the device
    decodes the MCU sub-grid covering the box, and the pixels equal the
    same slice of a full decode.  Counterpart of the JAX package's
    ``decode_region``."""
    dev = resolve_device(device)
    header = scan_jpeg(data)
    if not (0 <= y0 and 0 <= x0 and height > 0 and width > 0
            and y0 + height <= header.height and x0 + width <= header.width):
        raise ValueError(
            f"crop [{y0}:{y0 + height}, {x0}:{x0 + width}] outside "
            f"{header.height}x{header.width}")
    coeffs = entropy_decode(header)
    mode = S.mode_for(header.mode_key)
    px_h, px_w = mode.mcu_px_h, mode.mcu_px_w
    r0, c0 = y0 // px_h, x0 // px_w
    r1 = -(-(y0 + height) // px_h)
    c1 = -(-(x0 + width) // px_w)
    grid = (coeffs[: header.num_mcus]
            .reshape(header.mcu_rows, header.mcu_cols, mode.g, 64))
    sub = np.ascontiguousarray(grid[r0:r1, c0:c1]).reshape(-1, mode.g, 64)
    # A header describing just the sub-grid (its geometry derives from
    # width and height).
    sub_header = dataclasses.replace(header, height=(r1 - r0) * px_h,
                                     width=(c1 - c0) * px_w)
    if mode.ycbcr_saves_bytes:
        planes = _decode_grid(header, sub, dev, ycbcr=True)
        raster = assemble_raster_ycbcr(sub_header, planes)
    else:
        raster = assemble_raster_raw(
            sub_header, _decode_grid(header, sub, dev, raw=True))
    oy, ox = y0 - r0 * px_h, x0 - c0 * px_w
    return np.ascontiguousarray(raster[oy:oy + height, ox:ox + width])


def output_path(input_path: str) -> str:
    """Replace the extension with .bmp, or append .bmp if there is none."""
    stem, ext = os.path.splitext(input_path)
    return (stem if ext else input_path) + ".bmp"


def decode_file(path: str, out_path: Optional[str] = None,
                device="cuda") -> str:
    """Decode a JPEG file, write the BMP next to it; returns the BMP path."""
    with open(path, "rb") as f:
        data = f.read()
    out = out_path or output_path(path)
    write_bmp(out, decode_bytes(data, device))
    return out
