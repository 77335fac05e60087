"""The single-image JPEG decode pipeline on PyTorch.

Counterpart of ``pim_jpeg_decoder_tpu/models/pipeline.py`` (which imports
the Pallas kernel module, so it cannot be reused here).  The host stages are
the JAX package's own, imported rather than copied:

  scan_jpeg (marker parse)            codec/scanner.py
  entropy decode (C++ fast path)      native/ (or codec/progressive.py)
  quant pool                          build_qpool below
  device decode                       ops.decode_kernel.decode_mcus (CUDA)
  raster assembly / BMP               native.binding C++ finishers, io/bmp.py

Every device is explicit: ``device="cuda"`` on a machine without a card
raises instead of running on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from pim_jpeg_decoder_tpu.codec.header import JpegHeader
from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.io.bmp import write_bmp
from pim_jpeg_decoder_tpu.native import native_available
from pim_jpeg_decoder_tpu.native.binding import (raster_rgb_cpp,
                                                 ycbcr_to_rgb_cpp)
from pim_jpeg_decoder_tpu.ops import specs as S
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
        from pim_jpeg_decoder_tpu.codec.progressive import decode_progressive
        coeffs = decode_progressive(header, threads=threads)
        if out is not None:
            out[...] = coeffs
            return out
        return coeffs
    from pim_jpeg_decoder_tpu.native import decode_scan_native
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
    _require_native()
    mode = S.mode_for(header.mode_key)
    out = raster_rgb_cpp(raw_rgb, mode.v, mode.h, 8, header.mcu_rows,
                         header.mcu_cols, header.height, header.width,
                         mcu_off=mcu_off)
    if out is None:
        raise ValueError(f"raw RGB {raw_rgb.shape} {raw_rgb.dtype} does not "
                         f"hold {header.num_mcus} {mode.name} MCUs at "
                         f"{mcu_off} (or is not C-contiguous)")
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
        dev = self.device
        x = coeffs_to_device(coeffs, dev)
        qidx = torch.zeros(header.num_mcus, dtype=torch.int32, device=dev)
        qpool = qpool_to_device(build_qpool([header], mode), dev)
        ycbcr = (self.transport == "ycbcr"
                 or (self.transport == "auto" and mode.ycbcr_saves_bytes))
        out = decode_mcus(x, qidx, qpool, mode, raw=not ycbcr, ycbcr=ycbcr)
        host = out.cpu().numpy()
        if ycbcr:
            return DecodeResult(assemble_raster_ycbcr(header, host), header)
        return DecodeResult(assemble_raster_raw(header, host), header)


def decode_bytes(data: bytes, device="cuda") -> np.ndarray:
    """Decode one JPEG byte string to an ``[H, W, 3]`` uint8 RGB array."""
    return TorchJpegDecoder(device).decode(data).rgb


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
