"""End-to-end CPU oracle decode: JPEG bytes -> RGB (NumPy, bit-exact spec).

The full host-side equivalent of the reference pipeline
(scan -> entropy decode -> dequantize -> IDCT -> upsample+color -> raster),
used as the golden reference for the TPU path and validated against
PIL/libjpeg within integer-IDCT tolerance (SURVEY.md section 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pim_jpeg_decoder_tpu_torch.codec.entropy import decode_scan
from pim_jpeg_decoder_tpu_torch.codec.header import JpegHeader
from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu_torch.oracle import color as C
from pim_jpeg_decoder_tpu_torch.oracle.idct import dequantize, idct_blocks
from pim_jpeg_decoder_tpu_torch.ops import specs as S


@dataclasses.dataclass
class DecodedImage:
    rgb: np.ndarray          # [H, W, 3] uint8
    header: JpegHeader


def mcu_rgb_from_coeffs(header: JpegHeader, coeffs: np.ndarray) -> np.ndarray:
    """Raw coefficients ``[M, g, 64]`` -> per-MCU RGB ``[M, v*8, h*8, 3]``.

    This is the numeric stage the TPU kernel replaces; kept as a separate
    function so kernel tests can compare at the MCU level before raster
    assembly.
    """
    mode = S.mode_for(header.mode_key)
    m = coeffs.shape[0]

    # Dequantize per slot (each slot's component selects its quant table).
    deq = np.empty((m, mode.g, 64), dtype=np.int32)
    slots = header.slot_components()
    for s, (ci, _, _) in enumerate(slots):
        qt = header.component_qt(header.components[ci])
        deq[:, s, :] = dequantize(coeffs[:, s, :], qt[None, :])

    spat = idct_blocks(deq.reshape(m, mode.g, 8, 8))

    out = np.empty((m, mode.mcu_px_h, mode.mcu_px_w, 3), dtype=np.uint8)
    if mode.ncomp == 1:
        out[:, :8, :8, :] = C.gray_to_rgb(spat[:, 0])
        return out

    cb = spat[:, mode.luma_slots]
    cr = spat[:, mode.luma_slots + 1]
    for s in range(mode.luma_slots):
        qv, qh = mode.luma_slot_pos(s)
        y = spat[:, s]
        cb_s = C.chroma_subblock(cb, qv, qh, mode.v, mode.h)
        cr_s = C.chroma_subblock(cr, qv, qh, mode.v, mode.h)
        out[:, qv * 8:(qv + 1) * 8, qh * 8:(qh + 1) * 8, :] = C.ycbcr_to_rgb(y, cb_s, cr_s)
    return out


def assemble_raster(header: JpegHeader, mcu_rgb: np.ndarray) -> np.ndarray:
    """Per-MCU RGB tiles (raster MCU order) -> cropped ``[H, W, 3]`` image."""
    mode = S.mode_for(header.mode_key)
    gh, gw = header.mcu_rows, header.mcu_cols
    img = (
        mcu_rgb[: gh * gw]
        .reshape(gh, gw, mode.mcu_px_h, mode.mcu_px_w, 3)
        .swapaxes(1, 2)
        .reshape(gh * mode.mcu_px_h, gw * mode.mcu_px_w, 3)
    )
    return np.ascontiguousarray(img[: header.height, : header.width])


def decode_bytes_oracle(data: bytes) -> DecodedImage:
    """Full oracle decode of one JPEG (baseline or progressive)."""
    header = scan_jpeg(data)
    if header.progressive:
        from pim_jpeg_decoder_tpu_torch.codec.progressive import decode_progressive
        coeffs = decode_progressive(header)
    else:
        coeffs = decode_scan(header)
    mcu_rgb = mcu_rgb_from_coeffs(header, coeffs)
    return DecodedImage(assemble_raster(header, mcu_rgb), header)


def decode_scaled_oracle(data: bytes, scale: int) -> np.ndarray:
    """Scaled oracle decode: ``[ceil(H/scale), ceil(W/scale), 3]`` uint8.

    Golden reference for :func:`models.pipeline.decode_scaled`'s reduced-IDCT
    kernel path: same integer spec (specs.py 'Reduced (scaled) IDCT'), so
    agreement must be bit-exact.  Chroma of subsampled modes reduces per-axis
    to (sampling_factor * n) points — each luma slot slices its n x n region,
    no upsampling at scale >= 2.
    """
    from pim_jpeg_decoder_tpu_torch.oracle.idct import reduced_idct_blocks

    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")
    if scale == 1:
        return decode_bytes_oracle(data).rgb
    header = scan_jpeg(data)
    if header.progressive:
        from pim_jpeg_decoder_tpu_torch.codec.progressive import decode_progressive
        coeffs = decode_progressive(header)
    else:
        coeffs = decode_scan(header)
    mode = S.mode_for(header.mode_key)
    n = 8 // scale
    m = coeffs.shape[0]

    deq = np.empty((m, mode.g, 64), dtype=np.int32)
    for s, (ci, _, _) in enumerate(header.slot_components()):
        qt = header.component_qt(header.components[ci])
        deq[:, s, :] = dequantize(coeffs[:, s, :], qt[None, :])
    blocks = deq.reshape(m, mode.g, 8, 8)

    gy = mode.luma_slots
    spat = reduced_idct_blocks(blocks[:, :gy], n)
    tile_h, tile_w = mode.v * n, mode.h * n
    tiles = np.empty((m, tile_h, tile_w, 3), dtype=np.uint8)
    if mode.ncomp == 1:
        tiles[:] = C.gray_to_rgb(spat[:, 0])
    else:
        chroma = reduced_idct_blocks(blocks[:, gy:], tile_h, tile_w)
        for s in range(gy):
            qv, qh = mode.luma_slot_pos(s)
            cb = chroma[:, 0, qv * n:(qv + 1) * n, qh * n:(qh + 1) * n]
            cr = chroma[:, 1, qv * n:(qv + 1) * n, qh * n:(qh + 1) * n]
            tiles[:, qv * n:(qv + 1) * n, qh * n:(qh + 1) * n, :] = (
                C.ycbcr_to_rgb(spat[:, s], cb, cr))

    gh, gw = header.mcu_rows, header.mcu_cols
    img = (tiles[: gh * gw]
           .reshape(gh, gw, tile_h, tile_w, 3)
           .swapaxes(1, 2)
           .reshape(gh * tile_h, gw * tile_w, 3))
    out_h = -(-header.height // scale)
    out_w = -(-header.width // scale)
    return np.ascontiguousarray(img[:out_h, :out_w])
