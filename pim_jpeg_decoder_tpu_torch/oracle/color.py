"""Fixed-point BT.601 YCbCr->RGB + nearest-neighbor chroma upsampling (NumPy).

Spec implementation of :mod:`pim_jpeg_decoder_tpu_torch.ops.specs` color constants.
Capability-equivalent of the reference's fused upsample + color-convert DPU
stage (reference: src/decoder_dpu.c:323-390 ``convert_colorspace_component``):
nearest-neighbor (pixel replication) chroma upsampling, ITU-R BT.601
constants in fixed point, +128 level shift, clamp to [0, 255].
"""

from __future__ import annotations

import numpy as np

from pim_jpeg_decoder_tpu_torch.ops import specs as S


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Convert IDCT-output samples (centered at 0) to RGB uint8.

    Args:
      y, cb, cr: int32 arrays of identical shape; chroma already upsampled.

    Returns:
      uint8 array of shape ``y.shape + (3,)``.
    """
    y = y.astype(np.int32)
    cb = cb.astype(np.int32)
    cr = cr.astype(np.int32)
    y128 = y + 128
    r = y128 + S.descale(S.FIX_CR_R * cr, S.COLOR_BITS)
    g = y128 + S.descale(S.FIX_CB_G * cb + S.FIX_CR_G * cr, S.COLOR_BITS)
    b = y128 + S.descale(S.FIX_CB_B * cb, S.COLOR_BITS)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def gray_to_rgb(y: np.ndarray) -> np.ndarray:
    """Grayscale: replicate the level-shifted luma into all three channels."""
    v = np.clip(y.astype(np.int32) + 128, 0, 255).astype(np.uint8)
    return np.stack([v, v, v], axis=-1)


def chroma_subblock(chroma: np.ndarray, qv: int, qh: int, v: int, h: int) -> np.ndarray:
    """Upsampled chroma for the luma slot at MCU position (qv, qh).

    ``chroma`` is ``[..., 8, 8]``; the luma slot samples the
    ``(8//v) x (8//h)`` sub-block at (qv, qh) and replicates it (nearest
    neighbor) back to 8x8 — the quadrant-sampling scheme of the reference's
    4:2:0/4:2:2/4:4:0 dispatch (reference: src/decoder_dpu.c:338-355,370).
    """
    rh = 8 // v
    rw = 8 // h
    sub = chroma[..., qv * rh:(qv + 1) * rh, qh * rw:(qh + 1) * rw]
    return sub.repeat(v, axis=-2).repeat(h, axis=-1)
