"""Fixed-point integer 8x8 IDCT (NumPy, vectorized over blocks).

Implements the spec in :mod:`pim_jpeg_decoder_tpu_torch.ops.specs`: 13-bit Loeffler
integer IDCT, two separable passes with intermediate descaling, all int32
with arithmetic shifts.  Capability-equivalent of the reference's DPU IDCT
(reference: src/decoder_dpu.c:179-321 ``idct_component``), but using the
compliance-grade Loeffler constants rather than the reference's AAN variant.

The CUDA kernels (:mod:`pim_jpeg_decoder_tpu_torch.ops.decode_kernel`) compute
the identical arithmetic; tests assert bit-exact agreement.
"""

from __future__ import annotations

import numpy as np

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops.idct_math import idct_1d as _idct_1d


def idct_blocks(coeffs: np.ndarray, clamp: bool = True) -> np.ndarray:
    """IDCT of dequantized coefficient blocks.

    Args:
      coeffs: ``[..., 8, 8]`` integer array, natural order, already
        dequantized and clamped to int16 range (``specs.DEQUANT_CLAMP``).

    Returns:
      ``[..., 8, 8]`` int32 spatial samples centered at 0 (no +128 level
      shift), clamped to the 8-bit sample range [-128, 127] per T.81 A.3.1.
    """
    x = coeffs.astype(np.int32)

    # Pass 1: transform along the vertical-frequency axis (axis -2), output
    # scaled by 2^PASS1_BITS.
    cols = [x[..., u, :] for u in range(8)]
    cols = _idct_1d(cols, S.CONST_BITS - S.PASS1_BITS)
    y = np.stack(cols, axis=-2)

    # Pass 2: transform along the horizontal-frequency axis (axis -1),
    # final descale removes CONST_BITS + PASS1_BITS and the IDCT's 1/8.
    rows = [y[..., :, v] for v in range(8)]
    rows = _idct_1d(rows, S.CONST_BITS + S.PASS1_BITS + 3)
    out = np.stack(rows, axis=-1)
    if clamp:
        out = np.clip(out, S.SAMPLE_MIN, S.SAMPLE_MAX)
    return out


def reduced_idct_blocks(coeffs: np.ndarray, ny: int, nx: int = None,
                        clamp: bool = True) -> np.ndarray:
    """Reduced (ny x nx)-point IDCT (scaled decode): -> ``[..., ny, nx]``.

    Same integer spec as the Pallas kernel's reduced path (specs.py
    'Reduced (scaled) IDCT'): matrix multiply by the rounded basis, descale
    by CONST_BITS - PASS1_BITS then CONST_BITS + PASS1_BITS, int32 wrap.
    Chroma of subsampled modes uses ny/nx = sampling factor * n, so it is
    reduced less than luma (no upsampling at scale >= 2).
    """
    if nx is None:
        nx = ny
    mat1 = np.asarray(S.reduced_idct_matrix(ny), np.int32)
    mat2 = np.asarray(S.reduced_idct_matrix(nx), np.int32)
    x = coeffs[..., :ny, :nx].astype(np.int32)
    # Pass 1 along the vertical-frequency axis.
    y = S.descale(np.einsum("kv,...vu->...ku", mat1, x).astype(np.int32),
                  S.CONST_BITS - S.PASS1_BITS)
    # Pass 2 along the horizontal-frequency axis.
    out = S.descale(np.einsum("pu,...ku->...kp", mat2, y).astype(np.int32),
                    S.CONST_BITS + S.PASS1_BITS)
    if clamp:
        out = np.clip(out, S.SAMPLE_MIN, S.SAMPLE_MAX)
    return out


def dequantize(coeffs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Dequantize raw coefficients: elementwise multiply + int16 clamp.

    Equivalent of the reference's DPU dequantize stage
    (reference: src/decoder_dpu.c:158-177); the clamp keeps all IDCT
    intermediates in int32 (see specs.DEQUANT_CLAMP).
    """
    out = coeffs.astype(np.int32) * qt.astype(np.int32)
    return np.clip(out, -S.DEQUANT_CLAMP - 1, S.DEQUANT_CLAMP)


def float_idct_blocks(coeffs: np.ndarray) -> np.ndarray:
    """Ideal float64 IDCT (for tolerance tests only, not part of the spec)."""
    k = np.arange(8)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    basis = c[:, None] * np.cos((2 * np.arange(8)[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    # out[y, x] = sum_{u,v} basis[u, y] * basis[v, x] * coeff[u, v]
    return np.einsum("uy,vx,...uv->...yx", basis, basis, coeffs.astype(np.float64))
