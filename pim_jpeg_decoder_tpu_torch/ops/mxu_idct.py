"""The 8x8 IDCT as float32 matrix products: can the tensor cores beat the
integer butterflies?

PyTorch counterpart of the kernels in the repository's
``tools/mxu_idct_ab.py`` (``_kernel_mxu2pass``, ``_kernel_mxu64``);
``tools/mxu_idct_ab.py`` of this package times them against the butterfly
stage kernel (``stage_kernels.idct_stage``).  They are a cost model, not the
spec: the float32 products round where the integer butterfly does not.

- :func:`mxu2pass`: each 8-point pass one product with the ``[8, 8]``
  basis ``A = specs.reduced_idct_matrix(8)``: ``y1 = round(A X 2^-11)``,
  ``y2 = round(y1 A^T 2^-15)``.  ``pieces=2`` (the tool's ``mxu2pass4``)
  splits ``A`` and the operand into 8-bit pieces, ``hi = floor(v / 256)``,
  ``lo = v - 256 hi``, and recombines four products as ``hh*65536 +
  hl*256 + lh*256 + ll``: the exact formulation's op count.
- :func:`mxu64`: both passes as one product with the ``[64, 64]``
  ``kron(A, A)``: ``round(y 2^-26)``.

Each takes int16 ``[M, g, 64]`` (the dequantized coefficients of the stage
kernels, index ``v*8 + h``) and returns int16 ``[M, g, 64]`` samples clipped
to ``[SAMPLE_MIN, SAMPLE_MAX]``, index ``r*8 + p``: the JAX tool's ``[g, 64,
M]`` output transposed, the element order of the butterfly stage kernel.
Rounding is half to even (``torch.round``, as ``jnp.round``).

The plain versions (``*_reference``) follow the JAX kernels step by step in
float32; on a card their products run in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False, set for the call).  CPU
tensors take them, CUDA tensors the kernels of ``csrc/mxu_idct.cu`` (TF32
tensor-core products; the call raises on failure, nothing falls back).
``mxu2pass4`` equals its plain version bit for bit on the tool's inputs;
``mxu2pass`` and ``mxu64`` round their basis to TF32 and differ by 1-2 in
a few percent of samples.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops.stage_kernels import (
    _launch,
    _on_cuda,
    _plain_call,
)

INV1 = 2.0 ** -(S.CONST_BITS - S.PASS1_BITS)
INV2 = 2.0 ** -(S.CONST_BITS + S.PASS1_BITS)
INV64 = 2.0 ** -(2 * S.CONST_BITS)


def mat8() -> np.ndarray:
    """The 8-point basis at the spec's integer scale, float32 ``[k, u]``."""
    return np.asarray(S.reduced_idct_matrix(8), np.float32)


def mat64() -> np.ndarray:
    """Both passes' basis, ``kron(A, A)``, float32 ``[64, 64]``."""
    a = mat8()
    return np.kron(a, a).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _basis(which: str, device: str) -> torch.Tensor:
    return torch.from_numpy(mat8() if which == "8" else mat64()).to(device)


@contextlib.contextmanager
def _full_float32():
    """Float32 products in full float32 on a card (the default; set here so
    that a caller's TF32 setting cannot change the plain version)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _check(deq: torch.Tensor) -> None:
    if deq.dtype != torch.int16 or deq.dim() != 3 or deq.shape[2] != 64:
        raise ValueError(f"coefficients must be int16 [M, g, 64], got "
                         f"{tuple(deq.shape)} {deq.dtype}")
    if not deq.is_contiguous():
        raise ValueError("coefficients must be contiguous")


def _check_pieces(pieces: int) -> None:
    if pieces not in (1, 2):
        raise ValueError(f"pieces must be 1 or 2, got {pieces!r}")


# --- plain PyTorch versions --------------------------------------------------

def _matpass(a: torch.Tensor, x: torch.Tensor, inv: float,
             pieces: int) -> torch.Tensor:
    """``round(a @ x * inv)`` for ``x`` ``[8 (contracted), N]`` float32."""
    if pieces == 1:
        y = a @ x
    else:
        a_hi = torch.floor(a / 256.0)
        a_lo = a - a_hi * 256.0
        x_hi = torch.floor(x / 256.0)
        x_lo = x - x_hi * 256.0
        y = ((a_hi @ x_hi) * 65536.0 + (a_hi @ x_lo) * 256.0
             + (a_lo @ x_hi) * 256.0 + (a_lo @ x_lo))
    return torch.round(y * inv).to(torch.int32).to(torch.float32)


def mxu2pass_reference(deq: torch.Tensor, pieces: int = 1) -> torch.Tensor:
    """Plain :func:`mxu2pass`.  Calls on CUDA tensors are counted under
    ``plain_on_cuda`` (as for every plain version)."""
    _check(deq)
    _check_pieces(pieces)
    _plain_call(deq)
    m, g = deq.shape[:2]
    a = _basis("8", str(deq.device))
    with _full_float32():
        x = deq.to(torch.float32).view(m, g, 8, 8)          # [m, s, v, h]
        x = x.permute(2, 0, 1, 3).reshape(8, -1)             # [v, (m, s, h)]
        y1 = _matpass(a, x, INV1, pieces).view(8, m, g, 8)   # [r, m, s, h]
        y1t = y1.permute(3, 1, 2, 0).reshape(8, -1)          # [h, (m, s, r)]
        y2 = _matpass(a, y1t, INV2, pieces).view(8, m, g, 8)  # [p, m, s, r]
    spat = y2.to(torch.int32).clamp(S.SAMPLE_MIN, S.SAMPLE_MAX)
    return spat.permute(1, 2, 3, 0).reshape(m, g, 64).to(torch.int16)


def mxu64_reference(deq: torch.Tensor) -> torch.Tensor:
    """Plain :func:`mxu64`."""
    _check(deq)
    _plain_call(deq)
    m, g = deq.shape[:2]
    with _full_float32():
        x = deq.to(torch.float32).permute(2, 0, 1).reshape(64, -1)
        y = _basis("64", str(deq.device)) @ x                # [64, (m, s)]
    spat = torch.round(y * INV64).to(torch.int32).clamp(S.SAMPLE_MIN,
                                                        S.SAMPLE_MAX)
    return spat.view(64, m, g).permute(1, 2, 0).contiguous().to(torch.int16)


# --- the CUDA kernels --------------------------------------------------------

def mxu2pass(deq: torch.Tensor, pieces: int = 1) -> torch.Tensor:
    """int16 ``[M, g, 64]`` -> int16 ``[M, g, 64]``: the IDCT as two
    products per block (``pieces=2``: four hi/lo products per pass)."""
    _check(deq)
    _check_pieces(pieces)
    if not _on_cuda(deq):
        return mxu2pass_reference(deq, pieces)
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    out = torch.empty_like(deq)
    if deq.numel():
        _launch("mxu2pass", load().pjt_cuda_mxu2pass,
                (deq.data_ptr(), _basis("8", str(deq.device)).data_ptr(),
                 out.data_ptr(), deq.shape[0] * deq.shape[1], pieces, INV1,
                 INV2), out, f"pieces={pieces}, M={deq.shape[0]}")
    return out


def mxu64(deq: torch.Tensor) -> torch.Tensor:
    """int16 ``[M, g, 64]`` -> int16 ``[M, g, 64]``: the IDCT as one
    ``[64, 64]`` product per block."""
    _check(deq)
    if not _on_cuda(deq):
        return mxu64_reference(deq)
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    out = torch.empty_like(deq)
    if deq.numel():
        _launch("mxu64", load().pjt_cuda_mxu64,
                (deq.data_ptr(), _basis("64", str(deq.device)).data_ptr(),
                 out.data_ptr(), deq.shape[0] * deq.shape[1], INV64), out,
                f"M={deq.shape[0]}")
    return out
