"""Unfused per-stage decode: dequantize / IDCT / upsample + colour.

PyTorch counterpart of ``pim_jpeg_decoder_tpu/ops/stage_kernels.py``.  The
production path is the fused kernel of :mod:`.decode_kernel`; these three
stages exist for the device profile (``runtime/device_profile.py``: the
reference DPU's dequantization / inverse-DCT / colour-conversion phases,
timed separately) and to measure what fusion saves.  Each stage
round-trips device memory, as the reference's three phases do.

Layouts are the JAX package's:

- :func:`dequantize_stage`: ``[M, g, 64]`` int8/int16 coefficients ->
  int16 ``[M, g, 64]`` dequantized, clamped to the int16 range;
- :func:`idct_stage`: int16 ``[M, g, 64]`` -> int16 ``[M, g, 64]`` samples
  in [-128, 127], ROW-major within each block (index r*8 + p, the TPU
  kernel's ``_assemble``; the fused kernels are column-major);
- :func:`color_stage`: int16 row-major samples -> uint8 ``[M, gy, 64, 3]``
  (or the kernel's ``[3, gy, 64, M]`` with ``raw=True``), pixels
  column-major, as the fused RGB kernel writes them.

Each picks by the tensors' device: CPU tensors take the plain version
(``*_reference``), CUDA tensors the kernel in ``csrc/stage_kernels.cu`` (or
the call raises; nothing falls back).  Any M is accepted.  Composed,
:func:`decode_mcus_staged` equals ``decode_mcus(raw=False)``.
"""

from __future__ import annotations

import torch

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
    _check_inputs,
    _count,
    _rgb_layout,
    bt601_planes,
    dequantized,
    idct_blocks,
    upsampled_samples,
)

# --- plain PyTorch versions --------------------------------------------------


def _plain_call(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        _count("plain_on_cuda")


def dequantize_stage_reference(coeffs: torch.Tensor, qidx: torch.Tensor,
                               qpool: torch.Tensor) -> torch.Tensor:
    """Plain :func:`dequantize_stage`.  Calls on CUDA tensors are counted
    under ``plain_on_cuda`` (as for every plain version below)."""
    _plain_call(coeffs)
    return dequantized(coeffs, qidx, qpool).to(torch.int16)


def idct_stage_reference(deq: torch.Tensor) -> torch.Tensor:
    """Plain :func:`idct_stage`: the column-major IDCT transposed to
    row-major."""
    _plain_call(deq)
    m, g = deq.shape[:2]
    spat = idct_blocks(deq.to(torch.int32).view(m, g, 8, 8))   # [p, r]
    return spat.transpose(-1, -2).reshape(m, g, 64).to(torch.int16)


def color_stage_reference(spat: torch.Tensor, mode: S.ModeSpec, *,
                          raw: bool = False) -> torch.Tensor:
    """Plain :func:`color_stage`: row-major samples transposed back to
    column-major, then the fused plain version's upsample and BT.601."""
    _plain_call(spat)
    m = spat.shape[0]
    cm = (spat.to(torch.int32).view(m, mode.g, 8, 8).transpose(-1, -2)
          .reshape(m, mode.g, 64))
    return _rgb_layout(bt601_planes(*upsampled_samples(cm, mode)), raw)


# --- the CUDA kernels --------------------------------------------------------

def _check_samples(x: torch.Tensor, mode: S.ModeSpec, what: str) -> None:
    if (x.dtype != torch.int16 or x.dim() != 3
            or tuple(x.shape[1:]) != (mode.g, 64)):
        raise ValueError(f"{what} must be int16 [M, {mode.g}, 64] for "
                         f"{mode.name}, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA ones;
    raises for any other device."""
    device = tensors[0].device
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("stage inputs must be 16-byte aligned (the kernels "
                         "load them 16 bytes at a time)")
    return True


def _launch(name: str, fn, args, out: torch.Tensor, what: str) -> None:
    """``fn(*args, stream)`` on ``out``'s current stream, counted under the
    launch counter ``name``; raises if the launch failed."""
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA {name} kernel ({what}) failed to launch: "
                           f"cudaError {rc}")
    _count(name)


def dequantize_stage(coeffs: torch.Tensor, qidx: torch.Tensor,
                     qpool: torch.Tensor, mode: S.ModeSpec) -> torch.Tensor:
    """``[M, g, 64]`` int16/int8 coefficients -> int16 ``[M, g, 64]``
    ``clip(coeffs * qpool[qidx[m]], -32768, 32767)``; ``qpool`` is the
    int32 pool of ``decode_kernel.qpool_to_device``."""
    _check_inputs(coeffs, qidx, qpool, mode)
    if not _on_cuda(coeffs, qpool):
        return dequantize_stage_reference(coeffs, qidx, qpool)
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    m = coeffs.shape[0]
    out = torch.empty((m, mode.g, 64), dtype=torch.int16,
                      device=coeffs.device)
    if m:
        _launch("dequant", load().pjt_cuda_dequant_stage,
                (coeffs.data_ptr(), coeffs.element_size(), qidx.data_ptr(),
                 qpool.data_ptr(), qpool.shape[0], out.data_ptr(), m,
                 mode.g), out, f"{mode.name}, M={m}")
    return out


def idct_stage(deq: torch.Tensor, mode: S.ModeSpec) -> torch.Tensor:
    """int16 ``[M, g, 64]`` dequantized -> int16 ``[M, g, 64]`` samples,
    row-major."""
    _check_samples(deq, mode, "dequantized coefficients")
    if not _on_cuda(deq):
        return idct_stage_reference(deq)
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    out = torch.empty_like(deq)
    if deq.numel():
        _launch("idct", load().pjt_cuda_idct_stage,
                (deq.data_ptr(), out.data_ptr(), deq.shape[0] * mode.g),
                out, f"{mode.name}, M={deq.shape[0]}")
    return out


def color_stage(spat: torch.Tensor, mode: S.ModeSpec, *,
                raw: bool = False) -> torch.Tensor:
    """int16 ``[M, g, 64]`` row-major samples -> uint8 RGB
    ``[M, luma_slots, 64, 3]``, or ``[3, luma_slots, 64, M]`` with
    ``raw=True``; gray replicates the luma into all three."""
    _check_samples(spat, mode, "samples")
    if not _on_cuda(spat):
        return color_stage_reference(spat, mode, raw=raw)
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    m = spat.shape[0]
    out = torch.empty((3, mode.luma_slots, 64, m), dtype=torch.uint8,
                      device=spat.device)
    if m:
        _launch("color", load().pjt_cuda_color_stage,
                (spat.data_ptr(), out.data_ptr(), m, mode.h, mode.v,
                 mode.ncomp), out, f"{mode.name}, M={m}")
    return _rgb_layout(out, raw)


def decode_mcus_staged(coeffs: torch.Tensor, qidx: torch.Tensor,
                       qpool: torch.Tensor,
                       mode: S.ModeSpec) -> torch.Tensor:
    """Three-stage decode (the reference's unfused DPU pipeline shape):
    ``[M, luma_slots, 64, 3]`` uint8, equal to ``decode_mcus(raw=False)``."""
    deq = dequantize_stage(coeffs, qidx, qpool, mode)
    return color_stage(idct_stage(deq, mode), mode)
