"""Device decode of MCU batches: dequantize -> IDCT -> (upsample + BT.601).

PyTorch counterpart of ``pim_jpeg_decoder_tpu/ops/decode_kernel.py``.  Two
implementations of the same integer spec (``ops/specs.py``,
``ops/idct_math.py``):

- :func:`decode_mcus_reference`, plain PyTorch on int32 tensors.  It runs
  the shared ``idct_1d`` butterfly unchanged, so it is bit-identical to the
  NumPy oracle and to the Pallas kernels by construction (int32 tensor
  arithmetic wraps like theirs).
- the hand-written CUDA kernels in ``csrc/decode_kernel.cu`` for a card.

:func:`decode_mcus` picks by the tensors' device: CPU tensors take the
plain version, CUDA tensors the kernel (or the call raises; nothing falls
back).  Output layouts are the JAX package's: RGB ``[3, luma_slots, 64, M]``
and YCbCr ``[g, 64, M]`` uint8, pixels COLUMN-major inside each slot
(index = px*8 + py).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict

import numpy as np
import torch

from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.idct_math import idct_1d

# Launch counters: each kernel's wrapper adds one where it launches, and
# "plain_on_cuda" counts plain-version calls on CUDA tensors (a run that
# claims to use the kernels must show 0 there).
_counts: Dict[str, int] = {"rgb": 0, "ycbcr": 0, "plain_on_cuda": 0}
_counts_lock = threading.Lock()


def _count(name: str) -> None:
    with _counts_lock:
        _counts[name] += 1


def launch_counts() -> Dict[str, int]:
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _counts:
            _counts[k] = 0


# --- state carried to the device ---------------------------------------------

def coeffs_to_device(coeffs: np.ndarray, device) -> torch.Tensor:
    """``[M, g, 64]`` int16 or int8 coefficients -> tensor on ``device``."""
    if coeffs.dtype not in (np.int16, np.int8) or coeffs.ndim != 3:
        raise ValueError(f"coefficients must be [M, g, 64] int16/int8, got "
                         f"{coeffs.shape} {coeffs.dtype}")
    return torch.from_numpy(np.ascontiguousarray(coeffs)).to(device)


def qpool_to_device(qpool: np.ndarray, device) -> torch.Tensor:
    """``[Q, g, 64]`` float32 quantizer rows -> int32 tensor on ``device``.

    Exact: quantizer values are integers below 2^24.  Replaces the TPU
    kernel's one-hot MXU gather with a plain indexed load of
    ``qpool[qidx[m], s, k]``.
    """
    return torch.from_numpy(
        np.ascontiguousarray(qpool).astype(np.int32)).to(device)


# --- plain PyTorch version ---------------------------------------------------

def _idct_blocks(deq: torch.Tensor) -> torch.Tensor:
    """``[..., 8(v), 8(u)]`` int32 dequantized blocks -> ``[..., 8(px),
    8(py)]`` int32 samples clamped to the sample range (column-major, the
    kernels' pixel order)."""
    rows1 = idct_1d([deq[..., v, :] for v in range(8)],
                    S.CONST_BITS - S.PASS1_BITS)       # over py: [..., u]
    y = torch.stack(rows1, dim=-2)                     # [..., py, u]
    cols2 = idct_1d([y[..., u] for u in range(8)],
                    S.CONST_BITS + S.PASS1_BITS + 3)   # over px: [..., py]
    return torch.stack(cols2, dim=-2).clamp(S.SAMPLE_MIN, S.SAMPLE_MAX)


@functools.lru_cache(maxsize=None)
def _chroma_index(mode: S.ModeSpec) -> torch.Tensor:
    """``[luma_slots, 64]`` index into a column-major chroma block giving
    each luma-slot pixel its nearest-neighbour chroma sample."""
    rh, rw = 8 // mode.v, 8 // mode.h
    idx = torch.empty(mode.luma_slots, 64, dtype=torch.long)
    for s in range(mode.luma_slots):
        qv, qh = mode.luma_slot_pos(s)
        for px in range(8):
            for py in range(8):
                row = qv * rh + py // mode.v
                col = qh * rw + px // mode.h
                idx[s, px * 8 + py] = col * 8 + row
    return idx


def decode_mcus_reference(coeffs: torch.Tensor, qidx: torch.Tensor,
                          qpool: torch.Tensor, mode: S.ModeSpec, *,
                          raw: bool = False,
                          ycbcr: bool = False) -> torch.Tensor:
    """Plain PyTorch decode of ``[M, g, 64]`` coefficients (full scale).

    ``qidx`` ``[M]`` int32 selects each MCU's row of the int32 quantizer
    pool ``qpool`` ``[Q, g, 64]``.  Returns ``[g, 64, M]`` level-shifted
    YCbCr with ``ycbcr=True``, RGB ``[3, luma_slots, 64, M]`` with
    ``raw=True``, else RGB ``[M, luma_slots, 64, 3]``.  Calls on CUDA
    tensors are counted under ``plain_on_cuda``.
    """
    if coeffs.device.type == "cuda":
        _count("plain_on_cuda")
    m = coeffs.shape[0]
    x = coeffs.to(torch.int32)
    q = qpool[qidx.long()]                                   # [M, g, 64]
    deq = (x * q).clamp(-S.DEQUANT_CLAMP - 1, S.DEQUANT_CLAMP)
    spat = _idct_blocks(deq.view(m, mode.g, 8, 8)).reshape(m, mode.g, 64)
    if ycbcr:
        return (spat + 128).to(torch.uint8).permute(1, 2, 0).contiguous()

    gy = mode.luma_slots
    y128 = spat[:, :gy] + 128                                # [M, gy, 64]
    if mode.ncomp == 1:
        planes = [y128.clamp(0, 255)] * 3
    else:
        idx = _chroma_index(mode).to(coeffs.device)
        cb = spat[:, gy][:, idx]                             # [M, gy, 64]
        cr = spat[:, gy + 1][:, idx]
        planes = [
            y128 + S.descale(S.FIX_CR_R * cr, S.COLOR_BITS),
            y128 + S.descale(S.FIX_CB_G * cb + S.FIX_CR_G * cr,
                             S.COLOR_BITS),
            y128 + S.descale(S.FIX_CB_B * cb, S.COLOR_BITS),
        ]
    rgb = torch.stack([p.clamp(0, 255) for p in planes]).to(torch.uint8)
    return _rgb_layout(rgb.permute(0, 2, 3, 1).contiguous(), raw)


def _rgb_layout(raw_rgb: torch.Tensor, raw: bool) -> torch.Tensor:
    """``[3, gy, 64, M]`` -> itself, or the slot-major ``[M, gy, 64, 3]``
    (a real copy, as in the JAX package; the engine uses ``raw=True``)."""
    return raw_rgb if raw else raw_rgb.permute(3, 1, 2, 0).contiguous()


# --- the CUDA kernels --------------------------------------------------------

def _check_inputs(coeffs, qidx, qpool, mode: S.ModeSpec) -> None:
    if coeffs.dtype not in (torch.int16, torch.int8):
        raise ValueError(f"coefficients must be int16 or int8, got "
                         f"{coeffs.dtype}")
    if coeffs.dim() != 3 or coeffs.shape[1:] != (mode.g, 64):
        raise ValueError(f"coefficients must be [M, {mode.g}, 64] for "
                         f"{mode.name}, got {tuple(coeffs.shape)}")
    if qidx.dtype != torch.int32 or qidx.shape != (coeffs.shape[0],):
        raise ValueError(f"qidx must be [{coeffs.shape[0]}] int32, got "
                         f"{tuple(qidx.shape)} {qidx.dtype}")
    if (qpool.dtype != torch.int32 or qpool.dim() != 3
            or qpool.shape[1:] != (mode.g, 64) or qpool.shape[0] < 1):
        raise ValueError(f"qpool must be [Q, {mode.g}, 64] int32 "
                         f"(see qpool_to_device), got "
                         f"{tuple(qpool.shape)} {qpool.dtype}")
    devices = {coeffs.device, qidx.device, qpool.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    for t in (coeffs, qidx, qpool):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")


def _launch(coeffs, qidx, qpool, mode: S.ModeSpec, ycbcr: bool):
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    if coeffs.data_ptr() % 16 or qpool.data_ptr() % 16:
        raise ValueError("coefficients and qpool must be 16-byte aligned "
                         "(the kernel loads them 16 bytes at a time)")
    lib = load()
    m = coeffs.shape[0]
    if ycbcr:
        shape, fn, name = ((mode.g, 64, m), lib.pjt_cuda_decode_ycbcr,
                           "ycbcr")
    else:
        shape, fn, name = ((3, mode.luma_slots, 64, m),
                           lib.pjt_cuda_decode_rgb, "rgb")
    out = torch.empty(shape, dtype=torch.uint8, device=coeffs.device)
    if m == 0:
        return out
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(coeffs.data_ptr(), coeffs.element_size(), qidx.data_ptr(),
                qpool.data_ptr(), qpool.shape[0], out.data_ptr(), m,
                mode.h, mode.v, mode.ncomp, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA decode kernel ({name}, {mode.name}, "
                           f"M={m}) failed to launch: cudaError {rc}")
    _count(name)
    return out


def decode_mcus(coeffs: torch.Tensor, qidx: torch.Tensor,
                qpool: torch.Tensor, mode: S.ModeSpec, *, raw: bool = False,
                ycbcr: bool = False, scale: int = 1) -> torch.Tensor:
    """Decode a batch of MCUs on the tensors' device.

    Counterpart of ``pim_jpeg_decoder_tpu.ops.decode_kernel.decode_mcus``
    at full scale, with the same output layouts (see
    :func:`decode_mcus_reference`).  Any M is accepted: the kernel masks
    the ragged end, so no lane-tile padding is needed.  ``qpool`` is the
    int32 pool from :func:`qpool_to_device`.
    """
    if scale != 1:
        raise NotImplementedError(
            "scaled decode (scale 2/4/8) is not ported yet; see ROADMAP.md "
            "Queue 2 (reduced-IDCT branch of _make_kernel)")
    _check_inputs(coeffs, qidx, qpool, mode)
    if coeffs.device.type == "cpu":
        return decode_mcus_reference(coeffs, qidx, qpool, mode, raw=raw,
                                     ycbcr=ycbcr)
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    out = _launch(coeffs, qidx, qpool, mode, ycbcr)
    return out if ycbcr else _rgb_layout(out, raw)

