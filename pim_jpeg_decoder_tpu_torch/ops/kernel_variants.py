"""Experiment kernels of the fused RGB decode: the layout-matched memory
floor and two restructurings of ``rgb_kernel``.

PyTorch counterpart of the kernels in the repository's
``tools/kernel_opt.py`` (``_kernel_memfloor``, ``_kernel_chroma_truerez``,
``_kernel_stacked``); ``tools/kernel_opt.py`` of this package times them
against the production kernel.  Each takes the production inputs (the
``[M, g, 64]`` int8/int16 wire, ``qidx`` ``[M]`` int32 and the int32 pool
of ``decode_kernel.qpool_to_device``) of a colour mode and returns uint8
``[3, luma_slots, 64, M]``, pixels column-major, as
``decode_mcus(..., raw=True)`` does:

- :func:`memfloor`: no decode.  Each luma slot's output byte is
  ``u8(c[s] + c[gy] + c[gy+1])`` (int32 sum truncated to its low byte),
  written to all three planes: every coefficient byte read once, every
  output byte written once, with ``rgb_kernel``'s loads and stores.  It
  is the denominator of ``rgb_kernel``'s bandwidth share.
- :func:`rgb_truerez`: ``rgb_kernel``'s output, with the three BT.601
  chroma terms computed once per chroma sample and replicated to the luma
  pixels by index.
- :func:`rgb_stacked`: ``rgb_kernel``'s output, with the luma slots of an
  MCU run through one stacked butterfly chain.

Each plain version (``*_reference``) is written in its variant's own
structure, not as a call to ``decode_mcus_reference``, so that holding it
against the JAX variant tests the variant.  CPU tensors take the plain
version, CUDA tensors the kernel in ``csrc/kernel_opt.cu`` (or the call
raises; nothing falls back).  Any M is accepted.
"""

from __future__ import annotations

import torch

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops.idct_math import idct_1d
from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
    _check_inputs,
    _chroma_index,
    bt601_planes,
    dequantized,
    idct_blocks,
)
from pim_jpeg_decoder_tpu_torch.ops.stage_kernels import (
    _launch,
    _on_cuda,
    _plain_call,
)

# --- plain PyTorch versions --------------------------------------------------


def memfloor_reference(coeffs: torch.Tensor, qidx: torch.Tensor,
                       qpool: torch.Tensor,
                       mode: S.ModeSpec) -> torch.Tensor:
    """Plain :func:`memfloor` (``qidx`` and ``qpool`` unread, as in the
    kernel).  Calls on CUDA tensors are counted under ``plain_on_cuda``
    (as for every plain version below)."""
    _plain_call(coeffs)
    gy = mode.luma_slots
    c = coeffs.to(torch.int32)
    v = c[:, :gy] + (c[:, gy] + c[:, gy + 1])[:, None]          # [M, gy, 64]
    plane = (v & 0xFF).to(torch.uint8).permute(1, 2, 0)
    return torch.stack([plane] * 3)


def _colour_terms(chroma: torch.Tensor):
    """Clamped Cb and Cr samples ``[M, 2, 64]`` -> the three BT.601 terms
    (R: Cr, G: Cb and Cr, B: Cb), each ``[M, 64]`` at chroma resolution."""
    cb, cr = chroma[:, 0], chroma[:, 1]
    return (S.descale(S.FIX_CR_R * cr, S.COLOR_BITS),
            S.descale(S.FIX_CB_G * cb + S.FIX_CR_G * cr, S.COLOR_BITS),
            S.descale(S.FIX_CB_B * cb, S.COLOR_BITS))


def rgb_truerez_reference(coeffs: torch.Tensor, qidx: torch.Tensor,
                          qpool: torch.Tensor,
                          mode: S.ModeSpec) -> torch.Tensor:
    """Plain :func:`rgb_truerez`: the colour terms at chroma resolution,
    then replicated to each luma slot's pixels by indexing."""
    _plain_call(coeffs)
    m, gy = coeffs.shape[0], mode.luma_slots
    deq = dequantized(coeffs, qidx, qpool).view(m, mode.g, 8, 8)
    spat = idct_blocks(deq).reshape(m, mode.g, 64)
    idx = _chroma_index(mode).to(coeffs.device)                 # [gy, 64]
    y128 = spat[:, :gy] + 128
    planes = [(y128 + term[:, idx]).clamp(0, 255)
              for term in _colour_terms(spat[:, gy:])]
    return torch.stack(planes).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def rgb_stacked_reference(coeffs: torch.Tensor, qidx: torch.Tensor,
                          qpool: torch.Tensor,
                          mode: S.ModeSpec) -> torch.Tensor:
    """Plain :func:`rgb_stacked`: one ``idct_1d`` chain per pass over the
    luma slots stacked as ``[gy, 8, M]`` operands; chroma as in
    ``decode_mcus_reference``."""
    _plain_call(coeffs)
    m, gy = coeffs.shape[0], mode.luma_slots
    deq = dequantized(coeffs, qidx, qpool).view(m, mode.g, 8, 8)
    stk = deq[:, :gy].permute(1, 2, 3, 0)                    # [gy, v, u, M]
    rows1 = idct_1d([stk[:, v] for v in range(8)],
                    S.CONST_BITS - S.PASS1_BITS)       # r: [gy, u, M]
    y = torch.stack(rows1, dim=2)                      # [gy, u, r, M]
    cols2 = idct_1d([y[:, u] for u in range(8)],
                    S.CONST_BITS + S.PASS1_BITS + 3)   # p: [gy, r, M]
    luma = torch.stack(cols2, dim=1).clamp(S.SAMPLE_MIN, S.SAMPLE_MAX)
    chroma = idct_blocks(deq[:, gy:]).reshape(m, 2, 64)
    idx = _chroma_index(mode).to(coeffs.device)
    return bt601_planes(luma.reshape(gy, 64, m).permute(2, 0, 1),
                        chroma[:, 0][:, idx], chroma[:, 1][:, idx])


# --- the CUDA kernels --------------------------------------------------------

def _run(name: str, entry: str, plain, coeffs: torch.Tensor,
         qidx: torch.Tensor, qpool: torch.Tensor,
         mode: S.ModeSpec) -> torch.Tensor:
    """``plain`` on CPU tensors; on CUDA tensors the C entry point
    ``entry``, counted under the launch counter ``name``."""
    _check_inputs(coeffs, qidx, qpool, mode)
    if mode.ncomp != 3:
        raise ValueError(f"the {name} kernel takes a colour mode, not "
                         f"{mode.name}")
    if not _on_cuda(coeffs, qpool):
        return plain(coeffs, qidx, qpool, mode)
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    m = coeffs.shape[0]
    out = torch.empty((3, mode.luma_slots, 64, m), dtype=torch.uint8,
                      device=coeffs.device)
    if m:
        _launch(name, getattr(load(), entry),
                (coeffs.data_ptr(), coeffs.element_size(), qidx.data_ptr(),
                 qpool.data_ptr(), qpool.shape[0], out.data_ptr(), m, mode.h,
                 mode.v, mode.ncomp), out, f"{mode.name}, M={m}")
    return out


def memfloor(coeffs: torch.Tensor, qidx: torch.Tensor, qpool: torch.Tensor,
             mode: S.ModeSpec) -> torch.Tensor:
    """Layout-matched memory floor of ``rgb_kernel``: uint8
    ``[3, luma_slots, 64, M]``, each plane ``u8(c[s] + c[gy] + c[gy+1])``
    for luma slot ``s``."""
    return _run("memfloor", "pjt_cuda_memfloor", memfloor_reference, coeffs,
                qidx, qpool, mode)


def rgb_truerez(coeffs: torch.Tensor, qidx: torch.Tensor,
                qpool: torch.Tensor, mode: S.ModeSpec) -> torch.Tensor:
    """``decode_mcus(..., raw=True)`` with the colour terms computed at
    chroma resolution."""
    return _run("truerez", "pjt_cuda_decode_rgb_truerez",
                rgb_truerez_reference, coeffs, qidx, qpool, mode)


def rgb_stacked(coeffs: torch.Tensor, qidx: torch.Tensor,
                qpool: torch.Tensor, mode: S.ModeSpec) -> torch.Tensor:
    """``decode_mcus(..., raw=True)`` with the luma slots in one stacked
    butterfly chain."""
    return _run("stacked", "pjt_cuda_decode_rgb_stacked",
                rgb_stacked_reference, coeffs, qidx, qpool, mode)


# Launch-counter name -> (kernel wrapper, plain version).
KERNELS = {
    "memfloor": (memfloor, memfloor_reference),
    "truerez": (rgb_truerez, rgb_truerez_reference),
    "stacked": (rgb_stacked, rgb_stacked_reference),
}
