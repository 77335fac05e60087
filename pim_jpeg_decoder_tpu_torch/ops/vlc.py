"""The serial variable-length-code symbol loop: one Huffman-like symbol per
step, each step's advance known only after its table lookup.

PyTorch counterpart of the kernel in the repository's
``tools/tpu_vlc_bench.py`` (``_vlc_kernel``); ``tools/vlc_bench.py`` of
this package times it.  From bit ``seed & 1`` of a ``NWORDS``-word
bitstream: read the 32-bit window at the bit position, look its top 8 bits
up in a ``LUT_SIZE``-entry table (``entry & 0xF`` code bits, ``(entry >>
4) & 0xF`` value bits, ``(entry >> 8) & 0xFF`` added to a sum), advance by
code + value bits, until the position reaches ``NBITS`` (clear of the
stream's last two words).  Returns int32 ``[acc, nsym, bitpos]``.

A table entry with no advance would loop forever in the JAX kernel; both
versions here also stop after ``NBITS`` symbols, which no table with a
non-zero advance reaches.

:func:`vlc_reference` is the plain version (a Python loop: the work is one
serial chain); CPU tensors take it, CUDA tensors the kernel of
``csrc/vlc.cu`` (one thread; the call raises on failure, nothing falls
back).
"""

from __future__ import annotations

import torch

from pim_jpeg_decoder_tpu_torch.ops.stage_kernels import _launch, _plain_call

NWORDS = 2048          # 8 KiB bitstream
LUT_SIZE = 256
NBITS = NWORDS * 32 - 64


def _check(seed: torch.Tensor, data: torch.Tensor, lut: torch.Tensor) -> None:
    for name, t, n in (("seed", seed, 1), ("data", data, NWORDS),
                       ("lut", lut, LUT_SIZE)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({t.device for t in (seed, data, lut)}) != 1:
        raise ValueError("seed, data and lut must be on one device")


def vlc_reference(seed: torch.Tensor, data: torch.Tensor,
                  lut: torch.Tensor) -> torch.Tensor:
    """Plain :func:`vlc`.  Calls on CUDA tensors are counted under
    ``plain_on_cuda``."""
    _check(seed, data, lut)
    _plain_call(data)
    words = [w & 0xFFFFFFFF for w in data.tolist()]
    table = [e & 0xFFFFFFFF for e in lut.tolist()]
    bitpos = seed.item() & 1
    acc = nsym = 0
    while bitpos < NBITS and nsym < NBITS:
        widx, shift = bitpos >> 5, bitpos & 31
        win = (words[widx] << shift) & 0xFFFFFFFF
        if shift:
            win |= words[widx + 1] >> (32 - shift)
        entry = table[win >> 24]
        acc += (entry >> 8) & 0xFF
        bitpos += (entry & 0xF) + ((entry >> 4) & 0xF)
        nsym += 1
    return torch.tensor([acc, nsym, bitpos], dtype=torch.int32,
                        device=data.device)


def vlc(seed: torch.Tensor, data: torch.Tensor,
        lut: torch.Tensor) -> torch.Tensor:
    """int32 ``seed [1]``, ``data [NWORDS]``, ``lut [LUT_SIZE]`` -> int32
    ``[acc, nsym, bitpos]``."""
    _check(seed, data, lut)
    if data.device.type == "cpu":
        return vlc_reference(seed, data, lut)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    out = torch.empty(3, dtype=torch.int32, device=data.device)
    _launch("vlc", load().pjt_cuda_vlc,
            (seed.data_ptr(), data.data_ptr(), lut.data_ptr(),
             out.data_ptr()), out, f"{NWORDS} words")
    return out
