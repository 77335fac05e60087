"""Native (C++) host fast paths with pure-Python fallbacks.

The reference's host frontend is C++ (jpeg_scanner.cpp); here the
bit-serial entropy decode — the host hot loop (SURVEY.md section 3.2) — is
implemented in C++ (entropy.cpp), compiled on demand with g++ and bound via
ctypes (releasing the GIL so producer threads scale).  Falls back to the
NumPy/Python implementation in :mod:`pim_jpeg_decoder_tpu_torch.codec.entropy`
when no compiler is available or PIM_JPEG_TPU_NO_NATIVE=1.
"""

from __future__ import annotations

import os

import numpy as np

from pim_jpeg_decoder_tpu_torch.codec.entropy import decode_scan
from pim_jpeg_decoder_tpu_torch.codec.header import JpegHeader


def native_available() -> bool:
    if os.environ.get("PIM_JPEG_TPU_NO_NATIVE") == "1":
        return False
    try:
        from pim_jpeg_decoder_tpu_torch.native import binding
        return binding.load() is not None
    except Exception:
        return False


def decode_scan_native(header: JpegHeader, threads: int = 1,
                       out=None) -> np.ndarray:
    """Entropy-decode a scan via C++ if available, else the Python path.

    ``threads > 1`` enables restart-segment-parallel decode for DRI images
    (independent bitstream entry points; SURVEY.md section 2 item 4).
    ``out`` (optional, caller-zeroed ``[num_mcus, g, 64]`` int16) lets the
    native path decode straight into a batch transport slice.
    """
    if native_available():
        from pim_jpeg_decoder_tpu_torch.native import binding
        return binding.decode_scan_cpp(header, threads=threads, out=out)
    coeffs = decode_scan(header)
    if out is not None:
        out[...] = coeffs
        return out
    return coeffs
