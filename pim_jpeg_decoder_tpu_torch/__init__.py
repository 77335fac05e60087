"""pim_jpeg_decoder_tpu_torch — the JPEG decode engine on PyTorch and CUDA.

A port of :mod:`pim_jpeg_decoder_tpu` (JAX/Pallas on a TPU) to an NVIDIA
Hopper GPU.  The host layer (marker scan, C++ entropy decode, BMP I/O, the
NumPy oracle and the integer spec) is the JAX package's own, imported
without JAX; the device decode is two hand-written CUDA kernels
(``csrc/decode_kernel.cu``) with plain PyTorch versions beside them.

Top-level API (lazy, so importing the package builds and loads nothing):
``TorchJpegDecoder``, ``decode_bytes``, ``decode_file``, ``DecodeEngine``.
"""

from pim_jpeg_decoder_tpu_torch.version import __version__

__all__ = ["__version__", "TorchJpegDecoder", "decode_bytes", "decode_file",
           "DecodeEngine"]


def __getattr__(name):
    if name in ("TorchJpegDecoder", "decode_bytes", "decode_file"):
        from pim_jpeg_decoder_tpu_torch.models import pipeline
        return getattr(pipeline, name)
    if name == "DecodeEngine":
        from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
        return DecodeEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
