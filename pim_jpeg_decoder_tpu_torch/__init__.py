"""pim_jpeg_decoder_tpu_torch — the JPEG decode engine on PyTorch and CUDA.

A port of :mod:`pim_jpeg_decoder_tpu` (JAX/Pallas on a TPU) to an NVIDIA
Hopper GPU.  The host layer (marker scan, C++ entropy decode, BMP I/O, the
NumPy oracle and the integer spec) is the port's own copy of the JAX
package's, at the same relative paths (``codec/``, ``native/``, ``io/``,
``oracle/``, ``ops/specs.py``, ``ops/idct_math.py``, ``utils/``); the port
imports nothing of ``pim_jpeg_decoder_tpu``.  The device work is
hand-written CUDA kernels (``csrc/``: full-scale RGB, YCbCr, scaled RGB,
the batch raster epilogue, the stage kernels and the tools' kernels) with
plain PyTorch versions beside them.

Top-level API (lazy, so importing the package builds and loads nothing):
``TorchJpegDecoder``, ``decode_bytes``, ``decode_file``, ``decode_region``,
``decode_scaled``, ``DecodeEngine``; device-resident batches
(``models.input_pipeline``): ``decode_same_size_batch``,
``decode_same_size_batch_crops``, ``decode_batch_crops`` (mixed sizes),
``iter_decode_batches``, ``iter_decode_batch_crops``.
"""

from pim_jpeg_decoder_tpu_torch.version import __version__

_PIPELINE_API = ("TorchJpegDecoder", "decode_bytes", "decode_file",
                 "decode_region", "decode_scaled")
_BATCH_API = ("decode_same_size_batch", "decode_same_size_batch_crops",
              "decode_batch_crops", "iter_decode_batches",
              "iter_decode_batch_crops")

__all__ = ["__version__", *_PIPELINE_API, "DecodeEngine", *_BATCH_API]


def __getattr__(name):
    if name in _PIPELINE_API:
        from pim_jpeg_decoder_tpu_torch.models import pipeline
        return getattr(pipeline, name)
    if name in _BATCH_API:
        from pim_jpeg_decoder_tpu_torch.models import input_pipeline
        return getattr(input_pipeline, name)
    if name == "DecodeEngine":
        from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
        return DecodeEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
