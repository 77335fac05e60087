"""Plain reference of the scaled same-size batch path: JPEG bytes ->
``[B, ceil(H/scale), ceil(W/scale), 3]``, one image at a time.

It is written apart from the code it checks.  Each file is decoded by the
NumPy oracle at ``scale`` (``oracle.decoder.decode_scaled_oracle``: the
reduced IDCT of specs.py 'Reduced (scaled) IDCT' on the top-left
frequencies of each block, chroma at f*n points and never upsampled), and
``(pixel - mean) / std`` is computed in float32 and cast to the output
type last, with plain ``torch`` operations (``crop_reference.normalize``).
Nothing here imports a kernel of the port, an ``ops`` launcher or JAX; it
knows no MCU layout, no transport and no device.

The port's epilogue computes ``(pixel - mean) * (1 / std)``.  Over the 256
pixel values the two agree once rounded to bfloat16 or float16 for CLIP's
statistics and for a latent-diffusion autoencoder's ``mean = std =
127.5``, and in float32 wherever ``1 / std`` is exact (no ``std``, or a
power of two); elsewhere float32 outputs may differ by one step (378 of
the 768 values at ``std = 127.5``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from pim_jpeg_decoder_tpu_torch.models.crop_reference import normalize
from pim_jpeg_decoder_tpu_torch.oracle.decoder import decode_scaled_oracle


def scaled_batch(blobs: Sequence[bytes], scale: int, dtype=None, mean=None,
                 std=None) -> torch.Tensor:
    """The batch ``decode_same_size_batch(blobs, scale=scale, dtype=dtype,
    mean=mean, std=std)`` should give, on the CPU, in input order."""
    return torch.stack([
        normalize(torch.from_numpy(decode_scaled_oracle(data, scale)), dtype,
                  mean, std) for data in blobs])
