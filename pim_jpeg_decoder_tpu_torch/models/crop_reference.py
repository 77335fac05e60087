"""Plain reference of the crop batch path: JPEG bytes and crop origins ->
``[B, crop_h, crop_w, 3]``, one image at a time.

It is written apart from the code it checks.  Each file is decoded whole
by the NumPy oracle (``oracle.decoder.decode_bytes_oracle``, the integer
spec the kernels implement), the ``crop_hw`` window is cut at the image's
origin, and ``(pixel - mean) / std`` is computed in float32 and cast to
the output type last, with plain ``torch`` operations.  Nothing here
imports a kernel of the port, an ``ops`` launcher or JAX; it stages no MCU
sub-grid, groups no sampling modes and knows no device.  Images of any
size and sampling mode mix freely in a batch.

The port's epilogue computes ``(pixel - mean) * (1 / std)``.  Over the 256
pixel values the two agree once rounded to bfloat16 or float16 for
ImageNet's statistics, and in float32 wherever ``1 / std`` is exact (no
``std``, or a power of two); elsewhere float32 outputs may differ by one
step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pim_jpeg_decoder_tpu_torch.oracle.decoder import decode_bytes_oracle


def _channels(v) -> Optional[torch.Tensor]:
    """A scalar or length-3 statistic as a float32 ``[3]`` tensor."""
    if v is None:
        return None
    t = torch.tensor(np.asarray(v, np.float32).reshape(-1))
    return t.expand(3) if t.numel() == 1 else t


def normalize(pixels: torch.Tensor, dtype=None, mean=None, std=None
              ) -> torch.Tensor:
    """uint8 ``[..., 3]`` -> ``(pixels - mean) / std`` in float32, cast to
    ``dtype`` last; the pixels unchanged without a ``dtype``."""
    if dtype is None:
        return pixels
    x = pixels.to(torch.float32)
    m, s = _channels(mean), _channels(std)
    if m is not None:
        x = x - m
    if s is not None:
        x = x / s
    return x.to(dtype)


def crop_batch(blobs: Sequence[bytes], boxes: Sequence[Tuple[int, int]],
               crop_hw: Tuple[int, int], dtype=None, mean=None, std=None
               ) -> torch.Tensor:
    """The batch ``decode_batch_crops(blobs, boxes, crop_hw, dtype=dtype,
    mean=mean, std=std)`` should give at scale 1, on the CPU: image i's
    window ``[y0:y0 + crop_h, x0:x0 + crop_w]`` at ``boxes[i] = (y0,
    x0)``, in input order."""
    crop_h, crop_w = crop_hw
    crops = []
    for data, (y0, x0) in zip(blobs, boxes):
        rgb = torch.from_numpy(decode_bytes_oracle(data).rgb)
        crop = rgb[y0:y0 + crop_h, x0:x0 + crop_w]
        if min(y0, x0) < 0 or tuple(crop.shape[:2]) != (crop_h, crop_w):
            raise ValueError(f"crop [{y0}:{y0 + crop_h}, {x0}:{x0 + crop_w}]"
                             f" outside {rgb.shape[0]}x{rgb.shape[1]}")
        crops.append(normalize(crop, dtype, mean, std))
    return torch.stack(crops)
