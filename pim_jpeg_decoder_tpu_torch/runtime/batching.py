"""MCU batch packing: many images -> per-mode device batches.

Same packing and bucketing as ``pim_jpeg_decoder_tpu/runtime/batching.py``
(which imports the Pallas kernel module):
images are packed greedily per sampling mode into an MCU budget, flushed
when the next one does not fit, and each flushed batch is allocated at the
smallest ``specs.MCU_BUCKETS`` size covering it, rounded up to ``align``
MCUs.  The CUDA kernel itself takes any MCU count; ``align`` only keeps
launch sizes on the same grid as the JAX engine's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pim_jpeg_decoder_tpu_torch.codec.header import JpegHeader
from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.models.pipeline import build_qpool

# Maximum images whose quant tables can share one device batch.
MAX_IMAGES_PER_BATCH = 16


def sort_by_size(paths: Sequence[str]) -> List[str]:
    """Sort input paths ascending by file size."""
    return sorted(paths, key=lambda p: (os.stat(p).st_size, p))


def compact_wire(coeffs: np.ndarray) -> np.ndarray:
    """int8 coefficient wire when every value fits, else unchanged (the
    kernel reads either; half the H2D bytes for typical q<=90 JPEGs)."""
    if coeffs.dtype != np.int16 or not coeffs.size:
        return coeffs
    if os.environ.get("PIM_JPEG_TPU_NO_NATIVE") != "1":
        from pim_jpeg_decoder_tpu_torch.native.binding import (
            compact_wire_cpp)
        out = compact_wire_cpp(coeffs)
        if out is not None:
            return out
    if coeffs.min() >= -128 and coeffs.max() <= 127:
        return coeffs.astype(np.int8)
    return coeffs


@dataclasses.dataclass
class PreparedImage:
    """One entropy-decoded image awaiting device decode."""
    name: str
    header: JpegHeader
    coeffs: np.ndarray          # [num_mcus, g, 64] int16
    uid: int = -1               # engine-assigned input index (names may repeat)
    # Set for MCU-aligned tiles of an over-max_launch_mcus image:
    # (accumulator, raster row offset, raster col offset).
    band_target: Optional[Tuple] = None


@dataclasses.dataclass
class Batch:
    """One device launch (a shard a device).  ``coeffs``/``qidx``/``qpool``
    start as NumPy arrays; staging moves them into ``placed``
    (``parallel.sharding.Placed``: the shards on their devices and the
    events their launches wait for) and clears them."""
    mode: S.ModeSpec
    coeffs: Any                 # [alloc, g, 64] int16 / int8
    qidx: Any                   # [alloc] int32
    qpool: Any                  # [Q, g, 64] float32, int32 once staged
    images: List[Tuple[PreparedImage, int]]   # (image, mcu_offset)
    transport: str = "rgb"      # set at dispatch: "rgb" | "ycbcr"
    placed: Any = None


class BatchPacker:
    """Greedy first-fit packer for one sampling mode."""

    def __init__(self, mode: S.ModeSpec, budget_mcus: int,
                 max_images: int = MAX_IMAGES_PER_BATCH, align: int = 1):
        self.mode = mode
        self.budget = budget_mcus
        self.max_images = max_images
        self.align = align
        self._images: List[Tuple[PreparedImage, int]] = []
        self._used = 0

    def _alloc_size(self) -> int:
        alloc = min(self.budget, S.bucket_mcus(self._used))
        alloc = max(alloc, self._used, self.align)
        return -(-alloc // self.align) * self.align

    def fits(self, image: PreparedImage) -> bool:
        return (self._used + image.header.num_mcus <= self.budget
                and len(self._images) < self.max_images)

    def add(self, image: PreparedImage) -> Optional[Batch]:
        """Add an image; returns a flushed Batch when it didn't fit."""
        flushed = None
        if not self.fits(image):
            flushed = self.flush()
        self._images.append((image, self._used))
        self._used += image.header.num_mcus
        return flushed

    def flush(self) -> Optional[Batch]:
        if not self._images:
            return None
        mode = self.mode
        alloc = self._alloc_size()
        coeffs = np.zeros((alloc, mode.g, 64), np.int16)
        qidx = np.zeros(alloc, np.int32)
        qpool = np.zeros((self.max_images, mode.g, 64), np.float32)
        qpool[: len(self._images)] = build_qpool(
            [img.header for img, _ in self._images], mode)
        for i, (img, off) in enumerate(self._images):
            n = img.header.num_mcus
            coeffs[off:off + n] = img.coeffs
            qidx[off:off + n] = i
        batch = Batch(mode, coeffs, qidx, qpool, self._images)
        self._images = []
        self._used = 0
        return batch


class ModeRouter:
    """Routes prepared images to per-mode packers; yields flushed batches."""

    def __init__(self, budget_mcus: int,
                 max_images: int = MAX_IMAGES_PER_BATCH, align: int = 1):
        self.budget = budget_mcus
        self.max_images = max_images
        self.align = align
        self._packers: Dict[Tuple[int, int, int], BatchPacker] = {}

    def add(self, image: PreparedImage) -> List[Batch]:
        key = image.header.mode_key
        packer = self._packers.get(key)
        if packer is None:
            packer = self._packers[key] = BatchPacker(
                S.mode_for(key), self.budget, self.max_images,
                align=self.align)
        flushed = packer.add(image)
        return [flushed] if flushed else []

    def flush_all(self) -> List[Batch]:
        out = []
        for packer in self._packers.values():
            b = packer.flush()
            if b is not None:
                out.append(b)
        return out
