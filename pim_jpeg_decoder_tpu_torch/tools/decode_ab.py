"""A/B of the full-scale decode kernels (``rgb_kernel``, ``ycbcr_kernel``),
the raster epilogue, the dequantize, IDCT and colour stage kernels, the
scaled decode kernel, the stacked and truerez experiment kernels, the
tensor-core IDCT kernels, the memory floor and the VLC kernel between two
checkouts, in one call on one card.

    python3 pim_jpeg_decoder_tpu_torch/tools/decode_ab.py --parent DIR
    python3 pim_jpeg_decoder_tpu_torch/tools/decode_ab.py --root DIR

``--root DIR`` times DIR's kernels: this script imports
``pim_jpeg_decoder_tpu_torch`` from DIR (DIR's sources, DIR's build) and
prints one JSON line, ``{"card", "results": {geometry: {"us", "min_us",
"max_us", "sha1"}}}``.  ``--parent DIR`` runs that in four processes of
their own, in the order parent, this checkout, this checkout, parent, so
that both sides see the same card and the same drift; checks that every
run wrote the same bytes (sha1 of one output per geometry); and prints a
line per geometry and then one JSON line ``{geometry: {"parent_us",
"change_us", "band_us", "speedup", "verdict"}}``.  ``band_us`` is the
larger spread between the two runs of one side; the verdict is "faster"
or "slower" only beyond it, else "within band".

Geometries (``GEOMETRIES``): both kernels in all 5 modes at M=16,384 on
the int8 wire, and 4:2:0 at M=16,384 int16 and at M=196,608 (a B=256
ImageNet batch) on both wires; the raster epilogue
(``EPILOGUE_GEOMETRIES``) on that batch (256 images of 24 x 32 4:2:0 MCUs,
500x375) at scale 1 -> uint8, scale 2 -> bfloat16 normalised, 224x224
crops of the scale-1 batch -> bfloat16 normalised and scale 1 -> float32
normalised, on full batches of 224x224, 384x384 and 512x512 images
(``SQUARE_BATCHES``) -> bfloat16, and on the loader
benchmark's batch (``LOADER_BATCH``: 256 images of 16 x 16 4:2:0 MCUs,
256x256) at scale 1 -> bfloat16 with CLIP's statistics; the crop cell's two
launches (``CROP_CELL_GEOMETRIES``: 4:2:0 B=225 on 15 x 15 MCUs and 4:4:4
B=31 on 29 x 29, 224x224 crops -> bfloat16 through destination rows into
one output of 256) and its two decode launches unpadded, beside their
nearest M on the 16-byte grid (``CROP_CELL_DECODES``: ``rgb_kernel`` int16 at
4:2:0, M=50,625 and 50,624, and 4:4:4, M=26,071 and 26,064); the
dequantize stage
(``DEQUANT_GEOMETRIES``) at 4:2:0, M=16,384 and 196,608, on both wires;
the IDCT and colour stages (``IDCT_GEOMETRIES``, ``COLOR_GEOMETRIES``) at
4:2:0, M=16,384 and 196,608, int16: the IDCT on the dequantize stage's
output, the colour stage on the IDCT stage's, of the same seeded inputs;
the scaled decode (``SCALED_GEOMETRIES``: 4:2:0 scale 2 at M=16,384 and
196,608 on both wires, scale 4 and 8 at 196,608 int8, gray and 4:4:4
scale 2 at 16,384 int8, then 4:2:0 scale 2 at the half-scale cell's
M=262,144 on both wires and at M=131,091 int16, whose blocks walk several
tiles and whose last tile holds 19 MCUs, and 4:4:0 and 4:2:2 scale 2 at
196,608 int16, the one walking and the other not); the stacked and truerez kernels
(``STACKED_GEOMETRIES``, ``TRUEREZ_GEOMETRIES``: 4:2:0 at M=16,384 on both
wires and 196,608 int16), whose lines end with ``rgb_kernel``'s time on the
same geometry from the same runs; the tensor-core IDCT (``MXU_GEOMETRIES``:
``mxu2pass`` with pieces 1 and 2 and ``mxu64`` at 4:2:0, M=16,384, both
``mxu2pass`` forms at 196,608 and ``mxu64`` at 196,608, int16); the memory
floor (``MEMFLOOR_GEOMETRIES``: 4:2:0 at M=16,384 on both wires and 196,608
int16), whose lines also end with ``rgb_kernel``'s time; the VLC kernel
(``VLC_GEOMETRY``: the tool's draw, ``tools/vlc_bench.make_inputs``, 2,048
words, launches cycling over seeds 0-7; its digest covers the eight
``[acc, nsym, bitpos]``).
Inputs: Laplace(0, 6) coefficients, Q=16 quantizer rows (one of 16-bit
values), uniform bytes for the epilogue, the IDCT tool's draw (int16 in
[-2048, 2048), ``tools/mxu_idct_ab.make_inputs``), drawn from a fixed seed,
rotated past twice the L2 (``utils/devbench.rotation_count``); each time is
the median of 30 launches timed with CUDA events
(``utils/devbench.seconds_per_launch``), with their min and max.

Needs a CUDA card (exit 2 without one); exit 1 if the runs disagree on an
output.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

SEED = 20261016
HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODE_KEYS = ((1, 1, 1), (1, 1, 3), (1, 2, 3), (2, 1, 3), (2, 2, 3))
# (kernel, (h, v, ncomp), M, wire bytes)
GEOMETRIES: Tuple[Tuple[str, tuple, int, int], ...] = tuple(
    [(k, key, 16384, 1) for k in ("rgb", "ycbcr") for key in MODE_KEYS]
    + [(k, (2, 2, 3), m, w) for k in ("rgb", "ycbcr")
       for m, w in ((16384, 2), (196608, 1), (196608, 2))])
# The B=256 ImageNet batch of the epilogue: images, MCU rows and columns
# per image (4:2:0), image height and width.
BATCH = (256, 24, 32, 375, 500)
IMAGENET_NORM = dict(mean=(123.675, 116.28, 103.53),
                     std=(58.395, 57.12, 57.375))
# The batch of the loader benchmark's cell (perfbench loader-laion256):
# 256 images of 16 x 16 4:2:0 MCUs, 256x256, normalised by CLIP's mean and
# std x 255.
LOADER_BATCH = (256, 16, 16, 256, 256)
CLIP_NORM = dict(mean=(122.7709383, 116.7460125, 104.09373615),
                 std=(68.5005327, 66.6321579, 70.32316305))
# Full batches of square 4:2:0 images that the epilogue's row form takes
# with 4-byte (224x224: 28-MCU runs), 8-byte (384x384: 24) and 16-byte
# copies (512x512: one MCU row a band).
SQUARE_BATCHES = ((256, 14, 14, 224, 224), (256, 24, 24, 384, 384),
                  (64, 32, 32, 512, 512))
# (label, batch, scale, output dtype name or None for uint8, crop size or
# None, mean and std)
EPILOGUE_GEOMETRIES: Tuple[Tuple[str, tuple, int, Optional[str],
                                 Optional[tuple], dict], ...] = (
    ("scale 1 -> uint8", BATCH, 1, None, None, IMAGENET_NORM),
    ("scale 2 -> bfloat16", BATCH, 2, "bfloat16", None, IMAGENET_NORM),
    ("224x224 crops -> bfloat16", BATCH, 1, "bfloat16", (224, 224),
     IMAGENET_NORM),
    ("scale 1 -> float32", BATCH, 1, "float32", None, IMAGENET_NORM),
    ("scale 1 -> bfloat16 CLIP", LOADER_BATCH, 1, "bfloat16", None,
     CLIP_NORM),
    ("scale 1 -> bfloat16", SQUARE_BATCHES[0], 1, "bfloat16", None,
     IMAGENET_NORM),
    ("scale 1 -> bfloat16", SQUARE_BATCHES[1], 1, "bfloat16", None,
     IMAGENET_NORM),
    ("scale 1 -> bfloat16", SQUARE_BATCHES[2], 1, "bfloat16", None,
     IMAGENET_NORM))
# The crop cell's two epilogue launches (perfbench loader-imagenet-crops)
# in the split it mostly draws: the batch's 4:2:0 group, 225 images on
# 15 x 15-MCU sub-grids, and its 4:4:4 group, 31 on 29 x 29, each with M =
# B * g * g (no padding, so M % 16 != 0) and 224x224 crops -> bfloat16 with
# ImageNet's statistics written through destination rows into one output
# of CROP_CELL_BATCH images.  ((h, v, ncomp), images, MCUs a side)
CROP_CELL_GEOMETRIES: Tuple[Tuple[tuple, int, int], ...] = (
    ((2, 2, 3), 225, 15), ((1, 1, 3), 31, 29))
CROP_CELL_BATCH = 256
CROP_CELL_CROP = (224, 224)
# The crop cell's two decode launches in that split (rgb_kernel on the
# int16 wire, M = B * g * g: 225 * 15 * 15 at 4:2:0, 31 * 29 * 29 at
# 4:4:4), each followed by the nearest M below it on the 16-byte grid, so
# that the form whose rows start off the grid is timed beside the one whose
# rows start on it (the batch paths now pad such a launch to the grid).
# ((h, v, ncomp), M)
CROP_CELL_DECODES: Tuple[Tuple[tuple, int], ...] = (
    ((2, 2, 3), 50625), ((2, 2, 3), 50624),
    ((1, 1, 3), 26071), ((1, 1, 3), 26064))
# (M, wire bytes) of the dequantize stage at 4:2:0
DEQUANT_GEOMETRIES: Tuple[Tuple[int, int], ...] = (
    (16384, 2), (16384, 1), (196608, 2), (196608, 1))
# M of the IDCT and colour stages at 4:2:0, int16
IDCT_GEOMETRIES: Tuple[int, ...] = (16384, 196608)
COLOR_GEOMETRIES: Tuple[int, ...] = (16384, 196608)
# ((h, v, ncomp), scale, M, wire bytes) of the scaled decode
SCALED_GEOMETRIES: Tuple[Tuple[tuple, int, int, int], ...] = (
    ((2, 2, 3), 2, 16384, 1), ((2, 2, 3), 2, 16384, 2),
    ((2, 2, 3), 2, 196608, 1), ((2, 2, 3), 2, 196608, 2),
    ((2, 2, 3), 4, 196608, 1), ((2, 2, 3), 8, 196608, 1),
    ((1, 1, 1), 2, 16384, 1), ((1, 1, 3), 2, 16384, 1),
    ((2, 2, 3), 2, 262144, 1), ((2, 2, 3), 2, 262144, 2),
    ((2, 2, 3), 2, 131091, 2), ((1, 2, 3), 2, 196608, 2),
    ((2, 1, 3), 2, 196608, 2))
# (M, wire bytes) of the stacked kernel at 4:2:0
STACKED_GEOMETRIES: Tuple[Tuple[int, int], ...] = (
    (16384, 1), (16384, 2), (196608, 2))
# (M, wire bytes) of the truerez kernel at 4:2:0
TRUEREZ_GEOMETRIES: Tuple[Tuple[int, int], ...] = (
    (16384, 1), (16384, 2), (196608, 2))
# (variant of tools/mxu_idct_ab, M) of the tensor-core IDCT at 4:2:0, int16
MXU_GEOMETRIES: Tuple[Tuple[str, int], ...] = (
    ("mxu2pass", 16384), ("mxu2pass4", 16384), ("mxu64", 16384),
    ("mxu2pass", 196608), ("mxu2pass4", 196608), ("mxu64", 196608))
# (M, wire bytes) of the memory floor at 4:2:0
MEMFLOOR_GEOMETRIES: Tuple[Tuple[int, int], ...] = (
    (16384, 1), (16384, 2), (196608, 2))
ORDER = ("parent", "change", "change", "parent")


# The VLC kernel on its tool's bitstream and table, seeds 0-7.
VLC_GEOMETRY = "vlc 2048 words, the tool's draw, seeds 0-7"
VLC_SEEDS = 8


def geometry_name(kernel: str, mode_name: str, m: int, wire: int) -> str:
    return f"{kernel} {mode_name} M={m} int{8 * wire}"


def epilogue_name(label: str, batch: tuple = BATCH) -> str:
    b, _, _, h, w = batch
    return f"epilogue B={b} {w}x{h} 4:2:0 {label}"


def crop_cell_name(key: tuple, b: int, g: int) -> str:
    from pim_jpeg_decoder_tpu_torch.ops import specs as S

    h, w = CROP_CELL_CROP
    return (f"epilogue crop cell {S.mode_for(key).name} B={b} on {g}x{g} "
            f"MCUs {w}x{h} crops -> bfloat16 rows into {CROP_CELL_BATCH}")


def dequant_name(m: int, wire: int) -> str:
    return geometry_name("dequant", "4:2:0", m, wire)


def stage_name(stage: str, m: int) -> str:
    """``stage`` is "idct" or "color"; both take int16 at 4:2:0."""
    return geometry_name(stage, "4:2:0", m, 2)


def scaled_name(key: tuple, scale: int, m: int, wire: int) -> str:
    from pim_jpeg_decoder_tpu_torch.ops import specs as S

    return geometry_name(f"rgb_scaled scale {scale}", S.mode_for(key).name,
                         m, wire)


def stacked_name(m: int, wire: int) -> str:
    """The stacked kernel at 4:2:0; ``rgb_kernel``'s geometry of the same
    M and wire is ``geometry_name("rgb", "4:2:0", m, wire)``."""
    return geometry_name("stacked", "4:2:0", m, wire)


def truerez_name(m: int, wire: int) -> str:
    """The truerez kernel at 4:2:0, beside ``rgb_kernel`` as the stacked
    kernel is."""
    return geometry_name("truerez", "4:2:0", m, wire)


def mxu_name(variant: str, m: int) -> str:
    return geometry_name(variant, "4:2:0", m, 2)


def memfloor_name(m: int, wire: int) -> str:
    """The memory floor at 4:2:0, beside ``rgb_kernel`` as the truerez
    kernel is."""
    return geometry_name("memfloor", "4:2:0", m, wire)


def geometry_names() -> List[str]:
    """Every geometry ``side`` times, in its order."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S

    return ([geometry_name(k, S.mode_for(key).name, m, w)
             for k, key, m, w in GEOMETRIES]
            + [epilogue_name(label, batch)
               for label, batch, *_ in EPILOGUE_GEOMETRIES]
            + [crop_cell_name(*g) for g in CROP_CELL_GEOMETRIES]
            + [geometry_name("rgb", S.mode_for(key).name, m, 2)
               for key, m in CROP_CELL_DECODES]
            + [dequant_name(m, w) for m, w in DEQUANT_GEOMETRIES]
            + [stage_name(stage, m) for stage, m in stage_geometries()]
            + [scaled_name(*g) for g in SCALED_GEOMETRIES]
            + [stacked_name(m, w) for m, w in STACKED_GEOMETRIES]
            + [truerez_name(m, w) for m, w in TRUEREZ_GEOMETRIES]
            + [mxu_name(v, m) for v, m in MXU_GEOMETRIES]
            + [memfloor_name(m, w) for m, w in MEMFLOOR_GEOMETRIES]
            + [VLC_GEOMETRY])


def stage_geometries() -> List[Tuple[str, int]]:
    """``(stage, M)`` of the IDCT and colour geometries in the order
    ``side`` times them: by M, the IDCT before the colour stage."""
    return [(stage, m)
            for m in sorted(set(IDCT_GEOMETRIES) | set(COLOR_GEOMETRIES))
            for stage, ms in (("idct", IDCT_GEOMETRIES),
                              ("color", COLOR_GEOMETRIES)) if m in ms]


def _inputs(torch, mode, m: int, wire: int, dev):
    """Rotating ``(coeffs, qidx, qpool)`` buffers on ``dev``, past twice
    the L2."""
    import numpy as np

    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    rng = np.random.default_rng(SEED + m + 7 * wire + 31 * mode.g)
    dtype = np.int8 if wire == 1 else np.int16
    info = np.iinfo(dtype)
    count = max(2, rotation_count(m * mode.g * 64 * wire, dev))
    bufs = []
    for _ in range(count):
        coeffs = np.clip(np.round(rng.laplace(0.0, 6.0, (m, mode.g, 64))),
                         info.min, info.max).astype(dtype)
        qpool = rng.integers(1, 100, (16, mode.g, 64)).astype(np.float32)
        qpool[15] = rng.integers(1, 65536, (mode.g, 64))
        qidx = rng.integers(0, 16, m).astype(np.int32)
        bufs.append((coeffs_to_device(coeffs, dev),
                     torch.from_numpy(qidx).to(dev),
                     qpool_to_device(qpool, dev)))
    return bufs


def crop_origins(torch, rng, batch: int, scale: int, image_hw: tuple,
                 crop: tuple, dev) -> tuple:
    """Seeded ``(oy, ox)`` int32 tensors on ``dev``: origins anywhere a
    ``crop`` fits in the image decoded at ``scale``."""
    import numpy as np

    return tuple(
        torch.from_numpy(rng.integers(0, full // scale - size + 1, batch)
                         .astype(np.int32)).to(dev)
        for full, size in zip(image_hw, crop))


def _epilogue_case(torch, mode, batch: tuple, scale: int,
                   dtype_name: Optional[str], crop: Optional[tuple],
                   stats: dict, dev):
    """``(fn, rotating raw inputs)`` of one epilogue geometry: uniform
    bytes in the decode kernels' layout, and seeded crop origins."""
    import numpy as np

    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _norm_static
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import raster_epilogue
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    b, gh, gw, height, width = batch
    n = 8 // scale
    rng = np.random.default_rng(SEED + 97 * scale + (5 if crop else 0)
                                + (0 if batch == BATCH else 11))
    shape = (3, mode.luma_slots, n * n, b * gh * gw)
    raws = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
            .to(dev) for _ in range(rotation_count(int(np.prod(shape)), dev))]
    norm = (_norm_static(getattr(torch, dtype_name), **stats)
            if dtype_name else None)
    out_h, out_w = crop or (-(-height // scale), -(-width // scale))
    origins = (crop_origins(torch, rng, b, scale, (height, width), crop, dev)
               if crop else ())

    def fn(raw):
        return raster_epilogue(raw, mode, scale, b, gh, gw, out_h, out_w,
                               *origins, norm=norm)

    return fn, raws


def _crop_cell_case(torch, key: tuple, b: int, g: int, dev):
    """``(fn, rotating raw inputs)`` of one of the crop cell's epilogue
    launches: uniform bytes for ``b`` images of ``g x g`` MCUs, seeded
    origins over the sub-grid's slack, and seeded destination rows, ``b``
    of the ``CROP_CELL_BATCH`` rows of one zeroed output."""
    import numpy as np

    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _norm_static
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import raster_epilogue
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    mode = S.mode_for(key)
    rng = np.random.default_rng(SEED + 13 * g + b)
    shape = (3, mode.luma_slots, 64, b * g * g)
    raws = [torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
            .to(dev) for _ in range(rotation_count(int(np.prod(shape)), dev))]
    norm = _norm_static(torch.bfloat16, **IMAGENET_NORM)
    out_h, out_w = CROP_CELL_CROP
    origins = crop_origins(torch, rng, b, 1,
                           (g * mode.mcu_px_h, g * mode.mcu_px_w),
                           CROP_CELL_CROP, dev)
    rows = torch.from_numpy(rng.permutation(CROP_CELL_BATCH)[:b]
                            .astype(np.int32)).to(dev)
    out = torch.zeros((CROP_CELL_BATCH, out_h, out_w, 3),
                      dtype=torch.bfloat16, device=dev)

    def fn(raw):
        return raster_epilogue(raw, mode, 1, b, g, g, out_h, out_w, *origins,
                               norm=norm, rows=rows, out=out)

    return fn, raws


def _as_bytes(torch, out) -> bytes:
    """The bytes of a tensor on the card (bfloat16 through its bits)."""
    flat = out.contiguous().view(-1)
    if flat.dtype in (torch.bfloat16, torch.float16):
        flat = flat.view(torch.int16)
    return flat.cpu().numpy().tobytes()


def side() -> dict:
    """Time every geometry with the imported package's kernels."""
    import torch

    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import decode_mcus
    from pim_jpeg_decoder_tpu_torch.ops.kernel_variants import (
        memfloor, rgb_stacked, rgb_truerez)
    from pim_jpeg_decoder_tpu_torch.ops.stage_kernels import (
        color_stage, dequantize_stage, idct_stage)
    from pim_jpeg_decoder_tpu_torch.ops.vlc import vlc
    from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab, vlc_bench
    from pim_jpeg_decoder_tpu_torch.utils.devbench import (
        rotation_count, seconds_per_launch)

    dev = torch.device("cuda", 0)
    results = {}

    def measure(name: str, fn, bufs, digest_all: bool = False) -> None:
        """Times ``fn`` over ``bufs``; the digest is of its output on the
        first buffer, or on every buffer with ``digest_all``."""
        outs = [fn(b) for b in (bufs if digest_all else bufs[:1])]
        torch.cuda.synchronize()
        digest = hashlib.sha1(b"".join(_as_bytes(torch, out)
                                       for out in outs)).hexdigest()
        del outs
        us = sorted(t * 1e6 for t in seconds_per_launch(fn, bufs,
                                                          samples=True))
        results[name] = {"us": statistics.median(us), "min_us": us[0],
                         "max_us": us[-1], "sha1": digest}

    for kernel, key, m, wire in GEOMETRIES:
        mode = S.mode_for(key)
        bufs = _inputs(torch, mode, m, wire, dev)
        measure(geometry_name(kernel, mode.name, m, wire),
                lambda b, yc=kernel == "ycbcr": decode_mcus(
                    *b, mode, raw=True, ycbcr=yc), bufs)
        del bufs
        torch.cuda.empty_cache()
    mode = S.mode_for((2, 2, 3))
    for label, batch, scale, dtype_name, crop, stats in EPILOGUE_GEOMETRIES:
        fn, raws = _epilogue_case(torch, mode, batch, scale, dtype_name,
                                  crop, stats, dev)
        measure(epilogue_name(label, batch), fn, raws)
        del fn, raws
        torch.cuda.empty_cache()
    for key, b, g in CROP_CELL_GEOMETRIES:
        fn, raws = _crop_cell_case(torch, key, b, g, dev)
        measure(crop_cell_name(key, b, g), fn, raws)
        del fn, raws
        torch.cuda.empty_cache()
    for key, m in CROP_CELL_DECODES:
        decode_mode = S.mode_for(key)
        bufs = _inputs(torch, decode_mode, m, 2, dev)
        measure(geometry_name("rgb", decode_mode.name, m, 2),
                lambda b: decode_mcus(*b, decode_mode, raw=True), bufs)
        del bufs
        torch.cuda.empty_cache()
    for m, wire in DEQUANT_GEOMETRIES:
        bufs = _inputs(torch, mode, m, wire, dev)
        measure(dequant_name(m, wire),
                lambda b: dequantize_stage(*b, mode), bufs)
        del bufs
        torch.cuda.empty_cache()
    stages = {"idct": lambda d: idct_stage(d, mode),
              "color": lambda sp: color_stage(sp, mode, raw=True)}
    for stage, m in stage_geometries():
        # The IDCT takes the dequantize stage's output, the colour stage
        # the IDCT's, of the dequantize geometry's int16 inputs.
        bufs = [dequantize_stage(*b, mode)
                for b in _inputs(torch, mode, m, 2, dev)]
        if stage == "color":
            bufs = [idct_stage(d, mode) for d in bufs]
        measure(stage_name(stage, m), stages[stage], bufs)
        del bufs
        torch.cuda.empty_cache()
    for key, scale, m, wire in SCALED_GEOMETRIES:
        scaled_mode = S.mode_for(key)
        bufs = _inputs(torch, scaled_mode, m, wire, dev)
        measure(scaled_name(key, scale, m, wire),
                lambda b: decode_mcus(*b, scaled_mode, raw=True, scale=scale),
                bufs)
        del bufs
        torch.cuda.empty_cache()
    for m, wire in STACKED_GEOMETRIES:
        bufs = _inputs(torch, mode, m, wire, dev)
        measure(stacked_name(m, wire), lambda b: rgb_stacked(*b, mode), bufs)
        del bufs
        torch.cuda.empty_cache()
    for m, wire in TRUEREZ_GEOMETRIES:
        bufs = _inputs(torch, mode, m, wire, dev)
        measure(truerez_name(m, wire), lambda b: rgb_truerez(*b, mode), bufs)
        del bufs
        torch.cuda.empty_cache()
    fns = mxu_idct_ab.variant_fns()
    for variant, m in MXU_GEOMETRIES:
        count = max(2, rotation_count(m * mode.g * 64 * 2, dev))
        bufs = [torch.from_numpy(d).to(dev)
                for d in mxu_idct_ab.make_inputs(count, m)]
        measure(mxu_name(variant, m), fns[variant][0], bufs)
        del bufs
        torch.cuda.empty_cache()
    for m, wire in MEMFLOOR_GEOMETRIES:
        bufs = _inputs(torch, mode, m, wire, dev)
        measure(memfloor_name(m, wire), lambda b: memfloor(*b, mode), bufs)
        del bufs
        torch.cuda.empty_cache()
    data, lut = (torch.from_numpy(a).to(dev) for a in vlc_bench.make_inputs())
    seeds = [torch.tensor([i], dtype=torch.int32, device=dev)
             for i in range(VLC_SEEDS)]
    measure(VLC_GEOMETRY, lambda s: vlc(s, data, lut), seeds, digest_all=True)
    return {"card": torch.cuda.get_device_name(0), "results": results}


def verdict(runs: Sequence[dict]) -> Dict[str, dict]:
    """Per geometry, from the four runs in ``ORDER``: the sides' medians,
    the larger spread between the two runs of one side, the speedup
    (parent / change) and whether the change is faster or slower beyond
    that band."""
    table = {}
    for name in runs[0]["results"]:
        us = {"parent": [], "change": []}
        for who, run in zip(ORDER, runs):
            us[who].append(run["results"][name]["us"])
        p, c = us["parent"], us["change"]
        band = max(max(p) - min(p), max(c) - min(c))
        if min(p) - max(c) > band:
            word = "faster"
        elif min(c) - max(p) > band:
            word = "slower"
        else:
            word = "within band"
        table[name] = {"parent_us": p, "change_us": c, "band_us": band,
                       "speedup": statistics.mean(p) / statistics.mean(c),
                       "verdict": word}
    return table


def report_lines(table: Dict[str, dict], card: str) -> List[str]:
    """A line per geometry of ``verdict``'s table; a stacked, truerez or
    memory-floor geometry's line ends with ``rgb_kernel``'s mean times on
    the same geometry."""
    beside = {name(m, w): geometry_name("rgb", "4:2:0", m, w)
              for name, geometries in ((stacked_name, STACKED_GEOMETRIES),
                                       (truerez_name, TRUEREZ_GEOMETRIES),
                                       (memfloor_name, MEMFLOOR_GEOMETRIES))
              for m, w in geometries}
    lines = []
    for name, row in table.items():
        rgb = table.get(beside.get(name))
        note = (f"; rgb_kernel in the same runs: parent "
                f"{statistics.mean(rgb['parent_us']):.2f}, change "
                f"{statistics.mean(rgb['change_us']):.2f} us" if rgb else "")
        lines.append(f"{name}: parent {row['parent_us'][0]:.2f}, "
                     f"{row['parent_us'][1]:.2f} us; change "
                     f"{row['change_us'][0]:.2f}, {row['change_us'][1]:.2f} "
                     f"us; band {row['band_us']:.2f} us; "
                     f"{row['speedup']:.3f}x, {row['verdict']}{note} | "
                     f"{card}")
    return lines


def digests_agree(runs: Sequence[dict]) -> List[str]:
    """The geometries whose output bytes differ between runs."""
    return [name for name in runs[0]["results"]
            if len({r["results"][name]["sha1"] for r in runs}) != 1]


def _run_side(root: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--root", root], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"side {root} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", help="time this checkout's kernels")
    group.add_argument("--parent", help="A/B against this checkout")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("decode_ab needs a CUDA card", file=sys.stderr)
        return 2
    if args.root:
        print(json.dumps(side()))
        return 0
    roots = {"parent": os.path.abspath(args.parent), "change": HERE_ROOT}
    runs = [_run_side(roots[who]) for who in ORDER]
    bad = digests_agree(runs)
    if bad:
        print(f"outputs differ between runs: {bad}", file=sys.stderr)
        return 1
    table = verdict(runs)
    for line in report_lines(table, runs[0]["card"]):
        print(line, flush=True)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
