#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (nvcc under
PATH or /usr/local/cuda/bin, g++ for the host library).  Uses torch, numpy
and ``pim_jpeg_decoder_tpu_torch`` only (its own host layer, oracle and
encoder; nothing of ``pim_jpeg_decoder_tpu``).  Phases:

1. device: card name and power limit, build of ``csrc/*.cu``, native host
   library present;
2. each kernel against its plain PyTorch version on the card, byte for byte
   (tolerance 0: the decode spec is integer, and the epilogue rounds the
   same float32 values once): the full-scale RGB, YCbCr and scaled RGB
   (scale 2/4/8) decode kernels and the dequantize, IDCT and colour stage
   kernels for every sampling mode, both wires, at M=16,384 and at an odd
   M=1,001 with extreme blocks (Q=16 with one 16-bit quantizer row); the
   stages composed equal to the fused RGB kernel; the RGB kernels also
   against the NumPy oracle (full and scaled) on encoded images; the raster
   epilogue for every mode and scale, u8/f32/bf16/f16, full and cropped,
   and where its two forms branch (``epilogue_band_cases``: MCU columns
   of ``BAND_GWS``, outputs 1 to the full grid wide, B = 1, crop origins
   at and past every edge, the B=256 ImageNet geometry in all four types,
   the loader cell's B=256 256x256 bfloat16 batch in the row form, the
   crop cell's two groups written through destination rows into one
   B=256 output);
   the dequantize stage at the M values of ``DEQUANT_MS`` with wire-limit
   coefficients and out-of-range ``qidx`` (``dequant_cases``);
   the memory-floor, chroma-truerez and stacked kernels
   (``csrc/kernel_opt.cu``) for the colour modes, both wires, both Ms, the
   last two also equal to the fused RGB kernel; the tensor-core IDCT
   kernels (``csrc/mxu_idct.cu``: mxu2pass with pieces 1 and 2, mxu64) at
   M=16,384 and 1,001 of int16 in [-2048, 2048) within ``MXU_TOLERANCE``
   of their float32 plain versions (TF32 operands; pieces 2 bit-exact),
   and mxu2pass and mxu64 where their tiles and grids branch
   (``mxu_edge_cases``: mxu2pass at 1, 7, 8, 9 and 17 blocks, mxu64 at 1,
   15, 16, 17, 63, 64 and 65, each with a last CUDA block holding a
   ragged and idle warps, a ``deq[5:]`` slice, M=196,608);
   the VLC kernel (``csrc/vlc.cu``) on the tool's bitstream with five
   tables (``vlc_tables``: the tool's, all-zero, zero-advance entries,
   mostly 1-bit, long codes) at five seeds, tolerance 0, and no chunk exit
   off the next chunk's entry offsets (the kernel's counter); the tile
   kernels (RGB, YCbCr, scaled RGB at scale 2/4/8, and in the colour modes
   the stacked and truerez kernels, also equal to the RGB kernel, and the
   memory floor) in every
   mode, both wires, at M values around their 32-MCU tile and 16-byte stores
   (``TILE_MS`` and ``EDGE_MS``: 1, 15, 17, 31, 32, 33, 65, 196,608) and on
   a ``coeffs[5:]`` slice of 1,027 MCUs, with extreme blocks and
   out-of-range ``qidx`` entries (a zero quantizer row), tolerance 0; the
   IDCT and colour stage kernels where their tiles and store forms branch
   (``stage_tile_cases``: every mode, both wires, M of ``STAGE_MS`` and a
   ``[5:]`` slice; the colour stage on the IDCT output, the dequantized
   extremes and full-range int16), tolerance 0, staged == fused;
3. the main paths, each with the launch counts set to 0 just before it and
   read just after: ``cli.main`` on an ImageNet-val-like corpus (every BMP
   equal to the oracle raster, the same BMPs with ``--transport rgb`` and
   with banded launches, per-file failures for a corrupt and a missing
   file) and with ``--scale 2`` (every BMP equal to the scaled oracle); the
   device profile, ``cli.main --device-profile measure --profile DIR`` (the
   stage kernels launched, the phase lines printed, a trace naming the
   decode kernels written) and again with the default ``cached`` (the same
   phase lines, no stage kernel launched); the device-resident batch path,
   ``iter_decode_batches`` over 4 batches of B=256 500x375 4:2:0 images at
   scale 1 and 2, as uint8 and as bfloat16 normalised with the ImageNet
   statistics, every batch equal to the oracle rasters;
   ``decode_batch_crops`` of 224x224 random crops from 4:2:0 images of
   three sizes, equal to slices of the oracle rasters; the crop cell's
   batches (B=256 224x224 crops, 1 in 8 at 4:4:4 among 4:2:0, through
   ``iter_decode_batch_crops(mixed_sizes=True)`` in bfloat16 with the
   ImageNet statistics and ``decode_batch_crops`` in uint8), equal to the
   oracle slices, with two decode and two epilogue launches a batch and
   none in the row form; every path that
   takes a device list over two shards of the one card (``[3 multi]``:
   the engine on both transports, the single-image APIs, the B=256
   batches, the crop batch and a mixed-mode crop batch, each equal to the
   oracle or to one device,
   every shard launching), with the engine's MP/s and the batch path's
   images/s against one device, the host concatenation of two shards
   against their D2H, and two gloo ranks of ``tools.scaling_bench``; the
   port's differential fuzz campaign (``[3 fuzz]``: ``tools.fuzz.run`` in
   this process on the card, seed ``FUZZ_SEED``, ``FUZZ_ITERATIONS``
   iterations of random engine geometries, batch, stream, device-list,
   crop and table checks: no mismatch, every check drawn, the decode
   kernels and the epilogue launched); the host-decode tools on this
   machine's host (``[3 host]``: ``tools.entropy_bench``, with ``--prog``
   and ``tools.prog_profile`` where PIL imports, a null ``tools.src_ab``
   within ``NULL_AB_LIMIT``, ``tools.asan_drive`` under ASan and UBSan,
   ``tools.pgo_ab``); the
   experiment tool ``tools.kernel_opt`` (every variant bit-exact, each of
   its three kernels launched); the tools ``tools.mxu_idct_ab`` (the
   butterfly and the three tensor-core variants, each within its
   tolerance) and ``tools.vlc_bench`` (exact), their kernels launched (the
   IDCT tool in two runs, mxu2pass4 alone in the second, so that pieces 2
   has a launch count of its own);
4. kernel and plain-version times with CUDA events
   (``utils/devbench.seconds_per_launch``, 10 rotating inputs past the 50
   MB L2; median with min and max), each kernel's bound (the larger of its
   bytes over 3.35 TB/s and its operations over their peak rate) and, for
   the tensor-core IDCT, ``torch.matmul`` yardsticks with TF32 allowed;
   the IDCT A/B (butterfly, mxu2pass, mxu2pass4, mxu64) at the tool's
   geometry and the VLC kernel beside a 4-byte ``fill_`` launch (the
   card's floor for any launch); the ``tools/stage_profile`` record
   (staged sum, fused time, fusion ratio), the ``tools.kernel_opt`` record
   and rgb_kernel's GB/s as a share of the floor's (``memfloor_kernel``:
   the tiled decode kernels' pattern, a 32-MCU tile copied into shared
   memory and 16-byte row stores, with the decode taken out, so a share
   over 100% is printed as a finding; int16 and int8
   wire, from that one run) and over the tool's launch sizes
   (``kernel_opt.sweep``, 2,048 to 196,608 MCUs), the engine's end-to-end
   MP/s on the corpus, the batch path's images/s and MP/s, and the device
   busy share of one traced run of each; ``rgb_kernel`` and
   ``ycbcr_kernel`` in every mode at M=16,384 (int8) and at 4:2:0
   M=196,608 (both wires) against their bounds, and each one's registers
   (``nvcc.log``), dynamic shared memory, blocks an SM (occupancy
   calculator) and SASS instructions an MCU (``cuobjdump -sass``); the
   raster epilogue at the B=256 batch's two geometries and as 224x224
   crops of it, each against its bound; the scaled RGB kernel at 4:2:0
   scale 2, 4 and 8 and the stacked kernel beside ``rgb_kernel`` at
   M=16,384 and 196,608 on both wires, each against its bound (the scaled
   kernel's counted in the least exact form, the matrix-form count
   beside it); and the registers, shared memory and blocks an SM of the
   epilogue's, the stage kernels', the scaled, stacked and truerez
   kernels', the memory floor's, mxu2pass's and mxu64's instantiations
   (with SASS counts for truerez and the floor at 4:2:0, for mxu2pass and
   for mxu64); the floor and mxu64 also at M=196,608 against their bounds
   (mxu64 beside its TF32 ``torch.matmul`` yardstick).

``python3 chip_smoke.py --cards`` (a machine with two cards or more)
runs only phase 1, each kernel that prepares attributes on every card
against the first card, and ``[3 multi]`` over every card (ranks one a
card): what a one-card machine cannot show.

Any failure exits non-zero.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
the line before it the kernels' JSON record, and the one before that the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 20261016
# Launch-counter name -> (source, the TPU kernel or XLA fusion it replaces).
KERNELS = {
    "rgb": ("pim_jpeg_decoder_tpu_torch/csrc/decode_kernel.cu",
            "pim_jpeg_decoder_tpu/ops/decode_kernel.py:178"),
    "ycbcr": ("pim_jpeg_decoder_tpu_torch/csrc/decode_kernel.cu",
              "pim_jpeg_decoder_tpu/ops/decode_kernel.py:296"),
    "rgb_scaled": ("pim_jpeg_decoder_tpu_torch/csrc/decode_kernel.cu",
                   "pim_jpeg_decoder_tpu/ops/decode_kernel.py:268"),
    "raster": ("pim_jpeg_decoder_tpu_torch/csrc/raster_epilogue.cu",
               "pim_jpeg_decoder_tpu/models/input_pipeline.py:93"),
    "dequant": ("pim_jpeg_decoder_tpu_torch/csrc/stage_kernels.cu",
                "pim_jpeg_decoder_tpu/ops/stage_kernels.py:37"),
    "idct": ("pim_jpeg_decoder_tpu_torch/csrc/stage_kernels.cu",
             "pim_jpeg_decoder_tpu/ops/stage_kernels.py:52"),
    "color": ("pim_jpeg_decoder_tpu_torch/csrc/stage_kernels.cu",
              "pim_jpeg_decoder_tpu/ops/stage_kernels.py:61"),
    "memfloor": ("pim_jpeg_decoder_tpu_torch/csrc/kernel_opt.cu",
                 "tools/kernel_opt.py:68"),
    "truerez": ("pim_jpeg_decoder_tpu_torch/csrc/kernel_opt.cu",
                "tools/kernel_opt.py:92"),
    "stacked": ("pim_jpeg_decoder_tpu_torch/csrc/kernel_opt.cu",
                "tools/kernel_opt.py:141"),
    "mxu2pass": ("pim_jpeg_decoder_tpu_torch/csrc/mxu_idct.cu",
                 "tools/mxu_idct_ab.py:58"),
    # mxu2pass with pieces=2: its own instantiation (mxu2pass_kernel<2>),
    # launched through the same wrapper and counter.
    "mxu2pass4": ("pim_jpeg_decoder_tpu_torch/csrc/mxu_idct.cu",
                  "tools/mxu_idct_ab.py:58"),
    "mxu64": ("pim_jpeg_decoder_tpu_torch/csrc/mxu_idct.cu",
              "tools/mxu_idct_ab.py:104"),
    "vlc": ("pim_jpeg_decoder_tpu_torch/csrc/vlc.cu",
            "tools/tpu_vlc_bench.py:38"),
}
JSON_NAMES = {"raster": "raster_epilogue",
              "raster_scale2": "raster_epilogue (scale 2 -> bfloat16)",
              "raster_crops": "raster_epilogue (224x224 crops -> bfloat16)",
              "dequant": "stage_dequantize",
              "idct": "stage_idct", "color": "stage_color",
              "memfloor": "kernel_opt_memfloor",
              "truerez": "kernel_opt_chroma_truerez",
              "stacked": "kernel_opt_stacked",
              "mxu2pass": "mxu_idct_2pass",
              "mxu2pass4": "mxu_idct_2pass4 (pieces 2)",
              "mxu64": "mxu_idct_64",
              "vlc": "vlc_symbol_loop",
              "memfloor_196608": "kernel_opt_memfloor (M=196608 int16)",
              "mxu64_196608": "mxu_idct_64 (M=196608)"}
STAGES = ("dequant", "idct", "color")
KERNEL_OPT_COUNTERS = ("memfloor", "truerez", "stacked")
IMAGENET_NORM = dict(mean=(123.675, 116.28, 103.53),
                     std=(58.395, 57.12, 57.375))
# TF32 tensor-core IDCT against its float32 plain version: name -> (largest
# |difference|, largest share of samples that differ).  TF32 keeps 11
# significant bits: mxu2pass rounds its 12-bit basis entries, mxu64 its
# 24-bit ones; mxu2pass4's 8-bit pieces are exact, so it is bit-exact.
MXU_TOLERANCE = {"mxu2pass": (2, 0.04), "mxu2pass4": (0, 0.0),
                 "mxu64": (2, 0.03)}

# --- the least time the card could take (bound_ms) ----------------------------
# Published H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 bytes/s, TF32
# and float32 (outside the tensor cores) FLOP/s.  The sheet gives no
# integer rate.  Its 67 TFLOP/s count an FMA as two operations on the 128
# lanes an SM issues to each clock (4 schedulers, one warp instruction
# each); no instruction mix issues more, so integer operations peak at half
# of it (integer multiplies and adds share that issue rate).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12
INT32_OPS = FP32_FLOPS / 2
# Integer operations of the decode spec, counted from its code: one
# idct_1d pass is 56 (16 even part, 24 odd part, 8 adds and 8 shifts out),
# a block 16 passes and 2 x 64 clamps; dequantize a multiply and 2 clamps a
# coefficient; BT.601 (bt601_planes) 21 an RGB pixel (level shift 1; R, B:
# multiply, bias, shift, add, 2 clamps; G: 2 multiplies, 2 adds, shift,
# add, 2 clamps).
IDCT_BLOCK_OPS = 16 * 56 + 2 * 64
DEQUANT_BLOCK_OPS = 3 * 64
COLOR_PIXEL_OPS = 21
# Integer operations one VLC symbol needs at least: the window 2 (word
# index; one funnel shift of the two words, which takes the shift mod 32 and
# gives the first word at shift 0), the probe 1 (top 8 bits), the entry's
# fields 2 (advance, value) once the table is folded to advance | value << 8
# (256 entries once, against 8,639 symbols), the sums 3 (acc, position,
# nsym), the loop's test 1.  The loads are the bytes' share.
VLC_SYMBOL_OPS = 9


def reduced_pass_ops(n: int) -> int:
    """Integer operations of the sums of one n-point reduced pass in its
    least exact form, the even/odd split of the rounded basis
    (``rgb_scaled_kernel``'s ``reduced_sums``): the n/2-point pass of the
    even inputs, (n/2)^2 multiplies and n/2 (n/2 - 1) adds for the odd
    sums, n adds to combine them; one multiply at n = 1."""
    if n == 1:
        return 1
    h = n // 2
    return reduced_pass_ops(h) + h * h + h * (h - 1) + n


def reduced_idct_ops(ny: int, nx: int) -> int:
    """Integer operations of one reduced IDCT to ny x nx samples in its
    least exact form: each pass's sums (``reduced_pass_ops``) and a descale
    (2) an output, then 2 clamps a sample."""
    return (nx * (reduced_pass_ops(ny) + 2 * ny)
            + ny * (reduced_pass_ops(nx) + 2 * nx) + 2 * ny * nx)


def matrix_idct_ops(ny: int, nx: int) -> int:
    """Integer operations of the same IDCT in the matrix form
    (decode_kernel._reduced_pass): each output a sum of products over its
    pass (2n - 1) and a descale (2), then 2 clamps a sample."""
    return nx * ny * (2 * ny + 1) + ny * nx * (2 * nx + 1) + 2 * ny * nx


def scaled_mcu_counts(mode, scale: int, wire_bytes: int,
                      matrix_form: bool = False):
    """``(bytes, operations)`` an MCU of the scaled decode.  Bytes: the
    32-byte sectors that hold the coefficients the reduced IDCTs read
    (rows 0..n-1 of a luma block, 0..v*n-1 of a chroma block), qidx and the
    output.  Operations: a dequantize (3) of each coefficient read, the
    reduced IDCTs in their least exact form and BT.601 (21 a pixel; gray a
    level shift).  ``matrix_form``: the count kept beside it, the whole
    wire read, all 64 coefficients dequantized and the IDCTs in the matrix
    form."""
    n = 8 // scale
    gy = mode.luma_slots
    cy, cx = mode.v * n, mode.h * n
    chroma = 2 if mode.ncomp == 3 else 0

    def sectors(rows: int) -> int:
        return -(-rows * 8 * wire_bytes // 32) * 32

    if matrix_form:
        wire = mode.g * 64 * wire_bytes
        idct = gy * matrix_idct_ops(n, n) + chroma * matrix_idct_ops(cy, cx)
        deq = mode.g * DEQUANT_BLOCK_OPS
    else:
        wire = gy * sectors(n) + chroma * sectors(cy)
        idct = gy * reduced_idct_ops(n, n) + chroma * reduced_idct_ops(cy, cx)
        deq = 3 * (gy * n * n + chroma * cy * cx)
    colour = gy * n * n * (COLOR_PIXEL_OPS if chroma else 1)
    return wire + 3 * gy * n * n + 4, idct + deq + colour


def scaled_bound(mode, scale: int, m: int, wire_bytes: int, q: int = 16,
                 matrix_form: bool = False):
    """The bound of one scaled decode launch of ``m`` MCUs with a Q-row
    pool (read once): ``scaled_mcu_counts`` times ``m``."""
    nbytes, ops = scaled_mcu_counts(mode, scale, wire_bytes, matrix_form)
    return bound(m * nbytes + q * mode.g * 64 * 4, m * ops)


def bound(nbytes: float, ops: float = 0.0, rate: float = INT32_OPS):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory
    rate and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


def timing(kernel_band, plain_band, bound_pair, library_ms=None) -> dict:
    """The kernels-line numbers of one kernel from this run."""
    return {"ms": kernel_band[0], "plain_ms": plain_band[0],
            "bound_ms": bound_pair[0], "bound_by": bound_pair[1],
            "library_ms": library_ms}


def bound_note(bound_pair) -> str:
    return f"bound {bound_pair[0] * 1e3:.2f} us ({bound_pair[1]})"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# --- phase 1 -----------------------------------------------------------------

def phase_device(torch, card: str) -> None:
    from pim_jpeg_decoder_tpu_torch.native import native_available
    from pim_jpeg_decoder_tpu_torch.ops import _build

    print(f"[1 device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card}"
          f" | torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.monotonic()
    path = _build.build()
    _build.load()
    build_s = time.monotonic() - t0
    with open(os.path.join(os.path.dirname(path), "nvcc.log")) as f:
        log = f.read()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    print(f"[1 device] kernels built in {build_s:.1f} s ({path}); ptxas: "
          f"{len(regs)} kernels, max {max(regs, default=0)} registers, "
          f"max {max(spills, default=0)} bytes spill stores", flush=True)
    if not native_available():
        fail("native C++ host library unavailable (g++ missing?)")


# --- phase 2 -----------------------------------------------------------------

def synthetic_batch(mode, m: int, wire, rng, extreme: bool):
    info = np.iinfo(wire)
    coeffs = np.clip(np.round(rng.laplace(0.0, 6.0, (m, mode.g, 64))),
                     info.min, info.max).astype(wire)
    q = 16
    qpool = rng.integers(1, 100, (q, mode.g, 64)).astype(np.float32)
    qpool[q - 1] = rng.integers(1, 65536, (mode.g, 64))
    qidx = rng.integers(0, q, m).astype(np.int32)
    if extreme:
        coeffs[: m // 4] = rng.integers(info.min, int(info.max) + 1,
                                        (m // 4, mode.g, 64))
        coeffs[0] = info.max
        coeffs[1] = info.min
        coeffs[2, :, ::2] = info.max
        coeffs[2, :, 1::2] = info.min
        qidx[: m // 4] = q - 1
    return coeffs, qidx, qpool


def mcu_raster(mode, raw: np.ndarray) -> np.ndarray:
    """Kernel RGB ``[3, gy, 64, M]`` -> per-MCU ``[M, v*8, h*8, 3]``."""
    m = raw.shape[-1]
    out = np.empty((m, mode.mcu_px_h, mode.mcu_px_w, 3), np.uint8)
    for s in range(mode.luma_slots):
        qv, qh = mode.luma_slot_pos(s)
        # Slot pixels are column-major: index = px*8 + py.
        out[:, qv * 8:(qv + 1) * 8, qh * 8:(qh + 1) * 8, :] = (
            raw[:, s].reshape(3, 8, 8, m).transpose(3, 2, 1, 0))
    return out


def scaled_oracle(data: bytes, scale: int) -> np.ndarray:
    """``oracle.decoder.decode_scaled_oracle`` with the native entropy
    decoder in place of the pure-Python one (same coefficients, faster)."""
    from unittest import mock

    from pim_jpeg_decoder_tpu_torch.native import decode_scan_native
    from pim_jpeg_decoder_tpu_torch.oracle import decoder

    with mock.patch.object(decoder, "decode_scan", decode_scan_native):
        return decoder.decode_scaled_oracle(data, scale)


def phase_kernels(torch, dev, oracle_images) -> dict:
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.oracle.decoder import mcu_rgb_from_coeffs
    from pim_jpeg_decoder_tpu_torch.models.pipeline import (
        assemble_raster_raw_scaled, build_qpool)
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, decode_mcus_reference,
        qpool_to_device)

    rng = np.random.default_rng(SEED)
    max_err = {name: 0 for name in KERNELS}
    cases = 0
    variants = (("rgb", 1), ("ycbcr", 1), ("rgb_scaled", 2),
                ("rgb_scaled", 4), ("rgb_scaled", 8))
    for key in sorted(S.MODES):
        mode = S.mode_for(key)
        for wire in (np.int16, np.int8):
            for m, extreme in ((16384, False), (1001, True)):
                coeffs, qidx, qpool = synthetic_batch(mode, m, wire, rng,
                                                      extreme)
                x = coeffs_to_device(coeffs, dev)
                qi = torch.from_numpy(qidx).to(dev)
                qp = qpool_to_device(qpool, dev)
                for name, scale in variants:
                    kw = dict(raw=True, ycbcr=name == "ycbcr", scale=scale)
                    got = decode_mcus(x, qi, qp, mode, **kw)
                    want = decode_mcus_reference(x, qi, qp, mode, **kw)
                    torch.cuda.synchronize()
                    err = int((got.int() - want.int()).abs().max())
                    max_err[name] = max(max_err[name], err)
                    if got.shape != want.shape or err:
                        fail(f"{name} kernel != plain version: {mode.name} "
                             f"{np.dtype(wire).name} M={m} scale {scale} "
                             f"max|err|={err}")
                    cases += 1
                cases += stage_cases(torch, mode, x, qi, qp, max_err,
                                     f"{np.dtype(wire).name} M={m}")
                if mode.ncomp == 3:
                    cases += variant_cases(torch, mode, x, qi, qp, max_err,
                                           f"{np.dtype(wire).name} M={m}")
    n_mcus = 0
    for header, coeffs, data in oracle_images:
        mode = S.mode_for(header.mode_key)
        x = coeffs_to_device(coeffs, dev)
        qi = torch.zeros(header.num_mcus, dtype=torch.int32, device=dev)
        qp = qpool_to_device(build_qpool([header], mode), dev)
        raw = decode_mcus(x, qi, qp, mode, raw=True).cpu().numpy()
        if not np.array_equal(mcu_raster(mode, raw),
                              mcu_rgb_from_coeffs(header, coeffs)):
            fail(f"rgb kernel != oracle.mcu_rgb_from_coeffs on {mode.name}")
        for scale in (2, 4, 8):
            raw = decode_mcus(x, qi, qp, mode, raw=True,
                              scale=scale).cpu().numpy()
            if not np.array_equal(
                    assemble_raster_raw_scaled(header, raw, scale),
                    scaled_oracle(data, scale)):
                fail(f"rgb_scaled kernel != decode_scaled_oracle on "
                     f"{mode.name} at scale {scale}")
        n_mcus += header.num_mcus
    n_tile, tile_note = tile_cases(torch, dev, rng, max_err)
    n_epi = epilogue_cases(torch, dev, rng, max_err)
    n_band, n_rows = epilogue_band_cases(torch, dev, rng)
    n_deq = dequant_cases(torch, dev, rng, max_err)
    n_stage = stage_tile_cases(torch, dev, rng, max_err)
    mxu_line = mxu_cases(torch, dev, rng, max_err)
    vlc_line = vlc_cases(torch, dev, max_err)
    print(f"[2 kernels] {cases} decode, stage and kernel_opt "
          f"kernel-vs-plain cases byte-identical on the card (5 modes x "
          f"i16/i8 x M=16384/1001-with-extremes x rgb/ycbcr/scaled 2,4,8 "
          f"and dequant/idct/color (also on raw int16)/staged==fused, and "
          f"for the 4 colour modes memfloor/truerez/stacked, truerez and "
          f"stacked also == rgb kernel; Q=16; tolerance 0); rgb and "
          f"rgb_scaled "
          f"(2/4/8) == NumPy oracle on {n_mcus} MCUs of "
          f"{len(oracle_images)} encoded images; {n_epi} raster-epilogue "
          f"cases byte-identical (5 modes x scale 1/2/4/8 x u8/f32/bf16/f16 "
          f"x full/cropped)", flush=True)
    print(f"[2 kernels] {n_tile} tile cases byte-identical: {tile_note}",
          flush=True)
    print(f"[2 kernels] {n_band} raster-epilogue band cases byte-identical "
          f"({n_rows} in the row form; gray and 4:2:0 x scale 1/2 x gw="
          f"{list(BAND_GWS)} x out_w 1/5/500/full less one MCU/full x "
          f"u8/f32/bf16/f16 x B=1 "
          f"full / B=6 crops with origins at 0, the far edge, negative, "
          f"past the edge, odd, even; the B=256 ImageNet geometry at scale "
          f"1/2 in all four types; the loader cell's B=256 256x256 scale 1 "
          f"-> bfloat16 CLIP batch, row form); "
          f"{n_deq} dequantize-stage cases byte-identical (5 modes x i16/i8 "
          f"x M={list(DEQUANT_MS)}, wire-limit coefficients against 16-bit "
          f"quantizers, qidx Q and -1; staged == fused in each)", flush=True)
    print(f"[2 kernels] {n_stage} IDCT/colour stage tile cases "
          f"byte-identical (5 modes x i16/i8 x M={list(STAGE_MS)} and a "
          f"[5:] slice of 1,027 MCUs: the IDCT on the dequantized extremes, "
          f"the colour stage on the IDCT output, the dequantized extremes "
          f"and full-range int16 with 32767 and -32768 blocks; staged == "
          f"fused in each)", flush=True)
    print(f"[2 kernels] {mxu_line}", flush=True)
    print(f"[2 kernels] {vlc_line}", flush=True)
    return max_err


# M values around the full-scale kernels' tile (TILE_MCUS = 32, in
# csrc/decode_tile.cuh) and their 16-byte store width.
TILE_MS = (1, 15, 17, 31, 33, 196608)
# M values of the scaled and stacked kernels' cases on the same tile: 1, a
# tile less one, a tile, a tile and one, two tiles and one, a B=256 batch.
EDGE_MS = (1, 31, 32, 33, 65, 196608)


def tile_cases(torch, dev, rng, max_err):
    """The tile kernels against their plain versions, tolerance 0, in
    every mode and on both wires at the M values of ``TILE_MS`` and
    ``EDGE_MS`` (extreme blocks and out-of-range qidx entries -- Q and -1
    -- in each), and on a ``coeffs[5:]`` slice of 1,027 MCUs (input from
    MCU 5, an output whose rows start off the 16-byte grid): rgb_kernel,
    ycbcr_kernel, rgb_scaled_kernel at scale 2, 4 and 8 and, in the colour
    modes, rgb_stacked_kernel and rgb_truerez_kernel, which must also equal
    rgb_kernel, and the memory floor (memfloor_kernel: its 16-byte stores
    where M % 16 == 0, byte stores elsewhere)."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, decode_mcus_reference,
        qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.ops.kernel_variants import KERNELS

    def same(name, got, want, what) -> None:
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err[name] = max(max_err[name], err)
        if got.shape != want.shape or err:
            fail(f"{name} kernel != plain version: {what} (tile case) "
                 f"max|err|={err}")

    cases = 0
    for key in sorted(S.MODES):
        mode = S.mode_for(key)
        for wire in (np.int16, np.int8):
            for m in sorted(set(TILE_MS) | set(EDGE_MS)) + ["slice"]:
                n = 1032 if m == "slice" else m
                what = f"{mode.name} {np.dtype(wire).name} M={m}"
                coeffs, qidx, qpool = synthetic_batch(mode, max(n, 3), wire,
                                                      rng, extreme=True)
                qidx[n // 2] = qpool.shape[0]
                qidx[n - 1] = -1
                x = coeffs_to_device(coeffs[:n], dev)
                qi = torch.from_numpy(qidx[:n]).to(dev)
                if m == "slice":
                    x, qi = x[5:], qi[5:]       # 1,027 MCUs from MCU 5
                qp = qpool_to_device(qpool, dev)
                for name, scale in (("rgb", 1), ("ycbcr", 1),
                                    ("rgb_scaled", 2), ("rgb_scaled", 4),
                                    ("rgb_scaled", 8)):
                    kw = dict(raw=True, ycbcr=name == "ycbcr", scale=scale)
                    same(name, decode_mcus(x, qi, qp, mode, **kw),
                         decode_mcus_reference(x, qi, qp, mode, **kw),
                         f"{what} scale {scale}")
                    cases += 1
                if mode.ncomp == 3:
                    fused = decode_mcus(x, qi, qp, mode, raw=True)
                    for name in ("stacked", "truerez"):
                        kernel, plain = KERNELS[name]
                        got = kernel(x, qi, qp, mode)
                        same(name, got, plain(x, qi, qp, mode), what)
                        if not torch.equal(got, fused):
                            fail(f"{name} kernel != rgb kernel: {what}")
                        cases += 2
                    kernel, plain = KERNELS["memfloor"]
                    same("memfloor", kernel(x, qi, qp, mode),
                         plain(x, qi, qp, mode), what)
                    cases += 1
                del x, qi
    torch.cuda.empty_cache()
    return cases, (f"rgb/ycbcr/scaled 2,4,8 x 5 modes and stacked and "
                   f"truerez (each also == rgb kernel) and memfloor x 4 "
                   f"colour modes x i16/i8 x M="
                   f"{sorted(set(TILE_MS) | set(EDGE_MS))} and a coeffs[5:] "
                   f"slice of 1,027 MCUs, extreme blocks and out-of-range "
                   f"qidx (Q, -1: a zero quantizer row)")


def mxu_cases(torch, dev, rng, max_err) -> str:
    """The tensor-core IDCT kernels against their float32 plain versions
    on the card, every ``pieces``, at M=16,384 and an odd M=1,001 of the
    tool's draw (int16 in [-2048, 2048)), within ``MXU_TOLERANCE``; then
    ``mxu2pass`` (pieces 1 and 2) and ``mxu64`` where their tiles and
    grids branch (``mxu_edge_cases``)."""
    from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab

    fns = mxu_idct_ab.variant_fns()
    notes = []
    for m in (16384, 1001):
        deq = torch.from_numpy(rng.integers(
            -2048, 2048, (m, 6, 64)).astype(np.int16)).to(dev)
        for name in MXU_TOLERANCE:
            kernel, plain = fns[name]
            d = mxu_difference(torch, kernel(deq), plain(deq), name,
                               f"M={m}", max_err)
            notes.append(f"{name} M={m}: max|diff| {d['max_abs_diff']}, "
                         f"share {d['share_diff']:.5f}")
    return ("mxu_idct kernels (TF32) vs float32 plain versions, tool's draw "
            "(tolerance max|diff| <= 2 in <= 4% / 0 / <= 2 in <= 3%): "
            + "; ".join(notes) + "; " + mxu_edge_cases(torch, dev, rng,
                                                       max_err))


def mxu_difference(torch, got, want, name, what, max_err,
                   check_share=True) -> dict:
    """``tools.mxu_idct_ab.difference`` of a kernel's output and its plain
    version's, held to ``MXU_TOLERANCE[name]`` (the share only where
    ``check_share``); the largest difference goes into ``max_err``."""
    from pim_jpeg_decoder_tpu_torch.tools.mxu_idct_ab import difference

    torch.cuda.synchronize()
    tol, share_tol = MXU_TOLERANCE[name]
    d = difference(got, want)
    max_err[name] = max(max_err[name], d["max_abs_diff"])
    if (got.shape != want.shape or d["max_abs_diff"] > tol
            or (check_share and d["share_diff"] > share_tol)):
        fail(f"{name} kernel vs its float32 plain version at {what}: "
             f"max|diff| {d['max_abs_diff']} (at most {tol}), share "
             f"{d['share_diff']:.5f} (at most {share_tol})")
    return d


def mxu_edge_shapes(name: str):
    """``(blocks, shapes)`` of ``mxu_edge_cases`` for one kernel: the block
    counts where its tiles branch (``[n, 1, 64]``) and three CUDA blocks
    and a last one whose first warp is full, whose second is ragged and
    whose others have no blocks; then a ``deq[5:]`` slice of 1,006 MCUs of
    6 blocks and M=196,608 (1,179,648 blocks)."""
    from pim_jpeg_decoder_tpu_torch.ops.mxu_idct import (
        MXU2PASS_TILE, MXU64_PAIR, MXU64_TILE, MXU64_UNITS, MXU64_WARPS,
        TILES_PER_WARP, WARPS_PER_BLOCK)

    if name == "mxu64":
        tile, unit = MXU64_TILE, MXU64_TILE * MXU64_PAIR
        per_warp = unit * MXU64_UNITS
        ragged = 3 * MXU64_WARPS * per_warp + per_warp + unit + tile // 2 + 1
        blocks = (1, tile - 1, tile, tile + 1, per_warp - 1, per_warp,
                  per_warp + 1, ragged)
    else:
        tile = MXU2PASS_TILE
        per_warp = tile * TILES_PER_WARP[1 if name == "mxu2pass" else 2]
        ragged = 3 * WARPS_PER_BLOCK * per_warp + per_warp + tile // 2 + 1
        blocks = (1, tile - 1, tile, tile + 1, 2 * tile + 1, ragged)
    return blocks, [(n, 1, 64) for n in blocks] + ["slice", (196608, 6, 64)]


def mxu_edge_cases(torch, dev, rng, max_err) -> str:
    """``mxu2pass`` with pieces 1 and 2 and ``mxu64`` against their plain
    versions, within ``MXU_TOLERANCE``, where their designs branch
    (``mxu_edge_shapes``: tiles of ``MXU2PASS_TILE`` blocks, one or two a
    warp; ``mxu64``'s MMA tiles of ``MXU64_TILE`` blocks, ``MXU64_PAIR`` a
    unit, ``MXU64_UNITS`` units a warp).  The largest difference is held
    in every case; the share of samples that differ, a rate, over the
    small cases pooled and in the large one (a case of 64 samples can pass
    4% by chance)."""
    from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab

    fns = mxu_idct_ab.variant_fns()
    notes = []
    for name in ("mxu2pass", "mxu2pass4", "mxu64"):
        kernel, plain = fns[name]
        blocks, shapes = mxu_edge_shapes(name)
        differ = total = 0
        for shape in shapes:
            n = (1006, 6, 64) if shape == "slice" else shape
            deq = torch.from_numpy(rng.integers(-2048, 2048, n).astype(
                np.int16)).to(dev)
            if shape == "slice":
                deq = deq[5:]
            large = deq.numel() >= 64 * 98304
            d = mxu_difference(torch, kernel(deq), plain(deq), name,
                               f"{shape} blocks", max_err, check_share=large)
            if not large:
                differ += round(d["share_diff"] * deq.numel())
                total += deq.numel()
            del deq
        share = differ / total
        if share > MXU_TOLERANCE[name][1]:
            fail(f"{name}: {share:.5f} of the small edge cases' samples "
                 f"differ from the plain version (at most "
                 f"{MXU_TOLERANCE[name][1]})")
        notes.append(f"{name} at {len(shapes)} edge shapes (blocks "
                     f"{', '.join(str(n) for n in blocks)}, a [5:] slice, "
                     f"M=196608): max|diff| <= {max_err[name]}, small "
                     f"cases' share {share:.5f}")
    torch.cuda.empty_cache()
    return "; ".join(notes)


def vlc_tables(lut: np.ndarray) -> dict:
    """Name -> table of the VLC cases: the tool's, the all-zero one (every
    entry a fixed point), the tool's with 6 zero-advance entries, one of
    mostly 1-bit advances, one of codes 1-15 and value bits 0-15."""
    rng = np.random.default_rng(SEED)

    def table(code, vbits):
        return (code | vbits << 4
                | rng.integers(0, 256, lut.size) << 8).astype(np.int32)

    zero_advance = lut.copy()
    zero_advance[rng.choice(lut.size, 6, replace=False)] &= ~0xFF
    ones = rng.random(lut.size) < 0.9
    return {"tool": lut, "all_zero": np.zeros_like(lut),
            "zero_advance": zero_advance,
            "one_bit": table(np.where(ones, 1, rng.integers(1, 16, lut.size)),
                             np.where(ones, 0, rng.integers(0, 16, lut.size))),
            "long_codes": table(rng.integers(1, 16, lut.size),
                                rng.integers(0, 16, lut.size))}


def vlc_cases(torch, dev, max_err) -> str:
    """The VLC kernel against its plain version on the card: the tool's
    bitstream with each table of ``vlc_tables`` at five seeds, [acc, nsym,
    bitpos] identical; no chunk exit off the next chunk's entry offsets."""
    from pim_jpeg_decoder_tpu_torch.ops.vlc import (exit_violations, vlc,
                                                    vlc_reference)
    from pim_jpeg_decoder_tpu_torch.tools.vlc_bench import make_inputs

    data, lut = make_inputs()
    d_data = torch.from_numpy(data).to(dev)
    before = exit_violations(dev)
    outs = {}
    for name, table in vlc_tables(lut).items():
        d_lut = torch.from_numpy(table).to(dev)
        for seed in range(5):
            s = torch.tensor([seed], dtype=torch.int32, device=dev)
            got, want = vlc(s, d_data, d_lut), vlc_reference(s, d_data, d_lut)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err["vlc"] = max(max_err["vlc"], err)
            if err:
                fail(f"vlc kernel {got.tolist()} != plain version "
                     f"{want.tolist()} at seed {seed}, table {name}")
            outs.setdefault(name, []).append(got.tolist())
    violations = exit_violations(dev) - before
    if violations:
        fail(f"vlc kernel: {violations} chunk exits off the next chunk's "
             f"entry offsets")
    return (f"vlc kernel == plain version on 5 tables x seeds 0-4 "
            f"(tolerance 0), 0 chunk exits off the entry offsets: [acc, "
            f"nsym, bitpos] "
            + "; ".join(f"{n} {o[:2]}" for n, o in outs.items()))


def stage_cases(torch, mode, x, qi, qp, max_err, what: str) -> int:
    """The three stage kernels against their plain versions on one batch
    (the colour stage also on the dequantized int16, whose extremes wrap
    the BT.601 products), and the three composed against the fused RGB
    kernel."""
    from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as SK
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import decode_mcus

    def same(name, got, want) -> None:
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err[name] = max(max_err[name], err)
        if got.shape != want.shape or err:
            fail(f"{name} stage kernel != plain version: {mode.name} {what}"
                 f" max|err|={err}")

    deq = SK.dequantize_stage(x, qi, qp, mode)
    same("dequant", deq, SK.dequantize_stage_reference(x, qi, qp))
    spat = SK.idct_stage(deq, mode)
    same("idct", spat, SK.idct_stage_reference(deq))
    for src in (spat, deq):
        same("color", SK.color_stage(src, mode, raw=True),
             SK.color_stage_reference(src, mode, raw=True))
    staged = SK.decode_mcus_staged(x, qi, qp, mode)
    fused = decode_mcus(x, qi, qp, mode)
    torch.cuda.synchronize()
    if not torch.equal(staged, fused):
        fail(f"decode_mcus_staged != decode_mcus on the card: {mode.name} "
             f"{what}")
    return 5


def variant_cases(torch, mode, x, qi, qp, max_err, what: str) -> int:
    """The three kernels of ``csrc/kernel_opt.cu`` against their plain
    versions on one batch, and the two decode variants against the fused
    RGB kernel."""
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import decode_mcus
    from pim_jpeg_decoder_tpu_torch.ops.kernel_variants import KERNELS

    fused = decode_mcus(x, qi, qp, mode, raw=True)
    for name in KERNEL_OPT_COUNTERS:
        kernel, plain = KERNELS[name]
        got = kernel(x, qi, qp, mode)
        want = plain(x, qi, qp, mode)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err[name] = max(max_err[name], err)
        if got.shape != want.shape or err:
            fail(f"{name} kernel != plain version: {mode.name} {what} "
                 f"max|err|={err}")
        if name != "memfloor" and not torch.equal(got, fused):
            fail(f"{name} kernel != rgb kernel: {mode.name} {what}")
    return 5


def epilogue_cases(torch, dev, rng, max_err) -> int:
    """raster_epilogue against its plain version: B=5 images of 13x17
    MCUs (the last MCU row and column cut by the output size), and crops
    with random origins, some out of range (clamped as dynamic_slice
    clamps), also written through destination rows (shuffled, one of
    them outside) into a shared output of 7 images filled beforehand;
    then the crop cell's batch (:func:`crop_cell_epilogue_case`)."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _norm_static
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        raster_epilogue, raster_epilogue_reference)

    b, gh, gw = 5, 13, 17
    cases = 0
    for key in sorted(S.MODES):
        mode = S.mode_for(key)
        for scale in (1, 2, 4, 8):
            n = 8 // scale
            raw = torch.from_numpy(rng.integers(
                0, 256, (3, mode.luma_slots, n * n, b * gh * gw + 3),
                dtype=np.uint8)).to(dev)
            grid_h, grid_w = gh * mode.v * n, gw * mode.h * n
            crop_h, crop_w = grid_h // 2 + 1, grid_w // 3 + 1
            offsets = [torch.from_numpy(rng.integers(
                -2, g - c + 3, b).astype(np.int32)).to(dev)
                for g, c in ((grid_h, crop_h), (grid_w, crop_w))]
            for dtype in (None, torch.float32, torch.bfloat16,
                          torch.float16):
                norm = (_norm_static(dtype, **IMAGENET_NORM) if dtype
                        else None)
                for args in ((grid_h - 3, grid_w - 5),
                             (crop_h, crop_w, *offsets)):
                    got = raster_epilogue(raw, mode, scale, b, gh, gw, *args,
                                          norm=norm)
                    want = raster_epilogue_reference(raw, mode, scale, b, gh,
                                                     gw, *args, norm=norm)
                    torch.cuda.synchronize()
                    same = got.shape == want.shape and torch.equal(got, want)
                    if not same:
                        err = float((got.float() - want.float()).abs().max())
                        fail(f"raster epilogue != plain version: "
                             f"{mode.name} scale {scale} {dtype} "
                             f"{'crop' if len(args) > 2 else 'full'} "
                             f"max|err|={err}")
                    cases += 1
                rows = torch.from_numpy(np.append(
                    rng.permutation(7)[:b - 1], -1).astype(np.int32)).to(dev)
                fill = torch.full((7, crop_h, crop_w, 3), 77,
                                  dtype=dtype or torch.uint8, device=dev)
                got = raster_epilogue(raw, mode, scale, b, gh, gw, crop_h,
                                      crop_w, *offsets, norm=norm, rows=rows,
                                      out=fill.clone())
                want = raster_epilogue_reference(
                    raw, mode, scale, b, gh, gw, crop_h, crop_w, *offsets,
                    norm=norm, rows=rows, out=fill.clone())
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"raster epilogue with destination rows != plain "
                         f"version: {mode.name} scale {scale} {dtype}")
                cases += 1
    return cases + crop_cell_epilogue_case(torch, dev, rng)


# The batch of perfbench's loader-imagenet-crops cell: 224x224 crops, 224
# images of 4:2:0 on 15x15-MCU sub-grids and 32 of 4:4:4 on 29x29, in
# bfloat16 with the ImageNet statistics (M a multiple of 16 in both
# groups); the split the cell mostly draws (M off the 16-byte grid in
# both) is tools/decode_ab.CROP_CELL_GEOMETRIES.
CROP_CELL = (((2, 2, 3), 224, 15), ((1, 1, 3), 32, 29))


def crop_cell_epilogue_case(torch, dev, rng) -> int:
    """raster_epilogue against its plain version at the crop cell's two
    geometries, in two splits of the batch (``CROP_CELL`` and the cell's
    usual one, ``CROP_CELL_GEOMETRIES``, with M = B * g * g unpadded), each
    group written through its destination rows (a shuffle of 0..255) into
    one output of 256 images, origins drawn over each sub-grid's slack and,
    for every eighth image and the last, at its far edge, so that the last
    image's last band reads the input's final granule.  Every launch must
    count as shifted (``raster_shifted``); prints the blocks an SM and the
    band's shared memory at each geometry's row width."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _norm_static
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        band_row_bytes, launch_counts, raster_epilogue,
        raster_epilogue_reference, raster_occupancy)
    from pim_jpeg_decoder_tpu_torch.tools.decode_ab import (
        CROP_CELL_BATCH, CROP_CELL_GEOMETRIES)

    norm = _norm_static(torch.bfloat16, **IMAGENET_NORM)
    cases = 0
    for split in (CROP_CELL, CROP_CELL_GEOMETRIES):
        batch = sum(b for _, b, _ in split)
        assert batch == CROP_CELL_BATCH
        got = torch.full((batch, 224, 224, 3), 77, dtype=torch.bfloat16,
                         device=dev)
        want = got.clone()
        rows = rng.permutation(batch).astype(np.int32)
        at = 0
        for key, b, g in split:
            mode = S.mode_for(key)
            raw = torch.from_numpy(rng.integers(
                0, 256, (3, mode.luma_slots, 64, b * g * g),
                dtype=np.uint8)).to(dev)
            origins = []
            for f in (mode.v, mode.h):
                far = g * 8 * f - 224
                o = rng.integers(0, far + 1, b).astype(np.int32)
                o[::8], o[-1] = far, far
                origins.append(torch.from_numpy(o).to(dev))
            dst = torch.from_numpy(rows[at:at + b]).to(dev)
            at += b
            before = launch_counts()["raster_shifted"]
            got = raster_epilogue(raw, mode, 1, b, g, g, 224, 224, *origins,
                                  norm=norm, rows=dst, out=got)
            if launch_counts()["raster_shifted"] != before + 1:
                fail(f"the crop cell's {mode.name} launch (B={b} on {g}x{g}"
                     f") did not count as shifted")
            want = raster_epilogue_reference(raw, mode, 1, b, g, g, 224, 224,
                                              *origins, norm=norm, rows=dst,
                                              out=want)
            if split is CROP_CELL_GEOMETRIES:
                row_bytes = band_row_bytes(g, True)
                blocks, smem = raster_occupancy(mode, 1, torch.bfloat16,
                                                row_bytes=row_bytes)
                print(f"[2 kernels] crop cell epilogue {mode.name} B={b} on "
                      f"{g}x{g} MCUs (M % 16 = {b * g * g % 16}): "
                      f"{row_bytes}-byte band rows, {smem} B dynamic shared "
                      f"memory, {blocks} blocks/SM", flush=True)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            groups = ", ".join(f"{S.mode_for(k).name} B={b} {g}x{g}"
                               for k, b, g in split)
            fail(f"raster epilogue at the crop cell's geometries ({groups}, "
                 f"rows into {batch}) != plain version")
        cases += 1
    return cases


# MCU columns per image where the epilogue's two forms branch.  Banded
# (crops, and full batches the row form does not take): 32 (one aligned
# chunk), 1, 17 (a ragged chunk), 33 and 128 (a chunk loop).  Row form
# (full batches of 4:2:0 at scale 1, bands of 32 // gw whole MCU rows, and
# 32 itself): 16 (two rows), 8 (four rows), 14 (28-byte runs in 4-byte
# copies), 24 (8-byte copies), and 31 (a 31-byte run, which no copy size
# divides: banded).
BAND_GWS = (32, 1, 17, 33, 128, 16, 8, 14, 24, 31)
# Widths of BAND_GWS given an M that is a multiple of 16, so that the row
# form can take their full batches; the others keep 3 MCUs over the batch
# where gw % 16 != 0, so that the banded form's byte loads run too.
ROW_GWS = (16, 8, 14, 24, 31)
# M values of the dequantize stage cases: around the 4 blocks a warp takes
# at once, an odd count that ends inside a CUDA block, and a B=256 batch.
DEQUANT_MS = (1, 3, 31, 33, 1027, 196608)


def epilogue_band_cases(torch, dev, rng) -> tuple:
    """raster_epilogue against its plain version where its two forms
    branch, byte for byte in every output type: gray and 4:2:0 at scale 1
    and 2, ``gw`` of ``BAND_GWS`` (M % 16 == 0 for multiples of 16 and
    ``ROW_GWS``, else not), outputs 1, 5, 500, one MCU short of the grid
    (where the grid has them) and the full grid wide, B = 1 for the full form, and six crop origins
    (0, the far edge, negative, past the edge, odd, even) as one B = 6
    launch; then the B=256 ImageNet geometry itself (24 x 32 MCUs of
    4:2:0, 500x375) at scale 1 and 2 in all four output types, and the
    loader cell's (16 x 16 MCUs, 256x256, scale 1 -> bfloat16 with CLIP's
    statistics).  Returns ``(cases, launches that took the row form)``;
    fails unless the loader cell's launch took it."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _norm_static
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        launch_counts, raster_epilogue, raster_epilogue_reference)
    from pim_jpeg_decoder_tpu_torch.tools.decode_ab import (
        CLIP_NORM, LOADER_BATCH)

    dtypes = (None, torch.float32, torch.bfloat16, torch.float16)
    taken = 0

    def check(what, raw, mode, scale, b, gh, gw, *args, dtype,
              stats=IMAGENET_NORM) -> bool:
        nonlocal taken
        norm = _norm_static(dtype, **stats) if dtype else None
        before = launch_counts()["raster_rows"]
        got = raster_epilogue(raw, mode, scale, b, gh, gw, *args, norm=norm)
        row_form = launch_counts()["raster_rows"] > before
        want = raster_epilogue_reference(raw, mode, scale, b, gh, gw, *args,
                                         norm=norm)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"raster epilogue != plain version: {mode.name} scale "
                 f"{scale} {dtype} B={b} gh={gh} gw={gw} {what} ("
                 f"{'row' if row_form else 'banded'} form)")
        taken += row_form
        return row_form

    cases = 0
    b, gh = 6, 2
    for key in ((1, 1, 1), (2, 2, 3)):
        mode = S.mode_for(key)
        for scale in (1, 2):
            n = 8 // scale
            for gw in BAND_GWS:
                m = b * gh * gw
                m += -m % 16 if gw in ROW_GWS else (0 if gw % 16 == 0
                                                     else 3)
                raw = torch.from_numpy(rng.integers(
                    0, 256, (3, mode.luma_slots, n * n, m),
                    dtype=np.uint8)).to(dev)
                grid_h, grid_w = gh * mode.v * n, gw * mode.h * n
                out_h = grid_h - 3
                for out_w in sorted({1, 5, 500, grid_w - mode.h * n,
                                     grid_w}):
                    if not 0 < out_w <= grid_w:
                        continue
                    far_y, far_x = grid_h - out_h, grid_w - out_w
                    origins = ((0, 0), (far_y, far_x), (-3, -2),
                               (far_y + 5, far_x + 9), (1, far_x | 1),
                               (2, far_x & ~1))
                    oys, oxs = (torch.tensor(o, dtype=torch.int32,
                                             device=dev)
                                for o in zip(*origins))
                    for dtype in dtypes:
                        check(f"full {out_h}x{out_w}", raw, mode, scale, 1,
                              gh, gw, out_h, out_w, dtype=dtype)
                        check(f"crops {out_h}x{out_w}", raw, mode, scale, b,
                              gh, gw, out_h, out_w, oys, oxs, dtype=dtype)
                        cases += 2
    mode = S.mode_for((2, 2, 3))
    b, gh, gw = 256, 24, 32
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for scale in (1, 2):
        n = 8 // scale
        raw = torch.randint(0, 256, (3, mode.luma_slots, n * n, b * gh * gw),
                            dtype=torch.uint8, device=dev, generator=gen)
        for dtype in dtypes:
            check("the ImageNet batch", raw, mode, scale, b, gh, gw,
                  -(-375 // scale), -(-500 // scale), dtype=dtype)
            cases += 1
        del raw
    b, gh, gw, height, width = LOADER_BATCH
    raw = torch.randint(0, 256, (3, mode.luma_slots, 64, b * gh * gw),
                        dtype=torch.uint8, device=dev, generator=gen)
    shifted = launch_counts()["raster_shifted"]
    if not check("the loader cell's batch", raw, mode, 1, b, gh, gw, height,
                 width, dtype=torch.bfloat16, stats=CLIP_NORM):
        fail("the loader cell's batch did not take the epilogue's row form")
    if launch_counts()["raster_shifted"] != shifted:
        fail("the loader cell's row-form launch counted as shifted")
    cases += 1
    del raw
    torch.cuda.empty_cache()
    return cases, taken


def dequant_cases(torch, dev, rng, max_err) -> int:
    """dequantize_stage against its plain version, tolerance 0, in every
    mode (g = 1, 3, 4, 6) on both wires at the M values of ``DEQUANT_MS``:
    extreme coefficients (the wire's limits against 16-bit quantizers, so
    the int32 product wraps before the clamp), ``qidx`` of Q and -1 (a zero
    quantizer row); and the three stages composed still equal to the fused
    RGB kernel."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as SK
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, qpool_to_device)

    cases = 0
    for key in sorted(S.MODES):
        mode = S.mode_for(key)
        for wire in (np.int16, np.int8):
            for m in DEQUANT_MS:
                coeffs, qidx, qpool = synthetic_batch(mode, max(m, 3), wire,
                                                      rng, extreme=True)
                info = np.iinfo(wire)
                coeffs[0, :, ::2], coeffs[0, :, 1::2] = info.max, info.min
                qidx[0] = qpool.shape[0] - 1          # the 16-bit row
                qidx[m // 2] = qpool.shape[0]
                qidx[m - 1] = -1
                x = coeffs_to_device(coeffs[:m], dev)
                qi = torch.from_numpy(qidx[:m]).to(dev)
                qp = qpool_to_device(qpool, dev)
                got = SK.dequantize_stage(x, qi, qp, mode)
                want = SK.dequantize_stage_reference(x, qi, qp)
                staged = SK.decode_mcus_staged(x, qi, qp, mode)
                fused = decode_mcus(x, qi, qp, mode)
                torch.cuda.synchronize()
                err = int((got.int() - want.int()).abs().max())
                max_err["dequant"] = max(max_err["dequant"], err)
                if got.shape != want.shape or err:
                    fail(f"dequant stage kernel != plain version: "
                         f"{mode.name} {np.dtype(wire).name} M={m} "
                         f"max|err|={err}")
                if not torch.equal(staged, fused):
                    fail(f"decode_mcus_staged != decode_mcus: {mode.name} "
                         f"{np.dtype(wire).name} M={m}")
                cases += 1
                del x, qi, got, want, staged, fused
        torch.cuda.empty_cache()
    return cases


# M values of the IDCT and colour stage cases: TILE_MS, where the colour
# kernel's 32-MCU tile and 8-byte stores branch (16 and 24: M % 8 == 0, a
# ragged last tile; the odd ones take the byte stores) and an odd count
# that ends inside a CUDA block.
STAGE_MS = TILE_MS + (16, 24, 1027)


def stage_tile_cases(torch, dev, rng, max_err) -> int:
    """idct_stage and color_stage against their plain versions, tolerance
    0, in every mode on both wires at the M values of ``STAGE_MS`` and on a
    ``[5:]`` slice (1,027 MCUs from MCU 5): the IDCT on the dequantized
    extremes, the colour stage on the IDCT's output, on the dequantized
    coefficients and on full-range int16 (32767 and -32768 blocks, the
    BT.601 products wrap); and decode_mcus_staged equal to decode_mcus."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as SK
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, qpool_to_device)

    def same(name, got, want, what) -> None:
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err[name] = max(max_err[name], err)
        if got.shape != want.shape or err:
            fail(f"{name} stage kernel != plain version: {what} "
                 f"max|err|={err}")

    cases = 0
    for key in sorted(S.MODES):
        mode = S.mode_for(key)
        for wire in (np.int16, np.int8):
            for m in STAGE_MS + ("slice",):
                n = 1032 if m == "slice" else m
                what = f"{mode.name} {np.dtype(wire).name} M={m}"
                coeffs, qidx, qpool = synthetic_batch(mode, max(n, 3), wire,
                                                      rng, extreme=True)
                qidx[n // 2] = qpool.shape[0]
                qidx[n - 1] = -1
                x = coeffs_to_device(coeffs[:n], dev)
                qi = torch.from_numpy(qidx[:n]).to(dev)
                qp = qpool_to_device(qpool, dev)
                deq = SK.dequantize_stage(x, qi, qp, mode)
                full = rng.integers(-32768, 32768, (n, mode.g, 64),
                                    dtype=np.int16)
                full[0], full[min(1, n - 1)] = 32767, -32768
                full = torch.from_numpy(full).to(dev)
                if m == "slice":   # inputs from MCU 5, 16-byte aligned
                    x, qi, deq, full = (t[5:] for t in (x, qi, deq, full))
                spat = SK.idct_stage(deq, mode)
                same("idct", spat, SK.idct_stage_reference(deq), what)
                for src in (spat, deq, full):
                    same("color", SK.color_stage(src, mode, raw=True),
                         SK.color_stage_reference(src, mode, raw=True), what)
                staged = SK.decode_mcus_staged(x, qi, qp, mode)
                fused = decode_mcus(x, qi, qp, mode)
                torch.cuda.synchronize()
                if not torch.equal(staged, fused):
                    fail(f"decode_mcus_staged != decode_mcus: {what}")
                cases += 5
                del x, qi, deq, full, spat, staged, fused
        torch.cuda.empty_cache()
    return cases


# --- phase 3 -----------------------------------------------------------------

def synth_photo(rng, h: int, w: int) -> np.ndarray:
    """Smooth blobs + edges + sensor noise: a photo-like coefficient mix."""
    small = rng.integers(0, 256, (h // 16 + 2, w // 16 + 2, 3))
    big = np.kron(small, np.ones((16, 16, 1)))[:h, :w].astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    big += 40.0 * np.sin(xx / (7.0 + 5 * rng.random()))[..., None]
    big += 30.0 * np.cos(yy / (11.0 + 5 * rng.random()))[..., None]
    big += rng.normal(0.0, 5.0, big.shape)
    return np.clip(big, 0, 255).astype(np.uint8)


CORPUS = (
    # (count, height, width, encode kwargs)
    (32, 375, 500, dict(sampling="4:2:0", quality=75)),
    (2, 480, 640, dict(sampling="4:2:2", quality=75)),
    (2, 600, 800, dict(grayscale=True, quality=75)),
    (3, 257, 333, dict(sampling="4:4:4", quality=75)),
    (1, 240, 320, dict(sampling="4:4:0", quality=75)),
    (1, 389, 513, dict(sampling="4:2:0", quality=75)),
    (1, 1536, 2048, dict(sampling="4:2:0", quality=75)),
    (1, 375, 500, dict(sampling="4:2:0", quality=75, restart_interval=8)),
)


def corpus_kwargs():
    """The encode options of each corpus file, in build_corpus order."""
    return [kw for count, _, _, kw in CORPUS for _ in range(count)]


def build_corpus(root: str):
    from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg

    rng = np.random.default_rng(SEED + 1)
    paths = []
    for i, (count, h, w, kw) in enumerate(CORPUS):
        for j in range(count):
            path = os.path.join(root, f"img{i}_{j:02d}.jpg")
            with open(path, "wb") as f:
                f.write(encode_jpeg(synth_photo(rng, h, w), **kw))
            paths.append(path)
    return paths


def oracle_raster(data: bytes):
    from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu_torch.native import decode_scan_native
    from pim_jpeg_decoder_tpu_torch.oracle.decoder import (
        assemble_raster, mcu_rgb_from_coeffs)

    header = scan_jpeg(data)
    coeffs = decode_scan_native(header)
    return (header, coeffs,
            assemble_raster(header, mcu_rgb_from_coeffs(header, coeffs)))


def bmp_digests(paths) -> dict:
    from pim_jpeg_decoder_tpu_torch.models.pipeline import output_path
    out = {}
    for p in paths:
        with open(output_path(p), "rb") as f:
            out[p] = hashlib.sha1(f.read()).hexdigest()
    return out


@contextlib.contextmanager
def env(name: str, value: str):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def phase_slice(dev, paths, oracles, scaled_oracles) -> dict:
    from pim_jpeg_decoder_tpu_torch.io.bmp import read_bmp
    from pim_jpeg_decoder_tpu_torch.models.pipeline import output_path
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        launch_counts, reset_launch_counts)

    def run_cli(args) -> int:
        from pim_jpeg_decoder_tpu_torch.cli import main
        with contextlib.redirect_stdout(sys.stderr):
            return main([*args, "--device", str(dev), "--quiet"])

    reset_launch_counts()
    rc = run_cli(paths)
    counts = launch_counts()
    if rc != 0:
        fail(f"cli.main exited {rc} on the corpus")
    for p in paths:
        got = read_bmp(output_path(p))
        if not np.array_equal(got, oracles[p]):
            fail(f"BMP of {os.path.basename(p)} != oracle raster")
    if counts["rgb"] < 1 or counts["ycbcr"] < 1:
        fail(f"main path did not launch both kernels: {counts}")
    if counts["plain_on_cuda"]:
        fail(f"main path called the plain version on CUDA: {counts}")
    base = bmp_digests(paths)

    if run_cli([*paths, "--transport", "rgb"]) != 0:
        fail("cli.main --transport rgb failed")
    if bmp_digests(paths) != base:
        fail("--transport rgb BMPs differ from the auto-transport BMPs")
    with env("PIM_JPEG_TPU_MAX_LAUNCH", "4096"):
        if run_cli(paths) != 0:
            fail("cli.main with PIM_JPEG_TPU_MAX_LAUNCH=4096 failed")
    if bmp_digests(paths) != base:
        fail("banded (4096-MCU launch cap) BMPs differ")

    root = os.path.dirname(paths[0])
    corrupt = os.path.join(root, "corrupt.jpg")
    with open(paths[0], "rb") as f:
        data = f.read()
    with open(corrupt, "wb") as f:
        f.write(data[:600] + bytes(200))
    missing = os.path.join(root, "missing.jpg")
    good = [paths[0], paths[-1]]
    for p in good:
        os.remove(output_path(p))
    rc = run_cli([*good, corrupt, missing])
    if rc != 1:
        fail(f"corrupt + missing inputs: exit {rc}, expected 1")
    if os.path.exists(output_path(corrupt)):
        fail("a BMP was written for the corrupt file")
    if {p: base[p] for p in good} != bmp_digests(good):
        fail("good files beside the corrupt/missing ones did not decode")
    print(f"[3 slice] cli.main on {len(paths)} JPEGs (5 modes, DRI, "
          f"2048x1536): exit 0, every BMP == oracle raster; launches "
          f"rgb={counts['rgb']} ycbcr={counts['ycbcr']} "
          f"plain_on_cuda={counts['plain_on_cuda']}; --transport rgb and "
          f"4096-MCU bands byte-identical; corrupt+missing -> exit 1, "
          f"others decoded", flush=True)

    reset_launch_counts()
    rc = run_cli([*paths, "--scale", "2"])
    scaled_counts = launch_counts()
    if rc != 0:
        fail(f"cli.main --scale 2 exited {rc} on the corpus")
    for p in paths:
        if not np.array_equal(read_bmp(output_path(p)), scaled_oracles[p]):
            fail(f"--scale 2 BMP of {os.path.basename(p)} != scaled oracle")
    if scaled_counts["rgb_scaled"] < 1 or scaled_counts["plain_on_cuda"]:
        fail(f"cli.main --scale 2 did not go through the scaled kernel "
             f"alone: {scaled_counts}")
    print(f"[3 slice] cli.main --scale 2 on {len(paths)} JPEGs: exit 0, "
          f"every BMP == decode_scaled_oracle; launches rgb_scaled="
          f"{scaled_counts['rgb_scaled']} plain_on_cuda="
          f"{scaled_counts['plain_on_cuda']}", flush=True)
    return counts, base


PHASE_LABELS = ("GPU kernel device time", "Device dequantization time",
                "Device inverse DCT time", "Device color conversion time")


def phase_profile(dev, paths, tmp: str) -> dict:
    """``cli.main --device-profile measure --profile DIR`` on the corpus,
    then the default ``cached`` run: the stage kernels launch in the first
    run only, both print the same phase lines, and the trace names the
    decode kernels.  Returns the launch counts of the first run."""
    import io

    from pim_jpeg_decoder_tpu_torch.cli import main
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        launch_counts, reset_launch_counts)
    from pim_jpeg_decoder_tpu_torch.runtime import device_profile

    device_profile.CACHE_PATH = os.path.join(tmp, "phase_cache.json")
    trace_dir = os.path.join(tmp, "trace")
    walls = []

    def run(args):
        out = io.StringIO()
        reset_launch_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            rc = main([*paths, "--device", str(dev), "--no-write", *args])
        walls.append(time.monotonic() - t0)
        counts = launch_counts()
        if rc != 0:
            fail(f"cli.main {' '.join(args)} exited {rc}")
        lines = out.getvalue().splitlines()
        start = [i for i, ln in enumerate(lines) if PHASE_LABELS[0] in ln]
        phases = lines[start[0]:] if start else []
        for label in PHASE_LABELS:
            if not any(label in ln for ln in phases):
                fail(f"cli.main {' '.join(args)}: no '{label}' line in the "
                     f"Profiles block:\n{out.getvalue()}")
        return counts, phases, lines

    with env("PIM_JPEG_TPU_PROFILE", trace_dir):
        counts, phases, lines = run(["--device-profile", "measure",
                                     "--profile", trace_dir])
    if min(counts[k] for k in STAGES) < 1 or counts["plain_on_cuda"]:
        fail(f"--device-profile measure did not go through the stage "
             f"kernels alone: {counts}")
    traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
              if f.endswith(".json")]
    if len(traces) != 1:
        fail(f"--profile wrote {len(traces)} trace files: {traces}")
    with open(traces[0]) as f:
        trace = f.read()
    json.loads(trace)
    if "rgb_kernel" not in trace or "ycbcr_kernel" not in trace:
        fail("the --profile trace does not name rgb_kernel and ycbcr_kernel")
    cached_counts, cached_phases, _ = run([])
    if cached_phases != phases:
        fail(f"the cached run printed other phase lines: {cached_phases} "
             f"vs {phases}")
    if any(cached_counts[k] for k in STAGES) or cached_counts["plain_on_cuda"]:
        fail(f"the cached run launched stage kernels: {cached_counts}")
    init = [ln for ln in lines if "Device program init" in ln]
    print(f"[3 slice] cli.main --device-profile measure --profile on "
          f"{len(paths)} JPEGs: exit 0; launches "
          + " ".join(f"{k}={counts[k]}" for k in ("rgb", "ycbcr", *STAGES,
                                                    "plain_on_cuda"))
          + f"; trace {os.path.getsize(traces[0])} bytes names rgb_kernel "
          f"and ycbcr_kernel; the cached rerun printed the same phase lines "
          f"with 0 stage launches; CLI wall {walls[0]:.2f} s (measure + "
          f"trace) vs {walls[1]:.2f} s (cached). {' '.join(init)}",
          flush=True)
    for ln in phases:
        print(f"[3 slice]   {ln.strip()}", flush=True)
    return counts


def imagenet_batches(rng, blobs, batches: int = 4, size: int = 256):
    """``batches`` lists of ``size`` indices into ``blobs``: each blob
    size / len(blobs) times, in a seeded order."""
    return [rng.permutation(np.arange(size) % len(blobs))
            for _ in range(batches)]


def mixed_crop_batch(rng, mixed, size: int = 256):
    """A batch of the crop cell's mix from ``mixed`` (mode name -> list of
    ``(blob, oracle raster)``): ``size // 8`` images of 4:4:4 at random
    positions, the rest 4:2:0, each with a 224x224 crop at a uniform random
    origin.  Returns the blobs, the origins and the oracle's crops."""
    four = np.zeros(size, bool)
    four[rng.permutation(size)[:size // 8]] = True
    blobs, boxes, want = [], [], []
    for k in range(size):
        pool = mixed["4:4:4" if four[k] else "4:2:0"]
        blob, raster = pool[int(rng.integers(0, len(pool)))]
        y0 = int(rng.integers(0, raster.shape[0] - 224 + 1))
        x0 = int(rng.integers(0, raster.shape[1] - 224 + 1))
        blobs.append(blob)
        boxes.append((y0, x0))
        want.append(raster[y0:y0 + 224, x0:x0 + 224])
    return blobs, boxes, np.stack(want)


BATCH_CONFIGS = ((1, None), (1, "bfloat16"), (2, None), (2, "bfloat16"))


def batch_options(torch, dtype_name):
    """The batch APIs' keyword options for one configuration, and the
    normalisation they ask for (None: uint8)."""
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _norm_static

    if dtype_name is None:
        return {}, None
    kw = dict(dtype=getattr(torch, dtype_name), **IMAGENET_NORM)
    return kw, _norm_static(**kw)


def phase_batches(torch, dev, blobs, refs, crop_set) -> dict:
    """The device-resident batch path at the ImageNet input size, then a
    crop batch; each equal to the oracle (bfloat16: the oracle through the
    plain normalisation).  Returns the launch counts of the batch run."""
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import (
        decode_batch_crops, iter_decode_batch_crops, iter_decode_batches)
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        apply_norm, launch_counts, reset_launch_counts)

    rng = np.random.default_rng(SEED + 3)
    order = imagenet_batches(rng, blobs)
    expected = {s: torch.from_numpy(np.stack(refs[s])).to(dev)
                for s in (1, 2)}
    n_images = 0
    reset_launch_counts()
    for scale, dtype_name in BATCH_CONFIGS:
        kw, norm = batch_options(torch, dtype_name)
        stream = iter_decode_batches(([blobs[i] for i in idx]
                                      for idx in order), scale=scale,
                                     device=dev, **kw)
        for idx, (out, headers) in zip(order, stream):
            want = apply_norm(expected[scale][torch.from_numpy(idx).to(dev)],
                              norm)
            if (out.device.type != "cuda" or out.shape != want.shape
                    or not torch.equal(out, want)):
                fail(f"batch (scale {scale}, {dtype_name or 'uint8'}) != "
                     f"oracle: {tuple(out.shape)} {out.dtype} on "
                     f"{out.device}")
            n_images += len(headers)
    counts = launch_counts()
    if (counts["rgb"] < 1 or counts["rgb_scaled"] < 1 or counts["raster"] < 1
            or counts["plain_on_cuda"]):
        fail(f"batch path did not go through rgb, rgb_scaled and raster "
             f"alone: {counts}")
    print(f"[3 slice] iter_decode_batches: {len(order)} batches x B=256 "
          f"500x375 4:2:0 at scale 1/2 x uint8/bfloat16-normalised "
          f"({n_images} images): every batch == oracle rasters; launches "
          f"rgb={counts['rgb']} rgb_scaled={counts['rgb_scaled']} "
          f"raster={counts['raster']} (row form {counts['raster_rows']}) "
          f"plain_on_cuda={counts['plain_on_cuda']}", flush=True)

    crop_blobs, crop_refs, mixed = crop_set
    reset_launch_counts()
    for scale, dtype_name in ((1, None), (2, "bfloat16")):
        boxes = [(scale * int(rng.integers(0, (r.shape[0] - 224) // scale
                                           + 1)),
                  scale * int(rng.integers(0, (r.shape[1] - 224) // scale
                                           + 1)))
                 for r in crop_refs[1]]
        kw, norm = batch_options(torch, dtype_name)
        out, _ = decode_batch_crops(crop_blobs, boxes, (224, 224),
                                    scale=scale, device=dev, **kw)
        c = 224 // scale
        want = torch.from_numpy(np.stack([
            r[y0 // scale:y0 // scale + c, x0 // scale:x0 // scale + c]
            for r, (y0, x0) in zip(crop_refs[scale], boxes)])).to(dev)
        if not torch.equal(out, apply_norm(want, norm)):
            fail(f"decode_batch_crops (scale {scale}) != oracle slices")
    crop_counts = launch_counts()
    if crop_counts["raster"] < 1 or crop_counts["plain_on_cuda"]:
        fail(f"crop batch did not go through the kernels alone: "
             f"{crop_counts}")
    sizes = sorted({r.shape[:2] for r in crop_refs[1]})
    print(f"[3 slice] decode_batch_crops: {len(crop_blobs)} 4:2:0 images of "
          f"sizes {sizes}, 224x224 random crops at scale 1 (uint8) and 2 "
          f"(bfloat16-normalised): == oracle slices; launches "
          f"rgb={crop_counts['rgb']} rgb_scaled={crop_counts['rgb_scaled']} "
          f"raster={crop_counts['raster']} plain_on_cuda="
          f"{crop_counts['plain_on_cuda']}", flush=True)

    # The crop cell's path: two batches through the iterator in bfloat16
    # with the ImageNet statistics, one through decode_batch_crops in
    # uint8; each batch one decode launch and one epilogue a mode.
    batches = [mixed_crop_batch(rng, mixed) for _ in range(3)]
    kw, norm = batch_options(torch, "bfloat16")
    reset_launch_counts()
    stream = iter_decode_batch_crops(
        ((b, x) for b, x, _ in batches[:2]), (224, 224), device=dev,
        mixed_sizes=True, prefetch=2, **kw)
    outs = [(out, norm) for out, _ in stream]
    outs.append((decode_batch_crops(*batches[2][:2], (224, 224),
                                    device=dev)[0], None))
    for (out, nm), (_, _, want) in zip(outs, batches):
        if not torch.equal(out, apply_norm(torch.from_numpy(want).to(dev),
                                           nm)):
            fail(f"mixed-mode crop batch ({out.dtype}) != oracle slices")
    mixed_counts = launch_counts()
    want_counts = {"rgb": 2 * len(batches), "raster": 2 * len(batches),
                   "rgb_scaled": 0, "raster_rows": 0, "plain_on_cuda": 0}
    if any(mixed_counts[k] != v for k, v in want_counts.items()):
        fail(f"mixed-mode crop batches: launches {mixed_counts}, expected "
             f"{want_counts}")
    sizes = {m: sorted({r.shape[:2] for _, r in pool})
             for m, pool in mixed.items()}
    print(f"[3 slice] the crop cell's batches: {len(batches)} x B=256 "
          f"224x224 crops of 4:2:0 {sizes['4:2:0']} and, 1 in 8, 4:4:4 "
          f"{sizes['4:4:4']}, two through iter_decode_batch_crops(mixed_sizes=True) in "
          f"bfloat16-normalised, one through decode_batch_crops in uint8: "
          f"== oracle slices; launches rgb={mixed_counts['rgb']} raster="
          f"{mixed_counts['raster']} (row form "
          f"{mixed_counts['raster_rows']}) plain_on_cuda="
          f"{mixed_counts['plain_on_cuda']}", flush=True)
    return counts


# --- phase 3, several devices ---------------------------------------------

MULTI_RANKS = 2
MULTI_RANK_TIMEOUT_S = 150


def shard_launches(report) -> int:
    """Kernel launches an engine report's batches made: one a shard."""
    dispatches = sum(report.launch_stats.values())
    return (len(report.devices) * (dispatches - report.one_device_batches)
            + report.one_device_batches)


def engine_mps(torch, engine, paths, runs: int = 3):
    """MP/s of ``runs`` synchronised engine runs writing BMPs (after a
    warm one), and the last report."""
    engine.decode_paths(paths, write=True)
    rates = []
    for _ in range(runs):
        t0 = time.monotonic()
        report = engine.decode_paths(paths, write=True)
        torch.cuda.synchronize()
        rates.append(report.total_megapixels / (time.monotonic() - t0))
    return rates, report


def concat_costs(torch, dev, card: str) -> None:
    """The host concatenation that a gather of the engine's shards would
    cost, beside the D2H of those shards (pinned, one buffer each)."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.parallel.sharding import (
        decode_mcus_sharded, to_host)

    mode = S.mode_for((2, 2, 3))
    rng = np.random.default_rng(SEED + 6)
    for m in (16384, 65536):     # the engine's packed and big launches
        coeffs, qidx, qpool = synthetic_batch(mode, m, np.int8, rng,
                                              extreme=False)
        for ycbcr in (True, False):
            outs = decode_mcus_sharded(coeffs, qidx, qpool, mode,
                                       [dev, dev], raw=not ycbcr,
                                       ycbcr=ycbcr)
            d2h, cat = [], []
            for _ in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                host, done = to_host(outs)
                for event in done:
                    if event is not None:
                        event.synchronize()
                d2h.append(time.perf_counter() - t0)
                shards = [h.numpy() for h in host]
                t0 = time.perf_counter()
                np.concatenate(shards, axis=-1)
                cat.append(time.perf_counter() - t0)
            d2h_s, cat_s = statistics.median(d2h), statistics.median(cat)
            mb = sum(o.numel() for o in outs) / 1e6
            print(f"[3 multi] host concatenation of 2 shards, 4:2:0 M={m} "
                  f"{'ycbcr' if ycbcr else 'rgb'} ({mb:.1f} MB): "
                  f"{cat_s:.6f} s (median of 7; min {min(cat):.6f}) against "
                  f"the shards' D2H {d2h_s:.6f} s (min {min(d2h):.6f}), "
                  f"{cat_s / d2h_s:.2f}x | {card}", flush=True)
    print("[3 multi] the engine concatenates no shards: each image is "
          "finished from the shard buffer that holds it, and only an image "
          "that straddles two shards is joined, by a copy of its own MCUs "
          "(parallel/sharding.mcu_window)", flush=True)


def visible_card(index: int) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a child that sees only this process's
    card ``index``."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return visible.split(",")[index] if visible else str(index)


def scaling_ranks(devices, root: str, tmp: str, card: str) -> None:
    """Ranks of the port's tools/scaling_bench.py over gloo on localhost:
    one a distinct card of ``devices`` (each sees only its own), or
    ``MULTI_RANKS`` on one card; every rank exits 0, and only the
    metadata rows cross."""
    import socket

    cards = sorted({d.index for d in devices})
    ranks = len(cards) if len(cards) > 1 else MULTI_RANKS

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    logs, procs = [], []
    for rank in range(ranks):
        out = open(os.path.join(tmp, f"rank{rank}.out"), "w+")
        err = open(os.path.join(tmp, f"rank{rank}.err"), "w+")
        logs.append((out, err))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible_card(
            cards[rank % len(cards)]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pim_jpeg_decoder_tpu_torch.tools."
             "scaling_bench", "--num-processes", str(ranks),
             "--process-id", str(rank), "--coordinator",
             f"localhost:{port}", "--images", "16", "--device", "cuda:0"],
            stdout=out, stderr=err, cwd=root, env=env, text=True))
    t0 = time.monotonic()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, MULTI_RANK_TIMEOUT_S
                               - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        texts.append((out.read(), err.read()))
        out.close()
        err.close()
    wall = time.monotonic() - t0
    for rank, (p, (out, err)) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"scaling_bench rank {rank} exited {p.returncode}:\n{out}\n"
                 f"{err[-3000:]}")
    lines = [ln for ln in texts[0][0].splitlines() if ln.startswith("{")]
    if not lines:
        fail(f"scaling_bench rank 0 printed no JSON:\n{texts[0][0]}")
    report = json.loads(lines[-1])
    if (report.get("hosts") != ranks
            or not 0 < report.get("dcn_bytes", 0) <= 64 * ranks
            or report.get("mp_balance", 0) < 0.99):
        fail(f"scaling_bench over gloo: {report}")
    print(f"[3 multi] tools.scaling_bench, {ranks} ranks on cuda:"
          f"{', cuda:'.join(str(cards[r % len(cards)]) for r in range(ranks))}"
          f" over gloo (localhost), 16 images: every rank exits 0 in "
          f"{wall:.1f} s; {json.dumps(report)} | {card}", flush=True)


def per_card_kernels(torch, devices, card: str) -> None:
    """Each kernel that prepares function attributes (dynamic shared memory
    above 48 KB, the carveout: ``csrc/decode_tile.cuh:PerDevice``) launched
    on every card at 4:2:0 on the int16 wire, equal to the same launch on
    the first card: a once-per-process preparation fails on a second card
    (rgb_kernel needs 56,960 B there)."""
    from pim_jpeg_decoder_tpu_torch.ops import kernel_variants, mxu_idct
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as ST
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, qpool_to_device)

    mode = S.mode_for((2, 2, 3))
    c, qi, qp = synthetic_batch(mode, 4099, np.int16, np.random.default_rng(
        SEED + 7), extreme=True)
    deq = np.clip(c.astype(np.int32) * 9, -2048, 2047).astype(np.int16)
    cases = {
        "rgb": lambda x, q, p, d: decode_mcus(x, q, p, mode, raw=True),
        "ycbcr": lambda x, q, p, d: decode_mcus(x, q, p, mode, ycbcr=True),
        "rgb_scaled": lambda x, q, p, d: decode_mcus(x, q, p, mode, raw=True,
                                                     scale=2),
        "truerez": lambda x, q, p, d: kernel_variants.rgb_truerez(x, q, p,
                                                                  mode),
        "stacked": lambda x, q, p, d: kernel_variants.rgb_stacked(x, q, p,
                                                                  mode),
        "idct+color": lambda x, q, p, d: ST.decode_mcus_staged(x, q, p, mode),
        "mxu64": lambda x, q, p, d: mxu_idct.mxu64(d),
    }
    want = {}
    for dev in devices:
        inputs = (coeffs_to_device(c, dev), torch.from_numpy(qi).to(dev),
                  qpool_to_device(qp, dev), torch.from_numpy(deq).to(dev))
        for name, fn in cases.items():
            with torch.cuda.device(dev):
                got = fn(*inputs).cpu()
            if name not in want:
                want[name] = got
            elif not torch.equal(got, want[name]):
                fail(f"{name} on {dev} differs from {devices[0]}")
    print(f"[3 cards] {', '.join(cases)} at 4:2:0 int16, M=4099 with extreme "
          f"blocks, on each of {', '.join(str(d) for d in devices)}: == the "
          f"first card's | {card}", flush=True)


def phase_multi(torch, dev, devices, card: str, root: str, tmp: str, paths,
                oracles, base: dict, blobs, refs, crop_set) -> None:
    """Every path that takes a device list, over ``devices`` (two shards
    of the one card, ``[dev, dev]``, or with ``--cards`` every card): the
    split, the per-shard streams and the gather.  Each output equals the
    oracle or the one-device (``dev``) output, and every shard launched.
    Then ranks of the scaling harness over gloo."""
    from pim_jpeg_decoder_tpu_torch.io.bmp import read_bmp
    from pim_jpeg_decoder_tpu_torch.models import pipeline as P
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import (
        _groups, decode_batch_crops, iter_decode_batches)
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        apply_norm, launch_counts, reset_launch_counts)
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig

    t_phase = time.monotonic()
    two, n = list(devices), len(devices)
    names = ", ".join(str(d) for d in two)
    for transport in ("auto", "rgb"):
        engine = DecodeEngine(config=EngineConfig.from_env(
            transport=transport), device=two)
        reset_launch_counts()
        report = engine.decode_paths(paths, write=True)
        counts = launch_counts()
        if report.ok_count != len(paths):
            fail(f"two-shard engine ({transport}) failed files: "
                 f"{[(r.name, r.error) for r in report.results if not r.ok]}")
        if bmp_digests(paths) != base:
            fail(f"two-shard engine ({transport}) BMPs differ from the "
                 f"one-device run's")
        for p in paths:
            if not np.array_equal(read_bmp(P.output_path(p)), oracles[p]):
                fail(f"two-shard BMP of {os.path.basename(p)} != oracle")
        launched = counts["rgb"] + counts["ycbcr"]
        if (launched != shard_launches(report) or counts["plain_on_cuda"]
                or report.one_device_batches):
            fail(f"two-shard engine ({transport}): launches {counts}, "
                 f"{shard_launches(report)} expected "
                 f"({report.one_device_batches} one-device batches)")
        print(f"[3 multi] DecodeEngine(device=[{names}]) --transport "
              f"{transport} on {len(paths)} JPEGs: every BMP == oracle raster "
              f"and == the one-device digests; launches rgb={counts['rgb']} "
              f"ycbcr={counts['ycbcr']} plain_on_cuda="
              f"{counts['plain_on_cuda']} ({n} a batch, "
              f"{sum(report.launch_stats.values())} batches, 0 on one device)",
              flush=True)

    # The first file of each corpus entry: every mode, DRI, 2048x1536.
    firsts = np.cumsum([0] + [count for count, _, _, _ in CORPUS])[:-1]
    singles = [paths[i] for i in firsts]
    reset_launch_counts()
    for p in singles:
        with open(p, "rb") as f:
            data = f.read()
        h = oracles[p].shape[0]
        w = oracles[p].shape[1]
        pairs = (
            (P.TorchJpegDecoder(two).decode(data).rgb, oracles[p]),
            (P.decode_scaled(data, 2, two), P.decode_scaled(data, 2, dev)),
            (P.decode_region(data, h // 3, w // 5, h // 2, w // 2, two),
             oracles[p][h // 3:h // 3 + h // 2, w // 5:w // 5 + w // 2]))
        for what, (got, want) in zip(("decode", "decode_scaled 2",
                                      "decode_region"), pairs):
            if not np.array_equal(got, want):
                fail(f"two-shard {what} of {os.path.basename(p)} differs")
    counts = launch_counts()
    # A shard a device for the decode and the region; for decode_scaled n,
    # and one for the one-device output it is held against.
    if (counts["rgb"] + counts["ycbcr"] != 2 * n * len(singles)
            or counts["rgb_scaled"] != (n + 1) * len(singles)
            or counts["plain_on_cuda"]):
        fail(f"two-shard single-image APIs: launches {counts}")
    print(f"[3 multi] TorchJpegDecoder, decode_scaled(2), decode_region on "
          f"[{names}] for {len(singles)} JPEGs (every mode, 2048x1536): "
          f"== oracle / one device; launches rgb={counts['rgb']} ycbcr="
          f"{counts['ycbcr']} rgb_scaled={counts['rgb_scaled']} "
          f"plain_on_cuda={counts['plain_on_cuda']}", flush=True)

    rng = np.random.default_rng(SEED + 3)
    order = imagenet_batches(rng, blobs)
    expected = {s: torch.from_numpy(np.stack(refs[s])).to(dev)
                for s in (1, 2)}
    reset_launch_counts()
    for scale, dtype_name in ((1, None), (2, "bfloat16")):
        kw, norm = batch_options(torch, dtype_name)
        stream = iter_decode_batches(([blobs[i] for i in idx]
                                      for idx in order), scale=scale,
                                     device=two, **kw)
        for idx, (out, _) in zip(order, stream):
            want = apply_norm(expected[scale][torch.from_numpy(idx).to(dev)],
                              norm)
            if out.device != dev or not torch.equal(out, want):
                fail(f"two-shard batch (scale {scale}, "
                     f"{dtype_name or 'uint8'}) != oracle")
    counts = launch_counts()
    want_counts = {"rgb": n * len(order), "rgb_scaled": n * len(order),
                   "raster": 2 * n * len(order), "plain_on_cuda": 0}
    if any(counts[k] != v for k, v in want_counts.items()):
        fail(f"two-shard batches: launches {counts}, expected {want_counts}")
    print(f"[3 multi] iter_decode_batches on [{names}]: {len(order)} x "
          f"B=256 at scale 1 uint8 and scale 2 bfloat16-normalised: every "
          f"batch == oracle, one tensor on {dev}; launches rgb="
          f"{counts['rgb']} rgb_scaled={counts['rgb_scaled']} raster="
          f"{counts['raster']} plain_on_cuda={counts['plain_on_cuda']} ({n} "
          f"groups a batch)", flush=True)

    crop_blobs, crop_refs, mixed = crop_set
    boxes = [(2 * int(rng.integers(0, (r.shape[0] - 224) // 2 + 1)),
              2 * int(rng.integers(0, (r.shape[1] - 224) // 2 + 1)))
             for r in crop_refs[1]]
    reset_launch_counts()
    for scale, dtype_name in ((1, None), (2, "bfloat16")):
        kw, _ = batch_options(torch, dtype_name)
        got, _ = decode_batch_crops(crop_blobs, boxes, (224, 224),
                                    scale=scale, device=two, **kw)
        want, _ = decode_batch_crops(crop_blobs, boxes, (224, 224),
                                     scale=scale, device=dev, **kw)
        if not torch.equal(got, want):
            fail(f"two-shard decode_batch_crops (scale {scale}) != one "
                 f"device")
    counts = launch_counts()
    if counts["raster"] != 2 * (n + 1) or counts["plain_on_cuda"]:
        fail(f"two-shard crops: launches {counts} (raster {n} + 1 a "
             f"configuration expected)")
    print(f"[3 multi] decode_batch_crops on [{names}], "
          f"{len(crop_blobs)} images, scale 1 uint8 and 2 bfloat16: == one "
          f"device; launches raster={counts['raster']} ({n} + 1 a "
          f"configuration)", flush=True)

    # The crop cell's mixed-mode batch: each device's images are written
    # into the rows of its own output, counted from its first image.
    blobs_m, boxes_m, _ = mixed_crop_batch(rng, mixed)
    kw, _ = batch_options(torch, "bfloat16")
    reset_launch_counts()
    got, headers = decode_batch_crops(blobs_m, boxes_m, (224, 224),
                                      device=two, **kw)
    want, _ = decode_batch_crops(blobs_m, boxes_m, (224, 224), device=dev,
                                 **kw)
    if not torch.equal(got, want):
        fail("two-shard mixed-mode decode_batch_crops != one device")
    # A launch a mode present on each device, and two for the one device.
    launches = 2 + sum(len({headers[i].mode_key for i in range(b0, b1)})
                       for b0, b1 in _groups(len(blobs_m), n))
    counts = launch_counts()
    if (counts["rgb"] != launches or counts["raster"] != launches
            or counts["plain_on_cuda"]):
        fail(f"two-shard mixed-mode crops: launches {counts}, {launches} "
             f"rgb and raster expected")
    print(f"[3 multi] decode_batch_crops on [{names}], the crop cell's "
          f"B=256 mix of 4:2:0 and 4:4:4, bfloat16-normalised: == one "
          f"device; launches rgb={counts['rgb']} raster={counts['raster']}",
          flush=True)

    one_rates, one_rep = engine_mps(torch, DecodeEngine(device=dev), paths)
    two_rates, two_rep = engine_mps(torch, DecodeEngine(device=two), paths)
    print(f"[3 multi] engine e2e on the corpus, BMPs written, MP/s: one "
          f"device {', '.join(f'{r:.1f}' for r in one_rates)} (median "
          f"{statistics.median(one_rates):.1f}); [{names}] "
          f"{', '.join(f'{r:.1f}' for r in two_rates)} (median "
          f"{statistics.median(two_rates):.1f}). d2h / write seconds of the "
          f"last run: "
          f"{one_rep.timers.snapshot()['d2h'][0]:.3f} / "
          f"{one_rep.timers.snapshot()['write'][0]:.3f} against "
          f"{two_rep.timers.snapshot()['d2h'][0]:.3f} / "
          f"{two_rep.timers.snapshot()['write'][0]:.3f} | {card}", flush=True)

    def batch_rate(devices) -> float:
        t0 = time.monotonic()
        n = 0
        for out, headers in iter_decode_batches(
                ([blobs[i] for i in idx] for idx in order), device=devices):
            n += len(headers)
        torch.cuda.synchronize()
        return n / (time.monotonic() - t0)

    rates = {"one": [], "two": []}
    for _ in range(3):
        rates["one"].append(batch_rate(dev))
        rates["two"].append(batch_rate(two))
    print(f"[3 multi] iter_decode_batches {len(order)} x B=256, scale 1 "
          f"uint8, images/s: one device "
          f"{', '.join(f'{r:.0f}' for r in rates['one'])} (median "
          f"{statistics.median(rates['one']):.0f}); [{names}] "
          f"{', '.join(f'{r:.0f}' for r in rates['two'])} (median "
          f"{statistics.median(rates['two']):.0f}), in turns | {card}",
          flush=True)
    if len(set(two)) == 1:
        concat_costs(torch, dev, card)
    scaling_ranks(devices, root, tmp, card)
    print(f"[3 multi] phase wall {time.monotonic() - t_phase:.1f} s",
          flush=True)


# --- phases [3 fuzz] and [3 host] ---------------------------------------------

# The card's fuzz campaign: every check of the tool is drawn with this seed
# and count (the draws do not depend on the device or on PIL).
FUZZ_SEED = 20261017
FUZZ_ITERATIONS = 1000
FUZZ_KERNELS = ("rgb", "ycbcr", "rgb_scaled", "raster")
ENTROPY_REPS = 5
SRC_AB_REPS = 15
# A null A/B (the port's entropy.cpp against itself) that reads further
# from 1 than this: interleaved timing cannot resolve a host change here.
NULL_AB_LIMIT = 0.10
SANITIZER_ITERS = 40
PGO_REPS = 5


def phase_fuzz(dev) -> None:
    """``tools.fuzz.run`` in this process on the card (the tool sets the
    launch counts to 0 at its start and reads them at its end): no
    mismatch, valid inputs decoded, every check drawn, and the decode
    kernels and the raster epilogue launched, no plain version on the
    card."""
    from pim_jpeg_decoder_tpu_torch.tools import fuzz

    stats = fuzz.run(FUZZ_ITERATIONS, FUZZ_SEED, device=dev)
    print(f"[3 fuzz] {json.dumps(stats)}", flush=True)
    launches = stats["launches"]
    problems = []
    if not stats["ok"]:
        problems.append(f"{stats['mismatch']} mismatches, first "
                        f"{stats['failures'][:5]}")
    if stats["valid"] < 1:
        problems.append("no valid input decoded")
    undrawn = [k for k in fuzz.TRIAL_COUNTERS if stats[k] < 1]
    if undrawn:
        problems.append(f"checks never drawn: {undrawn}")
    idle = [k for k in FUZZ_KERNELS if launches[k] < 1]
    if idle or launches["plain_on_cuda"]:
        problems.append(f"kernels not launched: {idle}, plain versions on "
                        f"the card: {launches['plain_on_cuda']}")
    if problems:
        fail("[3 fuzz] " + "; ".join(problems))
    print(f"[3 fuzz] tools.fuzz seed {FUZZ_SEED}, {FUZZ_ITERATIONS} "
          f"iterations on {stats['device']}: 0 mismatches in "
          f"{stats['seconds']} s; valid {stats['valid']}, corrupt inputs "
          f"{stats['corrupt_ok']} refused and {stats['corrupt_decoded']} "
          f"decoded; " + ", ".join(f"{k} {stats[k]}"
                                   for k in fuzz.TRIAL_COUNTERS)
          + "; launches " + " ".join(f"{k}={launches[k]}"
                                     for k in FUZZ_KERNELS), flush=True)


def phase_host(root: str) -> None:
    """The host-decode tools over the port's ``entropy.cpp`` on this
    machine's host (no card): the entropy-decode rate of the port's host
    corpus (and, where PIL imports, of its progressive re-encodes, with
    ``tools.prog_profile``'s chain bound), a null ``src_ab`` (the source
    against itself: its correctness gate, and variant/base within
    ``NULL_AB_LIMIT``), the ASan and UBSan drives, each in its own
    process (the drive re-executes itself with the sanitizer runtime
    preloaded), and ``tools.pgo_ab`` (its profile trained and used; the
    ratio is printed, not held)."""
    import io

    from pim_jpeg_decoder_tpu_torch.tools import (entropy_bench, pgo_ab,
                                                  prog_profile, src_ab)
    from pim_jpeg_decoder_tpu_torch.tools.host_corpus import pil_image

    t0 = time.monotonic()
    image = pil_image()
    prog = image is not None
    print(f"[3 host] PIL {image.__version__ if prog else 'not installed'} "
          f"on this machine", flush=True)
    r = entropy_bench.run(reps=ENTROPY_REPS, prog=prog)
    corpus = (f"{r['images']} images, {r['mp_per_pass']:.1f} MP a pass, "
              f"one thread, host_cores={r['host_cores']}")
    for key in ("host_entropy_mps", "host_progressive_mps",
                "host_progressive_chains_mps"):
        if key in r:
            band = r[key]
            print(f"[3 host] tools.entropy_bench: {key} median="
                  f"{band['median']:.1f} min={band['min']:.1f} max="
                  f"{band['max']:.1f} MP/s over {r['reps']} reps ({corpus})",
                  flush=True)
            corpus = "the first 12 images as SOF2"
    if prog:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = prog_profile.main([str(ENTROPY_REPS)])
        lines = out.getvalue().splitlines()
        if rc != 0:
            fail(f"[3 host] tools.prog_profile exited {rc}")
        for ln in lines[:2] + [ln for ln in lines if "bound" in ln
                               or "overhead:" in ln]:
            print(f"[3 host] tools.prog_profile {ENTROPY_REPS}: {ln}",
                  flush=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ab = src_ab.run(src_ab.SRC, reps=SRC_AB_REPS)
    base, var = sorted(ab["base"]), sorted(ab["variant"])
    print(f"[3 host] tools.src_ab (entropy.cpp against itself, "
          f"{SRC_AB_REPS} interleaved reps): {out.getvalue().splitlines()[-1]}"
          f"; base median {statistics.median(base):.1f} MP/s (min "
          f"{base[0]:.1f}, max {base[-1]:.1f}), variant median "
          f"{statistics.median(var):.1f} (min {var[0]:.1f}, max "
          f"{var[-1]:.1f}), variant/base {ab['ratio']:.4f}", flush=True)
    if abs(ab["ratio"] - 1) > NULL_AB_LIMIT:
        fail(f"[3 host] null src_ab reads {ab['ratio']:.4f}, outside "
             f"1 +- {NULL_AB_LIMIT}")
    for flags in ([], ["--ubsan"]):
        cmd = [sys.executable, "-m",
               "pim_jpeg_decoder_tpu_torch.tools.asan_drive", "0",
               str(SANITIZER_ITERS), *flags]
        t1 = time.monotonic()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=900,
                              env=dict(os.environ, PYTHONPATH=root))
        last = proc.stdout.strip().splitlines()[-1:] or [""]
        if proc.returncode != 0 or not last[0].endswith(" decodes"):
            fail(f"[3 host] tools.asan_drive {' '.join(cmd[3:])} exited "
                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        print(f"[3 host] tools.asan_drive {' '.join(cmd[3:])}: {last[0]} "
              f"in {time.monotonic() - t1:.1f} s", flush=True)
    out = io.StringIO()
    t1 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = pgo_ab.main([str(PGO_REPS)])
    lines = out.getvalue().splitlines()
    if rc != 0:
        fail(f"[3 host] tools.pgo_ab exited {rc}: {lines[-3:]}")
    for ln in [ln for ln in lines if ln.startswith("profile:")] + lines[-3:]:
        print(f"[3 host] tools.pgo_ab {PGO_REPS}: {ln}", flush=True)
    print(f"[3 host] tools.pgo_ab in {time.monotonic() - t1:.1f} s (three "
          f"g++ builds and a training process)", flush=True)
    if not prog:
        print("[3 host] not run here: tools.entropy_bench --prog and "
              "tools.prog_profile (the progressive corpus needs PIL, which "
              "this machine does not have)", flush=True)
    print(f"[3 host] phase wall {time.monotonic() - t0:.1f} s", flush=True)


def phase_tool():
    """``python -m pim_jpeg_decoder_tpu_torch.tools.kernel_opt`` in this
    process, with the launch counts set to 0 just before it and read just
    after: every variant bit-exact, each kernel_opt kernel launched, no
    plain version on the card.  Returns the tool's JSON record and the
    counts."""
    import io

    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        launch_counts, reset_launch_counts)
    from pim_jpeg_decoder_tpu_torch.tools import kernel_opt

    out = io.StringIO()
    reset_launch_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rc = kernel_opt.main([])
    wall = time.monotonic() - t0
    counts = launch_counts()
    if rc != 0:
        fail(f"tools.kernel_opt exited {rc}")
    record = json.loads(out.getvalue().splitlines()[-1])
    if sorted(record) != sorted(kernel_opt.VARIANTS):
        fail(f"tools.kernel_opt ran {sorted(record)}")
    inexact = [n for n, r in record.items() if r["bit_exact"] is not True]
    if inexact:
        fail(f"tools.kernel_opt: not bit-exact: {inexact}")
    if (min(counts[k] for k in KERNEL_OPT_COUNTERS) < 1
            or counts["plain_on_cuda"]):
        fail(f"tools.kernel_opt did not go through the kernel_opt kernels "
             f"alone: {counts}")
    print(f"[3 slice] tools.kernel_opt (4:2:0, M={kernel_opt.M}, Q="
          f"{kernel_opt.Q}): exit 0 in {wall:.1f} s; {len(record)} variants "
          f"({', '.join(record)}) bit-exact; launches "
          + " ".join(f"{k}={counts[k]}" for k in (
              "rgb", *KERNEL_OPT_COUNTERS, "plain_on_cuda")),
          flush=True)
    return record, counts


def phase_ab_tools() -> dict:
    """``tools.mxu_idct_ab`` and ``tools.vlc_bench`` in this process, each
    with the launch counts set to 0 just before it and read just after:
    every IDCT variant within ``MXU_TOLERANCE`` of its plain version (the
    butterfly equal), the VLC kernel equal to its plain version, each
    kernel launched, no plain version on the card.  Returns the counts of
    the new kernels."""
    import io

    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        launch_counts, reset_launch_counts)
    from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab, vlc_bench

    tolerance = {"butterfly": (0, 0.0), **MXU_TOLERANCE}
    found = {}
    # The IDCT tool in two runs, so that mxu2pass with pieces 2 (the same
    # wrapper and counter as pieces 1) has a launch count of its own.
    idct_rest = [v for v in mxu_idct_ab.VARIANTS if v != "mxu2pass4"]
    records = {}
    for tool, argv, counters in (
            (mxu_idct_ab, idct_rest, {"idct": "idct", "mxu2pass": "mxu2pass",
                                      "mxu64": "mxu64"}),
            (mxu_idct_ab, ["mxu2pass4"], {"mxu2pass4": "mxu2pass"}),
            (vlc_bench, [], {"vlc": "vlc"})):
        name = tool.__name__.rsplit(".", 1)[-1]
        out = io.StringIO()
        reset_launch_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            rc = tool.main(argv)
        wall = time.monotonic() - t0
        counts = launch_counts()
        if rc != 0:
            fail(f"tools.{name} {' '.join(argv)} exited {rc}")
        record = json.loads(out.getvalue().splitlines()[-1])
        if (min(counts[c] for c in counters.values()) < 1
                or counts["plain_on_cuda"]):
            fail(f"tools.{name} {' '.join(argv)} did not go through its "
                 f"kernels alone: {counts}")
        if tool is mxu_idct_ab:
            records.update(record)
            for variant, r in record.items():
                tol, share_tol = tolerance[variant]
                if r["max_abs_diff"] > tol or r["share_diff"] > share_tol:
                    fail(f"tools.mxu_idct_ab: {variant} outside its "
                         f"tolerance: {r}")
        found.update({k: counts[c] for k, c in counters.items()
                      if k != "idct"})
        print(f"[3 slice] tools.{name} {' '.join(argv) or '(all)'}: exit 0 "
              f"in {wall:.1f} s; launches "
              + " ".join(f"{k}={counts[c]}" for k, c in counters.items())
              + f" plain_on_cuda={counts['plain_on_cuda']}; record "
              f"{json.dumps(record)}", flush=True)
    if sorted(records) != sorted(mxu_idct_ab.VARIANTS):
        fail(f"tools.mxu_idct_ab ran {sorted(records)}")
    return found


# --- phase 4 -----------------------------------------------------------------

def time_band(fn, bufs, runs: int = 30):
    """(median, min, max) ms per launch from the per-launch samples of
    ``utils/devbench.seconds_per_launch``."""
    from pim_jpeg_decoder_tpu_torch.utils.devbench import seconds_per_launch

    ms = sorted(t * 1e3 for t in seconds_per_launch(fn, bufs, runs=runs,
                                                     samples=True))
    return statistics.median(ms), ms[0], ms[-1]


def us_band(band) -> str:
    med, lo, hi = band
    return f"{med * 1e3:.1f} us (min {lo * 1e3:.1f}, max {hi * 1e3:.1f})"


def floor_note(floor_us: float, prod_us: float, what: str) -> str:
    """rgb_kernel's share of the floor's GB/s (the floor's time over
    rgb_kernel's), and a finding where rgb_kernel is the faster."""
    share = 100 * floor_us / prod_us
    if share <= 100:
        return f"{share:.1f}%"
    return (f"{share:.1f}% -- FINDING: rgb_kernel beats the floor of its own "
            f"pattern at {what}")


def floor_shares(record: dict, card: str) -> None:
    """rgb_kernel against the memory floor of ``tools.kernel_opt``, from
    the tool's one run (same call, same rotation): the floor's time over
    rgb_kernel's is rgb_kernel's GB/s as a share of the floor's.  The
    floor (``memfloor_kernel``) moves the same bytes in the pattern of the
    tiled decode kernels (a 32-MCU tile copied into shared memory, 16-byte
    row stores) with the decode taken out, so a share over 100% is a
    finding about the floor."""
    from pim_jpeg_decoder_tpu_torch.tools import kernel_opt

    print(f"[4 times] tools.kernel_opt record: {json.dumps(record)} | {card}",
          flush=True)
    m, mode = kernel_opt.M, kernel_opt.MODE
    out_mb = 3 * mode.luma_slots * 64 * m / 1e6
    for wire, nbytes, floor, prod in (("int16", 2, "memfloor", "prod"),
                                      ("int8", 1, "memfloor_i8", "prod_i8")):
        mb = m * mode.g * 64 * nbytes / 1e6 + out_mb
        f_us, p_us = record[floor]["us"], record[prod]["us"]
        print(f"[4 times] rgb_kernel vs the tiled-pattern memory floor, "
              f"4:2:0 M={m} {wire} "
              f"wire ({mb:.1f} MB): floor {f_us} us ({mb / f_us * 1e3:.0f} "
              f"GB/s), rgb_kernel {p_us} us ({mb / p_us * 1e3:.0f} GB/s): "
              f"{floor_note(f_us, p_us, f'M={m} {wire}')} of the floor's "
              f"GB/s | {card}", flush=True)


def floor_sweep(torch, card: str) -> None:
    """``tools.kernel_opt.sweep()``: every variant at each launch size of
    ``SWEEP_M``, each bit-exact, with rgb_kernel's share of the
    tiled-pattern floor; then whether the floor is the faster at every
    size on both wires (the floor property), each size where it is not
    printed as a finding with the margin."""
    from pim_jpeg_decoder_tpu_torch.tools import kernel_opt

    t0 = time.monotonic()
    table = kernel_opt.sweep()
    torch.cuda.empty_cache()
    mode = kernel_opt.MODE
    misses = []
    for m, record in table.items():
        inexact = [n for n, r in record.items() if r["bit_exact"] is not True]
        if inexact:
            fail(f"tools.kernel_opt sweep at M={m}: not bit-exact: {inexact}")
        us = {n: r["us"] for n, r in record.items()}
        mb = m * (mode.g * 64 * 2 + 3 * mode.luma_slots * 64) / 1e6
        misses += [f"M={m} {wire}: floor {us[f]} us, rgb_kernel {us[p]} us "
                   f"(+{100 * (us[f] / us[p] - 1):.1f}%)"
                   for wire, f, p in (("int16", "memfloor", "prod"),
                                      ("int8", "memfloor_i8", "prod_i8"))
                   if us[f] > us[p]]
        print(f"[4 times] kernel_opt sweep 4:2:0 M={m} (floor: "
              f"{-(-m // 32)} tiles of 32), us int16 [int8]: floor "
              f"{us['memfloor']} [{us['memfloor_i8']}] "
              f"({mb / us['memfloor'] * 1e3:.0f} GB/s of {mb:.1f} MB int16), "
              f"rgb_kernel {us['prod']} [{us['prod_i8']}], truerez "
              f"{us['chroma_truerez']}, stacked {us['stacked']}; rgb_kernel "
              f"at {floor_note(us['memfloor'], us['prod'], f'M={m} int16')} "
              f"[{floor_note(us['memfloor_i8'], us['prod_i8'], f'M={m} int8')}]"
              f" of the floor's GB/s | {card}", flush=True)
    print(f"[4 times] kernel_opt sweep: {len(table)} launch sizes, every "
          f"variant bit-exact, in {time.monotonic() - t0:.1f} s; the floor "
          + ("is no slower than rgb_kernel at every size on both wires"
             if not misses else "FINDING: slower than rgb_kernel at "
             + "; ".join(misses)) + f" | {card}", flush=True)


def phase_times(torch, dev, card: str, paths) -> dict:
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, decode_mcus_reference,
        qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.ops.kernel_variants import KERNELS
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
    from pim_jpeg_decoder_tpu_torch.tools.stage_profile import profile

    mode = S.mode_for((2, 2, 3))
    m = 16384
    rng = np.random.default_rng(SEED + 2)
    times = {}
    for wire in (np.int8, np.int16):
        bufs = []
        for _ in range(10):   # 10 x (6.3 or 12.6) MB of input: past the L2
            c, qi, qp = synthetic_batch(mode, m, wire, rng, extreme=False)
            bufs.append((coeffs_to_device(c, dev),
                         torch.from_numpy(qi).to(dev),
                         qpool_to_device(qp, dev)))
        mb_in = bufs[0][0].numel() * bufs[0][0].element_size() / 1e6
        cases = {name: (lambda b, yc=name == "ycbcr": decode_mcus(
                            *b, mode, raw=True, ycbcr=yc),
                        lambda b, yc=name == "ycbcr": decode_mcus_reference(
                            *b, mode, raw=True, ycbcr=yc))
                 for name in ("rgb", "ycbcr")}
        for name in KERNEL_OPT_COUNTERS:
            kernel, plain = KERNELS[name]
            cases[name] = (lambda b, f=kernel: f(*b, mode),
                           lambda b, f=plain: f(*b, mode))
        # qidx and the quantizer pool, read once.
        side = (bufs[0][1].numel() + bufs[0][2].numel()) * 4
        decode_ops = m * mode.g * (IDCT_BLOCK_OPS + DEQUANT_BLOCK_OPS)
        rgb_ops = decode_ops + m * mode.luma_slots * 64 * COLOR_PIXEL_OPS
        ops = {"rgb": rgb_ops, "truerez": rgb_ops, "stacked": rgb_ops,
               "ycbcr": decode_ops + m * mode.g * 64,   # + 128 level shift
               "memfloor": m * mode.luma_slots * 64 * 2}
        for name, (kernel, plain) in cases.items():
            k = time_band(kernel, bufs)
            p = time_band(plain, bufs, runs=20)
            wname = np.dtype(wire).name
            mb_out = (mode.g if name == "ycbcr"
                      else 3 * mode.luma_slots) * 64 * m / 1e6
            b = bound((mb_in + mb_out) * 1e6 + side, ops[name])
            if wire is np.int8:
                times[name] = timing(k, p, b)
            print(f"[4 times] {name} kernel 4:2:0 M={m} {wname} wire: "
                  f"{us_band(k)}/launch ({(mb_in + mb_out) / k[0]:.0f} GB/s "
                  f"of {mb_in + mb_out:.1f} MB; {bound_note(b)}); plain "
                  f"PyTorch {us_band(p)}; 30/20 launches over 10 rotating "
                  f"inputs | {card}", flush=True)
        if wire is np.int16:
            stage_times(torch, mode, bufs, times, card)
        del bufs
    torch.cuda.empty_cache()
    record = profile(dev)
    print(f"[4 times] tools/stage_profile (4:2:0, M={m}, int16, Q=16): "
          f"{json.dumps(record)} | {card}", flush=True)

    engine = DecodeEngine(device=dev)
    engine.decode_paths(paths, write=False)        # warm: pools, allocator
    mps, walls = [], []
    for _ in range(3):
        t0 = time.monotonic()
        report = engine.decode_paths(paths, write=True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if report.ok_count != len(paths):
            fail("engine failed files during the timed runs")
        walls.append(wall)
        mps.append(report.total_megapixels / wall)
    stages = report.timers.snapshot()
    print(f"[4 times] engine e2e on the corpus ({len(paths)} JPEGs, "
          f"{report.total_megapixels:.2f} MP, BMPs written): MP/s "
          f"{', '.join(f'{x:.1f}' for x in mps)} (median "
          f"{statistics.median(mps):.1f}); host stage seconds of the last "
          f"run: " + ", ".join(f"{k} {v[0]:.3f}" for k, v in stages.items())
          + f" | {card}", flush=True)
    busy = device_busy(torch, lambda: engine.decode_paths(paths, write=True),
                       "engine run")
    print(f"[4 times] {busy} | {card}", flush=True)
    return times


def decode_bound(mode, m: int, wire_bytes: int, name: str):
    """The bound of one full-scale decode launch (``name`` rgb or ycbcr):
    the wire in, qidx and a Q=16 pool once, the output out; the spec's
    integer operations (gray RGB: a level shift a pixel)."""
    nbytes = (m * mode.g * 64 * wire_bytes + m * 4 + 16 * mode.g * 64 * 4
              + (mode.g if name == "ycbcr" else 3 * mode.luma_slots) * 64 * m)
    ops = m * mode.g * (IDCT_BLOCK_OPS + DEQUANT_BLOCK_OPS)
    if name == "ycbcr":
        ops += m * mode.g * 64
    else:
        ops += m * mode.luma_slots * 64 * (COLOR_PIXEL_OPS if mode.ncomp == 3
                                           else 1)
    return bound(nbytes, ops)


def tile_times(torch, dev, card: str) -> dict:
    """rgb_kernel and ycbcr_kernel where the main path runs them: every
    mode at M=16,384 on the int8 wire, and 4:2:0 at M=196,608 (a B=256
    batch) on both wires; each against its bound.  Returns the M=16,384
    int8 medians by (kernel, mode name)."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    rng = np.random.default_rng(SEED + 5)
    geoms = [(key, 16384, np.int8) for key in sorted(S.MODES)]
    geoms += [((2, 2, 3), 196608, w) for w in (np.int8, np.int16)]
    medians = {}
    for key, m, wire in geoms:
        mode = S.mode_for(key)
        wb = np.dtype(wire).itemsize
        bufs = []
        for _ in range(max(2, rotation_count(m * mode.g * 64 * wb, dev))):
            c, qi, qp = synthetic_batch(mode, m, wire, rng, extreme=False)
            bufs.append((coeffs_to_device(c, dev),
                         torch.from_numpy(qi).to(dev),
                         qpool_to_device(qp, dev)))
        for name in ("rgb", "ycbcr"):
            k = time_band(lambda b, yc=name == "ycbcr": decode_mcus(
                *b, mode, raw=True, ycbcr=yc), bufs)
            b = decode_bound(mode, m, wb, name)
            if m == 16384:
                medians[(name, mode.name)] = k[0]
            print(f"[4 times] {name}_kernel {mode.name} M={m} "
                  f"{np.dtype(wire).name}: {us_band(k)}/launch; "
                  f"{bound_note(b)}, {100 * b[0] / k[0]:.1f}% of the bound; "
                  f"30 launches over {len(bufs)} rotating inputs | {card}",
                  flush=True)
        del bufs
        torch.cuda.empty_cache()
    return medians


def scaled_stacked_times(torch, dev, card: str) -> None:
    """rgb_scaled_kernel at 4:2:0 scale 2, 4 and 8, and rgb_stacked_kernel
    beside rgb_kernel on the same inputs, at M=16,384 and 196,608 on both
    wires (Laplace(0, 6) coefficients, Q=16, rotated past the L2); each
    against its bound and its share (the scaled kernel's recounted bound,
    the matrix-form count beside it)."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.ops.kernel_variants import rgb_stacked
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    rng = np.random.default_rng(SEED + 6)
    mode = S.mode_for((2, 2, 3))
    for m in (16384, 196608):
        for wire in (np.int8, np.int16):
            wb = np.dtype(wire).itemsize
            bufs = []
            for _ in range(max(2, rotation_count(m * mode.g * 64 * wb, dev))):
                c, qi, qp = synthetic_batch(mode, m, wire, rng, extreme=False)
                bufs.append((coeffs_to_device(c, dev),
                             torch.from_numpy(qi).to(dev),
                             qpool_to_device(qp, dev)))
            what = f"4:2:0 M={m} {np.dtype(wire).name}"
            for scale in (2, 4, 8):
                k = time_band(lambda b: decode_mcus(
                    *b, mode, raw=True, scale=scale), bufs)
                b = scaled_bound(mode, scale, m, wb)
                old = scaled_bound(mode, scale, m, wb, matrix_form=True)
                print(f"[4 times] rgb_scaled_kernel {what} scale {scale}: "
                      f"{us_band(k)}/launch; {bound_note(b)}, "
                      f"{100 * b[0] / k[0]:.1f}% of the bound (matrix-form "
                      f"{bound_note(old)}, {100 * old[0] / k[0]:.1f}%); 30 "
                      f"launches over {len(bufs)} rotating inputs | {card}",
                      flush=True)
            st = time_band(lambda b: rgb_stacked(*b, mode), bufs)
            rgb = time_band(lambda b: decode_mcus(*b, mode, raw=True), bufs)
            b = decode_bound(mode, m, wb, "rgb")
            print(f"[4 times] rgb_stacked_kernel {what}: {us_band(st)}/launch,"
                  f" {100 * b[0] / st[0]:.1f}% of the {bound_note(b)}; "
                  f"rgb_kernel on the same inputs {us_band(rgb)}, "
                  f"{100 * b[0] / rgb[0]:.1f}%: stacked/rgb "
                  f"{st[0] / rgb[0]:.3f} | {card}", flush=True)
            del bufs
            torch.cuda.empty_cache()


# Opcode roots of the integer-ALU pipe, the FMA pipe (IMAD) and memory.
SASS_ALU = ("IADD3", "LOP3", "SHF", "VIMNMX", "IMNMX", "SEL", "LEA", "PRMT",
            "ISETP", "VIADD", "IABS", "SGXT")
SASS_MEM = ("LDS", "STS", "LDG", "STG", "LDGSTS", "LDC")


def sass_counts(lib_path: str) -> dict:
    """``{mangled kernel name: Counter of opcode roots}`` from
    ``cuobjdump -sass`` of the built library (NOPs left out)."""
    from collections import Counter

    from pim_jpeg_decoder_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"cuobjdump -sass failed: {proc.stderr[-2000:]}")
    counts = {}
    for body in re.split(r"\n\s+Function : ", proc.stdout)[1:]:
        name, _, code = body.partition("\n")
        ops = re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", code)
        counts[name.strip()] = Counter(o for o in ops if o != "NOP")
    return counts


def tile_resources(torch, card: str, medians: dict, sass: dict) -> None:
    """Registers (ptxas, ``nvcc.log``), dynamic shared memory and blocks an
    SM holds (the occupancy calculator) of each full-scale tile kernel,
    and its SASS: instructions, of which integer-ALU, IMAD and memory, per
    MCU (every loop is unrolled, so a warp runs each instruction at most
    once a tile: TILE_THREADS / 32 warps over TILE_MCUS MCUs), and the
    time those would take at M=16,384 issued at one warp instruction a
    clock on each of an SM's 4 schedulers at the maximum SM clock; the
    same SASS accounting of the scaled kernel at 4:2:0 scale 2."""
    from pim_jpeg_decoder_tpu_torch.ops import _build
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        TILE_MCUS, TILE_THREADS, tile_occupancy)

    with open(os.path.join(_build.build_dir(), "nvcc.log")) as f:
        log = f.read()
    regs = dict(re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                           r"registers", log, flags=re.S))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    pattern = re.compile(r"\d+(rgb|ycbcr)_kernelI([as])((?:Li\d+E)+)Lb1E")
    for mangled, ops in sorted(sass.items()):
        found = pattern.search(mangled)
        if not found:
            continue
        name, wire = found.group(1), 1 if found.group(2) == "a" else 2
        ints = [int(i) for i in re.findall(r"Li(\d+)E", found.group(3))]
        if name == "rgb":
            key = (ints[0], ints[1], ints[2])
        else:   # ycbcr_kernel<T, G>: the first mode of that block count
            key = next(k for k in sorted(S.MODES)
                       if S.mode_for(k).g == ints[0])
        mode = S.mode_for(key)
        blocks, smem = tile_occupancy(wire, mode, name == "ycbcr")
        total = sum(ops.values())
        per_mcu = total * (TILE_THREADS // 32) / TILE_MCUS
        alu = sum(ops[o] for o in SASS_ALU)
        mem = sum(ops[o] for o in SASS_MEM)
        issue_us = per_mcu * 16384 / (4 * sms * clock) * 1e6
        measured = medians.get((name, mode.name)) if wire == 1 else None
        label = mode.name if name == "rgb" or mode.g != 4 else "4:2:2/4:4:0"
        print(f"[4 times] {name}_kernel {label} int{8 * wire} (16-byte "
              f"stores): {regs.get(mangled, '?')} registers, {smem} B "
              f"dynamic shared memory, {blocks} blocks/SM "
              f"({blocks * TILE_THREADS // 32} warps); SASS {total} "
              f"instructions ({alu} integer ALU, {ops['IMAD']} IMAD, {mem} "
              f"memory), {per_mcu:.1f} warp instructions an MCU: "
              f"{issue_us:.2f} us of issue at M=16384 ({sms} SMs x 4 "
              f"schedulers, {clock / 1e9:.3f} GHz)"
              + (f" vs {measured * 1e3:.2f} us measured" if measured
                 else "") + f" | {card}", flush=True)
    # The scaled kernel at 4:2:0 scale 2 (16-byte stores), likewise: every
    # round is unrolled and each warp runs it, so a warp runs each
    # instruction at most once a tile.
    scaled = re.compile(r"rgb_scaled_kernelI([as])Li2ELi2ELi3ELi4ELb1E")
    for mangled, ops in sorted(sass.items()):
        found = scaled.search(mangled)
        if not found:
            continue
        total = sum(ops.values())
        per_mcu = total * (TILE_THREADS // 32) / TILE_MCUS
        issue = [per_mcu * m / (4 * sms * clock) * 1e6 for m in (16384,
                                                                 196608)]
        print(f"[4 times] rgb_scaled_kernel 4:2:0 scale 2 "
              f"int{8 if found.group(1) == 'a' else 16} (16-byte stores): "
              f"SASS {total} instructions ({sum(ops[o] for o in SASS_ALU)} "
              f"integer ALU, {ops['IMAD']} IMAD, "
              f"{sum(ops[o] for o in SASS_MEM)} memory), {per_mcu:.1f} warp "
              f"instructions an MCU: {issue[0]:.2f} us of issue at M=16384, "
              f"{issue[1]:.2f} us at M=196608 | {card}", flush=True)


def redesign_resources(torch, card: str, sass: dict) -> None:
    """Registers (ptxas, ``nvcc.log``) of every instantiation of the banded
    raster epilogue, the dequantize, IDCT and colour stage kernels, the
    scaled decode kernel, the stacked and truerez kernels, the memory
    floor, mxu2pass and mxu64, with the shared memory and blocks an SM
    holds (the occupancy calculator) of the 4:2:0 epilogue and dequantize
    ones that phase 4 times and of every IDCT, colour, scaled, stacked,
    truerez, floor, mxu2pass and mxu64 one (the IDCT kernel and mxu64 have
    one instantiation; the colour kernel one a mode and store form; the
    scaled kernel one a mode, wire, scale and store form, the stacked and
    truerez kernels one a colour mode, wire and store form, the floor one
    a luma slot count (4:2:2 and 4:4:0 share one), wire and store form,
    mxu2pass one a ``pieces``), and the SASS instructions of the 4:2:0
    truerez and floor ones and of mxu2pass and mxu64 (``sass``:
    ``sass_counts``).
    Their layouts' bank and alignment claims are static_asserts in the CUDA
    source, so a build that passes holds them."""
    from pim_jpeg_decoder_tpu_torch.ops import _build
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        raster_occupancy, tile_occupancy)
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        TILE_MCUS, TILE_THREADS)
    from pim_jpeg_decoder_tpu_torch.ops.kernel_variants import (
        memfloor_occupancy, stacked_occupancy, truerez_occupancy)
    from pim_jpeg_decoder_tpu_torch.ops.mxu_idct import (
        MXU2PASS_TILE, MXU64_PAIR, MXU64_TILE, MXU64_UNITS, TILES_PER_WARP,
        mxu2pass_occupancy, mxu64_occupancy)
    from pim_jpeg_decoder_tpu_torch.ops.stage_kernels import (
        color_occupancy, dequant_occupancy, idct_occupancy)

    with open(os.path.join(_build.build_dir(), "nvcc.log")) as f:
        log = f.read()
    entries = re.findall(r"Compiling entry function '(\S+)'.*?Used (\d+) "
                         r"registers", log, flags=re.S)
    out_types = {"h": None, "f": torch.float32,
                 "13__nv_bfloat16": torch.bfloat16, "6__half": torch.float16}
    epi = re.compile(r"raster_epilogue_kernelI(h|f|13__nv_bfloat16|6__half)"
                     r"Li(\d+)ELi(\d+)ELb([01])E")
    deq = re.compile(r"dequant_stage_kernelI([as])Li(\d+)E")
    color = re.compile(r"color_stage_kernelILi(\d)ELi(\d)ELi(\d)ELb([01])E")
    scaled = re.compile(r"rgb_scaled_kernelI([as])Li(\d)ELi(\d)ELi(\d)ELi(\d)E"
                        r"Lb([01])E")
    stacked = re.compile(r"rgb_stacked_kernelI([as])Li(\d)ELi(\d)ELb([01])E")
    truerez = re.compile(r"rgb_truerez_kernelI([as])Li(\d)ELi(\d)ELb([01])E")
    mxu2pass = re.compile(r"mxu2pass_kernelILi([12])E")
    floor = re.compile(r"memfloor_kernelI([as])Li(\d)ELb([01])E")
    mode = S.mode_for((2, 2, 3))
    found = {"epilogue": [], "dequant": [], "idct": [], "color": [],
             "scaled": [], "stacked": [], "truerez": [], "mxu2pass": [],
             "memfloor": [], "mxu64": []}
    clock = max_sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for mangled, regs in entries:
        hit = epi.search(mangled)
        if hit:
            n, h = int(hit.group(2)), int(hit.group(3))
            found["epilogue"].append(int(regs))
            if h == mode.h and n in (8, 4):
                dtype = out_types[hit.group(1)]
                row_form = hit.group(4) == "1"
                blocks, smem = raster_occupancy(mode, 8 // n, dtype, row_form)
                print(f"[4 times] raster_epilogue_kernel 4:2:0 scale "
                      f"{8 // n} -> {dtype or 'uint8'} "
                      f"({'row' if row_form else 'banded'} form): {regs} "
                      f"registers, {smem} B dynamic shared memory, {blocks} "
                      f"blocks/SM ({blocks * 8} warps) | {card}", flush=True)
        hit = deq.search(mangled)
        if hit:
            found["dequant"].append(int(regs))
            if int(hit.group(2)) == mode.g:
                wire = 1 if hit.group(1) == "a" else 2
                blocks = dequant_occupancy(wire, mode)
                print(f"[4 times] dequant_stage_kernel 4:2:0 int{8 * wire}: "
                      f"{regs} registers, no shared memory, {blocks} "
                      f"blocks/SM ({blocks * 8} warps) | {card}", flush=True)
        if "idct_stage_kernel" in mangled:
            found["idct"].append(int(regs))
            blocks, smem = idct_occupancy()
            print(f"[4 times] idct_stage_kernel: {regs} registers, {smem} B "
                  f"static shared memory, {blocks} blocks/SM "
                  f"({blocks * 8} warps) | {card}", flush=True)
        hit = color.search(mangled)
        if hit:
            found["color"].append(int(regs))
            key = tuple(int(hit.group(i)) for i in (1, 2, 3))
            vec8 = hit.group(4) == "1"
            blocks, smem = color_occupancy(S.mode_for(key), vec8)
            print(f"[4 times] color_stage_kernel {S.mode_for(key).name} "
                  f"({'8-byte' if vec8 else 'byte'} stores): {regs} "
                  f"registers, {smem} B static shared memory, {blocks} "
                  f"blocks/SM ({blocks * 8} warps) | {card}", flush=True)
        hit = mxu2pass.search(mangled)
        if hit:
            pieces = int(hit.group(1))
            blocks, smem, grid = mxu2pass_occupancy(pieces, 98304)
            ops = sass[mangled]
            total = sum(ops.values())
            found["mxu2pass"].append((int(regs), blocks))
            per_block = total / (MXU2PASS_TILE * TILES_PER_WARP[pieces])
            print(f"[4 times] mxu2pass_kernel<{pieces}>: {regs} registers, "
                  f"{smem} B static shared memory, {blocks} blocks/SM "
                  f"({4 * blocks} warps), grid {grid} at 98,304 blocks; SASS "
                  f"{total} instructions ({ops['HMMA']} HMMA, "
                  f"{sum(ops[o] for o in SASS_MEM)} memory, {ops['BRA']} "
                  f"branches), at most {per_block:.1f} warp instructions a "
                  f"block (a warp runs each at most once for its "
                  f"{MXU2PASS_TILE * TILES_PER_WARP[pieces]} blocks): "
                  f"{per_block * 98304 / (4 * sms * clock) * 1e6:.2f} us of "
                  f"issue at M=16384 | {card}", flush=True)
        if "mxu64_kernel" in mangled:
            blocks, smem, grid = mxu64_occupancy(98304)
            ops = sass[mangled]
            total = sum(ops.values())
            found["mxu64"].append((int(regs), blocks))
            per_warp = MXU64_TILE * MXU64_PAIR * MXU64_UNITS
            per_block = total / per_warp
            print(f"[4 times] mxu64_kernel: {regs} registers, {smem} B "
                  f"dynamic shared memory, {blocks} blocks/SM "
                  f"({4 * blocks} warps), grid {grid} at 98,304 blocks; SASS "
                  f"{total} instructions ({ops['HMMA']} HMMA, "
                  f"{sum(ops[o] for o in SASS_MEM)} memory, {ops['BRA']} "
                  f"branches), at most {per_block:.1f} warp instructions a "
                  f"block (a warp runs each at most once for its {per_warp} "
                  f"blocks): "
                  f"{per_block * 98304 / (4 * sms * clock) * 1e6:.2f} us of "
                  f"issue at M=16384 | {card}", flush=True)
        hit = floor.search(mangled)
        if hit:
            wire = 1 if hit.group(1) == "a" else 2
            gy, vec16 = int(hit.group(2)), hit.group(3) == "1"
            key = {1: (1, 1, 3), 2: (2, 1, 3), 4: (2, 2, 3)}[gy]
            blocks, smem = memfloor_occupancy(wire, S.mode_for(key), vec16)
            found["memfloor"].append((int(regs), blocks))
            note = ""
            if gy == 4:
                total = sum(sass[mangled].values())
                per_mcu = total * (TILE_THREADS // 32) / TILE_MCUS
                note = (f"; SASS {total} instructions, at most "
                        f"{per_mcu:.1f} warp instructions an MCU: "
                        f"{per_mcu * 16384 / (4 * sms * clock) * 1e6:.2f} us "
                        f"of issue at M=16384")
            print(f"[4 times] memfloor_kernel {gy} luma slots "
                  f"({S.mode_for(key).name}{'/4:4:0' if gy == 2 else ''}) "
                  f"int{8 * wire} ({'16-byte' if vec16 else 'byte'} stores): "
                  f"{regs} registers, {smem} B static shared memory, "
                  f"{blocks} blocks/SM ({blocks * 8} warps){note} | {card}",
                  flush=True)
        hit = truerez.search(mangled)
        if hit:
            wire = 1 if hit.group(1) == "a" else 2
            key = (int(hit.group(2)), int(hit.group(3)), 3)
            vec16 = hit.group(4) == "1"
            blocks, smem = truerez_occupancy(wire, S.mode_for(key), vec16)
            found["truerez"].append((int(regs), blocks))
            note = ""
            if key == (2, 2, 3):
                total = sum(sass[mangled].values())
                per_mcu = total * (TILE_THREADS // 32) / TILE_MCUS
                note = (f"; SASS {total} instructions, {per_mcu:.1f} warp "
                        f"instructions an MCU: "
                        f"{per_mcu * 16384 / (4 * sms * clock) * 1e6:.2f} us "
                        f"of issue at M=16384")
            print(f"[4 times] rgb_truerez_kernel {S.mode_for(key).name} "
                  f"int{8 * wire} ({'16-byte' if vec16 else 'byte'} stores): "
                  f"{regs} registers, {smem} B dynamic shared memory, "
                  f"{blocks} blocks/SM ({blocks * 8} warps){note} | {card}",
                  flush=True)
        hit = scaled.search(mangled) or stacked.search(mangled)
        if hit:
            kind = "scaled" if hit.re is scaled else "stacked"
            wire = 1 if hit.group(1) == "a" else 2
            h, v = int(hit.group(2)), int(hit.group(3))
            vec16 = hit.group(hit.re.groups) == "1"
            if kind == "scaled":
                m_key = (h, v, int(hit.group(4)))
                scale = 8 // int(hit.group(5))
                blocks, smem = tile_occupancy(wire, S.mode_for(m_key), False,
                                              vec16, scale)
                label = (f"rgb_scaled_kernel {S.mode_for(m_key).name} "
                         f"scale {scale}")
            else:
                m_key = (h, v, 3)
                blocks, smem = stacked_occupancy(wire, S.mode_for(m_key),
                                                 vec16)
                label = f"rgb_stacked_kernel {S.mode_for(m_key).name}"
            found[kind].append((int(regs), blocks))
            print(f"[4 times] {label} int{8 * wire} "
                  f"({'16-byte' if vec16 else 'byte'} stores): {regs} "
                  f"registers, {smem} B dynamic shared memory, {blocks} "
                  f"blocks/SM ({blocks * 8} warps) | {card}", flush=True)
    want = {"epilogue": 36, "dequant": 8, "idct": 1, "color": 10,
            "scaled": 60, "stacked": 16, "truerez": 16, "mxu2pass": 2,
            "memfloor": 12, "mxu64": 1}
    if {k: len(v) for k, v in found.items()} != want:
        names = ", ".join(f"{len(v)} {k}" for k, v in found.items())
        fail(f"nvcc.log names {names} instantiations, expected {want}")
    print(f"[4 times] raster_epilogue_kernel: 36 instantiations (4 output "
          f"types x banded n 8/4/2/1 x h 1/2, and row form n 8 h 2), "
          f"{min(found['epilogue'])}-"
          f"{max(found['epilogue'])} registers; dequant_stage_kernel: 8 "
          f"(2 wires x g 1/3/4/6), {min(found['dequant'])}-"
          f"{max(found['dequant'])} registers; idct_stage_kernel: 1, "
          f"{found['idct'][0]} registers; color_stage_kernel: 10 (5 modes x "
          f"8-byte/byte stores), {min(found['color'])}-"
          f"{max(found['color'])} registers | {card}", flush=True)
    for kind, count in (("rgb_scaled", "60 (5 modes x 2 wires x scale "
                                       "2/4/8 x 16-byte/byte stores)"),
                        ("rgb_stacked", "16 (4 colour modes x 2 wires x "
                                        "16-byte/byte stores)"),
                        ("rgb_truerez", "16 (4 colour modes x 2 wires x "
                                        "16-byte/byte stores)"),
                        ("mxu2pass", "2 (pieces 1, 2)"),
                        ("memfloor", "12 (1, 2 and 4 luma slots x 2 wires x "
                                     "16-byte/byte stores)"),
                        ("mxu64", "1")):
        regs = [r for r, _ in found[kind.replace("rgb_", "")]]
        blocks = [b for _, b in found[kind.replace("rgb_", "")]]
        print(f"[4 times] {kind}_kernel: {count}, {min(regs)}-"
              f"{max(regs)} registers, {min(blocks)}-{max(blocks)} "
              f"blocks/SM | {card}", flush=True)


def stage_times(torch, mode, bufs, times: dict, card: str) -> None:
    """The three stage kernels and their plain versions at the stage
    profile's geometry (``bufs``: 10 rotating 4:2:0 int16 inputs, Q=16)."""
    from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as SK

    deqs = [SK.dequantize_stage(*b, mode) for b in bufs]
    spats = [SK.idct_stage(d, mode) for d in deqs]
    m = deqs[0].shape[0]
    i16_mb = deqs[0].numel() * 2 / 1e6
    rgb_mb = 3 * mode.luma_slots * 64 * m / 1e6
    side = (bufs[0][1].numel() + bufs[0][2].numel()) * 4
    blocks = m * mode.g
    cases = {
        "dequant": (lambda b: SK.dequantize_stage(*b, mode),
                    lambda b: SK.dequantize_stage_reference(*b), bufs,
                    2 * i16_mb, side, blocks * DEQUANT_BLOCK_OPS),
        "idct": (lambda d: SK.idct_stage(d, mode), SK.idct_stage_reference,
                 deqs, 2 * i16_mb, 0, blocks * IDCT_BLOCK_OPS),
        "color": (lambda sp: SK.color_stage(sp, mode, raw=True),
                  lambda sp: SK.color_stage_reference(sp, mode, raw=True),
                  spats, i16_mb + rgb_mb, 0,
                  m * mode.luma_slots * 64 * COLOR_PIXEL_OPS),
    }
    for name, (kernel, plain, inputs, mb, extra, ops) in cases.items():
        k = time_band(kernel, inputs)
        p = time_band(plain, inputs, runs=20)
        b = bound(mb * 1e6 + extra, ops)
        times[name] = timing(k, p, b)
        print(f"[4 times] {name} stage kernel 4:2:0 M={m} int16: "
              f"{us_band(k)}/launch ({mb / k[0]:.0f} GB/s of {mb:.1f} MB; "
              f"{bound_note(b)}, {100 * b[0] / k[0]:.1f}% of the bound); "
              f"plain PyTorch {us_band(p)}; 30/20 "
              f"launches over 10 rotating inputs | {card}", flush=True)


def batch_inputs(torch, dev, blobs, rng, count: int = 10):
    """``count`` B=256 batches on the card (int8 wire, 196,608 MCUs, 75 MB
    each), and the staging of the last: two staged by the batch path's own
    host stage, the others rotations of those by whole images on the card
    (the same coefficients at other addresses, so each launch reads
    device memory, not the L2)."""
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _host_stage

    staged_bufs = []
    for idx in imagenet_batches(rng, blobs, batches=2):
        staged = _host_stage([blobs[i] for i in idx], 8, "auto",
                             "chip_smoke", 1, False)
        staged_bufs.append([t.to(dev) for t in staged.launches[0].arrays])
    per_image = staged.headers[0].num_mcus
    bufs = []
    for i in range(count):
        coeffs, qidx, qpool = staged_bufs[i % 2]
        shift = (i // 2) * 37 * per_image
        bufs.append((torch.roll(coeffs, shift, 0), torch.roll(qidx, shift, 0),
                     qpool))
    return bufs, staged


def phase_batch_times(torch, dev, card: str, blobs, times: dict) -> None:
    """The two new kernels and their plain versions at the batch path's
    shapes, then the batch path's images/s, MP/s and device busy share."""
    from pim_jpeg_decoder_tpu_torch.utils.profiling import StageTimers
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import (
        iter_decode_batches)
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        decode_mcus, decode_mcus_reference, launch_counts, raster_epilogue,
        raster_epilogue_reference, raster_occupancy)
    from pim_jpeg_decoder_tpu_torch.tools.decode_ab import crop_origins

    rng = np.random.default_rng(SEED + 4)
    bufs, st = batch_inputs(torch, dev, blobs, rng)
    (ln,) = st.launches
    mode, m_full = ln.mode, bufs[0][0].shape[0]
    batch = len(st.headers)
    for m in (m_full, 16384):
        sub = [(c[:m], q[:m], qp) for c, q, qp in bufs]
        mb = sub[0][0].numel() / 1e6 + 3 * mode.luma_slots * 16 * m / 1e6
        k = time_band(lambda b: decode_mcus(*b, mode, raw=True, scale=2),
                      sub)
        p = time_band(lambda b: decode_mcus_reference(
            *b, mode, raw=True, scale=2), sub, runs=10)
        q = sub[0][2].shape[0]
        b = scaled_bound(mode, 2, m, 1, q)
        old = scaled_bound(mode, 2, m, 1, q, matrix_form=True)
        if m == m_full:
            times["rgb_scaled"] = timing(k, p, b)
        print(f"[4 times] rgb_scaled kernel 4:2:0 scale 2 M={m} int8 wire: "
              f"{us_band(k)}/launch ({mb / k[0]:.0f} GB/s of {mb:.1f} MB "
              f"wire + out; {bound_note(b)}, {100 * b[0] / k[0]:.1f}% of the "
              f"bound; matrix-form {bound_note(old)}, "
              f"{100 * old[0] / k[0]:.1f}%); plain PyTorch {us_band(p)}; "
              f"30/10 launches over 10 rotating inputs | {card}", flush=True)
    h0 = st.headers[0]
    for scale, dtype_name, crop in ((2, "bfloat16", None), (1, None, None),
                                    (1, "bfloat16", (224, 224))):
        raws = [decode_mcus(*b, mode, raw=True, scale=scale) for b in bufs]
        _, norm = batch_options(torch, dtype_name)
        out_h, out_w = crop or (-(-h0.height // scale), -(-h0.width // scale))
        args = (mode, scale, batch, ln.gh, ln.gw, out_h, out_w)
        if crop:
            args += crop_origins(torch, rng, batch, scale,
                                 (h0.height, h0.width), crop, dev)
        before = launch_counts()["raster_rows"]
        k = time_band(lambda r: raster_epilogue(r, *args, norm=norm), raws)
        row_form = launch_counts()["raster_rows"] > before
        p = time_band(lambda r: raster_epilogue_reference(
            r, *args, norm=norm), raws, runs=10)
        out_elems = batch * out_h * out_w * 3
        out_bytes = out_elems * (2 if dtype_name else 1)
        # Each input byte the output needs read once: the pixels of the
        # output window, not the MCU grid's padding around it.
        mb = (out_elems + out_bytes) / 1e6
        # A subtract and a multiply an element when normalising.
        b = bound(mb * 1e6, 2 * out_elems if dtype_name else 0, FP32_FLOPS)
        form = (f"{out_h}x{out_w} crops of scale {scale}" if crop
                else f"scale {scale}")
        key = ("raster_crops" if crop else
               "raster" if scale == 1 else "raster_scale2")
        times[key] = timing(k, p, b)
        blocks, smem = raster_occupancy(
            mode, scale, getattr(torch, dtype_name) if dtype_name else None,
            rows=row_form)
        print(f"[4 times] raster epilogue B={batch} {form} -> "
              f"{dtype_name or 'uint8'} [{batch}, {out_h}, {out_w}, 3]"
              f": {us_band(k)}/launch ({mb / k[0]:.0f} GB/s of {mb:.1f} MB; "
              f"{bound_note(b)}, {100 * b[0] / k[0]:.1f}% of the bound; "
              f"{'row' if row_form else 'banded'} form, {smem} B dynamic "
              f"shared memory, {blocks} blocks/SM); plain "
              f"PyTorch {us_band(p)}; 30/10 launches "
              f"over 10 rotating inputs | {card}", flush=True)
        del raws
    del bufs
    torch.cuda.empty_cache()

    order = imagenet_batches(rng, blobs)
    mp_per_image = st.headers[0].width * st.headers[0].height / 1e6

    def run(scale, dtype_name, timers=None) -> int:
        n = 0
        for out, headers in iter_decode_batches(
                ([blobs[i] for i in idx] for idx in order), scale=scale,
                device=dev, timers=timers,
                **batch_options(torch, dtype_name)[0]):
            n += len(headers)
        torch.cuda.synchronize()
        return n

    for scale, dtype_name in BATCH_CONFIGS:
        rates = []
        for _ in range(3):
            t0 = time.monotonic()
            n = run(scale, dtype_name)
            rates.append(n / (time.monotonic() - t0))
        timers = StageTimers()
        run(scale, dtype_name, timers)
        split = ", ".join(f"{k} {v[0]:.3f}"
                          for k, v in timers.snapshot().items())
        print(f"[4 times] batch path iter_decode_batches, {len(order)} x "
              f"B={batch} 500x375 4:2:0, scale {scale}, "
              f"{dtype_name or 'uint8'}: images/s "
              f"{', '.join(f'{r:.0f}' for r in rates)} (median "
              f"{statistics.median(rates):.0f}; MP/s "
              f"{statistics.median(rates) * mp_per_image:.1f}); stage "
              f"seconds of a run with timers (h2d and device on the "
              f"card's clock): {split} | {card}",
              flush=True)
    busy = device_busy(torch, lambda: run(1, None),
                       "batch path run (scale 1, uint8)")
    print(f"[4 times] {busy} | {card}", flush=True)


def max_sm_clock_hz() -> float:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi clocks.max.sm failed: {proc.stderr.strip()}")
    return float(proc.stdout.strip().splitlines()[0]) * 1e6


@contextlib.contextmanager
def tf32_matmul(torch):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def phase_ab_times(torch, dev, card: str, times: dict) -> None:
    """The IDCT variants of ``tools.mxu_idct_ab`` (the butterfly stage
    kernel, mxu2pass, mxu2pass4, mxu64) and their plain versions on the
    tool's draw rotated past twice the L2, beside the yardstick products
    (``torch.matmul`` with TF32 allowed: the products only, not the round
    and clip); then the VLC kernel and its plain version on the tool's
    bitstream."""
    from pim_jpeg_decoder_tpu_torch.ops import mxu_idct as X
    from pim_jpeg_decoder_tpu_torch.ops.vlc import vlc, vlc_reference
    from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab, vlc_bench
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    m, g = mxu_idct_ab.M, mxu_idct_ab.MODE.g
    blocks = m * g
    nbytes = 2 * blocks * 64 * 2                     # int16 in and out
    rot = [torch.from_numpy(d).to(dev) for d in mxu_idct_ab.make_inputs(
        max(8, rotation_count(nbytes // 2, dev)))]
    # The yardsticks' float32 operands: [8, 8 blocks] per pass, [64, blocks].
    x8 = [d.float().view(m, g, 8, 8).permute(2, 0, 1, 3).reshape(8, -1)
          for d in rot]
    x64 = [d.float().view(blocks, 64).t().contiguous() for d in rot]
    a8 = torch.from_numpy(X.mat8()).to(dev)
    a64 = torch.from_numpy(X.mat64()).to(dev)
    pairs = [(x8[i], x8[(i + 1) % len(x8)]) for i in range(len(x8))]
    with tf32_matmul(torch):
        lib2 = time_band(lambda xs: (a8 @ xs[0], a8 @ xs[1]), pairs)
        lib64 = time_band(lambda x: a64 @ x, x64)
    del x8, x64, pairs
    library = {"mxu2pass": lib2, "mxu2pass4": None, "mxu64": lib64,
               "butterfly": None}
    flops = {"butterfly": 0, "mxu2pass": 2048 * blocks,
             "mxu2pass4": 4 * 2048 * blocks, "mxu64": 8192 * blocks}
    fns = mxu_idct_ab.variant_fns()
    for name, (kernel, plain) in fns.items():
        k = time_band(kernel, rot)
        p = time_band(plain, rot, runs=20)
        b = (bound(nbytes, blocks * IDCT_BLOCK_OPS) if name == "butterfly"
             else bound(nbytes, flops[name], TF32_FLOPS))
        lib = library[name]
        if name != "butterfly":
            times[name] = timing(k, p, b, lib[0] if lib else None)
        lib_note = (f"; torch.matmul yardstick (TF32, products only"
                    f"{', both passes' if name == 'mxu2pass' else ''}) "
                    f"{us_band(lib)}" if lib else "")
        print(f"[4 times] IDCT A/B {name} 4:2:0 M={m} int16: {us_band(k)}"
              f"/launch ({nbytes / 1e6 / k[0]:.0f} GB/s of "
              f"{nbytes / 1e6:.1f} MB; {bound_note(b)}); plain PyTorch "
              f"{us_band(p)}{lib_note}; 30/20 launches over {len(rot)} "
              f"rotating inputs | {card}", flush=True)
    del rot
    torch.cuda.empty_cache()

    data, lut = (torch.from_numpy(a).to(dev) for a in vlc_bench.make_inputs())
    seeds = [torch.tensor([i], dtype=torch.int32, device=dev)
             for i in range(8)]
    _, nsym, bits = vlc_reference(seeds[0].cpu(), data.cpu(),
                                  lut.cpu()).tolist()
    fills = [torch.empty(1, dtype=torch.int32, device=dev) for _ in seeds]
    k = time_band(lambda s: vlc(s, data, lut), seeds)
    fill = time_band(lambda f: f.fill_(0), fills)
    p = time_band(lambda s: vlc_reference(s, data, lut), seeds, runs=5)
    # Each input read once (seed, stream, table), the output written once.
    nbytes = 4 * (1 + vlc_bench.NWORDS + vlc_bench.LUT_SIZE + 3)
    b = bound(nbytes, nsym * VLC_SYMBOL_OPS)
    times["vlc"] = timing(k, p, b)
    print(f"[4 times] vlc kernel, {vlc_bench.NWORDS} words, {nsym} symbols, "
          f"{bits} bits: {us_band(k)}/launch ({nsym / k[0] / 1e3:.2f} "
          f"Msymbols/s, {k[0] * 1e6 / nsym:.3f} ns a symbol); bound "
          f"{b[0] * 1e6:.3f} ns ({b[1]}: {nbytes} bytes over 3.35 TB/s "
          f"{nbytes / HBM_BYTES_PER_S * 1e9:.3f} ns, {VLC_SYMBOL_OPS} "
          f"integer operations a symbol over 33.5 T/s "
          f"{nsym * VLC_SYMBOL_OPS / INT32_OPS * 1e9:.3f} ns), "
          f"{100 * b[0] / k[0]:.4f}% of it; a 4-byte fill_ launch "
          f"{us_band(fill)} (the card's floor for any launch), the kernel "
          f"{k[0] / fill[0]:.2f}x it; plain Python loop {us_band(p)}; "
          f"30/30/5 launches | {card}", flush=True)


def redesign_times(torch, dev, card: str, times: dict) -> None:
    """The two kernels redesigned last at a B=256 batch's size: the memory
    floor at 4:2:0, M=196,608 int16 (the kernel_opt draw) and mxu64 on
    1,179,648 blocks of the IDCT tool's draw, each beside its plain
    version and its bound, mxu64 also beside its TF32 ``torch.matmul``
    yardstick; kept as each one's ``other_geometries`` on the kernels
    line."""
    from pim_jpeg_decoder_tpu_torch.ops import kernel_variants as KV
    from pim_jpeg_decoder_tpu_torch.ops import mxu_idct as X
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.tools import kernel_opt, mxu_idct_ab
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    m, mode = 196608, kernel_opt.MODE
    wire_bytes = m * mode.g * 64 * 2
    host = kernel_opt.make_inputs(max(2, rotation_count(wire_bytes, dev)), 0,
                                  m)["i16"]
    bufs = [(coeffs_to_device(c, dev), torch.from_numpy(qi).to(dev),
             qpool_to_device(qp, dev)) for c, qi, qp in host]
    del host
    k = time_band(lambda b: KV.memfloor(*b, mode), bufs)
    p = time_band(lambda b: KV.memfloor_reference(*b, mode), bufs, runs=10)
    out = 3 * mode.luma_slots * 64 * m
    b = bound(wire_bytes + out, m * mode.luma_slots * 64 * 2)
    times["memfloor_196608"] = timing(k, p, b)
    print(f"[4 times] memfloor kernel 4:2:0 M={m} int16 wire: {us_band(k)}"
          f"/launch ({(wire_bytes + out) / 1e6 / k[0]:.0f} GB/s of "
          f"{(wire_bytes + out) / 1e6:.1f} MB; {bound_note(b)}); plain "
          f"PyTorch {us_band(p)}; 30/10 launches over {len(bufs)} rotating "
          f"inputs | {card}", flush=True)
    del bufs
    torch.cuda.empty_cache()

    blocks = m * mxu_idct_ab.MODE.g
    nbytes = 2 * blocks * 64 * 2                     # int16 in and out
    rot = [torch.from_numpy(d).to(dev) for d in mxu_idct_ab.make_inputs(
        max(2, rotation_count(nbytes // 2, dev)), m)]
    a64 = torch.from_numpy(X.mat64()).to(dev)
    x64 = [d.float().view(blocks, 64).t().contiguous() for d in rot]
    with tf32_matmul(torch):
        lib = time_band(lambda x: a64 @ x, x64)
    del x64
    k = time_band(X.mxu64, rot)
    p = time_band(X.mxu64_reference, rot, runs=10)
    b = bound(nbytes, 8192 * blocks, TF32_FLOPS)
    times["mxu64_196608"] = timing(k, p, b, lib[0])
    print(f"[4 times] IDCT A/B mxu64 4:2:0 M={m} int16: {us_band(k)}/launch "
          f"({nbytes / 1e6 / k[0]:.0f} GB/s of {nbytes / 1e6:.1f} MB; "
          f"{bound_note(b)}); plain PyTorch {us_band(p)}; torch.matmul "
          f"yardstick (TF32, product only) {us_band(lib)}; 30/10 launches "
          f"over {len(rot)} rotating inputs | {card}", flush=True)
    del rot
    torch.cuda.empty_cache()


def kernel_bounds(times: dict, card: str) -> None:
    """Each kernel's median time against its bound, and its share of it."""
    for name, t in times.items():
        print(f"[4 times] bound {JSON_NAMES.get(name, f'decode_{name}')}: "
              f"{t['ms'] * 1e3:.2f} us vs {t['bound_ms'] * 1e3:.4g} us "
              f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.3g}% of "
              f"the bound; library "
              + (f"{t['library_ms'] * 1e3:.2f} us" if t["library_ms"]
                 else "none") + f" | {card}", flush=True)


def device_busy(torch, fn, label: str) -> str:
    """One traced run of ``fn``: the union of device activity (kernels and
    copies) over the run's wall time, and the device ops that took most."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return "device busy share: not measured (no device events traced)"
    busy_us, end, by_name = 0.0, float("-inf"), {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return (f"traced {label}: wall {wall:.4f} s, device busy "
            f"{busy_us / 1e6:.4f} s ({100 * busy_us / 1e6 / wall:.1f}%, idle "
            f"{100 - 100 * busy_us / 1e6 / wall:.1f}%); device time by op: "
            + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in top))


# --- main --------------------------------------------------------------------

def cards_only(torch, dev, card: str, root: str, tmp: str, paths, oracles,
               blobs, imagenet, scaled_oracles, crop_set) -> int:
    """``--cards``: every kernel that prepares attributes on each card,
    then phase ``[3 multi]`` over every card against one card (the engine's
    one-card digests made here), then the last line."""
    from pim_jpeg_decoder_tpu_torch.parallel.mesh import make_mesh
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine

    devices = make_mesh()
    if len(devices) < 2:
        fail(f"--cards needs two cards or more, found {len(devices)}")
    per_card_kernels(torch, devices, card)
    if DecodeEngine(device=dev).decode_paths(paths).ok_count != len(paths):
        fail("the one-card engine failed files")
    phase_multi(torch, dev, devices, card, root, tmp, paths, oracles,
                bmp_digests(paths), [blobs[p] for p in imagenet],
                {1: [oracles[p] for p in imagenet],
                 2: [scaled_oracles[p] for p in imagenet]}, crop_set)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--cards", action="store_true",
        help="only the device-list paths over every local card (two or "
             "more), held against one card: the launchers' per-card "
             "preparation and the split over cards that a one-card "
             "machine cannot show")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pim_jpeg_decoder_tpu_torch")):
        fail("run from the root of a checkout (pim_jpeg_decoder_tpu_torch/ "
             "not found beside this script)")
    sys.path.insert(0, root)
    card = card_line()
    phase_device(torch, card)

    with tempfile.TemporaryDirectory(prefix="pjt_smoke_") as tmp:
        t0 = time.monotonic()
        paths = build_corpus(tmp)
        oracles, scaled_oracles, oracle_images, seen = {}, {}, [], set()
        blobs = {}
        for p in paths:
            with open(p, "rb") as f:
                blobs[p] = f.read()
            header, coeffs, raster = oracle_raster(blobs[p])
            oracles[p] = raster
            scaled_oracles[p] = scaled_oracle(blobs[p], 2)
            if header.mode_key not in seen and header.num_mcus < 10000:
                seen.add(header.mode_key)
                oracle_images.append((header, coeffs, blobs[p]))
        # The ImageNet-like photos (the corpus's first 32), every 4:2:0
        # image for the crop batch, and every 4:2:0 and 4:4:4 image for
        # the crop cell's mixed batches.
        imagenet = paths[:CORPUS[0][0]]
        crop_paths = [p for p, kw in zip(paths, corpus_kwargs())
                      if kw.get("sampling") == "4:2:0"]
        mixed = {m: [(blobs[p], oracles[p])
                     for p, kw in zip(paths, corpus_kwargs())
                     if kw.get("sampling") == m]
                 for m in ("4:2:0", "4:4:4")}
        crop_set = ([blobs[p] for p in crop_paths],
                    {1: [oracles[p] for p in crop_paths],
                     2: [scaled_oracles[p] for p in crop_paths]}, mixed)
        dev = torch.device("cuda", 0)
        if args.cards:
            return cards_only(torch, dev, card, root, tmp, paths, oracles,
                              blobs, imagenet, scaled_oracles, crop_set)
        print(f"[3 slice] corpus of {len(paths)} JPEGs encoded and oracle "
              f"rasters (full and 1/2 scale) built in "
              f"{time.monotonic() - t0:.1f} s", flush=True)

        max_err = phase_kernels(torch, dev, oracle_images)
        counts, base = phase_slice(dev, paths, oracles, scaled_oracles)
        counts.update({k: v for k, v in phase_profile(dev, paths, tmp).items()
                       if k in STAGES})
        counts.update({k: v for k, v in phase_batches(
            torch, dev, [blobs[p] for p in imagenet],
            {1: [oracles[p] for p in imagenet],
             2: [scaled_oracles[p] for p in imagenet]},
            crop_set).items() if k in ("rgb_scaled", "raster")})
        phase_multi(torch, dev, [dev, dev], card, root, tmp, paths, oracles,
                    base,
                    [blobs[p] for p in imagenet],
                    {1: [oracles[p] for p in imagenet],
                     2: [scaled_oracles[p] for p in imagenet]}, crop_set)
        phase_fuzz(dev)
        phase_host(root)
        record, tool_counts = phase_tool()
        counts.update({k: tool_counts[k] for k in KERNEL_OPT_COUNTERS})
        counts.update(phase_ab_tools())
        floor_shares(record, card)
        floor_sweep(torch, card)
        times = phase_times(torch, dev, card, paths)
        phase_batch_times(torch, dev, card, [blobs[p] for p in imagenet],
                          times)
        phase_ab_times(torch, dev, card, times)
        redesign_times(torch, dev, card, times)
        from pim_jpeg_decoder_tpu_torch.ops import _build
        sass = sass_counts(os.path.join(_build.build_dir(), _build.LIB_NAME))
        tile_resources(torch, card, tile_times(torch, dev, card), sass)
        scaled_stacked_times(torch, dev, card)
        redesign_resources(torch, card, sass)
        kernel_bounds(times, card)

    kernels = [{
        "name": JSON_NAMES.get(name, f"decode_{name}"),
        "route": "cuda",
        "source": KERNELS[name][0],
        "replaces": KERNELS[name][1],
        "launches": counts[name],
        "max_abs_err": max_err[name],
        **times[name],
    } for name in KERNELS]
    for k in kernels:   # other timed geometries
        if k["name"] == JSON_NAMES["raster"]:
            k["geometry"] = "B=256 500x375 4:2:0, scale 1 -> uint8"
            k["other_geometries"] = {JSON_NAMES[g]: times[g] for g in
                                     ("raster_scale2", "raster_crops")}
        for name, label in (("memfloor", "4:2:0 M=196608 int16"),
                            ("mxu64", "4:2:0 M=196608 (1,179,648 blocks)")):
            if k["name"] == JSON_NAMES[name]:
                k["other_geometries"] = {label: times[f"{name}_196608"]}
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
