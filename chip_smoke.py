#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (nvcc under
PATH or /usr/local/cuda/bin, g++ for the host library).  Uses torch, numpy
and ``pim_jpeg_decoder_tpu_torch`` only (its own host layer, oracle and
encoder; nothing of ``pim_jpeg_decoder_tpu``).  Phases:

1. device: card name and power limit, build of ``csrc/*.cu`` (``nvcc.log``
   naming the instantiations of ``INSTANTIATIONS``), native host library
   present;
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
   extremes and full-range int16), tolerance 0, staged == fused; the RGB
   and stacked kernels where their rows start off the 16-byte grid
   (``row_shift_cases``: M of ``SHIFT_MS``, every row shift of the 8-byte
   grid and the crop cell's two launches, and outputs ``SHIFT_OFFSETS``
   bytes off the grid with guard bytes), tolerance 0;
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
   oracle slices, with two decode and two epilogue launches a batch,
   every decode's rows on the 16-byte grid and no epilogue in the row
   form; every path that
   takes a device list over two shards of the one card (``[3 multi]``:
   the engine on both transports, the single-image APIs, the B=256
   batches, the crop batch and a mixed-mode crop batch, each equal to the
   oracle or to one device, every shard launching, and two gloo ranks of
   ``tools.scaling_bench``); the port's differential fuzz campaign
   (``[3 fuzz]``: ``tools.fuzz.run`` in this process on the card, seed
   ``FUZZ_SEED``, ``FUZZ_ITERATIONS`` iterations of random engine
   geometries, batch, stream, device-list,
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
   has a launch count of its own).

It checks and does not time: the benchmark (``perfbench/``) measures the
cells and the kernels' rooflines, and
``pim_jpeg_decoder_tpu_torch/tools/decode_ab.py --parent`` times kernels
against another checkout.

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
              "dequant": "stage_dequantize",
              "idct": "stage_idct", "color": "stage_color",
              "memfloor": "kernel_opt_memfloor",
              "truerez": "kernel_opt_chroma_truerez",
              "stacked": "kernel_opt_stacked",
              "mxu2pass": "mxu_idct_2pass",
              "mxu2pass4": "mxu_idct_2pass4 (pieces 2)",
              "mxu64": "mxu_idct_64",
              "vlc": "vlc_symbol_loop"}
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

# Instantiations of each templated kernel that nvcc.log must name.
# Epilogue: 4 output types x banded n 8/4/2/1 x h 1/2, and the row form at
# n 8 h 2; dequantize: 2 wires x g 1/3/4/6; colour: 5 modes x 8-byte/byte
# stores; scaled: 5 modes x 2 wires x scale 2/4/8 x 16-byte/byte stores;
# stacked and truerez: 4 colour modes x 2 wires x 16-byte/byte stores;
# mxu2pass: pieces 1 and 2; the floor: 1, 2 and 4 luma slots x 2 wires x
# 16-byte/byte stores.
INSTANTIATIONS = {"raster_epilogue_kernel": 36, "dequant_stage_kernel": 8,
                  "idct_stage_kernel": 1, "color_stage_kernel": 10,
                  "rgb_scaled_kernel": 60, "rgb_stacked_kernel": 16,
                  "rgb_truerez_kernel": 16, "mxu2pass_kernel": 2,
                  "memfloor_kernel": 12, "mxu64_kernel": 1}


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
    entries = re.findall(r"Compiling entry function '(\S+)'", log)
    found = {name: sum(name in e for e in entries) for name in INSTANTIATIONS}
    if found != INSTANTIATIONS:
        fail(f"nvcc.log names {found} instantiations, expected "
             f"{INSTANTIATIONS}")
    print(f"[1 device] kernels built in {build_s:.1f} s ({path}); ptxas: "
          f"{len(regs)} kernels, max {max(regs, default=0)} registers, "
          f"max {max(spills, default=0)} bytes spill stores; instantiations "
          f"as expected ({sum(found.values())} of {len(found)} kernels)",
          flush=True)
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
    n_shift = row_shift_cases(torch, dev, max_err)
    loop_line = loop_cases(torch, dev, max_err)
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
    print(f"[2 kernels] {n_shift} row-shift cases byte-identical: rgb and "
          f"stacked (also == rgb kernel) x 5 modes x i16/i8 x M="
          f"{sorted(set(SHIFT_MS + SHIFT_OFFSET_MS))}, each launch off the "
          f"grid counted in rgb_shifted; "
          f"rgb into outputs {list(SHIFT_OFFSETS)} bytes off the grid at M="
          f"{list(SHIFT_OFFSET_MS)}, guard bytes untouched", flush=True)
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
    print(f"[2 kernels] {loop_line}", flush=True)
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


# M values of the RGB kernels' row-shift cases: 16k + r for r = 1..15 (row
# t of a plane starts (t * r) % 16 bytes past the 16-byte grid, so the
# full tiles write rows at every shift), 16k + 8, and the crop cell's two
# decode launches before their padding (4:2:0 M = 225 * 15 * 15, 4:4:4 M
# = 31 * 29 * 29); each has a ragged last tile.
SHIFT_MS = tuple(16 * 19 + r for r in range(1, 16)) + (16 * 20 + 8, 50625,
                                                         26071)
# Byte offsets of an output written through the C entry point, with M on
# the 16-byte grid (every row then shifted by the offset) and off it.
SHIFT_OFFSETS = (1, 2, 3, 4, 5, 6, 7, 8, 12)
SHIFT_OFFSET_MS = (16 * 20, 16 * 19 + 5)


def row_shift_cases(torch, dev, max_err) -> int:
    """rgb_kernel and rgb_stacked_kernel where their rows start off the
    16-byte grid (their byte-store form, ``store_rgb``): every mode and both
    wires at the M values of ``SHIFT_MS`` and ``SHIFT_OFFSET_MS``, against
    their plain versions and (stacked) the RGB kernel, tolerance 0, each
    ``rgb`` launch off the grid counted in ``rgb_shifted``; and, at
    ``SHIFT_OFFSET_MS``, rgb_kernel through its C entry point into outputs
    ``SHIFT_OFFSETS`` bytes off the grid, guard bytes on both sides
    untouched, equal to the aligned launch."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops._build import load
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, decode_mcus_reference, launch_counts,
        qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.ops.kernel_variants import KERNELS

    rng = np.random.default_rng(SEED + 26)

    def same(name, got, want, what) -> None:
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        max_err[name] = max(max_err[name], err)
        if got.shape != want.shape or err:
            fail(f"{name} kernel != plain version: {what} (row-shift case) "
                 f"max|err|={err}")

    lib = load()
    cases = 0
    for key in sorted(S.MODES):
        mode = S.mode_for(key)
        for wire in (np.int16, np.int8):
            for m in sorted(set(SHIFT_MS + SHIFT_OFFSET_MS)):
                what = f"{mode.name} {np.dtype(wire).name} M={m}"
                coeffs, qidx, qpool = synthetic_batch(mode, m, wire, rng,
                                                      extreme=True)
                qidx[m // 2] = qpool.shape[0]
                qidx[m - 1] = -1
                x = coeffs_to_device(coeffs, dev)
                qi = torch.from_numpy(qidx).to(dev)
                qp = qpool_to_device(qpool, dev)
                before = launch_counts()["rgb_shifted"]
                fused = decode_mcus(x, qi, qp, mode, raw=True)
                counted = launch_counts()["rgb_shifted"] - before
                if counted != (m % 16 != 0):
                    fail(f"rgb_shifted counted {counted} for {what}")
                same("rgb", fused,
                     decode_mcus_reference(x, qi, qp, mode, raw=True), what)
                cases += 1
                if mode.ncomp == 3:
                    kernel, plain = KERNELS["stacked"]
                    got = kernel(x, qi, qp, mode)
                    same("stacked", got, plain(x, qi, qp, mode), what)
                    if not torch.equal(got, fused):
                        fail(f"stacked kernel != rgb kernel: {what}")
                    cases += 2
                if m not in SHIFT_OFFSET_MS:
                    continue
                want = fused.reshape(-1)
                n = want.numel()
                for off in SHIFT_OFFSETS:
                    buf = torch.full((n + 32,), 0xA5, dtype=torch.uint8,
                                     device=dev)
                    with torch.cuda.device(dev):
                        rc = lib.pjt_cuda_decode_rgb(
                            x.data_ptr(), x.element_size(), qi.data_ptr(),
                            qp.data_ptr(), qp.shape[0],
                            buf.data_ptr() + 16 + off, m, mode.h, mode.v,
                            mode.ncomp,
                            torch.cuda.current_stream().cuda_stream)
                    torch.cuda.synchronize()
                    if rc != 0:
                        fail(f"rgb kernel failed to launch: {what} output "
                             f"{off} bytes off the grid, cudaError {rc}")
                    guards = torch.cat([buf[:16 + off], buf[16 + off + n:]])
                    if (not torch.equal(buf[16 + off:16 + off + n], want)
                            or bool((guards != 0xA5).any())):
                        fail(f"rgb kernel into an output {off} bytes off "
                             f"the grid != the aligned launch, or a guard "
                             f"byte written: {what}")
                    cases += 1
                del x, qi, qp
    torch.cuda.empty_cache()
    return cases


# Long scaled launches above one wave of resident blocks on an H100:
# (mode key, scale, M), each on both wires.  Their blocks walk several
# tiles where the form's tile copies enough (4:2:0 and 4:4:0 int16,
# ops/decode_kernel.scaled_plan) and keep a block a tile elsewhere.  The
# first four end in a ragged tile and take byte stores (M % 16 != 0); the
# last two take 16-byte stores on full tiles, 4:2:0 at the half-scale
# loader cell's own launch (a B=256 batch of 512x512 files).
LOOP_CASES = (((2, 2, 3), 2, 100003), ((1, 2, 3), 2, 100003),
              ((1, 1, 1), 2, 131091), ((1, 1, 3), 2, 65555),
              ((2, 2, 3), 2, 262144), ((1, 2, 3), 2, 196608))


def loop_cases(torch, dev, max_err) -> str:
    """rgb_scaled_kernel on the long launches of ``LOOP_CASES`` (both
    wires, extreme blocks, qidx Q and -1 in the last tile and -5 in the
    second) against its plain version, tolerance 0, each launch counted in
    ``rgb_scaled_looped`` exactly where its plan walks tiles, and the
    4:2:0 and 4:4:0 int16 launches walking."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        TILE_MCUS, _scaled_resident, coeffs_to_device, decode_mcus,
        decode_mcus_reference, launch_counts, qpool_to_device, scaled_plan)

    rng = np.random.default_rng(SEED + 28)
    notes = []
    for key, scale, m in LOOP_CASES:
        mode = S.mode_for(key)
        for wire in (np.int16, np.int8):
            what = f"{mode.name} {np.dtype(wire).name} scale {scale} M={m}"
            coeffs, qidx, qpool = synthetic_batch(mode, m, wire, rng,
                                                  extreme=True)
            qidx[m - 2] = qpool.shape[0]
            qidx[m - 1] = -1
            qidx[TILE_MCUS + 3] = -5   # in a tile that starts a walk
            x = coeffs_to_device(coeffs, dev)
            qi = torch.from_numpy(qidx).to(dev)
            qp = qpool_to_device(qpool, dev)
            before = launch_counts()["rgb_scaled_looped"]
            got = decode_mcus(x, qi, qp, mode, raw=True, scale=scale)
            looped = launch_counts()["rgb_scaled_looped"] - before
            blocks, per = scaled_plan(m, _scaled_resident(
                dev.index or 0, x.element_size(), mode.h, mode.v, mode.ncomp,
                scale, m % 16 == 0))
            must = wire == np.int16 and key in ((2, 2, 3), (1, 2, 3))
            if looped != (per > 1) or (must and not looped):
                fail(f"rgb_scaled_looped counted {looped} for {what} "
                     f"(plan {blocks} blocks x {per} tiles)")
            want = decode_mcus_reference(x, qi, qp, mode, raw=True,
                                         scale=scale)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            max_err["rgb_scaled"] = max(max_err["rgb_scaled"], err)
            if got.shape != want.shape or err:
                fail(f"rgb_scaled kernel != plain version: {what} (long "
                     f"launch) max|err|={err}")
            notes.append(f"{what}: {blocks} blocks x {per} tiles")
            del x, qi, qp, got, want
    torch.cuda.empty_cache()
    return (f"{len(notes)} long rgb_scaled launches byte-identical, those "
            f"that walk tiles counted in rgb_scaled_looped: "
            + "; ".join(notes))


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
    count as shifted (``raster_shifted``)."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import _norm_static
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        launch_counts, raster_epilogue, raster_epilogue_reference)
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
    # Every decode writes rows on the 16-byte grid (each launch's MCUs
    # padded to a multiple of 16): none counted in rgb_shifted.
    want_counts = {"rgb": 2 * len(batches), "raster": 2 * len(batches),
                   "rgb_shifted": 0, "rgb_scaled": 0, "raster_rows": 0,
                   "plain_on_cuda": 0}
    if any(mixed_counts[k] != v for k, v in want_counts.items()):
        fail(f"mixed-mode crop batches: launches {mixed_counts}, expected "
             f"{want_counts}")
    sizes = {m: sorted({r.shape[:2] for _, r in pool})
             for m, pool in mixed.items()}
    print(f"[3 slice] the crop cell's batches: {len(batches)} x B=256 "
          f"224x224 crops of 4:2:0 {sizes['4:2:0']} and, 1 in 8, 4:4:4 "
          f"{sizes['4:4:4']}, two through iter_decode_batch_crops(mixed_sizes=True) in "
          f"bfloat16-normalised, one through decode_batch_crops in uint8: "
          f"== oracle slices; launches rgb={mixed_counts['rgb']} "
          f"(off the grid {mixed_counts['rgb_shifted']}) raster="
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
    plain version on the card.  Returns the counts."""
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
    return counts


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


# --- main --------------------------------------------------------------------

def kernels_record(counts: dict, max_err: dict) -> dict:
    """The kernels' JSON record: for each launch counter of ``KERNELS``,
    its name, route, CUDA source, the TPU kernel it replaces, the launches
    phases 2-3 counted and its largest difference from its plain
    version."""
    return {"kernels": [{
        "name": JSON_NAMES.get(name, f"decode_{name}"),
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": counts[name],
        "max_abs_err": max_err[name],
    } for name, (source, replaces) in KERNELS.items()]}


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
        tool_counts = phase_tool()
        counts.update({k: tool_counts[k] for k in KERNEL_OPT_COUNTERS})
        counts.update(phase_ab_tools())

    print(card)
    print(json.dumps(kernels_record(counts, max_err)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
