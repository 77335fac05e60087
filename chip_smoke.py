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
   epilogue for every mode and scale, u8/f32/bf16/f16, full and cropped;
   the memory-floor, chroma-truerez and stacked kernels
   (``csrc/kernel_opt.cu``) for the colour modes, both wires, both Ms, the
   last two also equal to the fused RGB kernel; the tensor-core IDCT
   kernels (``csrc/mxu_idct.cu``: mxu2pass with pieces 1 and 2, mxu64) at
   M=16,384 and 1,001 of int16 in [-2048, 2048) within ``MXU_TOLERANCE``
   of their float32 plain versions (TF32 operands; pieces 2 bit-exact);
   the VLC kernel (``csrc/vlc.cu``) at five seeds, tolerance 0;
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
   three sizes, equal to slices of the oracle rasters; the experiment
   tool ``tools.kernel_opt`` (every variant bit-exact, each of its three
   kernels launched); the tools ``tools.mxu_idct_ab`` (the butterfly and
   the three tensor-core variants, each within its tolerance) and
   ``tools.vlc_bench`` (exact), their kernels launched;
4. kernel and plain-version times with CUDA events
   (``utils/devbench.seconds_per_launch``, 10 rotating inputs past the 50
   MB L2; median with min and max), each kernel's bound (the larger of its
   bytes over 3.35 TB/s and its operations over their peak rate) and, for
   the tensor-core IDCT, ``torch.matmul`` yardsticks with TF32 allowed;
   the IDCT A/B (butterfly, mxu2pass, mxu2pass4, mxu64) at the tool's
   geometry and the VLC kernel; the ``tools/stage_profile`` record
   (staged sum, fused time, fusion ratio), the ``tools.kernel_opt`` record
   and rgb_kernel's GB/s as a share of its memory floor's (int16 and int8
   wire, from that one run) and over the tool's launch sizes
   (``kernel_opt.sweep``, 2,048 to 196,608 MCUs), the engine's end-to-end
   MP/s on the corpus, the batch path's images/s and MP/s, and the device
   busy share of one traced run of each.

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
    "mxu64": ("pim_jpeg_decoder_tpu_torch/csrc/mxu_idct.cu",
              "tools/mxu_idct_ab.py:104"),
    "vlc": ("pim_jpeg_decoder_tpu_torch/csrc/vlc.cu",
            "tools/tpu_vlc_bench.py:38"),
}
JSON_NAMES = {"raster": "raster_epilogue", "dequant": "stage_dequantize",
              "idct": "stage_idct", "color": "stage_color",
              "memfloor": "kernel_opt_memfloor",
              "truerez": "kernel_opt_chroma_truerez",
              "stacked": "kernel_opt_stacked",
              "mxu2pass": "mxu_idct_2pass", "mxu64": "mxu_idct_64",
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
# The VLC loop's dependency chain a symbol: two dependent shared-memory
# loads (the window words, then the table entry) and at least 6 dependent
# integer operations (window funnel, probe, entry fields, advance, word
# index and address), at assumed latencies (not measured: shared load 23
# cycles, integer operation 4), over the card's maximum SM clock.
VLC_CYCLES_PER_SYMBOL = 2 * 23 + 6 * 4


def reduced_idct_ops(ny: int, nx: int) -> int:
    """Integer operations of one reduced (matrix) IDCT to ny x nx samples:
    each output a sum of products over its pass (2n - 1), a descale (2),
    then 2 clamps (decode_kernel._reduced_pass)."""
    return nx * ny * (2 * ny + 1) + ny * nx * (2 * nx + 1) + 2 * ny * nx


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
    n_epi = epilogue_cases(torch, dev, rng, max_err)
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
    print(f"[2 kernels] {mxu_line}", flush=True)
    print(f"[2 kernels] {vlc_line}", flush=True)
    return max_err


def mxu_cases(torch, dev, rng, max_err) -> str:
    """The tensor-core IDCT kernels against their float32 plain versions
    on the card, every ``pieces``, at M=16,384 and an odd M=1,001 of the
    tool's draw (int16 in [-2048, 2048)), within ``MXU_TOLERANCE``."""
    from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab

    fns = mxu_idct_ab.variant_fns()
    notes = []
    for m in (16384, 1001):
        deq = torch.from_numpy(rng.integers(
            -2048, 2048, (m, 6, 64)).astype(np.int16)).to(dev)
        for name, (tol, share_tol) in MXU_TOLERANCE.items():
            kernel, plain = fns[name]
            got, want = kernel(deq), plain(deq)
            torch.cuda.synchronize()
            d = mxu_idct_ab.difference(got, want)
            counter = mxu_idct_ab.VARIANTS[name]
            max_err[counter] = max(max_err[counter], d["max_abs_diff"])
            if (got.shape != want.shape or d["max_abs_diff"] > tol
                    or d["share_diff"] > share_tol):
                fail(f"{name} kernel vs its float32 plain version at M={m}: "
                     f"max|diff| {d['max_abs_diff']} (at most {tol}), share "
                     f"{d['share_diff']:.5f} (at most {share_tol})")
            notes.append(f"{name} M={m}: max|diff| {d['max_abs_diff']}, "
                         f"share {d['share_diff']:.5f}")
    return ("mxu_idct kernels (TF32) vs float32 plain versions, tool's draw "
            "(tolerance max|diff| <= 2 in <= 4% / 0 / <= 2 in <= 3%): "
            + "; ".join(notes))


def vlc_cases(torch, dev, max_err) -> str:
    """The VLC kernel against its plain version on the card: the tool's
    bitstream and table at five seeds, [acc, nsym, bitpos] identical."""
    from pim_jpeg_decoder_tpu_torch.ops.vlc import vlc, vlc_reference
    from pim_jpeg_decoder_tpu_torch.tools.vlc_bench import make_inputs

    data, lut = (torch.from_numpy(a).to(dev) for a in make_inputs())
    outs = []
    for seed in range(5):
        s = torch.tensor([seed], dtype=torch.int32, device=dev)
        got, want = vlc(s, data, lut), vlc_reference(s, data, lut)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err["vlc"] = max(max_err["vlc"], err)
        if err:
            fail(f"vlc kernel {got.tolist()} != plain version "
                 f"{want.tolist()} at seed {seed}")
        outs.append(got.tolist())
    return (f"vlc kernel == plain version at seeds 0-4 (tolerance 0): "
            f"[acc, nsym, bitpos] {outs}")


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
    clamps)."""
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
    return counts


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
        decode_batch_crops, iter_decode_batches)
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
          f"raster={counts['raster']} plain_on_cuda="
          f"{counts['plain_on_cuda']}", flush=True)

    crop_blobs, crop_refs = crop_set
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
    return counts


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
    for tool, counters in ((mxu_idct_ab, ("idct", "mxu2pass", "mxu64")),
                           (vlc_bench, ("vlc",))):
        name = tool.__name__.rsplit(".", 1)[-1]
        out = io.StringIO()
        reset_launch_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(out):
            rc = tool.main([])
        wall = time.monotonic() - t0
        counts = launch_counts()
        if rc != 0:
            fail(f"tools.{name} exited {rc}")
        record = json.loads(out.getvalue().splitlines()[-1])
        if min(counts[k] for k in counters) < 1 or counts["plain_on_cuda"]:
            fail(f"tools.{name} did not go through its kernels alone: "
                 f"{counts}")
        if tool is mxu_idct_ab:
            if sorted(record) != sorted(mxu_idct_ab.VARIANTS):
                fail(f"tools.mxu_idct_ab ran {sorted(record)}")
            for variant, r in record.items():
                tol, share_tol = tolerance[variant]
                if r["max_abs_diff"] > tol or r["share_diff"] > share_tol:
                    fail(f"tools.mxu_idct_ab: {variant} outside its "
                         f"tolerance: {r}")
        found.update({k: counts[k] for k in counters if k != "idct"})
        print(f"[3 slice] tools.{name}: exit 0 in {wall:.1f} s; launches "
              + " ".join(f"{k}={counts[k]}" for k in (*counters,
                                                        "plain_on_cuda"))
              + f"; record {json.dumps(record)}", flush=True)
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


def floor_shares(record: dict, card: str) -> None:
    """rgb_kernel against the layout-matched memory floor, from the
    tool's one run (same call, same rotation): the floor's time over
    rgb_kernel's is rgb_kernel's GB/s as a share of the floor's."""
    from pim_jpeg_decoder_tpu_torch.tools import kernel_opt

    print(f"[4 times] tools.kernel_opt record: {json.dumps(record)} | {card}",
          flush=True)
    m, mode = kernel_opt.M, kernel_opt.MODE
    out_mb = 3 * mode.luma_slots * 64 * m / 1e6
    for wire, nbytes, floor, prod in (("int16", 2, "memfloor", "prod"),
                                      ("int8", 1, "memfloor_i8", "prod_i8")):
        mb = m * mode.g * 64 * nbytes / 1e6 + out_mb
        f_us, p_us = record[floor]["us"], record[prod]["us"]
        print(f"[4 times] rgb_kernel vs its memory floor, 4:2:0 M={m} {wire} "
              f"wire ({mb:.1f} MB): floor {f_us} us ({mb / f_us * 1e3:.0f} "
              f"GB/s), rgb_kernel {p_us} us ({mb / p_us * 1e3:.0f} GB/s): "
              f"{100 * f_us / p_us:.1f}% of the floor's GB/s | {card}",
              flush=True)


def floor_sweep(torch, card: str) -> None:
    """``tools.kernel_opt.sweep()``: every variant at each launch size of
    ``SWEEP_M``, each bit-exact, with rgb_kernel's share of its floor."""
    from pim_jpeg_decoder_tpu_torch.tools import kernel_opt

    t0 = time.monotonic()
    table = kernel_opt.sweep()
    torch.cuda.empty_cache()
    mode = kernel_opt.MODE
    for m, record in table.items():
        inexact = [n for n, r in record.items() if r["bit_exact"] is not True]
        if inexact:
            fail(f"tools.kernel_opt sweep at M={m}: not bit-exact: {inexact}")
        us = {n: r["us"] for n, r in record.items()}
        mb = m * (mode.g * 64 * 2 + 3 * mode.luma_slots * 64) / 1e6
        print(f"[4 times] kernel_opt sweep 4:2:0 M={m} ({-(-m // 64)} blocks "
              f"of 64), us int16 [int8]: floor {us['memfloor']} "
              f"[{us['memfloor_i8']}] ({mb / us['memfloor'] * 1e3:.0f} GB/s "
              f"of {mb:.1f} MB int16), rgb_kernel {us['prod']} "
              f"[{us['prod_i8']}], truerez {us['chroma_truerez']}, stacked "
              f"{us['stacked']}; rgb_kernel at "
              f"{100 * us['memfloor'] / us['prod']:.1f}% "
              f"[{100 * us['memfloor_i8'] / us['prod_i8']:.1f}%] of the "
              f"floor's GB/s | {card}", flush=True)
    print(f"[4 times] kernel_opt sweep: {len(table)} launch sizes, every "
          f"variant bit-exact, in {time.monotonic() - t0:.1f} s", flush=True)


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
              f"{bound_note(b)}); plain PyTorch {us_band(p)}; 30/20 "
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
        staged_bufs.append([t.to(dev) for t in staged.arrays])
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
        decode_mcus, decode_mcus_reference, raster_epilogue,
        raster_epilogue_reference)

    rng = np.random.default_rng(SEED + 4)
    bufs, st = batch_inputs(torch, dev, blobs, rng)
    mode, m_full = st.mode, bufs[0][0].shape[0]
    batch = len(st.headers)
    # Scale 2 of 4:2:0: each luma block a 4x4 reduced IDCT, each chroma
    # block an 8x8 one (not upsampled); 16 RGB pixels a luma slot.
    scaled_mcu_ops = (mode.luma_slots * reduced_idct_ops(4, 4)
                      + 2 * reduced_idct_ops(8, 8)
                      + mode.g * DEQUANT_BLOCK_OPS
                      + mode.luma_slots * 16 * COLOR_PIXEL_OPS)
    for m in (m_full, 16384):
        sub = [(c[:m], q[:m], qp) for c, q, qp in bufs]
        mb = sub[0][0].numel() / 1e6 + 3 * mode.luma_slots * 16 * m / 1e6
        k = time_band(lambda b: decode_mcus(*b, mode, raw=True, scale=2),
                      sub)
        p = time_band(lambda b: decode_mcus_reference(
            *b, mode, raw=True, scale=2), sub, runs=10)
        b = bound(mb * 1e6 + (m + sub[0][2].numel()) * 4, m * scaled_mcu_ops)
        if m == m_full:
            times["rgb_scaled"] = timing(k, p, b)
        print(f"[4 times] rgb_scaled kernel 4:2:0 scale 2 M={m} int8 wire: "
              f"{us_band(k)}/launch ({mb / k[0]:.0f} GB/s of {mb:.1f} MB; "
              f"{bound_note(b)}); plain PyTorch {us_band(p)}; 30/10 "
              f"launches over 10 rotating inputs | {card}", flush=True)
    for scale, dtype_name in ((2, "bfloat16"), (1, None)):
        raws = [decode_mcus(*b, mode, raw=True, scale=scale) for b in bufs]
        _, norm = batch_options(torch, dtype_name)
        h0 = st.headers[0]
        args = (mode, scale, batch, st.gh, st.gw, -(-h0.height // scale),
                -(-h0.width // scale))
        k = time_band(lambda r: raster_epilogue(r, *args, norm=norm), raws)
        p = time_band(lambda r: raster_epilogue_reference(
            r, *args, norm=norm), raws, runs=10)
        out_elems = batch * args[-2] * args[-1] * 3
        out_bytes = out_elems * (2 if dtype_name else 1)
        mb = (raws[0].numel() + out_bytes) / 1e6
        # A subtract and a multiply an element when normalising.
        b = bound(mb * 1e6, 2 * out_elems if dtype_name else 0, FP32_FLOPS)
        if scale == 2:
            times["raster"] = timing(k, p, b)
        print(f"[4 times] raster epilogue B={batch} scale {scale} -> "
              f"{dtype_name or 'uint8'} [{batch}, {args[-2]}, {args[-1]}, 3]"
              f": {us_band(k)}/launch ({mb / k[0]:.0f} GB/s of {mb:.1f} MB; "
              f"{bound_note(b)}); plain PyTorch {us_band(p)}; 30/10 launches "
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
              f"seconds of a synchronised run: {split} | {card}",
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
        if name in ("mxu2pass", "mxu64"):
            times[name] = timing(k, p, b, lib[0])
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
    k = time_band(lambda s: vlc(s, data, lut), seeds)
    p = time_band(lambda s: vlc_reference(s, data, lut), seeds, runs=5)
    clock = max_sm_clock_hz()
    b = (nsym * VLC_CYCLES_PER_SYMBOL / clock * 1e3, "operations")
    times["vlc"] = timing(k, p, b)
    print(f"[4 times] vlc kernel, {vlc_bench.NWORDS} words, {nsym} symbols, "
          f"{bits} bits: {us_band(k)}/launch ({nsym / k[0] / 1e3:.2f} "
          f"Msymbols/s, {k[0] * 1e6 / nsym:.2f} ns a symbol; bound "
          f"{b[0] * 1e3:.2f} us: {VLC_CYCLES_PER_SYMBOL} dependent cycles a "
          f"symbol at the {clock / 1e9:.3f} GHz maximum SM clock); plain "
          f"Python loop {us_band(p)}; 30/5 launches | {card}", flush=True)


def kernel_bounds(times: dict, card: str) -> None:
    """Each kernel's median time against its bound, and its share of it."""
    for name, t in times.items():
        print(f"[4 times] bound {JSON_NAMES.get(name, f'decode_{name}')}: "
              f"{t['ms'] * 1e3:.2f} us vs {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}), {100 * t['bound_ms'] / t['ms']:.1f}% of "
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

def main() -> int:
    import torch

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
        # The ImageNet-like photos (the corpus's first 32), and every
        # 4:2:0 image for the crop batch.
        imagenet = paths[:CORPUS[0][0]]
        crop_paths = [p for p, kw in zip(paths, corpus_kwargs())
                      if kw.get("sampling") == "4:2:0"]
        crop_set = ([blobs[p] for p in crop_paths],
                    {1: [oracles[p] for p in crop_paths],
                     2: [scaled_oracles[p] for p in crop_paths]})
        print(f"[3 slice] corpus of {len(paths)} JPEGs encoded and oracle "
              f"rasters (full and 1/2 scale) built in "
              f"{time.monotonic() - t0:.1f} s", flush=True)

        dev = torch.device("cuda", 0)
        max_err = phase_kernels(torch, dev, oracle_images)
        counts = phase_slice(dev, paths, oracles, scaled_oracles)
        counts.update({k: v for k, v in phase_profile(dev, paths, tmp).items()
                       if k in STAGES})
        counts.update({k: v for k, v in phase_batches(
            torch, dev, [blobs[p] for p in imagenet],
            {1: [oracles[p] for p in imagenet],
             2: [scaled_oracles[p] for p in imagenet]},
            crop_set).items() if k in ("rgb_scaled", "raster")})
        record, tool_counts = phase_tool()
        counts.update({k: tool_counts[k] for k in KERNEL_OPT_COUNTERS})
        counts.update(phase_ab_tools())
        floor_shares(record, card)
        floor_sweep(torch, card)
        times = phase_times(torch, dev, card, paths)
        phase_batch_times(torch, dev, card, [blobs[p] for p in imagenet],
                          times)
        phase_ab_times(torch, dev, card, times)
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
