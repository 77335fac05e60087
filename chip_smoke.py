#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (nvcc under
PATH or /usr/local/cuda/bin, g++ for the host library).  Uses torch, numpy
and the JAX-free host layer of ``pim_jpeg_decoder_tpu`` only.  Phases:

1. device: card name and power limit, build of ``csrc/*.cu``, native host
   library present;
2. each kernel against its plain PyTorch version on the card, byte for byte
   (tolerance 0: the spec is integer), for every sampling mode, both wires
   and both kernels at M=16,384 and at an odd M=1,001 with extreme blocks;
   the RGB kernel also against the NumPy oracle on real encoded images;
3. the main path: ``python -m pim_jpeg_decoder_tpu_torch`` (``cli.main``)
   on an ImageNet-val-like corpus, every BMP equal to the oracle raster,
   both kernels launched and no plain-version call on the card, the same
   BMPs with ``--transport rgb`` and with banded launches, and per-file
   failures for a corrupt and a missing file;
4. kernel and plain-version times with CUDA events at M=16,384 4:2:0, and
   the engine's end-to-end MP/s on the corpus.

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
KERNEL_SOURCE = "pim_jpeg_decoder_tpu_torch/csrc/decode_kernel.cu"
REPLACES = {
    "rgb": "pim_jpeg_decoder_tpu/ops/decode_kernel.py:178",
    "ycbcr": "pim_jpeg_decoder_tpu/ops/decode_kernel.py:296",
}


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
    from pim_jpeg_decoder_tpu.native import native_available
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


def phase_kernels(torch, dev, oracle_images) -> dict:
    from pim_jpeg_decoder_tpu.ops import specs as S
    from pim_jpeg_decoder_tpu.oracle.decoder import mcu_rgb_from_coeffs
    from pim_jpeg_decoder_tpu_torch.models.pipeline import build_qpool
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, decode_mcus_reference,
        qpool_to_device)

    rng = np.random.default_rng(SEED)
    max_err = {"rgb": 0, "ycbcr": 0}
    cases = 0
    for key in sorted(S.MODES):
        mode = S.mode_for(key)
        for wire in (np.int16, np.int8):
            for m, extreme in ((16384, False), (1001, True)):
                coeffs, qidx, qpool = synthetic_batch(mode, m, wire, rng,
                                                      extreme)
                x = coeffs_to_device(coeffs, dev)
                qi = torch.from_numpy(qidx).to(dev)
                qp = qpool_to_device(qpool, dev)
                for name in ("rgb", "ycbcr"):
                    yc = name == "ycbcr"
                    got = decode_mcus(x, qi, qp, mode, raw=True, ycbcr=yc)
                    want = decode_mcus_reference(x, qi, qp, mode, raw=True,
                                                 ycbcr=yc)
                    torch.cuda.synchronize()
                    err = int((got.int() - want.int()).abs().max())
                    max_err[name] = max(max_err[name], err)
                    if got.shape != want.shape or err:
                        fail(f"{name} kernel != plain version: {mode.name} "
                             f"{np.dtype(wire).name} M={m} max|err|={err}")
                    cases += 1
    n_mcus = 0
    for header, coeffs in oracle_images:
        mode = S.mode_for(header.mode_key)
        x = coeffs_to_device(coeffs, dev)
        qi = torch.zeros(header.num_mcus, dtype=torch.int32, device=dev)
        qp = qpool_to_device(build_qpool([header], mode), dev)
        raw = decode_mcus(x, qi, qp, mode, raw=True).cpu().numpy()
        if not np.array_equal(mcu_raster(mode, raw),
                              mcu_rgb_from_coeffs(header, coeffs)):
            fail(f"rgb kernel != oracle.mcu_rgb_from_coeffs on {mode.name}")
        n_mcus += header.num_mcus
    print(f"[2 kernels] {cases} kernel-vs-plain cases byte-identical on the "
          f"card (5 modes x i16/i8 x M=16384/1001-with-extremes x rgb/ycbcr, "
          f"Q=16; tolerance 0); rgb kernel == NumPy oracle on {n_mcus} MCUs "
          f"of {len(oracle_images)} encoded images", flush=True)
    return max_err


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


def build_corpus(root: str):
    from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg

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
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.native import decode_scan_native
    from pim_jpeg_decoder_tpu.oracle.decoder import (assemble_raster,
                                                     mcu_rgb_from_coeffs)

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


def phase_slice(dev, paths, oracles) -> dict:
    from pim_jpeg_decoder_tpu.io.bmp import read_bmp
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
    return counts


# --- phase 4 -----------------------------------------------------------------

def time_launches(torch, fn, bufs, runs: int = 30) -> float:
    """Median ms per launch: a GPU sleep lets the host queue every launch
    first, so back-to-back events time the device, not the host."""
    for b in bufs[:3]:
        fn(b)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(200_000_000)
    events[0].record()
    for i in range(runs):
        fn(bufs[i % len(bufs)])
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(runs))


def phase_times(torch, dev, card: str, paths) -> dict:
    from pim_jpeg_decoder_tpu.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, decode_mcus_reference,
        qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine

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
        for name in ("rgb", "ycbcr"):
            yc = name == "ycbcr"
            k_ms = time_launches(torch, lambda b: decode_mcus(
                *b, mode, raw=True, ycbcr=yc), bufs)
            p_ms = time_launches(torch, lambda b: decode_mcus_reference(
                *b, mode, raw=True, ycbcr=yc), bufs, runs=20)
            wname = np.dtype(wire).name
            times[name, wname] = (k_ms, p_ms)
            mb_out = (mode.g if yc else 3 * mode.luma_slots) * 64 * m / 1e6
            print(f"[4 times] {name} kernel 4:2:0 M={m} {wname} wire: "
                  f"{k_ms * 1e3:.1f} us/launch ({(mb_in + mb_out) / k_ms:.0f}"
                  f" GB/s of {mb_in + mb_out:.1f} MB); plain PyTorch "
                  f"{p_ms * 1e3:.1f} us; median of 30/20 launches over 10 "
                  f"rotating inputs | {card}", flush=True)
        del bufs
    torch.cuda.empty_cache()

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
    print(f"[4 times] {device_busy(torch, engine, paths)} | {card}",
          flush=True)
    return times


def device_busy(torch, engine, paths) -> str:
    """One traced engine run: the union of device activity (kernels and
    copies) over the run's wall time, and the device ops that took most."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.decode_paths(paths, write=True)
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
    return (f"traced engine run: wall {wall:.4f} s, device busy "
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
        oracles, oracle_images, seen = {}, [], set()
        for p in paths:
            with open(p, "rb") as f:
                header, coeffs, raster = oracle_raster(f.read())
            oracles[p] = raster
            if header.mode_key not in seen and header.num_mcus < 10000:
                seen.add(header.mode_key)
                oracle_images.append((header, coeffs))
        print(f"[3 slice] corpus of {len(paths)} JPEGs encoded and oracle "
              f"rasters built in {time.monotonic() - t0:.1f} s", flush=True)

        dev = torch.device("cuda", 0)
        max_err = phase_kernels(torch, dev, oracle_images)
        counts = phase_slice(dev, paths, oracles)
        times = phase_times(torch, dev, card, paths)

    kernels = [{
        "name": f"decode_{name}",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES[name],
        "launches": counts[name],
        "max_abs_err": max_err[name],
        "ms": times[name, "int8"][0],
        "plain_ms": times[name, "int8"][1],
    } for name in ("rgb", "ycbcr")]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
