"""Per-phase device timing for the CLI "Profiles:" block.

Counterpart of ``pim_jpeg_decoder_tpu/runtime/device_profile.py``.  The
reference reads per-DPU-phase cycle counters (init / dequantization /
inverse DCT / colour conversion) every run.  The production kernel here is
one fused CUDA kernel with no phase boundaries, so the breakdown is
measured, not counted: the unfused stage kernels (:mod:`..ops.
stage_kernels`) and the fused kernel are timed with CUDA events
(:mod:`..utils.devbench`) at each launch geometry the engine observed,
on synthetic inputs of that exact geometry (M, wire, quantizer-pool depth
Q), rotated past the L2.

Measurements are cached on disk (``CACHE_PATH``), keyed by the card's name,
the kernel library's build hash and the launch geometry, so a kernel
change never reads stale numbers and only the first profiled run of a
geometry pays the measurement.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

_CACHE_VERSION = 1
CACHE_PATH = os.path.join(tempfile.gettempdir(), "pim_jpeg_tpu_torch",
                          "phase_cache.json")

# (mode_key, m, lane_tile, transport, scale, wire, q): the JAX package's
# launch key.  wire is "i8" (compact coefficient wire) or "i16"; q is the
# quantizer-pool depth (max_images_per_batch for packed batches, 1 for
# dedicated and banded launches).
LaunchKey = Tuple[Tuple[int, int, int], int, int, str, int, str, int]


def _load_cache() -> Dict[str, Dict[str, float]]:
    try:
        with open(CACHE_PATH) as f:
            data = json.load(f)
        if data.get("version") == _CACHE_VERSION:
            return data.get("entries", {})
    except (OSError, ValueError):
        pass
    return {}


def _save_cache(entries: Dict[str, Dict[str, float]]) -> None:
    try:
        os.makedirs(os.path.dirname(CACHE_PATH), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(CACHE_PATH))
        with os.fdopen(fd, "w") as f:
            json.dump({"version": _CACHE_VERSION, "entries": entries}, f)
        os.replace(tmp, CACHE_PATH)
    except OSError:
        pass  # the cache saves time only; never fail the report over it


def _cache_key(key: LaunchKey, device) -> str:
    from pim_jpeg_decoder_tpu_torch.ops import _build

    mode_key, m, lane_tile, transport, scale, wire, q = key
    return "|".join([torch.cuda.get_device_name(device),
                     os.path.basename(_build.build_dir()),
                     "x".join(map(str, mode_key)), str(m), str(lane_tile),
                     transport, str(scale), wire, str(q)])


def time_phases(key: LaunchKey, device="cuda") -> Dict[str, float]:
    """Microseconds per launch of the fused kernel (``fused_us``) and of
    each stage kernel (``dequantize_us``, ``idct_us``, ``color_us``) at
    one launch geometry, measured now (no cache).  ``color_us`` is absent
    for the YCbCr transport (colour runs on the host there); scaled decode
    reports ``fused_us`` only (the stage kernels are full-scale)."""
    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import decode_mcus
    from pim_jpeg_decoder_tpu_torch.ops.stage_kernels import (
        color_stage, dequantize_stage, idct_stage)
    from pim_jpeg_decoder_tpu_torch.utils.devbench import (
        RUNS, rotation_count, seconds_per_launch)

    mode_key, m, _, transport, scale, wire, q = key
    mode = S.mode_for(mode_key)
    device = torch.device(device)
    dtype, lo, hi = ((torch.int8, -100, 100) if wire == "i8"
                     else (torch.int16, -200, 200))
    # Past RUNS buffers no launch would read the rest.
    n_rot = min(rotation_count(m * mode.g * 64 * dtype.itemsize, device),
                RUNS)
    gen = torch.Generator(device).manual_seed(0)
    coeffs = torch.randint(lo, hi, (n_rot, m, mode.g, 64), dtype=dtype,
                           device=device, generator=gen)
    qpools = torch.randint(1, 64, (n_rot, q, mode.g, 64), dtype=torch.int32,
                           device=device, generator=gen)
    qidx = (torch.arange(m, device=device) % q).to(torch.int32)
    inputs = list(zip(coeffs, qpools))

    def us(fn, bufs) -> float:
        return round(seconds_per_launch(fn, bufs) * 1e6, 1)

    ycbcr = transport == "ycbcr"
    out = {"fused_us": us(lambda b: decode_mcus(
        b[0], qidx, b[1], mode, raw=not ycbcr, ycbcr=ycbcr, scale=scale),
        inputs)}
    if scale == 1:
        out["dequantize_us"] = us(
            lambda b: dequantize_stage(b[0], qidx, b[1], mode), inputs)
        deqs = [dequantize_stage(c, qidx, qp, mode) for c, qp in inputs]
        out["idct_us"] = us(lambda d: idct_stage(d, mode), deqs)
        if not ycbcr:
            spats = [idct_stage(d, mode) for d in deqs]
            out["color_us"] = us(lambda s: color_stage(s, mode, raw=True),
                                 spats)
    return out


def measure_phases(key: LaunchKey, cached_only: bool = False,
                   device="cuda") -> Optional[Dict[str, float]]:
    """:func:`time_phases` of one launch geometry, from the disk cache when
    it has the geometry for this card and kernel build; else measured now
    and cached, or None with ``cached_only`` (which launches nothing)."""
    ck = _cache_key(key, device)
    cached = _load_cache().get(ck)
    if cached is not None or cached_only:
        return cached
    out = time_phases(key, device)
    cache = _load_cache()
    cache[ck] = out
    _save_cache(cache)
    return out


def phase_report_lines(launch_stats: Dict[LaunchKey, int],
                       measure: bool = True, device="cuda") -> List[str]:
    """Profile-block lines for the observed launches.

    ``launch_stats`` maps launch geometry -> launch count (collected by the
    engine).  Totals are phase µs x launch count, the accounting the
    reference applies to its accumulated DPU cycle counters.  With
    ``measure=False`` only cached measurements are used (nothing is
    launched); geometries without one are reported as unmeasured.
    """
    totals = {"dequantize_us": 0.0, "idct_us": 0.0, "color_us": 0.0,
              "fused_us": 0.0}
    covered = {k: 0 for k in totals}   # launches contributing to each line
    measured_launches = 0
    total_launches = sum(launch_stats.values())
    for key, count in launch_stats.items():
        phases = measure_phases(key, cached_only=not measure, device=device)
        if not phases:
            continue
        measured_launches += count
        for name, v in phases.items():
            totals[name] += v * count
            covered[name] += count

    if measured_launches == 0:
        return [" - Device phase breakdown: unavailable (no cached "
                "measurement; run with --device-profile)"]
    lines = [f" - GPU kernel device time (measured, {measured_launches}"
             f"/{total_launches} launches): "
             f"{totals['fused_us'] / 1e6:.6f} (s)"]
    label = {
        "dequantize_us": "Device dequantization time",
        "idct_us": "Device inverse DCT time",
        "color_us": "Device color conversion time",
    }
    for k, lab in label.items():
        if totals[k]:
            # Stage lines cover only geometries with stage kernels (scale
            # 1; colour only for the RGB transport): say so for a mix.
            cov = ("" if covered[k] == measured_launches
                   else f", {covered[k]}/{measured_launches} launches")
            lines.append(f"   - {lab} (unfused-equivalent{cov}): "
                         f"{totals[k] / 1e6:.6f} (s)")
    return lines
