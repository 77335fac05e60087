"""The port's device profile: launch geometry, the Profiles block, the phase
cache, the CLI's ``--profile`` / ``--device-profile`` and the timer.

Here on the CPU nothing is timed: a CPU run is not a device time, so the
phase breakdown is checked with a stand-in for the measurement, and the
engine's launch geometry against the JAX engine's on the same blobs.  The
measurement itself runs on the card in chip_smoke.py.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.utils.config import EngineConfig
from pim_jpeg_decoder_tpu_torch.ops import _build
from pim_jpeg_decoder_tpu_torch.runtime import device_profile as DP
from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
from pim_jpeg_decoder_tpu_torch.utils import devbench

# Packed (several images, Q = max_images), dedicated (> budget, Q=1) and
# banded (> launch cap) launches, both transports and both wires.
CFG = dict(budget_mcus=128, lane_tile=128, prepare_threads=1,
           max_launch_mcus=256, num_devices=1)
IMAGES = [
    ("p420.jpg", (48, 64), dict(sampling="4:2:0")),
    ("p444.jpg", (40, 56), dict(sampling="4:4:4")),
    ("gray.jpg", (50, 70), dict(grayscale=True)),
    ("dedicated.jpg", (176, 208), dict(sampling="4:2:0")),    # 143 MCUs
    ("banded.jpg", (300, 260), dict(sampling="4:2:0")),       # 323 MCUs
]
RGB_KEY = ((1, 1, 3), 128, 128, "rgb", 1, "i8", 16)
YCBCR_KEY = ((2, 2, 3), 256, 128, "ycbcr", 1, "i16", 1)
SCALED_KEY = ((2, 2, 3), 128, 128, "rgb", 2, "i8", 16)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(3)
    out = []
    for name, (h, w), kw in IMAGES:
        small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
        img = np.kron(small, np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
        out.append((name, encode_jpeg(img, quality=80, **kw)))
    return out


@pytest.fixture(scope="module")
def reports(blobs):
    from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine as JaxEngine

    port = DecodeEngine(config=EngineConfig(**CFG), device="cpu")
    jax = JaxEngine(config=EngineConfig(**CFG))
    items = blobs * 2
    return port.decode_named_blobs(items), jax.decode_named_blobs(items)


def test_launch_stats_match_the_jax_engine(reports):
    port, jax = reports
    assert port.ok_count == jax.ok_count == 2 * len(IMAGES)
    assert port.launch_stats == jax.launch_stats
    transports = {key[3] for key in port.launch_stats}
    qs = {key[6] for key in port.launch_stats}
    assert transports == {"rgb", "ycbcr"} and qs == {1, 16}


def test_dispatch_times_one_per_launch(reports):
    port, _ = reports
    assert port.dispatch_times.keys() == port.launch_stats.keys()
    for key, count in port.launch_stats.items():
        assert len(port.dispatch_times[key]) == count
        assert all(t >= 0.0 for t in port.dispatch_times[key])
    assert port.timers.snapshot()["kernel"][1] == sum(
        port.launch_stats.values())


def test_print_profile_on_a_cpu_engine_prints_no_device_lines(
        reports, monkeypatch, capsys):
    def no_measure(*args, **kwargs):
        raise AssertionError("a CPU engine must not measure device phases")

    monkeypatch.setattr(DP, "measure_phases", no_measure)
    port, _ = reports
    for mode in ("measure", "cached", "off"):
        port.print_profile(device_phases=mode)
        out = capsys.readouterr().out
        assert out.startswith("Profiles:")
        assert "Decoded files: 10/10" in out
        for absent in ("GPU kernel device time", "phase breakdown",
                       "Device program init"):
            assert absent not in out


def _fake_phases(monkeypatch, table):
    calls = []

    def fake(key, cached_only=False, device="cuda"):
        calls.append((key, cached_only))
        return table.get(key)

    monkeypatch.setattr(DP, "measure_phases", fake)
    return calls


def test_phase_report_lines_arithmetic(monkeypatch):
    """Totals are µs x launch count; the colour line covers the RGB
    launches only and says so; an unmeasured geometry counts in the
    launch total only."""
    calls = _fake_phases(monkeypatch, {
        RGB_KEY: {"fused_us": 10.0, "dequantize_us": 4.0, "idct_us": 5.0,
                  "color_us": 6.0},
        YCBCR_KEY: {"fused_us": 8.0, "dequantize_us": 3.0, "idct_us": 4.0},
    })
    lines = DP.phase_report_lines({RGB_KEY: 2, YCBCR_KEY: 3, SCALED_KEY: 1},
                                  measure=False)
    assert lines == [
        " - GPU kernel device time (measured, 5/6 launches): 0.000044 (s)",
        "   - Device dequantization time (unfused-equivalent): "
        "0.000017 (s)",
        "   - Device inverse DCT time (unfused-equivalent): 0.000022 (s)",
        "   - Device color conversion time (unfused-equivalent, 2/5 "
        "launches): 0.000012 (s)",
    ]
    assert {c for _, c in calls} == {True}          # cached only: no launch
    DP.phase_report_lines({RGB_KEY: 1}, measure=True)
    assert calls[-1] == (RGB_KEY, False)


def test_phase_report_lines_unmeasured_and_scaled(monkeypatch):
    _fake_phases(monkeypatch, {SCALED_KEY: {"fused_us": 7.5}})
    assert DP.phase_report_lines({RGB_KEY: 4}, measure=False) == [
        " - Device phase breakdown: unavailable (no cached measurement; "
        "run with --device-profile)"]
    # Scaled decode has no stage kernels: the fused line only.
    assert DP.phase_report_lines({SCALED_KEY: 2}) == [
        " - GPU kernel device time (measured, 2/2 launches): 0.000015 (s)"]


def test_phase_cache_round_trip(tmp_path, monkeypatch):
    """Measured once, then read from the disk cache; another card or
    another kernel build hash misses, so it never reads stale numbers."""
    timed = []

    def fake_time(key, device="cuda"):
        timed.append(key)
        return {"fused_us": 33.3, "dequantize_us": 22.8, "idct_us": 23.1,
                "color_us": 35.1}

    monkeypatch.setattr(DP, "CACHE_PATH", str(tmp_path / "c" / "p.json"))
    monkeypatch.setattr(DP, "time_phases", fake_time)
    monkeypatch.setattr(DP.torch.cuda, "get_device_name",
                        lambda device=None: "Card A")
    assert DP.measure_phases(RGB_KEY, cached_only=True) is None
    assert timed == []
    first = DP.measure_phases(RGB_KEY)
    assert timed == [RGB_KEY]
    assert DP.measure_phases(RGB_KEY) == first
    assert DP.measure_phases(RGB_KEY, cached_only=True) == first
    assert timed == [RGB_KEY]
    with open(DP.CACHE_PATH) as f:
        assert len(json.load(f)["entries"]) == 1

    real_dir = _build.build_dir()
    monkeypatch.setattr(_build, "build_dir",
                        lambda: os.path.join(os.path.dirname(real_dir),
                                             "0123456789abcdef"))
    assert DP.measure_phases(RGB_KEY, cached_only=True) is None
    monkeypatch.setattr(_build, "build_dir", lambda: real_dir)
    monkeypatch.setattr(DP.torch.cuda, "get_device_name",
                        lambda device=None: "Card B")
    assert DP.measure_phases(RGB_KEY, cached_only=True) is None
    assert timed == [RGB_KEY]


def test_cli_profile_writes_a_trace(blobs, tmp_path, monkeypatch, capsys):
    from pim_jpeg_decoder_tpu_torch.cli import main

    trace_dir = tmp_path / "trace"
    # Registered so that the CLI's own setting is undone after the test.
    monkeypatch.setenv("PIM_JPEG_TPU_PROFILE", str(trace_dir))
    paths = []
    for name, data in blobs[:3]:
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    rc = main([*paths, "--device", "cpu", "--profile", str(trace_dir),
               "--device-profile", "measure"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Decoded files: 3/3" in out
    assert "GPU kernel device time" not in out
    traces = list(trace_dir.iterdir())
    assert len(traces) == 1 and traces[0].suffix == ".json"
    trace = json.loads(traces[0].read_text())
    assert trace["traceEvents"]


def test_cli_rejects_an_unknown_device_profile_mode(tmp_path):
    from pim_jpeg_decoder_tpu_torch.cli import main

    with pytest.raises(SystemExit) as exc:
        main([str(tmp_path / "a.jpg"), "--device", "cpu",
              "--device-profile", "always"])
    assert exc.value.code == 2


@pytest.mark.parametrize("buf_bytes,want", [
    (12_582_912, 9),              # a 16K-MCU 4:2:0 int16 wire: 8.3 -> 9
    (6_291_456, 17),              # the int8 wire
    (200_000_000, 2),             # larger than the L2: at least 2
    (1, 2 * 50 * 2**20),
])
def test_rotation_count_covers_twice_the_l2(monkeypatch, buf_bytes, want):
    monkeypatch.setattr(
        devbench.torch.cuda, "get_device_properties",
        lambda device: types.SimpleNamespace(L2_cache_size=50 * 2**20))
    n = devbench.rotation_count(buf_bytes, "cuda")
    assert n == want
    assert n * buf_bytes >= 2 * 50 * 2**20 or n == 2


@pytest.mark.parametrize("bufs", [
    [torch.zeros(4)],
    [(torch.zeros(4, dtype=torch.int16), torch.zeros(4))],
    [],
])
def test_seconds_per_launch_refuses_cpu_tensors(bufs):
    with pytest.raises(ValueError, match="not a device time"):
        devbench.seconds_per_launch(lambda b: b, bufs)
