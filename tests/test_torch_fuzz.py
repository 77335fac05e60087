"""The port's fuzz campaign (``pim_jpeg_decoder_tpu_torch/tools/fuzz.py``)
against the JAX package's ``tools/fuzz.py``, on the CPU.

The port's input generator and table generators must equal the JAX side's
draw for draw (tolerance 0: bytes and integer tables); without PIL the
generator must draw the same numbers.  The port's engine on the CPU (the
kernels' plain versions) and the JAX engine (Pallas in interpret mode, as
``tests/test_fuzz.py`` runs it) take the same fuzz inputs, valid, truncated
and byte-flipped, and must agree on every outcome and pixel.  A seeded mini
campaign runs as the tool runs, each check runs once on its own, and
nothing is skipped quietly: a CUDA device without a card exits 2, and the
table checks fail without the native library.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pim_jpeg_decoder_tpu.runtime.engine import DecodeEngine as JaxEngine
from pim_jpeg_decoder_tpu.utils.config import EngineConfig as JaxConfig
from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
from pim_jpeg_decoder_tpu_torch.tools import fuzz
from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig
from tests.test_native import TestRandomTableDifferential as JaxTables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = (0, 1, 2)
DRAWS = (67, 67, 66)     # 200 draws over the three seeds


@pytest.fixture(scope="module")
def jax_fuzz():
    """The JAX package's tools/fuzz.py, loaded by path (``tools`` is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_fuzz", os.path.join(REPO, "tools", "fuzz.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _state(rng):
    return rng.bit_generator.state["state"]["state"]


@pytest.mark.parametrize("seed,draws", zip(SEEDS, DRAWS))
def test_random_jpeg_bytes_equal_jax_tool(jax_fuzz, seed, draws):
    ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    names = set()
    for i in range(draws):
        name, data = fuzz.random_jpeg(ours)
        assert (name, data) == jax_fuzz.random_jpeg(theirs), (seed, i)
        assert _state(ours) == _state(theirs)
        names.add(name[:3])
    assert names == {"enc", "pil"}


@pytest.mark.parametrize("seed,draws", zip(SEEDS, DRAWS))
def test_random_jpeg_without_pil_draws_the_same_numbers(monkeypatch, seed,
                                                         draws):
    """The card's machine has no PIL: the same generator state after every
    draw, and every input a JPEG the port's scanner parses."""
    with_pil, without = np.random.default_rng(seed), np.random.default_rng(
        seed)
    for i in range(draws):
        fuzz.random_jpeg(with_pil)
        monkeypatch.setattr(fuzz, "pil_image", lambda: None)
        name, data = fuzz.random_jpeg(without)
        monkeypatch.undo()
        assert _state(with_pil) == _state(without), (seed, i)
        assert name.startswith("enc_q")
        assert not scan_jpeg(data).progressive


@pytest.mark.parametrize("name", ["_complete_huffman", "_random_huffman"])
def test_table_generators_equal_jax_tests(name):
    ours, theirs = np.random.default_rng(5), np.random.default_rng(5)
    for i in range(200):
        table_class = i % 2
        a = getattr(fuzz, name)(ours, table_class, i % 4)
        b = getattr(JaxTables, name)(theirs, table_class, i % 4)
        assert (a.table_id, a.table_class) == (b.table_id, b.table_class)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.symbols, b.symbols)
        assert a.counts.dtype == b.counts.dtype == np.uint8
        assert _state(ours) == _state(theirs)


def _shared_inputs(n=24, seed=7):
    """Fuzz inputs from the port's generator: valid, truncated and
    byte-flipped, as the campaign makes them."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        name, data = fuzz.random_jpeg(rng)
        if i % 4 == 1:
            cut = int(rng.integers(2, len(data)))
            name, data = f"{name}_trunc{cut}", data[:cut]
        elif i % 4 == 2:
            mutated = bytearray(data)
            mutated[int(rng.integers(0, len(data)))] ^= int(
                rng.integers(1, 256))
            name, data = f"{name}_flip", bytes(mutated)
        items.append((f"{i}_{name}", data))
    return items


# The campaign's default engine, and a small geometry with banded launches
# over 8-MCU lane tiles, the RGB transport and the int16 wire.
GEOMETRIES = {
    "default": dict(budget_mcus=1024, lane_tile=128, prepare_threads=2),
    "small_banded_rgb_i16": dict(budget_mcus=32, lane_tile=8,
                                 max_launch_mcus=32, transport="rgb",
                                 wire="i16", max_images_per_batch=4,
                                 prepare_threads=2),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_engines_agree_on_fuzz_inputs(geometry):
    items = _shared_inputs()
    kw = GEOMETRIES[geometry]
    theirs = JaxEngine(keep_rgb=True, config=JaxConfig(
        num_devices=1, **kw)).decode_named_blobs(items)
    ours = DecodeEngine(keep_rgb=True, config=EngineConfig(**kw),
                        device="cpu").decode_named_blobs(items)
    outcomes = []
    for (name, _), a, b in zip(items, ours.results, theirs.results):
        assert a.name == b.name == name
        assert a.ok == b.ok, (name, a.error, b.error)
        if a.ok:
            assert a.rgb.dtype == b.rgb.dtype == np.uint8
            np.testing.assert_array_equal(a.rgb, b.rgb, err_msg=name)
        outcomes.append(a.ok)
    assert 0 < sum(outcomes) < len(items)    # both outcomes were drawn


def test_seeded_mini_campaign_subprocess():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "pim_jpeg_decoder_tpu_torch.tools.fuzz",
         "48", "1234", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=280, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["ok"], stats
    assert stats["valid"] > 0 and stats["mismatch"] == 0
    assert stats["device"] == "cpu" and stats["iterations"] == 48
    for key in ("corrupt_ok", "corrupt_decoded", "failures", "seconds",
                *fuzz.TRIAL_COUNTERS):
        assert key in stats
    # The plain versions launch no kernel; none was counted.
    assert not any(stats["launches"].values())


@pytest.mark.parametrize("check,counter", [
    ("stream_check", "stream_batches"),
    ("mesh_check", "mesh_trials"),
    ("table_check", "table_trials"),
    ("prog_table_check", "prog_table_trials"),
    ("mixed_crop_check", "mixed_crop_trials"),
])
def test_each_check_runs_on_its_own(check, counter):
    campaign = fuzz.Campaign(seed=11, device="cpu")
    for _ in range(3):
        getattr(campaign, check)()
    assert campaign.stats["mismatch"] == 0, campaign.stats["failures"]
    assert campaign.stats[counter] >= 3


def test_random_engines_cover_every_lane_tile_on_the_device():
    campaign = fuzz.Campaign(seed=3, device="cpu")
    engines = [campaign.random_engine() for _ in range(40)]
    assert {e.lane_tile for e in engines} == set(fuzz.ENGINE_TILES)
    assert {e.scale for e in engines} == {1, 2, 4, 8}
    assert all(e.devices == (campaign.device,) for e in engines)


def test_cuda_device_exits_2_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    assert fuzz.main(["4", "1"]) == 2
    assert fuzz.main(["4", "1", "--device", "cuda:0"]) == 2
    captured = capsys.readouterr()
    assert "is_available() is False" in captured.err
    assert captured.out == ""


@pytest.mark.parametrize("check", ["table_check", "prog_table_check"])
def test_table_checks_fail_without_the_native_library(monkeypatch, check):
    monkeypatch.setenv("PIM_JPEG_TPU_NO_NATIVE", "1")
    campaign = fuzz.Campaign(seed=0, device="cpu")
    getattr(campaign, check)()
    assert campaign.stats["mismatch"] == 1
    assert campaign.stats["failures"] == [
        (check.replace("_check", ""), "native library did not load")]
