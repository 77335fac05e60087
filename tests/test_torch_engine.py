"""The PyTorch port's engine and CLI against the JAX package's.

Both run on the CPU here: the port's ``DecodeEngine(device="cpu")`` through
the plain PyTorch versions of the CUDA kernels, the JAX engine through the
Pallas kernels in interpret mode (one device, no mesh).  The BMP files must
be byte-identical (sha1), with the same per-file failures and exit codes.
"""

import dataclasses
import hashlib
import os
import shutil

import numpy as np
import pytest

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle
from pim_jpeg_decoder_tpu.utils.config import EngineConfig
from pim_jpeg_decoder_tpu_torch.runtime import batching as B
from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine

# Small launches so the corpus exercises packed, dedicated (> budget) and
# banded (> max launch) routes: budget 128 MCUs, launch cap 256.
SMALL_ENV = {"PIM_JPEG_TPU_BUDGET_MCUS": "128",
             "PIM_JPEG_TPU_LANE_TILE": "128",
             "PIM_JPEG_TPU_MAX_LAUNCH": "256",
             "PIM_JPEG_TPU_NUM_DEVICES": "1",
             "PIM_JPEG_TPU_PREPARE_THREADS": "2"}


def _photo(rng, h, w):
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(small, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


CORPUS = [
    ("p420.jpg", (48, 64), dict(sampling="4:2:0")),
    ("p444.jpg", (40, 56), dict(sampling="4:4:4")),
    ("p422.jpg", (37, 61), dict(sampling="4:2:2")),
    ("p440.jpg", (45, 30), dict(sampling="4:4:0")),
    ("gray.jpg", (50, 70), dict(grayscale=True)),
    ("dri.jpg", (64, 80), dict(sampling="4:2:0", restart_interval=3)),
    ("dedicated.jpg", (176, 208), dict(sampling="4:2:0")),    # 143 MCUs
    ("big444.jpg", (120, 136), dict(sampling="4:4:4")),       # 255 MCUs
    ("banded.jpg", (300, 260), dict(sampling="4:2:0")),       # 323 MCUs
]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine_corpus")
    rng = np.random.default_rng(42)
    for name, (h, w), kw in CORPUS:
        (root / name).write_bytes(encode_jpeg(_photo(rng, h, w), quality=80,
                                              **kw))
    (root / "corrupt.jpg").write_bytes(
        (root / "p420.jpg").read_bytes()[:300] + bytes(64))
    return root


def _copy(corpus, dst):
    dst.mkdir()
    for p in corpus.iterdir():
        shutil.copy(p, dst / p.name)
    return [str(dst / n) for n in sorted(os.listdir(dst))] + [
        str(dst / "missing.jpg")]


def _digests(paths):
    out = {}
    for p in paths:
        bmp = os.path.splitext(p)[0] + ".bmp"
        if os.path.exists(bmp):
            with open(bmp, "rb") as f:
                out[os.path.basename(bmp)] = hashlib.sha1(f.read()).hexdigest()
    return out


def _failed_names(stderr):
    return sorted(os.path.basename(line.split(":")[0])
                  for line in stderr.splitlines() if ".jpg:" in line)


def test_cli_matches_jax_cli(corpus, tmp_path, monkeypatch, capsys):
    from pim_jpeg_decoder_tpu.cli import main as jax_main
    from pim_jpeg_decoder_tpu_torch.cli import main as port_main

    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)
    jax_paths = _copy(corpus, tmp_path / "jax")
    port_paths = _copy(corpus, tmp_path / "port")

    capsys.readouterr()
    jax_rc = jax_main(jax_paths + ["--quiet"])
    jax_err = capsys.readouterr().err
    port_rc = port_main(port_paths + ["--quiet", "--device", "cpu"])
    port_err = capsys.readouterr().err

    assert jax_rc == port_rc == 1
    assert _failed_names(port_err) == _failed_names(jax_err) == [
        "corrupt.jpg", "missing.jpg"]
    jax_bmps, port_bmps = _digests(jax_paths), _digests(port_paths)
    assert len(port_bmps) == len(CORPUS)
    assert port_bmps == jax_bmps


@pytest.mark.parametrize("flags", [["--transport", "rgb"],
                                   ["--transport", "ycbcr"],
                                   ["--wire", "i16"],
                                   ["--no-sort", "--prepare-threads", "1"]])
def test_cli_options_give_identical_bmps(corpus, tmp_path, monkeypatch,
                                         flags):
    from pim_jpeg_decoder_tpu_torch.cli import main

    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)
    base, other = ([p for p in _copy(corpus, tmp_path / d)
                    if os.path.basename(p) not in ("corrupt.jpg",
                                                   "missing.jpg")]
                   for d in ("base", "other"))
    assert main(base + ["--quiet", "--device", "cpu"]) == 0
    assert main(other + ["--quiet", "--device", "cpu", *flags]) == 0
    assert _digests(base) == _digests(other)
    assert len(_digests(base)) == len(CORPUS)


def test_engine_keep_rgb_matches_oracle(corpus, monkeypatch):
    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)
    items = [(n, (corpus / n).read_bytes()) for n, _, _ in CORPUS]
    items.append(("corrupt.jpg", (corpus / "corrupt.jpg").read_bytes()))
    report = DecodeEngine(keep_rgb=True, device="cpu").decode_named_blobs(
        items)
    assert [r.name for r in report.results] == [n for n, _ in items]
    for r, (name, data) in zip(report.results[:-1], items):
        assert r.ok, r.error
        np.testing.assert_array_equal(r.rgb, decode_bytes_oracle(data).rgb)
    assert not report.results[-1].ok
    assert report.ok_count == len(CORPUS)
    assert report.total_megapixels > 0


def test_finish_failure_is_isolated(corpus, monkeypatch):
    """One image's finishing error fails that image only."""
    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)
    engine = DecodeEngine(keep_rgb=True, device="cpu")
    real = engine._finish_image

    def flaky(img, off, raw, ycbcr, write, results):
        if img.name == "p420.jpg":
            raise RuntimeError("disk full")
        return real(img, off, raw, ycbcr, write, results)

    monkeypatch.setattr(engine, "_finish_image", flaky)
    names = ["p420.jpg", "dri.jpg", "gray.jpg"]
    report = engine.decode_named_blobs(
        [(n, (corpus / n).read_bytes()) for n in names])
    by_name = {r.name: r for r in report.results}
    assert not by_name["p420.jpg"].ok
    assert "disk full" in by_name["p420.jpg"].error
    assert by_name["dri.jpg"].ok and by_name["gray.jpg"].ok


def test_duplicate_names_decode_independently(corpus):
    data = (corpus / "p444.jpg").read_bytes()
    report = DecodeEngine(keep_rgb=True, device="cpu", budget_mcus=1024,
                          lane_tile=128).decode_named_blobs(
        [("same", data), ("same", data)])
    assert report.ok_count == 2
    np.testing.assert_array_equal(report.results[0].rgb,
                                  report.results[1].rgb)


@pytest.mark.parametrize("budget,align", [(128, 128), (256, 128),
                                          (1000, 8), (16384, 512)])
def test_packer_matches_jax_packer(corpus, budget, align):
    """Same batches (offsets, coefficients, qidx, quant pool, allocation)
    as the JAX package's packer at the same budget and alignment."""
    from pim_jpeg_decoder_tpu.runtime import batching as JB
    from pim_jpeg_decoder_tpu_torch.models.pipeline import entropy_decode

    def prepared(cls, name):
        header = scan_jpeg((corpus / name).read_bytes())
        return cls(name, header, entropy_decode(header))

    names = [n for n, _, _ in CORPUS if n != "banded.jpg"] * 2
    port = B.ModeRouter(budget, max_images=3, align=align)
    ref = JB.ModeRouter(budget, max_images=3, lane_tile=align)
    got, want = [], []
    for n in names:
        got += port.add(prepared(B.PreparedImage, n))
        want += ref.add(prepared(JB.PreparedImage, n))
    got += port.flush_all()
    want += ref.flush_all()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        # The port's ModeSpec is its own copy's class: compare the fields.
        assert dataclasses.astuple(g.mode) == dataclasses.astuple(w.mode)
        assert ([(i.name, o) for i, o in g.images]
                == [(i.name, o) for i, o in w.images])
        np.testing.assert_array_equal(g.coeffs, w.coeffs)
        np.testing.assert_array_equal(g.qidx, w.qidx)
        np.testing.assert_array_equal(g.qpool, w.qpool)


def test_compact_wire_matches_jax():
    from pim_jpeg_decoder_tpu.runtime.batching import compact_wire as ref
    rng = np.random.default_rng(0)
    small = rng.integers(-128, 128, (5, 6, 64)).astype(np.int16)
    large = small.copy()
    large[3, 2, 7] = 300
    for arr in (small, large, np.zeros((0, 6, 64), np.int16)):
        got, want = B.compact_wire(arr), ref(arr)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", [dict(num_devices=2)])
def test_unported_options_raise(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(config=EngineConfig(**cfg), device="cpu")


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_engine_scale_matches_decode_scaled(corpus, monkeypatch, scale):
    """``scale`` through the engine (packed, dedicated and banded routes)
    gives the single-image ``decode_scaled`` pixels."""
    from pim_jpeg_decoder_tpu_torch.models.pipeline import decode_scaled

    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)
    items = [(n, (corpus / n).read_bytes()) for n, _, _ in CORPUS]
    engine = DecodeEngine(keep_rgb=True, device="cpu",
                          config=EngineConfig.from_env(scale=scale))
    report = engine.decode_named_blobs(items)
    assert report.ok_count == len(CORPUS)
    for r, (name, data) in zip(report.results, items):
        np.testing.assert_array_equal(r.rgb, decode_scaled(data, scale,
                                                           device="cpu"))


def test_engine_refuses_ycbcr_with_scale():
    with pytest.raises(ValueError, match="full-scale only"):
        DecodeEngine(config=EngineConfig(scale=2, transport="ycbcr"),
                     device="cpu")
