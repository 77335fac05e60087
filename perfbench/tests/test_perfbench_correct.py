"""The comparison that decides ``correct``, on the CPU at a small size
through the cells' own entry points: the program passes, the control
(the reference in a lower precision in the program's place) fails, and
so does a run whose timed path is broken underneath."""

import numpy as np
import pytest

from conftest import run_small
from harness import jpeg_ref

WORKLOADS = ("loader-laion256", "engine-imagenet-val")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_matches_reference(workload):
    out = run_small(workload)
    assert out.result["correct"], out.result["compared"]
    assert out.result["attempted"] > 0 and out.result["failed"] == 0
    gap = next(iter(out.result["compared"].values()))
    assert gap["value"] == 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(workload):
    out = run_small(workload, control=True)
    limits = {k: v["limit"] for k, v in out.result["compared"].items()}
    assert any(v > limits[k] for k, v in out.control.items()), out.control


def test_reference_decodes_restart_segments_and_both_modes():
    """jpeg_ref against the port's host decode (C++ entropy + NumPy
    oracle) on PIL files: 4:2:0 and 4:4:4, with and without restart
    markers, pixel for pixel; the float16 control differs."""
    import io

    from PIL import Image

    from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu_torch.models.pipeline import entropy_decode
    from pim_jpeg_decoder_tpu_torch.oracle.decoder import (
        assemble_raster, mcu_rgb_from_coeffs)
    rng = np.random.default_rng(5)
    for sub, rows in ((2, 0), (0, 0), (2, 1), (0, 2)):
        img = np.clip(rng.normal(128, 60, (67, 93, 3)), 0, 255).astype(
            np.uint8)
        buf = io.BytesIO()
        kw = {"restart_marker_rows": rows} if rows else {}
        Image.fromarray(img).save(buf, "JPEG", quality=90, subsampling=sub,
                                  **kw)
        data = buf.getvalue()
        header = scan_jpeg(data)
        port = assemble_raster(header, mcu_rgb_from_coeffs(
            header, entropy_decode(header)))
        assert np.array_equal(jpeg_ref.decode_rgb(data), port)
        assert not np.array_equal(jpeg_ref.decode_rgb(data, "float16"), port)


def _patch_loader(monkeypatch, fault):
    from pim_jpeg_decoder_tpu_torch.models import input_pipeline
    original = input_pipeline.iter_decode_batches

    def broken(*args, **kwargs):
        prev = None
        for out, headers in original(*args, **kwargs):
            if fault == "state_unchanged" and prev is not None:
                out = prev
            elif fault == "half_left_out":
                half = out.shape[0] // 2
                out = out.clone()
                out[half:] = out[:out.shape[0] - half]
            elif fault == "answer_altered":
                out = out.clone()
                out[0] = out[0].roll(1, dims=1)
            prev = out
            yield out, headers
    monkeypatch.setattr(input_pipeline, "iter_decode_batches", broken)


def _patch_engine(monkeypatch, fault):
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
    original = DecodeEngine.decode_named_blobs
    last = []

    def broken(self, items, write=False):
        report = original(self, items, write)
        if fault == "state_unchanged":
            if last:
                report = last[0]
            last[:] = [report]
        elif fault == "half_left_out":
            for res in report.results[len(report.results) // 2:]:
                res.ok, res.rgb = False, None
        elif fault == "answer_altered":
            for res in report.results:
                if res.rgb is not None:
                    res.rgb[0, 0, 0] ^= 1
        return report
    monkeypatch.setattr(DecodeEngine, "decode_named_blobs", broken)


@pytest.mark.parametrize("fault", ("state_unchanged", "half_left_out",
                                   "answer_altered"))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    if workload.startswith("loader"):
        _patch_loader(monkeypatch, fault)
    else:
        _patch_engine(monkeypatch, fault)
    out = run_small(workload)
    assert not out.result["correct"], (fault, out.result["compared"])


def test_engine_rate_counts_its_own_pixels(monkeypatch):
    """``engine_mp_per_s`` counts the megapixels of the benchmark's own
    files: a program that reports its files' megapixels otherwise (a
    padded grid, a scaled output) moves nothing."""
    import torch

    from conftest import small_cell
    from harness import corpus, spec
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
    workload, seed = "engine-imagenet-val", 2**35 + 1
    cell = spec.load_cell(workload)
    traffic, config = small_cell(workload)
    files = corpus.build_corpus(torch, traffic, seed, "cpu")
    original = DecodeEngine.decode_named_blobs
    want = []

    def inflated(self, items, write=False):
        report = original(self, items, write)
        for (name, _), res in zip(items, report.results):
            f = files[int(name.split("_")[1])]
            want.append(f.height * f.width / 1e6)
            res.megapixels *= 4
        return report
    monkeypatch.setattr(DecodeEngine, "decode_named_blobs", inflated)
    entry = cell.entry(torch, config, traffic, files,
                       corpus.calls(traffic, len(files), seed),
                       torch.device("cpu"), False, np.random.default_rng(0))
    win = entry.window(0.2, False)
    assert win["failed"] == 0 and want
    assert win["megapixels"] == pytest.approx(sum(want))
    assert cell.readers["engine_mp_per_s"].read(win) == pytest.approx(
        sum(want) / win["seconds"])
