"""The traffic generator: deterministic for a seed, and the files are the
ones each cell names (sizes, modes, qualities, restart intervals, bits a
pixel)."""

import os

import numpy as np
import pytest
import torch

from harness import corpus, jpeg_ref, spec

WORKLOADS = ("loader-laion256", "engine-imagenet-val", "engine-camera-12mp")
# Bits a pixel each cell's traffic is to reach, by sampling.
BPP = {"loader-laion256": {"4:2:0": (2.0, 3.0)},
       "engine-imagenet-val": {"4:2:0": (4.5, 5.8), "4:4:4": (4.5, 5.8)},
       "engine-camera-12mp": {"4:2:0": (1.7, 3.3)}}
QUALITY_DC = {95: 2, 90: 3}    # libjpeg's luminance DC step at the quality


def _first_of_each_group(traffic):
    t = dict(traffic)
    t["groups"] = [dict(g, count=1) for g in traffic["groups"]]
    return t


@pytest.mark.parametrize("workload", WORKLOADS)
def test_same_seed_same_files_and_calls(workload):
    traffic = _first_of_each_group(spec.load_cell(workload).traffic)
    for g in traffic["groups"]:
        g["height"], g["width"] = g["height"] // 4, g["width"] // 4
    a = corpus.build_corpus(torch, traffic, 2**40 + 3, "cpu")
    b = corpus.build_corpus(torch, traffic, 2**40 + 3, "cpu")
    c = corpus.build_corpus(torch, traffic, 2**40 + 4, "cpu")
    assert [f.data for f in a] == [f.data for f in b]
    assert [f.data for f in a] != [f.data for f in c]
    calls_a = corpus.calls(spec.load_cell(workload).traffic, 7, 2**40 + 3)
    calls_b = corpus.calls(spec.load_cell(workload).traffic, 7, 2**40 + 3)
    for _ in range(3):
        assert np.array_equal(next(calls_a), next(calls_b))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_files_are_the_named_ones(workload):
    cell = spec.load_cell(workload)
    traffic = _first_of_each_group(cell.traffic)
    files = corpus.build_corpus(torch, traffic, 12345, "cpu")
    assert len(files) == len(traffic["groups"])
    for f, g in zip(files, traffic["groups"]):
        info = jpeg_ref.parse(f.data)
        frame = info["frame"]
        assert (frame["height"], frame["width"]) == (g["height"], g["width"])
        h, v = corpus.FACTORS[g["sampling"]]
        assert [(c["h"], c["v"]) for c in frame["comps"]] == [
            (h, v), (1, 1), (1, 1)]
        assert info["qt"][0][0] == QUALITY_DC[g["quality"]]
        cols = -(-g["width"] // (8 * h))
        assert info["restart"] == g["restart_rows"] * cols
        lo, hi = BPP[workload][g["sampling"]]
        assert lo <= f.bpp <= hi, (g, f.bpp)


def test_cells_counts_and_mix():
    """ImageNet-val traffic: 256 distinct files, 1 in 8 at 4:4:4, four
    sizes; the loader's 512; calls of 256."""
    def counts(workload):
        t = spec.load_cell(workload).traffic
        return t, sum(g["count"] for g in t["groups"])
    t, n = counts("engine-imagenet-val")
    assert n == 256 and t["items_per_call"] == 256
    assert sum(g["count"] for g in t["groups"]
               if g["sampling"] == "4:4:4") * 8 == n
    assert {(g["height"], g["width"]) for g in t["groups"]} == {
        (375, 500), (500, 375), (333, 500), (500, 333)}
    t, n = counts("loader-laion256")
    assert n == 512 and t["items_per_call"] == 256
    t, n = counts("engine-camera-12mp")
    assert n == 8 and t["items_per_call"] == 4
    assert [(g["height"], g["width"], g["sampling"], g["restart_rows"])
            for g in t["groups"]] == [(3024, 4032, "4:2:0", 1)]


def test_held_back_cells_load_by_name():
    """A held-back cell runs by name with its own entries joined to the
    benchmark's; the benchmark's cells see none of them."""
    import json
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(spec.HELD_BACK) as f:
        held = json.load(f)
    ours = {w["name"] for w in bench["workloads"]}
    back = {w["name"] for w in held["workloads"]}
    assert ours == {"loader-laion256"} and not ours & back
    assert set(held["why"]) == back
    for section in spec.SECTIONS:
        names = [e["name"] for e in bench[section] + held[section]]
        assert len(names) == len(set(names)), section
    engine = spec.load_cell("engine-imagenet-val")
    assert {m["name"] for m in engine.end_to_end} == {
        "engine_mp_per_s", "host_cpu_ms_per_mp", "setup_s"}
    assert "engine.prepare_ms_per_mp" in engine.readers
    loader = spec.load_cell("loader-laion256")
    assert "engine_mp_per_s" not in loader.readers
    assert not any(m["name"].startswith("engine")
                   for m in loader.per_layer)
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


def test_group_encoder_options():
    """A group may ask for Huffman tables of the file's own (same pixels,
    fewer bytes) or for a progressive file; baseline with the standard
    tables is the default."""
    group = {"count": 1, "height": 48, "width": 64, "sampling": "4:2:0",
             "quality": 90, "restart_rows": 0,
             "content": {"cell": 8, "waves": [40, 30], "noise": 9}}
    std, = corpus.build_corpus(torch, {"groups": [group]}, 77, "cpu")
    opt, = corpus.build_corpus(torch, {"groups": [dict(group, optimize=True)]},
                               77, "cpu")
    prog, = corpus.build_corpus(
        torch, {"groups": [dict(group, progressive=True)]}, 77, "cpu")
    assert len(opt.data) < len(std.data)
    assert np.array_equal(jpeg_ref.decode_rgb(opt.data),
                          jpeg_ref.decode_rgb(std.data))
    assert b"\xff\xc2" in prog.data and b"\xff\xc2" not in std.data
    with pytest.raises(jpeg_ref.RefJpegError):
        jpeg_ref.decode_rgb(prog.data)


def test_reference_module_is_found_by_name():
    """The traffic, else the configuration, names the reference decoder;
    ``jpeg_ref`` reads baseline files at full scale only."""
    from harness import reference
    assert reference.module_name({}, {}) == "jpeg_ref"
    assert reference.module_name({}, {"reference": "a_b"}) == "a_b"
    assert reference.module_name({"reference": "c"}, {"reference": "a"}) == "c"
    with pytest.raises(ValueError):
        reference.module_name({"reference": "../x"}, {})
    assert reference.decoder("jpeg_ref") is jpeg_ref
    with pytest.raises(ModuleNotFoundError):
        reference.decode_all({0: b""}, module="no_such_decoder")
    with pytest.raises(jpeg_ref.RefJpegError):
        jpeg_ref.decode_rgb(b"", "int", 2)
