"""The decode A/B tool (``tools/decode_ab.py``) on the CPU: its
geometries, its verdict over the four runs, its output check and its exit
code without a card.  The timing itself runs on the card only."""

import pytest
import torch

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.tools import decode_ab as A


def _runs(parent, change, digests=("a", "a", "a", "a")):
    """Four runs in ``A.ORDER`` of one geometry: parent, change, change,
    parent."""
    us = [parent[0], change[0], change[1], parent[1]]
    return [{"card": "x", "results": {"g": {"us": u, "min_us": u,
                                             "max_us": u, "sha1": d}}}
            for u, d in zip(us, digests)]


def test_geometries_cover_every_mode_and_both_wires():
    names = {A.geometry_name(k, S.mode_for(key).name, m, w)
             for k, key, m, w in A.GEOMETRIES}
    assert len(names) == len(A.GEOMETRIES) == 16
    for kernel in ("rgb", "ycbcr"):
        for key in S.MODES:
            assert (f"{kernel} {S.mode_for(key).name} M=16384 int8"
                    in names)
        for m in (16384, 196608):
            assert f"{kernel} 4:2:0 M={m} int16" in names
        assert f"{kernel} 4:2:0 M=196608 int8" in names


def test_epilogue_and_dequantize_geometries_are_named():
    names = A.geometry_names()
    assert len(names) == len(set(names)) == (16 + 8 + 2 + 4 + 4 + 4 + 13
                                             + 3 + 3 + 6 + 3 + 1)
    assert names[:16] == [A.geometry_name(k, S.mode_for(key).name, m, w)
                          for k, key, m, w in A.GEOMETRIES]
    for label in ("scale 1 -> uint8", "scale 2 -> bfloat16",
                  "224x224 crops -> bfloat16", "scale 1 -> float32"):
        assert f"epilogue B=256 500x375 4:2:0 {label}" in names
    assert "epilogue B=256 256x256 4:2:0 scale 1 -> bfloat16 CLIP" in names
    for size in ("B=256 224x224", "B=256 384x384", "B=64 512x512"):
        assert f"epilogue {size} 4:2:0 scale 1 -> bfloat16" in names
    # The crop cell's two launches, after the other epilogue geometries:
    # its usual split, M off the 16-byte grid in both.
    crop_cell = ["epilogue crop cell 4:2:0 B=225 on 15x15 MCUs 224x224 "
                 "crops -> bfloat16 rows into 256",
                 "epilogue crop cell 4:4:4 B=31 on 29x29 MCUs 224x224 "
                 "crops -> bfloat16 rows into 256"]
    assert names[16 + 8:16 + 8 + 2] == crop_cell
    # Then its two decode launches (int16), each beside the nearest M below
    # it on the 16-byte grid.
    assert names[16 + 8 + 2:16 + 8 + 2 + 4] == [
        "rgb 4:2:0 M=50625 int16", "rgb 4:2:0 M=50624 int16",
        "rgb 4:4:4 M=26071 int16", "rgb 4:4:4 M=26064 int16"]
    for (key, m), (_, b, g) in zip(A.CROP_CELL_DECODES[::2],
                                   A.CROP_CELL_GEOMETRIES):
        assert m == b * g * g and m % 16 != 0
    for key, m in A.CROP_CELL_DECODES[1::2]:
        assert m % 16 == 0
    assert sum(b for _, b, _ in A.CROP_CELL_GEOMETRIES) == A.CROP_CELL_BATCH
    for key, b, g in A.CROP_CELL_GEOMETRIES:
        assert b * g * g % 16 != 0
        mode = S.mode_for(key)
        assert g * mode.mcu_px_h >= A.CROP_CELL_CROP[0]
        assert g * mode.mcu_px_w >= A.CROP_CELL_CROP[1]
    for m in (16384, 196608):
        for bits in (8, 16):
            assert f"dequant 4:2:0 M={m} int{bits}" in names
    # The batch is 256 images of 24 x 32 4:2:0 MCUs covering 500x375.
    b, gh, gw, height, width = A.BATCH
    mode = S.mode_for((2, 2, 3))
    assert b * gh * gw == 196608
    assert gh == -(-height // mode.mcu_px_h)
    assert gw == -(-width // mode.mcu_px_w)
    # The loader cell's batch: 256 images of 16 x 16 MCUs covering 256x256.
    lb, lgh, lgw, lheight, lwidth = A.LOADER_BATCH
    assert (lb, lheight, lwidth) == (256, 256, 256)
    for _, sgh, sgw, sheight, swidth in (A.LOADER_BATCH,) + A.SQUARE_BATCHES:
        assert sgh == -(-sheight // mode.mcu_px_h)
        assert sgw == -(-swidth // mode.mcu_px_w)
    for _, batch, scale, dtype_name, crop, stats in A.EPILOGUE_GEOMETRIES:
        assert batch in (A.BATCH, A.LOADER_BATCH) + A.SQUARE_BATCHES
        assert scale in (1, 2, 4, 8)
        assert dtype_name is None or hasattr(torch, dtype_name)
        assert stats in (A.IMAGENET_NORM, A.CLIP_NORM)
        if crop:
            assert crop[0] <= height // scale and crop[1] <= width // scale


def test_idct_and_colour_geometries_are_named_and_ordered():
    """Both stages at 4:2:0 int16, M=16,384 and 196,608, after the
    dequantize geometries and in the order ``side`` times them: by M, the
    IDCT before the colour stage."""
    names = A.geometry_names()
    assert A.IDCT_GEOMETRIES == A.COLOR_GEOMETRIES == (16384, 196608)
    assert names[16 + 8 + 2 + 4 + 4:16 + 8 + 2 + 4 + 4 + 4] == [
        "idct 4:2:0 M=16384 int16", "color 4:2:0 M=16384 int16",
        "idct 4:2:0 M=196608 int16", "color 4:2:0 M=196608 int16"]
    assert A.stage_geometries() == [("idct", 16384), ("color", 16384),
                                    ("idct", 196608), ("color", 196608)]
    assert A.stage_name("idct", 16384) == A.geometry_name(
        "idct", "4:2:0", 16384, 2)


def _named_runs(us_by_name, digests=None):
    """Four runs in ``A.ORDER`` of several geometries: name -> (parent
    pair, change pair)."""
    runs = []
    for i, who in enumerate(A.ORDER):
        first = A.ORDER.index(who) == i
        runs.append({"card": "x", "results": {
            name: {"us": pair[who == "change"][0 if first else 1],
                   "min_us": 0, "max_us": 0,
                   "sha1": (digests or {}).get(name, "a" * 4)[i]}
            for name, pair in us_by_name.items()}})
    return runs


@pytest.mark.parametrize("name", [
    "epilogue B=256 500x375 4:2:0 scale 1 -> uint8",
    "epilogue B=256 500x375 4:2:0 224x224 crops -> bfloat16",
    "epilogue B=256 500x375 4:2:0 scale 1 -> float32",
    "epilogue B=256 256x256 4:2:0 scale 1 -> bfloat16 CLIP",
    "epilogue B=256 224x224 4:2:0 scale 1 -> bfloat16",
    "epilogue crop cell 4:2:0 B=225 on 15x15 MCUs 224x224 crops -> bfloat16 "
    "rows into 256",
    "epilogue crop cell 4:4:4 B=31 on 29x29 MCUs 224x224 crops -> bfloat16 "
    "rows into 256",
    "rgb 4:2:0 M=50625 int16", "rgb 4:2:0 M=50624 int16",
    "rgb 4:4:4 M=26071 int16", "rgb 4:4:4 M=26064 int16",
    "dequant 4:2:0 M=16384 int16", "dequant 4:2:0 M=196608 int8",
    "idct 4:2:0 M=16384 int16", "idct 4:2:0 M=196608 int16",
    "color 4:2:0 M=16384 int16", "color 4:2:0 M=196608 int16",
    "rgb_scaled scale 2 4:2:0 M=16384 int8",
    "rgb_scaled scale 8 4:2:0 M=196608 int8",
    "rgb_scaled scale 2 4:2:0 M=262144 int8",
    "rgb_scaled scale 2 4:2:0 M=262144 int16",
    "rgb_scaled scale 2 4:2:0 M=131091 int16",
    "rgb_scaled scale 2 4:4:0 M=196608 int16",
    "rgb_scaled scale 2 4:2:2 M=196608 int16",
    "stacked 4:2:0 M=16384 int8", "stacked 4:2:0 M=196608 int16",
    "truerez 4:2:0 M=16384 int8", "truerez 4:2:0 M=196608 int16",
    "mxu2pass 4:2:0 M=16384 int16", "mxu2pass4 4:2:0 M=16384 int16",
    "mxu64 4:2:0 M=16384 int16", "mxu2pass4 4:2:0 M=196608 int16",
    "mxu64 4:2:0 M=196608 int16", "memfloor 4:2:0 M=16384 int8",
    "memfloor 4:2:0 M=196608 int16"])
def test_verdict_on_the_new_geometries(name):
    """Each geometry gets its own verdict from its own band: the named one
    faster beyond it, a decode kernel beside it within its band."""
    assert name in A.geometry_names()
    other = "rgb 4:2:0 M=16384 int8"
    table = A.verdict(_named_runs({
        name: ((392.0, 391.0), (132.0, 133.0)),
        other: ((19.0, 19.1), (19.05, 18.95))}))
    assert table[name]["verdict"] == "faster"
    assert table[name]["speedup"] == pytest.approx(783.0 / 265.0)
    assert table[other]["verdict"] == "within band"
    bad = A.digests_agree(_named_runs(
        {name: ((1, 1), (1, 1)), other: ((1, 1), (1, 1))},
        digests={name: "abaa"}))
    assert bad == [name]


@pytest.mark.parametrize("parent, change, word", [
    ((20.0, 20.2), (15.0, 15.1), "faster"),
    ((15.0, 15.1), (20.0, 20.2), "slower"),
    ((20.0, 21.0), (20.2, 20.3), "within band"),
    # The gap (0.5) is smaller than the parent's own spread (1.0).
    ((20.0, 21.0), (19.4, 19.5), "within band"),
])
def test_verdict_needs_a_gap_beyond_the_band(parent, change, word):
    row = A.verdict(_runs(parent, change))["g"]
    assert row["verdict"] == word
    assert row["parent_us"] == list(parent)
    assert row["change_us"] == list(change)
    assert row["band_us"] == pytest.approx(max(parent[1] - parent[0],
                                               change[1] - change[0]))
    assert row["speedup"] == pytest.approx(sum(parent) / sum(change))


def test_differing_outputs_are_named():
    assert A.digests_agree(_runs((1, 1), (1, 1))) == []
    assert A.digests_agree(_runs((1, 1), (1, 1),
                                 ("a", "b", "a", "a"))) == ["g"]


def test_exits_2_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    assert A.main(["--root", A.HERE_ROOT]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_one_side_is_required():
    with pytest.raises(SystemExit):
        A.main([])


@pytest.mark.parametrize("scale", [1, 2])
def test_crop_origins_fit_the_scaled_image(scale):
    """Seeded origins leave room for the crop in the image at ``scale``,
    and the same seed gives the same origins."""
    import numpy as np

    b, _, _, height, width = A.BATCH
    crop = (224 // scale, 224 // scale)
    oy, ox = A.crop_origins(torch, np.random.default_rng(3), b, scale,
                            (height, width), crop, torch.device("cpu"))
    again = A.crop_origins(torch, np.random.default_rng(3), b, scale,
                           (height, width), crop, torch.device("cpu"))
    for o, full, size in ((oy, height, crop[0]), (ox, width, crop[1])):
        assert o.dtype == torch.int32 and o.shape == (b,)
        assert int(o.min()) >= 0 and int(o.max()) <= full // scale - size
    assert torch.equal(oy, again[0]) and torch.equal(ox, again[1])


def test_scaled_and_stacked_geometries_are_named_and_last():
    """The scaled decode at 4:2:0 scale 2 on both wires at M=16,384,
    196,608 and the half-scale cell's 262,144, and at 131,091 int16 (blocks
    that walk several tiles, the last ragged), scale 4 and 8 at 196,608
    int8, gray and 4:4:4 scale 2 at 16,384 int8, 4:4:0 and 4:2:2 scale 2
    at 196,608 int16 (walked, and not); the stacked kernel at
    4:2:0, M=16,384 on both wires and 196,608 int16, each with rgb_kernel's
    geometry of the same M and wire in the table.  They were last until the
    truerez, tensor-core IDCT and memory-floor geometries were appended
    after them."""
    names = A.geometry_names()
    scaled = [A.scaled_name(*g) for g in A.SCALED_GEOMETRIES]
    stacked = [A.stacked_name(m, w) for m, w in A.STACKED_GEOMETRIES]
    start = 16 + 8 + 2 + 4 + 4 + 4
    assert names[start:start + 16] == scaled + stacked
    assert names[start + 16:] == (
        [A.truerez_name(m, w) for m, w in A.TRUEREZ_GEOMETRIES]
        + [A.mxu_name(v, m) for v, m in A.MXU_GEOMETRIES]
        + [A.memfloor_name(m, w) for m, w in A.MEMFLOOR_GEOMETRIES]
        + [A.VLC_GEOMETRY])
    want = {("4:2:0", 2, 16384, 8), ("4:2:0", 2, 16384, 16),
            ("4:2:0", 2, 196608, 8), ("4:2:0", 2, 196608, 16),
            ("4:2:0", 4, 196608, 8), ("4:2:0", 8, 196608, 8),
            ("gray", 2, 16384, 8), ("4:4:4", 2, 16384, 8),
            ("4:2:0", 2, 262144, 8), ("4:2:0", 2, 262144, 16),
            ("4:2:0", 2, 131091, 16), ("4:4:0", 2, 196608, 16),
            ("4:2:2", 2, 196608, 16)}
    assert {(S.mode_for(k).name, s, m, 8 * w)
            for k, s, m, w in A.SCALED_GEOMETRIES} == want
    assert A.scaled_name((2, 2, 3), 2, 16384, 1) == (
        "rgb_scaled scale 2 4:2:0 M=16384 int8")
    assert set(A.STACKED_GEOMETRIES) == {(16384, 1), (16384, 2),
                                         (196608, 2)}
    for m, w in A.STACKED_GEOMETRIES:
        assert A.geometry_name("rgb", "4:2:0", m, w) in names


def test_stacked_lines_carry_rgb_kernel_times():
    """``report_lines``: a stacked geometry's line ends with rgb_kernel's
    mean times from the same runs; the other lines carry no such note."""
    table = A.verdict(_named_runs({
        "stacked 4:2:0 M=16384 int8": ((47.0, 47.4), (20.0, 20.2)),
        "rgb 4:2:0 M=16384 int8": ((19.0, 19.2), (19.1, 19.3)),
        "idct 4:2:0 M=16384 int16": ((12.0, 12.1), (12.0, 12.1))}))
    lines = A.report_lines(table, "card")
    assert len(lines) == 3 and all(ln.endswith("| card") for ln in lines)
    stacked = [ln for ln in lines if ln.startswith("stacked")][0]
    assert "faster" in stacked
    assert ("rgb_kernel in the same runs: parent 19.10, change 19.20 us"
            in stacked)
    assert sum("rgb_kernel in the same runs" in ln for ln in lines) == 1


def test_truerez_and_mxu_geometries_are_named_and_last():
    """The truerez kernel at 4:2:0, M=16,384 on both wires and 196,608
    int16, each beside rgb_kernel's geometry of the same M and wire; then
    the tensor-core IDCT: mxu2pass with pieces 1 and 2 and mxu64 at
    M=16,384, both mxu2pass forms and mxu64 at 196,608, each a variant the
    IDCT tool runs.  Only the memory-floor and VLC geometries follow
    them."""
    from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab

    names = A.geometry_names()
    truerez = [A.truerez_name(m, w) for m, w in A.TRUEREZ_GEOMETRIES]
    mxu = [A.mxu_name(v, m) for v, m in A.MXU_GEOMETRIES]
    assert names[-13:-4] == truerez + mxu
    assert truerez == ["truerez 4:2:0 M=16384 int8",
                       "truerez 4:2:0 M=16384 int16",
                       "truerez 4:2:0 M=196608 int16"]
    assert mxu == ["mxu2pass 4:2:0 M=16384 int16",
                   "mxu2pass4 4:2:0 M=16384 int16",
                   "mxu64 4:2:0 M=16384 int16",
                   "mxu2pass 4:2:0 M=196608 int16",
                   "mxu2pass4 4:2:0 M=196608 int16",
                   "mxu64 4:2:0 M=196608 int16"]
    for m, w in A.TRUEREZ_GEOMETRIES:
        assert A.geometry_name("rgb", "4:2:0", m, w) in names
    assert {v for v, _ in A.MXU_GEOMETRIES} <= set(mxu_idct_ab.VARIANTS)


def test_truerez_lines_carry_rgb_kernel_times():
    """``report_lines``: a truerez geometry's line ends with rgb_kernel's
    mean times from the same runs, as a stacked one's does; an IDCT line
    carries no such note."""
    table = A.verdict(_named_runs({
        "truerez 4:2:0 M=196608 int16": ((355.0, 356.0), (150.0, 151.0)),
        "rgb 4:2:0 M=196608 int16": ((160.0, 160.4), (160.2, 160.6)),
        "mxu2pass 4:2:0 M=16384 int16": ((18.2, 18.3), (11.0, 11.1))}))
    lines = A.report_lines(table, "card")
    truerez = [ln for ln in lines if ln.startswith("truerez")][0]
    assert "faster" in truerez
    assert ("rgb_kernel in the same runs: parent 160.20, change 160.40 us"
            in truerez)
    assert sum("rgb_kernel in the same runs" in ln for ln in lines) == 1


def test_memfloor_geometries_are_named_and_last():
    """The memory floor at 4:2:0, M=16,384 on both wires and 196,608 int16,
    appended after every earlier geometry (whose names stay as they were),
    each beside rgb_kernel's geometry of the same M and wire; only the VLC
    geometry follows it."""
    names = A.geometry_names()
    floor = [A.memfloor_name(m, w) for m, w in A.MEMFLOOR_GEOMETRIES]
    assert names[-4:-1] == floor == ["memfloor 4:2:0 M=16384 int8",
                                   "memfloor 4:2:0 M=16384 int16",
                                   "memfloor 4:2:0 M=196608 int16"]
    for m, w in A.MEMFLOOR_GEOMETRIES:
        assert A.geometry_name("rgb", "4:2:0", m, w) in names


def test_memfloor_lines_carry_rgb_kernel_times():
    """``report_lines``: a memory-floor geometry's line ends with
    rgb_kernel's mean times from the same runs, as a truerez one's does."""
    table = A.verdict(_named_runs({
        "memfloor 4:2:0 M=196608 int16": ((145.0, 145.4), (122.0, 122.6)),
        "rgb 4:2:0 M=196608 int16": ((160.0, 160.4), (160.2, 160.6)),
        "mxu64 4:2:0 M=196608 int16": ((180.0, 180.2), (120.0, 120.4))}))
    lines = A.report_lines(table, "card")
    floor = [ln for ln in lines if ln.startswith("memfloor")][0]
    assert "faster" in floor
    assert ("rgb_kernel in the same runs: parent 160.20, change 160.40 us"
            in floor)
    assert sum("rgb_kernel in the same runs" in ln for ln in lines) == 1


def test_vlc_geometry_is_named_and_last():
    """The VLC kernel on its tool's draw, every seed's output in the
    digest, after every earlier geometry; its line carries no rgb_kernel
    note."""
    names = A.geometry_names()
    assert names[-1] == A.VLC_GEOMETRY == (
        "vlc 2048 words, the tool's draw, seeds 0-7")
    assert A.VLC_SEEDS == 8
    table = A.verdict(_named_runs({
        A.VLC_GEOMETRY: ((508.8, 508.1), (14.7, 14.8)),
        "rgb 4:2:0 M=16384 int8": ((19.0, 19.2), (19.1, 19.3))}))
    assert table[A.VLC_GEOMETRY]["verdict"] == "faster"
    line = [ln for ln in A.report_lines(table, "card")
            if ln.startswith("vlc")][0]
    assert "rgb_kernel" not in line and line.endswith("| card")

