"""The port's crop batches of mixed sizes and mixed sampling modes against
its plain reference, ``models/crop_reference.py``, on the CPU.

No JAX here: the JAX package refuses a batch that mixes modes, so the
port's result is held to the oracle's whole-image decode, cut at each
origin and normalised (``crop_reference``), element for element.  The
single-mode comparisons with the JAX package stay in
``test_torch_input_pipeline.py``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu_torch.models import crop_reference as R
from pim_jpeg_decoder_tpu_torch.models import input_pipeline as T
from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.utils.profiling import StageTimers

IMAGENET = dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375))
DTYPES = {"u8": (None, {}), "f32": (torch.float32, {}),
          "bf16_norm": (torch.bfloat16, IMAGENET)}
CROP = (24, 32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(small, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _file(seed, h, w, mode):
    img = _photo(seed, h, w)
    if mode == "gray":
        return encode_jpeg(img, quality=80, grayscale=True)
    return encode_jpeg(img, quality=70 + seed % 20, sampling=mode)


def _origin(rng, h, w, where):
    """A crop origin: 0, the far edge, on the 16-pixel MCU grid, or off
    it."""
    far_y, far_x = h - CROP[0], w - CROP[1]
    if where == "zero":
        return 0, 0
    if where == "far":
        return far_y, far_x
    if where == "grid":
        return 16 * (far_y // 16), 16 * (far_x // 16)
    return int(rng.integers(0, far_y + 1)) | 1, int(rng.integers(
        0, far_x + 1)) | 1


# (height, width, mode, origin): sizes mixed (odd ones among them), the
# four modes interleaved so that no mode's images are contiguous.
SPEC = [(40, 56, "4:2:0", "zero"), (47, 61, "4:4:4", "far"),
        (48, 64, "4:2:2", "grid"), (47, 61, "gray", "off"),
        (47, 61, "4:2:0", "off"), (56, 40, "4:4:4", "zero"),
        (41, 50, "4:2:2", "far"), (40, 56, "gray", "grid"),
        (61, 47, "4:2:0", "far"), (33, 45, "4:4:4", "off")]


def _batch(seed=0, spec=SPEC):
    rng = np.random.default_rng(seed)
    blobs = [_file(seed * 100 + i, h, w, mode)
             for i, (h, w, mode, _) in enumerate(spec)]
    boxes = [_origin(rng, h, w, where) for h, w, _, where in spec]
    return blobs, boxes


BLOBS, BOXES = _batch()


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_decode_batch_crops_mixes_sizes_and_modes(dtype_name):
    dtype, stats = DTYPES[dtype_name]
    got, headers = T.decode_batch_crops(BLOBS, BOXES, CROP, device="cpu",
                                        dtype=dtype, **stats)
    assert len({h.mode_key for h in headers}) == 4
    _same(got, R.crop_batch(BLOBS, BOXES, CROP, dtype=dtype, **stats))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_iter_decode_batch_crops_mixed_with_prefetch(dtype_name):
    dtype, stats = DTYPES[dtype_name]
    second = _batch(1)
    batches = [(BLOBS, BOXES), second, (BLOBS[::-1], BOXES[::-1])]
    got = list(T.iter_decode_batch_crops(batches, CROP, prefetch=2,
                                         device="cpu", mixed_sizes=True,
                                         dtype=dtype, **stats))
    assert len(got) == 3
    for (out, _), (blobs, boxes) in zip(got, batches):
        _same(out, R.crop_batch(blobs, boxes, CROP, dtype=dtype, **stats))


@pytest.mark.parametrize("devices", [2, 3, 4])
def test_device_lists_equal_one_device(devices):
    """Split over devices, the mode groups cut across the devices'
    ranges; the joined batch equals the one-device batch."""
    one, _ = T.decode_batch_crops(BLOBS, BOXES, CROP, device="cpu",
                                  dtype=torch.bfloat16, **IMAGENET)
    many, _ = T.decode_batch_crops(BLOBS, BOXES, CROP,
                                   device=["cpu"] * devices,
                                   dtype=torch.bfloat16, **IMAGENET)
    _same(many, one)
    for out, _ in T.iter_decode_batch_crops(
            [(BLOBS, BOXES)], CROP, device=["cpu"] * devices,
            mixed_sizes=True, dtype=torch.bfloat16, **IMAGENET):
        _same(out, one)


def test_mode_groups_are_launches_in_first_appearance_order():
    staged = T._host_stage_crops(BLOBS, BOXES, CROP, 1, 1, "auto", "test",
                                 False, False)
    names = [ln.mode.name for ln in staged.launches]
    assert names == ["4:2:0", "4:4:4", "4:2:2", "gray"]
    for ln in staged.launches:
        assert list(ln.index) == [i for i, s in enumerate(SPEC)
                                  if s[2] == ln.mode.name]
        # coeffs, qidx, qpool, oys, oxs and each image's batch position.
        assert len(ln.arrays) == 6
        assert ln.arrays[5].tolist() == list(ln.index)
        # The covering sub-grid of the launch's own mode and sizes.
        heads = [staged.headers[i] for i in ln.index]
        assert ln.gh == min(max(h.mcu_rows for h in heads),
                            -(-CROP[0] // ln.mode.mcu_px_h) + 1)
        assert ln.gw == min(max(h.mcu_cols for h in heads),
                            -(-CROP[1] // ln.mode.mcu_px_w) + 1)
        # Its sub-grids, then 15 zero MCUs (qidx 0), room to pad any
        # device's part of the launch to a multiple of 16.
        m = len(heads) * ln.gh * ln.gw
        assert ln.arrays[0].shape == (m + 15, ln.mode.g, 64)
        assert not ln.arrays[0][m:].any() and not ln.arrays[1][m:].any()



def test_each_device_rows_count_from_its_first_image(monkeypatch):
    """Over two devices, each launch's epilogue on a device writes its
    images into the rows of that device's output: their batch positions
    less the device's first."""
    seen = []
    original = T.raster_epilogue

    def recording(raw, mode, *args, rows=None, **kwargs):
        seen.append((mode.name, rows.tolist()))
        return original(raw, mode, *args, rows=rows, **kwargs)
    monkeypatch.setattr(T, "raster_epilogue", recording)
    T.decode_batch_crops(BLOBS, BOXES, CROP, device=["cpu", "cpu"])
    staged = T._host_stage_crops(BLOBS, BOXES, CROP, 1, 1, "auto", "test",
                                 False, False)
    want = [(ln.mode.name, [i - b0 for i in ln.index if b0 <= i < b1])
            for b0, b1 in T._groups(len(BLOBS), 2)
            for ln in staged.launches]
    assert seen == [w for w in want if w[1]]


def test_a_single_mode_batch_is_one_launch_as_before():
    """One mode: one launch, no destination rows, the transport of the
    same-mode path (what such a batch launched before mixed modes)."""
    spec = [s for s in SPEC if s[2] == "4:2:0"]
    blobs, boxes = _batch(2, spec)
    staged = T._host_stage_crops(blobs, boxes, CROP, 1, 1, "auto", "test",
                                 False, False)
    (ln,) = staged.launches
    assert ln.index is None and len(ln.arrays) == 5
    assert ln.arrays[1].tolist() == (
        list(np.repeat(np.arange(len(spec)), ln.gh * ln.gw)) + [0] * 15)
    out, _ = T.decode_batch_crops(blobs, boxes, CROP, device="cpu")
    _same(out, R.crop_batch(blobs, boxes, CROP))


def test_same_size_crops_keep_their_contract():
    """``decode_same_size_batch_crops`` and ``iter_decode_batch_crops``
    without ``mixed_sizes`` still refuse mixed sizes and modes."""
    from pim_jpeg_decoder_tpu_torch.codec.header import JpegError
    with pytest.raises(JpegError, match="identical dimensions and sampling"):
        T.decode_same_size_batch_crops(BLOBS[:2], BOXES[:2], CROP,
                                       device="cpu")
    with pytest.raises(JpegError, match="identical dimensions and sampling"):
        list(T.iter_decode_batch_crops([(BLOBS[:2], BOXES[:2])], CROP,
                                       device="cpu"))


def test_counters_of_a_mixed_batch():
    timers = StageTimers()
    T.decode_batch_crops(BLOBS, BOXES, CROP, device="cpu", timers=timers)
    staged = T._host_stage_crops(BLOBS, BOXES, CROP, 1, 1, "auto", "test",
                                 False, False)
    from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
    decoded = sum(scan_jpeg(b).num_mcus for b in BLOBS)
    shipped = sum(len(ln.index) * ln.gh * ln.gw for ln in staged.launches)
    assert timers.counters() == {"crop.mcus_decoded": decoded,
                                 "crop.mcus_shipped": shipped,
                                 "crop.mode_groups": 4}


@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("mode_key", sorted(S.MODES),
                         ids=[S.MODES[k].name for k in sorted(S.MODES)])
def test_epilogue_destination_rows(mode_key, scale):
    """Destination rows write image b into ``out[rows[b]]`` and leave
    every other row as it was, a row outside ``out`` included: against
    the epilogue's own result without rows, placed by hand."""
    mode = S.mode_for(mode_key)
    n = 8 // scale
    b, gh, gw = 4, 3, 5
    rng = np.random.default_rng(10 * scale + mode.g)
    raw = torch.from_numpy(rng.integers(
        0, 256, (3, mode.luma_slots, n * n, b * gh * gw + 3), dtype=np.uint8))
    ch, cw = gh * mode.v * n // 2 + 1, gw * mode.h * n // 2 + 1
    oys = torch.from_numpy(rng.integers(-2, 9, b).astype(np.int32))
    oxs = torch.from_numpy(rng.integers(-2, 9, b).astype(np.int32))
    rows = torch.tensor([5, 0, -1, 3], dtype=torch.int32)
    for dtype, stats in DTYPES.values():
        norm = T._norm_static(dtype, stats.get("mean"), stats.get("std"))
        crops = K.raster_epilogue(raw, mode, scale, b, gh, gw, ch, cw, oys,
                                  oxs, norm=norm)
        fill = torch.full((6, ch, cw, 3), 7, dtype=dtype or torch.uint8)
        want = fill.clone()
        for k, r in enumerate(rows.tolist()):
            if 0 <= r < 6:
                want[r] = crops[k]
        got = K.raster_epilogue(raw, mode, scale, b, gh, gw, ch, cw, oys,
                                oxs, norm=norm, rows=rows, out=fill.clone())
        _same(got, want)
        ref = K.raster_epilogue_reference(raw, mode, scale, b, gh, gw, ch,
                                          cw, oys, oxs, norm, rows,
                                          fill.clone())
        _same(ref, want)


@pytest.mark.parametrize("bad", ["rows_alone", "out_alone", "rows_dtype",
                                 "rows_len", "out_shape", "out_dtype"])
def test_epilogue_destination_rows_are_checked(bad):
    mode = S.mode_for((2, 2, 3))
    raw = torch.zeros((3, 4, 64, 8), dtype=torch.uint8)
    rows = torch.zeros(2, dtype=torch.int32)
    out = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    kw = {"rows_alone": dict(rows=rows),
          "out_alone": dict(out=out),
          "rows_dtype": dict(rows=rows.long(), out=out),
          "rows_len": dict(rows=rows[:1], out=out),
          "out_shape": dict(rows=rows, out=out[:, :4]),
          "out_dtype": dict(rows=rows, out=out.float())}[bad]
    with pytest.raises(ValueError):
        K.raster_epilogue(raw, mode, 1, 2, 2, 2, 8, 8, **kw)


def test_reference_division_agrees_with_the_port_in_half_types():
    """The reference divides by std; the port multiplies by 1/std.  Over
    every pixel value, ImageNet's statistics give the same bfloat16 and
    float16 either way, and float32 without std the same float32."""
    pixels = torch.arange(256, dtype=torch.uint8)[:, None].expand(256, 3)
    for dtype, stats in ((torch.bfloat16, IMAGENET),
                         (torch.float16, IMAGENET), (torch.float32, {})):
        norm = T._norm_static(dtype, stats.get("mean"), stats.get("std"))
        _same(K.apply_norm(pixels, norm),
              R.normalize(pixels, dtype, **stats))


def test_reference_refuses_a_window_outside_the_image():
    with pytest.raises(ValueError, match="outside"):
        R.crop_batch(BLOBS[:1], [(-1, 0)], CROP)
    with pytest.raises(ValueError, match="outside"):
        R.crop_batch(BLOBS[:1], [(17, 0)], CROP)


def test_reference_imports_no_kernel_and_no_jax():
    """Importing the reference loads no JAX, no kernel or launcher of
    ``ops`` (its integer spec and IDCT arithmetic aside) and not the batch
    path it checks."""
    code = textwrap.dedent("""
        import sys
        import pim_jpeg_decoder_tpu_torch.models.crop_reference
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pim_jpeg_decoder_tpu")
               or m.startswith("pim_jpeg_decoder_tpu_torch.ops.")
               and m.rsplit(".", 1)[1] not in ("specs", "idct_math")
               or m.startswith("pim_jpeg_decoder_tpu_torch.models.input")]
        print("BAD", bad)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "BAD []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("devices", [1, 2, 3])
def test_every_launch_decodes_rows_on_the_16_byte_grid(monkeypatch,
                                                       devices):
    """Each device decodes its images' MCUs of a launch padded to a
    multiple of 16 (the next device's first MCUs, or the transport's
    trailing zeros), so that its decode writes rows on the grid (not
    counted in ``rgb_shifted``); the padding changes no output byte."""
    seen = []
    original = T.decode_mcus

    def recording(coeffs, qidx, qpool, mode, **kwargs):
        seen.append((mode.name, coeffs.shape[0], qidx.shape[0]))
        return original(coeffs, qidx, qpool, mode, **kwargs)
    monkeypatch.setattr(T, "decode_mcus", recording)
    out, _ = T.decode_batch_crops(BLOBS, BOXES, CROP,
                                  device=["cpu"] * devices)
    staged = T._host_stage_crops(BLOBS, BOXES, CROP, 1, 1, "auto", "test",
                                 False, False)
    want = []
    for b0, b1 in T._groups(len(BLOBS), devices):
        for ln in staged.launches:
            mine = [i for i in ln.index if b0 <= i < b1]
            if mine:
                m = K.padded_mcus(len(mine) * ln.gh * ln.gw)
                assert m % 16 == 0 and not K.rgb_shifted(1 << 20, m)
                want.append((ln.mode.name, m, m))
    assert seen == want
    _same(out, R.crop_batch(BLOBS, BOXES, CROP))


def test_same_size_batches_are_padded_too():
    """The same-size path's transport: each image's MCUs, then 15 zero
    MCUs (qidx 0); one device decodes them padded to a multiple of 16."""
    blobs = [_file(i, 40, 56, "4:2:0") for i in range(3)]
    staged = T._host_stage(blobs, 1, "auto", "test", 1, False)
    (ln,) = staged.launches
    per_img = ln.gh * ln.gw
    m = 3 * per_img
    assert m % 16 and ln.arrays[0].shape[0] == m + 15
    assert ln.arrays[1].tolist() == (
        list(np.repeat(np.arange(3), per_img)) + [0] * 15)
    assert not ln.arrays[0][m:].any()
    assert K.padded_mcus(m) == m + -m % 16 <= m + 15
