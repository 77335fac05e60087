"""The PyTorch port's device-resident batch API against the JAX package's.

``pim_jpeg_decoder_tpu_torch.models.input_pipeline`` with ``device="cpu"``
runs the plain PyTorch versions of the decode kernels and of the raster
epilogue; the JAX ``input_pipeline`` runs the Pallas kernel in interpret
mode and its XLA relayout/crop/normalisation fusion.  Same JPEG bytes and
options; tolerance 0 for uint8, float32 and bfloat16 (both frameworks
compute ``(x - mean) * inv_std`` in float32 from the same float32
constants and round to bfloat16 to nearest even; compared bit for bit).
JAX results are cached per configuration, and the JAX side ships the
int16 wire (the port the default int8 compaction: same pixels), so that
each JAX program compiles once for all the tests that compare with it.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.codec.header import JpegError
from pim_jpeg_decoder_tpu.models import input_pipeline as J
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu_torch.codec.header import JpegError as PortJpegError
from pim_jpeg_decoder_tpu_torch.models import input_pipeline as T
from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.utils.profiling import StageTimers

LANE_TILE = 128
IMAGENET = dict(mean=(123.675, 116.28, 103.53), std=(58.395, 57.12, 57.375))
# name -> (torch dtype, jnp dtype, mean/std)
DTYPES = {"u8": (None, None, {}),
          "f32": (torch.float32, jnp.float32, {}),
          "bf16_norm": (torch.bfloat16, jnp.bfloat16, IMAGENET)}
CROP = (24, 32)
BOXES = {1: [(0, 0), (3, 5), (16, 24)], 2: [(0, 0), (2, 4), (16, 24)]}


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(small, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _blobs(seed, sizes, **kw):
    return tuple(encode_jpeg(_photo(seed + i, h, w), quality=70 + 5 * i,
                             **kw)
                 for i, (h, w) in enumerate(sizes))


SAME = _blobs(0, [(40, 56)] * 3, sampling="4:2:0")
SAME_B = _blobs(10, [(40, 56)] * 3, sampling="4:2:0")
# Mixed sizes whose MCU grids all cover the crops' 3x3 sub-grid, so the
# JAX crop program compiled for SAME is reused.
MIXED = _blobs(20, [(40, 56), (48, 64), (47, 61)], sampling="4:2:0")


def host(x):
    """A batch as NumPy, bfloat16 as its bits (exact comparison)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def assert_same(got, want):
    got, want = host(got), host(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def kwargs(dtype_name, jax_side):
    tdt, jdt, stats = DTYPES[dtype_name]
    return dict(dtype=jdt if jax_side else tdt, **stats)


@functools.lru_cache(maxsize=None)
def jax_batch(blobs, scale, dtype_name):
    out, _ = J.decode_same_size_batch(list(blobs), lane_tile=LANE_TILE,
                                      scale=scale, wire="i16",
                                      **kwargs(dtype_name, True))
    return host(out)


@functools.lru_cache(maxsize=None)
def jax_crops(blobs, scale, dtype_name, mixed):
    fn = J.decode_batch_crops if mixed else J.decode_same_size_batch_crops
    out, _ = fn(list(blobs), BOXES[scale], CROP, lane_tile=LANE_TILE,
                scale=scale, wire="i16", **kwargs(dtype_name, True))
    return host(out)


GRID = [(s, d) for s in (1, 2) for d in DTYPES]
GRID_IDS = [f"s{s}-{d}" for s, d in GRID]


@pytest.mark.parametrize("scale,dtype_name", GRID, ids=GRID_IDS)
def test_same_size_batch_matches_jax(scale, dtype_name):
    out, headers = T.decode_same_size_batch(
        list(SAME), scale=scale, device="cpu", **kwargs(dtype_name, False))
    assert out.device.type == "cpu" and len(headers) == 3
    assert out.shape == (3, -(-40 // scale), -(-56 // scale), 3)
    assert_same(out, jax_batch(SAME, scale, dtype_name))


@pytest.mark.parametrize("scale,dtype_name", GRID, ids=GRID_IDS)
def test_iter_decode_batches_matches_jax(scale, dtype_name):
    got = list(T.iter_decode_batches(
        [SAME, list(SAME_B), SAME], scale=scale, prefetch=2, device="cpu",
        **kwargs(dtype_name, False)))
    assert len(got) == 3
    for (out, headers), blobs in zip(got, (SAME, SAME_B, SAME)):
        assert len(headers) == 3
        assert_same(out, jax_batch(blobs, scale, dtype_name))


@pytest.mark.parametrize("scale,dtype_name", GRID, ids=GRID_IDS)
def test_same_size_batch_crops_matches_jax(scale, dtype_name):
    out, _ = T.decode_same_size_batch_crops(
        list(SAME), BOXES[scale], CROP, scale=scale, device="cpu",
        **kwargs(dtype_name, False))
    assert out.shape == (3, CROP[0] // scale, CROP[1] // scale, 3)
    assert_same(out, jax_crops(SAME, scale, dtype_name, False))


@pytest.mark.parametrize("scale,dtype_name", GRID, ids=GRID_IDS)
def test_mixed_size_batch_crops_match_jax(scale, dtype_name):
    out, headers = T.decode_batch_crops(
        list(MIXED), BOXES[scale], CROP, scale=scale, device="cpu",
        **kwargs(dtype_name, False))
    assert sorted({(h.height, h.width) for h in headers}) == [
        (40, 56), (47, 61), (48, 64)]
    assert_same(out, jax_crops(MIXED, scale, dtype_name, True))


@pytest.mark.parametrize("mixed", [False, True], ids=["same", "mixed"])
def test_iter_decode_batch_crops_matches_jax(mixed):
    blobs = MIXED if mixed else SAME
    got = list(T.iter_decode_batch_crops(
        [(blobs, BOXES[2])] * 2, CROP, scale=2, device="cpu",
        mixed_sizes=mixed, **kwargs("bf16_norm", False)))
    assert len(got) == 2
    for out, _ in got:
        assert_same(out, jax_crops(blobs, 2, "bf16_norm", mixed))


def test_crops_equal_slices_of_the_full_batch():
    full, _ = T.decode_same_size_batch(list(SAME), device="cpu")
    crops, _ = T.decode_same_size_batch_crops(list(SAME), BOXES[1], CROP,
                                              device="cpu")
    for i, (y0, x0) in enumerate(BOXES[1]):
        assert torch.equal(crops[i],
                           full[i, y0:y0 + CROP[0], x0:x0 + CROP[1]])


@pytest.mark.parametrize("scale", [1, 2, 4, 8])
@pytest.mark.parametrize("mode_key", sorted(S.MODES),
                         ids=[S.MODES[k].name for k in sorted(S.MODES)])
def test_raster_epilogue_reference_matches_jax(mode_key, scale):
    """The plain epilogue against the JAX ``_raster_relayout`` +
    ``_apply_norm`` (+ the crops' vmapped ``dynamic_slice``), on random
    kernel-native input: a full batch cut to a ragged size, and crops."""
    import jax

    mode = S.mode_for(mode_key)
    n = 8 // scale
    b, gh, gw = 3, 2, 3
    rng = np.random.default_rng(scale * 7 + mode.g)
    raw = rng.integers(0, 256, (3, mode.luma_slots, n * n, b * gh * gw + 4),
                       dtype=np.uint8)
    grid_h, grid_w = gh * mode.v * n, gw * mode.h * n
    oh, ow = max(1, grid_h - 3), max(1, grid_w - 1)
    ch, cw = max(1, grid_h // 2), max(1, grid_w // 2)
    oys = rng.integers(0, grid_h - ch + 1, b).astype(np.int32)
    oxs = rng.integers(0, grid_w - cw + 1, b).astype(np.int32)
    for dtype_name in DTYPES:
        tdt, jdt, stats = DTYPES[dtype_name]
        jnorm = J._norm_static(jdt, stats.get("mean"), stats.get("std"))
        tnorm = T._norm_static(tdt, stats.get("mean"), stats.get("std"))
        img = J._raster_relayout(jnp.asarray(raw), mode, scale, b, gh, gw)
        crops = jax.vmap(lambda im, oy, ox: jax.lax.dynamic_slice(
            im, (oy, ox, 0), (ch, cw, 3)))(img, oys, oxs)
        t_raw = torch.from_numpy(raw)
        assert_same(K.raster_epilogue_reference(t_raw, mode, scale, b, gh,
                                                gw, oh, ow, norm=tnorm),
                    J._apply_norm(img[:, :oh, :ow], jnorm))
        assert_same(K.raster_epilogue(t_raw, mode, scale, b, gh, gw, ch, cw,
                                      torch.from_numpy(oys),
                                      torch.from_numpy(oxs), norm=tnorm),
                    J._apply_norm(crops, jnorm))


# Where the CUDA epilogue branches: one MCU column, a ragged 32-column
# chunk, a chunk loop with unaligned runs (its banded form); bands of two
# and four whole MCU rows (its row form, R = 32 // gw MCU rows a band), and
# widths whose runs of 28, 24 and 31 MCUs it leaves to the banded form.
BAND_GWS = (1, 17, 33, 16, 8, 14, 24, 31)
BAND_WIDTHS = ("one", "odd", "full")


@pytest.mark.parametrize("width", BAND_WIDTHS)
@pytest.mark.parametrize("gw", BAND_GWS)
@pytest.mark.parametrize("scale", [1, 2])
@pytest.mark.parametrize("mode_key", [(1, 1, 1), (2, 2, 3)],
                         ids=["gray", "4:2:0"])
def test_raster_epilogue_reference_matches_jax_at_band_edges(mode_key, scale,
                                                             gw, width):
    """The plain epilogue (the oracle of the CUDA kernel on the card)
    against the JAX package where the kernel's two forms branch: B = 1,
    ``gw`` of ``BAND_GWS`` MCU columns, an output 1, an odd number and the
    full grid wide, and crop origins that ``dynamic_slice`` clamps
    (negative, past the far edge, and exactly at both edges).  Tolerance
    0."""
    import jax

    mode = S.mode_for(mode_key)
    n = 8 // scale
    b, gh = 1, 2
    rng = np.random.default_rng(1000 * scale + 10 * gw + mode.g)
    raw = rng.integers(0, 256, (3, mode.luma_slots, n * n, b * gh * gw + 5),
                       dtype=np.uint8)
    grid_h, grid_w = gh * mode.v * n, gw * mode.h * n
    ow = {"one": 1, "odd": (grid_w // 2) | 1, "full": grid_w}[width]
    oh = max(1, grid_h - 3)
    t_raw = torch.from_numpy(raw)
    img = J._raster_relayout(jnp.asarray(raw), mode, scale, b, gh, gw)
    for dtype_name in ("u8", "bf16_norm"):
        tdt, jdt, stats = DTYPES[dtype_name]
        jnorm = J._norm_static(jdt, stats.get("mean"), stats.get("std"))
        tnorm = T._norm_static(tdt, stats.get("mean"), stats.get("std"))
        assert_same(K.raster_epilogue_reference(t_raw, mode, scale, b, gh,
                                                gw, oh, ow, norm=tnorm),
                    J._apply_norm(img[:, :oh, :ow], jnorm))
        for oy, ox in ((0, 0), (grid_h - oh, grid_w - ow), (-3, -1),
                       (grid_h + 7, grid_w + 2), (1, grid_w - ow + 1)):
            oys = np.array([oy], np.int32)
            oxs = np.array([ox], np.int32)
            crops = jax.vmap(lambda im, y, x: jax.lax.dynamic_slice(
                im, (y, x, 0), (oh, ow, 3)))(img, oys, oxs)
            assert_same(K.raster_epilogue(t_raw, mode, scale, b, gh, gw, oh,
                                          ow, torch.from_numpy(oys),
                                          torch.from_numpy(oxs), norm=tnorm),
                        J._apply_norm(crops, jnorm))


@pytest.mark.parametrize("dim,size", [(16, 13), (8, 8), (40, 1)])
def test_crop_origins_read_start_indices_as_dynamic_slice(dim, size):
    """Every start index from far below to far above the axis: negative
    ones count from the far end, then all are clamped, as
    ``jax.lax.dynamic_slice`` does (the rule both the plain epilogue and
    the CUDA kernel implement)."""
    import jax

    starts = np.arange(-2 * dim - 3, 2 * dim + 4, dtype=np.int32)
    axis = jnp.arange(dim, dtype=jnp.int32)
    want = np.asarray(jax.vmap(lambda s: jax.lax.dynamic_slice(
        axis, (s,), (size,))[0])(starts))
    got = K._crop_origins(torch.from_numpy(starts), dim, size)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == 0 and got.max() == dim - size


@pytest.mark.parametrize("dtype_name,mean,std", [
    ("f32", None, None), ("bf16_norm", 127.5, 64.0),
    ("bf16_norm", IMAGENET["mean"], IMAGENET["std"]),
    ("f32", [0.5, 1.5, 2.5], None), ("f32", None, [3.0, 7.0, 11.0])])
def test_norm_static_matches_jax(dtype_name, mean, std):
    tdt, jdt, _ = DTYPES[dtype_name]
    got = T._norm_static(tdt, mean, std)
    want = J._norm_static(jdt, mean, std)
    assert got[0] == tdt
    assert got[1:] == want[1:]


def test_norm_float16_output():
    out, _ = T.decode_same_size_batch(list(SAME), device="cpu",
                                      dtype=torch.float16, **IMAGENET)
    ref, _ = T.decode_same_size_batch(list(SAME), device="cpu",
                                      dtype=torch.float32, **IMAGENET)
    assert out.dtype == torch.float16
    assert torch.equal(out, ref.to(torch.float16))


# Each case: (callable taking (api module, dtype map), expected exception).
BAD = {
    "empty": (lambda m, d: m.decode_same_size_batch([]), ValueError),
    "scale": (lambda m, d: m.decode_same_size_batch(list(SAME), scale=3),
              ValueError),
    "wire": (lambda m, d: m.decode_same_size_batch(list(SAME), wire="i8"),
             ValueError),
    "mixed_sizes": (lambda m, d: m.decode_same_size_batch(
        [SAME[0], MIXED[1]]), JpegError),
    "mixed_modes": (lambda m, d: m.decode_same_size_batch(
        [SAME[0], encode_jpeg(_photo(0, 40, 56), sampling="4:4:4")]),
        JpegError),
    "std_zero": (lambda m, d: m.decode_same_size_batch(
        list(SAME), dtype=d, mean=1.0, std=(1.0, 0.0, 2.0)), ValueError),
    "std_len": (lambda m, d: m.decode_same_size_batch(
        list(SAME), dtype=d, std=(1.0, 2.0)), ValueError),
    "mean_no_dtype": (lambda m, d: m.decode_same_size_batch(
        list(SAME), mean=0.5), ValueError),
    "crop_outside": (lambda m, d: m.decode_same_size_batch_crops(
        list(SAME), [(0, 0), (0, 0), (17, 0)], CROP), ValueError),
    "crop_boxes": (lambda m, d: m.decode_same_size_batch_crops(
        list(SAME), [(0, 0)], CROP), ValueError),
    "crop_size": (lambda m, d: m.decode_batch_crops(
        list(SAME), BOXES[1], (0, 8)), ValueError),
    "crop_misaligned": (lambda m, d: m.decode_batch_crops(
        list(SAME), BOXES[1], CROP, scale=2), ValueError),
    # The port's decode_batch_crops decodes mixed modes (beyond the JAX
    # package: test_torch_crop_batches.py); the same-size crops refuse them.
    "crop_mixed_modes": (lambda m, d: m.decode_same_size_batch_crops(
        [SAME[0], encode_jpeg(_photo(0, 40, 56), grayscale=True)],
        [(0, 0)] * 2, (8, 8)), JpegError),
    "prefetch": (lambda m, d: list(m.iter_decode_batches([SAME],
                                                         prefetch=0)),
                 ValueError),
    "iter_empty": (lambda m, d: list(m.iter_decode_batches([[]])),
                   ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_input_raises_like_jax(case):
    """The same exception type and message as the JAX package (the port
    decodes on the CPU here; the JAX side raises before compiling).  A
    ``JpegError`` from the port is its own copy's class of that name."""
    call, exc = BAD[case]
    with pytest.raises(exc) as want:
        call(J, jnp.float32)
    port = functools.partial
    api = type("Api", (), {
        name: staticmethod(port(getattr(T, name), device="cpu"))
        for name in ("decode_same_size_batch", "decode_same_size_batch_crops",
                     "decode_batch_crops", "iter_decode_batches")})
    with pytest.raises(PortJpegError if exc is JpegError else exc) as got:
        call(api, torch.float32)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_dtype_must_be_a_torch_float():
    for bad in (torch.int32, "float32", np.float32):
        with pytest.raises(ValueError, match="dtype must be floating"):
            T.decode_same_size_batch(list(SAME), dtype=bad, device="cpu")
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        T.decode_same_size_batch(list(SAME), dtype=torch.float64,
                                 device="cpu")


def test_multi_device_request_raises():
    """A device list decodes one group of whole images a device and equals
    the one-device result; a list naming a card this machine lacks, or no
    device at all, raises (nothing falls back)."""
    for devices in (["cpu", "cpu"], ("cpu",) * 4):
        got, _ = T.decode_same_size_batch(list(SAME), device=devices)
        want, _ = T.decode_same_size_batch(list(SAME), device="cpu")
        assert got.device.type == "cpu" and torch.equal(got, want)
        got, _ = T.decode_batch_crops(list(SAME), BOXES[1], CROP,
                                      device=devices)
        want, _ = T.decode_batch_crops(list(SAME), BOXES[1], CROP,
                                       device="cpu")
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="empty device list"):
        T.decode_same_size_batch(list(SAME), device=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            T.decode_same_size_batch(list(SAME), device=("cpu", "cuda:0"))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="is_available"):
        T.decode_same_size_batch(list(SAME))
    with pytest.raises(RuntimeError, match="is_available"):
        T.decode_batch_crops(list(SAME), BOXES[1], CROP, device="cuda")


def test_timers_record_every_stage():
    timers = StageTimers()
    T.decode_same_size_batch(list(SAME), device="cpu", timers=timers)
    for _ in T.iter_decode_batches([list(SAME)], device="cpu",
                                   timers=timers):
        pass
    assert {"scan", "entropy", "stage", "h2d", "device", "queue"} <= set(
        timers.snapshot())


def test_wire_i16_gives_the_same_batch():
    a, _ = T.decode_same_size_batch(list(SAME), device="cpu", wire="i16")
    b, _ = T.decode_same_size_batch(list(SAME), device="cpu")
    assert torch.equal(a, b)


def test_top_level_reexports():
    import pim_jpeg_decoder_tpu_torch as port

    for name in ("decode_same_size_batch", "decode_same_size_batch_crops",
                 "decode_batch_crops", "iter_decode_batches",
                 "iter_decode_batch_crops"):
        assert getattr(port, name) is getattr(T, name)
    assert port.decode_scaled.__module__.endswith("models.pipeline")
    assert port.decode_region.__module__.endswith("models.pipeline")
