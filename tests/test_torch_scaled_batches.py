"""The port's half-scale same-size batches against its plain reference,
``models/scaled_reference.py``, on the CPU.

``decode_same_size_batch(scale=2)`` and ``iter_decode_batches(scale=2)``
with ``device="cpu"`` run the plain PyTorch versions of the reduced-IDCT
decode and of the raster epilogue; the reference decodes each file by the
NumPy oracle at scale 2 and normalises it with plain ``torch``.  Tolerance
0, bfloat16 compared bit for bit.  The reference itself is held to the
JAX package's oracle, and the counters of the coefficients the reduced
IDCT reads to the per-block rule of specs.py 'Reduced (scaled) IDCT'.
"""

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.oracle.decoder import (
    decode_scaled_oracle as jax_decode_scaled_oracle)
from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu_torch.models import input_pipeline as T
from pim_jpeg_decoder_tpu_torch.models import scaled_reference as R
from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.utils.profiling import StageTimers

# A latent-diffusion autoencoder's [-1, 1] input, and CLIP's statistics.
SD = dict(mean=(127.5, 127.5, 127.5), std=(127.5, 127.5, 127.5))
CLIP = dict(mean=(122.7709383, 116.7460125, 104.09373615),
            std=(68.5005327, 66.6321579, 70.32316305))
DTYPES = {"u8": (None, {}), "bf16_sd": (torch.bfloat16, SD),
          "bf16_clip": (torch.bfloat16, CLIP)}
MODES = ("4:2:0", "4:4:4", "4:2:2", "gray")
# 72x88 is no multiple of a 16-pixel MCU either way.
SIZES = ((40, 56), (72, 88))
# Share of the wire's coefficients that the reduced IDCT reads at scale 2,
# by the per-block rule: luma 16 of 64, chroma min(8, 4 f_y) x min(8, 4
# f_x).
READ_SHARE = {"4:2:0": 50.0, "4:2:2": 37.5, "4:4:4": 25.0, "gray": 25.0}


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(small, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


def _blobs(mode, size, n=3, seed=0):
    h, w = size
    if mode == "gray":
        return [encode_jpeg(_photo(seed + i, h, w), quality=75 + 5 * i,
                            grayscale=True) for i in range(n)]
    return [encode_jpeg(_photo(seed + i, h, w), quality=75 + 5 * i,
                        sampling=mode) for i in range(n)]


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_scale2_batches_equal_the_reference(mode, size, dtype_name):
    dtype, stats = DTYPES[dtype_name]
    blobs = _blobs(mode, size, seed=MODES.index(mode) * 10)
    want = R.scaled_batch(blobs, 2, dtype=dtype, **stats)
    assert tuple(want.shape) == (3, -(-size[0] // 2), -(-size[1] // 2), 3)
    got, _ = T.decode_same_size_batch(blobs, scale=2, device="cpu",
                                      dtype=dtype, **stats)
    _same(got, want)
    streamed = list(T.iter_decode_batches([blobs, blobs[::-1]], scale=2,
                                          prefetch=2, device="cpu",
                                          dtype=dtype, **stats))
    assert len(streamed) == 2
    _same(streamed[0][0], want)
    _same(streamed[1][0], want.flip(0))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_reference_equals_the_jax_oracle(mode, size):
    blobs = _blobs(mode, size, n=2, seed=40)
    for scale in (2, 4, 8):
        got = R.scaled_batch(blobs, scale)
        want = np.stack([jax_decode_scaled_oracle(b, scale) for b in blobs])
        assert np.array_equal(got.numpy(), want), scale


@pytest.mark.parametrize("mode", sorted(READ_SHARE))
def test_counters_give_the_share_the_reduced_idct_reads(mode):
    blobs = _blobs(mode, (72, 88), seed=60)
    g = next(m.g for m in S.MODES.values() if m.name == mode)
    timers = StageTimers()
    T.decode_same_size_batch(blobs, scale=2, device="cpu", timers=timers)
    for _ in T.iter_decode_batches([blobs, blobs[:2]], scale=2, prefetch=2,
                                   device="cpu", timers=timers):
        pass
    mcus = scan_jpeg(blobs[0]).num_mcus * (3 + 3 + 2)
    counts = timers.counters()
    # The images' MCUs, not the 15 zero MCUs that end each transport.
    assert counts["scale.coefs_shipped"] == mcus * g * 64
    share = 100 * counts["scale.coefs_read"] / counts["scale.coefs_shipped"]
    assert share == READ_SHARE[mode]


@pytest.mark.parametrize("scale", [1, 2])
def test_no_scale_counters_at_scale_1_or_without_timers(scale):
    """At scale 1 the timers get no ``scale.*`` counter; without timers
    the scaled path counts nowhere (and runs)."""
    blobs = _blobs("4:2:0", (40, 56))
    timers = StageTimers()
    T.decode_same_size_batch(blobs, scale=1, device="cpu", timers=timers)
    assert not [k for k in timers.counters() if k.startswith("scale.")]
    got, _ = T.decode_same_size_batch(blobs, scale=scale, device="cpu")
    _same(got, R.scaled_batch(blobs, scale))
    assert not [k for k in timers.counters() if k.startswith("scale.")]


@pytest.mark.parametrize("stats", ["sd", "clip"])
def test_both_normalisations_agree_in_bfloat16(stats):
    """Over the 256 pixel values, the port's ``(x - mean) * (1/std)`` and
    the reference's ``(x - mean) / std`` round to the same bfloat16."""
    chosen = SD if stats == "sd" else CLIP
    _, mean3, inv3 = T._norm_static(torch.bfloat16, **chosen)
    x = torch.arange(256, dtype=torch.float32)[:, None]
    mean = torch.tensor(mean3, dtype=torch.float32)
    port = ((x - mean) * torch.tensor(inv3, dtype=torch.float32)).to(
        torch.bfloat16)
    plain = ((x - mean) / torch.tensor(chosen["std"], dtype=torch.float32)
             ).to(torch.bfloat16)
    assert torch.equal(port.view(torch.int16), plain.view(torch.int16))
