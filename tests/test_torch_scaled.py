"""The PyTorch port's scaled decode against the JAX package's.

Scale 2/4/8 is the reduced-IDCT branch of the JAX ``_make_kernel``.  Here
the port's plain PyTorch version (what ``decode_mcus`` runs on CPU tensors)
meets the Pallas kernel in interpret mode and the NumPy oracle, on the same
seeded inputs, with tolerance 0: the spec is integer arithmetic.  The CUDA
kernel is held against the same plain version on the card by
chip_smoke.py.
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.models import pipeline as jax_pipeline
from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import decode_mcus as jax_decode
from pim_jpeg_decoder_tpu.oracle.decoder import decode_scaled_oracle
from pim_jpeg_decoder_tpu_torch.models import pipeline as P
from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K

LANE_TILE = 128
M = 128          # one JAX lane tile: no padding
MODE_KEYS = sorted(S.MODES)
MODE_IDS = [S.MODES[k].name for k in MODE_KEYS]
SAMPLINGS = {"420": dict(sampling="4:2:0"), "422": dict(sampling="4:2:2"),
             "440": dict(sampling="4:4:0"), "444": dict(sampling="4:4:4"),
             "gray": dict(grayscale=True)}


def make_inputs(mode, wire, seed):
    """Photo-like blocks, 30 uniformly random blocks, an all-max, an
    all-min and a +max/-min checkerboard block; Q=3 quantizer rows (one
    with 16-bit values) mixed per MCU.  The extremes drive DEQUANT_CLAMP,
    int32 wrap and both clamps."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(wire)
    coeffs = np.clip(np.round(rng.laplace(0.0, 8.0, (M, mode.g, 64))),
                     info.min, info.max).astype(wire)
    coeffs[3:33] = rng.integers(info.min, int(info.max) + 1,
                                (30, mode.g, 64))
    coeffs[0] = info.max
    coeffs[1] = info.min
    coeffs[2, :, ::2] = info.max
    coeffs[2, :, 1::2] = info.min
    qpool = rng.integers(1, 64, (3, mode.g, 64)).astype(np.float32)
    qpool[2] = rng.integers(1, 65536, (mode.g, 64))
    qidx = rng.integers(0, 3, M).astype(np.int32)
    qidx[:33] = 2
    return coeffs, qidx, qpool


def port(coeffs, qidx, qpool, mode, **kw):
    return K.decode_mcus(torch.from_numpy(coeffs), torch.from_numpy(qidx),
                         K.qpool_to_device(qpool, "cpu"), mode, **kw).numpy()


@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("mode_key", MODE_KEYS, ids=MODE_IDS)
def test_plain_version_matches_jax_kernel(mode_key, scale):
    mode = S.mode_for(mode_key)
    coeffs, qidx, qpool = make_inputs(mode, np.int16,
                                      seed=scale * 31 + mode.g)
    want = np.asarray(jax_decode(coeffs, qidx, qpool, mode,
                                 lane_tile=LANE_TILE, raw=True, scale=scale))
    got = port(coeffs, qidx, qpool, mode, raw=True, scale=scale)
    nn = (8 // scale) ** 2
    assert got.shape == want.shape == (3, mode.luma_slots, nn, M)
    np.testing.assert_array_equal(got, want)


def test_cuda_basis_tables_are_the_spec_matrices():
    """The reduced-IDCT tables written into the CUDA source equal
    ``specs.reduced_idct_matrix`` (the card only compares results)."""
    import re

    path = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                        "decode_kernel.cu")
    with open(path) as f:
        src = f.read()
    for n in (1, 2, 4, 8):
        body = re.search(rf"b{n}\[{n}\]\[{n}\] = \{{(.*?)\}};", src, re.S)
        values = [int(v) for v in re.findall(r"-?\d+", body.group(1))]
        assert values == [c for row in S.reduced_idct_matrix(n)
                          for c in row]


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_int8_wire_decodes_like_int16(scale):
    mode = S.mode_for((2, 1, 3))
    coeffs, qidx, qpool = make_inputs(mode, np.int8, seed=scale)
    np.testing.assert_array_equal(
        port(coeffs, qidx, qpool, mode, raw=True, scale=scale),
        port(coeffs.astype(np.int16), qidx, qpool, mode, raw=True,
             scale=scale))


def _photo(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(small, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_decode_scaled_matches_oracle_and_jax(name, scale):
    """Odd dimensions (37x61): ceil(H/scale) x ceil(W/scale) outputs.  The
    JAX package runs at scale 2 for every mode and at every scale for
    4:2:0 (each of its calls compiles a Pallas program)."""
    data = encode_jpeg(_photo(scale, 37, 61), quality=85, **SAMPLINGS[name])
    got = P.decode_scaled(data, scale, device="cpu")
    assert got.shape == (-(-37 // scale), -(-61 // scale), 3)
    np.testing.assert_array_equal(got, decode_scaled_oracle(data, scale))
    if scale == 2 or name == "420":
        np.testing.assert_array_equal(
            got, jax_pipeline.decode_scaled(data, scale, lane_tile=LANE_TILE))


def test_decode_scaled_scale_1_is_a_full_decode():
    data = encode_jpeg(_photo(1), quality=85, sampling="4:2:0")
    np.testing.assert_array_equal(P.decode_scaled(data, 1, device="cpu"),
                                  P.decode_bytes(data, device="cpu"))
    with pytest.raises(ValueError, match="scale must be 1, 2, 4 or 8"):
        P.decode_scaled(data, 3, device="cpu")
    with pytest.raises(ValueError, match="scale must be 1, 2, 4 or 8"):
        jax_pipeline.decode_scaled(data, 3)


@pytest.mark.parametrize("name", ["420", "444", "gray"])
def test_decode_region_matches_jax(name):
    """Unaligned boxes, through the YCbCr kernel (4:2:0, gray) and the
    RGB kernel (4:4:4), equal the JAX package and a slice of a full
    decode."""
    data = encode_jpeg(_photo(7, 48, 64), quality=85, **SAMPLINGS[name])
    full = P.decode_bytes(data, device="cpu")
    for y0, x0, h, w in ((3, 5, 20, 30), (0, 0, 48, 64), (47, 63, 1, 1)):
        got = P.decode_region(data, y0, x0, h, w, device="cpu")
        np.testing.assert_array_equal(got, full[y0:y0 + h, x0:x0 + w])
        np.testing.assert_array_equal(
            got, jax_pipeline.decode_region(data, y0, x0, h, w,
                                            lane_tile=LANE_TILE))


@pytest.mark.parametrize("box", [(-1, 0, 4, 4), (0, 0, 0, 4), (40, 0, 9, 4),
                                 (0, 60, 4, 5)])
def test_decode_region_rejects_boxes_like_jax(box):
    data = encode_jpeg(_photo(3, 48, 64), quality=85, sampling="4:2:0")
    with pytest.raises(ValueError) as want:
        jax_pipeline.decode_region(data, *box, lane_tile=LANE_TILE)
    with pytest.raises(ValueError) as got:
        P.decode_region(data, *box, device="cpu")
    assert str(got.value) == str(want.value)


def _digests(root):
    return {n: hashlib.sha1((root / n).read_bytes()).hexdigest()
            for n in sorted(os.listdir(root)) if n.endswith(".bmp")}


def test_cli_scale_2_matches_jax_cli(tmp_path, monkeypatch):
    """``--scale 2`` BMPs of the port's CLI equal the JAX CLI's, byte for
    byte, over packed, dedicated and banded launches of every mode."""
    from pim_jpeg_decoder_tpu.cli import main as jax_main
    from pim_jpeg_decoder_tpu_torch.cli import main as port_main

    for k, v in {"PIM_JPEG_TPU_BUDGET_MCUS": "128",
                 "PIM_JPEG_TPU_LANE_TILE": "128",
                 "PIM_JPEG_TPU_MAX_LAUNCH": "256",
                 "PIM_JPEG_TPU_NUM_DEVICES": "1",
                 "PIM_JPEG_TPU_PREPARE_THREADS": "2"}.items():
        monkeypatch.setenv(k, v)
    src = tmp_path / "src"
    src.mkdir()
    for i, (name, (h, w)) in enumerate((("420", (45, 61)),
                                        ("422", (37, 50)),
                                        ("440", (30, 44)),
                                        ("444", (40, 56)),
                                        ("gray", (50, 70)),
                                        ("420", (300, 260)))):  # banded
        (src / f"{i}_{name}.jpg").write_bytes(
            encode_jpeg(_photo(i, h, w), quality=80, **SAMPLINGS[name]))
    dirs = []
    for d in ("jax", "port"):
        shutil.copytree(src, tmp_path / d)
        dirs.append(tmp_path / d)
    jax_files = [str(p) for p in sorted(dirs[0].iterdir())]
    port_files = [str(p) for p in sorted(dirs[1].iterdir())]
    assert jax_main(jax_files + ["--quiet", "--scale", "2"]) == 0
    assert port_main(port_files + ["--quiet", "--scale", "2",
                                   "--device", "cpu"]) == 0
    assert len(_digests(dirs[1])) == 6
    assert _digests(dirs[1]) == _digests(dirs[0])
