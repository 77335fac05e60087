"""The PyTorch port's single-image API against the JAX package's.

``TorchJpegDecoder(device="cpu")`` / ``decode_bytes`` run the plain
PyTorch versions of the CUDA kernels; the JAX ``TpuJpegDecoder`` runs the
Pallas kernels in interpret mode.  Same JPEG bytes (``encode_jpeg`` and PIL
fixtures), tolerance 0.
"""

import io

import numpy as np
import pytest
from PIL import Image

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.io.bmp import read_bmp
from pim_jpeg_decoder_tpu.models import pipeline as jax_pipeline
from pim_jpeg_decoder_tpu.oracle.decoder import decode_bytes_oracle
from pim_jpeg_decoder_tpu_torch.models import pipeline as P

LANE_TILE = 128  # JAX interpret-mode tile, as in tests/test_kernel.py

FIXTURES = {
    "444": dict(sampling="4:4:4"),
    "422": dict(sampling="4:2:2"),
    "440": dict(sampling="4:4:0"),
    "420": dict(sampling="4:2:0"),
    "gray": dict(grayscale=True),
    "420_dri": dict(sampling="4:2:0", restart_interval=4),
}


def jax_decode(data, transport="auto"):
    return jax_pipeline.TpuJpegDecoder(lane_tile=LANE_TILE,
                                       transport=transport).decode(data).rgb


@pytest.mark.parametrize("transport", ["auto", "rgb", "ycbcr"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_decoder_matches_jax(photo_image, name, transport):
    data = encode_jpeg(photo_image, quality=85, **FIXTURES[name])
    got = P.TorchJpegDecoder(device="cpu", transport=transport).decode(data)
    want = jax_decode(data, transport)
    assert got.rgb.shape == want.shape == photo_image.shape
    np.testing.assert_array_equal(got.rgb, want)
    assert got.header.width == photo_image.shape[1]


@pytest.mark.parametrize("sampling", ["4:2:0", "4:2:2", "4:4:4"])
def test_odd_dimensions(rng, sampling):
    img = rng.integers(0, 256, (37, 61, 3), dtype=np.uint8)
    data = encode_jpeg(img, quality=90, sampling=sampling)
    got = P.decode_bytes(data, device="cpu")
    assert got.shape == (37, 61, 3)
    np.testing.assert_array_equal(got, jax_decode(data))
    np.testing.assert_array_equal(got, decode_bytes_oracle(data).rgb)


def test_noise_hits_the_clamps(noise_image):
    data = encode_jpeg(noise_image, quality=98, sampling="4:2:0")
    for transport in ("rgb", "ycbcr"):
        got = P.TorchJpegDecoder("cpu", transport).decode(data).rgb
        np.testing.assert_array_equal(got, jax_decode(data, transport))


def test_progressive_via_pil(photo_image):
    buf = io.BytesIO()
    Image.fromarray(photo_image).save(buf, "JPEG", quality=85,
                                      progressive=True, subsampling=2)
    data = buf.getvalue()
    np.testing.assert_array_equal(P.decode_bytes(data, device="cpu"),
                                  jax_decode(data))


def test_gray_pixel_exact_vs_pil(photo_image):
    gray = np.asarray(Image.fromarray(photo_image).convert("L"))
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, "JPEG", quality=90)
    got = P.decode_bytes(buf.getvalue(), device="cpu")
    pil = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(got, pil)


def test_decode_bytes_matches_jax_default(photo_image):
    data = encode_jpeg(photo_image, quality=80, sampling="4:2:0")
    np.testing.assert_array_equal(P.decode_bytes(data, device="cpu"),
                                  jax_pipeline.decode_bytes(data))


def test_decode_file_writes_the_jax_bmp(tmp_path, photo_image):
    src = tmp_path / "photo.jpeg"
    src.write_bytes(encode_jpeg(photo_image, quality=85, sampling="4:4:4"))
    out = P.decode_file(str(src), device="cpu")
    assert out == str(tmp_path / "photo.bmp")
    port_bytes = (tmp_path / "photo.bmp").read_bytes()
    jax_out = jax_pipeline.decode_file(str(src),
                                       str(tmp_path / "jax.bmp"))
    assert port_bytes == (tmp_path / "jax.bmp").read_bytes()
    np.testing.assert_array_equal(read_bmp(jax_out), read_bmp(out))


@pytest.mark.parametrize("path", ["a/b.jpg", "x.JPEG", "noext", "d.e/f",
                                  "./g.tar.jpg"])
def test_output_path_rule(path):
    assert P.output_path(path) == jax_pipeline.output_path(path)


def test_build_qpool_matches_jax(photo_image, noise_image):
    from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu.ops import specs as S
    headers = [scan_jpeg(encode_jpeg(img, quality=q, sampling="4:2:0"))
               for img, q in ((photo_image, 90), (noise_image, 40))]
    mode = S.mode_for(headers[0].mode_key)
    np.testing.assert_array_equal(P.build_qpool(headers, mode),
                                  jax_pipeline.build_qpool(headers, mode))


def test_rejects_unknown_transport_and_device():
    with pytest.raises(ValueError, match="transport"):
        P.TorchJpegDecoder("cpu", transport="yuv")
    with pytest.raises(ValueError, match="device"):
        P.TorchJpegDecoder("meta")
