"""The corpus the port's host-decode tools share, made without PIL.

Counterpart of ``bench.make_corpus`` (48 ImageNet-like 500x375 4:2:0 q75
baseline JPEGs with distinct content, drawn from seed 42) for the machines
the port runs on, which need not have PIL: the scenes come from a
numpy-only generator (``synth_scene``, whose upsampled noise octaves use
:func:`bilinear_resize` in place of PIL's bilinear resize) and the port's
own ``codec.encoder.encode_jpeg`` encodes them.  No reference photograph
is added.

The host entropy-decode rates the tools print over this corpus are NOT
comparable with the JAX tools' ``host_entropy_mps``: that corpus is encoded
by PIL (libjpeg) from other pixels, so its streams differ in length and
symbol mix.  Compare rates only between runs over this corpus.

Building the corpus takes seconds (the port's encoder is Python), so it is
built once a process (:func:`make_corpus` is cached).
"""

from __future__ import annotations

import functools
import io
import time

import numpy as np

NUM_IMAGES = 48
WIDTH, HEIGHT = 500, 375
SEED = 42
# Progressive re-encodes of the corpus head (bench.py's host_progressive_mps
# fixture set).
PROGRESSIVE_IMAGES = 12


class ToolUnavailable(RuntimeError):
    """What a tool needs is missing on this machine (the native library, or
    PIL for the progressive corpus): the tool exits 2 rather than measure
    something else."""


def pil_image():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def require_pil():
    """PIL's ``Image`` module; :class:`ToolUnavailable` where PIL is not
    installed (the progressive corpus needs it: the port's encoder writes
    baseline JPEGs only)."""
    image = pil_image()
    if image is None:
        raise ToolUnavailable(
            "the progressive corpus needs PIL to re-encode the corpus as "
            "SOF2, and PIL is not installed here")
    return image


def require_native() -> None:
    """Raise :class:`ToolUnavailable` unless the port's C++ entropy decoder
    loads (``decode_scan_native`` would silently time the Python decoder)."""
    from pim_jpeg_decoder_tpu_torch.native import native_available

    if not native_available():
        raise ToolUnavailable(
            "the native entropy library did not load (g++ missing, a build "
            "error, or PIM_JPEG_TPU_NO_NATIVE=1); refusing to time the "
            "Python decoder as native")


def bilinear_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """``[h0, w0, c]`` uint8 -> ``[h, w, c]`` uint8 by separable bilinear
    interpolation at pixel centres, edges clamped."""
    def axis_weights(n_in: int, n_out: int):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0, n_in - 1)
        lo = np.floor(x).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (x - lo)

    src = img.astype(np.float32)
    lo, hi, f = axis_weights(src.shape[0], h)
    src = src[lo] * (1 - f)[:, None, None] + src[hi] * f[:, None, None]
    lo, hi, f = axis_weights(src.shape[1], w)
    src = src[:, lo] * (1 - f)[None, :, None] + src[:, hi] * f[None, :, None]
    return np.clip(np.rint(src), 0, 255).astype(np.uint8)


def synth_scene(rng, w: int, h: int) -> np.ndarray:
    """One distinct synthetic scene (``bench.synth_scene`` with the numpy
    resize): gradient base, two upsampled noise octaves, hard-edged
    rectangles and disks, fine texture."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        a, b = rng.uniform(-1, 1, 2)
        img[..., c] = rng.uniform(60, 200) + 70 * a * xx / w + 70 * b * yy / h
    for cell, amp in ((int(rng.integers(24, 64)), rng.uniform(15, 45)),
                      (int(rng.integers(6, 16)), rng.uniform(5, 25))):
        small = rng.normal(0, 1, (h // cell + 2, w // cell + 2, 3))
        small = (small - small.min()) / (np.ptp(small) + 1e-6) * 255
        up = bilinear_resize(small.astype(np.uint8), w, h).astype(np.float32)
        img += amp * (up - 128) / 128 * rng.uniform(20, 60)
    for _ in range(int(rng.integers(2, 7))):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        ry, rx = rng.integers(h // 16, h // 3), rng.integers(w // 16, w // 3)
        color = rng.uniform(0, 255, 3)
        if rng.random() < 0.5:
            img[max(0, cy - ry):cy + ry, max(0, cx - rx):cx + rx] = (
                0.6 * img[max(0, cy - ry):cy + ry,
                          max(0, cx - rx):cx + rx] + 0.4 * color)
        else:
            mask = ((yy - cy) ** 2 / max(ry, 1) ** 2
                    + (xx - cx) ** 2 / max(rx, 1) ** 2) <= 1.0
            img[mask] = 0.5 * img[mask] + 0.5 * color
    img += rng.normal(0, rng.uniform(1.5, 9.0), (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def make_corpus() -> tuple:
    """``(name, jpeg bytes)`` for the 48 corpus images, encoded by the
    port's encoder (500x375, 4:2:0, q75, seed 42)."""
    from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg

    rng = np.random.default_rng(SEED)
    return tuple(
        (f"img{i}", encode_jpeg(synth_scene(rng, WIDTH, HEIGHT), quality=75,
                                sampling="4:2:0"))
        for i in range(NUM_IMAGES))


def make_progressive_headers(blobs, n: int = PROGRESSIVE_IMAGES) -> list:
    """Progressive (SOF2) PIL re-encodes of the first ``n`` corpus images,
    parsed by the port's scanner (``bench.make_progressive_headers``).
    Needs PIL (:func:`require_pil`)."""
    from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg

    image = require_pil()
    headers = []
    for _, data in blobs[:n]:
        buf = io.BytesIO()
        image.open(io.BytesIO(data)).convert("RGB").save(
            buf, format="JPEG", progressive=True, quality=75, subsampling=2)
        headers.append(scan_jpeg(buf.getvalue()))
    return headers


def megapixels(headers) -> float:
    return sum(h.width * h.height for h in headers) / 1e6


def corpus_headers(blobs) -> tuple:
    """The corpus parsed by the port's scanner, and its megapixels."""
    from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg

    headers = [scan_jpeg(d) for _, d in blobs]
    return headers, megapixels(headers)


def timed_pass(decode, headers, mp: float) -> float:
    """MP/s of one pass of ``decode`` over ``headers`` (``mp`` megapixels)."""
    t0 = time.monotonic()
    for h in headers:
        decode(h)
    return mp / (time.monotonic() - t0)
