"""The benchmark's one traffic generator: JPEG files and the calls that
carry them, from a traffic file's parameters and the run's seed.

A traffic file (``traffic/<cell>.json``) holds

- ``groups``: the distinct files, each group ``{"count", "height",
  "width", "sampling" ("4:2:0" | "4:4:4" | "4:2:2"), "quality",
  "restart_rows" (0: no restart markers), "content": {"cell", "waves",
  "noise"}}``, and optionally ``"optimize"`` (Huffman tables of the file's
  own) and ``"progressive"`` (SOF2), both false unless given;
- ``items_per_call``: files per call (the engine) or per batch (the loader),
  drawn with replacement from all distinct files, uniformly;
- ``loop``: ``"closed"`` (one caller; the next call starts when the last
  one has returned).

Content is photo-like, after the pattern of the repository's smoke test:
flat colour patches ``cell`` pixels wide (their borders are the edges),
two sinusoids of amplitudes ``waves`` with periods drawn a file, and
Gaussian sensor noise of ``noise`` levels.  The pixels are drawn on the
run's device from a ``torch.Generator`` seeded with the seed, a group in one
call, then encoded by PIL (libjpeg-turbo) on a few threads, with the
standard Huffman tables unless a group asks otherwise.  The same seed on the same kind of device gives
the same files and the same calls.
"""

from __future__ import annotations

import dataclasses
import io
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List

import numpy as np

SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
# Luma sampling factors (h, v) of each subsampling: the MCU is 8h x 8v.
FACTORS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}
ENCODE_THREADS = 8


def pil_image():
    """PIL's ``Image`` module; the benchmark needs it to write its files."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("the benchmark encodes its corpus with PIL "
                           "(Pillow), which does not import here") from e
    return Image


@dataclasses.dataclass
class JpegFile:
    """One distinct file of the corpus."""
    data: bytes
    height: int
    width: int
    sampling: str

    @property
    def blocks_per_mcu(self) -> int:
        h, v = FACTORS[self.sampling]
        return h * v + 2

    @property
    def mcus(self) -> int:
        h, v = FACTORS[self.sampling]
        return -(-self.height // (8 * v)) * -(-self.width // (8 * h))

    @property
    def bpp(self) -> float:
        return len(self.data) * 8 / (self.height * self.width)


def seed_words(seed: int, salt: int) -> int:
    """A 63-bit generator seed from the run's seed (any whole number) and a
    salt."""
    seed %= 1 << 128
    ss = np.random.SeedSequence([seed & (2**64 - 1), seed >> 64, salt])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def synth_pixels(torch, gen, n: int, h: int, w: int, content: dict,
                 device) -> "torch.Tensor":
    """``[n, h, w, 3]`` uint8 photo-like pixels on ``device``."""
    cell = int(content["cell"])
    amp_x, amp_y = content["waves"]
    ph, pw = h // cell + 2, w // cell + 2
    patches = torch.randint(0, 256, (n, 3, ph, pw), generator=gen,
                            device=device, dtype=torch.int16)
    img = (patches.repeat_interleave(cell, 2).repeat_interleave(cell, 3)
           [:, :, :h, :w].to(torch.float32))
    periods = torch.rand((n, 2), generator=gen, device=device)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    yy = torch.arange(h, device=device, dtype=torch.float32)
    img += amp_x * torch.sin(xx[None, :] / (7.0 + 5.0 * periods[:, :1])
                             )[:, None, None, :]
    img += amp_y * torch.cos(yy[None, :] / (11.0 + 5.0 * periods[:, 1:])
                             )[:, None, :, None]
    img += float(content["noise"]) * torch.randn(
        img.shape, generator=gen, device=device)
    return img.clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)


def encode(pixels: np.ndarray, sampling: str, quality: int,
           restart_rows: int, optimize: bool = False,
           progressive: bool = False) -> bytes:
    """One file by PIL: baseline with the standard tables unless
    ``optimize`` (tables of its own) or ``progressive`` (SOF2)."""
    image = pil_image()
    buf = io.BytesIO()
    kwargs = {"restart_marker_rows": restart_rows} if restart_rows else {}
    image.fromarray(pixels).save(buf, "JPEG", quality=quality,
                                 subsampling=SUBSAMPLING[sampling],
                                 optimize=bool(optimize),
                                 progressive=bool(progressive), **kwargs)
    return buf.getvalue()


def build_corpus(torch, traffic: dict, seed: int, device) -> List[JpegFile]:
    """Every distinct file of ``traffic``, the same for the same seed."""
    pil_image()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed, 1))
    files: List[JpegFile] = []
    with ThreadPoolExecutor(ENCODE_THREADS) as pool:
        for group in traffic["groups"]:
            n, h, w = group["count"], group["height"], group["width"]
            pixels = synth_pixels(torch, gen, n, h, w, group["content"],
                                  device).cpu().numpy()
            datas = pool.map(encode, pixels, [group["sampling"]] * n,
                             [group["quality"]] * n,
                             [group.get("restart_rows", 0)] * n,
                             [group.get("optimize", False)] * n,
                             [group.get("progressive", False)] * n)
            for data in datas:
                files.append(JpegFile(data, h, w, group["sampling"]))
    return files


def calls(traffic: dict, n_files: int, seed: int) -> Iterator[np.ndarray]:
    """The endless stream of calls: each an array of ``items_per_call``
    file indices, drawn uniformly with replacement."""
    if traffic["loop"] != "closed":
        raise ValueError(f"no driver for a {traffic['loop']!r} loop")
    rng = np.random.default_rng(seed_words(seed, 2))
    k = int(traffic["items_per_call"])
    while True:
        yield rng.integers(0, n_files, size=k)
