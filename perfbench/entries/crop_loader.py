"""Driver of ``models.input_pipeline.iter_decode_batch_crops`` with
``mixed_sizes=True``: the loader's driver (``entries/loader.py``: one
consumer, each batch waited on, a seeded reservoir of ``check_sample``
whole batches in page-locked slots) over batches of one crop an image.

Each batch's crop origins are drawn from the run's seeded generator,
uniform over ``[0, H - crop_h] x [0, W - crop_w]`` of each file, and ride
with the batch's file indices wherever the loader's driver carries them,
into the reservoir and the comparison.

The work it reports is the MCUs each crop's pixels touch (by blocks an
MCU), so the slack MCUs of the staged sub-grid count as time and not as
work; traced, it also reports the program's counters over the window.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from harness import corpus, reference, spec

loader = spec.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader.py"),
    "perfbench_entry_loader")


def touched(origin: np.ndarray, size: int, step: int) -> np.ndarray:
    """MCUs of ``step`` pixels that a window of ``size`` pixels from each
    ``origin`` reaches along one axis."""
    return (origin + size - 1) // step - origin // step + 1


class Entry(loader.Entry):
    """What the loader's driver calls a batch's indices is here
    ``(file indices, origins)``."""

    def __init__(self, torch, config: dict, traffic: dict, files, calls,
                 device, trace: bool, rng):
        from pim_jpeg_decoder_tpu_torch.models import input_pipeline
        self.boxes_rng = np.random.default_rng(int(rng.integers(2**63)))
        self.crop = tuple(int(c) for c in config["crop"])
        ch, cw = self.crop
        if any(f.height < ch or f.width < cw for f in files):
            raise ValueError(f"a file is smaller than the {ch}x{cw} crop")
        # The loader's set-up without its slots, which a crop batch sizes,
        # and with its iterator (not yet started) replaced.
        super().__init__(torch, config, dict(traffic, check_sample=0),
                         files, calls, device, trace, rng)
        self.iterator.close()
        # Per file: height, width, MCU pixels down and across, blocks an
        # MCU.
        self.height = np.array([f.height for f in files])
        self.width = np.array([f.width for f in files])
        factors = [corpus.FACTORS[f.sampling] for f in files]
        self.mcu_h = np.array([8 * v for _, v in factors])
        self.mcu_w = np.array([8 * h for h, _ in factors])
        self.g = np.array([f.blocks_per_mcu for f in files])
        self.iterator = input_pipeline.iter_decode_batch_crops(
            self._blob_batches(), self.crop, scale=int(config["scale"]),
            prepare_threads=int(config["prepare_threads"]),
            wire=config["wire"], prefetch=int(config["prefetch"]),
            dtype=getattr(torch, config["dtype"]), mean=config["mean"],
            std=config["std"], device=device, mixed_sizes=True,
            timers=self.timers)
        self.check_sample = int(traffic["check_sample"])
        self.want_shape = (self.batch, ch, cw, 3)
        self.slots = [torch.empty(self.want_shape,
                                  dtype=getattr(torch, config["dtype"]),
                                  pin_memory=device.type == "cuda")
                      for _ in range(self.check_sample)]

    def _blob_batches(self):
        ch, cw = self.crop
        for idx in self._calls:
            ys = self.boxes_rng.integers(0, self.height[idx] - ch + 1)
            xs = self.boxes_rng.integers(0, self.width[idx] - cw + 1)
            boxes = np.stack([ys, xs], axis=1)
            self.sent.append((idx, boxes))
            yield ([self.files[i].data for i in idx],
                   [(int(y), int(x)) for y, x in boxes])

    def _counters(self) -> Dict[str, int]:
        """The program's counters (none where its timers have none)."""
        read = getattr(self.timers, "counters", None)
        return dict(read()) if read is not None else {}

    def _staged(self) -> int:
        """Batches the workers have staged (one ``crop_gather`` each)."""
        snap = self.timers.snapshot() if self.timers else {}
        return snap.get("crop_gather", (0.0, 0))[1]

    def work(self, batches) -> dict:
        """The MCUs each crop's pixels touch and the images, by blocks an
        MCU, over ``batches`` of ``(file indices, origins)``."""
        ch, cw = self.crop
        mcus: Dict[int, int] = {}
        images: Dict[int, int] = {}
        for idx, boxes in batches:
            n = (touched(boxes[:, 0], ch, self.mcu_h[idx])
                 * touched(boxes[:, 1], cw, self.mcu_w[idx]))
            for g in np.unique(self.g[idx]):
                mask = self.g[idx] == g
                mcus[int(g)] = mcus.get(int(g), 0) + int(n[mask].sum())
                images[int(g)] = images.get(int(g), 0) + int(mask.sum())
        return {"mcus": mcus, "images": images}

    def window(self, seconds: float, trace: bool) -> dict:
        """The loader's window, with the crops' work, the files' pixels,
        the program's counters and the batches staged in it."""
        counters0, staged0, taken0 = (self._counters(), self._staged(),
                                      self.taken)
        rec = super().window(seconds, trace)
        consumed = self.sent[taken0:self.taken]
        rec["work"] = dict(rec["work"], **self.work(consumed))
        rec["megapixels"] = sum(
            int((self.height[idx] * self.width[idx]).sum())
            for idx, _ in consumed) / 1e6
        rec["counters"] = {k: v - counters0.get(k, 0)
                           for k, v in self._counters().items()}
        rec["batches_staged"] = self._staged() - staged0
        return rec

    def _want(self, sent, rgb: Dict[int, np.ndarray]) -> np.ndarray:
        ch, cw = self.crop
        idx, boxes = sent
        return np.stack([reference.normalize_bf16(
            rgb[int(i)][y0:y0 + ch, x0:x0 + cw], self.config["mean"],
            self.config["std"]) for i, (y0, x0) in zip(idx, boxes)])

    def needed(self, kept) -> set:
        """The files whose reference the comparison needs."""
        return {int(i) for _, (idx, _) in kept for i in idx}
