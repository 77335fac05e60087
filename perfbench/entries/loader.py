"""Driver of ``models.input_pipeline.iter_decode_batches``: one consumer
takes same-size batches from one streaming iterator, as a training step
takes its input, and waits on each batch until it is ready on the card.

Per batch the time runs from the consumer's ``next()`` to an event,
recorded behind the yielded tensor, having passed.  A seeded reservoir
keeps ``check_sample`` whole batches of the window for the comparison once
the window has closed: each kept batch is copied into a page-locked host
slot made at set-up, so that the device's peak is the program's own and
the one batch the consumer holds.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from harness import arith, reference
from harness.trace import call_span


class Entry:
    def __init__(self, torch, config: dict, traffic: dict, files, calls,
                 device, trace: bool, rng):
        from pim_jpeg_decoder_tpu_torch.models import input_pipeline
        from pim_jpeg_decoder_tpu_torch.utils.profiling import StageTimers
        self.torch = torch
        self.config = config
        self.files = files
        self.device = device
        self.rng = rng
        self.batch = int(config["batch"])
        if int(traffic["items_per_call"]) != self.batch:
            raise ValueError(f"the traffic's items_per_call "
                             f"{traffic['items_per_call']} is not the "
                             f"configuration's batch {self.batch}")
        self.check_sample = int(traffic["check_sample"])
        self.sent: List[np.ndarray] = []
        self.timers = StageTimers() if trace else None
        self._calls = calls
        self.iterator = input_pipeline.iter_decode_batches(
            self._blob_batches(), scale=int(config["scale"]),
            prepare_threads=int(config["prepare_threads"]),
            wire=config["wire"], prefetch=int(config["prefetch"]),
            dtype=getattr(torch, config["dtype"]), mean=config["mean"],
            std=config["std"], device=device, timers=self.timers)
        self.taken = 0
        self.want_shape = (self.batch, files[0].height, files[0].width, 3)
        self.slots = [torch.empty(self.want_shape,
                                  dtype=getattr(torch, config["dtype"]),
                                  pin_memory=device.type == "cuda")
                      for _ in range(self.check_sample)]

    def _blob_batches(self):
        for idx in self._calls:
            self.sent.append(idx)
            yield [self.files[i].data for i in idx]

    def _next(self):
        """One batch, waited on; returns (tensor, its file indices, ok)."""
        torch = self.torch
        out, _headers = next(self.iterator)
        if out.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
            done.synchronize()
        idx = self.sent[self.taken]
        self.taken += 1
        ok = (tuple(out.shape) == self.want_shape
              and out.dtype == getattr(torch, self.config["dtype"])
              and out.device == self.device)
        return out, idx, ok

    def _keep(self, j: int, out):
        """A host copy of a kept batch: in slot ``j``, or a copy of its own
        where the batch came back in another shape or type."""
        slot = self.slots[j]
        if out.shape != slot.shape or out.dtype != slot.dtype:
            return out.to("cpu", copy=True)
        return slot.copy_(out)

    def warm(self, calls: int) -> None:
        for _ in range(calls):
            self._next()

    def window(self, seconds: float, trace: bool) -> dict:
        """The measured loop: batches until ``seconds`` have passed."""
        snap0 = self.timers.snapshot() if self.timers else {}
        kept: List[tuple] = []
        latencies, failed, seen = [], 0, 0
        t0 = time.monotonic()
        cpu0 = time.process_time()
        while True:
            ts = time.monotonic()
            if trace:
                with call_span(self.torch):
                    out, idx, ok = self._next()
            else:
                out, idx, ok = self._next()
            te = time.monotonic()
            latencies.append(te - ts)
            failed += not ok
            seen += 1
            if len(kept) < self.check_sample:
                j = len(kept)
                kept.append(None)
            else:
                j = int(self.rng.integers(0, seen))
            if j < self.check_sample:
                kept[j] = (self._keep(j, out), idx)
            del out
            if te - t0 >= seconds:
                break
        cpu = time.process_time() - cpu0
        self.iterator.close()
        px = self.want_shape[1] * self.want_shape[2]
        stages = (arith.stage_delta(self.timers.snapshot(), snap0)
                  if self.timers else {})
        g = self.files[0].blocks_per_mcu
        images = seen * self.batch
        return {"seconds": te - t0, "cpu_s": cpu, "latencies": latencies,
                "attempted": seen, "failed": failed, "images": images,
                "megapixels": images * px / 1e6, "stages": stages,
                "kept": kept,
                "work": {"mcus": {g: images * self.files[0].mcus},
                         "images": {g: images},
                         "out_elements": images * px * 3,
                         "out_bytes": self.torch.finfo(
                             getattr(self.torch, self.config["dtype"])).bits
                         // 8}}

    def _want(self, idx, rgb: Dict[int, np.ndarray]) -> np.ndarray:
        return np.stack([reference.normalize_bf16(
            rgb[int(i)], self.config["mean"], self.config["std"])
            for i in idx])

    def needed(self, kept) -> set:
        """The files whose reference the comparison needs."""
        return {int(i) for _, idx in kept for i in idx}

    def compare(self, kept, rgb: Dict[int, np.ndarray]) -> Dict[str, int]:
        """The widest gap between each kept batch and the reference's
        normalisation of its files' pixels, in steps of the bfloat16 grid
        at the reference's value."""
        torch = self.torch
        worst = 0
        for out, idx in kept:
            want = torch.from_numpy(self._want(idx, rgb)).to(self.device)
            worst = max(worst, reference.ulp_gap(
                torch, out.to(self.device).view(torch.int16), want))
            del want
        return {"max_ulp_gap": worst}

    def control(self, kept, rgb: Dict[int, np.ndarray], decode) -> list:
        """The control in the program's place: the reference's values of
        each kept batch cast through float8 e4m3 (``decode`` is not
        needed: the reference's pixels are in ``rgb``)."""
        torch = self.torch
        out = []
        for _batch, idx in kept:
            want = torch.from_numpy(self._want(idx, rgb)).to(self.device)
            out.append((reference.fp8_control(torch, want).view(
                torch.bfloat16), idx))
        return out
