"""Driver of ``models.input_pipeline.iter_decode_batches`` at a reduced
scale: the loader's driver (``entries/loader.py``: one consumer, each
batch waited on, a seeded reservoir of ``check_sample`` whole batches in
page-locked slots) over same-size batches decoded at 1/``scale``, each
``[B, ceil(H/scale), ceil(W/scale), 3]``.

The work it reports is the files' MCUs (by blocks an MCU), the scale and
the scaled output's elements; the megapixels are the files' own.  Traced,
it also reports the program's counters over the window (none where the
program has none).
"""

from __future__ import annotations

import os
from typing import Dict

from harness import spec

loader = spec.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "loader.py"),
    "perfbench_entry_loader")


class Entry(loader.Entry):
    def __init__(self, torch, config: dict, traffic: dict, files, calls,
                 device, trace: bool, rng):
        # The loader's set-up without its slots, which the scaled batch
        # sizes.
        super().__init__(torch, config, dict(traffic, check_sample=0),
                         files, calls, device, trace, rng)
        self.scale = int(config["scale"])
        self.check_sample = int(traffic["check_sample"])
        self.want_shape = (self.batch, -(-files[0].height // self.scale),
                           -(-files[0].width // self.scale), 3)
        self.slots = [torch.empty(self.want_shape,
                                  dtype=getattr(torch, config["dtype"]),
                                  pin_memory=device.type == "cuda")
                      for _ in range(self.check_sample)]

    def _counters(self) -> Dict[str, int]:
        """The program's counters (none where its timers have none)."""
        read = getattr(self.timers, "counters", None)
        return dict(read()) if read is not None else {}

    def window(self, seconds: float, trace: bool) -> dict:
        """The loader's window, with the scale in its work, the files'
        megapixels and the program's counters."""
        counters0 = self._counters()
        rec = super().window(seconds, trace)
        rec["work"] = dict(rec["work"], scale=self.scale)
        rec["megapixels"] = (rec["images"] * self.files[0].height
                             * self.files[0].width / 1e6)
        rec["counters"] = {k: v - counters0.get(k, 0)
                           for k, v in self._counters().items()}
        return rec
