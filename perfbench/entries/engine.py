"""Driver of ``runtime.engine.DecodeEngine.decode_named_blobs``: one
caller in a closed loop, each call a list of named JPEG blobs, RGB kept on
the host (``keep_rgb``), no BMP written.

A call counts the megapixels of the files it returned decoded
(``FileResult.ok``), from the benchmark's own sizes of those files and not
from what the program reports about them; a file that comes back failed,
under another name or with another shape is failed work.  A seeded reservoir keeps
``check_sample`` of the window's decoded files for the comparison once the
window has closed; every other array is dropped when its call returns.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from harness.trace import call_span

ENGINE_KEYS = ("budget_mcus", "lane_tile", "prepare_threads",
               "max_images_per_batch", "max_launch_mcus", "transport",
               "wire", "scale")


class Entry:
    def __init__(self, torch, config: dict, traffic: dict, files, calls,
                 device, trace: bool, rng):
        from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
        from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig
        if config["write_bmp"]:
            raise ValueError("the benchmark writes no BMP files")
        self.torch = torch
        self.files = files
        self.calls = calls
        self.rng = rng
        self.check_sample = int(traffic["check_sample"])
        cfg = EngineConfig(**{k: config[k] for k in ENGINE_KEYS})
        cfg.validate()
        self.engine = DecodeEngine(config=cfg, keep_rgb=bool(
            config["keep_rgb"]), device=device)

    def _call(self):
        idx = next(self.calls)
        items = [(f"f{n}_{i}", self.files[i].data)
                 for n, i in enumerate(idx)]
        report = self.engine.decode_named_blobs(items, write=False)
        return idx, items, report

    def warm(self, calls: int) -> None:
        for _ in range(calls):
            self._call()

    def window(self, seconds: float, trace: bool) -> dict:
        """The measured loop: calls until ``seconds`` have passed."""
        kept: List[tuple] = []
        stages: Dict[str, float] = {}
        work_mcus: Dict[int, int] = {}
        work_images: Dict[int, int] = {}
        latencies, attempted, failed, seen = [], 0, 0, 0
        megapixels = 0.0
        t0 = time.monotonic()
        cpu0 = time.process_time()
        while True:
            ts = time.monotonic()
            if trace:
                with call_span(self.torch):
                    idx, items, report = self._call()
            else:
                idx, items, report = self._call()
            te = time.monotonic()
            latencies.append(te - ts)
            for (name, _), i, res in zip(items, idx, report.results):
                f = self.files[int(i)]
                attempted += 1
                good = (res.ok and res.name == name and res.rgb is not None
                        and res.rgb.shape == (f.height, f.width, 3)
                        and res.rgb.dtype == np.uint8)
                if not good:
                    failed += 1
                    continue
                megapixels += f.height * f.width / 1e6
                g = f.blocks_per_mcu
                work_mcus[g] = work_mcus.get(g, 0) + f.mcus
                work_images[g] = work_images.get(g, 0) + 1
                seen += 1
                if len(kept) < self.check_sample:
                    kept.append((int(i), res.rgb))
                else:
                    j = int(self.rng.integers(0, seen))
                    if j < self.check_sample:
                        kept[j] = (int(i), res.rgb)
            missing = len(items) - len(report.results)
            attempted += max(0, missing)
            failed += max(0, missing)
            if trace:
                for k, (sec, _n) in report.timers.snapshot().items():
                    stages[k] = stages.get(k, 0.0) + sec
            del report
            if te - t0 >= seconds:
                break
        cpu = time.process_time() - cpu0
        return {"seconds": te - t0, "cpu_s": cpu, "latencies": latencies,
                "attempted": attempted, "failed": failed,
                "images": attempted - failed, "megapixels": megapixels,
                "stages": stages, "kept": kept,
                "work": {"mcus": work_mcus, "images": work_images}}

    def needed(self, kept) -> set:
        """The files whose reference the comparison needs."""
        return {i for i, _ in kept}

    def compare(self, kept, rgb: Dict[int, np.ndarray]) -> Dict[str, int]:
        """The widest gap, in 8-bit levels, between a kept file's pixels and
        the reference's."""
        worst = 0
        for i, got in kept:
            gap = np.abs(got.astype(np.int16) - rgb[i].astype(np.int16))
            worst = max(worst, int(gap.max()))
        return {"max_pixel_gap": worst}

    def control(self, kept, rgb: Dict[int, np.ndarray], decode) -> list:
        """The control in the program's place: the kept files decoded by the
        reference (``decode``) with its IDCT in float16."""
        datas = {i: self.files[i].data for i, _ in kept}
        ctrl = decode(datas, idct="float16")
        return [(i, ctrl[i]) for i, _ in kept]
