"""The decode engine: producer/consumer pipeline around the CUDA kernels.

Counterpart of ``pim_jpeg_decoder_tpu/runtime/engine.py`` on one explicit
device, with the same stages and failure semantics:

  prepare pool (N threads)   read + marker scan + C++ entropy decode
        |                    (the native code releases the GIL)
        v
  ModeRouter / BatchPacker   greedy budget packing per sampling mode
        |                    (dedicated launches for big images, MCU tiles
        |                    for images over the launch cap)
        v  H2D on a side stream: pinned host copy -> non_blocking copy,
        |  with an event the launch waits on
        v  bounded queue (backpressure)
  consumer thread            kernel on the current stream -> D2H into a
                             pinned buffer (event) -> raster assembly /
                             fused BMP write on a finish pool

Per-file failures are recorded and skipped; one image's failure never
poisons the others of its batch.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pim_jpeg_decoder_tpu_torch.codec.header import JpegHeader
from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu_torch.io.bmp import write_bmp, write_bmp_ycbcr
from pim_jpeg_decoder_tpu_torch.native import native_available
from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig
from pim_jpeg_decoder_tpu_torch.utils.log import logger
from pim_jpeg_decoder_tpu_torch.utils.profiling import STAGES, StageTimers
from pim_jpeg_decoder_tpu_torch.models.pipeline import (
    assemble_raster_raw_scaled,
    assemble_raster_ycbcr,
    entropy_decode,
    output_path,
    resolve_device,
)
from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import decode_mcus
from pim_jpeg_decoder_tpu_torch.runtime.batching import (
    Batch,
    ModeRouter,
    PreparedImage,
    compact_wire,
)

_STAGE_LABELS = {
    "prepare": "MCU prepare (scan + entropy decode) time",
    "queue": "Queue waiting time (incl. batch pop)",
    "h2d": "Host->device transfer time",
    "kernel": "Device kernel launch time",
    "d2h": "Device->host transfer time",
    "write": "BMP write time",
}


@dataclasses.dataclass
class _BandAccumulator:
    """Assembly state for one over-max_launch image decoded in tiles."""
    name: str
    uid: int
    header: JpegHeader
    raster: np.ndarray          # [H/s, W/s, 3], tiles pasted as they finish
    remaining: int              # tiles still in flight
    failed: bool = False


@dataclasses.dataclass
class FileResult:
    name: str
    ok: bool
    out_path: Optional[str] = None
    rgb: Optional[np.ndarray] = None
    error: Optional[str] = None
    megapixels: float = 0.0


@dataclasses.dataclass
class EngineReport:
    results: List[FileResult]
    timers: StageTimers
    # Launch geometry (device_profile.LaunchKey) -> count, for the
    # device-phase breakdown (the reference's per-DPU-phase counters).
    launch_stats: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    # Launch geometry -> per-dispatch wall seconds (the first dispatch of
    # a process also builds or loads the kernel library), for the init line.
    dispatch_times: Dict[tuple, list] = dataclasses.field(
        default_factory=dict)
    device: Optional[torch.device] = None

    @property
    def ok_count(self) -> int:
        return sum(r.ok for r in self.results)

    @property
    def total_megapixels(self) -> float:
        return sum(r.megapixels for r in self.results if r.ok)

    def print_profile(self, device_phases: str = "off") -> None:
        """Print the Profiles block: host wall-clock per stage, the device
        program init line, and the per-phase device breakdown.

        ``device_phases``: "off" = no breakdown; "cached" = from the disk
        cache of ``runtime/device_profile.py`` (launches nothing; a hint
        when unmeasured); "measure" = time any missing launch geometry now.
        A CPU engine prints neither device line: a CPU time is not a device
        time.
        """
        snap = self.timers.snapshot()
        lines = ["Profiles:",
                 f" - Total execution time: {self.timers.total():.6f} (s)"]
        for key in STAGES:
            if key in snap:
                lines.append(f" - {_STAGE_LABELS[key]}: {snap[key][0]:.6f}"
                             f" (s)")
        if "kernel" in snap:
            lines.append(f" - The number of device launches: "
                         f"{snap['kernel'][1]}")
        lines.append(f" - Decoded files: {self.ok_count}/{len(self.results)}")
        lines.append(f" - Total megapixels: {self.total_megapixels:.2f}")
        on_card = self.device is not None and self.device.type == "cuda"
        if self.dispatch_times and on_card:
            # The reference's "initialization" counter.  Here the cold cost
            # is the first use of the kernel library in the process (nvcc
            # build on a new source hash, else loading it): a first dispatch
            # of a geometry over the warm median by > max(0.1 s, 5x).
            warm = [d for ds in self.dispatch_times.values()
                    for d in ds[1:]]
            typical = statistics.median(warm) if warm else 0.0
            excess = [ds[0] - typical for ds in self.dispatch_times.values()]
            cold = [e for e in excess if e > max(0.1, 5 * typical)]
            lines.append(f" - Device program init (nvcc build + module "
                         f"load, {len(cold)} cold geometries): "
                         f"{sum(cold):.6f} (s)")
        if device_phases != "off" and self.launch_stats and on_card:
            from pim_jpeg_decoder_tpu_torch.runtime.device_profile import (
                phase_report_lines)
            lines += phase_report_lines(self.launch_stats,
                                        measure=device_phases == "measure",
                                        device=self.device)
        print("\n".join(lines))


def _fail(results: Dict[int, FileResult], images, error: str) -> None:
    for img, _ in images:
        if img.band_target is not None:
            img.band_target[0].failed = True
        results[img.uid] = FileResult(img.name, False, error=error)


class DecodeEngine:
    """High-throughput multi-image decoder on one device.

    Args:
      budget_mcus: MCUs per packed device batch.
      lane_tile: MCU alignment of every launch size (keeps launch sizes on
        the JAX engine's grid; the kernel itself takes any count).
      prepare_threads: host entropy-decode parallelism.
      keep_rgb: retain decoded arrays in results (for benchmarking/tests).
      device: "cuda" (default; must exist), "cuda:N" or "cpu" (the kernels'
        plain PyTorch versions).
    """

    def __init__(self, budget_mcus: Optional[int] = None,
                 lane_tile: Optional[int] = None,
                 prepare_threads: Optional[int] = None,
                 keep_rgb: bool = False,
                 config: Optional[EngineConfig] = None,
                 device="cuda"):
        cfg = config or EngineConfig.from_env(
            budget_mcus=budget_mcus, lane_tile=lane_tile,
            prepare_threads=prepare_threads)
        cfg.validate()
        if cfg.num_devices not in (None, 1):
            raise NotImplementedError(
                "multi-GPU decode is not ported yet (ROADMAP.md Queue 1, "
                "item 11); one engine drives one device")
        self.config = cfg
        self.budget_mcus = cfg.budget_mcus
        self.lane_tile = cfg.lane_tile
        self.prepare_threads = cfg.prepare_threads
        self.max_images = cfg.max_images_per_batch
        self.max_launch_mcus = cfg.max_launch_mcus
        self.transport = cfg.transport
        self.wire = cfg.wire
        self.scale = cfg.scale
        self.keep_rgb = keep_rgb
        self.device = resolve_device(device)
        self._h2d_stream = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._h2d_stream = torch.cuda.Stream(self.device)

    # -- pipeline stages ------------------------------------------------------

    def _prepare(self, name: str, data: bytes, uid: int,
                 timers: StageTimers) -> PreparedImage:
        with timers.stage("prepare"):
            header = scan_jpeg(data)
            # Images bigger than a packed batch fan their restart segments
            # (or progressive scan chains) across cores.
            threads = 1
            if header.num_mcus > self.budget_mcus:
                threads = min(self.prepare_threads, os.cpu_count() or 1)
            coeffs = entropy_decode(header, threads=threads)
            return PreparedImage(name, header, coeffs, uid=uid)

    def _stage_batch(self, batch: Batch, timers: StageTimers) -> Batch:
        """Start the H2D copy (producer side) so it overlaps the consumer's
        kernel and D2H of earlier batches."""
        if self.wire == "auto":
            batch.coeffs = compact_wire(batch.coeffs)
        arrays = (batch.coeffs, batch.qidx, batch.qpool.astype(np.int32))
        with timers.stage("h2d"):
            if self._h2d_stream is None:
                batch.coeffs, batch.qidx, batch.qpool = (
                    torch.from_numpy(a) for a in arrays)
                return batch
            with torch.cuda.stream(self._h2d_stream):
                batch.coeffs, batch.qidx, batch.qpool = (
                    torch.from_numpy(a).pin_memory().to(
                        self.device, non_blocking=True) for a in arrays)
                batch.ready = self._h2d_stream.record_event()
        return batch

    def _dedicated_budget(self, num_mcus: int) -> int:
        """Launch size for a dedicated (single-image/tile) router: the
        smallest covering bucket, capped at max_launch_mcus and aligned."""
        lt = self.lane_tile
        if num_mcus <= S.MCU_BUCKETS[-1]:
            budget = min(S.bucket_mcus(num_mcus),
                         max(self.max_launch_mcus, lt))
            budget = max(budget, num_mcus)
        else:
            budget = num_mcus
        return -(-budget // lt) * lt

    def _split_bands(self, prepared: PreparedImage):
        """MCU-aligned tiles of an over-max_launch_mcus image (generator):
        full-width row bands when a row fits the launch cap, 2-D tiles
        otherwise.  Each tile is its own launch; the decoded tiles paste
        into one accumulator (written by the consumer thread only)."""
        header = prepared.header
        mode = S.mode_for(header.mode_key)
        gw, gh = header.mcu_cols, header.mcu_rows
        cols_per = min(gw, self.max_launch_mcus)
        rows_per = max(1, self.max_launch_mcus // cols_per)
        px_h, px_w = 8 * mode.v, 8 * mode.h
        s = self.scale
        n_tiles = (-(-gh // rows_per)) * (-(-gw // cols_per))
        acc = _BandAccumulator(
            prepared.name, prepared.uid, header,
            np.empty((-(-header.height // s), -(-header.width // s), 3),
                     np.uint8),
            remaining=n_tiles)
        grid = prepared.coeffs[: gh * gw].reshape(gh, gw, mode.g, 64)
        for r0 in range(0, gh, rows_per):
            rows = min(rows_per, gh - r0)
            for c0 in range(0, gw, cols_per):
                cols = min(cols_per, gw - c0)
                tile_header = dataclasses.replace(
                    header,
                    height=min(rows * px_h, header.height - r0 * px_h),
                    width=min(cols * px_w, header.width - c0 * px_w))
                tile_coeffs = np.ascontiguousarray(
                    grid[r0:r0 + rows, c0:c0 + cols]).reshape(-1, mode.g, 64)
                tile = PreparedImage(
                    prepared.name, tile_header, tile_coeffs,
                    uid=prepared.uid,
                    band_target=(acc, r0 * px_h // s, c0 * px_w // s))
                router = ModeRouter(self._dedicated_budget(
                    tile_header.num_mcus), max_images=1,
                    align=self.lane_tile)
                router.add(tile)
                yield from router.flush_all()

    def _use_ycbcr(self, mode: S.ModeSpec) -> bool:
        """YCbCr planes whenever they are fewer D2H bytes than RGB (every
        mode except 4:4:4), unless the transport is forced.  Scaled decode
        always emits reduced RGB (the config refuses ycbcr with it)."""
        if self.scale != 1 or self.transport == "rgb":
            return False
        if self.transport == "ycbcr":
            return True
        return mode.ycbcr_saves_bytes

    def _launch_key(self, batch: Batch) -> tuple:
        """The launch geometry for the device-phase profile, from the
        staged tensors: the JAX engine's key with one device."""
        wire = "i8" if batch.coeffs.dtype == torch.int8 else "i16"
        return ((batch.mode.h, batch.mode.v, batch.mode.ncomp),
                int(batch.coeffs.shape[0]), self.lane_tile, batch.transport,
                self.scale, wire, int(batch.qpool.shape[0]))

    def _dispatch_batch(self, batch: Batch, timers: StageTimers):
        """Launch the kernel and start the D2H copy; returns
        ``(host_output, done_event)`` (the event is None on the CPU)."""
        ycbcr = self._use_ycbcr(batch.mode)
        batch.transport = "ycbcr" if ycbcr else "rgb"
        inputs = (batch.coeffs, batch.qidx, batch.qpool)
        with timers.stage("kernel"):
            if self._h2d_stream is None:
                out = decode_mcus(*inputs, batch.mode, raw=not ycbcr,
                                  ycbcr=ycbcr, scale=self.scale)
                return out.numpy(), None
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(batch.ready)
            for t in inputs:
                # Allocated on the H2D stream, used on this one: keep the
                # caching allocator from reusing them too early.
                t.record_stream(stream)
            out = decode_mcus(*inputs, batch.mode, raw=not ycbcr,
                              ycbcr=ycbcr, scale=self.scale)
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            return host, stream.record_event()

    def _finish_batch(self, batch: Batch, host_out, done,
                      timers: StageTimers, write: bool,
                      results: Dict[int, FileResult],
                      finish_pool=None) -> None:
        ycbcr = batch.transport == "ycbcr"
        with timers.stage("d2h"):
            # [g, 64, alloc] YCbCr planes or [3, luma_slots, nn, alloc] RGB
            if done is not None:
                done.synchronize()
                host_out = host_out.numpy()
            raw = host_out

        def finish_safe(img, off) -> None:
            # Per-image isolation: an assembly/write failure must not
            # poison the other images of the batch.
            try:
                self._finish_image(img, off, raw, ycbcr, write, results)
            except Exception as e:
                logger.error("finishing %s failed: %s", img.name, e)
                _fail(results, [(img, off)], f"output failed: {e}")

        with timers.stage("write"):
            # Independent images fan out across the finish pool (the C++
            # finishers release the GIL).  Band tiles and duplicate output
            # names stay on the consumer thread: the accumulator is not
            # thread-safe, and two writers of one path would interleave.
            pooled = []
            if finish_pool is not None and len(batch.images) > 1:
                names = [img.name for img, _ in batch.images]
                dup = ({nm for nm in names if names.count(nm) > 1}
                       if write else set())
                pooled = [(img, off) for img, off in batch.images
                          if img.band_target is None
                          and img.name not in dup]
            if len(pooled) > 1:
                in_pool = {id(img) for img, _ in pooled}
                futures = [finish_pool.submit(finish_safe, img, off)
                           for img, off in pooled]
                for img, off in batch.images:
                    if id(img) not in in_pool:
                        finish_safe(img, off)
                for fut in futures:
                    fut.result()  # finish_safe never raises
            else:
                for img, off in batch.images:
                    finish_safe(img, off)

    def _finish_image(self, img, off, raw, ycbcr: bool, write: bool,
                      results: Dict[int, FileResult]) -> None:
        header = img.header
        if (ycbcr and write and not self.keep_rgb
                and img.band_target is None and native_available()):
            # One native pass: YCbCr planes -> padded BGR BMP rows,
            # byte-identical to the raster route below.
            mode = S.mode_for(header.mode_key)
            res = FileResult(img.name, True,
                             megapixels=header.width * header.height / 1e6)
            res.out_path = output_path(img.name)
            write_bmp_ycbcr(res.out_path, raw, off, mode.v, mode.h,
                            mode.ncomp, header.mcu_rows, header.mcu_cols,
                            header.height, header.width)
            results[img.uid] = res
            return
        if ycbcr:
            rgb = assemble_raster_ycbcr(header, raw, mcu_off=off)
        else:
            rgb = assemble_raster_raw_scaled(header, raw, self.scale,
                                             mcu_off=off)
        if img.band_target is not None:
            acc, y0, x0 = img.band_target
            acc.raster[y0:y0 + rgb.shape[0], x0:x0 + rgb.shape[1]] = rgb
            acc.remaining -= 1
            if acc.remaining > 0 or acc.failed:
                return
            img_name, header, rgb, uid = (acc.name, acc.header, acc.raster,
                                          acc.uid)
        else:
            img_name, uid = img.name, img.uid
        res = FileResult(img_name, True,
                         megapixels=header.width * header.height / 1e6)
        if write:
            res.out_path = output_path(img_name)
            write_bmp(res.out_path, rgb)
        if self.keep_rgb:
            res.rgb = rgb
        results[uid] = res

    # -- public API -----------------------------------------------------------

    def decode_named_blobs(self, items: Sequence[Tuple[str, bytes]],
                           write: bool = False) -> EngineReport:
        """Decode (name, bytes) pairs through the full pipeline.

        Set PIM_JPEG_TPU_PROFILE=<dir> to record a ``torch.profiler`` trace
        of the run (host ops, and on a card the kernels and copies), written
        as a Chrome trace JSON file into that directory.
        """
        trace_dir = os.environ.get("PIM_JPEG_TPU_PROFILE")
        if not trace_dir:
            return self._decode_named_blobs(items, write)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            report = self._decode_named_blobs(items, write)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"pjt_trace_{os.getpid()}_{time.time_ns()}.json"))
        return report

    def _decode_named_blobs(self, items: Sequence[Tuple[str, bytes]],
                            write: bool) -> EngineReport:
        timers = StageTimers()
        results: Dict[int, FileResult] = {}
        launch_stats: Dict[tuple, int] = {}
        dispatch_times: Dict[tuple, list] = {}
        batch_q: "queue.Queue[Optional[Batch]]" = queue.Queue(maxsize=4)
        router = ModeRouter(self.budget_mcus, max_images=self.max_images,
                            align=self.lane_tile)

        def consumer() -> None:
            pending = collections.deque()  # depth-2 device pipeline
            finish_pool = (ThreadPoolExecutor(self.prepare_threads,
                                              thread_name_prefix="pjt-fin")
                           if self.prepare_threads > 1 else None)

            def drain_one() -> None:
                batch, host_out, done = pending.popleft()
                try:
                    self._finish_batch(batch, host_out, done, timers, write,
                                       results, finish_pool)
                except Exception as e:  # record, don't kill the pipeline
                    logger.error("device decode failed: %s", e)
                    _fail(results, batch.images,
                          f"device decode failed: {e}")

            while True:
                with timers.stage("queue"):
                    batch = batch_q.get()
                if batch is None:
                    break
                try:
                    t_disp = time.monotonic()
                    host_out, done = self._dispatch_batch(batch, timers)
                    # Only launches that went out count, on this thread.
                    key = self._launch_key(batch)
                    launch_stats[key] = launch_stats.get(key, 0) + 1
                    dispatch_times.setdefault(key, []).append(
                        time.monotonic() - t_disp)
                    pending.append((batch, host_out, done))
                except Exception as e:
                    logger.error("device decode failed: %s", e)
                    _fail(results, batch.images,
                          f"device decode failed: {e}")
                if len(pending) >= 2:
                    drain_one()
            while pending:
                drain_one()
            if finish_pool is not None:
                finish_pool.shutdown(wait=True)

        consumer_thread = threading.Thread(target=consumer, daemon=True)
        consumer_thread.start()

        def stage_safe(batches) -> None:
            """Stage + enqueue; a staging error fails the batch's OWN
            images (a flushed batch holds earlier images than the one whose
            add() flushed it)."""
            for b in batches:
                try:
                    batch_q.put(self._stage_batch(b, timers))
                except Exception as e:
                    logger.warning("staging batch failed: %s", e)
                    _fail(results, b.images, f"staging failed: {e}")

        try:
            with ThreadPoolExecutor(self.prepare_threads) as pool:
                # Bounded submission window: a finished prepare future holds
                # a whole coefficient array, so the pool may run only this
                # far ahead of the device consumer.
                window = max(2 * self.prepare_threads, 4)
                item_iter = iter(enumerate(items))
                inflight = collections.deque()

                def submit_next() -> None:
                    for i, (name, data) in item_iter:
                        inflight.append((i, name, pool.submit(
                            self._prepare, name, data, i, timers)))
                        return

                for _ in range(window):
                    submit_next()
                while inflight:
                    uid, name, fut = inflight.popleft()
                    submit_next()
                    try:
                        prepared = fut.result()
                    except Exception as e:
                        logger.warning("skipping %s: %s", name, e)
                        results[uid] = FileResult(name, False, error=str(e))
                        continue
                    num_mcus = prepared.header.num_mcus
                    if num_mcus > self.max_launch_mcus:
                        stage_safe(self._split_bands(prepared))
                    elif num_mcus > self.budget_mcus:
                        big = ModeRouter(self._dedicated_budget(num_mcus),
                                         max_images=1, align=self.lane_tile)
                        big.add(prepared)
                        stage_safe(big.flush_all())
                    else:
                        stage_safe(router.add(prepared))
            stage_safe(router.flush_all())
        finally:
            batch_q.put(None)
            consumer_thread.join()

        ordered = [results.get(i, FileResult(name, False, error="missing"))
                   for i, (name, _) in enumerate(items)]
        return EngineReport(ordered, timers, launch_stats, dispatch_times,
                            self.device)

    def decode_paths(self, paths: Sequence[str], write: bool = True,
                     sort: bool = True) -> EngineReport:
        """Decode files, writing a BMP next to each input by default.
        Unreadable files are recorded as failures and skipped."""
        items = []
        io_failures = []
        for p in paths:
            try:
                with open(p, "rb") as f:
                    items.append((p, f.read()))
            except OSError as e:
                logger.warning("cannot read %s: %s", p, e)
                io_failures.append(FileResult(p, False, error=str(e)))
        if sort:
            # Ascending file size (blob length == file size), then name.
            items.sort(key=lambda kv: (len(kv[1]), kv[0]))
        report = self.decode_named_blobs(items, write=write)
        report.results.extend(io_failures)
        return report
