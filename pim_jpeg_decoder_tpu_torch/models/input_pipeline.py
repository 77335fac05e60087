"""Device-resident batch decode on PyTorch: JPEG bytes -> training batch.

Counterpart of ``pim_jpeg_decoder_tpu/models/input_pipeline.py`` on one
device, with the same functions, arguments (a ``device`` in place of
``mesh``, a torch floating ``dtype`` in place of a jnp one, and no
``lane_tile``: the CUDA kernels take any MCU count, so the transport is
not padded), validation messages and results.  The decoded pixels never
leave the card: the host ships coefficients (5-10x fewer bytes than RGB)
and gets back nothing.

  worker threads (host code only)   marker scan, C++ entropy decode into
                                    the transport buffer, int8 wire
                                    compaction, staging into page-locked
                                    host memory
  consuming thread                  H2D on a side stream with an event the
                                    launch stream waits on; the decode
                                    kernel (``rgb`` / ``rgb_scaled``); the
                                    raster epilogue (layout + crop +
                                    normalisation in one pass) ->
                                    ``[B, H, W, 3]`` on the device

The JAX module imports ``jax`` at the top, so its host halves are
rewritten here rather than imported.  Multi-GPU decode is ROADMAP.md
Queue 1, item 11: a request for more than one device raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pim_jpeg_decoder_tpu_torch.codec.header import JpegError, JpegHeader
from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.models.pipeline import (build_qpool,
                                                        entropy_decode,
                                                        resolve_device)
from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (decode_mcus,
                                                          raster_epilogue)
from pim_jpeg_decoder_tpu_torch.runtime.batching import compact_wire

_FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _norm_static(dtype, mean, std):
    """Validate and canonicalize the fused-normalization options into
    ``(dtype, mean3, inv_std3)`` (None = raw uint8).

    ``mean``/``std`` are per-channel (scalar or length-3) training-set
    statistics in 0..255 pixel units; they require a floating ``dtype``.
    ``inv_std3`` holds the Python doubles ``1.0 / std`` of the float32
    stds, rounded to float32 where they are used, as in the JAX package,
    so both packages compute the same values.
    """
    if dtype is None:
        if mean is not None or std is not None:
            raise ValueError("mean/std require dtype (a floating type)")
        return None
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"dtype must be floating, got {dtype}")
    if dtype not in _FLOAT_DTYPES:
        raise ValueError(f"dtype must be float32, bfloat16 or float16, got "
                         f"{dtype}")

    def chan3(v, name):
        if v is None:
            return None
        arr = np.asarray(v, np.float32).reshape(-1)
        if arr.size == 1:
            arr = np.repeat(arr, 3)
        if arr.size != 3:
            raise ValueError(f"{name} must be scalar or length-3, got "
                             f"{np.asarray(v).shape}")
        return tuple(float(x) for x in arr)

    mean3 = chan3(mean, "mean")
    std3 = chan3(std, "std")
    if std3 is not None:
        if any(s == 0.0 for s in std3):
            raise ValueError("std must be nonzero")
        std3 = tuple(1.0 / s for s in std3)
    return (dtype, mean3, std3)


def _check_scale(scale: int) -> None:
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"scale must be 1, 2, 4 or 8, got {scale}")


def _check_wire(wire: str) -> None:
    if wire not in ("auto", "i16"):
        raise ValueError(f"wire must be auto/i16, got {wire!r}")


def _one_device(device) -> torch.device:
    """The one device a batch decodes on; a list of devices is a multi-GPU
    request, which is not ported yet."""
    if isinstance(device, (list, tuple)):
        raise NotImplementedError(
            f"multi-GPU batch decode over {list(device)} is not ported yet "
            f"(ROADMAP.md Queue 1, item 11); pass one device")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _scan_same_size(blobs: Sequence[bytes], caller: str):
    """Parse headers and enforce the identical-(size, mode) contract."""
    headers = [scan_jpeg(b) for b in blobs]
    h0 = headers[0]
    for h in headers[1:]:
        if (h.width, h.height, h.mode_key) != (h0.width, h0.height,
                                               h0.mode_key):
            raise JpegError(
                f"{caller} requires identical dimensions and sampling: "
                f"{(h.width, h.height, h.mode_key)} != "
                f"{(h0.width, h0.height, h0.mode_key)}")
    return headers, h0, S.mode_for(h0.mode_key)


def _scan_same_mode(blobs: Sequence[bytes], caller: str):
    """Parse headers and enforce an identical sampling MODE (dimensions
    free: the mixed-size crop path's contract)."""
    headers = [scan_jpeg(b) for b in blobs]
    h0 = headers[0]
    for h in headers[1:]:
        if h.mode_key != h0.mode_key:
            raise JpegError(
                f"{caller} requires identical sampling modes: "
                f"{h.mode_key} != {h0.mode_key}")
    return headers, h0, S.mode_for(h0.mode_key)


_PREP_POOLS: Dict[int, ThreadPoolExecutor] = {}
_LOCK = threading.Lock()


def _prep_pool(workers: int) -> ThreadPoolExecutor:
    """Persistent entropy-decode executors, keyed by worker count (the
    streaming APIs use one per yielded batch)."""
    with _LOCK:
        pool = _PREP_POOLS.get(workers)
        if pool is None:
            pool = _PREP_POOLS[workers] = ThreadPoolExecutor(
                workers, thread_name_prefix="pjt-prep")
        return pool


def _entropy_decode_pool(headers, prepare_threads: int, outs=None):
    """Entropy decode in parallel (the C++ decoder releases the GIL).
    ``outs`` are optional caller-zeroed destinations (transport-buffer
    slices).  A batch with fewer images than workers gives each image the
    spare cores for restart-segment fan-out, as the JAX package does."""
    if outs is None:
        outs = [None] * len(headers)
    n = len(headers)
    if prepare_threads <= 1:
        return [entropy_decode(h, o) for h, o in zip(headers, outs)]
    seg_threads = max(1, min(prepare_threads, os.cpu_count() or 1) // n)
    if n == 1:
        return [entropy_decode(headers[0], outs[0], threads=seg_threads)]
    return list(_prep_pool(prepare_threads).map(
        lambda h, o: entropy_decode(h, o, threads=seg_threads),
        headers, outs))


def _tstage(timers, name: str):
    """``timers.stage(name)`` or a no-op when no timers were passed."""
    if timers is None:
        return contextlib.nullcontext()
    return timers.stage(name)


@dataclasses.dataclass
class _Staged:
    """Host half of one batch: transport tensors (page-locked when bound
    for a card) and the geometry the raster epilogue needs."""
    headers: List[JpegHeader]
    mode: S.ModeSpec
    arrays: List[torch.Tensor]  # coeffs [M, g, 64], qidx, qpool[, oys, oxs]
    gh: int                     # MCU grid per image in the transport
    gw: int
    out_h: int                  # output pixels per image
    out_w: int


def _transport(arrays, wire: str, pin: bool) -> List[torch.Tensor]:
    """``(coeffs, qidx, qpool[, oys, oxs])`` NumPy arrays -> host tensors:
    int8 wire when ``wire="auto"`` and the batch fits, int32 quantizers,
    page-locked when ``pin`` (the H2D copy can then run asynchronously)."""
    coeffs, qidx, qpool, *offsets = arrays
    if wire == "auto":
        coeffs = compact_wire(coeffs)
    out = [torch.from_numpy(a) for a in (coeffs, qidx,
                                         qpool.astype(np.int32), *offsets)]
    return [t.pin_memory() for t in out] if pin else out


def _host_stage(blobs: Sequence[bytes], prepare_threads: int, wire: str,
                caller: str, scale: int, pin: bool, timers=None) -> _Staged:
    """Host half of a same-size batch decode: scan + entropy decode +
    transport staging + wire compaction.  ``timers`` (optional
    StageTimers) accumulates scan / entropy / stage seconds."""
    with _tstage(timers, "scan"):
        headers, h0, mode = _scan_same_size(blobs, caller)
    batch = len(blobs)
    per_img = h0.num_mcus
    with _tstage(timers, "stage"):
        coeffs = np.zeros((batch * per_img, mode.g, 64), np.int16)
        qidx = np.zeros(batch * per_img, np.int32)
    # Decode straight into the transport buffer's per-image slices.
    with _tstage(timers, "entropy"):
        _entropy_decode_pool(
            headers, prepare_threads,
            outs=[coeffs[i * per_img:(i + 1) * per_img]
                  for i in range(batch)])
    with _tstage(timers, "stage"):
        for i in range(batch):
            qidx[i * per_img:(i + 1) * per_img] = i
        arrays = _transport((coeffs, qidx, build_qpool(headers, mode)),
                            wire, pin)
    return _Staged(headers, mode, arrays, h0.mcu_rows, h0.mcu_cols,
                   -(-h0.height // scale), -(-h0.width // scale))


def _host_stage_crops(blobs, boxes, crop_hw, scale: int,
                      prepare_threads: int, wire: str, caller: str,
                      same_size: bool, pin: bool) -> _Staged:
    """Host half of a crop-batch decode (validation + scan + entropy +
    per-crop sub-grid staging + wire compaction).

    Each crop's covering MCU sub-grid has a fixed size (+1 MCU of slack
    for any sub-MCU alignment, the origin clamped to keep it inside the
    LARGEST image), so ``same_size=False`` admits mixed image dimensions:
    images with a smaller grid zero-pad the tail, which the validated crop
    box never reaches."""
    _check_wire(wire)
    _check_scale(scale)
    if not blobs:
        raise ValueError("empty batch")
    if len(boxes) != len(blobs):
        raise ValueError(f"{len(boxes)} boxes for {len(blobs)} images")
    crop_h, crop_w = crop_hw
    if crop_h <= 0 or crop_w <= 0:
        raise ValueError(f"invalid crop size {crop_hw}")
    if scale != 1:
        bad = [(y0, x0) for y0, x0 in boxes
               if y0 % scale or x0 % scale]
        if bad or crop_h % scale or crop_w % scale:
            raise ValueError(
                f"crop origins and dims must be multiples of scale="
                f"{scale} (got dims {crop_hw}, offending origins "
                f"{bad[:3]})")
    if same_size:
        headers, h0, mode = _scan_same_size(blobs, caller)
    else:
        headers, h0, mode = _scan_same_mode(blobs, caller)
    for h, (y0, x0) in zip(headers, boxes):
        if not (0 <= y0 and 0 <= x0 and y0 + crop_h <= h.height
                and x0 + crop_w <= h.width):
            raise ValueError(
                f"crop [{y0}:{y0 + crop_h}, {x0}:{x0 + crop_w}] outside "
                f"{h.height}x{h.width}")

    px_h, px_w = mode.mcu_px_h, mode.mcu_px_w
    gh_c = min(max(h.mcu_rows for h in headers), -(-crop_h // px_h) + 1)
    gw_c = min(max(h.mcu_cols for h in headers), -(-crop_w // px_w) + 1)
    batch = len(blobs)
    per_img = gh_c * gw_c
    coeffs = np.zeros((batch * per_img, mode.g, 64), np.int16)
    qidx = np.zeros(batch * per_img, np.int32)
    oys = np.zeros(batch, np.int32)
    oxs = np.zeros(batch, np.int32)

    decoded = _entropy_decode_pool(headers, prepare_threads)
    for i, ((y0, x0), h, c) in enumerate(zip(boxes, headers, decoded)):
        gh, gw = h.mcu_rows, h.mcu_cols
        r0 = max(0, min(y0 // px_h, gh - gh_c))
        c0 = max(0, min(x0 // px_w, gw - gw_c))
        # Output-pixel offsets into the sub-grid (exact: px_h, px_w, y0
        # and x0 are multiples of scale).
        oys[i] = (y0 - r0 * px_h) // scale
        oxs[i] = (x0 - c0 * px_w) // scale
        sub = c[: gh * gw].reshape(gh, gw, mode.g, 64)[r0:r0 + gh_c,
                                                       c0:c0 + gw_c]
        dst = coeffs[i * per_img:(i + 1) * per_img].reshape(
            gh_c, gw_c, mode.g, 64)
        dst[: sub.shape[0], : sub.shape[1]] = sub
        qidx[i * per_img:(i + 1) * per_img] = i
    arrays = _transport((coeffs, qidx, build_qpool(headers, mode), oys, oxs),
                        wire, pin)
    return _Staged(headers, mode, arrays, gh_c, gw_c, crop_h // scale,
                   crop_w // scale)


_H2D_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _to_device(tensors, device: torch.device) -> List[torch.Tensor]:
    """Copy page-locked host tensors on a side stream; the current stream
    waits on its event, and owns the copies from then on."""
    if device.type == "cpu":
        return list(tensors)
    with _LOCK:
        side = _H2D_STREAMS.get(device.index)
        if side is None:
            side = _H2D_STREAMS[device.index] = torch.cuda.Stream(device)
    with torch.cuda.stream(side):
        out = [t.to(device, non_blocking=True) for t in tensors]
        ready = side.record_event()
    launch = torch.cuda.current_stream(device)
    launch.wait_event(ready)
    for t in out:
        # Allocated on the side stream, used on this one: keep the caching
        # allocator from reusing them too early.
        t.record_stream(launch)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _dispatch(staged: _Staged, scale: int, norm, device: torch.device,
              timers=None):
    """Device half: H2D + decode kernel + raster epilogue (asynchronous).
    With ``timers``, the h2d and device stages synchronise at their
    boundaries so the split is attributable (a profiling run)."""
    with _tstage(timers, "h2d"):
        coeffs, qidx, qpool, *offsets = _to_device(staged.arrays, device)
        if timers is not None:
            _sync(device)
    with _tstage(timers, "device"):
        raw = decode_mcus(coeffs, qidx, qpool, staged.mode, raw=True,
                          scale=scale)
        out = raster_epilogue(raw, staged.mode, scale, len(staged.headers),
                              staged.gh, staged.gw, staged.out_h,
                              staged.out_w, *offsets, norm=norm)
        if timers is not None:
            _sync(device)
    return out, staged.headers


def decode_same_size_batch(
    blobs: Sequence[bytes],
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    dtype=None,
    mean=None,
    std=None,
    device="cuda",
    timers=None,
) -> Tuple[torch.Tensor, List[JpegHeader]]:
    """Decode same-sized JPEGs into one ``[B, H, W, 3]`` tensor on
    ``device``.

    All images must share dimensions and sampling mode.  Returns the
    tensor (uint8 by default) and the parsed headers.  ``scale`` in
    {1, 2, 4, 8} decodes at reduced resolution (H and W become
    ceil(dim/scale)) through the reduced-IDCT kernel.  ``wire="auto"``
    ships coefficients as int8 when the whole batch fits; "i16" disables
    that.  ``dtype`` (``torch.float32``, ``torch.bfloat16`` or
    ``torch.float16``) with optional per-channel ``mean``/``std`` (0..255
    pixel units) gives ``(pixels - mean) / std`` computed in float32 and
    cast last, in the same pass as the raster layout.  ``timers``
    (optional ``utils.profiling.StageTimers``) accumulates scan / entropy /
    stage / h2d / device seconds, synchronising at the device stages;
    leave it None on the throughput path.  For back-to-back batches use
    :func:`iter_decode_batches`.
    """
    _check_scale(scale)
    _check_wire(wire)
    norm = _norm_static(dtype, mean, std)
    if not blobs:
        raise ValueError("empty batch")
    dev = _one_device(device)
    staged = _host_stage(blobs, prepare_threads, wire,
                         "decode_same_size_batch", scale, dev.type == "cuda",
                         timers)
    return _dispatch(staged, scale, norm, dev, timers)


def _prefetched(stage_thunks, prefetch: int):
    """Run host-stage thunks on up to ``prefetch`` worker threads, yielding
    their results in input order.  The thunk iterator advances on the
    consuming thread (its validation errors reach the caller), and the
    pool drains fully on early generator close."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    it = iter(stage_thunks)
    with ThreadPoolExecutor(prefetch,
                            thread_name_prefix="pjt-prefetch") as pool:
        pending = deque()

        def submit_next() -> bool:
            try:
                thunk = next(it)
            except StopIteration:
                return False
            pending.append(pool.submit(thunk))
            return True

        for _ in range(prefetch):
            if not submit_next():
                break
        while pending:
            staged = pending.popleft().result()
            submit_next()
            yield staged


def iter_decode_batches(
    blob_batches,
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    prefetch: int = 2,
    dtype=None,
    mean=None,
    std=None,
    device="cuda",
    timers=None,
):
    """Streaming same-size batch decode with host/device overlap.

    Yields ``(batch_tensor, headers)`` per input batch, exactly what
    :func:`decode_same_size_batch` returns for it, while the host half of
    up to ``prefetch`` upcoming batches runs on worker threads.  Device
    work is asynchronous, so decode of batch N overlaps entropy decode of
    the next ones.  Worker threads run host code only; every CUDA call is
    made on the consuming thread.
    """
    _check_scale(scale)
    _check_wire(wire)
    norm = _norm_static(dtype, mean, std)
    dev = _one_device(device)

    def stage_thunks():
        for batch in blob_batches:
            blobs = list(batch)
            if not blobs:
                raise ValueError("empty batch")
            yield functools.partial(
                _host_stage, blobs, prepare_threads, wire,
                "iter_decode_batches", scale, dev.type == "cuda", timers)

    for staged in _prefetched(stage_thunks(), prefetch):
        yield _dispatch(staged, scale, norm, dev, timers)


def decode_same_size_batch_crops(
    blobs: Sequence[bytes],
    boxes: Sequence[Tuple[int, int]],
    crop_hw: Tuple[int, int],
    prepare_threads: int = 4,
    wire: str = "auto",
    scale: int = 1,
    dtype=None,
    mean=None,
    std=None,
    device="cuda",
) -> Tuple[torch.Tensor, List[JpegHeader]]:
    """Decode one ``crop_h x crop_w`` crop per image -> ``[B, ch/scale,
    cw/scale, 3]`` on ``device``.

    ``boxes[i] = (y0, x0)`` is image i's crop origin (pixels).  The device
    decodes only each crop's covering MCU sub-grid, and the raster
    epilogue applies the per-image pixel offset; the pixels equal the same
    slice of a full (scaled) decode.  With ``scale`` != 1, crop origins
    and dims must be multiples of it.  All images must share dimensions
    and sampling mode; ``dtype``/``mean``/``std`` as in
    :func:`decode_same_size_batch`.
    """
    norm = _norm_static(dtype, mean, std)
    dev = _one_device(device)
    staged = _host_stage_crops(blobs, boxes, crop_hw, scale,
                               prepare_threads, wire,
                               "decode_same_size_batch_crops", True,
                               dev.type == "cuda")
    return _dispatch(staged, scale, norm, dev)


def decode_batch_crops(
    blobs: Sequence[bytes],
    boxes: Sequence[Tuple[int, int]],
    crop_hw: Tuple[int, int],
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    dtype=None,
    mean=None,
    std=None,
    device="cuda",
) -> Tuple[torch.Tensor, List[JpegHeader]]:
    """Batched random-crop decode over MIXED-SIZE images (the sampling
    mode must match): a fixed ``crop_hw`` means a fixed covering MCU
    sub-grid, so the whole batch decodes in one launch.  Same
    ``scale``/``dtype``/``mean``/``std`` semantics as
    :func:`decode_same_size_batch_crops`.
    """
    norm = _norm_static(dtype, mean, std)
    dev = _one_device(device)
    staged = _host_stage_crops(blobs, boxes, crop_hw, scale,
                               prepare_threads, wire, "decode_batch_crops",
                               False, dev.type == "cuda")
    return _dispatch(staged, scale, norm, dev)


def iter_decode_batch_crops(
    crop_batches,
    crop_hw: Tuple[int, int],
    scale: int = 1,
    prepare_threads: int = 4,
    wire: str = "auto",
    prefetch: int = 2,
    dtype=None,
    mean=None,
    std=None,
    device="cuda",
    mixed_sizes: bool = False,
):
    """Streaming random-crop decode with host/device overlap.

    ``crop_batches`` yields ``(blobs, boxes)`` pairs; each yields exactly
    what :func:`decode_same_size_batch_crops` (or, with
    ``mixed_sizes=True``, :func:`decode_batch_crops`) returns for it,
    while the host half of up to ``prefetch`` upcoming batches runs on
    worker threads.
    """
    norm = _norm_static(dtype, mean, std)
    dev = _one_device(device)

    def stage_thunks():
        for blobs, boxes in crop_batches:
            yield functools.partial(
                _host_stage_crops, list(blobs), list(boxes), crop_hw, scale,
                prepare_threads, wire, "iter_decode_batch_crops",
                not mixed_sizes, dev.type == "cuda")

    for staged in _prefetched(stage_thunks(), prefetch):
        yield _dispatch(staged, scale, norm, dev)
