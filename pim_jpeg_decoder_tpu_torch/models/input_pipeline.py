"""Device-resident batch decode on PyTorch: JPEG bytes -> training batch.

Counterpart of ``pim_jpeg_decoder_tpu/models/input_pipeline.py``, with the
same functions, arguments (a ``device`` in place of ``mesh``, a torch
floating ``dtype`` in place of a jnp one, and no ``lane_tile``: the CUDA
kernels take any MCU count), validation messages and results.  Each
launch's transport ends in ``ROW_ALIGN - 1`` zero MCUs, and each
device decodes its images' MCUs padded to a multiple of ``ROW_ALIGN``
(``decode_kernel.padded_mcus``: the next images' first MCUs, or those
zeros; no epilogue reads them), so that the decode kernel's output rows
lie on the 16-byte grid and it takes its 16-byte stores (rows off the
grid cost it about 1.5x, PERF.md).  The decoded pixels never
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

A crop batch whose images mix sampling modes (``decode_batch_crops``,
``iter_decode_batch_crops(mixed_sizes=True)``; the JAX package refuses
such a batch) is staged as one launch a mode, in the order the modes first
appear: each has its own covering MCU sub-grid and transport, its own
decode kernel and its own raster epilogue, which writes its images into
their rows of the one output tensor (no copy pass).  A batch of one mode
is one launch, as in the JAX package.

``device`` may be a list of devices (the JAX package's ``mesh=``): the
batch splits into one contiguous group of whole images per device (sizes
differ by at most one; a device left without an image is skipped), each
device runs the H2D copy, the decode kernels and the raster epilogues on
its group, and the groups come to ``devices[0]``, where one ``torch.cat``
makes the result.  It equals the one-device result element for element.
The JAX package returns one array sharded over the batch axis; PyTorch
has no tensor sharded over devices, so the result lies whole on
``devices[0]``.

The JAX module imports ``jax`` at the top, so its host halves are
rewritten here rather than imported.
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
                                                        entropy_decode)
from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (ROW_ALIGN,
                                                          decode_mcus,
                                                          padded_mcus,
                                                          raster_epilogue)
from pim_jpeg_decoder_tpu_torch.parallel.mesh import devices_of
from pim_jpeg_decoder_tpu_torch.parallel.sharding import (adopt, copy_to,
                                                          gather, h2d_stream)
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


def _on_card(devices) -> bool:
    """Whether any device is a card (the host stage then page-locks)."""
    return any(d.type == "cuda" for d in devices)


def _groups(batch: int, n: int) -> List[Tuple[int, int]]:
    """Image ranges ``[b0, b1)`` of ``n`` contiguous groups of a batch,
    sizes differing by at most one; empty groups are left out."""
    base, extra = divmod(batch, n)
    bounds, b0 = [], 0
    for k in range(n):
        b1 = b0 + base + (k < extra)
        if b1 > b0:
            bounds.append((b0, b1))
        b0 = b1
    return bounds


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


def _mode_groups(headers: Sequence[JpegHeader]) -> List[np.ndarray]:
    """Input positions of a batch's images by sampling mode: each group in
    input order, the groups in the order their modes first appear."""
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, h in enumerate(headers):
        groups.setdefault(h.mode_key, []).append(i)
    return [np.asarray(g, np.int64) for g in groups.values()]


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


def _tstage(timers, name: str, **how):
    """``timers.stage(name, **how)`` or a no-op when no timers were
    passed."""
    if timers is None:
        return contextlib.nullcontext()
    return timers.stage(name, **how)


def _tcount(timers, name: str, n: int) -> None:
    """``timers.count(name, n)``, or nothing when no timers were passed."""
    if timers is not None:
        timers.count(name, n)


@dataclasses.dataclass
class _Launch:
    """One decode launch of a batch: images of one sampling mode, their
    transport tensors (page-locked when bound for a card) and the MCU
    sub-grid each has in the transport."""
    mode: S.ModeSpec
    # coeffs [M, g, 64], qidx, qpool[, oys, oxs[, positions]]: M is its
    # images' MCUs and ROW_ALIGN - 1 zero MCUs (qidx 0) after them; int32
    # positions of its images in the batch, where the batch has more than
    # one launch (each device's output rows count from its first image).
    arrays: List[torch.Tensor]
    gh: int
    gw: int
    # Input positions of its images, ascending; None: the whole batch.
    index: Optional[np.ndarray] = None


@dataclasses.dataclass
class _Staged:
    """Host half of one batch: its launches, one a sampling mode, and the
    output pixels per image."""
    headers: List[JpegHeader]
    launches: List[_Launch]
    out_h: int
    out_w: int


def _reduced_coefs_read(mode: S.ModeSpec, n: int) -> int:
    """Coefficients of one MCU that the n-point reduced IDCT reads
    (specs.py 'Reduced (scaled) IDCT'): the top-left n x n of a luma
    block, and of a chroma block min(8, f_y n) x min(8, f_x n), where f_y,
    f_x are luma's sampling factors over the chroma's (4:2:0 at n = 4: all
    64)."""
    luma = mode.luma_slots * n * n
    if mode.ncomp == 1:
        return luma
    return luma + 2 * min(8, mode.v * n) * min(8, mode.h * n)


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
    StageTimers) accumulates scan / entropy / stage seconds, and the
    thread CPU seconds of scan and stage (the rest of their wall clock is
    spent off a CPU: waiting for the GIL, or descheduled).  At ``scale``
    2, 4 or 8 it also counts the coefficients of the images' MCUs placed on
    the wire (``scale.coefs_shipped``; all 64 of every block) and those
    the reduced IDCT reads of them (``scale.coefs_read``,
    :func:`_reduced_coefs_read`)."""
    with _tstage(timers, "scan", cpu=True):
        headers, h0, mode = _scan_same_size(blobs, caller)
    batch = len(blobs)
    per_img = h0.num_mcus
    with _tstage(timers, "stage", cpu=True):
        coeffs = np.zeros((batch * per_img + ROW_ALIGN - 1, mode.g, 64),
                          np.int16)
        qidx = np.zeros(len(coeffs), np.int32)
    # Decode straight into the transport buffer's per-image slices.
    with _tstage(timers, "entropy"):
        _entropy_decode_pool(
            headers, prepare_threads,
            outs=[coeffs[i * per_img:(i + 1) * per_img]
                  for i in range(batch)])
    with _tstage(timers, "stage", cpu=True):
        for i in range(batch):
            qidx[i * per_img:(i + 1) * per_img] = i
        arrays = _transport((coeffs, qidx, build_qpool(headers, mode)),
                            wire, pin)
    if scale != 1 and timers is not None:
        mcus = batch * per_img
        timers.count("scale.coefs_shipped", mcus * mode.g * 64)
        timers.count("scale.coefs_read",
                     mcus * _reduced_coefs_read(mode, 8 // scale))
    return _Staged(headers, [_Launch(mode, arrays, h0.mcu_rows, h0.mcu_cols)],
                   -(-h0.height // scale), -(-h0.width // scale))


def _host_stage_crops(blobs, boxes, crop_hw, scale: int,
                      prepare_threads: int, wire: str, caller: str,
                      same_size: bool, pin: bool, timers=None) -> _Staged:
    """Host half of a crop-batch decode (validation + scan + entropy +
    per-crop sub-grid staging + wire compaction), one launch a sampling
    mode.  ``timers`` as in :func:`_host_stage`, with the sub-grid copy as
    stage ``crop_gather`` and the counters ``crop.mcus_decoded`` (MCUs
    entropy-decoded), ``crop.mcus_shipped`` (MCUs in the transport) and
    ``crop.mode_groups`` (launches).

    Each crop's covering MCU sub-grid has a fixed size within a launch (+1
    MCU of slack for any sub-MCU alignment, the origin clamped to keep it
    inside the launch's LARGEST image), so ``same_size=False`` admits mixed
    image dimensions: images with a smaller grid zero-pad the tail, which
    the validated crop box never reaches."""
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
    with _tstage(timers, "scan", cpu=True):
        if same_size:
            headers = _scan_same_size(blobs, caller)[0]
        else:
            headers = [scan_jpeg(b) for b in blobs]
        groups = [(S.mode_for(headers[idx[0]].mode_key), idx)
                  for idx in _mode_groups(headers)]
    for h, (y0, x0) in zip(headers, boxes):
        if not (0 <= y0 and 0 <= x0 and y0 + crop_h <= h.height
                and x0 + crop_w <= h.width):
            raise ValueError(
                f"crop [{y0}:{y0 + crop_h}, {x0}:{x0 + crop_w}] outside "
                f"{h.height}x{h.width}")

    with _tstage(timers, "entropy"):
        decoded = _entropy_decode_pool(headers, prepare_threads)
    # Per launch: (mode, positions, sub-grid rows and columns, transport).
    plans = []
    with _tstage(timers, "stage", cpu=True):
        for mode, idx in groups:
            gh_c = min(max(headers[i].mcu_rows for i in idx),
                       -(-crop_h // mode.mcu_px_h) + 1)
            gw_c = min(max(headers[i].mcu_cols for i in idx),
                       -(-crop_w // mode.mcu_px_w) + 1)
            n = len(idx)
            plans.append((mode, idx, gh_c, gw_c,
                          np.zeros((n * gh_c * gw_c + ROW_ALIGN - 1,
                                    mode.g, 64), np.int16),
                          np.zeros(n, np.int32), np.zeros(n, np.int32)))
    with _tstage(timers, "crop_gather"):
        for mode, idx, gh_c, gw_c, coeffs, oys, oxs in plans:
            px_h, px_w = mode.mcu_px_h, mode.mcu_px_w
            per_img = gh_c * gw_c
            for k, i in enumerate(idx):
                (y0, x0), h = boxes[i], headers[i]
                gh, gw = h.mcu_rows, h.mcu_cols
                r0 = max(0, min(y0 // px_h, gh - gh_c))
                c0 = max(0, min(x0 // px_w, gw - gw_c))
                # Output-pixel offsets into the sub-grid (exact: px_h,
                # px_w, y0 and x0 are multiples of scale).
                oys[k] = (y0 - r0 * px_h) // scale
                oxs[k] = (x0 - c0 * px_w) // scale
                sub = decoded[i][: gh * gw].reshape(
                    gh, gw, mode.g, 64)[r0:r0 + gh_c, c0:c0 + gw_c]
                dst = coeffs[k * per_img:(k + 1) * per_img].reshape(
                    gh_c, gw_c, mode.g, 64)
                dst[: sub.shape[0], : sub.shape[1]] = sub
    launches = []
    with _tstage(timers, "stage", cpu=True):
        for mode, idx, gh_c, gw_c, coeffs, oys, oxs in plans:
            qidx = np.zeros(len(coeffs), np.int32)
            qidx[:len(idx) * gh_c * gw_c] = np.repeat(
                np.arange(len(idx), dtype=np.int32), gh_c * gw_c)
            rows = [] if len(plans) == 1 else [idx.astype(np.int32)]
            arrays = _transport(
                (coeffs, qidx, build_qpool([headers[i] for i in idx], mode),
                 oys, oxs, *rows), wire, pin)
            launches.append(_Launch(mode, arrays, gh_c, gw_c,
                                    idx if rows else None))
    _tcount(timers, "crop.mcus_decoded", sum(h.num_mcus for h in headers))
    _tcount(timers, "crop.mcus_shipped",
            sum(len(idx) * gh_c * gw_c for _, idx, gh_c, gw_c, *_ in plans))
    _tcount(timers, "crop.mode_groups", len(launches))
    return _Staged(headers, launches, crop_h // scale, crop_w // scale)


def _dispatch(staged: _Staged, scale: int, norm, devices, timers=None):
    """Device half (asynchronous): for each device's group of whole
    images, H2D on the device's side stream (its current stream waits on
    the copy's event) + per launch a decode kernel and a raster epilogue;
    then the groups on ``devices[0]``, joined.  Every group gets each
    launch's whole (small) quantizer pool, so its ``qidx`` stays the
    launch's.  A batch of several launches has its output made here, one
    a device, and each epilogue writes its images into their rows of it
    (their batch positions less the device's first image).  Nothing
    synchronises.  With ``timers``, a card's h2d stage is timed by CUDA
    events on the side stream around the copies, and its device stage by
    events on the launch stream around the kernels (host wall clock on
    the CPU); the ranges ``pjt.h2d`` and ``pjt.device`` cover this
    thread's enqueueing."""
    batch = len(staged.headers)
    shared = any(ln.index is not None for ln in staged.launches)
    outs = []
    for (b0, b1), dev in zip(_groups(batch, len(devices)), devices):
        # Each launch's images in [b0, b1): one run of it (positions
        # ascend).
        parts = []
        for ln in staged.launches:
            i0, i1 = ((b0, b1) if ln.index is None
                      else np.searchsorted(ln.index, (b0, b1)))
            if i1 > i0:
                parts.append((ln, int(i0), int(i1)))
        side = launch = None
        if timers is not None and dev.type == "cuda":
            side, launch = h2d_stream(dev), torch.cuda.current_stream(dev)
        with _tstage(timers, "h2d", stream=side):
            host = []
            for ln, i0, i1 in parts:
                coeffs, qidx, qpool, *per_image = ln.arrays
                per_img = ln.gh * ln.gw
                # Its images' MCUs padded to the grid, from the next
                # images' or the transport's trailing zeros.
                stop = i0 * per_img + padded_mcus((i1 - i0) * per_img)
                host += [coeffs[i0 * per_img:stop],
                         qidx[i0 * per_img:stop], qpool,
                         *(a[i0:i1] for a in per_image[:2])]
                if shared:   # rows of this device's output
                    host.append(per_image[2][i0:i1] - b0 if b0
                                else per_image[2][i0:i1])
            group, ready = copy_to(host, dev)
            adopt(group, ready, dev)
        with _tstage(timers, "device", stream=launch):
            out = None
            if shared:
                out = torch.empty((b1 - b0, staged.out_h, staged.out_w, 3),
                                  dtype=norm[0] if norm else torch.uint8,
                                  device=dev)
            at = 0
            for ln, i0, i1 in parts:
                c, q, p, *offs = group[at:at + len(ln.arrays)]
                at += len(ln.arrays)
                raw = decode_mcus(c, q, p, ln.mode, raw=True, scale=scale)
                out = raster_epilogue(
                    raw, ln.mode, scale, i1 - i0, ln.gh, ln.gw,
                    staged.out_h, staged.out_w, *offs[:2], norm=norm,
                    rows=offs[2] if shared else None, out=out)
            outs.append(out)
    if len(outs) == 1:
        return outs[0], staged.headers
    return gather(outs, axis=0, device=devices[0]), staged.headers


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
    stage seconds on the host and h2d / device seconds on the card (CUDA
    events, read by ``timers.snapshot()``), and the thread CPU seconds of
    scan and stage; at ``scale`` 2, 4 or 8 also the counters
    ``scale.coefs_shipped`` and ``scale.coefs_read`` (``timers.counters()``:
    the coefficients on the wire, and those the reduced IDCT reads); the
    decode does not synchronise for it.  A list of
    devices splits the batch into groups of whole images, one a device,
    and returns the joined tensor on the first (see the module
    docstring).  For back-to-back batches use
    :func:`iter_decode_batches`.
    """
    _check_scale(scale)
    _check_wire(wire)
    norm = _norm_static(dtype, mean, std)
    if not blobs:
        raise ValueError("empty batch")
    devices = devices_of(device)
    staged = _host_stage(blobs, prepare_threads, wire,
                         "decode_same_size_batch", scale, _on_card(devices),
                         timers)
    return _dispatch(staged, scale, norm, devices, timers)


def _prefetched(stage_thunks, prefetch: int, timers=None):
    """Run host-stage thunks on up to ``prefetch`` worker threads, yielding
    their results in input order.  The thunk iterator advances on the
    consuming thread (its validation errors reach the caller), and the
    pool drains fully on early generator close.  ``timers`` times the
    consuming thread's wait for each result as stage ``queue``."""
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
            with _tstage(timers, "queue"):
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
    made on the consuming thread.  ``timers`` as in
    :func:`decode_same_size_batch`, and the consuming thread's wait for
    each staged batch as stage ``queue``.
    """
    _check_scale(scale)
    _check_wire(wire)
    norm = _norm_static(dtype, mean, std)
    devices = devices_of(device)

    def stage_thunks():
        for batch in blob_batches:
            blobs = list(batch)
            if not blobs:
                raise ValueError("empty batch")
            yield functools.partial(
                _host_stage, blobs, prepare_threads, wire,
                "iter_decode_batches", scale, _on_card(devices), timers)

    for staged in _prefetched(stage_thunks(), prefetch, timers):
        yield _dispatch(staged, scale, norm, devices, timers)


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
    timers=None,
) -> Tuple[torch.Tensor, List[JpegHeader]]:
    """Decode one ``crop_h x crop_w`` crop per image -> ``[B, ch/scale,
    cw/scale, 3]`` on ``device``.

    ``boxes[i] = (y0, x0)`` is image i's crop origin (pixels).  The device
    decodes only each crop's covering MCU sub-grid, and the raster
    epilogue applies the per-image pixel offset; the pixels equal the same
    slice of a full (scaled) decode.  With ``scale`` != 1, crop origins
    and dims must be multiples of it.  All images must share dimensions
    and sampling mode; ``dtype``/``mean``/``std`` as in
    :func:`decode_same_size_batch`, ``timers`` too, with the sub-grid copy
    as stage ``crop_gather`` and the counters ``crop.mcus_decoded``,
    ``crop.mcus_shipped`` and ``crop.mode_groups``
    (``timers.counters()``).
    """
    norm = _norm_static(dtype, mean, std)
    devices = devices_of(device)
    staged = _host_stage_crops(blobs, boxes, crop_hw, scale,
                               prepare_threads, wire,
                               "decode_same_size_batch_crops", True,
                               _on_card(devices), timers)
    return _dispatch(staged, scale, norm, devices, timers)


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
    timers=None,
) -> Tuple[torch.Tensor, List[JpegHeader]]:
    """Batched random-crop decode over images of MIXED SIZES and MIXED
    SAMPLING MODES (every mode the port decodes: 4:2:0, 4:2:2, 4:4:0,
    4:4:4, gray) -> ``[B, ch/scale, cw/scale, 3]`` in input order.

    A fixed ``crop_hw`` means a fixed covering MCU sub-grid for each
    mode, so the images of one mode decode in one launch whatever their
    sizes: a batch of one mode is one decode kernel and one raster
    epilogue.  A batch that mixes modes is grouped by mode (in the order
    the modes first appear), one decode kernel and one epilogue a group,
    each epilogue writing its images into their rows of the one output.
    The JAX package's ``decode_batch_crops`` requires one mode; the port
    goes beyond it here.  Same ``scale``/``dtype``/``mean``/``std``/
    ``timers`` semantics as :func:`decode_same_size_batch_crops`.
    """
    norm = _norm_static(dtype, mean, std)
    devices = devices_of(device)
    staged = _host_stage_crops(blobs, boxes, crop_hw, scale,
                               prepare_threads, wire, "decode_batch_crops",
                               False, _on_card(devices), timers)
    return _dispatch(staged, scale, norm, devices, timers)


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
    timers=None,
):
    """Streaming random-crop decode with host/device overlap.

    ``crop_batches`` yields ``(blobs, boxes)`` pairs; each yields exactly
    what :func:`decode_same_size_batch_crops` (or, with
    ``mixed_sizes=True``, :func:`decode_batch_crops`: sizes and sampling
    modes may then mix inside a batch, beyond what the JAX package
    admits) returns for it, while the host half of up to ``prefetch``
    upcoming batches runs on worker threads.  ``timers`` as in
    :func:`iter_decode_batches` and :func:`decode_same_size_batch_crops`.
    """
    norm = _norm_static(dtype, mean, std)
    devices = devices_of(device)

    def stage_thunks():
        for blobs, boxes in crop_batches:
            yield functools.partial(
                _host_stage_crops, list(blobs), list(boxes), crop_hw, scale,
                prepare_threads, wire, "iter_decode_batch_crops",
                not mixed_sizes, _on_card(devices), timers)

    for staged in _prefetched(stage_thunks(), prefetch, timers):
        yield _dispatch(staged, scale, norm, devices, timers)
