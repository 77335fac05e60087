"""Sharded device decode: contiguous MCU shards over a device list.

Counterpart of ``pim_jpeg_decoder_tpu/parallel/sharding.py``, where
``shard_map`` runs the fused Pallas kernel on each chip's slice of the MCU
axis.  Here shard ``k`` (``M/n`` consecutive MCUs) is copied page-locked
to ``devices[k]`` on that device's H2D side stream, behind an event, and
the same ``decode_mcus`` launches on the device's current stream once the
event has passed.  MCUs are independent, so no collective runs; the
shards' outputs come back to the host (:func:`to_host`, :func:`gather`)
or to ``devices[0]`` (:func:`gather`).  PyTorch has no tensor sharded
over devices: a sharded result is the list of per-shard tensors.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import decode_mcus
from pim_jpeg_decoder_tpu_torch.parallel.mesh import MCU_AXIS, make_mesh

# One H2D side stream per card, keyed by device index, shared by every
# caller in the process (batch APIs, engines, sharded decodes).
_H2D_STREAMS: Dict[int, torch.cuda.Stream] = {}
_LOCK = threading.Lock()


def h2d_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that :func:`copy_to` copies to card ``device`` on."""
    with _LOCK:
        side = _H2D_STREAMS.get(device.index)
        if side is None:
            side = _H2D_STREAMS[device.index] = torch.cuda.Stream(device)
    return side


def copy_to(tensors: Sequence[torch.Tensor], device: torch.device
            ) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
    """Start copying host tensors (page-locked, for an asynchronous copy)
    to ``device`` on its side stream.  Returns the device tensors and the
    event recorded after the copies; on the CPU the tensors themselves
    and no event."""
    if device.type == "cpu":
        return list(tensors), None
    side = h2d_stream(device)
    with torch.cuda.stream(side):
        out = [t.to(device, non_blocking=True) for t in tensors]
        ready = side.record_event()
    return out, ready


def adopt(tensors: Sequence[torch.Tensor], ready, device: torch.device
          ) -> None:
    """Make ``device``'s current stream wait on ``ready`` and own
    ``tensors`` from then on (they were allocated on the side stream: the
    caching allocator must not reuse them before this stream is done)."""
    if ready is None:
        return
    launch = torch.cuda.current_stream(device)
    launch.wait_event(ready)
    for t in tensors:
        t.record_stream(launch)


@dataclasses.dataclass(frozen=True)
class Placed:
    """Decode inputs placed by :func:`place_for_mesh`: shard ``k``'s
    ``(coeffs, qidx, qpool)`` on ``devices[k]``, readable once
    ``ready[k]`` has passed (None on the CPU).  Shards on one device share
    its ``qpool``."""
    devices: Tuple[torch.device, ...]
    shards: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    ready: Tuple[Optional[torch.cuda.Event], ...]

    @property
    def shard_mcus(self) -> int:
        return int(self.shards[0][0].shape[0])


def place_for_mesh(coeffs, qidx, qpool, devices: Sequence[torch.device],
                   align: int = 1) -> Placed:
    """Start placing decode inputs over ``devices``: shard ``k`` of the
    MCU axis (``M/n`` consecutive MCUs of ``coeffs`` ``[M, g, 64]`` and
    ``qidx`` ``[M]``) goes to ``devices[k]``, and the quantizer pool
    ``qpool`` ``[Q, g, 64]`` (as int32) to each distinct device once.

    Producer-side H2D: the engine calls this when it stages a batch, so
    the copies of batch N+1 overlap the launches of batch N, and
    :func:`decode_mcus_sharded` takes the result without placing again.
    An int8 coefficient wire (``runtime.batching.compact_wire``) stays
    int8 on the wire; the kernel reads either.
    """
    devices = tuple(devices)
    n, m = len(devices), coeffs.shape[0]
    if m % (n * align):
        raise ValueError(
            f"M={m} must be a multiple of devices*align={n * align}")
    wire = np.int8 if np.dtype(coeffs.dtype) == np.int8 else np.int16
    host = [torch.from_numpy(np.ascontiguousarray(coeffs, wire)),
            torch.from_numpy(np.ascontiguousarray(qidx, np.int32)),
            torch.from_numpy(np.asarray(qpool).astype(np.int32))]
    if any(d.type == "cuda" for d in devices):
        host = [t.pin_memory() for t in host]
    coeffs_h, qidx_h, pool_h = host
    size = m // n
    pools: Dict[torch.device, torch.Tensor] = {}
    shards, ready = [], []
    for k, dev in enumerate(devices):
        todo = [coeffs_h[k * size:(k + 1) * size],
                qidx_h[k * size:(k + 1) * size]]
        if dev not in pools:
            todo.append(pool_h)
        moved, event = copy_to(todo, dev)
        if dev not in pools:
            # Later shards on this device copy on the same side stream, so
            # their events also cover the pool.
            pools[dev] = moved.pop()
        shards.append((moved[0], moved[1], pools[dev]))
        ready.append(event)
    return Placed(devices, tuple(shards), tuple(ready))


def decode_mcus_sharded(coeffs, qidx, qpool, mode: S.ModeSpec,
                        devices: Optional[Sequence] = None, align: int = 1,
                        raw: bool = False, ycbcr: bool = False,
                        scale: int = 1) -> List[torch.Tensor]:
    """Decode MCU tiles sharded over ``devices`` (default: every local
    card), ``M`` a multiple of ``len(devices) * align``.

    ``coeffs``, ``qidx`` and ``qpool`` are host arrays, placed here by
    :func:`place_for_mesh`; or ``coeffs`` is what :func:`place_for_mesh`
    returned (``qidx`` and ``qpool`` None), which is decoded where it
    lies.  Each shard's ``decode_mcus`` launches on its device's current
    stream after the shard's H2D event.  Returns the per-shard outputs in
    ``decode_mcus``'s layouts (``[3, luma_slots, nn, M/n]`` with
    ``raw=True``, ``[g, 64, M/n]`` with ``ycbcr=True``, else
    ``[M/n, luma_slots, nn, 3]``); :func:`gather` joins them.
    """
    if isinstance(coeffs, Placed):
        placed = coeffs
        if (devices is not None
                and make_mesh(devices=devices) != placed.devices):
            raise ValueError(f"inputs placed on {placed.devices}, not on "
                             f"{tuple(devices)}")
    else:
        devices = make_mesh(devices=devices) if devices is not None else (
            make_mesh())
        placed = place_for_mesh(coeffs, qidx, qpool, devices, align)
    outs = []
    for dev, shard, ready in zip(placed.devices, placed.shards, placed.ready):
        adopt(shard, ready, dev)
        outs.append(decode_mcus(*shard, mode, raw=raw, ycbcr=ycbcr,
                                scale=scale))
    return outs


def to_host(outputs: Sequence[torch.Tensor]
            ) -> Tuple[List[torch.Tensor], List[Optional[torch.cuda.Event]]]:
    """Start the D2H copy of each shard's output into a page-locked buffer
    of its own, on the shard's device's current stream (behind its
    decode).  Returns the host buffers and one event each (None for a CPU
    shard, which is returned as it is); read a buffer after its event."""
    host, done = [], []
    for out in outputs:
        if out.device.type == "cpu":
            host.append(out)
            done.append(None)
            continue
        with torch.cuda.device(out.device):
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            buf.copy_(out, non_blocking=True)
            done.append(torch.cuda.current_stream().record_event())
        host.append(buf)
    return host, done


def gather(outputs: Sequence[torch.Tensor], axis: int = MCU_AXIS,
           device=None) -> torch.Tensor:
    """Join per-shard outputs along ``axis`` (the MCU axis: the last of
    the raw and YCbCr layouts, 0 for the slot-major RGB one) into one
    tensor on the host (``device=None``) or on ``device``.

    The MCU axis is the minor one, so a shard is not one contiguous piece
    of the joined tensor: each comes to the host in a buffer of its own
    (:func:`to_host`) and the host concatenates them.
    """
    if device is not None:
        # A cross-device copy runs on the source's current stream, behind
        # its decode, and the destination's current stream waits for it.
        return torch.cat([o.to(device, non_blocking=True) for o in outputs],
                         dim=axis)
    host, done = to_host(outputs)
    for event in done:
        if event is not None:
            event.synchronize()
    return torch.cat(host, dim=axis)


def mcu_window(shards: Sequence[np.ndarray], off: int, count: int,
               axis: int = MCU_AXIS) -> Tuple[np.ndarray, int]:
    """MCUs ``[off, off + count)`` of shards joined along ``axis``, as
    ``(array, offset)`` for the host finishers' ``mcu_off``: the one shard
    that holds the whole range and the range's offset in it, or, for a
    range that straddles shards, a copy of just that range and 0."""
    start = 0
    for k, shard in enumerate(shards):
        size = shard.shape[axis]
        if off < start + size:
            if off + count <= start + size:
                return shard, off - start
            break
        start += size
    else:
        raise ValueError(f"MCUs [{off}, {off + count}) outside "
                         f"{start} MCUs of shards")
    pieces, at = [], off
    for shard in shards[k:]:
        size = shard.shape[axis]
        lo = at - start
        hi = min(size, off + count - start)
        index = [slice(None)] * shard.ndim
        index[axis] = slice(lo, hi)
        pieces.append(shard[tuple(index)])
        at = start + hi
        start += size
        if at == off + count:
            return np.concatenate(pieces, axis=axis), 0
    raise ValueError(f"MCUs [{off}, {off + count}) outside {start} MCUs of "
                     f"shards")
