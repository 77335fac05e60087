"""Device lists: the port's counterpart of a 1-D mesh.

Counterpart of ``pim_jpeg_decoder_tpu/parallel/mesh.py``.  PyTorch has no
mesh object: the decode's one device axis (MCU tiles, independent of each
other) is a tuple of ``torch.device``, and shard ``k`` of the MCU axis
lives on ``devices[k]``.  The default is every local card, as the JAX
package's is every local chip.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

# The MCU axis of the kernel-native layouts (RGB ``[3, luma_slots, nn, M]``
# and YCbCr ``[g, 64, M]``): the axis shards split and gather joins.
MCU_AXIS = -1


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist, and one
    named without an index is the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           f"torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(num_devices: Optional[int] = None,
              devices: Optional[Sequence] = None
              ) -> Tuple[torch.device, ...]:
    """The first ``num_devices`` of ``devices`` (default: every local
    card, ``cuda:0`` ... ``cuda:{torch.cuda.device_count() - 1}``).

    ``devices`` may repeat a device (two shards on one card) and may name
    CPU devices (the kernels' plain versions).  Local devices only: in a
    multi-process run each process shards MCUs over its own cards, and
    whole images are split between processes (``parallel/multihost.py``).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: torch.cuda.is_available() is "
                               "False (pass devices=['cpu', ...] for the "
                               "plain versions)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"num_devices must be >= 1, got {num_devices}")
        if num_devices > len(devices):
            raise ValueError(
                f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    if not devices:
        raise ValueError("empty device list")
    return tuple(devices)


def devices_of(device, num_devices: Optional[int] = None
               ) -> Tuple[torch.device, ...]:
    """The devices a decode API's ``device`` argument names: a list or
    tuple is a device list (:func:`make_mesh`), anything else one device.
    ``num_devices`` keeps the first n of them; more than there are
    raises."""
    if isinstance(device, (list, tuple)):
        return make_mesh(num_devices, devices=device)
    return make_mesh(num_devices, devices=[device])
