"""Stage profiling with the reference's metric taxonomy.

Equivalent of the reference's timing harness
(reference: src/decoder_host.cpp:82-99 accumulators): clock pairs around
every pipeline stage, accumulated globally.  Stage names mirror the
reference so numbers are comparable (BASELINE.md):

  prepare   <- mcu_prepare (scan + entropy decode)       [:202-203]
  queue     <- queue waiting + batch pop                 [:236-238,255-259]
  h2d       <- CPU->DPUs transfer                        [:275-279]
  kernel    <- DPU execution                             [:291-295]
  d2h       <- DPUs->CPU transfer                        [:307-314]
  write     <- BMP write                                 [:325-334]

The reference times its cv.wait and its queue.pop as two stages ("queue
waiting" + "batch pop", reference: src/decoder_host.cpp:236-238,255-259)
because they are two mutex operations there; Python's ``queue.Queue.get``
performs both atomically, so the single "queue" stage here covers both and
no separate "pop" stage exists.

While a ``torch.profiler`` records, every stage also opens the range
``pjt.<stage>`` on the thread that runs it, on the profiler's clock, so
the stages line up with the kernels and copies of the device trace.  A
stage timed on a CUDA stream sums the card's time between two timing
events instead of the host's wall clock, without synchronising.

For device-side PHASE timing (the reference's per-DPU dequant/IDCT/color
cycle counters) see :mod:`pim_jpeg_decoder_tpu_torch.runtime.device_profile`;
this module is the cheap always-on host layer.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict, List, Tuple

STAGES = ("prepare", "queue", "h2d", "kernel", "d2h", "write")


def _span(name: str):
    """``record_function("pjt.<name>")`` while a profiler records, else a
    no-op.  The profiler's flag is process-wide (``torch.autograd.
    _profiler_enabled()`` reads False on threads other than the one that
    started it), and no profiler can run before torch is imported."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return contextlib.nullcontext()
    return prof.record_function("pjt." + name)


def all_threads_config():
    """A ``torch.profiler.profile`` ``experimental_config`` that records
    every thread's ranges, or None where the installed torch has no such
    option (the profiler then records the thread that started it)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class StageTimers:
    """Thread-safe accumulated seconds per pipeline stage, and summed
    whole-number counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._counters: Dict[str, int] = {}
        # (stage, start event, end event) of stages timed on a card whose
        # end had not passed when last looked at.
        self._pending: List[tuple] = []
        self._t0 = time.monotonic()

    @contextlib.contextmanager
    def stage(self, name: str, cpu: bool = False, stream=None):
        """Time the block as stage ``name``: the host's wall clock, or with
        ``stream`` (a ``torch.cuda.Stream``) the card's time between timing
        events recorded on it at entry and exit, read once the exit's event
        has passed (at the latest in :meth:`snapshot`).  ``cpu`` also sums
        the thread's CPU seconds as ``<name>.cpu``: the wall clock less
        them is the time the thread spent off a CPU."""
        with _span(name):
            if stream is not None:
                import torch
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            # The CPU clock's interval lies inside the wall clock's.
            wall0 = time.monotonic()
            cpu0 = time.thread_time() if cpu else 0.0
            try:
                yield
            finally:
                if cpu:
                    self.add(name + ".cpu", time.thread_time() - cpu0)
                if stream is None:
                    self.add(name, time.monotonic() - wall0)
                else:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(stream)
                    with self._lock:
                        self._pending.append((name, start, end))
                    self._settle(wait=False)

    def _settle(self, wait: bool) -> None:
        """Add the card times whose end has passed; with ``wait``, all of
        them (each end waited on)."""
        with self._lock:
            pending, self._pending = self._pending, []
        left = []
        for name, start, end in pending:
            if wait:
                end.synchronize()
            elif not end.query():
                left.append((name, start, end))
                continue
            self.add(name, start.elapsed_time(end) / 1e3)
        if left:
            with self._lock:
                self._pending[:0] = left

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._acc[name] = self._acc.get(name, 0.0) + seconds
            self._count[name] = self._count.get(name, 0) + 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the whole-number counter ``name`` (work counted
        beside the stages: MCUs, launches)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def counters(self) -> Dict[str, int]:
        """``{counter: sum}`` of :meth:`count`, the sibling of
        :meth:`snapshot`."""
        with self._lock:
            return dict(self._counters)

    def total(self) -> float:
        return time.monotonic() - self._t0

    def snapshot(self) -> Dict[str, Tuple[float, int]]:
        """``{stage: (seconds, count)}``, card-timed stages included."""
        self._settle(wait=True)
        with self._lock:
            return {k: (self._acc[k], self._count.get(k, 0)) for k in self._acc}
