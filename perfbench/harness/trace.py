"""The traced window: ``torch.profiler`` around it, its Chrome trace read
back into kernels, copies and host spans, the device's busy time and the
two lists of the result's ``breakdown``.

The benchmark's own spans mark the window (``perfbench.window``) and each
call into the program (``perfbench.call``); the kernels, copies and the
program's torch operations come from the profiler.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from collections import defaultdict
from typing import List, Optional, Tuple

from harness import arith

WINDOW_SPAN = "perfbench.window"
CALL_SPAN = "perfbench.call"
_HOST_CATS = ("cpu_op", "user_annotation")
_TEMPLATE = re.compile(r"(\w+)<([^()]*)>")


@dataclasses.dataclass
class Event:
    name: str
    start: float      # seconds, the trace's clock
    end: float
    grid: Tuple[int, ...] = ()

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    window: Tuple[float, float]
    kernels: List[Event]
    copies: List[Event]          # memcpy and memset on the device
    host: List[Event]            # torch ops and the benchmark's spans

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_events(self) -> List[Event]:
        lo, hi = self.window
        return [e for e in self.kernels + self.copies
                if e.end > lo and e.start < hi]

    def busy_s(self) -> float:
        lo, hi = self.window
        return arith.union_seconds(
            (max(e.start, lo), min(e.end, hi)) for e in self.device_events())

    def idle_share(self) -> Optional[float]:
        """The share of the window, in %, in which no kernel, memcpy or
        memset ran on the device; None for an empty window."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernel_seconds(self) -> float:
        """The summed time of the window's kernels, each clipped to the
        window and counted in full where two overlap."""
        lo, hi = self.window
        return sum(min(e.end, hi) - max(e.start, lo) for e in self.kernels
                   if e.end > lo and e.start < hi)

    def launches(self, kernel: str) -> List[Tuple[List[str], Event]]:
        """Launches of ``kernel`` in the window with its template
        arguments, read from the demangled name."""
        out = []
        for e in self.device_events():
            for m in _TEMPLATE.finditer(e.name):
                if m.group(1) == kernel:
                    args = [a.strip() for a in m.group(2).split(",")]
                    out.append((args, e))
                    break
        return out


def short_name(name: str) -> str:
    """A kernel's name with its template arguments and without its
    parameter list and namespace; a copy's name as it is."""
    name = name.replace("(anonymous namespace)::", "")
    m = _TEMPLATE.search(name)
    return m.group(0) if m else name


def load_chrome_trace(path: str, spans: bool = True) -> Trace:
    """The trace at ``path``; with ``spans`` its window is the benchmark's
    span, else (a trace of the device alone) from its first device event
    to its last."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels, copies, host = [], [], []
    window = None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = ev.get("cat", "")
        start = float(ev["ts"]) * 1e-6
        e = Event(ev.get("name", ""), start, start + float(ev["dur"]) * 1e-6)
        if cat == "kernel":
            e.grid = tuple(ev.get("args", {}).get("grid", ()))
            kernels.append(e)
        elif cat in ("gpu_memcpy", "gpu_memset"):
            copies.append(e)
        elif cat in _HOST_CATS:
            if e.name == WINDOW_SPAN and cat == "user_annotation":
                window = (e.start, e.end)
            else:
                host.append(e)
    if not spans:
        ends = [(e.start, e.end) for e in kernels + copies]
        window = ((min(a for a, _ in ends), max(b for _, b in ends))
                  if ends else (0.0, 0.0))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    return Trace(window, kernels, copies, host)


class Profiled:
    """``with Profiled(torch, path) as p: ...`` profiles the block as the
    window; ``p.trace`` then holds it.  The trace file is read back and
    deleted.  With ``host`` false only the device's activity is recorded
    (no host operations, no spans): the light profile of an untraced run
    whose end-to-end metric reads the device."""

    def __init__(self, torch, path: str, cuda: bool, host: bool = True):
        self.torch = torch
        self.path = path
        self.cuda = cuda
        self.host = host
        self.trace: Optional[Trace] = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] if self.host else []
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN) if self.host else None
        if self._span is not None:
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.torch.cuda.synchronize()
        if self._span is not None:
            self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
            try:
                self.trace = load_chrome_trace(self.path, self.host)
            finally:
                os.remove(self.path)
        return False


def call_span(torch):
    """The benchmark's span around one call into the program."""
    from torch.profiler import record_function
    return record_function(CALL_SPAN)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device, each named by what the host was doing: the
    program's host operation that overlaps most of the gap, else the
    benchmark's span around the call."""
    by_op = defaultdict(float)
    lo, hi = trace.window
    for e in trace.device_events():
        by_op[short_name(e.name)] += min(e.end, hi) - max(e.start, lo)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = arith.gaps(((e.start, e.end) for e in trace.device_events()),
                      lo, hi)
    idle.sort(key=lambda ab: -(ab[1] - ab[0]))
    host = sorted(trace.host, key=lambda e: e.start)
    named = []
    for a, b in idle[:top]:
        best, best_key = "host: no span", None
        for e in host:
            if e.start >= b:
                break
            cover = min(e.end, b) - max(e.start, a)
            if cover <= 0:
                continue
            key = (e.name.startswith("perfbench."), -cover)
            if best_key is None or key < best_key:
                best, best_key = e.name, key
        named.append([best, b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
