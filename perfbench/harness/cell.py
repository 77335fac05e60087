"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

Set-up builds the corpus from the seed, builds the entry's driver, and
warms it up on the cell's own traffic (the first calls of the same
stream).  The window then drives the entry for ``seconds``; with
``trace`` it runs under ``torch.profiler`` and the program's stage timers,
and its metrics are the per-layer ones.  After the window the device's
peak is read, the launch counters compared, the loaded modules checked,
and the reference decodes the kept work on worker processes.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from harness import corpus, reference, spec, trace as tracing

# Top-level module names that must not be loaded once the window has
# closed: JAX and the JAX package that the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "pim_jpeg_decoder_tpu")
WORK = os.path.join(spec.HERE, "_work")


class RunError(RuntimeError):
    """A run that must print no result."""


@dataclasses.dataclass
class Outcome:
    result: dict                       # the JSON line
    compared: Dict[str, Tuple[float, float]]
    launch_counts: Dict[str, int]
    control: Optional[Dict[str, float]] = None


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    names = modules if modules is not None else list(sys.modules)
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def _fifths(latencies: List[float], items: int) -> List[float]:
    """Items a second in each fifth of the window, the calls taken back
    to back (a stall shows in one fifth, a slow run in all)."""
    n = len(latencies)
    out = []
    for i in range(5):
        part = latencies[i * n // 5:(i + 1) * n // 5]
        out.append(round(len(part) * items / sum(part), 1) if part else 0.0)
    return out


def _launch_delta(after: dict, before: dict) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             setup_clock: Callable[[], float], device: str = "cuda:0",
             traffic: Optional[dict] = None, config: Optional[dict] = None,
             control: bool = False,
             log: Callable[[str], None] = lambda s: None) -> Outcome:
    """Run ``workload`` once; ``setup_clock()`` gives the seconds since the
    process started.  ``traffic`` and ``config`` replace the cell's files
    (tests run a cell at a small size on the CPU).  ``control`` also puts
    the control (the reference in a lower precision) in the program's place
    over the same kept work and keeps its numbers."""
    import torch

    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import launch_counts

    cell = spec.load_cell(workload)
    traffic = traffic or cell.traffic
    config = config or cell.config
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    log(f"imports and device {setup_clock():.3f} s")
    files = corpus.build_corpus(torch, traffic, seed, dev)
    log(f"corpus built {setup_clock():.3f} s")
    calls = corpus.calls(traffic, len(files), seed)
    rng = np.random.default_rng(corpus.seed_words(seed, 3))
    entry = cell.entry(torch, config, traffic, files, calls, dev, trace,
                       rng)
    entry.warm(int(traffic["warm_calls"]))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    counts0 = launch_counts()
    setup_s = setup_clock()
    log(f"set-up {setup_s:.3f} s: {len(files)} files, "
        f"{sum(len(f.data) for f in files)} bytes, mean "
        f"{np.mean([f.bpp for f in files]):.3f} bits a pixel")

    trace_data = None
    if trace or (cuda and any(m["source"] == "device_trace"
                              for m in cell.end_to_end)):
        # Traced: host spans and device activity.  Untraced, where an
        # end-to-end metric reads the device: its activity alone.
        os.makedirs(WORK, exist_ok=True)
        with tracing.Profiled(torch, os.path.join(
                WORK, f"trace_{workload}.json"), cuda, host=trace) as prof:
            win = entry.window(seconds, trace)
        trace_data = prof.trace
    else:
        win = entry.window(seconds, False)
    if cuda:
        torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counts = _launch_delta(launch_counts(), counts0)
    found = forbidden_modules()
    if found:
        raise RunError("modules of JAX or of the JAX package are loaded: "
                       + ", ".join(found))

    lat = sorted(win["latencies"])
    log(f"window {win['seconds']:.3f} s, {len(lat)} calls, latency min "
        f"{lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s, "
        f"CPU {win['cpu_s']:.3f} s")
    log(f"items a second by fifths of the window "
        f"{_fifths(win['latencies'], win['images'] // len(lat))}")
    rec = dict(win, setup_s=setup_s,
               trace=trace_data, launch_counts=counts)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.readers[m["name"]].read(rec)
        if value is None:
            # Untraced, an end-to-end metric must read; on the CPU (the
            # tests) a device's trace has nothing to give.
            if not trace and (cuda or m["source"] != "device_trace"):
                raise RunError(f"end-to-end metric {m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        detail = getattr(cell.readers[m["name"]], "detail", None)
        if detail is not None:
            log(f"{m['name']}: {detail(rec)}")

    # The comparison, once the window has closed and the peak is read.
    kept = win.pop("kept")
    t_check = time.monotonic()
    decode = functools.partial(
        reference.decode_all,
        module=reference.module_name(traffic, config),
        scale=int(config.get("scale", 1)))
    rgb = decode({i: files[i].data for i in entry.needed(kept)})
    numbers = entry.compare(kept, rgb)
    ctrl = (entry.compare(entry.control(kept, rgb, decode), rgb)
            if control else None)
    del kept, rgb
    log(f"reference check {time.monotonic() - t_check:.3f} s")
    failed = win["failed"]
    if counts.get("plain_on_cuda", 0):
        failed = win["attempted"]
    numbers["failed"] = failed
    numbers["plain_on_cuda"] = counts.get("plain_on_cuda", 0)
    limits = config["limits"]
    compared = {k: (numbers[k], limits[k]) for k in limits}
    correct = all(v <= lim for v, lim in compared.values())

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = trace_data.busy_s()
        device_info["window_s"] = trace_data.window_s
        result["breakdown"] = tracing.breakdown(trace_data)
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return Outcome(result, compared, counts, ctrl)
