"""Kernel roofline shares from the traced window: the least time the card
could take for the work the kernels did, over the time they took.

A decode launch's kind, mode and wire come from its demangled name
(``rgb_kernel<T, H, V, NC, VEC16>``, ``ycbcr_kernel<T, G, VEC16>``: T is
``short`` for the int16 wire, ``signed char`` for int8), its MCU count
from its grid (32 MCUs a block).  The work counted is the work the run
asked for: the MCUs of the files decoded in the window (``rec["work"]``),
shared among a mode's launches in proportion to their grids, so MCUs a
batch is padded with count as time and not as work.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

from harness import arith

TILE_MCUS = 32
_WIRE_BYTES = {"short": 2, "signed char": 1, "char": 1}


def _decode_launch(kernel: str, args) -> Tuple[int, int]:
    """``(blocks an MCU, wire bytes)`` of a decode launch."""
    wire = _WIRE_BYTES[args[0]]
    if kernel == "rgb_kernel":
        h, v, nc = int(args[1]), int(args[2]), int(args[3])
        return (1 if nc == 1 else h * v + 2), wire
    return int(args[1]), wire


def decode_bounds(trace, rec, kernels: Sequence[str]
                  ) -> Tuple[float, float, Dict[str, float]]:
    """``(bound seconds, kernel seconds, bound seconds by term)`` over the
    window's launches of ``kernels`` (``rgb_kernel``, ``ycbcr_kernel``)."""
    groups = defaultdict(lambda: [0, 0.0])   # (kind, g, wire) -> [M, s]
    for kernel in kernels:
        for args, e in trace.launches(kernel):
            g, wire = _decode_launch(kernel, args)
            grp = groups[(kernel.split("_")[0], g, wire)]
            grp[0] += e.grid[0] * TILE_MCUS
            grp[1] += e.seconds
    launched = defaultdict(int)
    for (_, g, _), (m, _) in groups.items():
        launched[g] += m
    bound, seconds, terms = 0.0, 0.0, defaultdict(float)
    for (kind, g, wire), (m, sec) in groups.items():
        share = m / launched[g]
        mcus = rec["work"]["mcus"].get(g, 0) * share
        images = rec["work"]["images"].get(g, 0) * share
        nbytes, ops = arith.decode_mcu_counts(kind, g, wire)
        t, term = arith.bound_s(mcus * nbytes
                                + images * arith.quantizer_bytes(g),
                                mcus * ops, arith.INT32_OPS)
        bound += t
        seconds += sec
        terms[term] += t
    return bound, seconds, dict(terms)


def epilogue_bounds(trace, rec) -> Tuple[float, float, Dict[str, float]]:
    """The same over ``raster_epilogue_kernel`` launches: the window's
    kernel RGB read once, its output elements written once."""
    launches = trace.launches("raster_epilogue_kernel")
    if not launches:
        return 0.0, 0.0, {}
    (g, mcus), = rec["work"]["mcus"].items()
    nbytes, flops = arith.epilogue_counts(mcus, g, rec["work"]["out_elements"],
                                          rec["work"]["out_bytes"])
    t, term = arith.bound_s(nbytes, flops, arith.FP32_FLOPS)
    return t, sum(e.seconds for _, e in launches), {term: t}


def decode_parts(rec, kernel: str) -> list:
    """The bound and time of the window's launches of one decode kernel;
    nothing where the run has no trace or no such launch."""
    if rec["trace"] is None:
        return []
    part = decode_bounds(rec["trace"], rec, (kernel,))
    return [part] if part[1] > 0 else []


def epilogue_parts(rec) -> list:
    """The same for ``raster_epilogue_kernel``."""
    if rec["trace"] is None:
        return []
    part = epilogue_bounds(rec["trace"], rec)
    return [part] if part[1] > 0 else []


def share(parts) -> Optional[float]:
    """Σ bound over Σ kernel time, in %; None when no launch was seen."""
    bound = sum(p[0] for p in parts)
    seconds = sum(p[1] for p in parts)
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds


def describe(parts) -> str:
    terms = defaultdict(float)
    for _, _, t in parts:
        for k, v in t.items():
            terms[k] += v
    return ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in sorted(terms.items())
                     ) + (f"; kernels {sum(p[1] for p in parts) * 1e3:.4f} ms"
                          if parts else "")
