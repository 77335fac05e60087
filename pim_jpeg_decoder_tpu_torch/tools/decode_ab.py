"""A/B of the full-scale decode kernels (``rgb_kernel``, ``ycbcr_kernel``)
between two checkouts, in one call on one card.

    python3 pim_jpeg_decoder_tpu_torch/tools/decode_ab.py --parent DIR
    python3 pim_jpeg_decoder_tpu_torch/tools/decode_ab.py --root DIR

``--root DIR`` times DIR's kernels: this script imports
``pim_jpeg_decoder_tpu_torch`` from DIR (DIR's sources, DIR's build) and
prints one JSON line, ``{"card", "results": {geometry: {"us", "min_us",
"max_us", "sha1"}}}``.  ``--parent DIR`` runs that in four processes of
their own, in the order parent, this checkout, this checkout, parent, so
that both sides see the same card and the same drift; checks that every
run wrote the same bytes (sha1 of one output per geometry); and prints a
line per geometry and then one JSON line ``{geometry: {"parent_us",
"change_us", "band_us", "speedup", "verdict"}}``.  ``band_us`` is the
larger spread between the two runs of one side; the verdict is "faster"
or "slower" only beyond it, else "within band".

Geometries (``GEOMETRIES``): both kernels in all 5 modes at M=16,384 on
the int8 wire, and 4:2:0 at M=16,384 int16 and at M=196,608 (a B=256
ImageNet batch) on both wires.  Inputs: Laplace(0, 6) coefficients, Q=16
quantizer rows (one of 16-bit values), drawn from a fixed seed, rotated
past twice the L2 (``utils/devbench.rotation_count``); each time is the
median of 30 launches timed with CUDA events
(``utils/devbench.seconds_per_launch``), with their min and max.

Needs a CUDA card (exit 2 without one); exit 1 if the runs disagree on an
output.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, List, Optional, Sequence, Tuple

SEED = 20261016
HERE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODE_KEYS = ((1, 1, 1), (1, 1, 3), (1, 2, 3), (2, 1, 3), (2, 2, 3))
# (kernel, (h, v, ncomp), M, wire bytes)
GEOMETRIES: Tuple[Tuple[str, tuple, int, int], ...] = tuple(
    [(k, key, 16384, 1) for k in ("rgb", "ycbcr") for key in MODE_KEYS]
    + [(k, (2, 2, 3), m, w) for k in ("rgb", "ycbcr")
       for m, w in ((16384, 2), (196608, 1), (196608, 2))])
ORDER = ("parent", "change", "change", "parent")


def geometry_name(kernel: str, mode_name: str, m: int, wire: int) -> str:
    return f"{kernel} {mode_name} M={m} int{8 * wire}"


def _inputs(torch, mode, m: int, wire: int, dev):
    """Rotating ``(coeffs, qidx, qpool)`` buffers on ``dev``, past twice
    the L2."""
    import numpy as np

    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.utils.devbench import rotation_count

    rng = np.random.default_rng(SEED + m + 7 * wire + 31 * mode.g)
    dtype = np.int8 if wire == 1 else np.int16
    info = np.iinfo(dtype)
    count = max(2, rotation_count(m * mode.g * 64 * wire, dev))
    bufs = []
    for _ in range(count):
        coeffs = np.clip(np.round(rng.laplace(0.0, 6.0, (m, mode.g, 64))),
                         info.min, info.max).astype(dtype)
        qpool = rng.integers(1, 100, (16, mode.g, 64)).astype(np.float32)
        qpool[15] = rng.integers(1, 65536, (mode.g, 64))
        qidx = rng.integers(0, 16, m).astype(np.int32)
        bufs.append((coeffs_to_device(coeffs, dev),
                     torch.from_numpy(qidx).to(dev),
                     qpool_to_device(qpool, dev)))
    return bufs


def side() -> dict:
    """Time every geometry with the imported package's kernels."""
    import torch

    from pim_jpeg_decoder_tpu_torch.ops import specs as S
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import decode_mcus
    from pim_jpeg_decoder_tpu_torch.utils.devbench import seconds_per_launch

    dev = torch.device("cuda", 0)
    results = {}
    for kernel, key, m, wire in GEOMETRIES:
        mode = S.mode_for(key)
        bufs = _inputs(torch, mode, m, wire, dev)

        def fn(b, yc=kernel == "ycbcr"):
            return decode_mcus(*b, mode, raw=True, ycbcr=yc)

        out = fn(bufs[0])
        torch.cuda.synchronize()
        digest = hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()
        del out
        us = sorted(t * 1e6 for t in seconds_per_launch(fn, bufs,
                                                          samples=True))
        results[geometry_name(kernel, mode.name, m, wire)] = {
            "us": statistics.median(us), "min_us": us[0], "max_us": us[-1],
            "sha1": digest}
        del bufs
        torch.cuda.empty_cache()
    return {"card": torch.cuda.get_device_name(0), "results": results}


def verdict(runs: Sequence[dict]) -> Dict[str, dict]:
    """Per geometry, from the four runs in ``ORDER``: the sides' medians,
    the larger spread between the two runs of one side, the speedup
    (parent / change) and whether the change is faster or slower beyond
    that band."""
    table = {}
    for name in runs[0]["results"]:
        us = {"parent": [], "change": []}
        for who, run in zip(ORDER, runs):
            us[who].append(run["results"][name]["us"])
        p, c = us["parent"], us["change"]
        band = max(max(p) - min(p), max(c) - min(c))
        if min(p) - max(c) > band:
            word = "faster"
        elif min(c) - max(p) > band:
            word = "slower"
        else:
            word = "within band"
        table[name] = {"parent_us": p, "change_us": c, "band_us": band,
                       "speedup": statistics.mean(p) / statistics.mean(c),
                       "verdict": word}
    return table


def digests_agree(runs: Sequence[dict]) -> List[str]:
    """The geometries whose output bytes differ between runs."""
    return [name for name in runs[0]["results"]
            if len({r["results"][name]["sha1"] for r in runs}) != 1]


def _run_side(root: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--root", root], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"side {root} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", help="time this checkout's kernels")
    group.add_argument("--parent", help="A/B against this checkout")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("decode_ab needs a CUDA card", file=sys.stderr)
        return 2
    if args.root:
        print(json.dumps(side()))
        return 0
    roots = {"parent": os.path.abspath(args.parent), "change": HERE_ROOT}
    runs = [_run_side(roots[who]) for who in ORDER]
    bad = digests_agree(runs)
    if bad:
        print(f"outputs differ between runs: {bad}", file=sys.stderr)
        return 1
    table = verdict(runs)
    for name, row in table.items():
        print(f"{name}: parent {row['parent_us'][0]:.2f}, "
              f"{row['parent_us'][1]:.2f} us; change "
              f"{row['change_us'][0]:.2f}, {row['change_us'][1]:.2f} us; "
              f"band {row['band_us']:.2f} us; {row['speedup']:.3f}x, "
              f"{row['verdict']} | {runs[0]['card']}", flush=True)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    sys.exit(main())
