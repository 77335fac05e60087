#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the card(s) the cell asks
for; a cell of ``perfbench/held_back.json`` runs the same way.  The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``compared``: each number the comparison
checked, beside its limit); the same numbers are the last lines of
standard error.  Without a card, or without as many as the cell asks for,
or with JAX loaded once the window has closed, it prints no result and
exits non-zero.
"""

import argparse
import json
import os
import sys
import time

_T0 = time.monotonic()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _process_age() -> float:
    """Seconds since this process started (Linux; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0 = _process_age()


def setup_clock() -> float:
    return _AGE0 + time.monotonic() - _T0


def set_environment() -> None:
    """Every build and kernel cache inside the checkout at a fixed path;
    no setting of the program's from outside."""
    cache = os.path.join(HERE, "_cache")
    for name in [k for k in os.environ if k.startswith("PIM_JPEG_TPU_")]:
        del os.environ[name]
    os.environ["PIM_JPEG_TPU_CACHE"] = cache
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.makedirs(cache, exist_ok=True)


def card_lines() -> list:
    import subprocess
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.limit,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return [f"card: {line}" for line in proc.stdout.strip().splitlines()]
    except (OSError, subprocess.SubprocessError) as e:
        return [f"card: nvidia-smi failed: {e}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_environment()
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
    from harness import cell, spec

    chips = spec.load_cell(args.workload).chips
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    for line in card_lines():
        print(line, flush=True)
    try:
        out = cell.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), setup_clock,
                            log=lambda s: print(f"perfbench: {s}",
                                                flush=True))
    except cell.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    print("launch counts (window): " + json.dumps(out.launch_counts),
          flush=True)
    for line in card_lines():
        print(line, flush=True)
    for name, (value, limit) in out.compared.items():
        print(f"compared {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
