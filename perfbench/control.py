#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 3]

For each seed, in one process: one run of the cell with a short window at
its own load, its kept work compared with the reference (the program's
reading), and the control (the reference in the next precision below the
one the configuration states) put in the program's place over the same
work (the control's reading).  One JSON line a seed, then one line with
the largest program reading and the smallest control reading of each
number.  Not part of a benchmark run.
"""

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    run.set_environment()
    sys.path[:0] = [p for p in (run.HERE, run.ROOT) if p not in sys.path]
    from harness import cell

    program, control = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = cell.run_cell(args.workload, seed, args.seconds, False,
                            run.setup_clock, device=args.device,
                            control=True)
        print(json.dumps({"seed": seed, "program": out.result["compared"],
                          "control": out.control,
                          "attempted": out.result["attempted"]}),
              flush=True)
        for k, v in out.result["compared"].items():
            program[k] = max(program.get(k, v["value"]), v["value"])
        for k, v in out.control.items():
            control[k] = min(control.get(k, v), v)
    print(json.dumps({"workload": args.workload, "program_max": program,
                      "control_min": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
