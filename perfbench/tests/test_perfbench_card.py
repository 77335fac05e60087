"""On a card: every cell runs, traced and not, and comes out correct with
every metric the benchmark lists for it.

    python -m pytest perfbench -q -m card
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _run(workload, trace):
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload,
         "--seed", str(2**31 + 11), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("workload", ("loader-laion256",
                                      "engine-imagenet-val"))
def test_cell_on_the_card(card, workload, trace):
    from harness import spec
    cell = spec.load_cell(workload)
    line = _run(workload, trace)
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu"
    assert "H100" in line["device"]["kind"]
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} <= set(line["metrics"])
