"""What a cell is, found by name: ``BENCHMARK.json`` at the checkout's
root names the cell, its configuration and traffic, and the metrics; each
of those is a file of its own under ``perfbench/``:

- ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives), whose
  ``entry`` names the driver ``entries/<entry>.py``;
- ``traffic/<traffic>.json``;
- ``metrics/<metric>.py`` for every metric, end to end and per layer, each
  with ``read(rec) -> float | None``.

A cell that is not in ``BENCHMARK.json`` is looked up in
``held_back.json`` beside this folder: cells that were built and measured
but held back from the benchmark (its ``why`` says why), in the same
form.  Its entries join those of ``BENCHMARK.json`` for that cell only, so
that such a cell runs by hand as any other, and promoting it moves its
entries into ``BENCHMARK.json`` with no file of this folder edited.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    entry: type
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _for_cell(metric: dict, cell: str, reported: set) -> bool:
    """Whether a per-layer metric is read in ``cell``: the cells its
    ``workloads`` lists; without that key, every cell that reports the
    end-to-end metric it ``moves`` (``reported``)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


HELD_BACK = os.path.join(HERE, "held_back.json")
SECTIONS = ("configs", "workloads", "end_to_end", "per_layer")


def load_bench(workload: str, root: str = ROOT) -> dict:
    """``BENCHMARK.json``, joined by ``held_back.json`` where the workload
    is held back."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if any(w["name"] == workload for w in bench["workloads"]):
        return bench
    with open(HELD_BACK) as f:
        held = json.load(f)
    return {k: bench[k] + held.get(k, []) for k in SECTIONS}


def load_cell(workload: str, root: str = ROOT) -> Cell:
    bench = load_bench(workload, root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json or "
                       f"held_back.json (have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(os.path.join(root, configs[cell["config"]]["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    entry = load_module(os.path.join(HERE, "entries",
                                     config["entry"] + ".py"),
                        f"perfbench_entry_{config['entry']}").Entry
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _for_cell(m, workload, names)]
    readers = {}
    for i, m in enumerate(e2e + layer):
        readers[m["name"]] = load_module(
            os.path.join(HERE, "metrics", m["name"] + ".py"),
            f"perfbench_metric_{i}")
    return Cell(workload, int(cell["chips"]), config, traffic, entry, e2e,
                layer, readers)
