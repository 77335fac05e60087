"""Paths and fixtures of the benchmark's own tests.

Run from the checkout's root: ``python -m pytest perfbench -q`` (the card
tests skip without a card; on a machine with one they run the cells).
"""

import copy
import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for path in (HERE, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture(scope="session", autouse=True)
def environment():
    """The caches and settings a benchmark run has (``run.set_environment``):
    the entropy library builds into ``perfbench/_cache/``."""
    import run
    run.set_environment()


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is visible (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "false here")
    return torch.device("cuda:0")


def small_cell(workload: str):
    """``(traffic, config)`` of ``workload`` cut to a size the CPU runs in
    a few seconds: a few small files of every group, a few a call."""
    from harness import spec
    cell = spec.load_cell(workload)
    traffic = copy.deepcopy(cell.traffic)
    config = copy.deepcopy(cell.config)
    for group in traffic["groups"]:
        group["count"] = max(3, min(6, group["count"] // 32))
        group["height"] = max(16, group["height"] // 16)
        group["width"] = max(16, group["width"] // 16)
    traffic["items_per_call"] = 4
    traffic["warm_calls"] = 1
    if config["entry"] == "loader":
        config["batch"] = 4
    return traffic, config


def run_small(workload: str, seed: int = 2**33 + 7, trace: bool = False,
              control: bool = False, seconds: float = 0.5):
    from harness import cell
    traffic, config = small_cell(workload)
    t0 = time.monotonic()
    return cell.run_cell(workload, seed, seconds, trace,
                         lambda: time.monotonic() - t0, device="cpu",
                         traffic=traffic, config=config, control=control)
