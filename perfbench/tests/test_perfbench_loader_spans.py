"""The readers of the loader's spans inside the program: the consumer's
wait and the worker stages' time off a CPU."""

import importlib.util
import os

import pytest

from conftest import run_small

METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "metrics")
NEW = ("loader.queue_wait_share", "loader.scan_offcpu_share",
       "loader.stage_offcpu_share")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REC = {"seconds": 50.0, "images": 1000,
       "stages": {"queue": 40.0, "scan": 8.0, "scan.cpu": 2.0,
                  "stage": 4.0, "stage.cpu": 3.0}}


@pytest.mark.parametrize("name,want", [
    ("loader.queue_wait_share", 80.0),
    ("loader.scan_offcpu_share", 75.0),
    ("loader.stage_offcpu_share", 25.0),
])
def test_reads_a_made_up_window(name, want):
    assert reader(name).read(REC) == pytest.approx(want)


@pytest.mark.parametrize("name,missing", [
    ("loader.queue_wait_share", "queue"),
    ("loader.scan_offcpu_share", "scan"),
    ("loader.scan_offcpu_share", "scan.cpu"),
    ("loader.stage_offcpu_share", "stage"),
    ("loader.stage_offcpu_share", "stage.cpu"),
])
def test_reads_nothing_without_its_stage(name, missing):
    stages = {k: v for k, v in REC["stages"].items() if k != missing}
    assert reader(name).read(dict(REC, stages=stages)) is None
    # A program without the spans (the parent of the change that added
    # them) gives an untraced window's empty stages.
    assert reader(name).read(dict(REC, stages={})) is None


def test_a_traced_run_reports_them():
    out = run_small("loader-laion256", trace=True)
    assert out.result["correct"]
    metrics = out.result["metrics"]
    for name in NEW:
        assert 0.0 <= metrics[name]["value"] <= 100.0, name
        assert metrics[name]["unit"] == "%"
