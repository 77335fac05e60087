"""The crop loader's cell on the CPU at a small size: the comparison that
decides ``correct`` passes on the program, fails on the control and on a
timed path broken three ways; its work counts the MCUs each crop touches;
its new per-layer readers read a traced run and nothing where the program
has no counters."""

import copy
import importlib.util
import os
import time

import numpy as np
import pytest

WORKLOAD = "loader-imagenet-crops"
METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "metrics")
NEW = ("rgb_kernel_roofline.crops", "raster_epilogue_kernel_roofline.crops",
       "device.idle_share.crops", "crops.images_per_s",
       "crops.gather_ms_per_image", "crops.shipped_mcu_share",
       "crops.mode_groups_per_batch")
# The cell's four sizes cut down, each still larger than the small crop.
SMALL_SIZES = {(375, 500): (47, 61), (500, 375): (61, 47),
               (333, 500): (40, 56), (500, 333): (56, 40)}


def small_crop_cell():
    """``(traffic, config)`` of the cell at a size the CPU runs in a few
    seconds: 3 files of each group, batches of 8, 24x32 crops."""
    from harness import spec
    cell = spec.load_cell(WORKLOAD)
    traffic = copy.deepcopy(cell.traffic)
    config = copy.deepcopy(cell.config)
    for group in traffic["groups"]:
        group["height"], group["width"] = SMALL_SIZES[
            (group["height"], group["width"])]
        group["count"] = 3
    traffic["items_per_call"] = 8
    traffic["warm_calls"] = 1
    config["batch"] = 8
    config["crop"] = [24, 32]
    return traffic, config


def run_crops(trace=False, control=False, seed=2**33 + 7, seconds=0.5):
    from harness import cell
    traffic, config = small_crop_cell()
    t0 = time.monotonic()
    return cell.run_cell(WORKLOAD, seed, seconds, trace,
                         lambda: time.monotonic() - t0, device="cpu",
                         traffic=traffic, config=config, control=control)


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_cell_loads_by_name():
    from harness import spec
    cell = spec.load_cell(WORKLOAD)
    assert cell.chips == 1 and cell.config["entry"] == "crop_loader"
    assert {m["name"] for m in cell.end_to_end} == {
        "loader_kernel_us_per_image", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    t = cell.traffic
    n = sum(g["count"] for g in t["groups"])
    assert n == 512 and t["items_per_call"] == 256
    assert sum(g["count"] for g in t["groups"]
               if g["sampling"] == "4:4:4") * 8 == n
    # The loader cell sees none of the new metrics.
    assert not set(NEW) & set(spec.load_cell("loader-laion256").readers)


def test_names_stay_unique_and_every_cell_loads():
    """The checks of ``test_perfbench_generator``'s held-back test over the
    benchmark as it now stands, two cells: no name twice in a section
    across the benchmark and the held-back cells, the held-back cells
    load with their own metrics, and the benchmark's cells with none of
    them."""
    import json

    from harness import spec
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(spec.HELD_BACK) as f:
        held = json.load(f)
    ours = [w["name"] for w in bench["workloads"]]
    back = {w["name"] for w in held["workloads"]}
    assert ours == ["loader-laion256", WORKLOAD] and not set(ours) & back
    assert set(held["why"]) == back
    for section in spec.SECTIONS:
        names = [e["name"] for e in bench[section] + held[section]]
        assert len(names) == len(set(names)), section
    engine = spec.load_cell("engine-imagenet-val")
    assert {m["name"] for m in engine.end_to_end} == {
        "engine_mp_per_s", "host_cpu_ms_per_mp", "setup_s"}
    assert "engine.prepare_ms_per_mp" in engine.readers
    for name in ours:
        cell = spec.load_cell(name)
        assert "engine_mp_per_s" not in cell.readers
        assert not any(m["name"].startswith("engine")
                       for m in cell.per_layer)
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")


@pytest.mark.parametrize("seed", [2**33 + 7, 3 * 2**31 + 5])
def test_program_matches_reference(seed):
    out = run_crops(seed=seed)
    assert out.result["correct"], out.result["compared"]
    assert out.result["attempted"] > 0 and out.result["failed"] == 0
    assert out.result["compared"]["max_ulp_gap"]["value"] == 0


def test_control_fails():
    out = run_crops(control=True)
    assert out.control["max_ulp_gap"] > 0, out.control


def _patch_staging(monkeypatch, fault):
    """Break the staged batches underneath the cell's entry point."""
    import torch

    from pim_jpeg_decoder_tpu_torch.models import input_pipeline as T
    original = T._host_stage_crops

    def broken(*args, **kwargs):
        staged = original(*args, **kwargs)
        if fault == "group_row":
            # The 4:4:4 launch writes image k of its group into row k.
            for ln in staged.launches:
                if ln.mode.name == "4:4:4" and ln.index is not None:
                    ln.arrays[5] = torch.arange(len(ln.index),
                                                dtype=torch.int32)
        elif fault == "dropped_group" and len(staged.launches) > 1:
            staged.launches = staged.launches[:-1]
        return staged
    monkeypatch.setattr(T, "_host_stage_crops", broken)


def _patch_origins(monkeypatch):
    """In every batch, the first crop that has room for it taken one MCU
    (16 pixels) off its origin, down, up, left or right."""
    from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu_torch.models import input_pipeline as T
    original = T.iter_decode_batch_crops

    def shifted(crop_batches, crop_hw, *args, **kwargs):
        def moved():
            for blobs, boxes in crop_batches:
                boxes = list(boxes)
                for k, (y0, x0) in enumerate(boxes):
                    h = scan_jpeg(blobs[k])
                    room = [(y, x) for y, x in ((y0 + 16, x0), (y0 - 16, x0),
                                                (y0, x0 + 16), (y0, x0 - 16))
                            if 0 <= y <= h.height - crop_hw[0]
                            and 0 <= x <= h.width - crop_hw[1]]
                    if room:
                        boxes[k] = room[0]
                        break
                yield blobs, boxes
        return original(moved(), crop_hw, *args, **kwargs)
    monkeypatch.setattr(T, "iter_decode_batch_crops", shifted)


@pytest.mark.parametrize("fault", ("group_row", "origin_off_by_an_mcu",
                                   "dropped_group"))
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    if fault == "origin_off_by_an_mcu":
        _patch_origins(monkeypatch)
    else:
        _patch_staging(monkeypatch, fault)
    out = run_crops()
    assert not out.result["correct"], (fault, out.result["compared"])


def test_work_counts_the_mcus_each_crop_touches():
    """14 or 15 MCUs a side at 4:2:0 (16 px), 28 or 29 at 4:4:4 (8 px),
    for a 224x224 crop, by where its origin lies on the MCU grid."""
    path = os.path.join(os.path.dirname(METRICS), "entries", "crop_loader.py")
    spec = importlib.util.spec_from_file_location("crop_loader_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.touched(np.array([0, 16, 1, 15, 8]), 224, 16).tolist() == [
        14, 14, 15, 15, 15]
    assert mod.touched(np.array([0, 8, 1, 7, 272]), 224, 8).tolist() == [
        28, 28, 29, 29, 28]


REC = {"seconds": 50.0, "images": 1000, "attempted": 4,
       "stages": {"crop_gather": 2.0},
       "counters": {"crop.mcus_decoded": 4000, "crop.mcus_shipped": 1000,
                    "crop.mode_groups": 10},
       "batches_staged": 5}


@pytest.mark.parametrize("name,want", [
    ("crops.images_per_s", 20.0), ("crops.gather_ms_per_image", 2.0),
    ("crops.shipped_mcu_share", 25.0), ("crops.mode_groups_per_batch", 2.0),
])
def test_reads_a_made_up_window(name, want):
    assert reader(name).read(REC) == pytest.approx(want)


@pytest.mark.parametrize("name", ["crops.gather_ms_per_image",
                                  "crops.shipped_mcu_share",
                                  "crops.mode_groups_per_batch"])
def test_reads_nothing_from_a_program_without_counters(name):
    """The parent of the change that added the counters and the stage
    gives empty stages and counters: the readers read nothing and raise
    nothing."""
    rec = dict(REC, stages={}, counters={}, batches_staged=0)
    assert reader(name).read(rec) is None
    assert reader(name).read({k: v for k, v in rec.items()
                              if k != "counters"}) is None


def test_rooflines_read_nothing_without_a_trace():
    rec = dict(REC, trace=None, work={"mcus": {6: 10, 3: 5},
                                      "images": {6: 1, 3: 1},
                                      "out_elements": 6, "out_bytes": 2})
    for name in ("rgb_kernel_roofline.crops",
                 "raster_epilogue_kernel_roofline.crops",
                 "device.idle_share.crops"):
        assert reader(name).read(rec) is None


def test_epilogue_bound_sums_the_modes():
    """Both modes' kernel RGB read once and the batch written once."""
    from harness import arith
    mod = reader("raster_epilogue_kernel_roofline.crops")

    class Trace:
        def launches(self, kernel):
            assert kernel == "raster_epilogue_kernel"
            e = type("E", (), {"seconds": 1e-3})()
            return [([], e), ([], e)]

    work = {"mcus": {6: 225 * 3, 3: 841}, "images": {6: 3, 3: 1},
            "out_elements": 4 * 224 * 224 * 3, "out_bytes": 2}
    (bound, seconds, _), = mod.parts({"trace": Trace(), "work": work})
    nbytes = (3 * 4 * 64 * 225 * 3 + 3 * 1 * 64 * 841
              + 4 * 224 * 224 * 3 * 2)
    assert seconds == pytest.approx(2e-3)
    assert bound == pytest.approx(nbytes / arith.HBM_BYTES_PER_S)


def test_a_traced_run_reports_the_new_metrics():
    out = run_crops(trace=True)
    assert out.result["correct"]
    metrics = out.result["metrics"]
    for name in ("crops.images_per_s", "crops.gather_ms_per_image",
                 "crops.shipped_mcu_share", "crops.mode_groups_per_batch",
                 "device.idle_share.crops"):
        assert metrics[name]["value"] >= 0, name
    assert 0 < metrics["crops.shipped_mcu_share"]["value"] <= 100
    assert 1 <= metrics["crops.mode_groups_per_batch"]["value"] <= 2
