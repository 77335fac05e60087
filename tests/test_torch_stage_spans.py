"""The port's stage timers on the batch loader: the profiler ranges they
open, the thread CPU they sum, the consumer's wait, and the card-timed
stages that read CUDA events without synchronising.

The tests need no card: the card-timed path runs against stand-in events
and streams that record what was asked of them.
"""

import contextlib
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu_torch.models import input_pipeline as T
from pim_jpeg_decoder_tpu_torch.utils import profiling
from pim_jpeg_decoder_tpu_torch.utils.profiling import StageTimers


def _photo(seed, h, w):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3))
    img = np.kron(small, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


SAME = [encode_jpeg(_photo(i, 40, 56), quality=75, sampling="4:2:0")
        for i in range(3)]
MIXED = [encode_jpeg(_photo(10 + i, h, w), quality=75, sampling="4:2:0")
         for i, (h, w) in enumerate([(40, 56), (48, 64), (47, 61)])]
BOXES = [(0, 0), (3, 5), (16, 24)]
CROP = (24, 32)
WORKER_STAGES = {"scan", "scan.cpu", "entropy", "stage", "stage.cpu"}
DEVICE_STAGES = {"h2d", "device"}
CROP_COUNTERS = ("crop.mcus_decoded", "crop.mcus_shipped", "crop.mode_groups")


def _three_batches(timers):
    return list(T.iter_decode_batches([SAME] * 3, device="cpu",
                                      timers=timers))


def test_iterator_times_the_wait_and_the_worker_cpu():
    timers = StageTimers()
    _three_batches(timers)
    snap = timers.snapshot()
    assert snap["queue"][1] == 3
    assert WORKER_STAGES | DEVICE_STAGES | {"queue"} <= set(snap)
    for name in ("scan", "stage"):
        assert 0.0 <= snap[name + ".cpu"][0] <= snap[name][0]
        assert snap[name + ".cpu"][1] == snap[name][1]


def test_a_plain_stage_keeps_its_keys():
    timers = StageTimers()
    with timers.stage("prepare"):
        pass
    assert set(timers.snapshot()) == {"prepare"}
    with timers.stage("scan", cpu=True):
        sum(range(1000))
    assert set(timers.snapshot()) == {"prepare", "scan", "scan.cpu"}


def test_no_timers_no_stage(monkeypatch):
    """``timers=None`` calls nothing of the timers and gives the batches a
    run with timers gives."""
    timed = _three_batches(StageTimers())

    def refuse(*args, **kwargs):
        raise AssertionError("a stage was timed with timers=None")

    monkeypatch.setattr(StageTimers, "stage", refuse)
    monkeypatch.setattr(StageTimers, "add", refuse)
    plain = _three_batches(None)
    assert len(plain) == len(timed) == 3
    for (a, ha), (b, hb) in zip(plain, timed):
        assert torch.equal(a, b)
        assert [h.width for h in ha] == [h.width for h in hb]
    assert isinstance(T._tstage(None, "scan", cpu=True),
                      contextlib.nullcontext)


class _CountedRanges:
    """Counts ``record_function`` ranges opened through the profiler
    module's attribute."""

    def __init__(self, monkeypatch):
        import torch.autograd.profiler as prof
        self.names = []
        real = prof.record_function

        def counted(name, *args):
            self.names.append(name)
            return real(name, *args)

        monkeypatch.setattr(prof, "record_function", counted)


def test_no_range_without_a_profiler(monkeypatch):
    ranges = _CountedRanges(monkeypatch)
    _three_batches(StageTimers())
    assert ranges.names == []
    # The same run under a profiler opens them (the count above is not
    # vacuous), one a stage and none around a whole batch.
    with profile(activities=[ProfilerActivity.CPU]):
        _three_batches(StageTimers())
    assert set(ranges.names) == {"pjt.queue", "pjt.scan", "pjt.entropy",
                                 "pjt.stage", "pjt.h2d", "pjt.device"}


def _events(trace_path):
    with open(trace_path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_ranges_lie_on_the_threads_that_run_them(monkeypatch, tmp_path):
    scanners = {}
    real = T._scan_same_size

    def scan(blobs, caller):
        me = threading.current_thread()
        scanners[threading.get_native_id()] = me.name
        return real(blobs, caller)

    monkeypatch.setattr(T, "_scan_same_size", scan)
    config = profiling.all_threads_config()
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        _three_batches(StageTimers())
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = _events(path)
    caller = threading.get_native_id()
    queue = [e for e in events if e["name"] == "pjt.queue"]
    assert len(queue) == 3
    assert {e["tid"] for e in queue} == {caller}
    assert {e["tid"] for e in events if e["name"] in ("pjt.h2d",
                                                       "pjt.device")} == {
        caller}
    assert all(name.startswith("pjt-prefetch") for name in scanners.values())
    if config is None:
        pytest.skip("this torch profiles the starting thread alone")
    scans = [e for e in events if e["name"] == "pjt.scan"]
    assert len(scans) == 3
    assert {e["tid"] for e in scans} <= set(scanners)


@pytest.mark.parametrize("api", ["same_size", "mixed", "iter"])
def test_crop_path_records_the_stages(api):
    timers = StageTimers()
    if api == "same_size":
        T.decode_same_size_batch_crops(SAME, BOXES, CROP, device="cpu",
                                       timers=timers)
    elif api == "mixed":
        T.decode_batch_crops(MIXED, BOXES, CROP, device="cpu", timers=timers)
    else:
        for _ in T.iter_decode_batch_crops([(MIXED, BOXES)] * 2, CROP,
                                           device="cpu", mixed_sizes=True,
                                           timers=timers):
            pass
    snap = timers.snapshot()
    want = WORKER_STAGES | DEVICE_STAGES | {"crop_gather"} | (
        {"queue"} if api == "iter" else set())
    assert set(snap) == want
    assert snap["scan"][1] == snap["crop_gather"][1] == (
        2 if api == "iter" else 1)
    assert set(timers.counters()) == set(CROP_COUNTERS)


def _mixed_modes():
    """Three images of two modes and their crop origins: 4:2:0 40x56
    (3 x 4 MCUs of 16 px), 4:4:4 47x61 (6 x 8 MCUs of 8 px), 4:2:0 48x64
    (3 x 4)."""
    blobs = [MIXED[0],
             encode_jpeg(_photo(30, 47, 61), quality=75, sampling="4:4:4"),
             MIXED[1]]
    return blobs, [(0, 0), (17, 20), (16, 24)]


def test_crop_counters_and_gather_on_a_known_batch():
    """A 24x32 crop covers at most 3 x 3 MCUs at 4:2:0 (16-pixel MCUs, one
    of slack) and 4 x 5 at 4:4:4 (8-pixel MCUs): the 4:2:0 launch ships 2
    images x 9, the 4:4:4 launch 1 x 20; the host decoded 12 + 48 + 12
    MCUs; two mode groups.  Twice through the iterator, twice the sums."""
    blobs, boxes = _mixed_modes()
    timers = StageTimers()
    for _ in T.iter_decode_batch_crops([(blobs, boxes)] * 2, CROP,
                                       device="cpu", mixed_sizes=True,
                                       timers=timers):
        pass
    assert timers.counters() == {"crop.mcus_decoded": 2 * 72,
                                 "crop.mcus_shipped": 2 * 38,
                                 "crop.mode_groups": 2 * 2}
    seconds, count = timers.snapshot()["crop_gather"]
    assert count == 2 and seconds > 0


def test_no_timers_nothing_counted(monkeypatch):
    """Without timers the crop path counts nothing and opens no stage, and
    gives the crops a run with timers gives."""
    blobs, boxes = _mixed_modes()
    timed, _ = T.decode_batch_crops(blobs, boxes, CROP, device="cpu",
                                    timers=StageTimers())

    def refuse(*args, **kwargs):
        raise AssertionError("counted or timed with timers=None")

    for name in ("count", "stage", "add"):
        monkeypatch.setattr(StageTimers, name, refuse)
    plain, _ = T.decode_batch_crops(blobs, boxes, CROP, device="cpu")
    assert torch.equal(plain, timed)
    assert T._tcount(None, "crop.mode_groups", 1) is None
    assert StageTimers().counters() == {}


def test_crop_path_gives_the_same_crops_with_timers():
    a, _ = T.decode_batch_crops(MIXED, BOXES, CROP, device="cpu")
    b, _ = T.decode_batch_crops(MIXED, BOXES, CROP, device="cpu",
                                timers=StageTimers())
    assert torch.equal(a, b)


# -- stages timed on a card, against stand-ins ---------------------------


class _Clock:
    def __init__(self):
        self.now = 0.0
        self.log = []
        self.synced = []


class _Stream:
    def __init__(self, clock, name):
        self.clock = clock
        self.name = name


def _event_class(clock, passes=False):
    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = None
            self.passed = passes

        def record(self, stream):
            clock.now += 1.0
            self.at = clock.now
            clock.log.append(("record", stream.name))

        def query(self):
            return self.passed

        def synchronize(self):
            clock.synced.append(self)
            self.passed = True

        def elapsed_time(self, end):
            assert self.passed or end.passed
            return 1e3 * (end.at - self.at)

    return Event


def _no_sync(*args, **kwargs):
    raise AssertionError("synchronised")


@pytest.mark.parametrize("passes", [False, True])
def test_dispatch_times_the_card_without_synchronising(monkeypatch, passes):
    want, _ = T.decode_same_size_batch(SAME, device="cpu")
    clock = _Clock()
    side, launch = _Stream(clock, "side"), _Stream(clock, "launch")
    monkeypatch.setattr(torch.cuda, "Event", _event_class(clock, passes))
    monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: launch)
    monkeypatch.setattr(T, "h2d_stream", lambda dev: side)

    def copy_to(tensors, dev):
        clock.now += 5.0
        clock.log.append("copy")
        return list(tensors), "ready"

    def adopt(tensors, ready, dev):
        assert ready == "ready"
        clock.log.append("adopt")

    real_decode, real_epilogue = T.decode_mcus, T.raster_epilogue

    def decode(*args, **kwargs):
        clock.now += 2.0
        clock.log.append("decode")
        return real_decode(*args, **kwargs)

    def epilogue(*args, **kwargs):
        clock.now += 3.0
        clock.log.append("epilogue")
        return real_epilogue(*args, **kwargs)

    monkeypatch.setattr(T, "copy_to", copy_to)
    monkeypatch.setattr(T, "adopt", adopt)
    monkeypatch.setattr(T, "decode_mcus", decode)
    monkeypatch.setattr(T, "raster_epilogue", epilogue)

    timers = StageTimers()
    staged = T._host_stage(SAME, 1, "auto", "test", 1, False)
    out, _ = T._dispatch(staged, 1, None, [torch.device("cuda:0")], timers)
    assert torch.equal(out, want)
    assert clock.log == [("record", "side"), "copy", "adopt",
                         ("record", "side"), ("record", "launch"), "decode",
                         "epilogue", ("record", "launch")]
    assert clock.synced == []
    with timers._lock:
        acc = dict(timers._acc)
    if passes:
        # Read as soon as each stage closed.
        assert acc == pytest.approx({"h2d": 6.0, "device": 6.0})
    else:
        assert acc == {}
    snap = timers.snapshot()
    assert snap == pytest.approx({"h2d": (6.0, 1), "device": (6.0, 1)})
    assert len(clock.synced) == (0 if passes else 2)
    assert timers.snapshot() == snap


def test_card_stages_settle_under_many_threads(monkeypatch):
    """Card-timed stages closed on many threads at once, half of them
    passed at once and half read at the snapshot: every one counted
    once."""
    clock = _Clock()
    lock = threading.Lock()

    class Event(_event_class(clock)):
        def record(self, stream):
            with lock:
                super().record(stream)
            self.at = 0.0 if self.at is None else self.at
            self.passed = stream.name == "fast"

        def elapsed_time(self, end):
            return 1e3

    monkeypatch.setattr(torch.cuda, "Event", Event)
    timers = StageTimers()
    threads, per = 16, 200
    streams = [_Stream(clock, "fast"), _Stream(clock, "slow")]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                with timers.stage("h2d", stream=streams[(k + i) % 2]):
                    pass

        pool = [threading.Thread(target=work, args=(k,))
                for k in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    seconds, count = timers.snapshot()["h2d"]
    assert count == threads * per
    assert seconds == pytest.approx(threads * per)
