"""The yardstick's arithmetic: bytes and operations of each kernel
launch, bounds, percentiles, rates and the readers built on them."""

import importlib.util
import os

import pytest

from harness import arith, roofline, trace as tracing

METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind,g,wire,want", [
    # 4:2:0 RGB: 6*64*2 wire + 4 qidx + 3*4*64 out; 6 blocks of IDCT and
    # dequantize, 256 pixels of BT.601.
    ("rgb", 6, 2, (768 + 4 + 768, 6 * (1024 + 192) + 256 * 21)),
    ("rgb", 6, 1, (384 + 4 + 768, 6 * (1024 + 192) + 256 * 21)),
    # 4:4:4 RGB: 3 blocks, 64 pixels.
    ("rgb", 3, 2, (384 + 4 + 192, 3 * (1024 + 192) + 64 * 21)),
    # 4:2:0 YCbCr: 6 planes out, a level shift a sample.
    ("ycbcr", 6, 2, (768 + 4 + 384, 6 * (1024 + 192) + 384)),
])
def test_decode_mcu_counts(kind, g, wire, want):
    assert arith.decode_mcu_counts(kind, g, wire) == want


def test_epilogue_counts_and_bound_terms():
    # One B=256 batch of 256x256 4:2:0 to bfloat16.
    mcus, elems = 256 * 256, 256 * 256 * 256 * 3
    nbytes, flops = arith.epilogue_counts(mcus, 6, elems, 2)
    assert nbytes == 768 * mcus + 2 * elems
    assert flops == 2 * elems
    t, term = arith.bound_s(nbytes, flops, arith.FP32_FLOPS)
    assert term == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    t, term = arith.bound_s(1.0, 1e9, arith.INT32_OPS)
    assert term == "operations" and t == pytest.approx(1e9 / 33.5e12)


def test_percentile_and_rate_with_a_stall():
    """A stall inside the window moves the rate and the tail."""
    steady = [0.070] * 200
    stalled = [0.070] * 190 + [0.500] * 10
    assert arith.percentile(steady, 95) == pytest.approx(0.070)
    assert arith.percentile(stalled, 95) > 0.070
    assert arith.percentile([1, 2, 3, 4, 5], 50) == 3
    assert arith.percentile([0, 10], 95) == pytest.approx(9.5)
    images = 256 * 200
    assert arith.rate(images, sum(stalled)) < arith.rate(images, sum(steady))
    rec = {"latencies": stalled, "images": images,
           "seconds": sum(stalled)}
    assert reader("loader.batch_p95_ms").read(rec) > 70.0
    assert reader("loader.images_per_s").read(rec) == pytest.approx(
        images / sum(stalled))


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert arith.union_seconds(spans) == pytest.approx(3.0)
    assert arith.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 5.0)]


def _trace(kernels, window=(0.0, 1.0)):
    return tracing.Trace(window, kernels, [], [])


def test_roofline_counts_real_mcus_not_padding():
    """Two ycbcr launches of 16,384 MCUs (grid 512) carrying 24,576 real
    MCUs of 4:2:0 files at int16: the bound counts the real ones."""
    name = ("void (anonymous namespace)::ycbcr_kernel<short, 6, true>"
            "(short const*, int const*, int const*, int, unsigned char*, "
            "long long)")
    kernels = [tracing.Event(name, 0.1, 0.1 + 20e-6, (512, 1, 1)),
               tracing.Event(name, 0.2, 0.2 + 20e-6, (512, 1, 1))]
    rec = {"trace": _trace(kernels),
           "work": {"mcus": {6: 24576}, "images": {6: 32}}}
    bound, seconds, terms = roofline.decode_bounds(
        rec["trace"], rec, ("ycbcr_kernel",))
    nbytes, _ = arith.decode_mcu_counts("ycbcr", 6, 2)
    want = (24576 * nbytes + 32 * 6 * 64 * 4) / 3.35e12
    assert bound == pytest.approx(want) and set(terms) == {"bytes"}
    assert seconds == pytest.approx(40e-6)
    share = reader("ycbcr_kernel_roofline.engine").read(rec)
    assert share == pytest.approx(100 * want / 40e-6)


def test_roofline_reads_nothing_without_launches():
    rec = {"trace": _trace([]),
           "work": {"mcus": {}, "images": {}}}
    assert reader("ycbcr_kernel_roofline.engine").read(rec) is None
    assert reader("rgb_kernel_roofline.engine").read(rec) is None
    assert reader("ycbcr_kernel_roofline.engine").read(
        dict(rec, trace=None)) is None


def test_idle_share_and_breakdown():
    k = tracing.Event("void rgb_kernel<short, 2, 2, 3, true>(short const*)",
                      0.2, 0.3, (2048, 1, 1))
    host = [tracing.Event("perfbench.call", 0.0, 1.0),
            tracing.Event("aten::pin_memory", 0.4, 0.9)]
    tr = tracing.Trace((0.0, 1.0), [k], [], host)
    assert tr.busy_s() == pytest.approx(0.1)
    rec = {"trace": tr}
    assert reader("device.idle_share.loader").read(rec) == pytest.approx(90)
    bd = tracing.breakdown(tr)
    assert bd["device_ops"] == [["rgb_kernel<short, 2, 2, 3, true>",
                                 pytest.approx(0.1)]]
    assert bd["idle_gaps"][0] == ["aten::pin_memory", pytest.approx(0.7)]
    assert bd["idle_gaps"][1] == ["perfbench.call", pytest.approx(0.2)]
    # A short host operation in a gap names it over the call's span.
    host.append(tracing.Event("aten::empty", 0.05, 0.06))
    bd = tracing.breakdown(tracing.Trace((0.0, 1.0), [k], [], host))
    assert bd["idle_gaps"][1] == ["aten::empty", pytest.approx(0.2)]


def test_kernel_time_per_image_counts_kernels_alone(tmp_path):
    """Kernels count in full, overlaps included, clipped to the window;
    copies and memsets do not.  A trace of the device alone spans its
    first event to its last."""
    import json
    events = [
        {"ph": "X", "cat": "kernel", "name": "void rgb_kernel<short>()",
         "ts": 1000.0, "dur": 100.0, "args": {"grid": [8, 1, 1]}},
        {"ph": "X", "cat": "kernel", "name": "void raster_epilogue_kernel()",
         "ts": 1050.0, "dur": 350.0},
        {"ph": "X", "cat": "gpu_memcpy",
         "name": "Memcpy HtoD (Pinned -> Device)", "ts": 1400.0,
         "dur": 500.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 1950.0, "dur": 50.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    with pytest.raises(RuntimeError):
        tracing.load_chrome_trace(str(path))
    tr = tracing.load_chrome_trace(str(path), spans=False)
    assert tr.window == (pytest.approx(1000e-6), pytest.approx(2000e-6))
    assert tr.kernel_seconds() == pytest.approx(450e-6)
    clipped = tracing.Trace((1100e-6, 2000e-6), tr.kernels, tr.copies, [])
    assert clipped.kernel_seconds() == pytest.approx(300e-6)
    rec = {"trace": tr, "images": 9}
    assert reader("loader_kernel_us_per_image").read(rec) == pytest.approx(
        50.0)
    assert reader("loader_kernel_us_per_image").read(
        dict(rec, trace=None)) is None
    assert reader("loader_kernel_us_per_image").read(
        dict(rec, trace=tracing.Trace((0.0, 0.0), [], [], []))) is None
