"""The half-scale loader's cell on the CPU at a small size: its reference
decoder equals the program's oracle, its counts are the hand count, the
comparison that decides ``correct`` passes on the program and fails on the
control and on a timed path broken three ways, and its new readers read a
traced run and nothing where the program has nothing to give."""

import copy
import importlib.util
import os
import time

import numpy as np
import pytest

WORKLOAD = "loader-laion512-scale2"
METRICS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "metrics")
NEW = ("rgb_scaled_kernel_roofline.scale2",
       "raster_epilogue_kernel_roofline.scale2", "scale2.read_coef_share")


def small_scaled_cell(size=(40, 56)):
    """``(traffic, config)`` of the cell at a size the CPU runs in a few
    seconds: 6 files of ``size``, batches of 4."""
    from harness import spec
    cell = spec.load_cell(WORKLOAD)
    traffic = copy.deepcopy(cell.traffic)
    config = copy.deepcopy(cell.config)
    (group,) = traffic["groups"]
    group["count"] = 6
    group["height"], group["width"] = size
    traffic["items_per_call"] = 4
    traffic["warm_calls"] = 1
    config["batch"] = 4
    return traffic, config


def run_scaled(trace=False, control=False, seed=2**33 + 7, seconds=0.5,
               size=(40, 56)):
    from harness import cell
    traffic, config = small_scaled_cell(size)
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
    from harness import reference, spec
    cell = spec.load_cell(WORKLOAD)
    assert cell.chips == 1 and cell.config["entry"] == "scaled_loader"
    assert cell.config["scale"] == 2 and cell.config["batch"] == 256
    assert {m["name"] for m in cell.end_to_end} == {
        "loader_kernel_us_per_image", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    assert reference.module_name(cell.traffic, cell.config) == (
        "jpeg_ref_scaled")
    (group,) = cell.traffic["groups"]
    assert (group["count"], group["height"], group["width"],
            group["sampling"], group["quality"]) == (512, 512, 512, "4:2:0",
                                                     95)
    assert cell.traffic["items_per_call"] == 256
    for other in ("loader-laion256", "loader-imagenet-crops"):
        assert not set(NEW) & set(spec.load_cell(other).readers)


def test_names_stay_unique_and_every_cell_loads():
    """``test_perfbench_crops``'s check of the same name over the benchmark
    as it now stands, three cells (that test pins the list to the two
    before this one): no name twice in a section across the benchmark and
    the held-back cells, the held-back cells load with their own metrics,
    and the benchmark's cells with none of them."""
    import json

    from harness import spec
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(spec.HELD_BACK) as f:
        held = json.load(f)
    ours = [w["name"] for w in bench["workloads"]]
    back = {w["name"] for w in held["workloads"]}
    assert ours == ["loader-laion256", "loader-imagenet-crops", WORKLOAD]
    assert not set(ours) & back and set(held["why"]) == back
    for section in spec.SECTIONS:
        names = [e["name"] for e in bench[section] + held[section]]
        assert len(names) == len(set(names)), section
    engine = spec.load_cell("engine-imagenet-val")
    assert "engine.prepare_ms_per_mp" in engine.readers
    for name in ours:
        cell = spec.load_cell(name)
        assert "engine_mp_per_s" not in cell.readers
        assert not any(m["name"].startswith("engine")
                       for m in cell.per_layer)


def _pil_file(rng, h, w, sampling, quality=90):
    from harness import corpus
    img = np.clip(rng.normal(128, 50, (h, w, 3)), 0, 255).astype(np.uint8)
    if sampling == "gray":
        import io
        buf = io.BytesIO()
        corpus.pil_image().fromarray(img).convert("L").save(
            buf, "JPEG", quality=quality)
        return buf.getvalue()
    return corpus.encode(img, sampling, quality, 0)


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "4:2:2", "gray"])
def test_reference_equals_the_programs_oracle(sampling):
    """``jpeg_ref_scaled`` against the program's NumPy oracle, pixel for
    pixel, at scales 2, 4 and 8, on seeded files whose sizes are no
    multiple of their MCU, noisy enough to reach the clamps."""
    from harness import jpeg_ref_scaled

    from pim_jpeg_decoder_tpu_torch.oracle.decoder import decode_scaled_oracle
    rng = np.random.default_rng(11)
    for h, w in ((37, 53), (64, 48)):
        data = _pil_file(rng, h, w, sampling)
        for scale in (1, 2, 4, 8):
            got = jpeg_ref_scaled.decode_rgb(data, "int", scale)
            assert got.shape == (-(-h // scale), -(-w // scale), 3)
            assert np.array_equal(got, decode_scaled_oracle(data, scale)), (
                h, w, scale)


def test_reference_equals_the_oracle_on_the_cells_own_file():
    """One 512x512 4:2:0 q95 file from the cell's own generator."""
    import torch

    from harness import corpus, jpeg_ref_scaled, spec

    from pim_jpeg_decoder_tpu_torch.oracle.decoder import decode_scaled_oracle
    traffic = copy.deepcopy(spec.load_cell(WORKLOAD).traffic)
    traffic["groups"][0]["count"] = 1
    (f,) = corpus.build_corpus(torch, traffic, 3 * 2**31 + 5, "cpu")
    assert (f.height, f.width, f.sampling) == (512, 512, "4:2:0")
    got = jpeg_ref_scaled.decode_rgb(f.data, "int", 2)
    assert got.shape == (256, 256, 3)
    assert np.array_equal(got, decode_scaled_oracle(f.data, 2))


def test_reference_wraps_as_int32():
    """A block of extreme coefficients: pass 2's sums leave int32's range,
    and the reference wraps them as the definition's int32 arithmetic
    does (the program's oracle computes in int32)."""
    from harness import jpeg_ref_scaled

    from pim_jpeg_decoder_tpu_torch.oracle.idct import reduced_idct_blocks
    rng = np.random.default_rng(5)
    deq = rng.choice([-32768, 32767], size=(64, 8, 8)).astype(np.int32)
    for ny, nx in ((4, 4), (8, 8), (8, 4), (2, 2), (1, 1)):
        assert np.array_equal(jpeg_ref_scaled.reduced_idct(deq, ny, nx),
                              reduced_idct_blocks(deq, ny, nx))


def test_counts_of_one_mcu_by_hand():
    """One 4:2:0 MCU at scale 2 (n = 4): four luma blocks read rows 0-3
    (32 bytes at int8: one sector; 64 at int16), two chroma blocks all 8
    rows (64, 128); 4 bytes of quantizer index; 3 x 4 x 16 bytes out.
    Operations: 4-point passes 14 a sum, 8-point 50; a 4x4 IDCT 4 x (14 +
    8) x 2 + 32 = 208, an 8x8 one 8 x (50 + 16) x 2 + 128 = 1,184;
    dequantize 3 x 192; BT.601 21 x 64."""
    from harness import arith, arith_scaled
    assert arith_scaled.reduced_pass_ops(4) == 14
    assert arith_scaled.reduced_pass_ops(8) == 50
    assert arith_scaled.reduced_idct_ops(4, 4) == 208
    assert arith_scaled.reduced_idct_ops(8, 8) == 1184
    ops = 4 * 208 + 2 * 1184 + 3 * (4 * 16 + 2 * 64) + 21 * 64
    assert arith_scaled.decode_mcu_counts(2, 2, 3, 4, 1) == (
        4 * 32 + 2 * 64 + 4 + 192, ops)
    assert arith_scaled.decode_mcu_counts(2, 2, 3, 4, 2) == (
        4 * 64 + 2 * 128 + 4 + 192, ops)
    assert ops == 5120
    assert arith_scaled.coefs_read(2, 2, 3, 4) == 192   # of 384: 50%
    # PERF.md's recount of the scaled decode (M = 196,608, int8, a 16-row
    # pool): 30.05 us, bound by operations.
    nbytes, ops = arith_scaled.decode_mcu_counts(2, 2, 3, 4, 1)
    t, term = arith.bound_s(196608 * nbytes + 16 * arith.quantizer_bytes(6),
                            196608 * ops, arith.INT32_OPS)
    assert term == "operations" and round(t * 1e6, 2) == 30.05
    # The epilogue: 192 bytes an MCU in, the bf16 batch out, 2 FLOPs an
    # element.
    assert arith_scaled.epilogue_counts(10, 4, 4, 300, 2) == (
        10 * 192 + 600, 600)


@pytest.mark.parametrize("seed", [2**33 + 7, 3 * 2**31 + 5])
def test_program_matches_reference(seed):
    out = run_scaled(seed=seed)
    assert out.result["correct"], out.result["compared"]
    assert out.result["attempted"] > 0 and out.result["failed"] == 0
    assert out.result["compared"]["max_ulp_gap"]["value"] == 0


def test_control_fails():
    out = run_scaled(control=True)
    assert out.control["max_ulp_gap"] > 0, out.control


def _box_filtered(monkeypatch):
    """The batch decoded at scale 1 and box-filtered 2x2 (rounded), then
    normalised: a resize, not the reduced IDCT."""
    import torch

    from pim_jpeg_decoder_tpu_torch.models import input_pipeline as T
    original = T.iter_decode_batches

    def resized(blob_batches, scale=1, dtype=None, mean=None, std=None,
                **kwargs):
        for out, headers in original(blob_batches, scale=1, **kwargs):
            x = torch.nn.functional.avg_pool2d(
                out.permute(0, 3, 1, 2).to(torch.float32), scale,
                ceil_mode=True).round().permute(0, 2, 3, 1)
            x = (x - torch.tensor(mean)) / torch.tensor(std)
            yield x.to(dtype), headers
    monkeypatch.setattr(T, "iter_decode_batches", resized)


def _chroma_from_4_points(monkeypatch):
    """Chroma through the luma's 4-point IDCT, then upsampled 2x2 (nearest)
    in place of its 8-point one."""
    import torch

    from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
    original = K._scaled_samples

    def upsampled(deq, mode, n):
        luma, cb, cr = original(deq, mode, n)
        if mode.ncomp == 1:
            return luma, cb, cr
        m, gy = deq.shape[0], mode.luma_slots
        small = K._reduced_idct(deq[:, gy:], n, n)            # [M, 2, px, py]
        chroma = small.repeat_interleave(mode.h, dim=-2).repeat_interleave(
            mode.v, dim=-1)
        regions = []
        for s in range(gy):
            qv, qh = mode.luma_slot_pos(s)
            regions.append(chroma[:, :, qh * n:(qh + 1) * n,
                                  qv * n:(qv + 1) * n].reshape(m, 2, n * n))
        cbcr = torch.stack(regions, dim=2)
        return luma, cbcr[:, 0], cbcr[:, 1]
    monkeypatch.setattr(K, "_scaled_samples", upsampled)


def _pass2_one_bit_short(monkeypatch):
    """The reduced IDCT's second pass descaled by one bit less."""
    import torch

    from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
    from pim_jpeg_decoder_tpu_torch.ops import specs as S

    def short(deq, ny, nx):
        rows1 = K._reduced_pass([deq[..., v, :nx] for v in range(ny)],
                                S.reduced_idct_matrix(ny),
                                S.CONST_BITS - S.PASS1_BITS)
        y = torch.stack(rows1, dim=-1)
        cols2 = K._reduced_pass([y[..., u, :] for u in range(nx)],
                                S.reduced_idct_matrix(nx),
                                S.CONST_BITS + S.PASS1_BITS - 1)
        return torch.stack(cols2, dim=-2).clamp(S.SAMPLE_MIN, S.SAMPLE_MAX)
    monkeypatch.setattr(K, "_reduced_idct", short)


@pytest.mark.parametrize("fault", [_box_filtered, _chroma_from_4_points,
                                   _pass2_one_bit_short],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_scaled()
    assert not out.result["correct"], (fault.__name__,
                                       out.result["compared"])


def test_work_counts_the_files_mcus_and_the_scaled_output():
    """The window's work: every file's 3 x 4 MCUs (40x56 at 4:2:0), the
    scale, and 20 x 28 x 3 elements an image; the files' own
    megapixels."""
    import torch

    from harness import corpus, spec
    cell = spec.load_cell(WORKLOAD)
    traffic, config = small_scaled_cell()
    seed = 2**35 + 1
    files = corpus.build_corpus(torch, traffic, seed, "cpu")
    entry = cell.entry(torch, config, traffic, files,
                       corpus.calls(traffic, len(files), seed),
                       torch.device("cpu"), False, np.random.default_rng(0))
    win = entry.window(0.2, False)
    images = win["images"]
    assert win["failed"] == 0 and images > 0
    assert win["work"]["mcus"] == {6: images * 12}
    assert win["work"]["scale"] == 2
    assert win["work"]["out_elements"] == images * 20 * 28 * 3
    assert win["megapixels"] == pytest.approx(images * 40 * 56 / 1e6)
    assert win["counters"] == {}


REC = {"seconds": 50.0, "images": 1000, "attempted": 4,
       "counters": {"scale.coefs_shipped": 3840, "scale.coefs_read": 1920}}


def test_read_share_reads_a_made_up_window():
    assert reader("scale2.read_coef_share").read(REC) == pytest.approx(50.0)


def test_readers_read_nothing_from_a_program_without_counters_or_trace():
    """The parent of the change that added the counters gives none; an
    untraced run has no trace: the readers read nothing and raise
    nothing."""
    rec = dict(REC, counters={}, trace=None,
               work={"mcus": {6: 10}, "images": {6: 1}, "out_elements": 6,
                     "out_bytes": 2, "scale": 2})
    assert reader("scale2.read_coef_share").read(rec) is None
    assert reader("scale2.read_coef_share").read(
        {k: v for k, v in rec.items() if k != "counters"}) is None
    for name in NEW[:2]:
        assert reader(name).read(rec) is None


class _Trace:
    """Launches of a made-up window: each kernel's (template arguments,
    event)."""

    def __init__(self, launches):
        self._launches = launches

    def launches(self, kernel):
        return self._launches.get(kernel, [])


def _event(seconds, grid=1):
    return type("E", (), {"seconds": seconds, "grid": (grid,)})()


def test_rooflines_of_a_made_up_window():
    """Two B=2 batches of 512x512 4:2:0 (1,024 MCUs an image) on the int16
    wire, each launch 64 tiles of 32 MCUs; each epilogue writing 2 x 256 x
    256 x 3 bf16."""
    from harness import arith, arith_scaled
    work = {"mcus": {6: 4096}, "images": {6: 4},
            "out_elements": 4 * 256 * 256 * 3, "out_bytes": 2, "scale": 2}
    args = ["short", "2", "2", "3", "4", "true"]
    trace = _Trace({
        "rgb_scaled_kernel": [(args, _event(1e-5, 64)),
                              (args, _event(1e-5, 64))],
        "raster_epilogue_kernel": [([], _event(2e-5)), ([], _event(2e-5))]})
    rec = {"trace": trace, "work": work}
    nbytes, ops = arith_scaled.decode_mcu_counts(2, 2, 3, 4, 2)
    want, _ = arith.bound_s(4096 * nbytes + 4 * arith.quantizer_bytes(6),
                            4096 * ops, arith.INT32_OPS)
    assert reader(NEW[0]).read(rec) == pytest.approx(100 * want / 2e-5)
    eb = 4096 * 3 * 4 * 16 + 4 * 256 * 256 * 3 * 2
    assert reader(NEW[1]).read(rec) == pytest.approx(
        100 * eb / arith.HBM_BYTES_PER_S / 4e-5)


def test_a_traced_run_reports_the_read_share():
    out = run_scaled(trace=True)
    assert out.result["correct"]
    metrics = out.result["metrics"]
    # 4:2:0: the reduced IDCT reads 16 of a luma block's 64 and all of a
    # chroma block's.
    assert metrics["scale2.read_coef_share"]["value"] == pytest.approx(50.0)
    # No device here: the rooflines have no trace of a card to read.
    assert not set(NEW[:2]) & set(metrics)


@pytest.mark.card
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_on_the_card(card, trace):
    """The cell at its full size on a card, 3 s windows: correct, on the
    H100, with every metric it lists; traced, the read share of 4:2:0."""
    import json
    import subprocess
    import sys

    from harness import spec
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.HERE, "run.py"), "--workload",
         WORKLOAD, "--seed", str(2**31 + 13), "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, timeout=600,
        cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert "H100" in line["device"]["kind"]
    cell = spec.load_cell(WORKLOAD)
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} <= set(line["metrics"])
    if trace:
        assert line["metrics"]["scale2.read_coef_share"]["value"] == 50.0
