"""The port's device lists against the JAX package's mesh, on the CPU.

The JAX side runs ``parallel.sharding.decode_mcus_sharded`` and the
``mesh=`` APIs on the virtual 8-device CPU mesh of ``tests/conftest.py``,
with the Pallas kernels in interpret mode and lane tiles of 8 (as
``__graft_entry__.dryrun_multichip`` does); the port runs the same seeded
inputs over lists of ``"cpu"`` devices (every shard through the kernels'
plain versions).  Tolerance 0 everywhere: the decode spec is integer.
"""

import datetime
import functools
import hashlib
import inspect
import os
import re

import jax
import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
from pim_jpeg_decoder_tpu.models import input_pipeline as JI
from pim_jpeg_decoder_tpu.models import pipeline as JP
from pim_jpeg_decoder_tpu.ops import specs as JS
from pim_jpeg_decoder_tpu.parallel import multihost as JM
from pim_jpeg_decoder_tpu.parallel.mesh import make_mesh as jax_mesh
from pim_jpeg_decoder_tpu.parallel.sharding import (
    decode_mcus_sharded as jax_sharded)
from pim_jpeg_decoder_tpu_torch.models import input_pipeline as TI
from pim_jpeg_decoder_tpu_torch.models import pipeline as TP
from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops import stage_kernels
from pim_jpeg_decoder_tpu_torch.parallel import mesh as M
from pim_jpeg_decoder_tpu_torch.parallel import multihost as MH
from pim_jpeg_decoder_tpu_torch.parallel import sharding as SH
from pim_jpeg_decoder_tpu_torch.runtime import engine as engine_module
from pim_jpeg_decoder_tpu_torch.runtime.batching import compact_wire
from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine

LANE_TILE = 8  # tiny tiles: interpret mode is slow
NS = (1, 2, 3, 8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "pim_jpeg_decoder_tpu_torch", "csrc")


def _cpus(n):
    return ["cpu"] * n


@pytest.fixture(scope="module", autouse=True)
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (conftest sets XLA_FLAGS)")


def _example_inputs(m):
    """``__graft_entry__._example_inputs``: 4:2:0, two images in the pool."""
    rng = np.random.default_rng(0)
    coeffs = rng.integers(-128, 128, (m, 6, 64)).astype(np.int16)
    qidx = (np.arange(m) % 2).astype(np.int32)
    qpool = np.ones((2, 6, 64), np.float32)
    qpool[1] *= 2
    return coeffs, qidx, qpool


@functools.lru_cache(maxsize=None)
def _jax_decode(n, raw, ycbcr, scale):
    coeffs, qidx, qpool = _example_inputs(n * LANE_TILE)
    return np.asarray(jax_sharded(
        coeffs, qidx, qpool, JS.mode_for((2, 2, 3)), mesh=jax_mesh(n),
        lane_tile=LANE_TILE, raw=raw, ycbcr=ycbcr, scale=scale))


# dryrun_multichip's checks 1, 2 and 4: (raw, ycbcr, scale).
KINDS = {"raw_rgb": (True, False, 1), "ycbcr": (False, True, 1),
         "scale2": (True, False, 2), "slot_major": (False, False, 1)}


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_decode_matches_jax(n, kind):
    raw, ycbcr, scale = KINDS[kind]
    coeffs, qidx, qpool = _example_inputs(n * LANE_TILE)
    outs = SH.decode_mcus_sharded(coeffs, qidx, qpool, S.mode_for((2, 2, 3)),
                                  _cpus(n), align=LANE_TILE, raw=raw,
                                  ycbcr=ycbcr, scale=scale)
    assert len(outs) == n
    axis = 0 if not (raw or ycbcr) else M.MCU_AXIS
    assert {o.shape[axis] for o in outs} == {LANE_TILE}
    got = SH.gather(outs, axis=axis).numpy()
    np.testing.assert_array_equal(got, _jax_decode(n, raw, ycbcr, scale))
    np.testing.assert_array_equal(
        SH.gather(outs, axis=axis, device="cpu").numpy(), got)


@pytest.mark.parametrize("n", NS)
def test_preplaced_int8_wire_matches_int16(n, monkeypatch):
    """dryrun_multichip check 3: the int8 wire, placed by place_for_mesh
    (the engine's producer side), decodes as the int16 wire does in the
    JAX package, and is not placed a second time."""
    coeffs, qidx, qpool = _example_inputs(n * LANE_TILE)
    small = np.clip(coeffs, -127, 127).astype(np.int16)
    wire = compact_wire(small)
    assert wire.dtype == np.int8
    devices = M.make_mesh(devices=_cpus(n))
    placed = SH.place_for_mesh(wire, qidx, qpool, devices, LANE_TILE)
    assert all(c.dtype == torch.int8 for c, _, _ in placed.shards)
    # One device repeated n times: the quantizer pool went there once.
    assert len({id(p) for _, _, p in placed.shards}) == 1
    calls = []
    monkeypatch.setattr(SH, "copy_to", lambda *a: calls.append(a))
    monkeypatch.setattr(SH, "place_for_mesh", lambda *a: calls.append(a))
    got = SH.gather(SH.decode_mcus_sharded(placed, None, None,
                                           S.mode_for((2, 2, 3)), devices,
                                           raw=True))
    assert not calls, "decode_mcus_sharded placed placed inputs again"
    want = np.asarray(jax_sharded(
        small, qidx, qpool, JS.mode_for((2, 2, 3)), mesh=jax_mesh(n),
        lane_tile=LANE_TILE, raw=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_placed_inputs_on_other_devices_raise():
    coeffs, qidx, qpool = _example_inputs(16)
    placed = SH.place_for_mesh(coeffs, qidx, qpool, M.make_mesh(
        devices=_cpus(2)))
    with pytest.raises(ValueError, match="placed on"):
        SH.decode_mcus_sharded(placed, None, None, S.mode_for((2, 2, 3)),
                               _cpus(4))


@pytest.mark.parametrize("n,align,m", [(8, LANE_TILE, 8), (3, 1, 8),
                                       (2, 8, 24)])
def test_shard_size_validation(n, align, m):
    with pytest.raises(ValueError, match=f"M={m} must be a multiple of "
                                         f"devices\\*align={n * align}"):
        SH.decode_mcus_sharded(np.zeros((m, 3, 64), np.int16),
                               np.zeros(m, np.int32),
                               np.ones((1, 3, 64), np.float32),
                               S.mode_for((1, 1, 3)), _cpus(n), align=align)


def test_a_failing_shard_raises(monkeypatch):
    """No shard falls back: the second shard's failure reaches the
    caller."""
    real, seen = SH.decode_mcus, []

    def flaky(*a, **kw):
        seen.append(1)
        if len(seen) == 2:
            raise RuntimeError("launch failed on shard 1")
        return real(*a, **kw)

    monkeypatch.setattr(SH, "decode_mcus", flaky)
    coeffs, qidx, qpool = _example_inputs(24)
    with pytest.raises(RuntimeError, match="shard 1"):
        SH.decode_mcus_sharded(coeffs, qidx, qpool, S.mode_for((2, 2, 3)),
                               _cpus(3))
    assert len(seen) == 2


# --- the APIs that take a device list ----------------------------------------

def _blobs(n_images, h, w, sampling="4:2:0", seed=5):
    """dryrun_multichip check 5's corpus: random pixels, quality 80-87."""
    rng = np.random.default_rng(seed)
    return [encode_jpeg(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                        quality=80 + i % 8, sampling=sampling)
            for i in range(n_images)]


@pytest.mark.parametrize("n", (2, 8))
@pytest.mark.parametrize("images", (1, 5))
def test_batch_api_matches_jax_mesh(n, images):
    """dryrun_multichip check 5 (and one image, fewer images than
    devices): the port's groups of whole images equal the JAX program on
    the mesh."""
    blobs = _blobs(images, 24, 40)
    got, headers = TI.decode_same_size_batch(blobs, device=_cpus(n))
    want, _ = JI.decode_same_size_batch(blobs, lane_tile=LANE_TILE,
                                        mesh=jax_mesh(n))
    assert got.shape == (images, 24, 40, 3) and len(headers) == images
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", (2, 8))
def test_crop_batches_match_jax_mesh(n):
    """Crops over a device list (mixed sizes; scale 2 with normalised
    bfloat16) equal the JAX crop programs on the mesh."""
    blobs = (_blobs(3, 40, 56, seed=6) + _blobs(2, 48, 64, seed=7))
    boxes = [(0, 0), (4, 8), (16, 24), (8, 30), (24, 16)]
    got, _ = TI.decode_batch_crops(blobs, boxes, (16, 24), device=_cpus(n))
    want, _ = JI.decode_batch_crops(blobs, boxes, (16, 24),
                                    lane_tile=LANE_TILE, mesh=jax_mesh(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same = blobs[:3]
    norm = dict(mean=128.0, std=64.0)
    got, _ = TI.decode_same_size_batch_crops(
        same, boxes[:3], (16, 24), scale=2, dtype=torch.bfloat16,
        device=_cpus(n), **norm)
    want, _ = JI.decode_same_size_batch_crops(
        same, boxes[:3], (16, 24), scale=2, dtype=jax.numpy.bfloat16,
        lane_tile=LANE_TILE, mesh=jax_mesh(n), **norm)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_streaming_apis_take_device_lists():
    blobs = _blobs(3, 24, 40)
    one = [o for o, _ in TI.iter_decode_batches([blobs, blobs[:2]],
                                                device="cpu")]
    many = [o for o, _ in TI.iter_decode_batches([blobs, blobs[:2]],
                                                 device=_cpus(3))]
    assert all(torch.equal(a, b) for a, b in zip(one, many))
    crops = [(blobs, [(0, 0), (8, 8), (0, 16)])]
    one = [o for o, _ in TI.iter_decode_batch_crops(crops, (16, 16),
                                                    device="cpu")]
    many = [o for o, _ in TI.iter_decode_batch_crops(crops, (16, 16),
                                                     device=_cpus(2))]
    assert torch.equal(one[0], many[0])


@pytest.mark.parametrize("batch,n,groups", [
    (5, 2, [(0, 3), (3, 5)]), (3, 8, [(0, 1), (1, 2), (2, 3)]),
    (6, 3, [(0, 2), (2, 4), (4, 6)]), (1, 1, [(0, 1)])])
def test_batch_groups_differ_by_at_most_one(batch, n, groups):
    assert TI._groups(batch, n) == groups


# The single-image APIs of tests/test_sharding.py's TestSingleImageMeshAPIs.
SINGLE = {
    "decoder_420": ("4:2:0", lambda d, dev: TP.TorchJpegDecoder(dev).decode(
        d).rgb, lambda d, mesh: JP.TpuJpegDecoder(
            lane_tile=LANE_TILE, mesh=mesh).decode(d).rgb),
    "decoder_444_rgb": ("4:4:4", lambda d, dev: TP.TorchJpegDecoder(
        dev).decode(d).rgb, lambda d, mesh: JP.TpuJpegDecoder(
            lane_tile=LANE_TILE, mesh=mesh).decode(d).rgb),
    "decode_scaled_2": ("4:2:0", lambda d, dev: TP.decode_scaled(d, 2, dev),
                        lambda d, mesh: JP.decode_scaled(
                            d, 2, lane_tile=LANE_TILE, mesh=mesh)),
    "decode_scaled_1": ("4:2:0", lambda d, dev: TP.decode_scaled(d, 1, dev),
                        lambda d, mesh: JP.decode_scaled(
                            d, 1, lane_tile=LANE_TILE, mesh=mesh)),
    "decode_region_422": ("4:2:2", lambda d, dev: TP.decode_region(
        d, 17, 23, 64, 48, dev), lambda d, mesh: JP.decode_region(
            d, 17, 23, 64, 48, lane_tile=LANE_TILE, mesh=mesh)),
}


@pytest.mark.parametrize("api", sorted(SINGLE))
def test_single_image_apis_match_jax_mesh(api, photo_image):
    sampling, port, ref = SINGLE[api]
    data = encode_jpeg(photo_image, quality=85, sampling=sampling)
    want = ref(data, jax_mesh(8))
    np.testing.assert_array_equal(port(data, _cpus(8)), want)
    np.testing.assert_array_equal(port(data, _cpus(3)), want)
    np.testing.assert_array_equal(port(data, "cpu"), want)


def test_decoder_decode_batch_and_slot_assembly(photo_image):
    """``TorchJpegDecoder.decode_batch`` and ``assemble_raster_slots``,
    the JAX package's, on a device list."""
    blobs = [encode_jpeg(photo_image, quality=q, sampling="4:2:0")
             for q in (70, 90)]
    got = TP.TorchJpegDecoder(_cpus(2)).decode_batch(blobs)
    want = JP.TpuJpegDecoder(lane_tile=LANE_TILE).decode_batch(blobs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.rgb, w.rgb)
    header = got[0].header
    mode = S.mode_for(header.mode_key)
    slots = TP._decode_grid(header, TP.entropy_decode(header), M.make_mesh(
        devices=_cpus(3)))
    assert slots.shape[1:] == (mode.luma_slots, 64, 3)
    np.testing.assert_array_equal(TP.assemble_raster_slots(header, slots),
                                  want[0].rgb)
    np.testing.assert_array_equal(
        TP.assemble_raster_slots(header, slots),
        JP.assemble_raster_slots(header, slots))


# --- the engine --------------------------------------------------------------

ENGINE_ENV = {"PIM_JPEG_TPU_BUDGET_MCUS": "128",
              "PIM_JPEG_TPU_LANE_TILE": "16",
              "PIM_JPEG_TPU_MAX_LAUNCH": "256",
              "PIM_JPEG_TPU_PREPARE_THREADS": "2"}


def _engine_corpus(root):
    rng = np.random.default_rng(11)
    specs = [("a420.jpg", (48, 64), "4:2:0"), ("b420.jpg", (40, 72), "4:2:0"),
             ("c444.jpg", (40, 56), "4:4:4"), ("d422.jpg", (37, 61), "4:2:2"),
             ("e420.jpg", (176, 208), "4:2:0"),    # 143 MCUs: dedicated
             ("f420.jpg", (300, 260), "4:2:0")]    # 323 MCUs: banded
    paths = []
    for name, (h, w), sampling in specs:
        img = np.kron(rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3)),
                      np.ones((8, 8, 1)))[:h, :w].astype(np.uint8)
        path = root / name
        path.write_bytes(encode_jpeg(img, quality=80, sampling=sampling))
        paths.append(str(path))
    return paths


def _digests(paths):
    return {os.path.basename(p): hashlib.sha1(
        open(os.path.splitext(p)[0] + ".bmp", "rb").read()).hexdigest()
        for p in paths}


@pytest.mark.parametrize("transport,scale", [("auto", 1), ("rgb", 1),
                                             ("auto", 2)])
def test_engine_two_cpu_devices_write_the_same_bmps(tmp_path, monkeypatch,
                                                    transport, scale):
    for k, v in ENGINE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("PIM_JPEG_TPU_TRANSPORT", transport)
    monkeypatch.setenv("PIM_JPEG_TPU_SCALE", str(scale))
    paths = _engine_corpus(tmp_path)
    one = DecodeEngine(device="cpu").decode_paths(paths)
    want = _digests(paths)
    windows = []
    real = SH.mcu_window

    def spy(shards, off, count, **kw):
        out = real(shards, off, count, **kw)
        windows.append(not any(out[0] is s for s in shards))
        return out

    monkeypatch.setattr("pim_jpeg_decoder_tpu_torch.runtime.engine."
                        "mcu_window", spy)
    engine = DecodeEngine(device=["cpu", "cpu"])
    assert engine.batch_align == 32 and engine.budget_mcus == 128
    two = engine.decode_paths(paths)
    assert one.ok_count == two.ok_count == len(paths)
    assert _digests(paths) == want
    assert any(windows), "no image straddled the two shards"
    assert two.one_device_batches == 0 and two.devices == engine.devices
    # The profile's launch geometry is a shard's: M / 2 (launches of 128
    # and 256 MCUs on one device, aligned to both 16 and 32).
    assert {k[1] for k in two.launch_stats} == {
        k[1] // 2 for k in one.launch_stats} == {64, 128}


def test_engine_counts_batches_left_on_one_device(tmp_path, monkeypatch):
    """A batch whose M is no multiple of devices x lane_tile runs whole on
    the first device (the JAX engine's rule), and the profile counts it."""
    for k, v in ENGINE_ENV.items():
        monkeypatch.setenv(k, v)
    paths = _engine_corpus(tmp_path)[:2]
    engine = DecodeEngine(device=["cpu", "cpu"])
    # Launches of 128 MCUs (the budget), unaligned, against an alignment
    # they do not divide by.
    router = engine_module.ModeRouter
    monkeypatch.setattr(engine_module, "ModeRouter",
                        lambda budget, max_images, align: router(
                            budget, max_images, align=1))
    engine.batch_align = 3 * engine.lane_tile
    report = engine.decode_paths(paths)
    assert report.ok_count == 2
    assert report.one_device_batches == sum(report.launch_stats.values()) > 0


def test_cli_banner_counts_the_engines_devices(tmp_path, capsys,
                                                monkeypatch):
    from pim_jpeg_decoder_tpu_torch.cli import main

    monkeypatch.setattr(DecodeEngine, "__init__", _two_cpu_init)
    path = _engine_corpus(tmp_path)[0]
    assert main([path, "--device", "cpu", "--no-write"]) == 0
    out = capsys.readouterr().out
    assert "2 cpu device(s) allocated (cpu: host CPU, cpu: host CPU)" in out
    assert "Batches on one of the 2 devices" in out


_REAL_INIT = DecodeEngine.__init__


def _two_cpu_init(self, *args, device="cuda", **kw):
    _REAL_INIT(self, *args, device=[device, device], **kw)


# --- mesh, multihost ---------------------------------------------------------

def test_make_mesh_rules():
    assert M.make_mesh(devices=["cpu"] * 3) == (torch.device("cpu"),) * 3
    assert M.make_mesh(2, devices=["cpu"] * 3) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="num_devices must be >= 1, got 0"):
        M.make_mesh(0, devices=["cpu"])
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        M.make_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="unsupported device"):
        M.make_mesh(devices=["meta"])
    assert M.devices_of("cpu") == (torch.device("cpu"),)
    assert M.devices_of(("cpu", "cpu"), 1) == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            M.make_mesh()
        for devices in (["cuda:0"], ["cpu", "cuda:1"]):
            with pytest.raises(RuntimeError, match="is_available"):
                TP.TorchJpegDecoder(devices)


@pytest.mark.parametrize("shard_sizes,off,count,joined", [
    ((8, 8), 0, 8, False), ((8, 8), 3, 4, False), ((8, 8), 8, 8, False),
    ((8, 8), 6, 4, True), ((4, 4, 4), 2, 9, True), ((5, 3, 8), 5, 3, False),
    ((5, 3, 8), 4, 12, True)])
def test_mcu_window(shard_sizes, off, count, joined):
    full = np.arange(3 * 2 * sum(shard_sizes)).reshape(3, 2, -1)
    bounds = np.cumsum((0,) + shard_sizes)
    shards = [np.ascontiguousarray(full[..., a:b])
              for a, b in zip(bounds[:-1], bounds[1:])]
    arr, local = SH.mcu_window(shards, off, count)
    assert any(arr is s for s in shards) is not joined
    np.testing.assert_array_equal(arr[..., local:local + count],
                                  full[..., off:off + count])
    with pytest.raises(ValueError, match="outside"):
        SH.mcu_window(shards, sum(shard_sizes) - 1, 2)


def test_partition_paths_strided_and_as_jax():
    paths = [f"f{i}" for i in range(10)]
    shards = [MH.partition_paths(paths, i, 3) for i in range(3)]
    assert sorted(sum(shards, [])) == sorted(paths)
    assert sorted(len(s) for s in shards) == [3, 3, 4]
    for n in (1, 2, 3, 4, 11):
        for i in range(n):
            assert (MH.partition_paths(paths, i, n)
                    == JM.partition_paths(paths, i, n))
    # Not in a process group: process 0 of 1 takes everything.
    assert MH.process_index() == 0 and MH.process_count() == 1
    assert MH.partition_paths(paths) == paths
    assert MH.local_chip_count() == torch.cuda.device_count()


GATING_VARS = ("SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID",
               "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "WORLD_SIZE",
               "RANK", "MASTER_ADDR", "MASTER_PORT")
MASTER = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500"}


@pytest.mark.parametrize("env,kwargs,want", [
    ({}, {}, None),
    ({"SLURM_JOB_ID": "123"}, {}, None),
    ({"SLURM_JOB_ID": "123", "SLURM_NTASKS": "1"}, {}, None),
    ({"OMPI_COMM_WORLD_SIZE": "1"}, {}, None),
    ({"WORLD_SIZE": "1", **MASTER}, {}, None),
    ({"SLURM_NTASKS": "4", **MASTER}, {"num_processes": 1}, None),
    ({"SLURM_JOB_ID": "123", "SLURM_NTASKS": "4", "SLURM_PROCID": "2",
      **MASTER}, {}, ("10.0.0.1:29500", 4, 2)),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1", **MASTER},
     {}, ("10.0.0.1:29500", 2, 1)),
    ({"WORLD_SIZE": "3", "RANK": "2", **MASTER}, {},
     ("10.0.0.1:29500", 3, 2)),
    ({}, {"coordinator_address": "localhost:1234", "num_processes": 2,
          "process_id": 1}, ("localhost:1234", 2, 1)),
    ({"SLURM_NTASKS": "2"}, {}, "MASTER_ADDR"),
    ({}, {"coordinator_address": "localhost:1234"}, "without num_processes"),
])
def test_initialize_distributed_gating(monkeypatch, env, kwargs, want):
    """Only markers of a multi-process job join the group (a bare Slurm or
    MPI allocation of one task must not block waiting for ranks)."""
    for var in GATING_VARS:
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(MH.dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    if isinstance(want, str):
        with pytest.raises((RuntimeError, ValueError), match=want):
            MH.initialize_distributed(**kwargs)
        assert calls == []
        return
    MH.initialize_distributed(**kwargs)
    if want is None:
        assert calls == []
        return
    (args, kw), = calls
    addr, size, rank = want
    assert args == ("gloo",)
    assert kw == {"init_method": f"tcp://{addr}", "world_size": size,
                  "rank": rank, "timeout": datetime.timedelta(minutes=5)}


# --- launchers prepare kernels once per device -----------------------------

def test_kernel_attributes_are_prepared_per_device():
    """Function attributes act on the current device only: no launcher in
    csrc/ keeps a once-per-process ``static const cudaError_t``; each keeps
    a per-device table (``PerDevice``, keyed by ``cudaGetDevice``).  And
    each wrapper of this path's kernels launches under
    ``torch.cuda.device`` of its tensors, so the ordinal is theirs."""
    sources = {}
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name)) as f:
                sources[name] = f.read()
    offenders = [n for n, src in sources.items()
                 if re.search(r"static\s+const\s+cudaError_t", src)]
    assert offenders == []
    uses = {n: len(re.findall(r"static PerDevice \w+;", src))
            for n, src in sources.items()}
    assert uses == {**{n: 0 for n in sources}, "decode_kernel.cu": 1,
                    "kernel_opt.cu": 2, "mxu_idct.cu": 1,
                    "raster_epilogue.cu": 1, "stage_kernels.cu": 2,
                    "vlc.cu": 1}
    assert "cudaGetDevice(&device)" in sources["decode_tile.cuh"]
    assert len(re.findall(r"cudaFuncSetAttribute\(",
                          "".join(sources.values()))) == 4
    for fn in (K._launch, K.raster_epilogue, stage_kernels._launch):
        assert "with torch.cuda.device(" in inspect.getsource(fn), fn
