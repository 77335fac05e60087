"""The scaled decode's launch plan on the CPU.

``scaled_plan`` decides how many CUDA blocks a launch of
``rgb_scaled_kernel`` (``csrc/decode_kernel.cu``) takes: a block a tile
while the tiles fit in one wave of resident blocks, or where the kernel's
form never walks tiles, else as many blocks as the card holds of that
form, each walking several tiles (block b the tiles b, b + blocks, ...),
the next tile's copy streaming in meanwhile, counted in
``launch_counts()["rgb_scaled_looped"]``.  The kernel itself is held
against its plain version on the card by chip_smoke.py."""

import importlib.util
import os
import re
import types

import pytest
import torch

from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import specs as S

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pim_jpeg_decoder_tpu_torch", "csrc")
# Resident blocks of a form on an H100's 132 SMs: 4:2:0 and 4:4:0 scale 2
# int16 (5 blocks an SM), one of 8 an SM, a form that never walks its tiles
# (0: its tile copies too little); then a one-SM card.
CARDS = (660, 1056, 0, 1)
# The half-scale cell's launch, a CLI launch, ragged launches above a wave.
MS = (1, 31, 32, 33, 16384, 16385, 21121, 100003, 131091, 196608, 262144)


def _tiles(m: int) -> int:
    return -(-m // K.TILE_MCUS)


def _visits(num_mcus: int, blocks: int):
    """The tiles each block walks in the kernel's loop."""
    return [list(range(b, _tiles(num_mcus), blocks)) for b in range(blocks)]


@pytest.mark.parametrize("resident", CARDS)
@pytest.mark.parametrize("m", MS)
def test_every_tile_once(m, resident):
    """Every tile is walked by exactly one block (the ragged last one
    too), and no block walks more than the plan's tiles a block."""
    blocks, per = K.scaled_plan(m, resident)
    walked = [t for ts in _visits(m, blocks) for t in ts]
    assert sorted(walked) == list(range(_tiles(m)))
    assert max(len(ts) for ts in _visits(m, blocks)) == per
    assert 1 <= blocks <= _tiles(m)


@pytest.mark.parametrize("m,resident", [
    (m, r) for r in CARDS for m in MS if _tiles(m) <= r or r == 0])
def test_one_tile_a_block_within_a_wave(m, resident):
    """A launch whose tiles fit in one wave (the CLI's 16,384-MCU
    launches, 512 tiles, among them), or of a form that never walks its
    tiles, keeps a block a tile."""
    assert K.scaled_plan(m, resident) == (_tiles(m), 1)


@pytest.mark.parametrize("m,resident", [
    (m, r) for r in CARDS for m in MS if 0 < r < _tiles(m)])
def test_blocks_loop_above_a_wave(m, resident):
    """Above one wave every resident block, each walking ceil(tiles /
    blocks) tiles or one fewer: fewer blocks would leave an SM short of
    its share."""
    blocks, per = K.scaled_plan(m, resident)
    assert per > 1 and blocks == resident
    assert per == -(-_tiles(m) // blocks)
    assert min(len(ts) for ts in _visits(m, blocks)) >= per - 1


def test_the_cells_launch_loops_on_an_h100():
    """The half-scale cell's B=256 launch (M = 262,144 at 4:2:0 int16,
    8,192 tiles) on 660 resident blocks: 660 blocks of 12 or 13 tiles; a
    CLI launch of 16,384 MCUs, a block a tile."""
    assert K.scaled_plan(262144, 660) == (660, 13)
    assert K.scaled_plan(16384, 660) == (512, 1)


def test_the_loop_is_the_kernels():
    """The kernel walks tiles blockIdx.x, + gridDim.x, ... as ``_visits``
    models, and the launcher takes the wrapper's block count."""
    with open(os.path.join(CSRC, "decode_kernel.cu")) as f:
        source = f.read()
    kernel = source[source.index("rgb_scaled_kernel(const T*"):]
    assert "const long long step = gridDim.x;" in kernel
    assert re.search(r"for \(long long t = blockIdx\.x; t < tiles; "
                     r"t \+= step, \+\+j\)", kernel)
    assert "blocks = static_cast<unsigned>(a.blocks);" in source


class _Lib:
    """Stands in for the CUDA library: launches succeed and are recorded;
    the card holds ``resident`` blocks of every scaled form."""

    def __init__(self, resident: int):
        self.resident, self.launches = resident, []

    def pjt_cuda_rgb_scaled_resident(self, *args):
        args[-1]._obj.value = self.resident
        return 0

    def pjt_cuda_decode_rgb_scaled(self, *args):
        self.launches.append(args)
        return 0

    def __getattr__(self, name):
        return lambda *args: 0


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_card(monkeypatch):
    """``decode_kernel._launch`` on CPU tensors against a stand-in library
    of a card of the given size (the resident-block cache cleared)."""
    from pim_jpeg_decoder_tpu_torch.ops import _build

    monkeypatch.setattr(torch.cuda, "device", lambda d: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def make(resident: int) -> _Lib:
        lib = _Lib(resident)
        monkeypatch.setattr(_build, "load", lambda: lib)
        K._scaled_resident.cache_clear()
        return lib

    yield make
    K._scaled_resident.cache_clear()


@pytest.mark.parametrize("key,m,scale,resident,looped", [
    ((2, 2, 3), 262144, 2, 660, 1),     # the half-scale cell's launch
    ((2, 2, 3), 16384, 2, 660, 0),      # a CLI --scale 2 launch
    ((2, 2, 3), 131091, 2, 660, 1),     # ragged, byte stores
    ((2, 2, 3), 660 * 32, 2, 660, 0),   # one whole wave
    ((2, 2, 3), 660 * 32 + 1, 2, 660, 1),
    ((2, 2, 3), 262144, 2, 0, 0),       # a form that never walks
    ((1, 1, 1), 100003, 4, 1056, 1),
    ((1, 1, 3), 33, 8, 1, 1),
    ((1, 1, 3), 32, 8, 1, 0)])
def test_looped_counts_the_launches_that_loop(fake_card, key, m, scale,
                                              resident, looped):
    """``rgb_scaled_looped`` counts exactly the ``rgb_scaled`` launches
    whose blocks walk more than one tile, and the launch gets the plan's
    block count."""
    lib = fake_card(resident)
    mode = S.mode_for(key)
    coeffs = torch.zeros((m, mode.g, 64), dtype=torch.int16)
    qidx = torch.zeros(m, dtype=torch.int32)
    qpool = torch.ones((1, mode.g, 64), dtype=torch.int32)
    before = K.launch_counts()
    K._launch(coeffs, qidx, qpool, mode, False, scale)
    after = K.launch_counts()
    assert after["rgb_scaled"] == before["rgb_scaled"] + 1
    assert after["rgb_scaled_looped"] == before["rgb_scaled_looped"] + looped
    (args,) = lib.launches
    assert args[-2] == K.scaled_plan(m, resident)[0]
    assert args[-3] == scale


def test_full_scale_launches_never_loop(fake_card):
    fake_card(1)
    mode = S.mode_for((2, 2, 3))
    coeffs = torch.zeros((1000, mode.g, 64), dtype=torch.int8)
    before = K.launch_counts()
    for ycbcr in (False, True):
        K._launch(coeffs, torch.zeros(1000, dtype=torch.int32),
                  torch.ones((1, mode.g, 64), dtype=torch.int32), mode,
                  ycbcr, 1)
    after = K.launch_counts()
    assert after["rgb_scaled_looped"] == before["rgb_scaled_looped"]
    assert after["rgb"] + after["ycbcr"] == before["rgb"] + before["ycbcr"] + 2


def _copy_bytes(key, scale: int, wire: int) -> int:
    """A scaled tile's copy of wire rows in shared memory, as ScaledLayout
    counts it: 16-byte chunks of the rows the reduced IDCT reads, MCUs an
    odd number of chunks apart."""
    mode = S.mode_for(key)
    n = 8 // scale
    luma = -(-n * 8 * wire // 16)
    chroma = -(-mode.v * n * 8 * wire // 16)
    chunks = mode.luma_slots * luma + (mode.g - mode.luma_slots) * chroma
    return K.TILE_MCUS * (chunks | 1) * 16


def test_only_tiles_that_copy_much_are_walked():
    """``WALK_MIN_COPY_BYTES``: of every mode, scale and wire, only 4:2:0
    and 4:4:0 at scale 2 on the int16 wire copy enough a tile for the walk
    to pay on an H100."""
    with open(os.path.join(CSRC, "decode_kernel.cu")) as f:
        source = f.read()
    least = eval(re.search(r"constexpr int WALK_MIN_COPY_BYTES = ([^;]+);",
                           source).group(1))
    assert "kWalks = kCopyBytes >= WALK_MIN_COPY_BYTES" in source
    walked = {(S.mode_for(key).name, scale, wire)
              for key in S.MODES for scale in (2, 4, 8) for wire in (1, 2)
              if _copy_bytes(key, scale, wire) >= least}
    assert walked == {("4:2:0", 2, 2), ("4:4:0", 2, 2)}
    assert _copy_bytes((2, 2, 3), 2, 2) == 16896


def _chip_smoke():
    path = os.path.join(os.path.dirname(CSRC), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("key,scale,m", [
    ((2, 2, 3), 2, 262144),    # the half-scale cell's own launch
    ((1, 2, 3), 2, 196608)])
def test_chip_smoke_checks_each_walked_form_on_full_tiles(key, scale, m):
    """chip_smoke.py's long launches hold each form that walks tiles at
    16-byte stores on full tiles, as the half-scale cell launches it, and
    above one wave of an H100's resident blocks, so that its blocks walk."""
    assert (key, scale, m) in _chip_smoke().LOOP_CASES
    assert m % 16 == 0 and m % K.TILE_MCUS == 0
    assert K.scaled_plan(m, CARDS[0])[1] > 1
