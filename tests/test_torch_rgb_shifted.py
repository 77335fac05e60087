"""The RGB decode's shifted-row counter on the CPU.

``rgb_shifted`` is the host's reading of when an ``rgb`` launch of
``csrc/decode_kernel.cu`` writes output rows that start off the 16-byte
grid (the launch counter ``rgb_shifted``): the launcher then picks the
kernel without 16-byte stores, which writes its rows a byte a lane.  The
batch paths pad each launch's MCUs to the grid (``padded_mcus``; their
tests are in ``test_torch_crop_batches.py``).  The kernel itself is held
against its plain version on the card by chip_smoke.py
(``row_shift_cases``)."""

import os
import re
import types

import pytest
import torch

from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import specs as S

ALIGNED = 1 << 20   # a base address on the 16-byte grid
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pim_jpeg_decoder_tpu_torch", "csrc")


@pytest.mark.parametrize("r", range(1, 16))
def test_m_off_the_grid_shifts(r):
    """M % 16 != 0 puts row t of a plane t * M bytes past row 0, off the
    grid, whatever the base."""
    assert K.rgb_shifted(ALIGNED, 16 * 19 + r)
    assert K.rgb_shifted(ALIGNED, 50624 + r)


@pytest.mark.parametrize("off", [1, 4, 8, 15])
def test_an_output_off_the_grid_shifts(off):
    assert K.rgb_shifted(ALIGNED + off, 65536)


@pytest.mark.parametrize("m", [65536, 50624, 26064, 16])
def test_m_and_output_on_the_grid_do_not_shift(m):
    """The loader cell's launches (M = 65,536) and the crop cell's nearest
    on-grid sizes keep the 16-byte stores."""
    assert not K.rgb_shifted(ALIGNED, m)


@pytest.mark.parametrize("m", [1, 15, 16, 17, 50625, 26071, 65536])
def test_padded_mcus_reach_the_grid(m):
    """``padded_mcus`` is the least multiple of 16 at or above M, so a
    launch of that many MCUs into a fresh output never shifts."""
    p = K.padded_mcus(m)
    assert p % 16 == 0 and m <= p < m + 16
    assert not K.rgb_shifted(ALIGNED, p)


def test_the_crop_cells_launches_shift():
    """The crop cell's usual split: 225 images on 15 x 15 MCUs at 4:2:0, 31
    on 29 x 29 at 4:4:4."""
    assert K.rgb_shifted(ALIGNED, 225 * 15 * 15)
    assert K.rgb_shifted(ALIGNED, 31 * 29 * 29)


def test_the_rule_is_the_launchers():
    """``decode`` in csrc/decode_kernel.cu takes the 16-byte stores exactly
    when M and the output address are both on the grid."""
    with open(os.path.join(CSRC, "decode_kernel.cu")) as f:
        source = f.read()
    launcher = source[source.index("int decode("):]
    assert re.search(r"num_mcus % VEC == 0 &&\s+reinterpret_cast<uintptr_t>"
                     r"\(out\) % VEC == 0", launcher)
    with open(os.path.join(CSRC, "decode_tile.cuh")) as f:
        assert "constexpr int VEC = 16;" in f.read()


class _Lib:
    """Stands in for the CUDA library: every launch succeeds, and a card
    holds every scaled launch's blocks in one wave."""

    def __getattr__(self, name):
        return lambda *args: 0

    @staticmethod
    def pjt_cuda_rgb_scaled_resident(*args):
        args[-1]._obj.value = 1 << 20
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    """``decode_kernel._launch`` on CPU tensors against a library whose
    launches all succeed, so that its counting runs here."""
    from pim_jpeg_decoder_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda: _Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _inputs(mode, m):
    coeffs = torch.zeros((m, mode.g, 64), dtype=torch.int16)
    qidx = torch.zeros(m, dtype=torch.int32)
    qpool = torch.ones((1, mode.g, 64), dtype=torch.int32)
    return coeffs, qidx, qpool


@pytest.mark.parametrize("key,m,ycbcr,scale,counted", [
    ((2, 2, 3), 50625, False, 1, 1),     # the crop cell's 4:2:0 launch
    ((1, 1, 3), 26071, False, 1, 1),     # its 4:4:4 launch
    ((2, 1, 3), 33, False, 1, 1),
    ((2, 2, 3), 50624, False, 1, 0),     # on the grid: 16-byte stores
    ((1, 1, 1), 33, False, 1, 1),        # gray too
    ((2, 2, 3), 33, True, 1, 0),         # not an rgb launch
    ((2, 2, 3), 33, False, 2, 0)])
def test_launches_count_where_rows_shift(fake_launch, key, m, ycbcr, scale,
                                         counted):
    mode = S.mode_for(key)
    before = K.launch_counts()
    K._launch(*_inputs(mode, m), mode, ycbcr, scale)
    after = K.launch_counts()
    name = "ycbcr" if ycbcr else "rgb" if scale == 1 else "rgb_scaled"
    assert after[name] == before[name] + 1
    assert after["rgb_shifted"] == before["rgb_shifted"] + counted


def test_counter_is_listed_and_cpu_calls_count_nothing():
    """``rgb_shifted`` is a launch counter; the plain version on CPU
    tensors counts no launch."""
    assert K.launch_counts()["rgb_shifted"] >= 0
    mode = S.mode_for((2, 2, 3))
    before = K.launch_counts()
    K.decode_mcus(*_inputs(mode, 33), mode, raw=True)
    assert K.launch_counts() == before
