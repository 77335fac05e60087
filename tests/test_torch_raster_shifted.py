"""The epilogue's shifted-copy counter on the CPU.

``raster_shifted`` is the host's reading of when a banded-form launch of
``csrc/raster_epilogue.cu`` copies input runs that start off the 16-byte
grid (the launch counter ``raster_shifted``).  The kernel itself is held
against its plain version on the card by chip_smoke.py."""

import pytest
import torch

from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import specs as S

ALIGNED = 1 << 20   # a base address on the 16-byte grid


@pytest.mark.parametrize("batch,gw", [(225, 15), (31, 29), (2, 15), (2, 29),
                                      (3, 17), (4, 40)])
def test_widths_off_the_grid_shift(batch, gw):
    """gw 15 or 29 (the crop cell's sub-grids) over more than one MCU row:
    some band's first MCU is off the grid, even where M is on it."""
    gh = gw
    m = batch * gh * gw
    m += -m % 16
    assert K.raster_shifted(ALIGNED, m, batch, gh, gw)
    assert K.raster_shifted(ALIGNED, m, 1, 2, gw)


@pytest.mark.parametrize("pad", [1, 7, 8, 15])
def test_m_off_the_grid_shifts(pad):
    """M % 16 != 0 puts run rho at rho * M past run 0, off the grid, even
    for 32-wide images."""
    m = 4 * 24 * 32 + pad
    assert K.raster_shifted(ALIGNED, m, 4, 24, 32)


@pytest.mark.parametrize("off", [1, 4, 8, 15])
def test_an_unaligned_base_shifts(off):
    assert K.raster_shifted(ALIGNED + off, 256 * 24 * 32, 256, 24, 32)


@pytest.mark.parametrize("batch,gh,gw", [(256, 24, 32), (1, 1, 32),
                                         (3, 5, 16), (2, 2, 64)])
def test_grid_widths_with_m_on_the_grid_do_not_shift(batch, gh, gw):
    assert not K.raster_shifted(ALIGNED, batch * gh * gw, batch, gh, gw)


@pytest.mark.parametrize("gw", [1, 15, 29, 33])
def test_a_single_mcu_row_does_not_shift(gw):
    """One MCU row over the batch: every band starts at a multiple of 32
    MCUs, so only M and the base decide."""
    m = gw + -gw % 16
    assert not K.raster_shifted(ALIGNED, m, 1, 1, gw)
    assert K.raster_shifted(ALIGNED, m + 1, 1, 1, gw)


@pytest.mark.parametrize("raw_ptr,m,batch,gh,gw", [
    (ALIGNED, 256 * 16 * 16, 256, 16, 16),        # the loader cell's batch
    (ALIGNED, 256 * 14 * 14, 256, 14, 14),        # 224x224: 4-byte copies
    (ALIGNED + 4, 256 * 14 * 14, 256, 14, 14),
    (ALIGNED + 8, 6 * 2 * 24 + 8, 6, 2, 24),      # 8-byte copies
    (ALIGNED, 64 * 32 * 32, 64, 32, 32)])
def test_the_row_form_never_counts(raw_ptr, m, batch, gh, gw):
    """A launch the row form takes copies whole runs of R*gw bytes, never
    shifted ones, wherever its input lies."""
    assert not K.raster_shifted(raw_ptr, m, batch, gh, gw, row_form=True)


def test_counter_is_listed_and_cpu_calls_count_nothing():
    """``raster_shifted`` is a launch counter; the plain version on CPU
    tensors counts no launch."""
    assert K.launch_counts()["raster_shifted"] >= 0
    mode = S.mode_for((2, 2, 3))
    raw = torch.zeros((3, mode.luma_slots, 64, 2 * 2 * 15 + 3),
                      dtype=torch.uint8)
    before = K.launch_counts()
    K.raster_epilogue(raw, mode, 1, 2, 2, 15, 20, 20,
                      torch.zeros(2, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32))
    assert K.launch_counts() == before
