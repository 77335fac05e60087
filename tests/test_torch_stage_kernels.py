"""The PyTorch port's stage functions against the JAX stage kernels.

``pim_jpeg_decoder_tpu_torch.ops.stage_kernels`` on CPU tensors runs the
plain PyTorch versions of the CUDA stage kernels; the JAX stage functions
run their Pallas kernels in interpret mode (conftest forces the CPU
backend), on inputs padded to a 128-MCU lane tile and sliced back.  Same
numpy inputs, drawn from a seed with extreme blocks; tolerance 0, because
the spec is integer arithmetic.  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops import stage_kernels as J
from pim_jpeg_decoder_tpu.ops.decode_kernel import pad_mcus
from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as P

LANE_TILE = 128
M = 101          # odd: padded to the JAX lane tile, sliced back after
MODE_KEYS = sorted(S.MODES)
MODE_IDS = [S.MODES[k].name for k in MODE_KEYS]
WIRES = pytest.mark.parametrize("wire", [np.int16, np.int8],
                                ids=["i16", "i8"])
MODES = pytest.mark.parametrize("mode_key", MODE_KEYS, ids=MODE_IDS)


def make_inputs(mode, wire, seed):
    """Photo-like coefficients, 20 uniformly random blocks, an all-max, an
    all-min and an alternating block; Q=3 quant rows (one with 16-bit
    values) mixed per MCU: the extremes reach DEQUANT_CLAMP and wrap the
    IDCT's int32 arithmetic."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(wire)
    coeffs = np.clip(np.round(rng.laplace(0.0, 8.0, (M, mode.g, 64))),
                     info.min, info.max).astype(wire)
    coeffs[3:23] = rng.integers(info.min, int(info.max) + 1,
                                (20, mode.g, 64))
    coeffs[0] = info.max
    coeffs[1] = info.min
    coeffs[2, :, ::2] = info.max
    coeffs[2, :, 1::2] = info.min
    qpool = rng.integers(1, 64, (3, mode.g, 64)).astype(np.float32)
    qpool[2] = rng.integers(1, 65536, (mode.g, 64))
    qidx = rng.integers(0, 3, M).astype(np.int32)
    qidx[:23] = 2
    return coeffs, qidx, qpool


def _pad(x):
    out = np.zeros((pad_mcus(x.shape[0], LANE_TILE),) + x.shape[1:], x.dtype)
    out[: x.shape[0]] = x
    return out


def jax_stage(fn, *arrays, **kw):
    """A JAX stage function on lane-tile-padded inputs, sliced to M."""
    out = fn(*(_pad(a) for a in arrays), lane_tile=LANE_TILE, **kw)
    return np.asarray(out)[:M]


def _port_inputs(coeffs, qidx, qpool):
    return (torch.from_numpy(coeffs), torch.from_numpy(qidx),
            K.qpool_to_device(qpool, "cpu"))


def full_range_samples(mode, seed):
    """int16 samples over the whole int16 range: the colour stage's int32
    products wrap, as they do in the JAX kernel."""
    rng = np.random.default_rng(seed)
    spat = rng.integers(-128, 128, (M, mode.g, 64)).astype(np.int16)
    spat[:40] = rng.integers(-32768, 32768, (40, mode.g, 64))
    spat[0] = 32767
    spat[1] = -32768
    return spat


@WIRES
@MODES
def test_dequantize_stage_matches_jax(mode_key, wire):
    mode = S.mode_for(mode_key)
    coeffs, qidx, qpool = make_inputs(mode, wire, seed=hash(mode_key) % 991)
    want = np.asarray(J.dequantize_stage(_pad(coeffs), _pad(qidx), qpool,
                                         mode=mode, lane_tile=LANE_TILE))[:M]
    got = P.dequantize_stage(*_port_inputs(coeffs, qidx, qpool), mode)
    assert got.dtype == torch.int16 and tuple(got.shape) == (M, mode.g, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() == -32768 and got.max() == 32767   # the clamps bite


@MODES
def test_idct_stage_matches_jax(mode_key):
    """On dequantized extremes (the clamps, int32 wrap in the butterfly):
    row-major samples, as the TPU kernel writes them."""
    mode = S.mode_for(mode_key)
    coeffs, qidx, qpool = make_inputs(mode, np.int16, seed=7)
    deq = P.dequantize_stage(*_port_inputs(coeffs, qidx, qpool), mode)
    want = jax_stage(J.idct_stage, deq.numpy(), mode=mode)
    got = P.idct_stage(deq, mode)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= S.SAMPLE_MIN and got.max() <= S.SAMPLE_MAX


@pytest.mark.parametrize("source", ["idct", "full_range"])
@MODES
def test_color_stage_matches_jax(mode_key, source):
    mode = S.mode_for(mode_key)
    if source == "idct":
        coeffs, qidx, qpool = make_inputs(mode, np.int16, seed=9)
        spat = P.idct_stage(P.dequantize_stage(
            *_port_inputs(coeffs, qidx, qpool), mode), mode).numpy()
    else:
        spat = full_range_samples(mode, seed=13)
    want = jax_stage(J.color_stage, spat, mode=mode)
    got = P.color_stage(torch.from_numpy(spat), mode).numpy()
    raw = P.color_stage(torch.from_numpy(spat), mode, raw=True).numpy()
    assert got.shape == (M, mode.luma_slots, 64, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(raw, got.transpose(3, 1, 2, 0))


@WIRES
@MODES
def test_decode_mcus_staged_matches_fused_and_jax(mode_key, wire):
    mode = S.mode_for(mode_key)
    coeffs, qidx, qpool = make_inputs(mode, wire, seed=hash(mode_key) % 89)
    got = P.decode_mcus_staged(*_port_inputs(coeffs, qidx, qpool), mode)
    fused = K.decode_mcus(*_port_inputs(coeffs, qidx, qpool), mode)
    np.testing.assert_array_equal(got.numpy(), fused.numpy())
    want = np.asarray(J.decode_mcus_staged(
        _pad(coeffs), _pad(qidx), qpool, mode, lane_tile=LANE_TILE))[:M]
    np.testing.assert_array_equal(got.numpy(), want)


def test_any_mcu_count_and_no_launch_on_cpu():
    """No lane-tile padding: M = 0, 1 and 7 give the first rows of a full
    batch; CPU calls launch nothing."""
    mode = S.mode_for((2, 1, 3))
    coeffs, qidx, qpool = make_inputs(mode, np.int8, seed=3)
    before = K.launch_counts()
    full = P.decode_mcus_staged(*_port_inputs(coeffs, qidx, qpool), mode)
    for m in (0, 1, 7):
        part = _port_inputs(coeffs[:m].copy(), qidx[:m].copy(), qpool)
        got = P.decode_mcus_staged(*part, mode)
        np.testing.assert_array_equal(got.numpy(), full[:m].numpy())
        assert tuple(P.color_stage(
            P.idct_stage(P.dequantize_stage(*part, mode), mode), mode,
            raw=True).shape) == (3, mode.luma_slots, 64, m)
    assert K.launch_counts() == before


def _valid(mode):
    return (torch.zeros(4, mode.g, 64, dtype=torch.int16),
            torch.zeros(4, dtype=torch.int32),
            torch.ones(1, mode.g, 64, dtype=torch.int32))


@pytest.mark.parametrize("case", [
    "dequant_coeff_dtype", "dequant_qpool_float", "dequant_qidx_len",
    "idct_int32", "idct_slots", "color_int8", "color_shape",
    "color_non_contiguous", "idct_meta_device", "color_meta_device"])
def test_stage_wrappers_reject_bad_inputs(case):
    mode = S.mode_for((2, 2, 3))
    c, qi, qp = _valid(mode)
    spat = torch.zeros(4, mode.g, 64, dtype=torch.int16)
    calls = {
        "dequant_coeff_dtype": lambda: P.dequantize_stage(c.int(), qi, qp,
                                                          mode),
        "dequant_qpool_float": lambda: P.dequantize_stage(c, qi, qp.float(),
                                                          mode),
        "dequant_qidx_len": lambda: P.dequantize_stage(c, qi[:3], qp, mode),
        "idct_int32": lambda: P.idct_stage(spat.int(), mode),
        "idct_slots": lambda: P.idct_stage(spat[:, :4].contiguous(), mode),
        "color_int8": lambda: P.color_stage(spat.to(torch.int8), mode),
        "color_shape": lambda: P.color_stage(spat.view(4, 6, 8, 8), mode),
        "color_non_contiguous": lambda: P.color_stage(
            torch.zeros(mode.g, 4, 64, dtype=torch.int16).transpose(0, 1),
            mode),
        # Neither CPU nor CUDA: raises instead of running the plain version.
        "idct_meta_device": lambda: P.idct_stage(spat.to("meta"), mode),
        "color_meta_device": lambda: P.color_stage(spat.to("meta"), mode),
    }
    with pytest.raises(ValueError):
        calls[case]()
