"""The PyTorch port's device decode against the JAX Pallas kernels.

``pim_jpeg_decoder_tpu_torch.ops.decode_kernel.decode_mcus`` on CPU tensors
runs the plain PyTorch version of the CUDA kernels; the JAX ``decode_mcus``
runs the Pallas kernels in interpret mode (conftest forces the CPU backend).
Same numpy inputs, drawn from a seed; tolerance 0, because the spec
(ops/specs.py, ops/idct_math.py) is integer arithmetic.  The CUDA kernels
themselves are held against the same plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu.ops.decode_kernel import decode_mcus as jax_decode
from pim_jpeg_decoder_tpu.ops.decode_kernel import pad_mcus
from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K

LANE_TILE = 128
M = 101          # odd: padded to the JAX lane tile, sliced back after
MODE_KEYS = sorted(S.MODES)
MODE_IDS = [S.MODES[k].name for k in MODE_KEYS]


def make_inputs(mode, wire, seed):
    """Photo-like coefficients, 20 uniformly random blocks, an all-max and
    an all-min block; Q=3 quant rows (one with 16-bit values) mixed per
    MCU -- the extremes drive DEQUANT_CLAMP, int32 wrap and the clamps."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(wire)
    coeffs = np.clip(np.round(rng.laplace(0.0, 8.0, (M, mode.g, 64))),
                     info.min, info.max).astype(wire)
    coeffs[2:22] = rng.integers(info.min, int(info.max) + 1,
                                (20, mode.g, 64))
    coeffs[0] = info.max
    coeffs[1] = info.min
    qpool = rng.integers(1, 64, (3, mode.g, 64)).astype(np.float32)
    qpool[2] = rng.integers(1, 65536, (mode.g, 64))
    qidx = rng.integers(0, 3, M).astype(np.int32)
    qidx[:22] = 2
    return coeffs, qidx, qpool


def jax_reference(coeffs, qidx, qpool, mode, **kw):
    m_pad = pad_mcus(coeffs.shape[0], LANE_TILE)
    padded = np.zeros((m_pad,) + coeffs.shape[1:], coeffs.dtype)
    padded[: coeffs.shape[0]] = coeffs
    qpad = np.zeros(m_pad, np.int32)
    qpad[: coeffs.shape[0]] = qidx
    out = np.asarray(jax_decode(padded, qpad, qpool, mode,
                                lane_tile=LANE_TILE, **kw))
    if kw.get("raw") or kw.get("ycbcr"):
        return out[..., : coeffs.shape[0]]
    return out[: coeffs.shape[0]]


def port(coeffs, qidx, qpool, mode, **kw):
    return K.decode_mcus(torch.from_numpy(coeffs), torch.from_numpy(qidx),
                         K.qpool_to_device(qpool, "cpu"), mode, **kw).numpy()


@pytest.mark.parametrize("wire", [np.int16, np.int8], ids=["i16", "i8"])
@pytest.mark.parametrize("layout", ["raw", "ycbcr"])
@pytest.mark.parametrize("mode_key", MODE_KEYS, ids=MODE_IDS)
def test_matches_jax_kernel(mode_key, layout, wire):
    mode = S.mode_for(mode_key)
    coeffs, qidx, qpool = make_inputs(mode, wire, seed=hash(mode_key) % 997)
    kw = {layout: True}
    want = jax_reference(coeffs, qidx, qpool, mode, **kw)
    got = port(coeffs, qidx, qpool, mode, **kw)
    assert got.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_slot_major_layout_matches_jax():
    """raw=False: the JAX package's [M, luma_slots, 64, 3] layout."""
    mode = S.mode_for((2, 2, 3))
    coeffs, qidx, qpool = make_inputs(mode, np.int16, seed=5)
    want = jax_reference(coeffs, qidx, qpool, mode)
    got = port(coeffs, qidx, qpool, mode)
    assert got.shape == (M, mode.luma_slots, 64, 3)
    np.testing.assert_array_equal(got, want)


def test_plain_version_matches_numpy_oracle():
    """The plain version against the oracle's own primitives."""
    from pim_jpeg_decoder_tpu.oracle.color import (chroma_subblock,
                                                   ycbcr_to_rgb)
    from pim_jpeg_decoder_tpu.oracle.idct import dequantize, idct_blocks

    mode = S.mode_for((2, 1, 3))
    coeffs, qidx, qpool = make_inputs(mode, np.int16, seed=11)
    got = port(coeffs, qidx, qpool, mode, raw=True)
    deq = dequantize(coeffs, qpool[qidx].astype(np.uint32))
    spat = idct_blocks(deq.reshape(M, mode.g, 8, 8))
    for s in range(mode.luma_slots):
        qv, qh = mode.luma_slot_pos(s)
        cb = chroma_subblock(spat[:, 2], qv, qh, mode.v, mode.h)
        cr = chroma_subblock(spat[:, 3], qv, qh, mode.v, mode.h)
        want = ycbcr_to_rgb(spat[:, s], cb, cr)          # [M, py, px, 3]
        want = want.swapaxes(1, 2).reshape(M, 64, 3)     # column-major
        np.testing.assert_array_equal(got[:, s], want.transpose(2, 1, 0))


def test_any_mcu_count():
    """No lane-tile padding: M = 0, 1 and 7 decode like a padded batch."""
    mode = S.mode_for((1, 1, 3))
    coeffs, qidx, qpool = make_inputs(mode, np.int16, seed=3)
    full = port(coeffs, qidx, qpool, mode, raw=True)
    for m in (0, 1, 7):
        got = port(coeffs[:m].copy(), qidx[:m].copy(), qpool, mode, raw=True)
        np.testing.assert_array_equal(got, full[..., :m])


def test_cpu_calls_count_no_launch():
    mode = S.mode_for((1, 1, 1))
    coeffs, qidx, qpool = make_inputs(mode, np.int8, seed=1)
    before = K.launch_counts()
    port(coeffs, qidx, qpool, mode, ycbcr=True)
    port(coeffs, qidx, qpool, mode, raw=True)
    assert K.launch_counts() == before


def test_qpool_to_device_is_exact():
    qpool = np.array([[[1.0, 255.0, 65535.0, 2.0 ** 24 - 1]]], np.float32)
    got = K.qpool_to_device(qpool, "cpu")
    assert got.dtype == torch.int32
    assert got.tolist() == [[[1, 255, 65535, 2 ** 24 - 1]]]


def test_coeffs_to_device_keeps_the_wire_dtype():
    for wire in (np.int16, np.int8):
        x = K.coeffs_to_device(np.ones((2, 3, 64), wire), "cpu")
        assert x.dtype == {np.int16: torch.int16, np.int8: torch.int8}[wire]
    with pytest.raises(ValueError):
        K.coeffs_to_device(np.ones((2, 3, 64), np.int32), "cpu")


def _valid(mode):
    return (torch.zeros(4, mode.g, 64, dtype=torch.int16),
            torch.zeros(4, dtype=torch.int32),
            torch.ones(1, mode.g, 64, dtype=torch.int32))


@pytest.mark.parametrize("case", ["coeff_dtype", "coeff_shape", "qidx_dtype",
                                  "qidx_len", "qpool_float", "qpool_empty",
                                  "non_contiguous", "meta_device"])
def test_wrapper_rejects_bad_inputs(case):
    mode = S.mode_for((2, 2, 3))
    c, qi, qp = _valid(mode)
    if case == "coeff_dtype":
        c = c.int()
    elif case == "coeff_shape":
        c = torch.zeros(4, 3, 64, dtype=torch.int16)
    elif case == "qidx_dtype":
        qi = qi.long()
    elif case == "qidx_len":
        qi = qi[:3]
    elif case == "qpool_float":
        qp = qp.float()
    elif case == "qpool_empty":
        qp = qp[:0]
    elif case == "non_contiguous":
        c = torch.zeros(mode.g, 4, 64, dtype=torch.int16).transpose(0, 1)
    elif case == "meta_device":
        # Neither CPU nor CUDA: raises instead of running the plain version.
        c, qi, qp = (t.to("meta") for t in (c, qi, qp))
    with pytest.raises(ValueError):
        K.decode_mcus(c, qi, qp, mode, raw=True)


@pytest.mark.parametrize("scale", [2, 4, 8])
def test_scaled_decode_not_ported_yet(scale):
    mode = S.mode_for((2, 2, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.decode_mcus(*_valid(mode), mode, raw=True, scale=scale)
