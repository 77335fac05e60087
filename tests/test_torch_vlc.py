"""The port's serial VLC loop (``ops/vlc.py``) against the JAX package's
``tools/tpu_vlc_bench.py``, and the port's bench tool.

On CPU tensors the port runs the plain version of the CUDA kernel in
``csrc/vlc.cu``; the JAX tool's Pallas kernel runs through its own
``run_vlc`` in interpret mode (conftest forces the CPU backend) at the full
bitstream (NWORDS = 2,048 words).  Tolerance 0: integer arithmetic.  The
CUDA kernel is held against the plain version on the card by chip_smoke.py.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import vlc as V
from pim_jpeg_decoder_tpu_torch.tools import vlc_bench as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/tpu_vlc_bench.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_tpu_vlc_bench",
        os.path.join(REPO, "tools", "tpu_vlc_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lut_draw(seed: int) -> np.ndarray:
    """A table as the tool draws it (code lengths 2-8, value bits 0-5)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, 9, V.LUT_SIZE).astype(np.int32)
    vbits = rng.integers(0, 6, V.LUT_SIZE).astype(np.int32)
    vals = rng.integers(0, 256, V.LUT_SIZE).astype(np.int32)
    return lens | (vbits << 4) | (vals << 8)


def port(seed, data, lut):
    return V.vlc(torch.tensor([seed], dtype=torch.int32),
                 torch.from_numpy(data), torch.from_numpy(lut)).numpy()


# Case -> (seed, table): the tool's seed-0 draw at both starts, and two
# other tables (one with long codes, up to 15 + 15 bits a symbol).
CASES = ["tool_seed0", "tool_seed1", "lut_draw_7", "lut_long_codes"]


def case_inputs(case):
    data, lut = T.make_inputs()
    if case == "tool_seed1":
        return 1, data, lut
    if case == "lut_draw_7":
        return 0, data, lut_draw(7)
    if case == "lut_long_codes":
        rng = np.random.default_rng(11)
        return 1, data, (rng.integers(1, 16, V.LUT_SIZE)
                         | rng.integers(0, 16, V.LUT_SIZE) << 4
                         | rng.integers(0, 256, V.LUT_SIZE) << 8
                         ).astype(np.int32)
    return 0, data, lut


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_the_jax_kernel(jax_tool, case):
    import jax.numpy as jnp

    seed, data, lut = case_inputs(case)
    want = np.asarray(jax_tool.run_vlc(jnp.asarray([seed], jnp.int32), data,
                                       lut))
    got = port(seed, data, lut)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[2] >= V.NBITS and got[1] > 0


def test_the_tools_seed0_numbers():
    """[acc, nsym, bitpos] of the tool's seed-0 draw (the JAX kernel's
    interpret-mode output, pinned)."""
    data, lut = T.make_inputs()
    assert port(0, data, lut).tolist() == [1113556, 8639, 65475]


def test_start_is_the_seeds_low_bit():
    data, lut = T.make_inputs()
    for seed in (2, -4, 2 ** 31 - 1):
        assert port(seed, data, lut).tolist() == port(seed & 1, data,
                                                      lut).tolist()


def test_a_table_with_no_advance_stops():
    """An all-zero table would loop forever in the JAX kernel: here the
    loop stops after NBITS symbols, at the start position."""
    data, _ = T.make_inputs()
    zero = np.zeros(V.LUT_SIZE, np.int32)
    assert port(1, data, zero).tolist() == [0, V.NBITS, 1]


def test_window_at_shift_zero_reads_one_word():
    """At a word boundary the window is the word itself (the JAX select,
    not ``lo >> 32``): only the first symbol, at bit 0, probes 0xA3."""
    data = np.zeros(V.NWORDS, np.int32)
    data[0] = np.int32(-0x5D000000)          # top byte 0xA3
    data[1] = -1                             # all ones: must not leak in
    lut = np.full(V.LUT_SIZE, 0x2 | (0xF << 4), np.int32)  # +17 bits
    lut[0xA3] = 0x2 | (0xE << 4) | (5 << 8)  # +16 bits, acc += 5
    assert port(0, data, lut)[0] == 5


def test_cpu_entry_point_takes_the_plain_path():
    data, lut = T.make_inputs()
    args = (torch.tensor([0], dtype=torch.int32), torch.from_numpy(data),
            torch.from_numpy(lut))
    before = K.launch_counts()
    assert torch.equal(V.vlc(*args), V.vlc_reference(*args))
    assert K.launch_counts() == before


@pytest.mark.parametrize("case", ["meta_device", "short_data", "int64_lut",
                                  "two_seeds"])
def test_wrapper_rejects_bad_inputs(case):
    seed = torch.zeros(1, dtype=torch.int32)
    data = torch.zeros(V.NWORDS, dtype=torch.int32)
    lut = torch.ones(V.LUT_SIZE, dtype=torch.int32)
    if case == "meta_device":
        seed, data, lut = (t.to("meta") for t in (seed, data, lut))
    elif case == "short_data":
        data = data[:100]
    elif case == "int64_lut":
        lut = lut.long()
    else:
        seed = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        V.vlc(seed, data, lut)


def test_tool_inputs_are_the_jax_tools_draw(jax_tool):
    assert (V.NWORDS, V.LUT_SIZE) == (jax_tool.NWORDS, jax_tool.LUT_SIZE)
    data, lut = T.make_inputs()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        data, rng.integers(-2**31, 2**31, V.NWORDS, np.int64).astype(np.int32))
    lens = rng.integers(2, 9, V.LUT_SIZE).astype(np.int32)
    vbits = rng.integers(0, 6, V.LUT_SIZE).astype(np.int32)
    vals = rng.integers(0, 256, V.LUT_SIZE).astype(np.int32)
    np.testing.assert_array_equal(lut, lens | (vbits << 4) | (vals << 8))


def test_tool_exits_2_without_a_card_or_with_arguments(capsys):
    assert T.main(["--fast"]) == 2
    assert "no arguments" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    assert T.main([]) == 2
    assert "is_available() is False" in capsys.readouterr().err
