"""The port's VLC loop (``ops/vlc.py``) against the JAX package's
``tools/tpu_vlc_bench.py``, and the port's bench tool.

On CPU tensors the port runs the plain version of the CUDA kernel in
``csrc/vlc.cu``; the JAX tool's Pallas kernel runs through its own
``run_vlc`` in interpret mode (conftest forces the CPU backend) at the full
bitstream (NWORDS = 2,048 words).  Tolerance 0: integer arithmetic.  The
kernel's own algorithm (chunk maps composed across a cluster) runs only on
the card, so a NumPy model of it here, with the kernel's constants and its
composition order, is held against the plain version (hypothesis draws)
and the JAX kernel; chip_smoke.py holds the CUDA kernel against the plain
version on the card.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

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


# --- the kernel's algorithm: chunk maps composed across the cluster ----------

M32 = 0xFFFFFFFF
CHUNKS = -(-V.NBITS // V.CHUNK_BITS)


def chunk_maps(data, lut, chunk_bits=V.CHUNK_BITS,
               entry_offsets=V.ENTRY_OFFSETS):
    """The kernel's phase 1: for each chunk of ``chunk_bits`` bits and each
    entry offset, decode from the chunk's start + offset until the chunk's
    end (``NBITS`` for the last one) or a table entry with no advance.
    Returns ``(exit, n, a, fix)``, int64 ``[chunks, entry_offsets]`` each:
    the exit position (the fixed point's, if met), the symbols and the sum
    up to it, and ``0x100 | value`` of the fixed point (0: none)."""
    chunks = -(-V.NBITS // chunk_bits)
    words = data.view(np.uint32).astype(np.int64)
    table = lut.view(np.uint32).astype(np.int64)
    first = np.arange(chunks, dtype=np.int64)[:, None] * chunk_bits
    end = np.minimum(first + chunk_bits, V.NBITS)
    p = first + np.arange(entry_offsets, dtype=np.int64)
    n, a, fix = (np.zeros_like(p) for _ in range(3))
    live = p < end
    while live.any():
        q = np.where(live, p, 0)
        widx, shift = q >> 5, q & 31
        win = ((words[widx] << shift) & M32) | np.where(
            shift == 0, 0, words[widx + 1] >> (32 - shift))
        entry = table[win >> 24]
        advance = (entry & 0xF) + ((entry >> 4) & 0xF)
        val = (entry >> 8) & 0xFF
        stuck = live & (advance == 0)
        fix[stuck] = 0x100 | val[stuck]
        live &= ~stuck
        a = np.where(live, (a + val) & M32, a)
        p = np.where(live, p + advance, p)
        n += live
        live &= p < end
    return p, n, a, fix


def compose(left, right, right_start):
    """Entry-wise: each left entry followed by the entry of ``right`` (the
    next maps, ``[k, E]``, starting at bits ``right_start [k]``) that its
    exit lands on, as the kernel's ``compose``.  Returns the composed
    entries and the count of exits that landed on no entry offset."""
    exit, n, a, fix = left
    go = (fix == 0) & (exit < V.NBITS)
    o = exit - np.asarray(right_start)[:, None]
    bad = go & ((o < 0) | (o >= right[0].shape[-1]))
    go &= ~bad
    o = np.clip(o, 0, right[0].shape[-1] - 1)
    r = [np.take_along_axis(x, o, axis=-1) for x in right]
    return ((np.where(go, r[0], exit), np.where(go, n + r[1], n),
             np.where(go, (a + r[2]) & M32, a), np.where(go, r[3], fix)),
            int(bad.sum()))


def chunk_model(seed, data, lut, chunk_bits=V.CHUNK_BITS,
                entry_offsets=V.ENTRY_OFFSETS):
    """``([acc, nsym, bitpos], exit violations)`` as the kernel computes
    them: the chunk maps; each block's ``chunks / CLUSTER_CTAS`` maps
    composed in order from every entry offset of its first chunk (its warp
    0); the walk over the blocks' maps from ``seed & 1``; the closed form
    at a fixed point."""
    maps = chunk_maps(data, lut, chunk_bits, entry_offsets)
    per_cta = maps[0].shape[0] // V.CLUSTER_CTAS
    maps = [x.reshape(V.CLUSTER_CTAS, per_cta, -1) for x in maps]
    first = np.arange(V.CLUSTER_CTAS) * per_cta * chunk_bits
    heads = [x[:, 0] for x in maps]
    violations = 0
    for c in range(1, per_cta):
        heads, bad = compose(heads, [x[:, c] for x in maps],
                             first + c * chunk_bits)
        violations += bad
    path = tuple(np.array([[v]], np.int64) for v in (seed & 1, 0, 0, 0))
    for k in range(V.CLUSTER_CTAS):
        path, bad = compose(path, [x[k:k + 1] for x in heads], first[k:k + 1])
        violations += bad
    exit, n, a, fix = (int(x[0, 0]) for x in path)
    if fix:
        a = (a + (V.NBITS - n) * (fix & 0xFF)) & M32
        n = V.NBITS
    return np.array([a, n, exit], np.uint32).view(np.int32), violations


def zero_advance_unreached():
    """A table whose entry 0xFF has no advance, on a stream whose bytes are
    never 0xFF, every other entry advancing 8 or 16 bits: from seed 0 the
    path stays on byte boundaries and never meets the fixed point (the JAX
    kernel ends), while lanes at other offsets do (bits 1-8 of 0x7F 0x80)."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 255, 4 * V.NWORDS).astype(np.uint8)
    data = data.reshape(-1, 4).astype(np.uint32)
    data = ((data[:, 0] << 24) | (data[:, 1] << 16) | (data[:, 2] << 8)
            | data[:, 3]).view(np.int32)
    code = rng.integers(1, 9, V.LUT_SIZE)
    vbits = np.where(rng.random(V.LUT_SIZE) < 0.2, 16 - code, 8 - code)
    vbits = np.where(vbits > 15, 8 - code, vbits)
    lut = (code | vbits << 4 | rng.integers(0, 256, V.LUT_SIZE) << 8)
    lut[0xFF] = 77 << 8
    return 0, data, lut.astype(np.int32)


MODEL_CASES = CASES + ["zero_advance_unreached"]


def model_case_inputs(case):
    if case == "zero_advance_unreached":
        return zero_advance_unreached()
    return case_inputs(case)


def test_chunk_constants_cover_every_advance():
    """A symbol advances at most 15 + 15 bits: the path enters a chunk at
    one of its first 30 positions, and every lane starts inside its
    chunk.  The CUDA source carries the same constants."""
    entry = np.arange(256)
    largest_advance = int(((entry & 0xF) + ((entry >> 4) & 0xF)).max())
    assert largest_advance == 15 + 15
    assert V.CHUNK_BITS >= V.ENTRY_OFFSETS >= largest_advance
    assert CHUNKS % V.CLUSTER_CTAS == 0
    per_cta = CHUNKS // V.CLUSTER_CTAS
    assert per_cta & (per_cta - 1) == 0 and per_cta * 32 <= 1024
    with open(os.path.join(REPO, "pim_jpeg_decoder_tpu_torch", "csrc",
                           "vlc.cu")) as f:
        source = f.read()
    for line in (f"constexpr uint32_t ENTRY_OFFSETS = {V.ENTRY_OFFSETS};",
                 "static_assert(ENTRY_OFFSETS >= advance_of(0xFFu),",
                 f"constexpr uint32_t CHUNK_BITS = {V.CHUNK_BITS};",
                 f"constexpr int CLUSTER_CTAS = {V.CLUSTER_CTAS};",
                 f"constexpr int NWORDS = {V.NWORDS};"):
        assert line in source


@pytest.mark.parametrize("case", MODEL_CASES)
def test_chunk_model_matches_the_jax_kernel(jax_tool, case):
    import jax.numpy as jnp

    seed, data, lut = model_case_inputs(case)
    want = np.asarray(jax_tool.run_vlc(jnp.asarray([seed], jnp.int32), data,
                                       lut))
    got, violations = chunk_model(seed, data, lut)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port(seed, data, lut), want)
    assert violations == 0


def test_lanes_meet_fixed_points_the_path_does_not():
    """The zero-advance case is what it claims: lanes stop at fixed points,
    the path from seed 0 does not, from seed 1 it does."""
    seed, data, lut = zero_advance_unreached()
    assert (chunk_maps(data, lut)[3] != 0).sum() > 100
    assert port(seed, data, lut)[1] < V.NBITS
    got, violations = chunk_model(1, data, lut)
    assert got[1] == V.NBITS and violations == 0
    np.testing.assert_array_equal(got, port(1, data, lut))


def test_chunk_model_on_the_all_zero_table():
    data, _ = T.make_inputs()
    zero = np.zeros(V.LUT_SIZE, np.int32)
    for seed in (0, 1):
        got, violations = chunk_model(seed, data, zero)
        assert got.tolist() == [0, V.NBITS, seed] and violations == 0


def test_a_lane_decodes_a_chunk_not_the_stream():
    """On the tool's draw a lane decodes ~34 symbols (256 bits at ~7.5 a
    symbol), not the path's 8,639."""
    data, lut = T.make_inputs()
    n = chunk_maps(data, lut)[1]
    assert n.shape == (CHUNKS, V.ENTRY_OFFSETS)
    assert 30 <= n.mean() <= 38 and n.max() <= 64


@pytest.mark.parametrize("entry_offsets, table", [(29, "advance_30"),
                                                  (20, "lut_long_codes")])
def test_too_few_entry_offsets_are_counted(entry_offsets, table):
    """The model counts exits that land on no entry offset, as the kernel
    does: with one offset too few (every symbol 15 + 15 bits) or with 20,
    some exits land past the next chunk's entry offsets."""
    seed, data, lut = case_inputs("lut_long_codes")
    if table == "advance_30":
        lut = np.full(V.LUT_SIZE, 0xF | 0xF << 4 | 3 << 8, np.int32)
    assert chunk_model(seed, data, lut, V.CHUNK_BITS, entry_offsets)[1] > 0
    assert chunk_model(seed, data, lut)[1] == 0


@st.composite
def vlc_draws(draw):
    """A stream and a table from a drawn seed: codes 1-15 plus value bits
    0-15, or with 1-8 zero-advance entries, or mostly 1-bit advances, or
    the tool's shape (codes 2-8, value bits 0-5); a start seed of any
    int32."""
    kind = draw(st.sampled_from(["long_codes", "zero_advance", "one_bit",
                                 "tool_shape"]))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    data = rng.integers(-2 ** 31, 2 ** 31, V.NWORDS,
                        np.int64).astype(np.int32)
    code = rng.integers(1, 16, V.LUT_SIZE)
    vbits = rng.integers(0, 16, V.LUT_SIZE)
    if kind == "zero_advance":
        idx = rng.choice(V.LUT_SIZE, draw(st.integers(1, 8)), replace=False)
        code[idx] = vbits[idx] = 0
    elif kind == "one_bit":
        ones = rng.random(V.LUT_SIZE) < draw(st.floats(0.6, 1.0))
        code[ones], vbits[ones] = 1, 0
    elif kind == "tool_shape":
        code = rng.integers(2, 9, V.LUT_SIZE)
        vbits = rng.integers(0, 6, V.LUT_SIZE)
    lut = (code | vbits << 4
           | rng.integers(0, 256, V.LUT_SIZE) << 8).astype(np.int32)
    return draw(st.integers(-2 ** 31, 2 ** 31 - 1)), data, lut


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(vlc_draws())
def test_chunk_model_matches_the_plain_version(drawn):
    seed, data, lut = drawn
    got, violations = chunk_model(seed, data, lut)
    np.testing.assert_array_equal(got, port(seed, data, lut))
    assert violations == 0

