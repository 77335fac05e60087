"""The port's experiment kernels (``ops/kernel_variants.py``) against the
JAX package's ``tools/kernel_opt.py`` variants, and its timing tool.

On CPU tensors the port runs the plain PyTorch versions of the CUDA
kernels in ``csrc/kernel_opt.cu``; the JAX tool's Pallas variants run
through its own ``variant_call`` in interpret mode (conftest forces the
CPU backend) at M=512, one JAX lane tile.  Same numpy inputs, drawn from a
seed as the tool draws them (coefficients in [-200, 200), quantizers in
[1, 64), Q=16); tolerance 0, because the spec is integer arithmetic.  The
CUDA kernels are held against the same plain versions and against
``rgb_kernel`` on the card by chip_smoke.py.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu.ops import specs as S
from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import kernel_variants as V
from pim_jpeg_decoder_tpu_torch.tools import kernel_opt as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODE = S.mode_for((2, 2, 3))
COLOUR_KEYS = [k for k in sorted(S.MODES) if S.MODES[k].ncomp == 3]
COLOUR = pytest.mark.parametrize("mode_key", COLOUR_KEYS,
                                 ids=[S.MODES[k].name for k in COLOUR_KEYS])


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/kernel_opt.py, loaded by path (``tools`` is
    not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_kernel_opt", os.path.join(REPO, "tools", "kernel_opt.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tool_inputs(mode, m, seed, wire=np.int16):
    """The tool's draw: coefficients in [-200, 200) (clipped to [-127,
    127] for the int8 wire, as the tool clips them), quantizers in [1, 64),
    Q=16, MCU i on pool row i % 16."""
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-200, 200, (m, mode.g, 64)).astype(np.int16)
    if wire is np.int8:
        coeffs = np.clip(coeffs, -127, 127).astype(np.int8)
    qidx = (np.arange(m) % 16).astype(np.int32)
    qpool = rng.integers(1, 64, (16, mode.g, 64)).astype(np.float32)
    return coeffs, qidx, qpool


def extreme_inputs(mode, m, seed, wire):
    """Uniform coefficients over the wire's range, an all-max, an all-min
    and an alternating block, and a 16-bit quantizer row: the extremes
    reach DEQUANT_CLAMP and wrap the IDCT's int32 arithmetic."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(wire)
    coeffs = np.clip(np.round(rng.laplace(0.0, 8.0, (m, mode.g, 64))),
                     info.min, info.max).astype(wire)
    coeffs[3:m // 3] = rng.integers(info.min, int(info.max) + 1,
                                    (m // 3 - 3, mode.g, 64))
    coeffs[0] = info.max
    coeffs[1] = info.min
    coeffs[2, :, ::2] = info.max
    coeffs[2, :, 1::2] = info.min
    qpool = rng.integers(1, 64, (3, mode.g, 64)).astype(np.float32)
    qpool[2] = rng.integers(1, 65536, (mode.g, 64))
    qidx = rng.integers(0, 3, m).astype(np.int32)
    qidx[:m // 3] = 2
    return coeffs, qidx, qpool


def port_inputs(coeffs, qidx, qpool):
    return (torch.from_numpy(coeffs), torch.from_numpy(qidx),
            K.qpool_to_device(qpool, "cpu"))


@pytest.mark.parametrize("variant,wire", [
    ("memfloor", np.int16), ("memfloor", np.int8),
    ("chroma_truerez", np.int16), ("stacked", np.int16)],
    ids=["memfloor", "memfloor_i8", "chroma_truerez", "stacked"])
def test_plain_version_matches_the_jax_variant(jax_tool, variant, wire):
    """Each plain version equals the JAX tool's Pallas variant, whose
    ``[3, gy*64, M]`` output is the port's ``[3, gy, 64, M]``."""
    import jax.numpy as jnp

    make_kernel = {"memfloor": jax_tool._kernel_memfloor,
                   "chroma_truerez": jax_tool._kernel_chroma_truerez,
                   "stacked": jax_tool._kernel_stacked}[variant]
    port = {"memfloor": V.memfloor, "chroma_truerez": V.rgb_truerez,
            "stacked": V.rgb_stacked}[variant]
    m = jax_tool.LANE_TILE
    coeffs, qidx, qpool = tool_inputs(MODE, m, seed=11, wire=wire)
    want = np.asarray(jax_tool.variant_call(
        make_kernel, wire_dtype=jnp.dtype(wire))(coeffs, qidx, qpool))
    got = port(*port_inputs(coeffs, qidx, qpool), MODE)
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == (3, MODE.luma_slots, 64, m)
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))


@pytest.mark.parametrize("wire", [np.int16, np.int8], ids=["i16", "i8"])
@COLOUR
def test_memfloor_is_the_wrapped_sum(mode_key, wire):
    """``u8(c[s] + c[gy] + c[gy+1])`` of int32, truncated, in all three
    planes; negative and wrapping sums included."""
    mode = S.mode_for(mode_key)
    coeffs, qidx, qpool = extreme_inputs(mode, 101, seed=5, wire=wire)
    got = V.memfloor(*port_inputs(coeffs, qidx, qpool), mode).numpy()
    c = coeffs.astype(np.int32)
    gy = mode.luma_slots
    want = (c[:, :gy] + c[:, gy:gy + 1] + c[:, gy + 1:gy + 2]).astype(
        np.uint8).transpose(1, 2, 0)
    for plane in got:
        np.testing.assert_array_equal(plane, want)


@pytest.mark.parametrize("m", [1, 15, 17, 31, 33, 65, "slice"])
@pytest.mark.parametrize("wire", [np.int16, np.int8], ids=["i16", "i8"])
@COLOUR
def test_memfloor_at_ragged_m_and_on_a_slice(mode_key, wire, m):
    """The plain floor at M values around the kernel's 32-MCU tile and its
    16-byte stores, and on a ``coeffs[5:]`` slice (the kernel's inputs on
    the card in chip_smoke.py's tile cases), against the NumPy wrapped
    sum of every plane."""
    mode = S.mode_for(mode_key)
    n = 1032 if m == "slice" else m
    coeffs, qidx, qpool = extreme_inputs(mode, max(n, 30), seed=n, wire=wire)
    coeffs, qidx = coeffs[:n], qidx[:n]
    args = port_inputs(coeffs, qidx, qpool)
    if m == "slice":
        coeffs, qidx = coeffs[5:], qidx[5:]
        args = (args[0][5:], args[1][5:], args[2])
    got = V.memfloor(*args, mode).numpy()
    c = coeffs.astype(np.int64)
    gy = mode.luma_slots
    want = ((c[:, :gy] + c[:, gy:gy + 1] + c[:, gy + 1:gy + 2]) % 256).astype(
        np.uint8).transpose(1, 2, 0)
    assert got.shape == (3, gy, 64, len(coeffs))
    for plane in got:
        np.testing.assert_array_equal(plane, want)


@pytest.mark.parametrize("m", [1001, 64, 1])
@pytest.mark.parametrize("wire", [np.int16, np.int8], ids=["i16", "i8"])
@COLOUR
@pytest.mark.parametrize("variant", ["truerez", "stacked"])
def test_decode_variants_equal_the_fused_plain_version(variant, mode_key,
                                                       wire, m):
    """truerez and stacked give ``decode_mcus_reference(raw=True)`` for
    every colour mode, on extreme blocks, at a ragged M."""
    mode = S.mode_for(mode_key)
    coeffs, qidx, qpool = extreme_inputs(mode, max(m, 30), seed=m, wire=wire)
    args = port_inputs(coeffs[:m].copy(), qidx[:m].copy(), qpool)
    fn = V.rgb_truerez if variant == "truerez" else V.rgb_stacked
    got = fn(*args, mode)
    want = K.decode_mcus_reference(*args, mode, raw=True)
    assert got.shape == want.shape and got.dtype == torch.uint8
    assert torch.equal(got, want)


def test_no_launch_on_cpu_and_empty_batches():
    mode = S.mode_for((2, 1, 3))
    coeffs, qidx, qpool = tool_inputs(mode, 9, seed=3)
    before = K.launch_counts()
    for fn in (V.memfloor, V.rgb_truerez, V.rgb_stacked):
        assert tuple(fn(*port_inputs(coeffs, qidx, qpool), mode).shape) == (
            3, 2, 64, 9)
        empty = port_inputs(coeffs[:0].copy(), qidx[:0].copy(), qpool)
        assert tuple(fn(*empty, mode).shape) == (3, 2, 64, 0)
    assert K.launch_counts() == before


def _valid(mode):
    return (torch.zeros(4, mode.g, 64, dtype=torch.int16),
            torch.zeros(4, dtype=torch.int32),
            torch.ones(1, mode.g, 64, dtype=torch.int32))


@pytest.mark.parametrize("fn", [V.memfloor, V.rgb_truerez, V.rgb_stacked],
                         ids=["memfloor", "truerez", "stacked"])
@pytest.mark.parametrize("case", ["meta_device", "gray", "int32_coeffs",
                                  "float_qpool", "short_qidx"])
def test_wrappers_reject_bad_inputs(fn, case):
    """Neither CPU nor CUDA raises instead of running the plain version; so
    do a gray mode (no chroma slots) and malformed inputs."""
    mode = MODE
    c, qi, qp = _valid(mode)
    if case == "meta_device":
        c, qi, qp = (t.to("meta") for t in (c, qi, qp))
    elif case == "gray":
        mode = S.mode_for((1, 1, 1))
        c, qi, qp = _valid(mode)
    elif case == "int32_coeffs":
        c = c.int()
    elif case == "float_qpool":
        qp = qp.float()
    else:
        qi = qi[:3]
    with pytest.raises(ValueError):
        fn(c, qi, qp, mode)


def test_tool_exits_2_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    assert T.main([]) == 2
    assert "is_available() is False" in capsys.readouterr().err


def test_tool_rejects_unknown_and_unported_variants(capsys):
    """``stacked_fusedmm`` and the 256-lane-tile variants are TPU-only
    (see the tool's docstring): named, they are refused before any card
    is looked for."""
    for name in ("stacked_fusedmm", "prod_lt256", "nope"):
        assert T.main([name]) == 2
        assert name in capsys.readouterr().err


def test_tool_variants_name_the_ported_kernels():
    """Every variant runs a kernel of ``ops/kernel_variants.KERNELS`` or
    production, on a wire the rotations have; each kernel is timed; the
    sweep covers the tool's own M."""
    kernels = {k for k, _ in T.VARIANTS.values()}
    assert kernels == set(V.KERNELS) | {"prod"}
    assert {w for _, w in T.VARIANTS.values()} == {"i16", "i8"}
    assert T.M in T.SWEEP_M and list(T.SWEEP_M) == sorted(T.SWEEP_M)
    assert not set(T.TPU_ONLY) & set(T.VARIANTS)


def test_tool_inputs_are_the_jax_tools_draw(jax_tool):
    """The tool's geometry is the JAX tool's, and rotation 0 is its seed-0
    draw (the first coefficient buffer, drawn before 7 more and then the
    quantizer pools); the rotations have the sizes asked for, the int8
    buffers the clipped int16 ones (checked at a small M)."""
    assert (T.M, dataclasses.astuple(T.MODE), T.Q) == (
        jax_tool.M, dataclasses.astuple(jax_tool.MODE), jax_tool.Q)
    m = 64
    rot = T.make_inputs(n16=9, n8=17, m=m)
    rng = np.random.default_rng(0)
    first = rng.integers(-200, 200, (m, MODE.g, 64)).astype(np.int16)
    np.testing.assert_array_equal(rot["i16"][0][0], first)
    for _ in range(7):
        rng.integers(-200, 200, (m, MODE.g, 64))
    pool = rng.integers(1, 64, (T.Q, MODE.g, 64)).astype(np.float32)
    np.testing.assert_array_equal(rot["i16"][0][2], pool)
    np.testing.assert_array_equal(rot["i16"][0][1], np.arange(m) % T.Q)
    assert len(rot["i16"]) == 9 and len(rot["i8"]) == 17
    np.testing.assert_array_equal(
        rot["i8"][3][0], np.clip(rot["i16"][3][0], -127, 127))
    assert rot["i8"][3][0].dtype == np.int8
    assert len({a[0].tobytes() for a in rot["i8"]}) == 17
