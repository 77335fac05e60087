"""The port's tensor-core IDCT variants (``ops/mxu_idct.py``) against the
JAX package's ``tools/mxu_idct_ab.py``, and the port's A/B tool.

On CPU tensors the port runs the plain PyTorch versions of the CUDA kernels
in ``csrc/mxu_idct.cu``; the JAX tool's Pallas kernels run through its own
``_call`` in interpret mode (conftest forces the CPU backend) at M=512, one
JAX lane tile, on the tool's draw (int16 in [-2048, 2048)).  Tolerance 0:
both sides compute the same float32 products and round half to even.  The
CUDA kernels (TF32 products) are held against these plain versions on the
card by chip_smoke.py.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from pim_jpeg_decoder_tpu_torch.ops import decode_kernel as K
from pim_jpeg_decoder_tpu_torch.ops import mxu_idct as X
from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as SK
from pim_jpeg_decoder_tpu_torch.tools import mxu_idct_ab as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/mxu_idct_ab.py, loaded by path (``tools``
    is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_mxu_idct_ab", os.path.join(REPO, "tools", "mxu_idct_ab.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def draw(seed: int, m: int = 512) -> np.ndarray:
    """The tool's draw: int16 ``[m, 6, 64]`` in [-2048, 2048)."""
    rng = np.random.default_rng(seed)
    return rng.integers(-2048, 2048, (m, 6, 64)).astype(np.int16)


VARIANTS = {
    "mxu2pass": (lambda jt: jt._kernel_mxu2pass(jt.MODE, jt.LANE_TILE),
                 lambda d: X.mxu2pass_reference(d, 1)),
    "mxu2pass4": (lambda jt: jt._kernel_mxu2pass(jt.MODE, jt.LANE_TILE,
                                                 pieces=2),
                  lambda d: X.mxu2pass_reference(d, 2)),
    "mxu64": (lambda jt: jt._kernel_mxu64(jt.MODE, jt.LANE_TILE),
              X.mxu64_reference),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_version_matches_the_jax_kernel(jax_tool, variant, seed):
    """Each plain version equals the JAX tool's Pallas kernel, whose
    ``[g, 64, M]`` output is the port's ``[M, g, 64]`` transposed."""
    make, plain = VARIANTS[variant]
    kernel, mat = make(jax_tool)
    deq = draw(seed, jax_tool.LANE_TILE)
    want = np.asarray(jax_tool._call(kernel, mat)(deq)).transpose(2, 0, 1)
    got = plain(torch.from_numpy(deq))
    assert got.dtype == torch.int16 and tuple(got.shape) == deq.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_mxu64_matches_the_jax_kernel_on_full_range(jax_tool, seed):
    """The plain mxu64 equals the JAX tool's Pallas kernel at further
    seeds, on full-range int16 with both extremes (products past 2^24,
    rounded the same way on both sides)."""
    kernel, mat = VARIANTS["mxu64"][0](jax_tool)
    rng = np.random.default_rng(seed)
    deq = rng.integers(-32768, 32768, (jax_tool.LANE_TILE, 6, 64)).astype(
        np.int16)
    deq[0], deq[1] = 32767, -32768
    want = np.asarray(jax_tool._call(kernel, mat)(deq)).transpose(2, 0, 1)
    got = X.mxu64_reference(torch.from_numpy(deq))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variants_are_within_one_of_the_butterfly(variant):
    """The element order is the butterfly stage kernel's: every sample
    within 1 of ``idct_stage`` and nearly all equal."""
    deq = torch.from_numpy(draw(5, 256))
    got = VARIANTS[variant][1](deq).int()
    want = SK.idct_stage_reference(deq).int()
    diff = (got - want).abs()
    assert int(diff.max()) <= 1
    assert float((diff == 0).float().mean()) > 0.97


def test_basis_matrices():
    a = X.mat8()
    assert a.dtype == np.float32 and a.shape == (8, 8)
    assert np.abs(a).max() == 4017 and np.all(a == np.round(a))
    b = X.mat64()
    assert b.shape == (64, 64) and b[9, 18] == a[1, 2] * a[1, 2]
    assert np.abs(b).max() < 2 ** 24       # exact in float32
    assert (X.INV1, X.INV2, X.INV64) == (2.0 ** -11, 2.0 ** -15, 2.0 ** -26)


@pytest.mark.parametrize("pieces", [1, 2])
def test_rounding_is_half_to_even(pieces):
    """A pass on a DC coefficient of +-64 lands on +-90.5 in every row (the
    basis's DC column is 2,896 and 2,896 * 64 / 2**11 = 90.5): rounded half
    to even, +-90, as jnp.round gives, not half away from zero."""
    a = torch.from_numpy(X.mat8())
    x = torch.zeros(8, 2)
    x[0] = torch.tensor([64.0, -64.0])
    y = X._matpass(a, x, X.INV1, pieces)
    assert y[:, 0].tolist() == [90.0] * 8
    assert y[:, 1].tolist() == [-90.0] * 8


@pytest.mark.parametrize("pieces", [1, 2])
def test_cpu_entry_points_take_the_plain_path(pieces):
    deq = torch.from_numpy(draw(9, 33))
    before = K.launch_counts()
    assert torch.equal(X.mxu2pass(deq, pieces),
                       X.mxu2pass_reference(deq, pieces))
    assert torch.equal(X.mxu64(deq), X.mxu64_reference(deq))
    empty = deq[:0].contiguous()
    assert tuple(X.mxu2pass(empty, pieces).shape) == (0, 6, 64)
    assert tuple(X.mxu64(empty).shape) == (0, 6, 64)
    assert K.launch_counts() == before


@pytest.mark.parametrize("case", ["meta_device", "int32", "shape",
                                  "pieces", "strided"])
def test_wrappers_reject_bad_inputs(case):
    """A meta tensor raises instead of running the plain version; so do
    malformed inputs and a ``pieces`` other than 1 or 2."""
    deq = torch.zeros(4, 6, 64, dtype=torch.int16)
    pieces = 1
    if case == "meta_device":
        deq = deq.to("meta")
    elif case == "int32":
        deq = deq.int()
    elif case == "shape":
        deq = deq.view(4, 12, 32)
    elif case == "strided":
        deq = torch.zeros(4, 6, 128, dtype=torch.int16)[..., ::2]
    else:
        pieces = 4
    with pytest.raises(ValueError):
        X.mxu2pass(deq, pieces)
    if case != "pieces":
        with pytest.raises(ValueError):
            X.mxu64(deq)


def test_tool_exits_2_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    assert T.main([]) == 2
    assert "is_available() is False" in capsys.readouterr().err


def test_tool_rejects_unknown_variants(capsys):
    assert T.main(["mxu2pass", "nope"]) == 2
    assert "nope" in capsys.readouterr().err


def test_tool_geometry_and_draw_are_the_jax_tools(jax_tool):
    """The tool's geometry is the JAX tool's, and its first rotations are
    its seed-0 draws in order (checked at a small M); every variant names a
    launch counter."""
    assert (T.M, dataclasses.astuple(T.MODE)) == (
        jax_tool.M, dataclasses.astuple(jax_tool.MODE))
    rng = np.random.default_rng(0)
    rot = T.make_inputs(3, m=16)
    for buf in rot:
        np.testing.assert_array_equal(
            buf, rng.integers(-2048, 2048, (16, 6, 64)).astype(np.int16))
    assert set(T.VARIANTS) == {"butterfly", "mxu2pass", "mxu2pass4", "mxu64"}
    assert set(T.VARIANTS.values()) <= set(K.launch_counts())
    fns = T.variant_fns()
    deq = torch.from_numpy(rot[0])
    for name, (kernel, plain) in fns.items():
        assert torch.equal(kernel(deq), plain(deq)), name


def test_tool_difference_record():
    a = torch.tensor([[1, 2, 3, 4]], dtype=torch.int16)
    b = torch.tensor([[1, 4, 3, 3]], dtype=torch.int16)
    assert T.difference(a, b) == {"max_abs_diff": 2, "share_diff": 0.5}


def test_mxu2pass_geometry_matches_the_header():
    """``MXU2PASS_TILE`` / ``TILES_PER_WARP`` / ``WARPS_PER_BLOCK`` (read
    by chip_smoke.py's edge cases) are the values
    csrc/mxu_idct.cu compiles mxu2pass_kernel with."""
    import re

    with open(os.path.join(REPO, "pim_jpeg_decoder_tpu_torch", "csrc",
                           "mxu_idct.cu")) as f:
        text = f.read()
    for name, value in (("M2_TILE", X.MXU2PASS_TILE),
                        ("M2_TILES_P1", X.TILES_PER_WARP[1]),
                        ("M2_TILES_P2", X.TILES_PER_WARP[2]),
                        ("M2_WARPS", X.WARPS_PER_BLOCK)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert found and int(found.group(1)) == value


def test_mxu64_geometry_matches_the_header():
    """``MXU64_TILE`` / ``MXU64_PAIR`` / ``MXU64_UNITS`` / ``MXU64_WARPS``
    (read by chip_smoke.py's edge cases) are the values
    csrc/mxu_idct.cu compiles mxu64_kernel with."""
    import re

    with open(os.path.join(REPO, "pim_jpeg_decoder_tpu_torch", "csrc",
                           "mxu_idct.cu")) as f:
        text = f.read()
    for name, value in (("M64_TILE", X.MXU64_TILE),
                        ("M64_PAIR", X.MXU64_PAIR),
                        ("M64_UNITS", X.MXU64_UNITS),
                        ("M64_WARPS", X.MXU64_WARPS)):
        found = re.search(rf"constexpr int {name} = (\d+);", text)
        assert found and int(found.group(1)) == value


def test_mxu64_edge_shapes_cover_its_branches():
    """chip_smoke.py's mxu64 edge cases: 1, 15, 16, 17, 63, 64 and 65
    blocks, then a last CUDA block with a full warp, a ragged one and idle
    ones, a [5:] slice and M=196,608."""
    C = _chip_smoke()
    blocks, shapes = C.mxu_edge_shapes("mxu64")
    per_warp = X.MXU64_TILE * X.MXU64_PAIR * X.MXU64_UNITS
    per_block = per_warp * X.MXU64_WARPS
    assert blocks[:7] == (1, 15, 16, 17, 63, 64, 65)
    ragged = blocks[7]
    last = ragged - 3 * per_block
    assert 3 * per_block < ragged < 4 * per_block
    assert per_warp < last < 2 * per_warp   # warp 0 full, 1 ragged, 2-3 idle
    assert (last - per_warp) % X.MXU64_TILE != 0
    assert shapes[-2:] == ["slice", (196608, 6, 64)]
    assert shapes[:-2] == [(n, 1, 64) for n in blocks]
    assert C.mxu_edge_shapes("mxu2pass")[0] == (1, 7, 8, 9, 17, 109)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name, pieces", [("mxu2pass", 1),
                                          ("mxu2pass4", 2)])
def test_kernels_line_names_each_mxu2pass_instantiation(name, pieces):
    """chip_smoke's kernels line has an entry for each pieces of mxu2pass
    (``mxu2pass4`` is pieces 2), under a name of its own, from the same
    source and TPU kernel, held to its own tolerance; the IDCT tool runs
    both."""
    C = _chip_smoke()
    assert name in C.KERNELS and name in T.VARIANTS
    assert C.KERNELS[name] == C.KERNELS["mxu2pass"]
    names = [C.JSON_NAMES.get(k, f"decode_{k}") for k in C.KERNELS]
    assert len(set(names)) == len(names)
    assert C.JSON_NAMES[name].startswith(f"mxu_idct_2pass")
    assert ("4" in C.JSON_NAMES[name]) == (pieces == 2)
    assert C.MXU_TOLERANCE[name][0] == (2 if pieces == 1 else 0)
