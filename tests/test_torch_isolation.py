"""The PyTorch port stays free of JAX, never hides a missing card, and
builds its CUDA kernels for Hopper into a gitignored directory."""

import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from pim_jpeg_decoder_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pim_jpeg_decoder_tpu_torch")


def _run(code, cwd=REPO, timeout=300):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_decodes_without_loading_jax(tmp_path):
    """In a fresh process (this one has JAX loaded by conftest): importing
    every port module and decoding through the API, the engine and the CLI
    on the CPU, with a JPEG made by the port's own encoder, and running the
    tools' plain versions, leaves ``jax``, ``pim_jpeg_decoder_tpu`` and
    every ``pim_jpeg_decoder_tpu.*`` module out of ``sys.modules``."""
    proc = _run(f"""
        import importlib
        import pkgutil
        import sys
        import numpy as np
        import pim_jpeg_decoder_tpu_torch as port
        for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            if not info.name.endswith("__main__"):
                importlib.import_module(info.name)
        import pim_jpeg_decoder_tpu_torch.cli
        import pim_jpeg_decoder_tpu_torch.ops.mxu_idct as mxu
        import pim_jpeg_decoder_tpu_torch.ops.vlc as vlc
        import pim_jpeg_decoder_tpu_torch.tools.vlc_bench as vlc_bench
        import torch
        from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg
        from pim_jpeg_decoder_tpu_torch.ops.specs import mode_for
        assert len([m for m in sys.modules
                    if m.startswith("pim_jpeg_decoder_tpu_torch.")]) > 40
        img = np.random.default_rng(0).integers(0, 256, (40, 48, 3),
                                                 dtype=np.uint8)
        data = encode_jpeg(img, sampling="4:2:0")
        rgb = port.decode_bytes(data, device="cpu")
        assert rgb.shape == (40, 48, 3)
        assert port.decode_scaled(data, 2, device="cpu").shape == (20, 24, 3)
        assert port.decode_region(data, 1, 2, 8, 9,
                                  device="cpu").shape == (8, 9, 3)
        batch, _ = port.decode_same_size_batch(
            [data] * 2, scale=2, dtype=torch.bfloat16, mean=128.0, std=64.0,
            device="cpu")
        assert batch.shape == (2, 20, 24, 3)
        for crops, _ in port.iter_decode_batch_crops(
                [([data] * 2, [(0, 0), (8, 8)])], (16, 16), device="cpu"):
            assert crops.shape == (2, 16, 16, 3)
        path = {str(tmp_path / 'x.jpg')!r}
        open(path, "wb").write(data)
        rc = pim_jpeg_decoder_tpu_torch.cli.main([path, "--device", "cpu",
                                                  "--quiet", "--scale", "4"])
        assert rc == 0, rc
        rc = pim_jpeg_decoder_tpu_torch.cli.main(
            [path, "--device", "cpu", "--device-profile", "measure",
             "--profile", {str(tmp_path / "trace")!r}])
        assert rc == 0, rc
        staged = pim_jpeg_decoder_tpu_torch.ops.stage_kernels
        assert staged.decode_mcus_staged(
            torch.zeros(2, 6, 64, dtype=torch.int8),
            torch.zeros(2, dtype=torch.int32),
            torch.ones(1, 6, 64, dtype=torch.int32),
            mode_for((2, 2, 3))).shape == (2, 4, 64, 3)
        variants = pim_jpeg_decoder_tpu_torch.ops.kernel_variants
        for fn in (variants.memfloor, variants.rgb_truerez,
                   variants.rgb_stacked):
            assert fn(torch.zeros(2, 6, 64, dtype=torch.int16),
                      torch.zeros(2, dtype=torch.int32),
                      torch.ones(1, 6, 64, dtype=torch.int32),
                      mode_for((2, 2, 3))).shape == (3, 4, 64, 2)
        deq = torch.zeros(3, 6, 64, dtype=torch.int16)
        for out in (mxu.mxu2pass(deq), mxu.mxu2pass(deq, pieces=2),
                    mxu.mxu64(deq)):
            assert out.shape == (3, 6, 64)
        words, table = (torch.from_numpy(a) for a in vlc_bench.make_inputs())
        assert vlc.vlc(torch.zeros(1, dtype=torch.int32), words,
                       table).tolist() == [1113556, 8639, 65475]
        assert "jax" not in sys.modules, "jax was imported"
        jax_pkg = [m for m in sys.modules if m == "pim_jpeg_decoder_tpu"
                   or m.startswith("pim_jpeg_decoder_tpu.")]
        assert not jax_pkg, jax_pkg
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


# An import of the JAX package or of any module under it (never of
# ``pim_jpeg_decoder_tpu_torch``, which starts with the same name).
JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+pim_jpeg_decoder_tpu(?!\w)"
    r"|import\s+[^#\n]*\bpim_jpeg_decoder_tpu(?!\w))"
    r"|(import_module|__import__)\(\s*['\"]pim_jpeg_decoder_tpu(?!\w)", re.M)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_jax_package_import_in_port_sources():
    """No module of the port and not chip_smoke.py imports the JAX package
    or any module under it (the port keeps its own host layer)."""
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                      for m in JAX_PACKAGE_IMPORT.finditer(src)]
    assert offenders == []


@pytest.mark.parametrize("line,hit", [
    ("from pim_jpeg_decoder_tpu.ops import specs as S", True),
    ("    from pim_jpeg_decoder_tpu.native import binding", True),
    ("import pim_jpeg_decoder_tpu", True),
    ("import pim_jpeg_decoder_tpu.codec.encoder as enc", True),
    ("from pim_jpeg_decoder_tpu import decode_bytes", True),
    ("importlib.import_module('pim_jpeg_decoder_tpu.cli')", True),
    ("import pim_jpeg_decoder_tpu.ops.specs  # a comment", True),
    ("import os, pim_jpeg_decoder_tpu.io.bmp", True),
    ("__import__(\"pim_jpeg_decoder_tpu\")", True),
    ("import pim_jpeg_decoder_tpu_torch.ops.specs  # a comment", False),
    ("from pim_jpeg_decoder_tpu_torch import cli", False),
    ("from pim_jpeg_decoder_tpu_torch.ops import specs as S", False),
    ("import pim_jpeg_decoder_tpu_torch.cli", False),
    ("    Counterpart of ``pim_jpeg_decoder_tpu/ops/specs.py``", False),
])
def test_jax_package_import_pattern(line, hit):
    """The static scan tells the JAX package from the port by the full
    name, never by the bare prefix."""
    assert bool(JAX_PACKAGE_IMPORT.search(line)) is hit


def test_no_jax_import_in_port_sources():
    offenders = []
    files = _port_sources()
    for path in files:
        with open(path) as f:
            src = f.read()
        if re.search(r"^\s*(import jax|from jax)", src, re.M):
            offenders.append(path)
    assert len(files) > 8
    assert offenders == []


def test_cuda_device_raises_without_a_card():
    import torch

    from pim_jpeg_decoder_tpu_torch.models.pipeline import (
        TorchJpegDecoder, decode_bytes)
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchJpegDecoder()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchJpegDecoder(device="cuda:0")
    with pytest.raises(RuntimeError, match="cuda"):
        decode_bytes(b"\xff\xd8")
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeEngine()


def test_cli_default_device_errors_without_a_card(tmp_path, capsys):
    import torch

    from pim_jpeg_decoder_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    (tmp_path / "a.jpg").write_bytes(b"\xff\xd8")
    with pytest.raises(SystemExit) as exc:
        main([str(tmp_path / "a.jpg")])
    assert exc.value.code == 2
    assert "is_available() is False" in capsys.readouterr().err
    assert not (tmp_path / "a.bmp").exists()


def test_nvcc_command_targets_sm90a_under_the_gitignored_build_dir():
    """One nvcc per source (all started together), then one link."""
    out = os.path.join(_build.build_dir(), _build.LIB_NAME)
    compiles, link = _build.nvcc_commands(out)
    assert [cmd[-1] for cmd in compiles] == [
        os.path.join(PORT, "csrc", name)
        for name in ("decode_kernel.cu", "kernel_opt.cu", "mxu_idct.cu",
                     "raster_epilogue.cu", "stage_kernels.cu", "vlc.cu")]
    for cmd in compiles:
        assert cmd[0] == "nvcc"
        i = cmd.index("-gencode")
        assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
        for flag in ("-O3", "-c", "-std=c++17"):
            assert flag in cmd
        assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
        obj = cmd[cmd.index("-o") + 1]
        assert os.path.dirname(obj) == os.path.dirname(out)
        assert obj in link
    assert link[:4] == ["nvcc", "-shared", "-o", out]
    rel = os.path.relpath(out, REPO)
    assert rel.startswith(os.path.join("pim_jpeg_decoder_tpu_torch",
                                       "_build") + os.sep)
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert "pim_jpeg_decoder_tpu_torch/_build/" in ignored


def test_build_dir_follows_the_source_content(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build.build_dir()
    assert first == _build.build_dir()
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.build_dir() != first


def test_build_dir_follows_the_header_content(tmp_path, monkeypatch):
    """A shared header is hashed with the sources: an edit to it is a new
    build directory, never a stale library."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build.build_dir()
    (tmp_path / "common.cuh").write_text("// two\n")
    assert _build.build_dir() != first
    compiles, _ = _build.nvcc_commands(os.path.join(first, _build.LIB_NAME))
    assert [cmd[-1] for cmd in compiles] == [str(tmp_path / "k.cu")]


def test_missing_nvcc_raises_a_clear_error(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """No card: non-zero exit and no result line.  Alone in a directory
    (no checkout beside it): non-zero exit too."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only case")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
