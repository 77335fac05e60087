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
    on the CPU leaves ``jax`` out of ``sys.modules``."""
    proc = _run(f"""
        import sys
        import numpy as np
        import pim_jpeg_decoder_tpu_torch as port
        import pim_jpeg_decoder_tpu_torch.cli
        import pim_jpeg_decoder_tpu_torch.ops._build
        import pim_jpeg_decoder_tpu_torch.runtime.batching
        from pim_jpeg_decoder_tpu.codec.encoder import encode_jpeg
        img = np.random.default_rng(0).integers(0, 256, (40, 48, 3),
                                                 dtype=np.uint8)
        data = encode_jpeg(img, sampling="4:2:0")
        rgb = port.decode_bytes(data, device="cpu")
        assert rgb.shape == (40, 48, 3)
        path = {str(tmp_path / 'x.jpg')!r}
        open(path, "wb").write(data)
        rc = pim_jpeg_decoder_tpu_torch.cli.main([path, "--device", "cpu",
                                                  "--quiet"])
        assert rc == 0, rc
        assert "jax" not in sys.modules, "jax was imported"
        print("OK")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_no_jax_import_in_port_sources():
    offenders = []
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]   # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
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
    out = os.path.join(_build.build_dir(), _build.LIB_NAME)
    cmd = _build.nvcc_command(out)
    assert cmd[0] == "nvcc"
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-O3", "-shared", "-std=c++17"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-o") + 1] == out
    assert os.path.join(PORT, "csrc", "decode_kernel.cu") in cmd
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
