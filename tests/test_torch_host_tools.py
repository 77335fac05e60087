"""The port's host-decode tools against the JAX package's, on the CPU.

``pim_jpeg_decoder_tpu_torch/tools/{entropy_bench,prog_profile,src_ab,
pgo_ab,asan_drive}.py`` measure and check the port's own
``native/entropy.cpp`` over the port's PIL-free host corpus
(``tools/host_corpus.py``).  They must print the JAX tools' keys, decode
the corpus exactly as the JAX package's native decoder does (tolerance 0:
integer coefficients), refuse to time the Python decoder as native, gate
a diverging source variant, train the profile build where the port's
binding loads it, and run clean under ASan and UBSan without loading torch.
"""

import importlib.util
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from pim_jpeg_decoder_tpu.codec.scanner import scan_jpeg as jax_scan_jpeg
from pim_jpeg_decoder_tpu.native import decode_scan_native as jax_native
from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
from pim_jpeg_decoder_tpu_torch.native import binding, decode_scan_native
from pim_jpeg_decoder_tpu_torch.tools import (
    entropy_bench,
    host_corpus,
    pgo_ab,
    prog_profile,
    src_ab,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("host_corpus", "entropy_bench", "prog_profile", "src_ab", "pgo_ab",
         "asan_drive", "fuzz")


@pytest.fixture(scope="module")
def corpus():
    return host_corpus.make_corpus()


@pytest.fixture(scope="module")
def progressive(corpus):
    return host_corpus.make_progressive_headers(corpus)


def _run(args, tmp_path, timeout):
    """A tool as ``python -m``, with the port's cache in ``tmp_path``."""
    env = dict(os.environ, PYTHONPATH=REPO,
               PIM_JPEG_TPU_CACHE=str(tmp_path))
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_host_corpus_is_the_bench_geometry(corpus):
    assert len(corpus) == host_corpus.NUM_IMAGES == 48
    assert len({data for _, data in corpus}) == 48        # distinct images
    for _, data in corpus:
        h = scan_jpeg(data)
        assert (h.width, h.height, h.mode_key) == (500, 375, (2, 2, 3))
        assert not h.progressive
    assert host_corpus.make_corpus() is corpus              # once a process


def test_bilinear_resize_is_within_one_of_pil():
    from PIL import Image

    small = np.random.default_rng(0).integers(0, 256, (9, 13, 3), np.uint8)
    for w, h in ((500, 375), (37, 21), (13, 9)):
        want = np.array(Image.fromarray(small).resize((w, h),
                                                      Image.BILINEAR))
        got = host_corpus.bilinear_resize(small, w, h)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1


def test_native_decode_equals_jax_package_on_the_corpus(corpus):
    for name, data in corpus:
        np.testing.assert_array_equal(
            decode_scan_native(scan_jpeg(data)),
            jax_native(jax_scan_jpeg(data)), err_msg=name)


def test_entropy_bench_run_gives_the_jax_tool_keys(corpus, capsys):
    r = entropy_bench.run(reps=1, prog=True)
    for key in ("host_entropy_mps", "host_progressive_mps",
                "host_progressive_chains_mps"):
        assert set(r[key]) == {"median", "min", "max"}
        assert 0 < r[key]["min"] <= r[key]["median"] <= r[key]["max"]
    assert r["images"] == 48 and r["reps"] == 1
    assert r["mp_per_pass"] == pytest.approx(48 * 500 * 375 / 1e6)
    assert entropy_bench.main(["1", "--prog"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "host_entropy_mps", "host_progressive_mps",
        "host_progressive_chains_mps"]
    assert re.match(r"host_entropy_mps: median=[\d.]+ min=[\d.]+ "
                    r"max=[\d.]+ over 1 reps, 48 images, 9.0 MP/pass",
                    lines[0])


def test_scan_kind_equals_jax_tool(progressive):
    spec = importlib.util.spec_from_file_location(
        "jax_tools_prog_profile",
        os.path.join(REPO, "tools", "prog_profile.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    assert len(progressive) == 12
    kinds = set()
    for h in progressive:
        assert h.progressive
        for scan in h.scans:
            kind = prog_profile.scan_kind(h, scan)
            assert kind == jax_tool.scan_kind(h, scan)
            kinds.add(kind)
    assert {"dc_first_il", "ac_first[0]", "ac_refine[2]"} <= kinds


def test_prog_profile_prints_the_share_table(corpus, capsys):
    assert prog_profile.main(["1"]) == 0
    out = capsys.readouterr().out
    assert "progressive corpus: 12 images" in out
    assert "3-core chain speedup bound" in out


@pytest.mark.parametrize("tool,argv", [
    (entropy_bench, ["1"]),
    (prog_profile, ["1"]),
    (src_ab, [src_ab.SRC, "1"]),
    (pgo_ab, ["1"]),
])
def test_host_tools_exit_2_without_the_native_library(monkeypatch, capsys,
                                                      tool, argv):
    """The binding would fall back to the Python decoder: nothing is timed
    as native."""
    monkeypatch.setenv("PIM_JPEG_TPU_NO_NATIVE", "1")
    assert tool.main(argv) == 2
    captured = capsys.readouterr()
    assert "native entropy library did not load" in captured.err
    assert "MP/s" not in captured.out


@pytest.mark.parametrize("tool,argv", [
    (entropy_bench, ["1", "--prog"]),
    (prog_profile, ["1"]),
])
def test_progressive_tools_exit_2_without_pil(monkeypatch, capsys, tool,
                                              argv):
    monkeypatch.setattr(host_corpus, "pil_image", lambda: None)
    assert tool.main(argv) == 2
    assert "PIL is not installed" in capsys.readouterr().err


def test_src_ab_gate_passes_the_unchanged_source(corpus, tmp_path,
                                                 monkeypatch, capsys):
    monkeypatch.setenv("PIM_JPEG_TPU_CACHE", str(tmp_path))
    before = binding.load()
    assert src_ab.main([src_ab.SRC, "1"]) == 0
    out = capsys.readouterr().out
    assert "correctness gate passed" in out
    assert re.search(r"variant/base = \d+\.\d{3}", out)
    assert os.path.exists(tmp_path / "pim_jpeg_tpu_torch" / "src_ab" /
                          "variant.so")
    assert binding.load() is before      # the binding's library restored


def test_src_ab_refuses_a_diverging_variant(corpus, tmp_path, monkeypatch,
                                            capsys):
    """A variant that offsets every DC coefficient by one compiles, loads
    and is refused before any timing."""
    with open(src_ab.SRC) as f:
        src = f.read()
    dc = "out[0] = static_cast<int16_t>(*dc_pred);"
    assert src.count(dc) >= 1
    variant = tmp_path / "variant.cpp"
    variant.write_text(src.replace(
        dc, "out[0] = static_cast<int16_t>(*dc_pred + 1);"))
    monkeypatch.setenv("PIM_JPEG_TPU_CACHE", str(tmp_path))
    assert src_ab.main([str(variant), "1"]) == 1
    out = capsys.readouterr().out
    assert "VARIANT DIVERGES" in out and "MP/s" not in out


def test_pgo_ab_trains_the_build_the_binding_loads(corpus, tmp_path,
                                                   monkeypatch, capsys):
    monkeypatch.setenv("PIM_JPEG_TPU_CACHE", str(tmp_path))
    assert pgo_ab.main(["1"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"pgo/plain = \d+\.\d{3}", out)
    work = tmp_path / "pim_jpeg_tpu_torch" / "pgo_ab"
    assert pgo_ab.gcda_files(str(work / "prof"))
    trained = os.path.basename(binding.library_path())
    assert (work / "gen_cache" / "pim_jpeg_tpu_torch" / trained).exists()


@pytest.mark.parametrize("flags,line", [([], "ASAN-CLEAN"),
                                        (["--ubsan"], "UBSAN-CLEAN")])
def test_asan_drive_runs_clean(tmp_path, flags, line):
    proc = _run(["pim_jpeg_decoder_tpu_torch.tools.asan_drive", "0", "8",
                 *flags], tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert re.fullmatch(rf"{line} \d+ decodes", proc.stdout.strip())
    built = "ubsan" if flags else "asan"
    assert (tmp_path / "pim_jpeg_tpu_torch" / "asan" /
            f"entropy_{built}.so").exists()


def test_host_tools_load_no_torch(tmp_path):
    """The sanitized process must not load torch: no host tool (nor the
    fuzz module, whose table generator the drive uses) imports it."""
    code = textwrap.dedent(f"""
        import sys
        for name in {TOOLS!r}:
            __import__("pim_jpeg_decoder_tpu_torch.tools." + name)
        assert "torch" not in sys.modules
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "OK"
