"""The port's two scaling harnesses over gloo, 2 and 4 CPU ranks.

Counterpart of ``tests/test_multiprocess.py``: every rank runs
``pim_jpeg_decoder_tpu_torch.tools.scaling_bench`` (the BMP engine) or
``tools.batch_scaling_bench`` (the batch API) with ``--device cpu``, joins
the group at ``tcp://localhost:PORT``, decodes only its whole images, and
rank 0 reports the metadata all-gather.  Ranks write to files, not pipes
(a rank that filled its pipe while rank 0 waited in a collective would
deadlock), and every rank is killed at a deadline, which fails the test.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(tool: str, n_procs: int, *extra: str) -> dict:
    port = _free_port()
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    logs, procs = [], []
    for rank in range(n_procs):
        fo = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
        fe = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
        logs.append((fo, fe))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"pim_jpeg_decoder_tpu_torch.tools.{tool}",
             "--num-processes", str(n_procs), "--process-id", str(rank),
             "--coordinator", f"localhost:{port}", "--device", "cpu",
             *extra], stdout=fo, stderr=fe, env=env, cwd=REPO, text=True))
    deadline = time.monotonic() + DEADLINE_S
    late = []
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                late.append(p.pid)
    finally:
        for p in procs:   # a hung rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for fo, fe in logs:
        fo.seek(0)
        fe.seek(0)
        outs.append((fo.read(), fe.read()))
        fo.close()
        fe.close()
    assert not late, f"ranks {late} passed the {DEADLINE_S} s deadline"
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}\n{err[-2000:]}"
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")]
    assert lines, f"rank 0 printed no JSON:\n{outs[0][0]}\n{outs[0][1]}"
    for out, _ in outs[1:]:
        assert not [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


@pytest.mark.parametrize("n_procs", [2, 4])
def test_batch_api_harness(n_procs):
    """Per-rank oracle equality, balanced shares of an equal-size corpus,
    and only the (megapixels, wall, ok) rows cross processes."""
    report = _run_ranks("batch_scaling_bench", n_procs, "--images", "8")
    assert report["hosts"] == n_procs
    assert report["equality_ok"] is True
    assert report["value"] > 0
    assert len(report["per_host_mps"]) == n_procs
    assert report["mp_balance"] >= 0.99
    assert report["dcn_bytes"] == n_procs * 3 * 8 <= 64 * n_procs
    assert report["device"] == "host CPU"


@pytest.mark.parametrize("n_procs", [2, 4])
def test_engine_scaling_harness(n_procs):
    report = _run_ranks("scaling_bench", n_procs, "--images", "8",
                        "--baseline-mps", "1.0")
    assert report["hosts"] == n_procs
    assert report["value"] > 0
    assert report["scaling_efficiency"] > 0
    # Equal-size corpus, sorted strided split: megapixels balance exactly.
    assert report["mp_balance"] >= 0.99
    assert report["dcn_bytes"] == n_procs * 2 * 8 <= 64 * n_procs
    assert report["device"] == "host CPU"
