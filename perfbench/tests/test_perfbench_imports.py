"""Nothing the benchmark runs imports JAX or the JAX package: the
top-level module name (before the first dot) is compared whole, since the
port's name begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from harness import cell

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def test_forbidden_names_compared_whole():
    found = cell.forbidden_modules([
        "pim_jpeg_decoder_tpu_torch", "pim_jpeg_decoder_tpu_torch.ops",
        "numpy", "jaxtyping", "pim_jpeg_decoder_tpu.ops.specs", "jax.numpy",
        "jaxlib", "flax.linen"])
    assert found == ["flax.linen", "jax.numpy", "jaxlib",
                     "pim_jpeg_decoder_tpu.ops.specs"]


def test_sources_import_no_jax():
    for dirpath, _, names in os.walk(HERE):
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                else:
                    continue
                assert not cell.forbidden_modules(mods), (name, mods)


def test_a_run_loads_no_jax():
    """A whole small run on the CPU in a fresh process, then sys.modules."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from conftest import run_small\n"
        "from harness import cell\n"
        "if __name__ == '__main__':\n"
        "    out = run_small('engine-imagenet-val')\n"
        "    assert out.result['correct']\n"
        "    print('FOUND', cell.forbidden_modules())\n"
        % (os.path.join(HERE, "tests"), HERE))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FOUND []" in proc.stdout


def test_no_card_no_result():
    """Without a card the harness prints no result and exits non-zero."""
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "engine-imagenet-val", "--seed", "3", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
