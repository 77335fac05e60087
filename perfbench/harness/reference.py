"""The reference side of the comparison that decides ``correct``.

The reference decodes the files the run sent (plain Python and NumPy) on
worker processes once the window has closed, and works out what the
program should have produced from them.  The decoder is a module of
``harness/`` found by name: ``jpeg_ref`` (baseline files at full scale)
unless the traffic file, or else the configuration, names another under
``"reference"``, so that a mix the baseline decoder cannot read
(progressive files, a scaled output) brings a module of its own with a
``decode_rgb(data, idct, scale)`` and edits none.  Nothing here imports
the program or takes anything it made; ``torch`` is handed in by the
caller and used only to compare on the program's device.
"""

from __future__ import annotations

import importlib
import os
import pickle
import re
import subprocess
import sys
from typing import Dict

import numpy as np

MAX_WORKERS = 8
_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A worker process: plain Python over pipes (no multiprocessing, so no
# semaphore files and no helper process).
_WORKER = ("import sys; sys.path.insert(0, {here!r}); "
           "from harness import reference; reference.work()")


DEFAULT_MODULE = "jpeg_ref"


def module_name(traffic: dict, config: dict) -> str:
    """The reference decoder a cell names: the traffic's, else the
    configuration's, else ``jpeg_ref``."""
    name = traffic.get("reference", config.get("reference", DEFAULT_MODULE))
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"not a module of harness/: {name!r}")
    return name


def decoder(name: str):
    """The module ``harness/<name>.py``."""
    return importlib.import_module(f"harness.{name}")


def _decode(args):
    index, data, idct, module, scale = args
    return index, decoder(module).decode_rgb(data, idct, scale)


def work() -> None:
    """Decode the pickled jobs read from stdin; pickle the results out."""
    jobs = pickle.load(sys.stdin.buffer)
    pickle.dump(dict(map(_decode, jobs)), sys.stdout.buffer,
                protocol=pickle.HIGHEST_PROTOCOL)
    sys.stdout.buffer.flush()


def decode_all(datas: Dict[int, bytes], idct: str = "int",
               module: str = DEFAULT_MODULE, scale: int = 1,
               workers: int = 0) -> Dict[int, np.ndarray]:
    """Reference RGB of each file by the decoder ``module`` at ``scale``,
    on up to ``MAX_WORKERS`` worker processes (all ended before this
    returns)."""
    decoder(module)
    items = [(i, d, idct, module, scale) for i, d in sorted(datas.items())]
    n = min(workers or os.cpu_count() or 1, MAX_WORKERS, len(items))
    if n <= 1:
        return dict(map(_decode, items))
    # Largest first, dealt round the workers.
    items.sort(key=lambda it: -len(it[1]))
    shares = [items[k::n] for k in range(n)]
    procs = [subprocess.Popen([sys.executable, "-c",
                               _WORKER.format(here=_HERE)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in shares]
    out: Dict[int, np.ndarray] = {}
    try:
        for proc, share in zip(procs, shares):
            proc.stdin.write(pickle.dumps(share))
            proc.stdin.close()
        for proc in procs:
            # Bytes that our own worker wrote.
            out.update(pickle.loads(proc.stdout.read()))
            if proc.wait() != 0:
                raise RuntimeError(f"a reference worker exited with "
                                   f"{proc.returncode}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
    return out


def normalize_bf16(rgb: np.ndarray, mean, std) -> np.ndarray:
    """``(pixel - mean) / std`` in float32, rounded to bfloat16 (nearest,
    ties to even): the bits as int16."""
    x = ((rgb.astype(np.float32) - np.asarray(mean, np.float32))
         / np.asarray(std, np.float32))
    bits = x.view(np.uint32)
    rounded = (bits + np.uint32(0x7FFF) + ((bits >> 16) & 1)) >> 16
    return rounded.astype(np.uint16).view(np.int16)


def fp8_control(torch, bits):
    """The control of a bfloat16 output: the same values through float8
    e4m3, the next precision below; bfloat16 bits back as int16."""
    values = bits.view(torch.bfloat16)
    return values.to(torch.float8_e4m3fn).to(torch.bfloat16).view(
        torch.int16)


def _ordered(torch, bits):
    u = bits.to(torch.int32) & 0xFFFF
    mag = u & 0x7FFF
    return torch.where(u >= 0x8000, -mag, mag)


def ulp_gap(torch, got_bits, want_bits) -> int:
    """The widest distance between two bfloat16 tensors (as int16 bits) in
    steps of the bfloat16 grid; +0 and -0 are one point."""
    gap = (_ordered(torch, got_bits) - _ordered(torch, want_bits)).abs()
    return int(gap.max()) if gap.numel() else 0
