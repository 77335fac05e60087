"""Times the IDCT on the tensor cores against the butterflies on a CUDA
card.

Counterpart of the repository's ``tools/mxu_idct_ab.py``: the same
geometry (4:2:0, M=16,384 MCUs: 98,304 8x8 blocks) and seed-0 inputs
(int16 dequantized coefficients in [-2048, 2048)), timed with
``utils/devbench.seconds_per_launch`` (CUDA events) over inputs rotated past
twice the L2 (``rotation_count``: 9 buffers of 12.6 MB on an H100).  Each
variant is first held against its plain version, run on the CPU on
rotation 0 (so that no plain version runs on the card).  Prints one line per
variant, then one JSON line ``{name: {"us", "max_abs_diff",
"share_diff"}}`` (the largest difference from the plain version and the
share of samples that differ).

    python -m pim_jpeg_decoder_tpu_torch.tools.mxu_idct_ab [variant ...]

Variants (all by default):

- ``butterfly``: ``stage_kernels.idct_stage``, the integer Loeffler
  butterflies (``idct_stage_kernel``); equal to its plain version.
- ``mxu2pass``, ``mxu2pass4``: ``mxu_idct.mxu2pass`` with ``pieces`` 1 and
  2; ``mxu64``: ``mxu_idct.mxu64`` (``csrc/mxu_idct.cu``).  TF32 products:
  ``mxu2pass4`` equals its float32 plain version, the other two differ by
  1-2 in a few percent of samples.

Needs a CUDA card: a CPU run is not a device time.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from pim_jpeg_decoder_tpu_torch.ops import specs as S

M = 16384
MODE = S.mode_for((2, 2, 3))
# Variant -> launch counter of the kernel it runs.
VARIANTS = {"butterfly": "idct", "mxu2pass": "mxu2pass",
            "mxu2pass4": "mxu2pass", "mxu64": "mxu64"}


def make_inputs(n: int, m: int = M) -> List[np.ndarray]:
    """``n`` int16 ``[m, g, 64]`` draws in [-2048, 2048) from seed 0, the
    first 8 in the JAX tool's order."""
    rng = np.random.default_rng(0)
    return [rng.integers(-2048, 2048, (m, MODE.g, 64)).astype(np.int16)
            for _ in range(n)]


def variant_fns() -> Dict[str, tuple]:
    """``{name: (wrapper, plain version)}``, each taking int16
    ``[M, g, 64]``."""
    from pim_jpeg_decoder_tpu_torch.ops import mxu_idct as X
    from pim_jpeg_decoder_tpu_torch.ops import stage_kernels as SK

    return {
        "butterfly": (lambda d: SK.idct_stage(d, MODE),
                      SK.idct_stage_reference),
        "mxu2pass": (X.mxu2pass, X.mxu2pass_reference),
        "mxu2pass4": (lambda d: X.mxu2pass(d, pieces=2),
                      lambda d: X.mxu2pass_reference(d, pieces=2)),
        "mxu64": (X.mxu64, X.mxu64_reference),
    }


def difference(got, want) -> dict:
    """``{"max_abs_diff", "share_diff"}`` of two int16 tensors."""
    diff = (got.int() - want.int()).abs()
    return {"max_abs_diff": int(diff.max()) if diff.numel() else 0,
            "share_diff": float((diff > 0).float().mean())
            if diff.numel() else 0.0}


def run(names: Sequence[str]) -> dict:
    """The variants ``names`` at the tool's geometry on the current CUDA
    card, one line each as measured; returns ``{name: {"us",
    "max_abs_diff", "share_diff"}}``."""
    import torch

    from pim_jpeg_decoder_tpu_torch.utils.devbench import (
        rotation_count, seconds_per_launch)

    dev = torch.device("cuda")
    n = max(8, rotation_count(M * MODE.g * 64 * 2, dev))
    rot = [torch.from_numpy(d).to(dev) for d in make_inputs(n)]
    first = rot[0].cpu()
    fns = variant_fns()
    results = {}
    for name in names:
        kernel, plain = fns[name]
        record = {}
        got = kernel(rot[0])
        record.update(difference(got.cpu(), plain(first)))
        us = seconds_per_launch(kernel, rot) * 1e6
        results[name] = {"us": round(us, 2), **record}
        print(f"{name:<12} {us:8.2f} us/launch ({M} MCUs, 4:2:0); vs plain "
              f"max|diff| {record['max_abs_diff']}, share "
              f"{record['share_diff']:.5f}", flush=True)
    return results


def main(argv: Optional[List[str]] = None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"mxu_idct_ab: {', '.join(unknown)}: not a variant (choose "
              f"from {', '.join(VARIANTS)})", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("mxu_idct_ab needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    print(json.dumps(run(names)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
