"""Times the fused RGB kernel's experiment variants on a CUDA card.

Counterpart of the repository's ``tools/kernel_opt.py``: the same geometry
(4:2:0, M=16,384 MCUs, Q=16) and seed-0 inputs (coefficients in
[-200, 200), quantizers in [1, 64), MCU i on pool row i % 16).  Each
variant is first checked for exactness on rotation 0, then timed with
``utils/devbench.seconds_per_launch`` (CUDA events) over inputs rotated
past the L2 (``rotation_count``: at least 8 int16 and 16 int8 buffers).
Prints one line per variant, then one JSON line
``{name: {"us", "gps", "bit_exact"}}`` (gps: gigapixels per second).

    python -m pim_jpeg_decoder_tpu_torch.tools.kernel_opt [variant ...]

Variants (all by default), from ``ops/kernel_variants.py``:

- ``memfloor``, ``memfloor_i8``: the layout-matched memory floor, int16 /
  int8 wire; ``bit_exact`` is equality with its plain version.
- ``prod``, ``prod_i8``: ``decode_mcus(..., raw=True)``, i.e.
  ``rgb_kernel``, the reference of the decode variants.  The int8 wire
  carries the coefficients clipped to [-127, 127], and its reference is
  production on the same clipped values.
- ``chroma_truerez``: ``rgb_truerez``; ``stacked``: ``rgb_stacked``.

:func:`sweep` times every variant at each launch size of ``SWEEP_M``
(2,048 to 196,608 MCUs), the same draw at that M; ``chip_smoke.py``
prints it.

Not run: ``stacked_fusedmm`` differs from ``stacked`` only in gathering
the quantizers with one one-hot matmul on the TPU's matrix unit, which on
a GPU is the indexed load every kernel already does; ``prod_lt256`` and
``stacked_lt256`` change the TPU lane tile, a TPU block width, while the
CUDA kernels take ``TILE`` = 64 MCUs per block (``csrc/decode_common.cuh``).

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
Q = 16
# Variant -> (kernel, wire): a launch counter of
# ``ops/kernel_variants.KERNELS``, or ``prod`` for ``rgb_kernel``.
VARIANTS = {
    "memfloor": ("memfloor", "i16"),
    "memfloor_i8": ("memfloor", "i8"),
    "prod_i8": ("prod", "i8"),
    "chroma_truerez": ("truerez", "i16"),
    "prod": ("prod", "i16"),
    "stacked": ("stacked", "i16"),
}
TPU_ONLY = ("stacked_fusedmm", "prod_lt256", "stacked_lt256")
# Launch sizes of :func:`sweep`: from 32 blocks of 64 MCUs (latency-bound)
# to a B=256 batch of 500x375 4:2:0 images (196,608 MCUs).
SWEEP_M = (2048, 4096, M, 32768, 65536, 196608)


def make_inputs(n16: int, n8: int, m: int = M) -> Dict[str, list]:
    """``{"i16": [(coeffs, qidx, qpool)] * n16, "i8": [...] * n8}`` numpy
    rotations of ``m`` MCUs.  The first 8 coefficient buffers and the 8
    pools are the JAX tool's draws in its order; more coefficient buffers
    follow from the same generator.  int8 buffer i is int16 buffer i
    clipped."""
    rng = np.random.default_rng(0)

    def draw():
        return rng.integers(-200, 200, (m, MODE.g, 64)).astype(np.int16)

    coeffs = [draw() for _ in range(8)]
    pools = [rng.integers(1, 64, (Q, MODE.g, 64)).astype(np.float32)
             for _ in range(8)]
    coeffs += [draw() for _ in range(max(n16, n8) - 8)]
    qidx = (np.arange(m) % Q).astype(np.int32)
    i8 = [np.clip(c, -127, 127).astype(np.int8) for c in coeffs[:n8]]
    return {"i16": [(c, qidx, pools[i % 8])
                    for i, c in enumerate(coeffs[:n16])],
            "i8": [(c, qidx, pools[i % 8]) for i, c in enumerate(i8)]}


def _measure(names: Sequence[str], m: int) -> dict:
    """``{name: {"us", "gps", "bit_exact"}}`` of the variants ``names`` at
    ``m`` MCUs on the current CUDA card."""
    import torch

    from pim_jpeg_decoder_tpu_torch.ops import kernel_variants as KV
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        coeffs_to_device, decode_mcus, qpool_to_device)
    from pim_jpeg_decoder_tpu_torch.utils.devbench import (
        rotation_count, seconds_per_launch)

    dev = torch.device("cuda")
    wire_bytes = m * MODE.g * 64
    host = make_inputs(max(8, rotation_count(2 * wire_bytes, dev)),
                       max(16, rotation_count(wire_bytes, dev)), m)
    rot = {w: [(coeffs_to_device(c, dev), torch.from_numpy(qi).to(dev),
                qpool_to_device(qp, dev)) for c, qi, qp in bufs]
           for w, bufs in host.items()}
    del host
    kernels = {name: fn for name, (fn, _) in KV.KERNELS.items()}
    kernels["prod"] = lambda c, qi, qp, mode: decode_mcus(c, qi, qp, mode,
                                                          raw=True)
    c8, qi, qp = rot["i8"][0]
    want = {"i16": decode_mcus(*rot["i16"][0], MODE, raw=True),
            "i8": decode_mcus(c8.to(torch.int16), qi, qp, MODE, raw=True)}
    mp = m * 256 / 1e6
    results = {}
    for name in names:
        kernel, wire = VARIANTS[name]
        fn = kernels[kernel]
        got = fn(*rot[wire][0], MODE)
        if kernel == "memfloor":
            plain = KV.memfloor_reference(*(t.cpu() for t in rot[wire][0]),
                                          MODE)
            ok = torch.equal(got.cpu(), plain)
        else:
            ok = torch.equal(got, want[wire])
        us = seconds_per_launch(lambda b, fn=fn: fn(*b, MODE),
                                rot[wire]) * 1e6
        results[name] = {"us": round(us, 2), "gps": round(mp / us * 1e3, 1),
                         "bit_exact": bool(ok)}
    return results


def run(names: Sequence[str]) -> dict:
    """The variants ``names`` at the tool's geometry, one line each as
    measured; returns ``{name: {"us", "gps", "bit_exact"}}``."""
    results = _measure(names, M)
    for name, record in results.items():
        print(name, record, flush=True)
    return results


def sweep() -> Dict[int, dict]:
    """Every variant at each launch size of ``SWEEP_M`` (the tool's draw at
    that M, rotated past twice the L2): ``{m: {name: {"us", "gps",
    "bit_exact"}}}``."""
    return {m: _measure(list(VARIANTS), m) for m in SWEEP_M}


def main(argv: Optional[List[str]] = None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"kernel_opt: {', '.join(unknown)}: not a variant of the port "
              f"(choose from {', '.join(VARIANTS)}; {', '.join(TPU_ONLY)} "
              f"are TPU-only, see the module docstring)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_opt needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    print(json.dumps(run(names)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
