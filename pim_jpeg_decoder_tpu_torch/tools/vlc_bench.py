"""Measures the variable-length-code decode rate of one GPU segment.

Counterpart of the repository's ``tools/tpu_vlc_bench.py``: the same
2,048-word bitstream and 256-entry table drawn from seed 0 (code lengths
2-8, value bits 0-5, so a symbol advances ~7.5 bits, as a q75 AC stream
does), one table probe per symbol, no stores.  The kernel
(``ops/vlc.py`` -> ``csrc/vlc.cu``) decodes the segment as 256-bit chunks
from each of their 30 entry offsets at once and composes the chunks' maps
across a cluster of 16 blocks.  That works because a symbol's advance here
depends on its bit position alone; in a JPEG scan it also depends on the
coefficient index and the table in use, so the rate is an upper bound on
a GPU entropy decoder, as the JAX tool's is on the TPU's scalar core.  The
kernel is first held against its plain version on the CPU, then timed with
``utils/devbench.seconds_per_launch`` (CUDA events), its start varied
through ``seed & 1`` as the JAX tool varies it.  Prints one JSON line with
the JAX tool's keys (``value`` in Mbit/s, ``msymbols_per_s``,
``bits_per_launch``, ``ns_per_symbol``).

    python -m pim_jpeg_decoder_tpu_torch.tools.vlc_bench

Needs a CUDA card (exit 2 without one); exit 1 if the kernel disagrees
with its plain version.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional, Tuple

import numpy as np

from pim_jpeg_decoder_tpu_torch.ops.vlc import LUT_SIZE, NWORDS

SEEDS = 8   # distinct seed tensors the timed launches cycle over


def make_inputs() -> Tuple[np.ndarray, np.ndarray]:
    """``(data, lut)``: the JAX tool's seed-0 draws, in its order."""
    rng = np.random.default_rng(0)
    data = rng.integers(-2**31, 2**31, NWORDS, np.int64).astype(np.int32)
    lens = rng.integers(2, 9, LUT_SIZE).astype(np.int32)        # 2..8
    vbits = rng.integers(0, 6, LUT_SIZE).astype(np.int32)       # 0..5
    vals = rng.integers(0, 256, LUT_SIZE).astype(np.int32)
    return data, lens | (vbits << 4) | (vals << 8)


def run() -> dict:
    """The tool's record on the current CUDA card; raises if the kernel
    disagrees with its plain version on seed 0 or 1."""
    import torch

    from pim_jpeg_decoder_tpu_torch.ops.vlc import vlc, vlc_reference
    from pim_jpeg_decoder_tpu_torch.utils.devbench import seconds_per_launch

    dev = torch.device("cuda")
    data, lut = (torch.from_numpy(a) for a in make_inputs())
    seeds = [torch.tensor([i], dtype=torch.int32) for i in range(SEEDS)]
    d_data, d_lut = data.to(dev), lut.to(dev)
    d_seeds = [s.to(dev) for s in seeds]
    for s, d_s in zip(seeds[:2], d_seeds[:2]):
        got = vlc(d_s, d_data, d_lut).cpu()
        want = vlc_reference(s, data, lut)
        if not torch.equal(got, want):
            raise RuntimeError(f"vlc kernel {got.tolist()} != plain version "
                               f"{want.tolist()} at seed {s.item()}")
    _, nsym, bits = vlc_reference(seeds[0], data, lut).tolist()
    dt = seconds_per_launch(lambda s: vlc(s, d_data, d_lut), d_seeds)
    return {
        "metric": f"GPU chunk-parallel VLC decode (upper bound), "
                  f"{torch.cuda.get_device_name(dev)}",
        "value": round(bits / dt / 1e6, 1),
        "unit": "Mbit/s",
        "msymbols_per_s": round(nsym / dt / 1e6, 2),
        "bits_per_launch": bits,
        "ns_per_symbol": round(dt / nsym * 1e9, 2),
        "note": "256-bit chunks decoded from every entry offset at "
                "once, their maps composed across a cluster; one "
                "256-entry shared-memory table probe per symbol, no "
                "stores - an upper bound on a one-segment GPU VLC "
                "decoder whose advance depends on the position alone",
    }


def main(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args:
        print(f"vlc_bench takes no arguments, got {args}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("vlc_bench needs a CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        record = run()
    except RuntimeError as exc:
        print(f"vlc_bench: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
