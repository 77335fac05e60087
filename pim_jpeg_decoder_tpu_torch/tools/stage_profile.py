"""Per-stage device time on a CUDA card, and what fusion saves.

Counterpart of the repository's ``tools/stage_profile.py``: the dequantize,
IDCT and colour stage kernels and the fused RGB kernel, timed at one
16,384-MCU 4:2:0 launch with the int16 wire and a 16-deep quantizer pool
(the reference DPU's per-phase cycle counters, and the fusion ratio), with
:func:`runtime.device_profile.time_phases` (CUDA events over inputs
rotated past the L2).  Prints one JSON line with the same keys.

    python -m pim_jpeg_decoder_tpu_torch.tools.stage_profile

Needs a CUDA card: a CPU run is not a device time.
"""

from __future__ import annotations

import json
import sys

# 4:2:0, M=16,384 MCUs, int16 wire, Q=16, full scale, RGB transport.
MODE_KEY = (2, 2, 3)
M = 16384


def profile(device="cuda") -> dict:
    from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig
    from pim_jpeg_decoder_tpu_torch.runtime.device_profile import time_phases

    key = (MODE_KEY, M, EngineConfig().lane_tile, "rgb", 1, "i16", 16)
    t = time_phases(key, device)
    mp = M * 256 / 1e6
    staged = t["dequantize_us"] + t["idct_us"] + t["color_us"]
    return {
        "megapixels_per_launch": mp,
        "dequantize_us": t["dequantize_us"],
        "idct_us": t["idct_us"],
        "color_convert_us": t["color_us"],
        "staged_total_us": round(staged, 1),
        "fused_us": t["fused_us"],
        "fusion_speedup": round(staged / t["fused_us"], 2),
        "fused_mps": round(mp / t["fused_us"] * 1e6, 1),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stage_profile needs a CUDA card (torch.cuda.is_available() "
              "is False)", file=sys.stderr)
        return 2
    print(json.dumps(profile()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
