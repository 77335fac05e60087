"""Command-line entry: ``python -m pim_jpeg_decoder_tpu_torch <jpegs...>``

The JAX package's CLI flags, plus ``--device``: the inputs are sorted by
size, decoded through the pipelined engine on one device, a BMP is written
next to each input (extension replaced with .bmp), and a "Profiles:" block
is printed at exit: host stage times, the device program init, and the
per-phase device breakdown (``--device-profile``; cached under
``<tmp>/pim_jpeg_tpu_torch/phase_cache.json``).  ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the run into DIR.  Exit code 0 when
every file decoded, 1 otherwise (per-file errors on stderr).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="pim-jpeg-decoder-tpu-torch",
        description="GPU (PyTorch + CUDA) baseline JPEG -> BMP decoder",
    )
    parser.add_argument("files", nargs="+", help="JPEG files to decode")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N, or cpu "
                             "(the kernels' plain PyTorch versions)")
    parser.add_argument("--batch-mcus", type=int, default=None,
                        help="MCUs per packed device batch")
    parser.add_argument("--lane-tile", type=int, default=None,
                        help="MCU alignment of launch sizes")
    parser.add_argument("--prepare-threads", type=int, default=None,
                        help="host entropy-decode threads")
    parser.add_argument("--scale", type=int, default=None,
                        choices=(1, 2, 4, 8),
                        help="decode at 1/scale resolution through the "
                             "reduced-IDCT kernel (default 1)")
    parser.add_argument("--transport", default=None,
                        choices=("auto", "rgb", "ycbcr"),
                        help="device->host transport: ycbcr halves D2H "
                             "bytes for subsampled modes (default auto)")
    parser.add_argument("--wire", default=None, choices=("auto", "i16"),
                        help="host->device coefficient wire: auto ships "
                             "int8 when the batch fits, halving H2D bytes "
                             "(default auto)")
    parser.add_argument("--no-sort", action="store_true",
                        help="do not sort inputs by file size")
    parser.add_argument("--no-write", action="store_true",
                        help="decode only; skip BMP output")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress the profile report")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace (Chrome trace "
                             "JSON: host ops, kernels and copies) to DIR")
    parser.add_argument("--device-profile", nargs="?", const="measure",
                        default="cached", choices=("measure", "cached", "off"),
                        help="per-phase device timing in the Profiles block "
                             "(dequantize/IDCT/color, like the reference's "
                             "DPU cycle counters). Default 'cached' prints "
                             "disk-cached measurements and launches nothing; "
                             "'measure' times any missing launch geometry "
                             "now with the stage kernels")
    args = parser.parse_args(argv)

    import os
    if args.profile:
        os.environ["PIM_JPEG_TPU_PROFILE"] = args.profile

    from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine

    try:
        engine = DecodeEngine(config=EngineConfig.from_env(
            budget_mcus=args.batch_mcus,
            lane_tile=args.lane_tile,
            prepare_threads=args.prepare_threads,
            scale=args.scale,
            transport=args.transport,
            wire=args.wire,
        ), device=args.device)
    except (ValueError, NotImplementedError, RuntimeError) as e:
        parser.error(str(e))
    if not args.quiet:
        import torch
        dev = engine.device
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "host CPU")
        print(f"1 {dev.type} device allocated ({dev}: {name})")
    report = engine.decode_paths(args.files, write=not args.no_write,
                                 sort=not args.no_sort)

    failures = 0
    for r in report.results:
        if not r.ok:
            failures += 1
            print(f"{r.name}: {r.error}", file=sys.stderr)
        elif r.out_path and not args.quiet:
            print(f"{r.name} -> {r.out_path}")
    if not args.quiet:
        report.print_profile(device_phases=args.device_profile)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
