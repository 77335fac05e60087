"""Multi-process scaling harness of the BMP engine: whole images per process.

Counterpart of the repository's ``tools/scaling_bench.py``.  Each process
decodes its strided share of a deterministic corpus (made by the port's
own encoder, the same on every rank) on its own devices through
``DecodeEngine``, then the ranks all-gather their (megapixels, wall
seconds) as one float64 tensor over gloo, and rank 0 prints the
aggregate throughput as one JSON line.  That all-gather is the only data
that crosses processes (``dcn_bytes``): pixels, coefficients and files
never do (``parallel/multihost.py``).

Single process (the baseline for ``--baseline-mps``):
    python -m pim_jpeg_decoder_tpu_torch.tools.scaling_bench --device cpu

N processes on one machine, each with its share of the cores:
    python -m pim_jpeg_decoder_tpu_torch.tools.scaling_bench \\
        --num-processes 2 --process-id R --coordinator localhost:PORT \\
        --device cpu        # or cuda / cuda:N

Exit 0 when every image of the rank's share decoded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _early_thread_caps() -> None:
    """Split the machine's cores between the simulated hosts before numpy
    loads: OpenBLAS reads OMP/OPENBLAS/MKL_NUM_THREADS when the library
    loads, so setting them later is a no-op and the simulation would
    measure core thrash, not scaling.  (``torch.set_num_threads`` follows
    in ``main``.)"""
    n = _num_processes(sys.argv)
    if n > 1:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                    "MKL_NUM_THREADS"):
            os.environ.setdefault(var, str(_cores_per_process(n)))


def _num_processes(argv) -> int:
    for i, a in enumerate(argv):
        if a == "--num-processes" and i + 1 < len(argv):
            return int(argv[i + 1])
        if a.startswith("--num-processes="):
            return int(a.split("=", 1)[1])
    return 0


def _cores_per_process(n: int) -> int:
    return max(1, (os.cpu_count() or 8) // n)


if __name__ == "__main__":
    _early_thread_caps()

import numpy as np  # noqa: E402  (after the BLAS thread caps, see above)


def make_corpus(n: int):
    """``n`` 500x375 4:2:0 q75 JPEGs of smooth random photos, named
    ``img{i}``; the same bytes on every rank (seed 7)."""
    from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg

    rng = np.random.default_rng(7)
    blobs = []
    for i in range(n):
        small = rng.integers(0, 256, (24, 32, 3))
        img = np.kron(small, np.ones((16, 16, 1)))[:375, :500]
        img = img + rng.normal(0.0, 4.0, img.shape)
        blobs.append((f"img{i}", encode_jpeg(
            np.clip(img, 0, 255).astype(np.uint8), quality=75,
            sampling="4:2:0")))
    return blobs


def device_name(device: str) -> str:
    """The device a result was measured on, as the report names it."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "host CPU"


def all_gather_rows(values) -> np.ndarray:
    """Every rank's ``values`` (float64) as rows of one array, by
    ``torch.distributed.all_gather`` over gloo."""
    import torch
    import torch.distributed as dist

    mine = torch.tensor(values, dtype=torch.float64)
    rows = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, mine)
    return torch.stack(rows).numpy()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--coordinator", default="localhost:9876")
    parser.add_argument("--images", type=int, default=32)
    parser.add_argument("--baseline-mps", type=float, default=None,
                        help="single-process MP/s for efficiency reporting "
                             "(measure it on the same device type)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (every local card), cuda:N or cpu")
    parser.add_argument("--cpu", action="store_true",
                        help="the same as --device cpu")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    import torch

    from pim_jpeg_decoder_tpu_torch.parallel.multihost import (
        initialize_distributed, partition_paths, process_index)
    from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine

    multi = args.num_processes is not None and args.num_processes > 1
    if multi:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(_cores_per_process(args.num_processes))
        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)

    corpus = make_corpus(args.images)
    # Sort by size before the strided split so per-process megapixels
    # balance (see partition_paths).
    corpus.sort(key=lambda kv: (len(kv[1]), kv[0]))
    mine = set(partition_paths([n for n, _ in corpus]))
    shard = [(n, b) for n, b in corpus if n in mine]

    engine = DecodeEngine(budget_mcus=4096, lane_tile=256, device=device)
    engine.decode_named_blobs(shard)   # warm-up: kernel build, caches
    t0 = time.monotonic()
    report = engine.decode_named_blobs(shard)
    dt = time.monotonic() - t0
    if report.ok_count != len(shard):
        errs = [(r.name, r.error) for r in report.results if not r.ok]
        raise SystemExit(f"decode failures on shard: {errs[:4]}")
    local_mp = report.total_megapixels

    if not multi:
        print(json.dumps({
            "metric": "single-process decode throughput",
            "hosts": 1,
            "value": round(local_mp / dt, 2),
            "unit": "MP/s",
            "device": device_name(device),
        }))
        return 0
    import torch.distributed as dist

    stats = all_gather_rows([local_mp, dt])
    # The only data that crosses processes: the (megapixels, wall) rows.
    dcn_bytes = int(stats.nbytes)
    if process_index() == 0:
        mps = float(stats[:, 0].sum()) / float(stats[:, 1].max())
        out = {
            "metric": "multi-host decode throughput",
            "hosts": args.num_processes,
            "value": round(mps, 2),
            "unit": "MP/s",
            # Per-process megapixel balance of the sorted strided split
            # (min/max): an uneven split caps efficiency by its makespan.
            "mp_balance": round(float(stats[:, 0].min())
                                / float(stats[:, 0].max()), 3),
            "dcn_bytes": dcn_bytes,
            "device": device_name(device),
            "note": "the processes share one machine's cores",
        }
        if args.baseline_mps:
            out["scaling_efficiency"] = round(
                mps / (args.baseline_mps * args.num_processes), 3)
        print(json.dumps(out))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
