"""Multi-process harness of the batch API: a same-size batch per process.

Counterpart of the repository's ``tools/batch_scaling_bench.py`` (sibling
of ``tools/scaling_bench.py``, which drives the BMP engine).  Each process
joins the gloo group, takes its strided share of a deterministic
same-size 4:2:0 corpus (made by the port's encoder, the same on every
rank), decodes it with ``decode_same_size_batch`` on its own device,
checks every image against the port's NumPy oracle, and the ranks
all-gather (megapixels, wall seconds, ok) as one float64 tensor; rank 0
prints one JSON line:

  {"hosts": N, "value": aggregate_mps, "per_host_mps": [...],
   "equality_ok": true, "mp_balance": ..., "dcn_bytes": ...}

Only that all-gather crosses processes: pixels never do.

    python -m pim_jpeg_decoder_tpu_torch.tools.batch_scaling_bench \\
        --num-processes 2 --process-id R --coordinator localhost:PORT \\
        --images 8 --device cpu        # or cuda / cuda:N

Exit 3 when an image differs from the oracle.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    # One core per rank, capped before numpy loads (oversubscription
    # stalls the gloo handshake).
    for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                 "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, "1")

import numpy as np  # noqa: E402


def make_corpus(n: int):
    """``n`` same-size 64x48 4:2:0 JPEGs (quality 78-87), named
    ``img{i:03d}``; the same bytes on every rank (seed 424242)."""
    from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg

    rng = np.random.default_rng(424242)
    out = []
    for i in range(n):
        small = rng.integers(0, 256, (6, 8, 3))
        img = np.kron(small, np.ones((8, 8, 1))) + rng.normal(0.0, 3.0,
                                                             (48, 64, 3))
        out.append((f"img{i:03d}", encode_jpeg(
            np.clip(img, 0, 255).astype(np.uint8), quality=78 + i % 10,
            sampling="4:2:0")))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-processes", type=int, required=True)
    parser.add_argument("--process-id", type=int, required=True)
    parser.add_argument("--coordinator", default="localhost:9876")
    parser.add_argument("--images", type=int, default=8)
    parser.add_argument("--device", default="cuda",
                        help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from pim_jpeg_decoder_tpu_torch.models.input_pipeline import (
        decode_same_size_batch)
    from pim_jpeg_decoder_tpu_torch.oracle.decoder import (
        decode_bytes_oracle)
    from pim_jpeg_decoder_tpu_torch.parallel.multihost import (
        initialize_distributed, partition_paths)
    from pim_jpeg_decoder_tpu_torch.tools.scaling_bench import (
        all_gather_rows, device_name)

    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id)
    corpus = make_corpus(args.images)
    mine = set(partition_paths([n for n, _ in corpus]))
    shard = [b for n, b in corpus if n in mine]
    if not shard:
        raise SystemExit("empty shard")

    def decode():
        out, headers = decode_same_size_batch(shard, device=args.device)
        return out.cpu().numpy(), headers      # waits for the device

    rgb, headers = decode()                    # warm-up: kernel build
    ok = all(np.array_equal(rgb[i], decode_bytes_oracle(data).rgb)
             for i, data in enumerate(shard))
    t0 = time.monotonic()
    _, headers = decode()
    wall = time.monotonic() - t0
    mp = sum(h.width * h.height for h in headers) / 1e6

    stats = all_gather_rows([mp, wall, 1.0 if ok else 0.0])
    if args.process_id == 0:
        per_host = [float(m / w) for m, w, _ in stats]
        print(json.dumps({
            "hosts": args.num_processes,
            "value": round(sum(per_host), 3),
            "unit": "MP/s (aggregate)",
            "per_host_mps": [round(v, 3) for v in per_host],
            "equality_ok": bool(stats[:, 2].all()),
            "mp_balance": round(float(stats[:, 0].min()
                                      / stats[:, 0].max()), 4),
            "dcn_bytes": int(stats.nbytes),
            "device": device_name(args.device),
        }))
    dist.destroy_process_group()
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
