"""Host entropy-decode microbench over the port's own ``native/entropy.cpp``.

Counterpart of the JAX package's ``tools/entropy_bench.py`` (same arguments,
same three printed lines): builds the port's host corpus
(``tools/host_corpus.py``: 48 500x375 4:2:0 q75 JPEGs from the port's
encoder), then times ``native.decode_scan_native`` on one thread over
``reps`` passes.  The rates are not comparable with the JAX tool's, whose
corpus PIL encodes (see ``host_corpus``).

    python -m pim_jpeg_decoder_tpu_torch.tools.entropy_bench [reps] [--prog]

``--prog`` also times the progressive (SOF2) re-encodes of the corpus head,
serial and with the component chains on 3 threads; it needs PIL.  Exits 2,
timing nothing, when the native library does not load (the decoder would
fall back to Python) or when ``--prog`` is asked for without PIL.
"""

from __future__ import annotations

import os
import statistics
import sys

from pim_jpeg_decoder_tpu_torch.tools.host_corpus import (
    ToolUnavailable,
    corpus_headers,
    make_corpus,
    make_progressive_headers,
    megapixels,
    require_native,
    require_pil,
    timed_pass,
)


def _band(rates) -> dict:
    return {"median": statistics.median(rates), "min": min(rates),
            "max": max(rates)}


def _rates(decode, headers, reps: int) -> list:
    mp = megapixels(headers)
    return [timed_pass(decode, headers, mp) for _ in range(reps)]


def run(reps: int = 5, prog: bool = False) -> dict:
    """Time the corpus passes; returns ``host_entropy_mps`` (and with
    ``prog`` ``host_progressive_mps`` and ``host_progressive_chains_mps``)
    as ``{"median", "min", "max"}`` in MP/s, with the corpus size and the
    host's core count.  Raises :class:`ToolUnavailable` as ``main`` exits 2."""
    from pim_jpeg_decoder_tpu_torch.native import decode_scan_native

    require_native()
    if prog:
        require_pil()
    blobs = make_corpus()
    pheaders = make_progressive_headers(blobs) if prog else None
    headers, mp = corpus_headers(blobs)
    decode_scan_native(headers[0])   # load the library outside the timer
    out = {"host_entropy_mps": _band(_rates(decode_scan_native, headers,
                                            reps)),
           "reps": reps, "images": len(blobs), "mp_per_pass": mp,
           "host_cores": os.cpu_count()}
    if prog:
        from pim_jpeg_decoder_tpu_torch.codec.progressive import (
            decode_progressive)

        decode_progressive(pheaders[0])
        out["host_progressive_mps"] = _band(_rates(
            decode_progressive, pheaders, reps))
        # Component chains on 3 threads: about 1.0x or below on one core
        # (each chain re-decodes the DC scans); a lever on many cores.
        out["host_progressive_chains_mps"] = _band(_rates(
            lambda h: decode_progressive(h, threads=3), pheaders, reps))
    return out


def _line(name: str, band: dict) -> str:
    return (f"{name}: median={band['median']:.1f} min={band['min']:.1f} "
            f"max={band['max']:.1f}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv and argv[0].isdigit() else 5
    try:
        r = run(reps, prog="--prog" in argv)
    except ToolUnavailable as e:
        print(f"entropy_bench: {e}", file=sys.stderr)
        return 2
    print(f"{_line('host_entropy_mps', r['host_entropy_mps'])} over {reps} "
          f"reps, {r['images']} images, {r['mp_per_pass']:.1f} MP/pass")
    if "host_progressive_mps" in r:
        print(_line("host_progressive_mps", r["host_progressive_mps"]))
        print(f"{_line('host_progressive_chains_mps', r['host_progressive_chains_mps'])} "
              f"(threads=3, host_cores={r['host_cores']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
