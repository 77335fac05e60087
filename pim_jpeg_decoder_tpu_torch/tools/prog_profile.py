"""Per-scan-type accounting for progressive (SOF2) host decode in the port.

Counterpart of the JAX package's ``tools/prog_profile.py`` (same argument,
same output): decodes the progressive re-encodes of the port's host corpus
(``tools/host_corpus.py``) through the port's image-level native entry
with per-scan timers (``native.binding.decode_progressive_image_cpp(
scan_seconds=...)``), then buckets the seconds by scan type:

  dc_first / dc_refine (interleaved)   the shared scans every component
                                       chain re-decodes
  ac_first[ci] / ac_refine[ci]         the per-component chain bodies

and prints (a) the share table, (b) the Python-side staging/assembly
overhead (wall minus in-native scan seconds), and (c) the component-chain
parallel speedup bound implied by the shares:

  T_chain(ci) = T_interleaved + T_noninterleaved(ci)
  speedup_bound = T_total / max_ci T_chain(ci)

    python -m pim_jpeg_decoder_tpu_torch.tools.prog_profile [reps]

Needs PIL for the progressive corpus and the native library; exits 2
without either.
"""

from __future__ import annotations

import statistics
import sys
import time
from collections import defaultdict

import numpy as np

from pim_jpeg_decoder_tpu_torch.tools.host_corpus import (
    ToolUnavailable,
    make_corpus,
    make_progressive_headers,
    megapixels,
    require_native,
    require_pil,
)


def scan_kind(header, scan) -> str:
    spec = scan.spec
    interleaved = scan.interleaved or (
        spec.start_of_selection == 0
        and len(scan.component_indices) == header.ncomp)
    if spec.start_of_selection == 0:
        base = "dc_first" if spec.successive_high == 0 else "dc_refine"
        return base + ("_il" if interleaved else f"[{scan.component_indices[0]}]")
    ci = scan.component_indices[0]
    base = "ac_first" if spec.successive_high == 0 else "ac_refine"
    return f"{base}[{ci}]"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 15
    from pim_jpeg_decoder_tpu_torch.native.binding import (
        decode_progressive_image_cpp,
    )

    try:
        require_native()
        require_pil()
    except ToolUnavailable as e:
        print(f"prog_profile: {e}", file=sys.stderr)
        return 2
    headers = make_progressive_headers(make_corpus())
    mp = megapixels(headers)

    decode_progressive_image_cpp(headers[0])  # load outside the timers

    by_kind = defaultdict(float)        # scan-type -> native seconds (best rep)
    walls, native_tot = [], []
    for _ in range(reps):
        kind_acc = defaultdict(float)
        t0 = time.monotonic()
        nat = 0.0
        for h in headers:
            secs = np.zeros(len(h.scans), np.float64)
            decode_progressive_image_cpp(h, scan_seconds=secs)
            for scan, s in zip(h.scans, secs):
                kind_acc[scan_kind(h, scan)] += float(s)
            nat += float(secs.sum())
        walls.append(time.monotonic() - t0)
        native_tot.append(nat)
        if nat == min(native_tot):
            by_kind = kind_acc
    wall = statistics.median(walls)
    nat = statistics.median(native_tot)

    print(f"progressive corpus: {len(headers)} images, {mp:.2f} MP")
    print(f"wall median: {wall * 1e3:.1f} ms  ({mp / wall:.1f} MP/s), "
          f"native scan seconds median: {nat * 1e3:.1f} ms "
          f"({mp / nat:.1f} MP/s)")
    print(f"python staging+assembly+alloc overhead: "
          f"{(wall - nat) * 1e3:.1f} ms ({(wall - nat) / wall:.1%})")
    print()
    total = sum(by_kind.values())
    print(f"{'scan type':<16} {'ms':>9} {'share':>7}")
    for kind, s in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"{kind:<16} {s * 1e3:>9.2f} {s / total:>7.1%}")

    # Chain decomposition: interleaved scans are decoded by EVERY chain;
    # noninterleaved scans belong to their component's chain.
    shared = sum(s for k, s in by_kind.items() if k.endswith("_il"))
    per_comp = defaultdict(float)
    for k, s in by_kind.items():
        if "[" in k:
            per_comp[int(k.split("[")[1][0])] += s
    print()
    print(f"interleaved (shared, re-decoded per chain): {shared * 1e3:.2f} ms"
          f" ({shared / total:.1%})")
    for ci, s in sorted(per_comp.items()):
        print(f"chain[{ci}]: noninterleaved {s * 1e3:.2f} ms, "
              f"T_chain = {(shared + s) * 1e3:.2f} ms")
    if per_comp:
        bound = total / (shared + max(per_comp.values()))
        print(f"3-core chain speedup bound (native share only): "
              f"{bound:.2f}x")
        py = wall - nat
        print(f"incl. serial python overhead: "
              f"{wall / (py + shared + max(per_comp.values())):.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
