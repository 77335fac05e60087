"""A/B two builds of the port's ``native/entropy.cpp`` in one process.

Counterpart of the JAX package's ``tools/src_ab.py`` (same arguments and
output) over the port's own source and host corpus
(``tools/host_corpus.py``): builds the port's ``entropy.cpp`` and a
patched variant, loads both libraries, and interleaves timed corpus passes
while routing the port's ``native.binding`` through each in turn
(``binding.use_library``); interleaved in-process timing is what resolves
small deltas on a shared host.  Correctness gate first: the variant must
decode the whole corpus byte for byte equal to the base before any timing,
else the tool exits 1 with "VARIANT DIVERGES".

    python -m pim_jpeg_decoder_tpu_torch.tools.src_ab <variant.cpp> [reps] [--prog]

The libraries are built under the port's cache directory
(``$TMPDIR/pim_jpeg_tpu_torch/src_ab``, or under ``$PIM_JPEG_TPU_CACHE``).
Exits 2 when the native library does not load, or for ``--prog`` without
PIL.  ``tools/pgo_ab.py`` shares its build and timing helpers.
"""

from __future__ import annotations

import os
import statistics
import subprocess
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

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "entropy.cpp")
# The flags of the port's own build (native/binding.py:_build).
BASE_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]


REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def module_env(**overrides) -> dict:
    """This process's environment for a ``python -m`` child of the port's
    tools: the checkout on ``PYTHONPATH``, then ``overrides``."""
    path = os.pathsep.join([REPO, *filter(None, [os.environ.get(
        "PYTHONPATH")])])
    return dict(os.environ, PYTHONPATH=path, **overrides)


def work_dir(name: str) -> str:
    from pim_jpeg_decoder_tpu_torch.native import binding

    path = os.path.join(binding._cache_dir(), name)
    os.makedirs(path, exist_ok=True)
    return path


def build(jobs) -> None:
    """Build ``(source, output, extra flags)`` jobs with g++, all started
    together; raises with g++'s message when one fails."""
    procs = []
    for src, out, extra in jobs:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        procs.append(subprocess.Popen(
            ["g++", *BASE_FLAGS, *extra, src, "-o", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (src, out, _), proc in zip(jobs, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"g++ failed building {out} from {src}:\n{log}")


def interleaved(libs: dict, headers, mp: float, reps: int,
                pheaders=None) -> tuple:
    """``reps`` rounds, each one corpus pass a library in turn (and one
    progressive pass with ``pheaders``): ``({name: [MP/s]}, {name:
    [progressive MP/s]})``."""
    from pim_jpeg_decoder_tpu_torch.codec.progressive import decode_progressive
    from pim_jpeg_decoder_tpu_torch.native import binding, decode_scan_native

    rates = {k: [] for k in libs}
    prates = {k: [] for k in libs}
    pmp = megapixels(pheaders or ())
    for _ in range(reps):
        for name, lib in libs.items():
            with binding.use_library(lib):
                rates[name].append(timed_pass(decode_scan_native, headers,
                                              mp))
                if pheaders:
                    prates[name].append(timed_pass(decode_progressive,
                                                   pheaders, pmp))
    return rates, prates


class VariantDiverges(RuntimeError):
    """The variant's output differs from the base's on the corpus."""


def run(variant_src: str, reps: int = 15, prog: bool = False) -> dict:
    """Build, gate, then time base and variant; returns ``{"base": [MP/s],
    "variant": [MP/s], "prog": {...}, "ratio": variant/base medians}``.
    Raises :class:`VariantDiverges` before timing when the variant's
    coefficients differ on any corpus image."""
    import numpy as np

    from pim_jpeg_decoder_tpu_torch.native import binding, decode_scan_native

    require_native()
    if prog:
        require_pil()
    work = work_dir("src_ab")
    base_so = os.path.join(work, "base.so")
    var_so = os.path.join(work, "variant.so")
    print("building ...", flush=True)
    build([(SRC, base_so, []), (variant_src, var_so, [])])

    blobs = make_corpus()
    headers, mp = corpus_headers(blobs)
    libs = {"base": binding.open_library(base_so),
            "variant": binding.open_library(var_so)}
    outs = {}
    for name, lib in libs.items():
        with binding.use_library(lib):
            outs[name] = [decode_scan_native(h) for h in headers]
    for i, (a, b) in enumerate(zip(outs["base"], outs["variant"])):
        if not np.array_equal(a, b):
            raise VariantDiverges(
                f"VARIANT DIVERGES FROM BASE on corpus image {i} "
                f"({blobs[i][0]}) - not timing it")
    print("correctness gate passed (corpus byte-identical)", flush=True)

    pheaders = make_progressive_headers(blobs) if prog else None
    rates, prates = interleaved(libs, headers, mp, reps, pheaders)
    return {**rates, "prog": prates,
            "ratio": (statistics.median(rates["variant"])
                      / statistics.median(rates["base"]))}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0].startswith("-"):
        print("usage: python -m pim_jpeg_decoder_tpu_torch.tools.src_ab "
              "<variant.cpp> [reps] [--prog]", file=sys.stderr)
        return 2
    reps = int(argv[1]) if len(argv) > 1 and argv[1].isdigit() else 15
    prog = "--prog" in argv
    try:
        r = run(argv[0], reps, prog)
    except ToolUnavailable as e:
        print(f"src_ab: {e}", file=sys.stderr)
        return 2
    except VariantDiverges as e:
        print(e)
        return 1
    for name in ("base", "variant"):
        rates = sorted(r[name])
        line = (f"{name:8s} median={statistics.median(rates):7.1f} MP/s "
                f"min={rates[0]:.1f} max={rates[-1]:.1f}")
        if prog:
            line += f"  prog_median={statistics.median(r['prog'][name]):.1f}"
        print(line)
    print(f"variant/base = {r['ratio']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
