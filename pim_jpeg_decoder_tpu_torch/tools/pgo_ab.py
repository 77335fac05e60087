"""A/B: profile-guided vs plain -O3 build of the port's ``native/entropy.cpp``.

Counterpart of the JAX package's ``tools/pgo_ab.py`` (same argument and
output) over the port's source and host corpus: builds ``entropy.cpp``
plain and with ``-fprofile-generate``, trains the second in a subprocess
(``python -m pim_jpeg_decoder_tpu_torch.tools.entropy_bench 2``, with
``--prog`` where PIL imports), builds with ``-fprofile-use``, then times
both in this process, interleaved (``tools/src_ab.py``'s helpers).

    python -m pim_jpeg_decoder_tpu_torch.tools.pgo_ab [reps]

Two things keep the profile from being silently lost, which would read as
a ~1.00x "result":
- the training build is put where the port's binding loads it in the
  subprocess, ``$PIM_JPEG_TPU_CACHE/pim_jpeg_tpu_torch/entropy_<sha>.so``
  (``binding.library_path``); else that process builds and times its own
  plain library and writes no profile.  The tool fails if the profile
  directory holds no ``.gcda`` after training;
- both profiled builds compile the same object path, because gcc names
  the profile data after it, and the profile-use build fails on a missing
  profile (``-Werror=missing-profile``).

Work files go under the port's cache directory
(``$TMPDIR/pim_jpeg_tpu_torch/pgo_ab``).  Exits 2 when the native library
does not load.
"""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import sys

from pim_jpeg_decoder_tpu_torch.tools.host_corpus import (
    ToolUnavailable,
    corpus_headers,
    make_corpus,
    pil_image,
    require_native,
)
from pim_jpeg_decoder_tpu_torch.tools.src_ab import (
    SRC,
    build,
    interleaved,
    module_env,
    work_dir,
)


def gcda_files(prof_dir: str) -> list:
    return [os.path.join(root, n) for root, _, names in os.walk(prof_dir)
            for n in names if n.endswith(".gcda")]


def build_profiled(work: str, out: str, flags: list) -> None:
    """Compile to ``work/obj/entropy.o`` (the one object path both profiled
    builds use), then link ``out``."""
    obj = os.path.join(work, "obj", "entropy.o")
    build([(SRC, obj, ["-c", *flags])])
    subprocess.run(["g++", "-shared", *flags, obj, "-o", out], check=True,
                   capture_output=True)


def main(argv=None) -> int:
    from pim_jpeg_decoder_tpu_torch.native import binding

    argv = sys.argv[1:] if argv is None else argv
    reps = int(argv[0]) if argv else 15
    try:
        require_native()
    except ToolUnavailable as e:
        print(f"pgo_ab: {e}", file=sys.stderr)
        return 2

    work = work_dir("pgo_ab")
    prof_dir = os.path.join(work, "prof")
    gen_cache = os.path.join(work, "gen_cache")
    shutil.rmtree(prof_dir, ignore_errors=True)
    plain_so = os.path.join(work, "plain.so")
    pgo_so = os.path.join(work, "pgo.so")
    gen_so = binding.library_path(gen_cache)

    print("building plain + profile-generate ...", flush=True)
    build([(SRC, plain_so, [])])
    build_profiled(work, gen_so, [f"-fprofile-generate={prof_dir}"])
    print(f"training (subprocess corpus pass, loading {gen_so}) ...",
          flush=True)
    train = [sys.executable, "-m",
             "pim_jpeg_decoder_tpu_torch.tools.entropy_bench", "2"]
    if pil_image() is not None:
        train.append("--prog")
    proc = subprocess.run(train, capture_output=True, text=True,
                          env=module_env(PIM_JPEG_TPU_CACHE=gen_cache))
    if proc.returncode:
        print(f"training run failed ({proc.returncode}):\n{proc.stderr}",
              file=sys.stderr)
        return 1
    profiles = gcda_files(prof_dir)
    if not profiles:
        print(f"no .gcda under {prof_dir} after training: the training "
              f"process did not load {gen_so}", file=sys.stderr)
        return 1
    print(f"profile: {len(profiles)} .gcda file(s) under {prof_dir}",
          flush=True)
    print("building profile-use ...", flush=True)
    build_profiled(work, pgo_so, [f"-fprofile-use={prof_dir}",
                                  "-fprofile-correction",
                                  "-Werror=missing-profile"])

    headers, mp = corpus_headers(make_corpus())
    libs = {"plain": binding.open_library(plain_so),
            "pgo": binding.open_library(pgo_so)}
    rates, _ = interleaved(libs, headers, mp, reps)
    for name in libs:
        r = sorted(rates[name])
        print(f"{name:6s} median={statistics.median(r):7.1f} MP/s "
              f"min={r[0]:.1f} max={r[-1]:.1f} over {reps} interleaved reps")
    delta = statistics.median(rates["pgo"]) / statistics.median(rates["plain"])
    print(f"pgo/plain = {delta:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
