"""AddressSanitizer (or UBSan) drive of the port's native entropy decoder.

Counterpart of the JAX package's ``tools/asan_drive.py`` (same arguments,
prongs and final line) over the port's ``native/entropy.cpp``: builds it
with ``-fsanitize=address`` (``--ubsan``: ``-fsanitize=undefined``) into
``$TMPDIR/pim_jpeg_tpu_torch/asan/`` (or under ``$PIM_JPEG_TPU_CACHE``),
re-executes itself with the sanitizer runtime preloaded (``LD_PRELOAD`` of
``g++ -print-file-name=lib{asan,ubsan}.so``, ``ASAN_OPTIONS=detect_leaks=0``),
routes the port's ``native.binding`` through the sanitized library, and
decodes adversarial streams:

1. encoder corpus + truncations (baseline, DRI, and a quarter progressive
   PIL re-encodes where PIL imports; without PIL that quarter is encoded
   by the port's encoder from the same draws, so a seed names the same
   drive on both machines);
2. random-canonical-table garbage streams (``fuzz.random_table``: wide
   11..15-bit magnitudes, lengths that engage the guarded fast path);
3. the worst-case block (DC 11 + 63x AC 15 with 16-bit codes) truncated
   across every byte of the guard window;
4. destuff, compact_wire, ycbcr_to_rgb and raster_rgb on random inputs.

Any out-of-bounds access (or undefined behaviour) aborts with the
sanitizer's report; a clean run ends with ``ASAN-CLEAN n decodes`` (or
``UBSAN-CLEAN``).

    python -m pim_jpeg_decoder_tpu_torch.tools.asan_drive [seed] [iters] [--ubsan]

The sanitized process must not load torch (its CUDA libraries and a
preloaded ASan runtime clash over shadow memory): it imports only the
port's host modules, and fails if torch was loaded.
"""

from __future__ import annotations

import os
import subprocess
import sys

from pim_jpeg_decoder_tpu_torch.tools.src_ab import SRC, module_env, work_dir

MODULE = "pim_jpeg_decoder_tpu_torch.tools.asan_drive"
CHILD_ENV = "PJT_ASAN_CHILD"


def _librt(name: str) -> str:
    out = subprocess.run(["g++", f"-print-file-name=lib{name}.so"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip()


def _library(ubsan: bool) -> str:
    return os.path.join(work_dir("asan"),
                        f"entropy_{'ubsan' if ubsan else 'asan'}.so")


def _reexec_under_sanitizer(argv) -> None:
    """Build the sanitized library and re-exec this module with the
    sanitizer runtime preloaded (it must load before python for a
    dlopen'd library)."""
    ubsan = "--ubsan" in argv
    san = "undefined" if ubsan else "address"
    runtime = _librt("ubsan" if ubsan else "asan")
    if not os.path.isabs(runtime):
        # g++ echoes the bare name when it has no such runtime.
        raise SystemExit(f"asan_drive: no lib{'ubsan' if ubsan else 'asan'}"
                         f".so for this g++ (got {runtime!r})")
    subprocess.run(
        ["g++", "-O1", "-g", f"-fsanitize={san}",
         "-fno-sanitize-recover=all", "-fno-omit-frame-pointer",
         "-march=native", "-std=c++17", "-shared", "-fPIC", SRC, "-o",
         _library(ubsan)],
        check=True, capture_output=True)
    env = module_env(LD_PRELOAD=runtime, ASAN_OPTIONS="detect_leaks=0",
                     UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1",
                     **{CHILD_ENV: "1"})
    os.execve(sys.executable, [sys.executable, "-m", MODULE, *argv], env)


def drive(seed: int, iters: int) -> int:
    """The four prongs through the port's binding (whatever library it
    routes to); returns the number of native calls made."""
    import numpy as np

    from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg
    from pim_jpeg_decoder_tpu_torch.codec.header import (
        Component,
        HuffmanTableSpec,
        JpegError,
        JpegHeader,
    )
    from pim_jpeg_decoder_tpu_torch.codec.progressive import decode_progressive
    from pim_jpeg_decoder_tpu_torch.codec.scanner import scan_jpeg
    from pim_jpeg_decoder_tpu_torch.native.binding import (
        compact_wire_cpp,
        decode_scan_cpp,
        destuff_cpp,
        raster_rgb_cpp,
        ycbcr_to_rgb_cpp,
    )
    from pim_jpeg_decoder_tpu_torch.tools.fuzz import (
        PIL_SUBSAMPLING,
        random_table,
    )
    from pim_jpeg_decoder_tpu_torch.tools.host_corpus import pil_image

    image = pil_image()
    rng = np.random.default_rng(seed)
    n_done = 0

    # 1. Encoder corpus + truncations.
    for _ in range(iters):
        h = int(rng.integers(8, 120))
        w = int(rng.integers(8, 120))
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        if rng.random() < 0.25:
            subsampling = int(rng.integers(0, 3))
            if image is None:     # the same draws, through the port's encoder
                data = encode_jpeg(img, quality=75,
                                   sampling=PIL_SUBSAMPLING[subsampling])
            else:
                import io

                buf = io.BytesIO()
                image.fromarray(img).save(buf, format="JPEG", quality=75,
                                          progressive=True,
                                          subsampling=subsampling)
                data = buf.getvalue()
        else:
            data = encode_jpeg(
                img, quality=int(rng.integers(30, 98)),
                sampling=str(rng.choice(
                    ["4:4:4", "4:2:2", "4:4:0", "4:2:0"])),
                restart_interval=int(rng.choice([0, 0, 2, 5])))
        if rng.random() < 0.4 and len(data) > 4:
            data = data[: int(rng.integers(2, len(data)))]
        try:
            header = scan_jpeg(data)
            if header.progressive:
                decode_progressive(header)
            else:
                decode_scan_cpp(header,
                                threads=int(rng.choice([1, 1, 4])))
        except JpegError:
            pass
        n_done += 1

    # 2. Random-canonical-table garbage streams.
    for _ in range(iters * 2):
        if rng.random() < 0.5:
            comps = [Component(0, 1, 1, 0, dc_id=0, ac_id=0)]
        else:
            v, hh = int(rng.integers(1, 3)), int(rng.integers(1, 3))
            comps = [Component(0, hh, v, 0, dc_id=0, ac_id=0),
                     Component(1, 1, 1, 0, dc_id=1, ac_id=1),
                     Component(2, 1, 1, 0, dc_id=1, ac_id=1)]
        header = JpegHeader(
            width=int(rng.integers(8, 64)),
            height=int(rng.integers(8, 48)),
            components=comps,
            dc_tables={t: random_table(rng, 0, t) for t in range(2)},
            ac_tables={t: random_table(rng, 1, t) for t in range(2)},
            restart_interval=int(rng.choice([0, 0, 0, 2, 5])),
        )
        n = int(rng.integers(300, 4000) if rng.random() < 0.4
                else rng.integers(16, 400))
        payload = rng.integers(0, 256, n, np.uint8)
        if rng.random() < 0.3:
            payload[rng.random(n) < 0.5] = 0
        header.entropy_bytes = payload.tobytes()
        if header.restart_interval:
            segs = -(-header.num_mcus // header.restart_interval)
            offs = sorted(int(x) for x in rng.integers(0, n, segs - 1))
            header.segment_offsets = tuple([0] + offs)
        else:
            header.segment_offsets = (0,)
        try:
            decode_scan_cpp(header)
        except JpegError:
            pass
        n_done += 1

    # 3. Deterministic worst-case-block streams: DC 11 + 63x AC 15 with
    # 16-bit codes (1980 bits/block), final block truncated across every
    # byte of the guard window.
    def onecode16(symbol, table_class):
        counts = np.zeros(16, np.uint8)
        counts[15] = 1
        return HuffmanTableSpec(0, table_class, counts,
                                np.array([symbol], np.uint8))

    bits = []
    for _ in range(8):
        bits.extend([0] * 16
                    + [(0x7FF >> i) & 1 for i in range(10, -1, -1)])
        for _ in range(63):
            bits.extend([0] * 16
                        + [(0x7FFF >> i) & 1 for i in range(14, -1, -1)])
    while len(bits) % 8:
        bits.append(1)
    full = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))
    for cut in range(1940, len(full) + 1):
        header = JpegHeader(
            width=64, height=8,
            components=[Component(0, 1, 1, 0, dc_id=0, ac_id=0)],
            dc_tables={0: onecode16(11, 0)},
            ac_tables={0: onecode16(0x0F, 1)},
            restart_interval=0,
        )
        header.entropy_bytes = full[:cut]
        header.segment_offsets = (0,)
        try:
            decode_scan_cpp(header)
        except JpegError:
            pass
        n_done += 1

    # 4. The remaining native surfaces: destuff on adversarial byte
    # soups, compact_wire at the int8 boundary, ycbcr_to_rgb and
    # raster_rgb across all sampling geometries (incl. ragged edges).
    for _ in range(iters):
        n = int(rng.integers(0, 600))
        soup = rng.integers(0, 256, n, np.uint8)
        if rng.random() < 0.5:
            soup[rng.random(n) < 0.3] = 0xFF  # marker/stuffing heavy
        try:
            destuff_cpp(soup.tobytes(), int(rng.integers(0, n + 1)),
                        stop_at_marker=bool(rng.random() < 0.5))
        except JpegError:
            pass
        lo, hi = (-128, 128) if rng.random() < 0.5 else (-300, 300)
        coeffs = rng.integers(lo, hi, (int(rng.integers(1, 64)), 6, 64),
                              np.int16)
        compact_wire_cpp(coeffs)
        v, hh = int(rng.integers(1, 3)), int(rng.integers(1, 3))
        ncomp = int(rng.choice([1, 3]))
        if ncomp == 1:
            v = hh = 1
        g = v * hh + (2 if ncomp == 3 else 0)
        rows, cols = int(rng.integers(1, 6)), int(rng.integers(1, 6))
        m_total = rows * cols + int(rng.integers(0, 8))  # padded tail
        planes = rng.integers(0, 256, (g, 64, m_total), np.uint8)
        height = int(rng.integers(1, rows * v * 8 + 1))
        width = int(rng.integers(1, cols * hh * 8 + 1))
        ycbcr_to_rgb_cpp(planes, 0, v, hh, ncomp, rows, cols,
                         height, width)
        nsc = int(rng.choice([8, 4, 2, 1]))
        raw = rng.integers(0, 256, (3, v * hh, nsc * nsc, m_total),
                           np.uint8)
        raster_rgb_cpp(raw, v, hh, nsc, rows, cols,
                       int(rng.integers(1, rows * v * nsc + 1)),
                       int(rng.integers(1, cols * hh * nsc + 1)))
        n_done += 4
    return n_done


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if os.environ.get(CHILD_ENV) != "1":
        _reexec_under_sanitizer(argv)   # does not return

    from pim_jpeg_decoder_tpu_torch.native import binding

    ubsan = "--ubsan" in argv
    args = [a for a in argv if a != "--ubsan"]
    with binding.use_library(binding.open_library(_library(ubsan))):
        n_done = drive(int(args[0]) if args else 0,
                       int(args[1]) if len(args) > 1 else 250)
    if "torch" in sys.modules:
        print("asan_drive: torch was loaded into the sanitized process",
              file=sys.stderr)
        return 1
    print(f"{'UBSAN' if ubsan else 'ASAN'}-CLEAN {n_done} decodes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
