"""Differential fuzz campaign of the port: random JPEGs, engine vs oracle.

Counterpart of the JAX package's ``tools/fuzz.py``, over the port's engine,
batch APIs, native decoder and NumPy oracle, on a CUDA card (the kernels)
or on the CPU (their plain versions).  Three properties, checked over
randomized streams:

1. DIFFERENTIAL: for any valid baseline/progressive JPEG the engine's
   pixels equal the NumPy oracle's bit-exactly, over random engine
   geometries (lane tile 8, 32 or 128; budgets, launch caps and batch
   sizes that give packed, dedicated, banded and bucketed partial
   launches), transports, wires and scales.
2. ROBUSTNESS: truncations and byte flips of valid streams end in a
   successful decode or a clean per-file error, never a crash.
3. API: the streaming, device-list and crop batch APIs equal their serial,
   one-device and oracle forms; random Huffman tables and scan scripts
   decode the same through the native decoder and the Python oracle.

    python -m pim_jpeg_decoder_tpu_torch.tools.fuzz [iterations] [seed] [fixed] [--device cuda|cpu]

``fixed`` pins the engine geometry.  The default device is ``cuda``; with
no card the tool exits 2 and never runs on the CPU instead.  It prints the
JAX tool's JSON line plus ``device`` and the campaign's kernel launch
counts, and exits 1 on any mismatch.

Inputs: where PIL imports, :func:`random_jpeg` makes the JAX tool's bytes
for the same generator state (a quarter of them PIL-encoded, some
progressive).  Where it does not (the card's machine), it draws the same
numbers, upsamples the smooth kind with numpy and encodes the PIL quarter
with the port's encoder (baseline only), so a seed names the same
campaign on both machines.

This module imports no torch at import time: ``tools/asan_drive.py`` takes
its table generator into a sanitized process that must not load torch.
"""

from __future__ import annotations

import io
import json
import sys
import time

import numpy as np

from pim_jpeg_decoder_tpu_torch.tools.host_corpus import (
    bilinear_resize,
    pil_image,
)

SAMPLINGS = ["4:4:4", "4:2:2", "4:4:0", "4:2:0"]
# PIL's ``subsampling`` ids as the port's encoder names them.
PIL_SUBSAMPLING = {0: "4:4:4", 1: "4:2:2", 2: "4:2:0"}
ENGINE_TILES = [8, 32, 128]
TRIAL_COUNTERS = ("stream_batches", "table_trials", "prog_table_trials",
                  "mesh_trials", "mixed_crop_trials")


def random_jpeg(rng) -> tuple:
    """(name, bytes): a random valid JPEG via the port's encoder or PIL."""
    from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg

    image = pil_image()
    h = int(rng.integers(8, 180))
    w = int(rng.integers(8, 180))
    kind = rng.integers(0, 3)
    if kind == 0:                       # smooth photo-like
        small = rng.integers(0, 256, (max(2, h // 8), max(2, w // 8), 3),
                             np.uint8)
        img = (bilinear_resize(small, w, h) if image is None else
               np.array(image.fromarray(small).resize((w, h),
                                                      image.BILINEAR)))
    elif kind == 1:                     # hard noise
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
    else:                               # flat + edges
        img = np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8)
        img[h // 2:, :] = rng.integers(0, 256, 3, np.uint8)

    q = int(rng.integers(30, 99))
    if rng.random() < 0.25:             # PIL-encoded (independent encoder)
        gray = rng.random() < 0.3
        subsampling = int(rng.integers(0, 3))
        progressive = bool(rng.random() < 0.3)
        if image is None:               # the same draws, baseline only
            return f"enc_q{q}", encode_jpeg(
                img, quality=q, sampling=PIL_SUBSAMPLING[subsampling],
                grayscale=gray)
        buf = io.BytesIO()
        pil = image.fromarray(img)
        if gray:
            pil = pil.convert("L")
        pil.save(buf, format="JPEG", quality=q, subsampling=subsampling,
                 progressive=progressive)
        return f"pil_q{q}", buf.getvalue()
    gray = rng.random() < 0.15
    app_segments = None
    comment = None
    if rng.random() < 0.2:     # exercise the APPn/COM skip paths
        app_segments = [bytes(rng.integers(0, 256,
                                           int(rng.integers(0, 300)),
                                           np.uint8))
                        for _ in range(int(rng.integers(1, 4)))]
    if rng.random() < 0.15:
        comment = bytes(rng.integers(32, 127, int(rng.integers(0, 200)),
                                     np.uint8))
    data = encode_jpeg(img[:, :, 0] if gray else img, quality=q,
                       sampling=str(rng.choice(SAMPLINGS)),
                       restart_interval=int(rng.choice([0, 0, 1, 3, 7])),
                       grayscale=gray,
                       zero_based_ids=bool(rng.random() < 0.1),
                       app_segments=app_segments, comment=comment)
    return f"enc_q{q}", data


def random_table(rng, table_class: int, table_id: int):
    """A random canonical Huffman table for the entropy-level checks:
    complete (dense success coverage) or sparse (BAD_CODE coverage), with
    invalid DC sizes 12..15 and wide AC magnitudes 11..15."""
    from pim_jpeg_decoder_tpu_torch.codec.header import HuffmanTableSpec

    if rng.random() < 0.6:  # complete: dense success coverage
        depths = [1, 1]
        target = int(rng.integers(4, 40))
        while len(depths) < target:
            j = int(rng.integers(0, len(depths)))
            if depths[j] >= 16:
                continue
            d = depths.pop(j)
            depths += [d + 1, d + 1]
        counts = np.zeros(16, np.uint8)
        for d in depths:
            counts[d - 1] += 1
        total = len(depths)
    else:  # sparse canonical: BAD_CODE coverage
        counts = np.zeros(16, np.uint8)
        code = 0
        total = 0
        for l in range(1, 17):
            cap = (1 << l) - code
            n = (0 if cap <= 0 or total >= 162
                 else int(rng.choice([0, 0, 1, 2, 3])))
            n = max(0, min(n, cap - (1 if l < 16 else 0), 162 - total))
            counts[l - 1] = n
            total += n
            code = (code + n) << 1
        if total == 0:
            counts[0] = 1
            total = 1
    if table_class == 0:  # DC sizes incl. the invalid 12..15
        syms = rng.integers(0, 16, total).astype(np.uint8)
    else:  # AC: pair-able smalls + wide magnitudes incl. 11..15
        runs = rng.integers(0, 16, total)
        sizes = rng.choice([0, 1, 2, 3, 4, 9, 10, 12, 15], total)
        syms = (runs << 4 | sizes).astype(np.uint8)
    return HuffmanTableSpec(table_id, table_class, counts, syms)


def _complete_huffman(rng, table_class, table_id):
    """COMPLETE canonical code via random binary-tree splitting: every bit
    pattern decodes to some symbol, so garbage streams decode fully (no
    BAD_CODE) and the success-path comparison gets dense coverage.  (The
    table generator of the JAX package's native tests, on the port's
    ``HuffmanTableSpec``.)"""
    from pim_jpeg_decoder_tpu_torch.codec.header import HuffmanTableSpec

    depths = [1, 1]
    target = int(rng.integers(4, 40))
    while len(depths) < target:
        i = int(rng.integers(0, len(depths)))
        if depths[i] >= 16:
            continue
        d = depths.pop(i)
        depths += [d + 1, d + 1]
    counts = np.zeros(16, np.uint8)
    for d in depths:
        counts[d - 1] += 1
    total = len(depths)
    if table_class == 0:
        syms = rng.integers(0, 9, total).astype(np.uint8)  # sizes 0..8
    else:
        runs = rng.integers(0, 3, total)
        sizes = rng.integers(1, 5, total)
        syms = (runs << 4 | sizes).astype(np.uint8)
        for j in range(total):  # dense EOBs end most blocks early
            if rng.random() < 0.2:
                syms[j] = 0x00
    return HuffmanTableSpec(table_id, table_class, counts, syms)


def _random_huffman(rng, table_class, table_id):
    """A random (possibly incomplete) canonical code biased to short codes,
    with invalid DC sizes, wide AC magnitudes, EOB, ZRL and invalid EOBn
    symbols.  (The JAX package's native tests' generator, on the port's
    ``HuffmanTableSpec``.)"""
    from pim_jpeg_decoder_tpu_torch.codec.header import HuffmanTableSpec

    counts = np.zeros(16, np.uint8)
    code = 0
    total = 0
    for l in range(1, 17):
        cap = (1 << l) - code
        if cap <= 0 or total >= 162:
            n = 0
        else:
            # Bias toward short codes (incl. 1-bit) so the pair paths
            # and extreme |val2| magnitudes get real coverage.
            n = int(rng.choice([0, 0, 1, 1, 2, 3, cap % 7]))
            n = max(0, min(n, cap - (1 if l < 16 else 0), 162 - total))
        counts[l - 1] = n
        total += n
        code = (code + n) << 1
    if total == 0:
        counts[0] = 1
        total = 1
    if table_class == 0:  # DC: sizes 0..11 valid; sprinkle invalid
        syms = rng.integers(0, 12, total).astype(np.uint8)
        if rng.random() < 0.1:
            syms[rng.integers(0, total)] = rng.integers(12, 16)
    else:  # AC: favor small run/size (pair-able), mix in wide + EOB/ZRL
        runs = rng.integers(0, 16, total)
        # 11..15 are beyond what T.81 encoders emit but legal input —
        # they stress the fast path's worst-case byte budget.
        sizes = rng.choice([1, 1, 1, 2, 2, 3, 4, 9, 10, 12, 15], total)
        syms = (runs << 4 | sizes).astype(np.uint8)
        for j in range(total):
            r = rng.random()
            if r < 0.08:
                syms[j] = 0x00  # EOB
            elif r < 0.12:
                syms[j] = 0xF0  # ZRL
            elif r < 0.14:
                syms[j] = int(rng.integers(1, 15)) << 4  # EOBn: invalid
    return HuffmanTableSpec(table_id, table_class, counts, syms)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _difference(decode_ref, decode_native):
    """None when both calls give equal arrays or both raise ``JpegError``;
    else what differs."""
    from pim_jpeg_decoder_tpu_torch.codec.header import JpegError

    r_py = e_py = r_cc = e_cc = None
    try:
        r_py = decode_ref()
    except JpegError as e:
        e_py = str(e)
    try:
        r_cc = decode_native()
    except JpegError as e:
        e_cc = str(e)
    if e_py is None and e_cc is None:
        return None if np.array_equal(r_py, r_cc) else "native != oracle"
    if e_py is None or e_cc is None:
        return f"one path errored: py={e_py!r} cc={e_cc!r}"
    return None


class Campaign:
    """One seeded campaign on one device: the generator, the counters and
    the checks (each callable on its own, as the tests do)."""

    def __init__(self, seed: int = 0, device="cuda", fixed: bool = False):
        from pim_jpeg_decoder_tpu_torch.parallel.mesh import resolve_device

        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.fixed = fixed
        self.stats = {"valid": 0, "mismatch": 0, "corrupt_ok": 0,
                      "corrupt_decoded": 0,
                      **{k: 0 for k in TRIAL_COUNTERS}, "failures": []}

    def fail(self, where: str, what: str) -> None:
        self.stats["mismatch"] += 1
        self.stats["failures"].append((where, what))

    def _encode(self, h: int, w: int, sampling: str, qlo: int, qhi: int):
        from pim_jpeg_decoder_tpu_torch.codec.encoder import encode_jpeg

        rng = self.rng
        return encode_jpeg(rng.integers(0, 256, (h, w, 3), np.uint8),
                           quality=int(rng.integers(qlo, qhi)),
                           sampling=sampling)

    def random_engine(self):
        """Random engine geometry: exercises bucketing, dedicated
        launches, chunked (banded) decode, every transport/wire/scale."""
        from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
        from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig

        rng = self.rng
        lane_tile = int(rng.choice(ENGINE_TILES))
        budget = lane_tile * int(rng.choice([4, 8, 16]))
        scale = int(rng.choice([1, 1, 1, 1, 2, 4, 8]))
        cfg = EngineConfig(
            budget_mcus=budget, lane_tile=lane_tile, prepare_threads=2,
            max_launch_mcus=int(rng.choice([budget, budget, 4 * budget])),
            transport=("auto" if scale != 1 else
                       str(rng.choice(["auto", "rgb", "ycbcr"]))),
            wire=str(rng.choice(["auto", "i16"])),
            scale=scale,
            max_images_per_batch=int(rng.choice([1, 4, 16])),
        )
        return DecodeEngine(keep_rgb=True, config=cfg, device=self.device)

    def stream_check(self) -> None:
        """Property 3 (streaming API): iter_decode_batches over random
        same-size batches must equal serial decode_same_size_batch."""
        from pim_jpeg_decoder_tpu_torch.models.input_pipeline import (
            decode_same_size_batch,
            iter_decode_batches,
        )

        rng = self.rng
        hh = int(rng.integers(16, 96))
        ww = int(rng.integers(16, 96))
        sampling = str(rng.choice(SAMPLINGS))
        batches = [[self._encode(hh, ww, sampling, 50, 95)
                    for _ in range(int(rng.integers(1, 4)))]
                   for _ in range(int(rng.integers(2, 4)))]
        streamed = list(iter_decode_batches(
            batches, prefetch=int(rng.integers(1, 4)), device=self.device))
        if len(streamed) != len(batches):
            self.fail("stream", f"{len(streamed)} batches out of "
                                f"{len(batches)}")
            return
        for blobs_b, (out, _) in zip(batches, streamed):
            want, _ = decode_same_size_batch(blobs_b, device=self.device)
            if not np.array_equal(_host(out), _host(want)):
                self.fail("stream", "streamed != serial")
                return
        self.stats["stream_batches"] += len(batches)

    def mesh_check(self) -> None:
        """Property 6 (device-list batch APIs): decode_same_size_batch /
        _crops and the streaming iterator over a list of 2 or 4 entries of
        the campaign's device must equal the one-device forms (random
        geometry, scale, batch size, incl. batches that don't divide the
        list)."""
        from pim_jpeg_decoder_tpu_torch.models.input_pipeline import (
            decode_same_size_batch,
            decode_same_size_batch_crops,
            iter_decode_batches,
        )

        rng = self.rng
        devices = [self.device] * int(rng.choice([2, 4]))
        hh = int(rng.integers(17, 80))
        ww = int(rng.integers(17, 80))
        sampling = str(rng.choice(SAMPLINGS))
        blobs = [self._encode(hh, ww, sampling, 50, 95)
                 for _ in range(int(rng.integers(1, 6)))]
        scale = int(rng.choice([1, 1, 2]))
        out, _ = decode_same_size_batch(blobs, scale=scale, device=devices)
        want, _ = decode_same_size_batch(blobs, scale=scale,
                                         device=self.device)
        want = _host(want)
        if not np.array_equal(_host(out), want):
            self.fail("mesh", "batch != single-device")
            return
        if rng.random() < 0.5:
            (s_out, _), = list(iter_decode_batches([blobs], scale=scale,
                                                   device=devices))
            if not np.array_equal(_host(s_out), want):
                self.fail("mesh", "stream != single")
                return

        # Random aligned crop box per image (per-image offsets below).
        def pick(extent):
            size = int(rng.integers(scale, extent + 1)) // scale * scale
            return max(size, scale)
        ch = pick(hh)
        cw = pick(ww)
        boxes = []
        for _ in blobs:
            y0 = int(rng.integers(0, hh - ch + 1)) // scale * scale
            x0 = int(rng.integers(0, ww - cw + 1)) // scale * scale
            boxes.append((y0, x0))
        ckw = dict(boxes=boxes, crop_hw=(ch, cw), scale=scale)
        c_out, _ = decode_same_size_batch_crops(blobs, device=devices, **ckw)
        c_want, _ = decode_same_size_batch_crops(blobs, device=self.device,
                                                 **ckw)
        if not np.array_equal(_host(c_out), _host(c_want)):
            self.fail("mesh", "crops != single-device")
            return
        self.stats["mesh_trials"] += 1

    def table_check(self) -> None:
        """Property 1 at the entropy level: random canonical Huffman
        tables + garbage payloads decode byte-identically (same output, or
        both error) through the native decoder and the Python oracle,
        including streams long enough to engage the guarded fast path.
        A missing native library is a failure, not a skip."""
        from pim_jpeg_decoder_tpu_torch.codec.entropy import decode_scan
        from pim_jpeg_decoder_tpu_torch.codec.header import (
            Component,
            JpegHeader,
        )
        from pim_jpeg_decoder_tpu_torch.native import native_available
        from pim_jpeg_decoder_tpu_torch.native.binding import decode_scan_cpp

        if not native_available():
            self.fail("table", "native library did not load")
            return
        rng = self.rng
        for _ in range(8):
            if rng.random() < 0.4:
                comps = [Component(0, 1, 1, 0, dc_id=0, ac_id=0)]
            else:
                v, h = int(rng.integers(1, 3)), int(rng.integers(1, 3))
                comps = [Component(0, h, v, 0, dc_id=0, ac_id=0),
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
            n = int(rng.integers(300, 4000) if rng.random() < 0.3
                    else rng.integers(16, 400))
            payload = rng.integers(0, 256, n, np.uint8)
            if rng.random() < 0.3:
                payload[rng.random(n) < 0.5] = 0  # long decodes
            header.entropy_bytes = payload.tobytes()
            if header.restart_interval:
                segs = -(-header.num_mcus // header.restart_interval)
                offs = sorted(int(x) for x in rng.integers(0, n, segs - 1))
                header.segment_offsets = tuple([0] + offs)
            else:
                header.segment_offsets = (0,)
            error = _difference(lambda: decode_scan(header),
                                lambda: decode_scan_cpp(header))
            if error:
                self.fail("table", error)
                return
            self.stats["table_trials"] += 1

    def prog_table_check(self) -> None:
        """Progressive differential at the scan-script level: random
        tables + random successive-approximation scripts (band splits,
        overlaps/duplicates, refine chains, restart intervals) with
        garbage payloads: native image-level decode (serial or over
        component chains) vs the Python oracle, same output or both
        error.  A missing native library is a failure, not a skip."""
        from pim_jpeg_decoder_tpu_torch.codec.header import (
            Component,
            JpegHeader,
            ScanData,
            ScanSpec,
        )
        from pim_jpeg_decoder_tpu_torch.codec.progressive import (
            decode_progressive,
        )
        from pim_jpeg_decoder_tpu_torch.native import native_available

        if not native_available():
            self.fail("prog_table", "native library did not load")
            return
        rng = self.rng
        for _ in range(6):
            safe = rng.random() < 0.8
            make = _complete_huffman if safe else _random_huffman
            dc = make(rng, 0, 0)
            ac = make(rng, 1, 0)
            header = JpegHeader(
                width=int(rng.integers(8, 64)),
                height=int(rng.integers(8, 48)),
                progressive=True,
                components=[Component(0, 1, 1, 0, dc_id=0, ac_id=0)],
                dc_tables={0: dc},
                ac_tables={0: ac},
            )

            def scan(spec, ri=0):
                n = int(rng.integers(800, 2400) if rng.random() < 0.2
                        else rng.integers(8, 300))
                data = rng.integers(0, 256, n, np.uint8).tobytes()
                if ri:
                    segs = max(1, -(-header.num_mcus // ri))
                    offs = sorted(
                        int(x) for x in rng.integers(0, n, segs - 1))
                    offs = tuple([0] + offs)
                else:
                    offs = (0,)
                is_dc = spec.start_of_selection == 0
                return ScanData([0], [0], [0], spec, ri, data, offs,
                                [dc if is_dc else None],
                                [None if is_dc else ac])

            a0 = int(rng.integers(0, 3))
            scans = [scan(ScanSpec(0, 0, 0, a0))]  # DC first (mandatory)
            al_dc = a0
            for _ in range(int(rng.integers(1, 7))):
                ri = int(rng.choice([0, 0, 0, 2, 5]))
                if rng.random() < 0.3 and al_dc > 0:  # DC refine chain
                    scans.append(scan(ScanSpec(0, 0, al_dc, al_dc - 1), ri))
                    al_dc -= 1
                else:  # AC band: random range, overlaps/dupes allowed
                    ss = int(rng.integers(1, 64))
                    se = int(rng.integers(ss, 64))
                    al = int(rng.integers(0, 3))
                    ah = 0 if rng.random() < 0.6 else al + 1
                    scans.append(scan(ScanSpec(ss, se, ah, al), ri))
            header.scans = scans

            # Half the trials run the component-chain partition
            # (threads > 1): output AND error reporting must match serial.
            threads = int(rng.integers(2, 4)) if rng.random() < 0.5 else 1
            error = _difference(
                lambda: decode_progressive(header, use_native=False),
                lambda: decode_progressive(header, use_native=True,
                                           threads=threads))
            if error:
                self.fail("prog_table", error)
                return
            self.stats["prog_table_trials"] += 1

    def mixed_crop_check(self) -> None:
        """Property 7 (mixed-size crop batches): decode_batch_crops over
        randomly-sized images must equal the per-image oracle slices
        (random crop size/origins, sampling, scale)."""
        from pim_jpeg_decoder_tpu_torch.models.input_pipeline import (
            decode_batch_crops,
        )
        from pim_jpeg_decoder_tpu_torch.oracle.decoder import (
            decode_bytes_oracle,
            decode_scaled_oracle,
        )

        rng = self.rng
        sampling = str(rng.choice(SAMPLINGS))
        scale = int(rng.choice([1, 1, 1, 2]))
        # 8-multiples are automatically scale-multiples (scale <= 2 here).
        ch = int(rng.integers(2, 8)) * 8
        cw = int(rng.integers(2, 8)) * 8
        blobs, boxes = [], []
        for _ in range(int(rng.integers(2, 5))):
            hh = int(rng.integers(ch, ch + 90))
            ww = int(rng.integers(cw, cw + 90))
            blobs.append(self._encode(hh, ww, sampling, 55, 95))
            y0 = int(rng.integers(0, hh - ch + 1)) // scale * scale
            x0 = int(rng.integers(0, ww - cw + 1)) // scale * scale
            boxes.append((y0, x0))
        out, _ = decode_batch_crops(blobs, boxes, (ch, cw), scale=scale,
                                    device=self.device)
        host = _host(out)
        for i, (b, (y0, x0)) in enumerate(zip(blobs, boxes)):
            if scale == 1:
                want = decode_bytes_oracle(b).rgb[y0:y0 + ch, x0:x0 + cw]
            else:
                want = decode_scaled_oracle(b, scale)[
                    y0 // scale:(y0 + ch) // scale,
                    x0 // scale:(x0 + cw) // scale]
            if not np.array_equal(host[i], want):
                self.fail("mixed_crop", f"image {i} != oracle slice")
                return
        self.stats["mixed_crop_trials"] += 1

    def check_batch(self, engine, batch) -> None:
        """Properties 1 and 2 over one engine call."""
        from pim_jpeg_decoder_tpu_torch.oracle.decoder import (
            decode_bytes_oracle,
            decode_scaled_oracle,
        )

        report = engine.decode_named_blobs(batch)
        stats = self.stats
        for (bname, bdata), res in zip(batch, report.results):
            if "_trunc" in bname or "_flip" in bname:
                # Either outcome is legal, but a successful decode must
                # still be a sane raster and a failure must say why.
                if res.ok:
                    stats["corrupt_decoded"] += 1
                    if res.rgb.dtype != np.uint8 or res.rgb.ndim != 3:
                        self.fail(bname, f"corrupt input decoded to "
                                         f"{res.rgb.dtype} {res.rgb.shape}")
                else:
                    stats["corrupt_ok"] += 1
                    if not res.error:
                        self.fail(bname, "failed without an error message")
                continue
            stats["valid"] += 1
            if not res.ok:
                self.fail(bname, f"decode failed: {res.error}")
                continue
            if engine.scale != 1:
                want = decode_scaled_oracle(bdata, engine.scale)
            else:
                want = decode_bytes_oracle(bdata).rgb
            if not np.array_equal(res.rgb, want):
                diff = (int(np.abs(res.rgb.astype(int)
                                   - want.astype(int)).max())
                        if res.rgb.shape == want.shape else
                        f"shape {res.rgb.shape} != {want.shape}")
                self.fail(bname, f"pixel diff max {diff}")

    def run(self, iters: int) -> dict:
        from pim_jpeg_decoder_tpu_torch.runtime.engine import DecodeEngine
        from pim_jpeg_decoder_tpu_torch.utils.config import EngineConfig

        rng = self.rng
        engine = DecodeEngine(keep_rgb=True, device=self.device,
                              config=EngineConfig(budget_mcus=1024,
                                                  lane_tile=128,
                                                  prepare_threads=2))
        t0 = time.monotonic()
        batch = []
        for i in range(iters):
            if rng.random() < 0.02:
                self.stream_check()
            if rng.random() < 0.05:
                self.table_check()
            if rng.random() < 0.04:
                self.prog_table_check()
            if rng.random() < 0.03:
                self.mesh_check()
            if rng.random() < 0.03:
                self.mixed_crop_check()
            name, data = random_jpeg(rng)
            mode = rng.random()
            if mode < 0.7:
                batch.append((f"{i}_{name}", data))
            elif mode < 0.85 and len(data) > 4:   # truncate
                cut = int(rng.integers(2, len(data)))
                batch.append((f"{i}_trunc{cut}_{name}", data[:cut]))
            else:                                  # flip one byte
                pos = int(rng.integers(0, len(data)))
                mutated = bytearray(data)
                mutated[pos] ^= int(rng.integers(1, 256))
                batch.append((f"{i}_flip{pos}_{name}", bytes(mutated)))

            if len(batch) < 8 and i != iters - 1:
                continue
            if not self.fixed and rng.random() < 0.3:
                engine = self.random_engine()
            self.check_batch(engine, batch)
            batch = []
        self.stats["seconds"] = round(time.monotonic() - t0, 1)
        self.stats["iterations"] = iters
        self.stats["ok"] = self.stats["mismatch"] == 0
        return self.stats


def run(iterations: int = 300, seed: int = 0, fixed: bool = False,
        device="cuda") -> dict:
    """One campaign on ``device`` (a CUDA device must exist when one is
    named); returns the JSON record, with ``device`` and the kernel launch
    counts of the campaign (the counters are set to 0 at its start)."""
    from pim_jpeg_decoder_tpu_torch.ops.decode_kernel import (
        launch_counts,
        reset_launch_counts,
    )

    campaign = Campaign(seed, device, fixed)
    reset_launch_counts()
    stats = campaign.run(iterations)
    stats["device"] = str(campaign.device)
    stats["launches"] = launch_counts()
    return stats


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m pim_jpeg_decoder_tpu_torch.tools.fuzz",
        description="Differential fuzz campaign of the port.")
    parser.add_argument("iterations", nargs="?", type=int, default=300)
    parser.add_argument("seed", nargs="?", type=int, default=0)
    parser.add_argument("fixed", nargs="?", choices=["fixed"],
                        help="pin the engine geometry")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default), cuda:N or cpu (the kernels' "
                             "plain versions)")
    args = parser.parse_args(argv)
    from pim_jpeg_decoder_tpu_torch.parallel.mesh import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:       # a CUDA device named, and no card
        print(f"fuzz: {e}", file=sys.stderr)
        return 2
    stats = run(args.iterations, args.seed, args.fixed == "fixed", device)
    print(json.dumps(stats))
    return 0 if stats["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
