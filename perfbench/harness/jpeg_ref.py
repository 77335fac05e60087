"""The plain reference decoder of the benchmark: baseline JPEG -> RGB.

Written for the benchmark alone, in plain Python and NumPy: it imports
nothing of the program and takes nothing the program made.  It reads the
file's markers, decodes the Huffman-coded data itself (restart intervals
included), dequantizes, runs the 13-bit Loeffler integer IDCT of libjpeg's
"islow" method (int32, rounding descales, samples clamped to [-128, 127]),
replicates chroma to the luma grid (nearest neighbour) and converts with
fixed-point BT.601 at 2^16 ((x + 2^15) >> 16, arithmetic shift), clamped
to [0, 255].  That is the arithmetic the program states it computes, so a
correct decode equals this one pixel for pixel.

``idct="float16"`` is the control: the same decode with the IDCT taken as
the ideal transform in float16 (the tensor-core form a faster decoder
would be tempted by).  It breaks the bit-exact guarantee and has to fail
the comparison.
"""

from __future__ import annotations

import re
from array import array
from typing import Dict, List, Tuple

import numpy as np

# Zigzag position k -> natural (row-major) index of the 8x8 block.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)
# 64 entries past the end absorb a run that overshoots the block (k > 63),
# which a valid stream never has; the decode checks k afterwards.
_ZZ = ZIGZAG.tolist() + [0] * 80
_MASK = [(1 << i) - 1 for i in range(97)]
_HALF = [0] + [1 << (i - 1) for i in range(1, 17)]

_END = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


class RefJpegError(ValueError):
    pass


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def parse(data: bytes) -> dict:
    """Markers of a baseline (SOF0/SOF1) Huffman JPEG -> frame, tables,
    restart interval and the entropy-coded segments (still stuffed)."""
    if data[:2] != b"\xff\xd8":
        raise RefJpegError("no SOI marker")
    qt: Dict[int, np.ndarray] = {}
    ht: Dict[Tuple[int, int], Tuple[bytes, bytes]] = {}
    frame = None
    restart = 0
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise RefJpegError(f"marker expected at {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:          # fill byte
            pos += 1
            continue
        length = _u16(data, pos + 2)
        body = data[pos + 4:pos + 2 + length]
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(body[i + 1:i + 1 + n],
                                    ">u2" if pq else "u1").astype(np.int32)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = raw
                qt[tq] = table
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1:i + 17]
                n = sum(counts)
                ht[(tc, th)] = (bytes(counts), bytes(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker in (0xC0, 0xC1):
            precision = body[0]
            if precision != 8:
                raise RefJpegError("only 8-bit samples")
            height, width, nf = _u16(body, 1), _u16(body, 3), body[5]
            comps = []
            for c in range(nf):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq})
            frame = {"height": height, "width": width, "comps": comps}
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise RefJpegError(f"unsupported frame type 0xFF{marker:02X}")
        elif marker == 0xDD:
            restart = _u16(body, 0)
        elif marker == 0xDA:
            if frame is None:
                raise RefJpegError("SOS before SOF")
            ns = body[0]
            order = []
            for s in range(ns):
                cid, tdta = body[1 + 2 * s:3 + 2 * s]
                ci = next(i for i, c in enumerate(frame["comps"])
                          if c["id"] == cid)
                frame["comps"][ci]["td"] = tdta >> 4
                frame["comps"][ci]["ta"] = tdta & 15
                order.append(ci)
            if order != list(range(len(frame["comps"]))):
                raise RefJpegError("only one interleaved scan of all "
                                   "components")
            start = pos + 2 + length
            end = _END.search(data, start)
            if end is None:
                raise RefJpegError("no marker after the scan")
            scan = data[start:end.start()]
            return {"frame": frame, "qt": qt, "ht": ht, "restart": restart,
                    "segments": _RST.split(scan)}
        pos += 2 + length
    raise RefJpegError("no scan")


_LUTS: Dict[Tuple[bytes, bytes], List[int]] = {}


def _lut(counts: bytes, symbols: bytes) -> List[int]:
    """16-bit peek table: entry = symbol << 5 | code length (0: no code)."""
    key = (counts, symbols)
    lut = _LUTS.get(key)
    if lut is None:
        lut = [0] * 65536
        code, si = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                if hi > 65536:
                    raise RefJpegError("Huffman code overflow")
                lut[lo:hi] = [(symbols[si] << 5) | length] * (hi - lo)
                code += 1
                si += 1
            code <<= 1
        _LUTS[key] = lut
    return lut


def _words(seg: bytes) -> List[int]:
    """Destuffed segment -> big-endian 64-bit words (zero padded, plus two
    words of zeros so a read past the end finds bits)."""
    raw = seg.replace(b"\xff\x00", b"\xff")
    raw += b"\0" * (-len(raw) % 8 + 16)
    return np.frombuffer(raw, ">u8").tolist()


def _decode_segment(words, mcus, mcu_cols, slots, planes) -> None:
    """Huffman-decode MCUs ``mcus`` (a range) of one restart segment into
    the component planes (flat int32 ``array``s, natural order)."""
    acc, nb, wi = 0, 0, 0
    mask, half, zz = _MASK, _HALF, _ZZ
    preds = [0] * len(planes)
    for m in mcus:
        mr, mc = divmod(m, mcu_cols)
        for ci, dclut, aclut, a, b, c in slots:
            plane = planes[ci]
            off = (mr * a + mc * b + c) << 6
            if nb < 32:
                acc = ((acc & mask[nb]) << 64) | words[wi]
                wi += 1
                nb += 64
            e = dclut[(acc >> (nb - 16)) & 0xFFFF]
            if not e & 31:
                raise RefJpegError("invalid DC code")
            nb -= e & 31
            s = e >> 5
            if s:
                v = (acc >> (nb - s)) & mask[s]
                nb -= s
                if v < half[s]:
                    v -= mask[s]
                preds[ci] += v
            plane[off] = preds[ci]
            k = 1
            while k < 64:
                if nb < 32:
                    acc = ((acc & mask[nb]) << 64) | words[wi]
                    wi += 1
                    nb += 64
                e = aclut[(acc >> (nb - 16)) & 0xFFFF]
                if not e & 31:
                    raise RefJpegError("invalid AC code")
                nb -= e & 31
                rs = e >> 5
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = (acc >> (nb - s)) & mask[s]
                    nb -= s
                    if v < half[s]:
                        v -= mask[s]
                    plane[off + zz[k]] = v
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break
            if k > 64:
                raise RefJpegError("AC index past the block")
        if wi >= len(words):
            raise RefJpegError("ran out of entropy-coded data")


def coefficients(info: dict) -> Tuple[list, int, int]:
    """Quantized coefficients of every component: ``[rows, cols, 8, 8]``
    int32 blocks each (the padded MCU grid), and the MCU grid size."""
    frame = info["frame"]
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if len(comps) == 1:
        hmax = vmax = comps[0]["h"] = comps[0]["v"] = 1
    mcu_cols = -(-frame["width"] // (8 * hmax))
    mcu_rows = -(-frame["height"] // (8 * vmax))
    planes, slots, shapes = [], [], []
    for ci, comp in enumerate(comps):
        bw, bh = mcu_cols * comp["h"], mcu_rows * comp["v"]
        planes.append(array("i", bytes(4 * bw * bh * 64)))
        shapes.append((bh, bw))
        try:
            dc = _lut(*info["ht"][(0, comp["td"])])
            ac = _lut(*info["ht"][(1, comp["ta"])])
        except KeyError as e:
            raise RefJpegError(f"missing Huffman table {e}") from None
        for v in range(comp["v"]):
            for h in range(comp["h"]):
                slots.append((ci, dc, ac, comp["v"] * bw, comp["h"],
                              v * bw + h))
    total = mcu_rows * mcu_cols
    step = info["restart"] or total
    segments = info["segments"]
    if len(segments) < -(-total // step):
        raise RefJpegError("missing restart segment")
    for i, m0 in enumerate(range(0, total, step)):
        _decode_segment(_words(segments[i]), range(m0, min(total, m0 + step)),
                        mcu_cols, slots, planes)
    blocks = [np.frombuffer(p, np.int32).reshape(bh, bw, 8, 8)
              for p, (bh, bw) in zip(planes, shapes)]
    return blocks, mcu_rows, mcu_cols


# --- the integer IDCT (libjpeg islow: 13-bit constants, 2 pass bits) ---------

_C = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
      "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
      "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
      "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _pass(x: np.ndarray, shift: int) -> np.ndarray:
    """One 8-point pass over the last axis of int32 ``x``, each output
    descaled by ``shift`` with rounding."""
    c = _C
    r = np.int32(1 << (shift - 1))
    z1 = (x[..., 2] + x[..., 6]) * c["0_541196100"]
    t2 = z1 - x[..., 6] * c["1_847759065"]
    t3 = z1 + x[..., 2] * c["0_765366865"]
    t0 = ((x[..., 0] + x[..., 4]) << 13) + r
    t1 = ((x[..., 0] - x[..., 4]) << 13) + r
    e0, e3 = t0 + t3, t0 - t3
    e1, e2 = t1 + t2, t1 - t2
    o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z5 = (o0 + o2 + o1 + o3) * c["1_175875602"]
    za = (o0 + o3) * -c["0_899976223"]
    zb = (o1 + o2) * -c["2_562915447"]
    zc = (o0 + o2) * -c["1_961570560"] + z5
    zd = (o1 + o3) * -c["0_390180644"] + z5
    o0 = o0 * c["0_298631336"] + za + zc
    o1 = o1 * c["2_053119869"] + zb + zd
    o2 = o2 * c["3_072711026"] + zb + zc
    o3 = o3 * c["1_501321110"] + za + zd
    out = [e0 + o3, e1 + o2, e2 + o1, e3 + o0,
           e3 - o0, e2 - o1, e1 - o2, e0 - o3]
    return np.stack(out, axis=-1) >> shift


def idct_int(deq: np.ndarray) -> np.ndarray:
    """``[..., 8, 8]`` dequantized int32 blocks (row = vertical frequency)
    -> samples centred at 0, clamped to [-128, 127]."""
    cols = _pass(np.swapaxes(deq, -1, -2), 11)       # over each column
    rows = _pass(np.swapaxes(cols, -1, -2), 18)      # over each row
    return np.clip(rows, -128, 127)


def idct_float16(deq: np.ndarray) -> np.ndarray:
    """The control: the ideal IDCT with operands, products and sums in
    float16, rounded to integers and clamped."""
    k = np.arange(8)
    basis = (np.where(k == 0, np.sqrt(0.5), 1.0)[:, None]
             * np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2)
    b = basis.astype(np.float16)                      # [u, y]
    x = deq.astype(np.float16)
    tmp = np.matmul(np.swapaxes(b, 0, 1), x)          # [y, v]... per block
    out = np.matmul(tmp, b)                           # [y, x]
    return np.clip(np.rint(out.astype(np.float32)), -128, 127).astype(
        np.int32)


def _samples(blocks: np.ndarray, qt: np.ndarray, idct) -> np.ndarray:
    """Quantized ``[rows, cols, 8, 8]`` blocks -> the component's sample
    plane ``[rows*8, cols*8]`` int32, centred at 0."""
    deq = np.clip(blocks * qt.reshape(8, 8), -32768, 32767)
    spat = idct(deq)
    rows, cols = blocks.shape[:2]
    return spat.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def descale16(x: np.ndarray) -> np.ndarray:
    return (x + (1 << 15)) >> 16


def decode_rgb(data: bytes, idct: str = "int", scale: int = 1
               ) -> np.ndarray:
    """A baseline JPEG -> ``[H, W, 3]`` uint8 RGB, at full scale only."""
    if scale != 1:
        raise RefJpegError(f"jpeg_ref decodes at scale 1, not {scale}: a "
                           "scaled cell names a reference module of its own")
    info = parse(data)
    frame = info["frame"]
    comps = frame["comps"]
    blocks, mcu_rows, mcu_cols = coefficients(info)
    fn = idct_int if idct == "int" else idct_float16
    planes = []
    for comp, blk in zip(comps, blocks):
        qt = info["qt"].get(comp["tq"])
        if qt is None:
            raise RefJpegError("missing quantization table")
        planes.append(_samples(blk, qt, fn))
    height, width = frame["height"], frame["width"]
    y = planes[0][:height, :width]
    if len(comps) == 1:
        v = np.clip(y + 128, 0, 255).astype(np.uint8)
        return np.stack([v, v, v], axis=-1)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    chroma = []
    for comp, plane in zip(comps[1:], planes[1:]):
        fy, fx = vmax // comp["v"], hmax // comp["h"]
        rows = np.arange(height) // fy
        cols = np.arange(width) // fx
        chroma.append(plane[rows[:, None], cols[None, :]])
    cb, cr = chroma
    y128 = y + 128
    rgb = np.stack([y128 + descale16(91881 * cr),
                    y128 + descale16(-22554 * cb - 46802 * cr),
                    y128 + descale16(116130 * cb)], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)
