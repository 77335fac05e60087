"""Baseline JPEG encoder (test-fixture factory).

The reference repo ships a single sample image and no tests (SURVEY.md
section 4); this encoder lets the test suite manufacture arbitrary fixtures —
any supported sampling mode (4:4:4 / 4:2:2 / 4:4:0 / 4:2:0 / grayscale),
restart intervals, zero-based component ids — with known pixel content.
Streams are validated by round-tripping through PIL/libjpeg in tests.

Not part of the decode capability contract; quality is not a goal here
(float FDCT, Annex K tables, no optimization).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from pim_jpeg_decoder_tpu_torch.codec import markers as M
from pim_jpeg_decoder_tpu_torch.codec import tables as T
from pim_jpeg_decoder_tpu_torch.codec.header import HuffmanTableSpec
from pim_jpeg_decoder_tpu_torch.codec.huffman import build_decode_table


class _BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:          # byte stuffing
                self.out.append(0x00)
        self.acc &= (1 << self.nbits) - 1

    def align(self) -> None:
        """Pad with 1-bits to a byte boundary (ITU-T T.81 F.1.2.3)."""
        if self.nbits:
            self.write((1 << (8 - self.nbits)) - 1, 8 - self.nbits)

    def emit_marker(self, marker: int) -> None:
        self.align()
        self.out += struct.pack(">H", marker)


def _fdct_block(block: np.ndarray) -> np.ndarray:
    """Float forward DCT of one (or many) 8x8 block(s), [..., 8, 8]."""
    k = np.arange(8)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    basis = c[:, None] * np.cos((2 * np.arange(8)[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    return np.einsum("uy,vx,...yx->...uv", basis, basis, block.astype(np.float64))


def _plane_blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """Pad a plane (edge-replicate) to (bh*8, bw*8) and cut into [bh, bw, 8, 8]."""
    h, w = plane.shape
    plane = np.pad(plane, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge")
    return plane.reshape(bh, 8, bw, 8).swapaxes(1, 2)


def _size_of(value: int) -> int:
    return int(value).bit_length() if value != 0 else 0


def encode_jpeg(
    rgb: np.ndarray,
    quality: int = 85,
    sampling: str = "4:2:0",
    restart_interval: int = 0,
    grayscale: bool = False,
    zero_based_ids: bool = False,
    app_segments: Optional[List[bytes]] = None,
    comment: Optional[bytes] = None,
) -> bytes:
    """Encode an ``[H, W, 3]`` (or ``[H, W]``) uint8 image as baseline JPEG."""
    sampling_map = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:4:0": (1, 2), "4:2:0": (2, 2)}
    if rgb.ndim == 2:
        grayscale = True
    h_s, v_s = (1, 1) if grayscale else sampling_map[sampling]
    height, width = rgb.shape[:2]

    # --- color transform (float BT.601), planes centered at 0 ---------------
    if grayscale:
        y = rgb.astype(np.float64) if rgb.ndim == 2 else (
            0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])
        planes = [y - 128.0]
    else:
        r = rgb[..., 0].astype(np.float64)
        g = rgb[..., 1].astype(np.float64)
        b = rgb[..., 2].astype(np.float64)
        y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
        cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b
        cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b
        planes = [y, cb, cr]

    mcu_cols = -(-width // (8 * h_s))
    mcu_rows = -(-height // (8 * v_s))

    # Chroma: pad to MCU-aligned luma size first, then box-downsample.
    luma_h, luma_w = mcu_rows * v_s * 8, mcu_cols * h_s * 8
    comp_blocks = []
    qts = [T.scaled_quant_table(T.STD_LUMA_QT, quality)]
    if not grayscale:
        qts.append(T.scaled_quant_table(T.STD_CHROMA_QT, quality))
    for ci, plane in enumerate(planes):
        if ci == 0:
            blocks = _plane_blocks(plane, mcu_rows * v_s, mcu_cols * h_s)
        else:
            padded = np.pad(
                plane,
                ((0, luma_h - height), (0, luma_w - width)),
                mode="edge",
            )
            down = padded.reshape(luma_h // v_s, v_s, luma_w // h_s, h_s).mean(axis=(1, 3))
            blocks = _plane_blocks(down, mcu_rows, mcu_cols)
        qt = qts[min(ci, 1)].astype(np.float64)
        coeffs = np.round(_fdct_block(blocks) / qt.reshape(8, 8)).astype(np.int32)
        comp_blocks.append(coeffs)

    # --- Huffman tables ------------------------------------------------------
    dc_specs = [HuffmanTableSpec(0, 0, np.array(T.STD_DC_LUMA_COUNTS, np.uint8),
                                 np.array(T.STD_DC_LUMA_SYMBOLS, np.uint8))]
    ac_specs = [HuffmanTableSpec(0, 1, np.array(T.STD_AC_LUMA_COUNTS, np.uint8),
                                 np.array(T.STD_AC_LUMA_SYMBOLS, np.uint8))]
    if not grayscale:
        dc_specs.append(HuffmanTableSpec(1, 0, np.array(T.STD_DC_CHROMA_COUNTS, np.uint8),
                                         np.array(T.STD_DC_CHROMA_SYMBOLS, np.uint8)))
        ac_specs.append(HuffmanTableSpec(1, 1, np.array(T.STD_AC_CHROMA_COUNTS, np.uint8),
                                         np.array(T.STD_AC_CHROMA_SYMBOLS, np.uint8)))
    dc_tables = [build_decode_table(s) for s in dc_specs]
    ac_tables = [build_decode_table(s) for s in ac_specs]

    # --- entropy encode ------------------------------------------------------
    bw = _BitWriter()
    ncomp = 1 if grayscale else 3
    samplings = [(h_s, v_s)] + [(1, 1)] * (ncomp - 1)
    dc_pred = [0] * ncomp
    rst = 0
    zz = T.ZIGZAG

    def encode_block(coeff: np.ndarray, ci: int) -> None:
        ti = min(ci, 1)
        dc_t, ac_t = dc_tables[ti], ac_tables[ti]
        diff = int(coeff[0, 0]) - dc_pred[ci]
        dc_pred[ci] = int(coeff[0, 0])
        mag = diff if diff >= 0 else -diff
        size = _size_of(mag)
        bw.write(int(dc_t.enc_code[size]), int(dc_t.enc_length[size]))
        if size:
            bits = diff if diff >= 0 else diff + (1 << size) - 1
            bw.write(bits, size)
        flat = coeff.reshape(64)[zz]
        nz = np.flatnonzero(flat[1:]) + 1
        k = 1
        for idx in nz:
            run = int(idx) - k
            while run >= 16:
                bw.write(int(ac_t.enc_code[0xF0]), int(ac_t.enc_length[0xF0]))
                run -= 16
            val = int(flat[idx])
            mag = val if val >= 0 else -val
            size = _size_of(mag)
            sym = (run << 4) | size
            bw.write(int(ac_t.enc_code[sym]), int(ac_t.enc_length[sym]))
            bits = val if val >= 0 else val + (1 << size) - 1
            bw.write(bits, size)
            k = int(idx) + 1
        if k < 64:
            bw.write(int(ac_t.enc_code[0x00]), int(ac_t.enc_length[0x00]))

    mcu_index = 0
    for my in range(mcu_rows):
        for mx in range(mcu_cols):
            if restart_interval and mcu_index and mcu_index % restart_interval == 0:
                bw.emit_marker(M.RST0 + rst)
                rst = (rst + 1) & 7
                dc_pred = [0] * ncomp
            for ci in range(ncomp):
                ch, cv = samplings[ci]
                for qv in range(cv):
                    for qh in range(ch):
                        encode_block(comp_blocks[ci][my * cv + qv, mx * ch + qh], ci)
            mcu_index += 1
    bw.align()
    entropy = bytes(bw.out)

    # --- segment assembly ----------------------------------------------------
    out = bytearray()
    out += struct.pack(">H", M.SOI)
    for app in app_segments or []:
        out += struct.pack(">HH", M.APP0, len(app) + 2) + app
    if comment is not None:
        out += struct.pack(">HH", M.COM, len(comment) + 2) + comment

    for tid, qt in enumerate(qts):
        body = bytes([tid]) + bytes(int(x) for x in qt[T.ZIGZAG])
        out += struct.pack(">HH", M.DQT, len(body) + 2) + body

    base_id = 0 if zero_based_ids else 1
    sof = bytearray()
    sof += struct.pack(">BHHB", 8, height, width, ncomp)
    for ci in range(ncomp):
        ch, cv = samplings[ci]
        sof += bytes([base_id + ci, (ch << 4) | cv, min(ci, 1)])
    out += struct.pack(">HH", M.SOF0, len(sof) + 2) + sof

    for specs in (dc_specs, ac_specs):
        for spec in specs:
            body = bytes([(spec.table_class << 4) | spec.table_id])
            body += bytes(int(x) for x in spec.counts)
            body += bytes(int(x) for x in spec.symbols)
            out += struct.pack(">HH", M.DHT, len(body) + 2) + body

    if restart_interval:
        out += struct.pack(">HHH", M.DRI, 4, restart_interval)

    sos = bytearray([ncomp])
    for ci in range(ncomp):
        ti = min(ci, 1)
        sos += bytes([base_id + ci, (ti << 4) | ti])
    sos += bytes([0, 63, 0])
    out += struct.pack(">HH", M.SOS, len(sos) + 2) + sos

    out += entropy
    out += struct.pack(">H", M.EOI)
    return bytes(out)
