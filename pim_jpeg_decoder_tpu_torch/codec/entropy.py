"""Sequential (host, NumPy/Python) baseline entropy decode.

Equivalent of the reference's BitReader + block/scan entropy decoders
(reference: src/headers/jpeg.h:81-122 ``BitReader``,
src/jpeg_scanner.cpp:467-520 ``decode_MCU_component`` baseline path,
src/jpeg_scanner.cpp:707-756 ``decode_Huffman_data``), with two deliberate
changes (SURVEY.md section 2/C10 and section 4):

- symbols decode via a single 16-bit peek-LUT lookup instead of a
  bit-at-a-time linear search, and
- restart intervals count *MCUs* (per ITU-T T.81 E.2.4) — the reference's
  ``(y*mcu_width_real + x) % restart_interval`` miscounts for subsampled
  images (reference: src/jpeg_scanner.cpp:723).

Output layout is the engine's transport contract: ``[num_mcus, g, 64]``
int16, natural (de-zigzagged) coefficient order, MCU slots in interleaved
scan order (see :meth:`JpegHeader.slot_components`).  This replaces the
reference's per-DPU 768-short block scatter
(reference: src/jpeg_scanner.cpp:733-741).

This module is the correctness oracle for entropy decode; the production
fast path is the C++ implementation in
:mod:`pim_jpeg_decoder_tpu_torch.native` with identical semantics.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from pim_jpeg_decoder_tpu_torch.codec.header import JpegError, JpegHeader
from pim_jpeg_decoder_tpu_torch.codec.huffman import (
    DecodeTable,
    build_decode_table,
    extend_signed,
)
from pim_jpeg_decoder_tpu_torch.codec.tables import ZIGZAG


class BitReader:
    """MSB-first bit cursor over the de-stuffed entropy byte stream.

    Equivalent of the reference's ``BitReader``
    (reference: src/headers/jpeg.h:81-122) with 16-bit peek support for
    LUT-based decode.  ``seek_byte`` replaces ``align()``: restart segments
    re-enter at recorded byte offsets.
    """

    __slots__ = ("data", "bitpos", "nbits")

    def __init__(self, data: bytes):
        # Pad so a 4-byte window is always readable at any valid bit position.
        self.data = data + b"\x00\x00\x00\x00"
        self.bitpos = 0
        self.nbits = len(data) * 8

    def seek_byte(self, byte_offset: int) -> None:
        self.bitpos = byte_offset * 8

    def peek16(self) -> int:
        byte = self.bitpos >> 3
        shift = self.bitpos & 7
        window = int.from_bytes(self.data[byte:byte + 4], "big")
        return (window >> (16 - shift)) & 0xFFFF

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if self.bitpos + n > self.nbits:
            raise JpegError("Ran out of entropy-coded data")
        byte = self.bitpos >> 3
        shift = self.bitpos & 7
        window = int.from_bytes(self.data[byte:byte + 4], "big")
        self.bitpos += n
        return (window >> (32 - shift - n)) & ((1 << n) - 1)


def build_tables(header: JpegHeader) -> Dict[str, Dict[int, DecodeTable]]:
    """Build decode LUTs for every DHT table in the header."""
    return {
        "dc": {tid: build_decode_table(spec) for tid, spec in header.dc_tables.items()},
        "ac": {tid: build_decode_table(spec) for tid, spec in header.ac_tables.items()},
    }


def _decode_symbol(br: BitReader, table: DecodeTable) -> int:
    peek = br.peek16()
    length = int(table.lut_length[peek])
    if length == 0:
        raise JpegError("Invalid Huffman code in entropy-coded data")
    if br.bitpos + length > br.nbits:
        raise JpegError("Ran out of entropy-coded data")
    br.bitpos += length
    return int(table.lut_symbol[peek])


def _decode_block(
    br: BitReader,
    out: np.ndarray,           # [64] int16 view, natural order
    dc_table: DecodeTable,
    ac_table: DecodeTable,
    dc_pred: List[int],
    ci: int,
) -> None:
    """Decode one 8x8 block: DC differential + AC run/size pairs.

    Baseline semantics of the reference's ``decode_MCU_component``
    (reference: src/jpeg_scanner.cpp:468-520): DC size symbol with
    signed-magnitude extension and differential prediction; AC with
    0x00 = EOB and 0xF0 = ZRL.
    """
    t = _decode_symbol(br, dc_table)
    if t > 11:
        raise JpegError(f"Invalid DC coefficient size: {t}")
    diff = extend_signed(br.read_bits(t), t)
    dc_pred[ci] += diff
    # Corrupt-but-Huffman-valid streams can push the predictor past int16;
    # wrap like the C++ path's int16 cast (legal streams never get here).
    out[0] = (dc_pred[ci] + 0x8000) % 0x10000 - 0x8000

    k = 1
    zz = ZIGZAG
    while k < 64:
        sym = _decode_symbol(br, ac_table)
        if sym == 0x00:          # EOB
            return
        run = sym >> 4
        size = sym & 0x0F
        if size == 0:
            if sym != 0xF0:
                raise JpegError(f"Invalid AC symbol 0x{sym:02X}")
            k += 16              # ZRL: 16 zeros
            continue
        k += run
        if k > 63:
            raise JpegError("Decoded AC coefficient index out of range")
        out[zz[k]] = extend_signed(br.read_bits(size), size)
        k += 1


def decode_scan(header: JpegHeader) -> np.ndarray:
    """Decode the full interleaved baseline scan.

    Returns coefficients ``[num_mcus, g, 64]`` int16 in natural order.
    Scan-walk equivalent of the reference's ``decode_Huffman_data``
    (reference: src/jpeg_scanner.cpp:707-756) with correct MCU-counted
    restart handling: at each restart the DC predictors reset and the bit
    cursor jumps to the next recorded segment offset (byte aligned by
    construction).
    """
    if header.progressive:
        raise JpegError("Progressive scans are not supported")
    tables = build_tables(header)
    slots = header.slot_components()
    g = len(slots)
    num_mcus = header.num_mcus
    coeffs = np.zeros((num_mcus, g, 64), dtype=np.int16)

    slot_tables = []
    for ci, _, _ in slots:
        comp = header.components[ci]
        slot_tables.append((ci, tables["dc"][comp.dc_id], tables["ac"][comp.ac_id]))

    br = BitReader(header.entropy_bytes)
    dc_pred = [0] * header.ncomp
    ri = header.restart_interval
    seg = 0
    offsets = header.segment_offsets

    for m in range(num_mcus):
        if ri and m and m % ri == 0:
            seg += 1
            if seg >= len(offsets):
                raise JpegError(
                    f"Missing restart segment {seg} (have {len(offsets)})")
            br.seek_byte(offsets[seg])
            dc_pred = [0] * header.ncomp
        mcu = coeffs[m]
        for s, (ci, dc_t, ac_t) in enumerate(slot_tables):
            _decode_block(br, mcu[s], dc_t, ac_t, dc_pred, ci)
    return coeffs
