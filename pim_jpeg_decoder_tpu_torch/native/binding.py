"""ctypes binding for the C++ entropy decoder (build-on-demand with g++).

The shared library is compiled once per source hash into a cache directory
and loaded via ctypes (calls release the GIL, so multiple producer threads
entropy-decode in parallel — the host/device overlap the reference gets from
its two-thread queue, reference: src/decoder_host.cpp:35-38, scales further
here).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from pim_jpeg_decoder_tpu_torch.codec.header import JpegError, JpegHeader

_SRC = os.path.join(os.path.dirname(__file__), "entropy.cpp")

_ERROR_MESSAGES = {
    -1: "Invalid Huffman code in entropy-coded data",
    -2: "Ran out of entropy-coded data",
    -3: "Invalid DC coefficient size",
    -4: "Decoded AC coefficient index out of range",
    -5: "Missing restart segment",
    -6: "Invalid AC symbol",
    -7: "Invalid arguments to native decoder",
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _cache_dir() -> str:
    # The port's own directory (under $PIM_JPEG_TPU_CACHE when that is
    # set), so it never loads a library built from another package's copy.
    base = os.path.join(os.environ.get("PIM_JPEG_TPU_CACHE",
                                       tempfile.gettempdir()),
                        "pim_jpeg_tpu_torch")
    os.makedirs(base, exist_ok=True)
    return base


def _build() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    path = os.path.join(_cache_dir(), f"entropy_{tag}.so")
    if not os.path.exists(path):
        tmp = path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, path)
    return path


def load() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the native library; None on failure."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _load_failed:
            return None
        try:
            lib = ctypes.CDLL(_build())
            lib.pjt_decode_scan.restype = ctypes.c_int32
            lib.pjt_decode_segments.restype = ctypes.c_int32
            lib.pjt_decode_progressive_scan.restype = ctypes.c_int32
            lib.pjt_decode_progressive_image.restype = ctypes.c_int32
            lib.pjt_progressive_assemble.restype = ctypes.c_int32
            lib.pjt_ycbcr_to_rgb.restype = ctypes.c_int32
            lib.pjt_ycbcr_to_bmp_rows.restype = ctypes.c_int32
            lib.pjt_destuff.restype = ctypes.c_int32
            lib.pjt_compact_wire.restype = ctypes.c_int32
            lib.pjt_bmp_rows.restype = ctypes.c_int32
            lib.pjt_raster_rgb.restype = ctypes.c_int32
            lib.pjt_abi_version.restype = ctypes.c_int32
            if lib.pjt_abi_version() != 13:
                raise RuntimeError("native ABI mismatch")
            _lib = lib
        except Exception:
            _load_failed = True
            return None
        return _lib


def _vp(arr: np.ndarray) -> ctypes.c_void_p:
    """Cheap pointer for a LOCAL array (about 2x faster than
    ``arr.ctypes.data_as(POINTER(...))``).  Unlike ``data_as`` this keeps
    NO reference to the array — callers must bind the array to a local
    that outlives the foreign call (never pass a temporary)."""
    return ctypes.c_void_p(arr.ctypes.data)


# Per-header table staging: raw DHT definitions ([4,16] counts, [4,162]
# symbols per class); the C++ side builds its L1-resident lookahead tables
# from these (a few microseconds per call).
def _stage_tables(header: JpegHeader):
    dc_counts = np.zeros((4, 16), np.uint8)
    dc_symbols = np.zeros((4, 162), np.uint8)
    ac_counts = np.zeros((4, 16), np.uint8)
    ac_symbols = np.zeros((4, 162), np.uint8)
    for tid, spec in header.dc_tables.items():
        dc_counts[tid] = spec.counts
        dc_symbols[tid, : spec.symbols.size] = spec.symbols
    for tid, spec in header.ac_tables.items():
        ac_counts[tid] = spec.counts
        ac_symbols[tid, : spec.symbols.size] = spec.symbols
    return dc_counts, dc_symbols, ac_counts, ac_symbols


# Fan segment ranges across threads only when there is enough work per
# thread to amortize dispatch (~MCUs per thread).
_MIN_MCUS_PER_THREAD = 2048

# Engagement evidence for segment-parallel decode (the latent parallelism
# of SURVEY.md section 2 item 4): production callers are expected to reach
# the threads>1 branch for large DRI images, and tests pin that they do.
_seg_stats = {"parallel_calls": 0, "parallel_threads": 0, "serial_calls": 0,
              "prog_parallel_calls": 0, "prog_chain_threads": 0,
              "prog_serial_calls": 0}


def segment_decode_stats() -> dict:
    """Counters for restart-segment-parallel decode engagement (tests)."""
    return dict(_seg_stats)

_pool = None


def _segment_pool():
    """Shared executor for segment-range decode (persistent: pool startup
    would otherwise dwarf the few-ms decode of a typical image)."""
    global _pool
    if _pool is None:
        from concurrent.futures import ThreadPoolExecutor
        with _lock:
            if _pool is None:
                _pool = ThreadPoolExecutor(
                    max_workers=os.cpu_count() or 8,
                    thread_name_prefix="pjt-seg")
    return _pool


def decode_scan_cpp(header: JpegHeader, threads: int = 1,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """Entropy-decode via the C++ library; semantics match codec.entropy.

    With ``threads > 1`` and a restart interval present, disjoint restart-
    segment ranges decode concurrently (intra-image parallelism — the
    segment entry points the reference strips without exploiting,
    reference: src/jpeg_scanner.cpp:423).

    ``out`` (optional) is a caller-ZEROED C-contiguous int16
    ``[num_mcus, g, 64]`` destination — e.g. a slice of a batch transport
    buffer, skipping one full copy on the ML input path.
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native entropy decoder unavailable")
    if header.progressive:
        raise JpegError("Progressive scans are not supported")

    slots = header.slot_components()
    g = len(slots)
    num_mcus = header.num_mcus
    slot_comp = np.array([ci for ci, _, _ in slots], np.int32)
    comp_dc = np.zeros(3, np.int32)
    comp_ac = np.zeros(3, np.int32)
    for ci, c in enumerate(header.components):
        comp_dc[ci] = c.dc_id
        comp_ac[ci] = c.ac_id

    dc_counts, dc_symbols, ac_counts, ac_symbols = _stage_tables(header)
    data = np.frombuffer(header.entropy_bytes, np.uint8)
    seg_offsets = np.asarray(header.segment_offsets, np.int64)
    if out is None:
        out = np.zeros((num_mcus, g, 64), np.int16)
    else:
        if (out.shape != (num_mcus, g, 64) or out.dtype != np.int16
                or not out.flags.c_contiguous):
            raise ValueError(
                f"out must be C-contiguous int16 {(num_mcus, g, 64)}")

    # _vp pointers are safe here: every array is a local of this function
    # and the futures below resolve before it returns.
    common = (
        _vp(data), ctypes.c_int64(data.size),
        _vp(seg_offsets), ctypes.c_int32(seg_offsets.size),
    )
    tail = (
        ctypes.c_int32(header.restart_interval), ctypes.c_int32(num_mcus),
        ctypes.c_int32(g),
        _vp(slot_comp),
        _vp(dc_counts), _vp(dc_symbols),
        _vp(ac_counts), _vp(ac_symbols),
        _vp(comp_dc), _vp(comp_ac),
        _vp(out),
    )

    ri = header.restart_interval
    segs_used = -(-num_mcus // ri) if ri else 1
    threads = max(1, min(threads, segs_used,
                         num_mcus // _MIN_MCUS_PER_THREAD or 1))

    def raise_on_error(rc: int, err_mcu: ctypes.c_int32) -> None:
        if rc != 0:
            msg = _ERROR_MESSAGES.get(rc, f"native decode error {rc}")
            raise JpegError(f"{msg} (MCU {err_mcu.value})")

    if threads == 1:
        with _lock:  # pool worker threads also land here; += is not atomic
            _seg_stats["serial_calls"] += 1
        err_mcu = ctypes.c_int32(-1)
        rc = lib.pjt_decode_scan(*common, *tail, ctypes.byref(err_mcu))
        raise_on_error(rc, err_mcu)
        return out
    with _lock:
        _seg_stats["parallel_calls"] += 1
        _seg_stats["parallel_threads"] += threads

    if segs_used > seg_offsets.size:
        # Match the oracle's wording exactly: it fails at the FIRST absent
        # segment index (== the available count), codec/entropy.py:176.
        raise JpegError(
            f"Missing restart segment {seg_offsets.size} "
            f"(have {seg_offsets.size})")

    bounds = np.linspace(0, segs_used, threads + 1).astype(np.int32)

    def run_range(b: int, e: int):
        err_mcu = ctypes.c_int32(-1)
        rc = lib.pjt_decode_segments(
            *common, ctypes.c_int32(b), ctypes.c_int32(e), *tail,
            ctypes.byref(err_mcu))
        return rc, err_mcu

    # Drain EVERY submitted future before any raise leaves this frame:
    # the _vp pointers above keep no reference to the arrays, so an early
    # unwind would let this frame (the only owner of data/out/tables) die
    # while segment calls are still writing through the pointers
    # (use-after-free).  That covers both an erroring segment AND an
    # exception (KeyboardInterrupt/MemoryError) landing mid-submit-loop.
    # Segments never block on each other, so the wait is bounded.
    futures = []
    try:
        for i in range(threads):
            if bounds[i] < bounds[i + 1]:
                futures.append(_segment_pool().submit(
                    run_range, int(bounds[i]), int(bounds[i + 1])))
    except BaseException:
        for fut in futures:
            try:
                fut.result()
            except BaseException:
                pass
        raise
    results = []
    first_exc: BaseException | None = None
    for fut in futures:
        try:
            results.append(fut.result())
        except BaseException as exc:  # pool/ctypes failure: keep draining
            if first_exc is None:
                first_exc = exc
    if first_exc is not None:
        raise first_exc
    for rc, err_mcu in results:
        raise_on_error(rc, err_mcu)
    return out


def _scan_slots(header, scan):
    """Interleaved rule + block-slot rows for one progressive scan.

    Returns ``(interleaved, slots, bw, bh)`` with ``slots`` a list of
    ``(scan_comp_idx, comp_idx, qv, qh)`` tuples (the MCU's block slots in
    decode order) and ``bw/bh`` the non-interleaved component block grid.
    ONE implementation shared by the per-scan differential-reference path
    and the production image-level path — the rule must never diverge
    between them (semantics: codec/progressive._decode_one_scan)."""
    spec = scan.spec
    interleaved = scan.interleaved or (
        spec.start_of_selection == 0
        and len(scan.component_indices) == header.ncomp)
    if interleaved:
        slots = []
        for i, ci in enumerate(scan.component_indices):
            c = header.components[ci]
            for qv in range(c.v):
                for qh in range(c.h):
                    slots.append((i, ci, qv, qh))
        bw = bh = 0
    else:
        ci = scan.component_indices[0]
        slots = [(0, ci, 0, 0)]
        bw, bh = header.comp_blocks(ci)
    return interleaved, slots, bw, bh


def decode_progressive_scan_cpp(header, scan, planes: np.ndarray,
                                comp_offset: np.ndarray) -> None:
    """Decode ONE progressive scan via C++ into the shared plane buffer.

    ``planes`` is the concatenated zigzag-order coefficient planes
    ([total_blocks, 64] int32); ``comp_offset`` the per-component start
    offsets in int32 units.  Semantics match
    codec/progressive._decode_one_scan (differentially tested).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native entropy decoder unavailable")

    spec = scan.spec
    ss, se = spec.start_of_selection, spec.end_of_selection
    ah, al = spec.successive_high, spec.successive_low

    interleaved, slots, bw, bh = _scan_slots(header, scan)
    slot_scomp = [s[0] for s in slots]
    slot_ci = [s[1] for s in slots]
    slot_qv = [s[2] for s in slots]
    slot_qh = [s[3] for s in slots]

    nc = len(scan.component_indices)
    dc_counts = np.zeros((nc, 16), np.uint8)
    dc_symbols = np.zeros((nc, 162), np.uint8)
    ac_counts = np.zeros((nc, 16), np.uint8)
    ac_symbols = np.zeros((nc, 162), np.uint8)
    for i in range(nc):
        if scan.dc_specs[i] is not None:
            dc_counts[i] = scan.dc_specs[i].counts
            dc_symbols[i, : scan.dc_specs[i].symbols.size] = scan.dc_specs[i].symbols
        if scan.ac_specs[i] is not None:
            ac_counts[i] = scan.ac_specs[i].counts
            ac_symbols[i, : scan.ac_specs[i].symbols.size] = scan.ac_specs[i].symbols

    comp_v = np.zeros(3, np.int32)
    comp_h = np.zeros(3, np.int32)
    comp_bwp = np.zeros(3, np.int32)
    for ci, c in enumerate(header.components):
        comp_v[ci] = c.v
        comp_h[ci] = c.h
        comp_bwp[ci] = header.comp_blocks_padded(ci)[0]

    data = np.frombuffer(scan.entropy_bytes, np.uint8)
    seg_offsets = np.asarray(scan.segment_offsets, np.int64)
    err_unit = ctypes.c_int32(-1)

    def ptr(arr, ctype):
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    def iarr(values):
        return np.asarray(values, np.int32)

    rc = lib.pjt_decode_progressive_scan(
        ptr(data, ctypes.c_uint8), ctypes.c_int64(data.size),
        ptr(seg_offsets, ctypes.c_int64), ctypes.c_int32(seg_offsets.size),
        ctypes.c_int32(scan.restart_interval),
        ctypes.c_int32(ss), ctypes.c_int32(se),
        ctypes.c_int32(ah), ctypes.c_int32(al),
        ctypes.c_int32(1 if interleaved else 0),
        ctypes.c_int32(header.mcu_rows), ctypes.c_int32(header.mcu_cols),
        ctypes.c_int32(len(slot_ci)),
        ptr(iarr(slot_scomp), ctypes.c_int32),
        ptr(iarr(slot_ci), ctypes.c_int32),
        ptr(iarr(slot_qv), ctypes.c_int32),
        ptr(iarr(slot_qh), ctypes.c_int32),
        ptr(comp_v, ctypes.c_int32), ptr(comp_h, ctypes.c_int32),
        ctypes.c_int32(bw), ctypes.c_int32(bh),
        ctypes.c_int32(nc),
        ptr(dc_counts, ctypes.c_uint8), ptr(dc_symbols, ctypes.c_uint8),
        ptr(ac_counts, ctypes.c_uint8), ptr(ac_symbols, ctypes.c_uint8),
        ptr(planes, ctypes.c_int32),
        ptr(np.asarray(comp_offset, np.int64), ctypes.c_int64),
        ptr(comp_bwp, ctypes.c_int32),
        ctypes.byref(err_unit),
    )
    if rc != 0:
        msg = _ERROR_MESSAGES.get(rc, f"native decode error {rc}")
        raise JpegError(f"{msg} (unit {err_unit.value})")


def compact_wire_cpp(coeffs: np.ndarray):
    """Fused range-check + int8 narrowing of a coefficient array.

    Returns the int8 array when every value fits, the ORIGINAL array when
    some value does not (caller keeps the int16 wire), or None when the
    native library is unavailable.  Semantics identical to the NumPy path
    in runtime/batching.compact_wire.
    """
    lib = load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(coeffs)
    out = np.empty(flat.shape, np.int8)
    ok = lib.pjt_compact_wire(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ctypes.c_int64(flat.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out if ok else coeffs


def destuff_cpp(data: bytes, pos: int, stop_at_marker: bool):
    """Native de-stuff of one entropy-coded segment.

    Returns ``(destuffed_bytes, offsets_tuple, end_pos)`` with semantics
    identical to ``codec.scanner._scan_entropy``'s pure-Python path
    (differentially tested), or raises JpegError with the same messages.
    Returns None when the native library is unavailable (caller falls
    back to Python).
    """
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    n = buf.size
    out = np.empty(max(0, n - pos), np.uint8)
    # Restart-segment bound: every RSTn consumes 2 bytes, so (n-pos)//2+1
    # always suffices.  For large files count the actual RSTn pairs
    # instead (one vector pass) to keep the transient allocation small.
    if n - pos > (1 << 20):
        tail = buf[pos:]
        max_segs = int(np.count_nonzero(
            (tail[:-1] == 0xFF) & ((tail[1:] & 0xF8) == 0xD0))) + 1
    else:
        max_segs = max(1, (n - pos) // 2 + 1)
    seg = np.empty(max_segs, np.int64)
    out_len = ctypes.c_int64(0)
    n_segs = ctypes.c_int32(0)
    end_pos = ctypes.c_int64(0)
    term = ctypes.c_int32(0)
    rc = lib.pjt_destuff(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n), ctypes.c_int64(pos),
        ctypes.c_int32(1 if stop_at_marker else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(out_len),
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(max_segs), ctypes.byref(n_segs),
        ctypes.byref(end_pos), ctypes.byref(term))
    if rc == -2:  # out of data
        if term.value == 0:
            raise JpegError("Unexpected end of JPEG inside entropy-coded data")
        raise JpegError("Unexpected end of JPEG: no EOI marker")
    if rc == -1:  # invalid marker mid-scan
        from pim_jpeg_decoder_tpu_torch.codec import markers as M
        raise JpegError(
            f"Invalid marker {M.marker_name(0xFF00 | term.value)} inside "
            "entropy-coded data (multi-scan streams not supported)")
    if rc != 0:
        raise RuntimeError(f"pjt_destuff failed: {rc}")
    return (out[: out_len.value].tobytes(),
            tuple(int(x) for x in seg[: n_segs.value]),
            int(end_pos.value))


_Z16 = bytes(16)
_Z162 = bytes(162)
# Assemble slot-index arrays keyed by the slot tuple (a mode-level
# constant: 6 distinct sampling modes exist, so this never grows).
_ASSEMBLE_SLOTS: dict = {}


def _assemble_slot_arrays(slots):
    key = tuple(slots)
    arrs = _ASSEMBLE_SLOTS.get(key)
    if arrs is None:
        slot_arr = np.array(slots, np.int32)
        arrs = tuple(np.ascontiguousarray(slot_arr[:, j]) for j in range(3))
        _ASSEMBLE_SLOTS[key] = arrs
    return arrs


def decode_progressive_image_cpp(header, threads: int = 1,
                                 scan_seconds=None) -> np.ndarray:
    """Decode ALL scans of a progressive image in ONE native call and
    assemble the ``[num_mcus, g, 64]`` int16 natural-order transport.

    Equivalent to looping :func:`decode_progressive_scan_cpp` over
    ``header.scans`` plus the NumPy de-zigzag assembly (differentially
    tested against that path), but with per-image instead of per-scan
    staging/dispatch — the Python overhead that dominated the progressive
    wall clock.

    ``threads > 1`` partitions the scan script into per-component chains
    and fans them across the shared pool: non-interleaved progressive
    scans are single-component bitstream segments with no cross-component
    data dependence (T.81 G.2), so the 2-3 chains decode concurrently
    into disjoint plane ranges; each chain re-decodes the (small)
    interleaved DC scans with writes masked to its own components
    (``comp_mask``).  Output is byte-identical to serial decode (tested).

    ``scan_seconds`` (optional ``[nscans]`` float64 array, threads=1 only)
    receives per-scan decode seconds — the accounting surface behind
    tools/prog_profile.py.
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native entropy decoder unavailable")

    nscans = len(header.scans)
    if nscans == 0:
        raise JpegError("Progressive stream has no scans")

    # Plane buffer: concatenated zigzag-order per-component planes.
    # np.zeros is the cheapest zero-init here (lazy zero pages); an
    # explicit memset of a reused buffer measured SLOWER (~140 us vs
    # ~110 us for this 1.8 MB buffer on a 0.3 MP 4:2:0 image).
    ncomp = header.ncomp
    comp_offset = np.zeros(3, np.int64)
    total = 0
    sizes = []
    for ci in range(ncomp):
        bwp, bhp = header.comp_blocks_padded(ci)
        sizes.append((bhp, bwp))
        comp_offset[ci] = total * 64
        total += bhp * bwp
    planes = np.zeros(total * 64, np.int32)

    components = header.components
    comp_v = np.zeros(3, np.int32)
    comp_h = np.zeros(3, np.int32)
    comp_bwp = np.zeros(3, np.int32)
    for ci, c in enumerate(components):
        comp_v[ci] = c.v
        comp_h[ci] = c.h
        comp_bwp[ci] = sizes[ci][1]

    # Flat per-scan staging.  Rows accumulate as FLAT Python int lists /
    # bytes chunks and convert in ONE np.array / frombuffer call each —
    # per-row numpy assignment and nested-list np.array were the
    # progressive path's hottest Python lines (tools/prog_profile.py).
    data = b"".join(s.entropy_bytes for s in header.scans)
    scan_data_l = []      # flat nscans x 2 int64
    seg_idx_l = [0]       # nscans+1 prefix sums
    scan_i32_l = []       # flat nscans x 10 int32
    slots_l = []          # flat nscans x 40 int32 (10 slots x 4, 0-padded)
    z16, z162 = _Z16, _Z162
    dcc, dcs, acc, acs = [], [], [], []    # 3 bytes rows per scan
    spec_rows: dict = {}  # id(spec) -> (counts16, symbols162) bytes

    def table_row(spec):
        r = spec_rows.get(id(spec))
        if r is None:
            r = (spec.counts.tobytes(),
                 spec.symbols.tobytes().ljust(162, b"\0"))
            spec_rows[id(spec)] = r
        return r

    seg_parts = []
    pad40 = (0,) * 40
    off = 0
    for scan in header.scans:
        spec = scan.spec
        nbytes = len(scan.entropy_bytes)
        scan_data_l += (off, nbytes)
        off += nbytes
        segs = scan.segment_offsets
        seg_parts += segs
        seg_idx_l.append(seg_idx_l[-1] + len(segs))

        comp_indices = scan.component_indices
        interleaved, slots, bw, bh = _scan_slots(header, scan)
        slot_row = [x for s in slots for x in s]
        ns = len(slots)
        slots_l += slot_row
        slots_l += pad40[len(slot_row):]
        scan_i32_l += (spec.start_of_selection, spec.end_of_selection,
                       spec.successive_high, spec.successive_low,
                       1 if interleaved else 0, scan.restart_interval,
                       ns, len(comp_indices), bw, bh)
        nc = len(comp_indices)
        for i in range(3):
            dspec = scan.dc_specs[i] if i < nc else None
            aspec = scan.ac_specs[i] if i < nc else None
            if dspec is not None:
                c, s = table_row(dspec)
                dcc.append(c)
                dcs.append(s)
            else:
                dcc.append(z16)
                dcs.append(z162)
            if aspec is not None:
                c, s = table_row(aspec)
                acc.append(c)
                acs.append(s)
            else:
                acc.append(z16)
                acs.append(z162)
    scan_data = np.array(scan_data_l, np.int64)
    seg_idx = np.array(seg_idx_l, np.int64)
    scan_i32 = np.array(scan_i32_l, np.int32)
    slots_all = np.array(slots_l, np.int32)
    seg_offsets_all = np.array(seg_parts, np.int64)
    dc_counts = np.frombuffer(b"".join(dcc), np.uint8)
    dc_symbols = np.frombuffer(b"".join(dcs), np.uint8)
    ac_counts = np.frombuffer(b"".join(acc), np.uint8)
    ac_symbols = np.frombuffer(b"".join(acs), np.uint8)
    data_arr = np.frombuffer(data, np.uint8)

    def run_chain(comp_mask: int, seconds: np.ndarray | None):
        err_scan = ctypes.c_int32(-1)
        err_unit = ctypes.c_int32(-1)
        rc = lib.pjt_decode_progressive_image(
            _vp(data_arr), ctypes.c_int64(data_arr.size),
            ctypes.c_int32(nscans),
            _vp(scan_data), _vp(seg_offsets_all), _vp(seg_idx),
            _vp(scan_i32), _vp(slots_all),
            _vp(comp_v), _vp(comp_h),
            ctypes.c_int32(header.mcu_rows), ctypes.c_int32(header.mcu_cols),
            _vp(dc_counts), _vp(dc_symbols), _vp(ac_counts), _vp(ac_symbols),
            _vp(planes), _vp(comp_offset), _vp(comp_bwp),
            ctypes.c_int32(comp_mask),
            (_vp(seconds) if seconds is not None else None),
            ctypes.byref(err_scan), ctypes.byref(err_unit),
        )
        return rc, err_scan.value, err_unit.value

    # Component-chain partition: greedy by padded block count into
    # min(threads, ncomp) groups (luma carries most of the bits, so at
    # 2 threads the natural split is [Y], [Cb, Cr]).
    n_chains = max(1, min(threads, ncomp))
    if n_chains > 1:
        with _lock:
            _seg_stats["prog_parallel_calls"] += 1
            _seg_stats["prog_chain_threads"] += n_chains
        groups = [[0, 0] for _ in range(n_chains)]  # [weight, mask]
        for ci in sorted(range(ncomp),
                         key=lambda c: -sizes[c][0] * sizes[c][1]):
            g0 = min(groups, key=lambda g: g[0])
            g0[0] += sizes[ci][0] * sizes[ci][1]
            g0[1] |= 1 << ci
        futures = [_segment_pool().submit(run_chain, mask, None)
                   for _, mask in groups]
        # Drain EVERY chain before any raise can unwind this frame: the
        # staged arrays are locals and the native calls write through raw
        # pointers into them (same use-after-free hazard as the segment
        # fan-out above).
        results, first_exc = [], None
        for f in futures:
            try:
                results.append(f.result())
            except BaseException as exc:
                first_exc = first_exc or exc
        if first_exc is not None:
            raise first_exc
        bad = [r for r in results if r[0] != 0]
        if bad:
            # Serial order stops at the FIRST failing scan; the chain that
            # saw the smallest scan index reports it (identical message).
            rc, es, eu = min(bad, key=lambda r: r[1])
            msg = _ERROR_MESSAGES.get(rc, f"native decode error {rc}")
            raise JpegError(f"{msg} (scan {es}, unit {eu})")
    else:
        with _lock:
            _seg_stats["prog_serial_calls"] += 1
        rc, es, eu = run_chain(0x7, scan_seconds)
        if rc != 0:
            msg = _ERROR_MESSAGES.get(rc, f"native decode error {rc}")
            raise JpegError(f"{msg} (scan {es}, unit {eu})")

    # Transport assembly (de-zigzag + saturation + slot gather) in C++.
    slots = header.slot_components()
    g = len(slots)
    slot_ci, slot_qv, slot_qh = _assemble_slot_arrays(slots)
    out = np.empty((header.num_mcus, g, 64), np.int16)
    rc = lib.pjt_progressive_assemble(
        _vp(planes), _vp(comp_offset), _vp(comp_bwp),
        ctypes.c_int32(header.num_mcus), ctypes.c_int32(header.mcu_cols),
        ctypes.c_int32(g),
        _vp(slot_ci), _vp(slot_qv), _vp(slot_qh),
        _vp(comp_v), _vp(comp_h),
        _vp(out),
    )
    if rc != 0:
        raise RuntimeError(f"pjt_progressive_assemble failed: {rc}")
    return out


def bmp_rows_cpp(rgb: np.ndarray, out: np.ndarray) -> bool:
    """Fill ``out`` ([height, row_bytes] uint8) with bottom-up padded BGR
    rows from ``rgb`` ([H, W, 3] uint8, C-contiguous) — the byte-movement
    half of io/bmp.encode_bmp.  Returns False when the native library is
    unavailable (caller falls back to NumPy)."""
    lib = load()
    if lib is None:
        return False
    if (rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8
            or not rgb.flags.c_contiguous or out.dtype != np.uint8
            or not out.flags.c_contiguous or out.shape[0] != rgb.shape[0]
            or out.shape[1] < rgb.shape[1] * 3):
        raise ValueError(
            f"bmp_rows: rgb {rgb.shape} / out {out.shape} inconsistent")
    rc = lib.pjt_bmp_rows(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(rgb.shape[0]), ctypes.c_int64(rgb.shape[1]),
        ctypes.c_int64(out.shape[1]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"pjt_bmp_rows failed: {rc}")
    return True


def raster_rgb_cpp(raw: np.ndarray, v: int, h: int, n: int,
                   mcu_rows: int, mcu_cols: int, out_h: int,
                   out_w: int, mcu_off: int = 0):
    """Raster-assemble kernel-native raw RGB ``[3, V*H, n*n, M]`` uint8
    into ``[out_h, out_w, 3]`` (models.pipeline.assemble_raster_raw_scaled
    semantics), reading the image's MCUs at ``mcu_off`` within the (padded,
    possibly multi-image) batch buffer — so the engine can pass the FULL
    launch buffer instead of a non-contiguous slice.  Returns None when
    the native library is unavailable or the input is not the expected
    C-contiguous uint8 geometry (caller falls back to NumPy)."""
    lib = load()
    if (lib is None or raw.dtype != np.uint8
            or not raw.flags.c_contiguous
            or raw.ndim != 4 or raw.shape[0] != 3
            or raw.shape[1] != v * h or raw.shape[2] != n * n
            or mcu_off + mcu_rows * mcu_cols > raw.shape[3]):
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.pjt_raster_rgb(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(raw.shape[3]), ctypes.c_int64(mcu_off),
        ctypes.c_int32(v), ctypes.c_int32(h),
        ctypes.c_int32(n), ctypes.c_int32(mcu_rows),
        ctypes.c_int32(mcu_cols), ctypes.c_int32(out_h),
        ctypes.c_int32(out_w),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"pjt_raster_rgb failed: {rc}")
    return out


def ycbcr_to_rgb_cpp(planes: np.ndarray, mcu_off: int, v: int, h: int,
                     ncomp: int, mcu_rows: int, mcu_cols: int,
                     height: int, width: int) -> np.ndarray:
    """Fused upsample + BT.601 + raster from the device's YCbCr wire layout.

    ``planes`` is the fetched kernel output ``[g, 64, m_total]`` uint8
    (level-shifted, MCU axis minor); returns ``[height, width, 3]`` uint8,
    bit-identical to the fused RGB kernel path (shared integer spec).
    """
    lib = load()
    if lib is None:  # callers gate on native_available(), but fail loudly
        raise RuntimeError("native entropy decoder unavailable")
    planes = np.ascontiguousarray(planes, np.uint8)
    g = v * h + (2 if ncomp == 3 else 0)
    if (planes.ndim != 3 or planes.shape[0] != g or planes.shape[1] != 64
            or mcu_off < 0
            or mcu_off + mcu_rows * mcu_cols > planes.shape[2]):
        raise ValueError(
            f"planes {planes.shape} inconsistent with v={v} h={h} "
            f"ncomp={ncomp} mcus={mcu_rows}x{mcu_cols}+{mcu_off}")
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.pjt_ycbcr_to_rgb(
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(planes.shape[2]), ctypes.c_int64(mcu_off),
        ctypes.c_int32(v), ctypes.c_int32(h), ctypes.c_int32(ncomp),
        ctypes.c_int32(mcu_rows), ctypes.c_int32(mcu_cols),
        ctypes.c_int32(height), ctypes.c_int32(width),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"pjt_ycbcr_to_rgb failed: {rc}")
    return out


def ycbcr_to_bmp_rows_cpp(planes: np.ndarray, mcu_off: int, v: int, h: int,
                          ncomp: int, mcu_rows: int, mcu_cols: int,
                          height: int, width: int, row_bytes: int,
                          out_rows: np.ndarray) -> None:
    """Fused upsample + BT.601 + BMP row serialization from the YCbCr wire
    layout: fills ``out_rows`` ([height, row_bytes] uint8, C-contiguous)
    with bottom-up padded BGR rows, byte-identical to
    ``ycbcr_to_rgb_cpp`` + ``bmp_rows_cpp`` while skipping the
    intermediate RGB raster (the BMP path's largest remaining host cost,
    reference analog: the per-pixel convert loop,
    reference: src/decoder_dpu.c:361-390)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native entropy decoder unavailable")
    planes = np.ascontiguousarray(planes, np.uint8)
    g = v * h + (2 if ncomp == 3 else 0)
    if (planes.ndim != 3 or planes.shape[0] != g or planes.shape[1] != 64
            or mcu_off < 0
            or mcu_off + mcu_rows * mcu_cols > planes.shape[2]
            or out_rows.dtype != np.uint8 or not out_rows.flags.c_contiguous
            or out_rows.shape != (height, row_bytes)
            or row_bytes < width * 3):
        raise ValueError(
            f"planes {planes.shape} / rows {out_rows.shape} inconsistent "
            f"with v={v} h={h} ncomp={ncomp} "
            f"mcus={mcu_rows}x{mcu_cols}+{mcu_off} {height}x{width}")
    rc = lib.pjt_ycbcr_to_bmp_rows(
        planes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(planes.shape[2]), ctypes.c_int64(mcu_off),
        ctypes.c_int32(v), ctypes.c_int32(h), ctypes.c_int32(ncomp),
        ctypes.c_int32(mcu_rows), ctypes.c_int32(mcu_cols),
        ctypes.c_int32(height), ctypes.c_int32(width),
        ctypes.c_int64(row_bytes),
        out_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise RuntimeError(f"pjt_ycbcr_to_bmp_rows failed: {rc}")
