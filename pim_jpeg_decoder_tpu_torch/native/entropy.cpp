// Native host entropy decoder (baseline JPEG, interleaved scan).
//
// C++ fast path for the host hot loop — the equivalent of the reference's
// decode_Huffman_data / decode_MCU_component / BitReader
// (reference: src/jpeg_scanner.cpp:707-756,467-520; src/headers/jpeg.h:81-122),
// rebuilt with:
//   * a 64-bit bit buffer with an 8-bit L1-resident lookahead LUT plus
//     canonical maxcode fallback (vs the reference's bit-at-a-time linear
//     code search),
//   * restart intervals counted in MCUs per ITU-T T.81 E.2.4 with recorded
//     segment byte offsets as re-entry points,
//   * output written directly into the TPU transport layout
//     [num_mcus, g, 64] int16, natural (de-zigzagged) order.
//
// Semantics are identical to pim_jpeg_decoder_tpu_torch/codec/entropy.py (the
// NumPy oracle); tests assert byte-identical output on every mode.
//
// Built on demand by binding.py:  g++ -O3 -shared -fPIC entropy.cpp
// Exposed via ctypes (calls release the GIL, so producer threads scale).

#include <cassert>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>
#if defined(__BMI2__) || defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// Error codes (binding.py maps these to JpegError messages).
enum ErrorCode : int32_t {
  OK = 0,
  ERR_BAD_CODE = -1,
  ERR_OUT_OF_DATA = -2,
  ERR_BAD_DC_SIZE = -3,
  ERR_AC_RANGE = -4,
  ERR_MISSING_SEGMENT = -5,
  ERR_BAD_AC_SYMBOL = -6,
  ERR_BAD_ARGS = -7,
};

// Standard zigzag -> natural index map (ITU-T T.81 Figure A.6); must match
// codec/tables.py:ZIGZAG.
const int32_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct BitReader {
  const uint8_t* data;
  int64_t len;
  int64_t pos;        // next byte to load into the buffer
  uint64_t buf;       // MSB-first bit buffer
  int32_t cnt;        // valid bits in buf
  int64_t overrun;    // pad bytes consumed past the end

  void seek(int64_t byte_offset) {
    pos = byte_offset;
    buf = 0;
    cnt = 0;
    overrun = 0;
  }

  inline void fill() {
    if (cnt > 32) return;
    if (pos + 4 <= len) {
      // Fast path: the stream is already de-stuffed, so a raw 32-bit
      // big-endian load needs no marker checks.
      uint32_t w;
      __builtin_memcpy(&w, data + pos, 4);
      buf = (buf << 32) | __builtin_bswap32(w);
      cnt += 32;
      pos += 4;
      return;
    }
    while (cnt <= 56) {
      uint8_t b;
      if (pos < len) {
        b = data[pos++];
      } else {
        b = 0;
        ++overrun;
      }
      buf = (buf << 8) | b;
      cnt += 8;
    }
  }

  inline uint32_t peek16() {
    fill();
    return static_cast<uint32_t>((buf >> (cnt - 16)) & 0xFFFFu);
  }

  inline void drop(int32_t n) { cnt -= n; }

  inline uint32_t read_bits(int32_t n) {
    if (n == 0) return 0;
    fill();
    uint32_t v = static_cast<uint32_t>((buf >> (cnt - n)) & ((1u << n) - 1u));
    cnt -= n;
    return v;
  }

  // Value bits taken immediately after decode_symbol need no refill: the
  // lookup's fill() left cnt >= 32 (early-out only when cnt > 32; the fast
  // path adds exactly 32) and the symbol consumed <= 16 bits, so >= 16
  // bits remain — enough for the baseline 8-bit maxima (DC <= 11,
  // AC <= 10).  NOTE the margin is exactly 1 bit over a 15-bit magnitude;
  // re-verify before reusing for wider magnitudes (e.g. 12-bit precision).
  inline uint32_t take_nofill(int32_t n) {
    if (n == 0) return 0;
    // Safety depends on non-local invariants (fill() leaves cnt >= 32;
    // a symbol is <= 16 bits and its magnitude <= 15, so drop(<=16) +
    // take_nofill(<=15) fits) — keep them loud in debug builds.
    assert(cnt >= n && "take_nofill underflow: fill()/drop() invariant broken");
    uint32_t v = static_cast<uint32_t>((buf >> (cnt - n)) & ((1u << n) - 1u));
    cnt -= n;
    return v;
  }

  // True once decode has consumed bits that never existed in the stream.
  inline bool exhausted() const { return overrun * 8 > cnt; }
};

// Defined-behavior helpers for signed fixed-point arithmetic: left shift
// of a negative value and signed wraparound addition are UB in C++17;
// route both through uint32_t (identical two's-complement bit patterns,
// and what the optimizer emitted anyway -- UBSan-clean now).
inline int32_t shl32(int32_t v, int32_t n) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << n);
}
inline int32_t wrap_add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              + static_cast<uint32_t>(b));
}

// JPEG signed-magnitude EXTEND (ITU-T T.81 F.2.2.1).
inline int32_t extend_signed(uint32_t value, int32_t size) {
  if (size == 0) return 0;
  if (value < (1u << (size - 1))) {
    return static_cast<int32_t>(value) - (1 << size) + 1;
  }
  return static_cast<int32_t>(value);
}

// Canonical Huffman decode table: an 8-bit L1-resident lookahead LUT for
// short codes (the overwhelming majority) plus maxcode/valoffset arrays for
// the 9..16-bit tail — the libjpeg-style structure, vastly more cache
// friendly than a flat peek-16 LUT.
struct HuffTable {
  uint16_t lut[256];       // (symbol << 8) | code_length for lengths <= 8
  int32_t maxcode[17];     // largest code of each length, or -1
  int32_t valoffset[17];   // symbol_index = code + valoffset[length]
  uint8_t symbols[162];    // canonical symbol order (owned: tables are
                           // cached across calls, caller buffers are not)
  bool present;
};

// Builds the decode structure from DHT counts/symbols.  Returns false for
// structurally invalid tables (code overflow).
inline bool build_table(const uint8_t* counts, const uint8_t* symbols,
                        HuffTable* t) {
  for (int i = 0; i < 256; ++i) t->lut[i] = 0;
  __builtin_memcpy(t->symbols, symbols, 162);
  int32_t code = 0;
  int32_t k = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = counts[l - 1];
    if (n == 0) {
      t->maxcode[l] = -1;
      t->valoffset[l] = 0;
    } else {
      if (code + n > (1 << l)) return false;  // over-subscribed
      t->valoffset[l] = k - code;
      if (l <= 8) {
        for (int j = 0; j < n; ++j) {
          uint16_t entry =
              static_cast<uint16_t>((symbols[k + j] << 8) | l);
          int lo = (code + j) << (8 - l);
          int hi = lo + (1 << (8 - l));
          for (int p = lo; p < hi; ++p) t->lut[p] = entry;
        }
      }
      code += n;
      k += n;
      t->maxcode[l] = code - 1;
    }
    code <<= 1;
  }
  t->present = k > 0;
  return true;
}

// 12-bit fast-AC lookup (libjpeg-turbo style): for AC codes whose
// (code length + magnitude size) <= 12, one table read yields the zero
// run, the fully sign-extended coefficient value, and the total bits to
// consume — symbol decode, magnitude read and EXTEND in a single step.
// 4096 entries x 4 B = 16 KiB per table (L1-resident).
// The pair extension (run2/val2/bits2) packs a SECOND symbol into the same
// probe when both symbols' code+magnitude bits fit in the 12-bit window —
// high-frequency AC tails are runs of +-1 coefficients with 2-4 bit codes,
// so one L1 load frequently resolves two coefficients (or a coefficient
// plus the block-terminating EOB), halving the serial load chain.  Only
// the guarded fast path consults the pair fields; the careful path and the
// progressive ac_first read value/run/packed exactly as before.
struct FastAc {
  int16_t value;    // sign-extended coefficient
  int8_t run;       // 0..15 coefficient run; 16 = ZRL; 17 = EOB; -1 = slow
  uint8_t packed;   // (code_length << 4) | total_bits, both <= 12
  int16_t val2;     // pair: second coefficient (size2 <= 9 -> +-511); else 0
  uint8_t run2enc;  // run2 | (pair << 4) | (pair_eob << 5); 0 = single
  uint8_t bits2;    // total bits: t1 for singles, t1 + t2 for pairs
};

inline void build_fast_ac(const uint8_t* counts, const uint8_t* symbols,
                          FastAc* fast) {
  // Table init is a per-scan fixed cost (progressive images rebuild per
  // scan): one 8-byte pattern store per entry instead of four field
  // writes.
  static_assert(sizeof(FastAc) == 8, "pattern fill assumes 8-byte FastAc");
  const FastAc empty{0, -1, 0, 0, 0, 0};
  uint64_t pat;
  __builtin_memcpy(&pat, &empty, 8);
  // Per-entry memcpy (not a reinterpret_cast'd uint64_t store: FastAc has
  // alignof 2, so that would be an aliasing/alignment violation); the
  // compiler fuses these into the same 8-byte stores.
  for (int i = 0; i < 4096; ++i) __builtin_memcpy(&fast[i], &pat, 8);
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = counts[l - 1];
    if (l <= 12) {
      for (int j = 0; j < n; ++j) {
        const int sym = symbols[k + j];
        const int run = sym >> 4;
        const int size = sym & 0x0F;
        const int32_t base = (code + j) << (12 - l);
        if (sym == 0x00 || sym == 0xF0) {
          const int8_t r = (sym == 0xF0) ? 16 : 17;   // ZRL : EOB
          const uint8_t pk = static_cast<uint8_t>((l << 4) | l);
          for (int p = 0; p < (1 << (12 - l)); ++p) {
            fast[base + p].run = r;
            fast[base + p].packed = pk;
            fast[base + p].bits2 = static_cast<uint8_t>(l);
          }
        } else if (size == 0) {
          // Progressive EOBn symbols are INVALID in a baseline scan: leave
          // the slow path to report ERR_BAD_AC_SYMBOL identically.
        } else if (l + size <= 12) {
          const int tail = 12 - l - size;
          const uint8_t pk = static_cast<uint8_t>((l << 4) | (l + size));
          for (int v = 0; v < (1 << size); ++v) {
            const int16_t val =
                static_cast<int16_t>(extend_signed(v, size));
            const int32_t b2 = base + (v << tail);
            for (int p = 0; p < (1 << tail); ++p) {
              fast[b2 + p].value = val;
              fast[b2 + p].run = static_cast<int8_t>(run);
              fast[b2 + p].packed = pk;
              fast[b2 + p].bits2 = static_cast<uint8_t>(l + size);
            }
          }
        }
        // else: code fits but magnitude spills past 12 bits -> slow path.
      }
    }
    code = (code + n) << 1;
    k += n;
  }

  // Pair pass: for every fully-resolved coefficient entry, decode the
  // REMAINDER of the 12-bit window against the table built above.  If it
  // completes another coefficient (or an EOB) within the window, record
  // the pair.  |val2| <= 127 always: t1 >= 3 and code2 >= 2 leave
  // size2 <= 7.
  for (int i = 0; i < 4096; ++i) {
    if (fast[i].run < 0 || fast[i].run > 15) continue;
    const int t1 = fast[i].packed & 0x0F;
    if (t1 >= 11) continue;  // no room for a 2-bit minimum second code
    const FastAc f2 = fast[(i << t1) & 0xFFF];
    if (f2.run < 0) continue;
    const int t2 = f2.packed & 0x0F;
    if (t1 + t2 > 12) continue;
    if (f2.run <= 15) {
      fast[i].val2 = f2.value;
      fast[i].run2enc = static_cast<uint8_t>(f2.run | 16);
      fast[i].bits2 = static_cast<uint8_t>(t1 + t2);
    } else if (f2.run == 17) {  // coefficient then EOB
      fast[i].run2enc = 32;
      fast[i].bits2 = static_cast<uint8_t>(t1 + t2);
    }
  }
}

// 12-bit fused DC lookup: for DC codes where code length + magnitude size
// fits in 12 bits, one read yields the fully EXTENDed differential and the
// total bits to consume.  bits == 0 marks the slow path (long code, large
// magnitude, or the invalid size > 11 — the slow path reports that error
// with identical precedence).
struct FastDc {
  int16_t value;  // sign-extended DC differential
  uint8_t bits;   // total bits (code + magnitude); 0 = slow path
};

inline void build_fast_dc(const uint8_t* counts, const uint8_t* symbols,
                          FastDc* fast) {
  for (int i = 0; i < 4096; ++i) fast[i].bits = 0;
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = counts[l - 1];
    if (l <= 12) {
      for (int j = 0; j < n; ++j) {
        const int size = symbols[k + j];
        if (size > 11 || l + size > 12) continue;  // slow path
        const int32_t base = (code + j) << (12 - l);
        if (size == 0) {
          for (int p = 0; p < (1 << (12 - l)); ++p) {
            fast[base + p].value = 0;
            fast[base + p].bits = static_cast<uint8_t>(l);
          }
        } else {
          const int tail = 12 - l - size;
          for (int v = 0; v < (1 << size); ++v) {
            const int16_t val = static_cast<int16_t>(extend_signed(v, size));
            const int32_t b2 = base + (v << tail);
            for (int p = 0; p < (1 << tail); ++p) {
              fast[b2 + p].value = val;
              fast[b2 + p].bits = static_cast<uint8_t>(l + size);
            }
          }
        }
      }
    }
    code = (code + n) << 1;
    k += n;
  }
}

// Content-keyed table-build cache.  Progressive images rebuild per-scan
// tables from identical DHT snapshots (files typically define each table
// once), and corpus decodes repeat the standard tables image to image on
// the same pool thread — a 178-byte memcmp skips the rebuild when the
// definition is unchanged.  Callers pair each key with thread_local table
// storage and must mark the key invalid when a build fails.
struct TableKey {
  uint8_t bytes[16 + 162];
  bool valid = false;
  // True = cache hit (tables for this key are already built).
  bool check(const uint8_t* counts, const uint8_t* symbols) {
    if (valid && !__builtin_memcmp(bytes, counts, 16) &&
        !__builtin_memcmp(bytes + 16, symbols, 162)) {
      return true;
    }
    __builtin_memcpy(bytes, counts, 16);
    __builtin_memcpy(bytes + 16, symbols, 162);
    valid = true;
    return false;
  }
};

// Top-aligned branchless bit cursor for the guarded fast path.  Valid only
// while the caller guarantees >= 8 readable bytes at every refill() — the
// per-MCU slack check in the segment loop (kBlockSlack bytes per block)
// makes both buffer overrun AND out-of-data exhaustion impossible, so the
// hot loop carries no end-of-stream branches at all (the careful BitReader
// path finishes the stream tail with identical semantics).
//
// refill() is Fabian Giesen's "variant 4": one unaligned 64-bit load per
// call, no branches, leaves 56..63 valid bits.
struct FastState {
  const uint8_t* data;
  uint64_t buf;   // stream bits at the TOP of the word; zeros below
  int32_t bits;   // valid bit count, top-aligned
  int64_t pos;    // next byte to load

  void init(const uint8_t* d, int64_t bitpos) {
    data = d;
    pos = bitpos >> 3;
    buf = 0;
    bits = 0;
    refill();
    consume(static_cast<int32_t>(bitpos & 7));
  }

  inline void refill() {
    uint64_t w;
    __builtin_memcpy(&w, data + pos, 8);
    buf |= __builtin_bswap64(w) >> bits;
    pos += (63 - bits) >> 3;
    bits |= 56;
  }

  inline uint32_t peek(int32_t n) const {
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  inline uint32_t peek12() const { return static_cast<uint32_t>(buf >> 52); }

  inline void consume(int32_t n) {
    buf <<= n;
    bits -= n;
  }

  inline uint32_t take(int32_t n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    consume(n);
    return v;
  }

  // Absolute bit offset of the next unconsumed bit.
  inline int64_t bit_position() const { return pos * 8 - bits; }
};

// Worst-case bytes one block can consume: DC (16+11 bits) + 63 AC
// coefficients at (16+15) bits = 1980 bits = 248 bytes, plus the cursor's
// byte-granularity lead (<= 8) and the 8-byte refill lookahead.  264
// covers all of it even for single-slot (grayscale) MCUs.
//
// The 15-bit AC magnitude matters: T.81 baseline encoders only *emit*
// sizes <= 10, but the 4-bit size field admits up to 15 and both the
// Python oracle and the careful native path accept such (crafted) streams
// -- so the guarded fast path must budget for them too.  (The FastState
// bit budget already covers it: slow-path entry sits <= 24 bits behind a
// refill, and 24 + 16 + 15 = 55 <= 56.)
constexpr int64_t kBlockSlack = 264;

inline int32_t decode_symbol(BitReader& br, const HuffTable& tab,
                             int32_t* out_sym) {
  uint32_t p16 = br.peek16();
  uint16_t e = tab.lut[p16 >> 8];
  if (e) {
    br.drop(e & 0xFF);
    if (br.exhausted()) return ERR_OUT_OF_DATA;
    *out_sym = e >> 8;
    return OK;
  }
  // Long code: scan lengths 9..16 against maxcode.
  for (int l = 9; l <= 16; ++l) {
    int32_t c = static_cast<int32_t>(p16 >> (16 - l));
    if (tab.maxcode[l] >= 0 && c <= tab.maxcode[l]) {
      br.drop(l);
      if (br.exhausted()) return ERR_OUT_OF_DATA;
      *out_sym = tab.symbols[c + tab.valoffset[l]];
      return OK;
    }
  }
  return ERR_BAD_CODE;
}

inline int32_t decode_block(BitReader& br, int16_t* out, const HuffTable& dc,
                            const HuffTable& ac, const FastAc* fast,
                            int32_t* dc_pred) {
  int32_t t;
  int32_t rc = decode_symbol(br, dc, &t);
  if (rc != OK) return rc;
  if (t > 11) return ERR_BAD_DC_SIZE;
  int32_t diff = extend_signed(br.take_nofill(t), t);
  if (br.exhausted()) return ERR_OUT_OF_DATA;
  *dc_pred = wrap_add32(*dc_pred, diff);
  out[0] = static_cast<int16_t>(*dc_pred);

  int32_t k = 1;
  while (k < 64) {
    // Fast path: one 16 KiB-table read decodes run+value+bits for the
    // overwhelming majority of AC codes.  Bit accounting AND error
    // precedence are identical to the slow path: drop the code bits,
    // check exhaustion, range-check, then drop the magnitude bits.
    const FastAc fa = fast[br.peek16() >> 4];
    if (fa.run >= 0) {
      br.drop(fa.packed >> 4);
      if (br.exhausted()) return ERR_OUT_OF_DATA;
      if (fa.run < 16) {
        k += fa.run;
        if (k > 63) return ERR_AC_RANGE;
        br.drop((fa.packed & 0x0F) - (fa.packed >> 4));
        if (br.exhausted()) return ERR_OUT_OF_DATA;
        out[kZigzag[k]] = fa.value;
        ++k;
      } else if (fa.run == 16) {
        k += 16;  // ZRL
      } else {
        return OK;  // EOB
      }
      continue;
    }
    int32_t sym;
    rc = decode_symbol(br, ac, &sym);
    if (rc != OK) return rc;
    if (sym == 0x00) return OK;  // EOB
    int32_t run = sym >> 4;
    int32_t size = sym & 0x0F;
    if (size == 0) {
      if (sym != 0xF0) return ERR_BAD_AC_SYMBOL;
      k += 16;  // ZRL
      continue;
    }
    k += run;
    if (k > 63) return ERR_AC_RANGE;
    out[kZigzag[k]] =
        static_cast<int16_t>(extend_signed(br.take_nofill(size), size));
    if (br.exhausted()) return ERR_OUT_OF_DATA;
    ++k;
  }
  return OK;
}

// Symbol decode on the fast cursor: same table structure and precedence as
// decode_symbol, minus the (impossible-here) exhaustion checks.  Callers
// guarantee >= 16 valid bits (refill leaves >= 56; at most one failed
// 12-bit probe precedes this call and probes consume nothing).
inline int32_t decode_symbol_fs(FastState& fs, const HuffTable& tab,
                                int32_t* out_sym) {
  uint32_t p16 = fs.peek(16);
  uint16_t e = tab.lut[p16 >> 8];
  if (e) {
    fs.consume(e & 0xFF);
    *out_sym = e >> 8;
    return OK;
  }
  for (int l = 9; l <= 16; ++l) {
    int32_t c = static_cast<int32_t>(p16 >> (16 - l));
    if (tab.maxcode[l] >= 0 && c <= tab.maxcode[l]) {
      fs.consume(l);
      *out_sym = tab.symbols[c + tab.valoffset[l]];
      return OK;
    }
  }
  return ERR_BAD_CODE;
}

// Guarded-region block decode: bit-identical coefficients and error codes
// to decode_block (differential tests + fuzz assert this), restructured
// for the serial dependency chain — branchless refills, one fused LUT
// probe per window resolving up to TWO coefficients (pair extension;
// singles are pairs writing a benign zero, removing the unpredictable
// pair-vs-single branch), one subtract of the bit count.  Error codes
// and failing positions match the careful path exactly; bits consumed
// past an error are unobservable because decode aborts.
inline int32_t decode_block_fast(FastState& fs, int16_t* out,
                                 const HuffTable& dc, const FastDc* fdc,
                                 const HuffTable& ac, const FastAc* fac,
                                 int32_t* dc_pred) {
  fs.refill();
  const FastDc d = fdc[fs.peek12()];
  if (d.bits) {
    fs.consume(d.bits);
    *dc_pred = wrap_add32(*dc_pred, d.value);
  } else {
    int32_t t;
    int32_t rc = decode_symbol_fs(fs, dc, &t);
    if (rc != OK) return rc;
    if (t > 11) return ERR_BAD_DC_SIZE;
    // <= 16 bits consumed since refill, so >= 40 remain: no refill needed.
    *dc_pred = wrap_add32(*dc_pred, extend_signed(fs.take(t), t));
  }
  out[0] = static_cast<int16_t>(*dc_pred);

  int32_t k = 1;
  while (k < 64) {
    fs.refill();
    // Three probe-steps per refill: each consumes <= 12 bits (pair
    // included), so 36 worst-case, and the slow path (entered with at
    // most two completed steps = 24 bits behind it) needs <= 26 more
    // (24 + 26 = 50 <= 56).  The body is inlined with goto-structured
    // cold paths so `k` and the cursor stay in registers with no
    // status-code plumbing on the hot path.
    for (int probes = 0; probes < 3; ++probes) {
      const FastAc fa = fac[fs.peek12()];
      if (__builtin_expect(static_cast<uint32_t>(fa.run) > 15u, 0)) {
        if (fa.run < 0) goto slow;  // long code / wide magnitude
        fs.consume(fa.packed & 0x0F);
        if (fa.run == 17) return OK;  // EOB
        k += 16;                      // ZRL
        if (k >= 64) return OK;
        continue;
      }
      {
        const int32_t k1 = k + fa.run;
        if (__builtin_expect(k1 >= 63, 0)) {
          // Block-terminal (or out-of-range): a recorded pair must
          // single-ify — its second symbol belongs to the NEXT block.
          if (k1 > 63) return ERR_AC_RANGE;
          fs.consume(fa.packed & 0x0F);
          out[kZigzag[63]] = fa.value;
          return OK;
        }
        // Branchless single/pair (singles: run2enc == 0, val2 == 0,
        // bits2 == t1 — the second store writes a benign 0 at k1+1).
        fs.consume(fa.bits2);
        out[kZigzag[k1]] = fa.value;
        const int32_t r2 = fa.run2enc;
        const int32_t k2 = k1 + 1 + (r2 & 15);
        if (k2 > 63) return ERR_AC_RANGE;  // only real pairs can trigger
        out[kZigzag[k2]] = fa.val2;
        k = k2 + ((r2 >> 4) & 1);
        if (r2 & 32) return OK;  // coefficient-then-EOB pair
        if (k >= 64) return OK;
      }
    }
    continue;

  slow:
    {
      int32_t sym;
      int32_t rc = decode_symbol_fs(fs, ac, &sym);
      if (rc != OK) return rc;
      if (sym == 0x00) return OK;  // EOB
      int32_t run = sym >> 4;
      int32_t size = sym & 0x0F;
      if (size == 0) {
        if (sym != 0xF0) return ERR_BAD_AC_SYMBOL;
        k += 16;  // ZRL
        continue;
      }
      k += run;
      if (k > 63) return ERR_AC_RANGE;
      // >= 56 - 24 - 16 = 16 bits remain; the max 15-bit magnitude fits
      // with 1 bit spare (crafted tables reach size 15 -- see kBlockSlack).
      out[kZigzag[k]] =
          static_cast<int16_t>(extend_signed(fs.take(size), size));
      ++k;
    }
  }
  return OK;
}

// --- Progressive (SOF2) scan decode ----------------------------------------
// Port of codec/progressive.py (ITU-T T.81 G.2): DC first/refine, AC first
// with EOB runs, AC refinement with correction bits.  Operates on
// zigzag-order int32 coefficient planes; the Python layer owns plane
// allocation, the scan loop, and final de-zigzag assembly.

struct ProgState {
  BitReader br;
  int64_t eobrun;
  int32_t preds[3];
};

inline int32_t dc_first(ProgState& st, int32_t* block, int ci,
                        const HuffTable& dc, int al) {
  int32_t t;
  int32_t rc = decode_symbol(st.br, dc, &t);
  if (rc != OK) return rc;
  if (t > 11) return ERR_BAD_DC_SIZE;
  int32_t diff = extend_signed(st.br.read_bits(t), t);
  if (st.br.exhausted()) return ERR_OUT_OF_DATA;
  st.preds[ci] = wrap_add32(st.preds[ci], diff);
  block[0] = shl32(st.preds[ci], al);
  return OK;
}

inline int32_t dc_refine(ProgState& st, int32_t* block, int al) {
  if (st.br.read_bits(1)) block[0] |= 1 << al;
  if (st.br.exhausted()) return ERR_OUT_OF_DATA;
  return OK;
}

inline int32_t ac_first(ProgState& st, int32_t* block, uint64_t* nzp,
                        const HuffTable& ac, const FastAc* fast, int ss,
                        int se, int al) {
  if (st.eobrun > 0) {
    --st.eobrun;
    return OK;
  }
  int k = ss;
  while (k <= se) {
    // Fast path: coefficient and ZRL codes resolve in one table read
    // (EOB/EOBn stay on the slow path: they carry run-length bits).
    // Error precedence matches the slow path exactly.
    const FastAc fa = fast[st.br.peek16() >> 4];
    if (fa.run >= 0 && fa.run <= 16) {
      st.br.drop(fa.packed >> 4);
      if (st.br.exhausted()) return ERR_OUT_OF_DATA;
      if (fa.run == 16) {
        k += 16;  // ZRL
      } else {
        k += fa.run;
        if (k > se) return ERR_AC_RANGE;
        st.br.drop((fa.packed & 0x0F) - (fa.packed >> 4));
        if (st.br.exhausted()) return ERR_OUT_OF_DATA;
        block[k] = shl32(fa.value, al);
        *nzp |= 1ull << k;
        ++k;
      }
      continue;
    }
    int32_t sym;
    int32_t rc = decode_symbol(st.br, ac, &sym);
    if (rc != OK) return rc;
    int r = sym >> 4;
    int s = sym & 0x0F;
    if (s == 0) {
      if (r != 15) {
        st.eobrun = (1 << r) - 1;
        if (r) st.eobrun += st.br.read_bits(r);
        if (st.br.exhausted()) return ERR_OUT_OF_DATA;
        return OK;
      }
      k += 16;  // ZRL
      continue;
    }
    k += r;
    if (k > se) return ERR_AC_RANGE;
    block[k] = shl32(extend_signed(st.br.read_bits(s), s), al);
    if (st.br.exhausted()) return ERR_OUT_OF_DATA;
    *nzp |= 1ull << k;
    ++k;
  }
  return OK;
}

inline int32_t ac_refine(ProgState& st, int32_t* block, uint64_t* nzp,
                         const HuffTable& ac, int ss, int se, int al) {
  const int32_t p1 = 1 << al;
  const int32_t m1 = shl32(-1, al);
  int k = ss;

  if (st.eobrun == 0) {
    while (k <= se) {
      int32_t sym;
      int32_t rc = decode_symbol(st.br, ac, &sym);
      if (rc != OK) return rc;
      int r = sym >> 4;
      int s = sym & 0x0F;
      int32_t newval = 0;
      if (s == 0) {
        if (r != 15) {
          // EOB run INCLUDES this block (remaining nonzeros still take
          // correction bits below; the tail decrements the run).
          st.eobrun = 1 << r;
          if (r) st.eobrun += st.br.read_bits(r);
          if (st.br.exhausted()) return ERR_OUT_OF_DATA;
          break;
        }
        // ZRL: skip 16 zero-history positions.
      } else {
        if (s != 1) return ERR_BAD_AC_SYMBOL;
        newval = st.br.read_bits(1) ? p1 : m1;
      }
      while (k <= se) {
        if (block[k] != 0) {
          if (st.br.read_bits(1) && (block[k] & p1) == 0) {
            block[k] += block[k] >= 0 ? p1 : m1;
          }
        } else {
          if (r == 0) break;
          --r;
        }
        if (st.br.exhausted()) return ERR_OUT_OF_DATA;
        ++k;
      }
      if (newval && k <= se) {
        block[k] = newval;
        *nzp |= 1ull << k;
      }
      ++k;
    }
  }

  if (st.eobrun > 0) {
    while (k <= se) {
      if (block[k] != 0) {
        if (st.br.read_bits(1) && (block[k] & p1) == 0) {
          block[k] += block[k] >= 0 ? p1 : m1;
        }
        if (st.br.exhausted()) return ERR_OUT_OF_DATA;
      }
      ++k;
    }
    --st.eobrun;
  }
  return OK;
}

// --- Progressive fast-path variants ----------------------------------------
// FastState versions of the four phase procedures, used while the per-run
// byte-slack guard holds (no exhaustion/overrun possible).  Bit-identical
// to the ProgState versions above; the careful versions finish each
// restart run's tail so end-of-stream accounting matches the oracle.

inline int32_t dc_first_fs(FastState& fs, int32_t* block, int ci,
                           const HuffTable& dc, const FastDc* fdc, int al,
                           int32_t* preds) {
  fs.refill();
  const FastDc d = fdc[fs.peek12()];
  int32_t diff;
  if (d.bits) {
    fs.consume(d.bits);
    diff = d.value;
  } else {
    int32_t t;
    int32_t rc = decode_symbol_fs(fs, dc, &t);
    if (rc != OK) return rc;
    if (t > 11) return ERR_BAD_DC_SIZE;
    diff = extend_signed(fs.take(t), t);
  }
  preds[ci] = wrap_add32(preds[ci], diff);
  block[0] = shl32(preds[ci], al);
  return OK;
}

inline int32_t dc_refine_fs(FastState& fs, int32_t* block, int al) {
  fs.refill();
  if (fs.take(1)) block[0] |= 1 << al;
  return OK;
}

// AC-first: pairs stay behind explicit branches here (no benign-zero
// trick): a malformed stream can re-send a band, leaving nonzero history
// at positions a run skips, which a blind zero store would clobber.
inline int32_t ac_first_fs(FastState& fs, int32_t* block, uint64_t* nzp,
                           const HuffTable& ac, const FastAc* fac, int ss,
                           int se, int al, int64_t* eobrun) {
  if (*eobrun > 0) {
    --*eobrun;
    return OK;
  }
  int32_t k = ss;
  uint64_t nz = *nzp;
  while (k <= se) {
    fs.refill();
    const FastAc fa = fac[fs.peek12()];
    if (fa.run < 0) {
      // Slow: long code, wide magnitude, or EOBn (run-length bits).
      int32_t sym;
      int32_t rc = decode_symbol_fs(fs, ac, &sym);
      if (rc != OK) { *nzp = nz; return rc; }
      int r = sym >> 4;
      int s = sym & 0x0F;
      if (s == 0) {
        if (r != 15) {
          *eobrun = (1 << r) - 1;
          if (r) *eobrun += fs.take(r);
          *nzp = nz;
          return OK;
        }
        k += 16;  // ZRL
        continue;
      }
      k += r;
      if (k > se) { *nzp = nz; return ERR_AC_RANGE; }
      block[k] = shl32(extend_signed(fs.take(s), s), al);
      nz |= 1ull << k;
      ++k;
      continue;
    }
    if (fa.run >= 16) {
      fs.consume(fa.packed & 0x0F);
      if (fa.run == 17) { *nzp = nz; return OK; }  // EOB0 (eobrun stays 0)
      k += 16;                                     // ZRL
      continue;
    }
    const int32_t k1 = k + fa.run;
    if (k1 > se) { *nzp = nz; return ERR_AC_RANGE; }
    if ((fa.run2enc & 16) && k1 < se) {  // coefficient pair, non-terminal
      fs.consume(fa.bits2);
      block[k1] = shl32(fa.value, al);
      const int32_t k2 = k1 + 1 + (fa.run2enc & 15);
      if (k2 > se) { *nzp = nz | (1ull << k1); return ERR_AC_RANGE; }
      block[k2] = shl32(fa.val2, al);
      nz |= (1ull << k1) | (1ull << k2);
      k = k2 + 1;
    } else if ((fa.run2enc & 32) && k1 < se) {  // coefficient then EOB0
      fs.consume(fa.bits2);
      block[k1] = shl32(fa.value, al);
      *nzp = nz | (1ull << k1);
      return OK;
    } else {
      fs.consume(fa.packed & 0x0F);
      block[k1] = shl32(fa.value, al);
      nz |= 1ull << k1;
      k = k1 + 1;
    }
  }
  *nzp = nz;
  return OK;
}

inline int32_t ac_refine_fs(FastState& fs, int32_t* block, uint64_t* nzp,
                            const HuffTable& ac, const FastAc* fac, int ss,
                            int se, int al, int64_t* eobrun) {
  const int32_t p1 = 1 << al;
  const int32_t m1 = shl32(-1, al);
  int32_t k = ss;

  // Nonzero-history bitmap (bit j = block[j] != 0): maintained
  // PERSISTENTLY across scans by every writer (ac_first/ac_refine fast +
  // careful variants), so refinement never touches the 256-byte block to
  // discover its nonzero set — an EOB-covered block with no in-band
  // nonzeros costs one 8-byte read.  Refinement only reads correction
  // bits AT nonzero positions and counts runs over zero positions, so
  // the zero-position walk collapses into bit ops; corrections keep
  // positions nonzero, and the only mask mutation is the newval insert.
  uint64_t nz = *nzp;

  // Correction bits for the ascending run of nonzero positions in
  // `corr`: read ALL of them in one batched take (one refill covers
  // >= 56 bits; a 64-spectral band can carry up to 62 in-band nonzeros,
  // so chunk by 32) and apply top-aligned bit j to the j-th position —
  // identical consumption order to the per-bit sequential walk.
  auto correct_run = [&](uint64_t corr) {
    while (corr) {
      const int n = __builtin_popcountll(corr);
      const int take_n = n > 32 ? 32 : n;
      fs.refill();
      const uint32_t v = fs.take(take_n);
      for (int j = take_n - 1; j >= 0; --j) {
        const int i = __builtin_ctzll(corr);
        corr &= corr - 1;
        // Branchless apply: correction bits are ~random, so the naive
        // `if (bit && !(block[i] & p1))` mispredicts about every other
        // coefficient — the measured hot cost of refinement scans.
        //   apply = bit & ~already_refined_at_this_level
        //   delta = +p1 for positive history, -p1 (== m1) for negative
        const int32_t b = block[i];
        const uint32_t apply =
            (v >> j) & ~(static_cast<uint32_t>(b) >> al) & 1u;
        const int32_t delta =
            p1 - ((b >> 31) & (2 * p1));  // b<0 -> -p1, else +p1
        block[i] = b + static_cast<int32_t>(apply) * delta;
      }
    }
  };
  auto range_mask = [&](int lo) -> uint64_t {
    return (~0ull >> (63 - se)) & ~((1ull << lo) - 1ull);
  };

  if (*eobrun == 0) {
    while (k <= se) {
      fs.refill();
      int32_t r;
      int32_t newval = 0;
      const FastAc fa = fac[fs.peek12()];
      if (fa.run >= 0) {
        const int32_t cl = fa.packed >> 4;
        const int32_t tot = fa.packed & 0x0F;
        if (fa.run == 17) {  // EOB0: run includes this block
          fs.consume(tot);
          *eobrun = 1;
          break;
        }
        if (fa.run == 16) {  // ZRL: skip 16 zero-history positions
          fs.consume(tot);
          r = 15;
        } else {
          fs.consume(tot);
          if (tot - cl != 1) { *nzp = nz; return ERR_BAD_AC_SYMBOL; }
          r = fa.run;
          newval = fa.value > 0 ? p1 : m1;
        }
      } else {
        int32_t sym;
        int32_t rc = decode_symbol_fs(fs, ac, &sym);
        if (rc != OK) { *nzp = nz; return rc; }
        r = sym >> 4;
        int s = sym & 0x0F;
        if (s == 0) {
          if (r != 15) {
            *eobrun = 1 << r;
            if (r) *eobrun += fs.take(r);
            break;
          }
          newval = 0;  // ZRL
        } else {
          if (s != 1) { *nzp = nz; return ERR_BAD_AC_SYMBOL; }
          newval = fs.take(1) ? p1 : m1;
        }
      }
      // Advance to the (r+1)-th zero-history position >= k (or past se),
      // reading correction bits — in ascending order — at every nonzero
      // position passed.  Equivalent to the sequential walk in ac_refine.
      {
        const uint64_t range = range_mask(k);
        const uint64_t zmask = ~nz & range;
#if defined(__BMI2__)
        const uint64_t nth = _pdep_u64(1ull << r, zmask);
#else
        uint64_t tmp = zmask;
        for (int drop = 0; drop < r && tmp; ++drop) tmp &= tmp - 1;
        const uint64_t nth = tmp & (~tmp + 1);  // lowest remaining set bit
#endif
        const int target = nth ? __builtin_ctzll(nth) : se + 1;
        correct_run(nz & range & (nth ? nth - 1 : ~0ull));
        k = target;
      }
      if (newval && k <= se) {
        block[k] = newval;
        nz |= 1ull << k;
      }
      ++k;
    }
  }

  if (*eobrun > 0) {
    if (k <= se) correct_run(nz & range_mask(k));
    --*eobrun;
  }
  *nzp = nz;
  return OK;
}

// Total blocks across the concatenated (MCU-padded) component planes —
// the size of the persistent nonzero-bitmap array that parallels them.
inline int64_t total_plane_blocks(const int64_t* comp_offset,
                                  const int32_t* comp_bwp,
                                  const int32_t* comp_v, int32_t mcu_rows) {
  int64_t total = 0;
  for (int ci = 0; ci < 3; ++ci) {
    if (comp_bwp[ci] <= 0) continue;
    const int64_t end = comp_offset[ci] / 64 +
        static_cast<int64_t>(comp_bwp[ci]) * mcu_rows * comp_v[ci];
    if (end > total) total = end;
  }
  return total;
}

// Rebuild the bitmaps from plane contents (the per-scan reference entry
// can be handed partially-decoded planes; the image-level entry keeps the
// map incrementally instead).
inline void build_nzmap(const int32_t* planes, int64_t total_blocks,
                        uint64_t* nzmap) {
  for (int64_t b = 0; b < total_blocks; ++b) {
    const int32_t* block = planes + b * 64;
    uint64_t nz = 0;
#if defined(__AVX2__)
    const __m256i zero = _mm256_setzero_si256();
    for (int j = 0; j < 64; j += 8) {
      const __m256i a =
          _mm256_loadu_si256(reinterpret_cast<const __m256i*>(block + j));
      const uint32_t eq = static_cast<uint32_t>(
          _mm256_movemask_ps(_mm256_castsi256_ps(
              _mm256_cmpeq_epi32(a, zero))));
      nz |= static_cast<uint64_t>(~eq & 0xFFu) << j;
    }
#else
    for (int j = 0; j < 64; ++j) {
      nz |= static_cast<uint64_t>(block[j] != 0) << j;
    }
#endif
    nzmap[b] = nz;
  }
}

}  // namespace

// Decode ONE progressive scan into zigzag-order int32 coefficient planes.
//
//   planes                concatenated per-component planes, each
//                         [bhp, bwp, 64] int32 (MCU-padded)
//   comp_offset[3]        start offset (in int32 units) of each plane
//   comp_bwp[3]           padded blocks-wide of each plane
//   interleaved           1 = MCU walk over the padded grid (DC bands),
//                         0 = raster over the single component's unpadded
//                             block grid (bw x bh)
//   slots: for interleaved walks, slot_ci/slot_qv/slot_qh arrays [g'];
//          sampling v/h per component in comp_v/comp_h.
//   Tables: per scan-component snapshot DHT definitions.
//   comp_mask: bit ci set = component ci's blocks are WRITTEN.  Interleaved
//   scans always decode every slot's bits (the stream is shared) but
//   masked-out slots store into a discard block — the mechanism behind
//   component-partitioned parallel scan chains (binding.py fans the 2-3
//   per-component chains of a progressive scan script across cores; each
//   chain re-decodes the small interleaved DC scans and owns its
//   component's planes exclusively).  Non-interleaved scans of masked-out
//   components must be skipped by the CALLER (scans are independent
//   bitstream segments, so skipping is free).
//
// Returns OK or a negative ErrorCode; *err_unit is the failing MCU/block.
static int32_t decode_progressive_scan_impl(
    const uint8_t* data, int64_t data_len,
    const int64_t* seg_offsets, int32_t num_segs, int32_t restart_interval,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    int32_t interleaved,
    int32_t mcu_rows, int32_t mcu_cols,
    int32_t nslots, const int32_t* slot_scomp, const int32_t* slot_ci,
    const int32_t* slot_qv, const int32_t* slot_qh,
    const int32_t* comp_v, const int32_t* comp_h,
    int32_t bw, int32_t bh,            // non-interleaved block grid
    int32_t nc,                        // scan component count
    const uint8_t* dc_counts, const uint8_t* dc_symbols,   // [nc][16]/[162]
    const uint8_t* ac_counts, const uint8_t* ac_symbols,
    int32_t* planes, const int64_t* comp_offset, const int32_t* comp_bwp,
    uint64_t* nzmap,                   // [total_blocks] nonzero bitmaps
    int32_t comp_mask,
    int32_t* err_unit) {
  if (nc < 1 || nc > 3 || nslots < 0 || nslots > 10) return ERR_BAD_ARGS;

  static thread_local HuffTable dc_tabs[3];
  static thread_local HuffTable ac_tabs[3];
  static thread_local FastAc fast_tabs[3][4096];
  static thread_local FastDc fast_dc_tabs[3][4096];
  static thread_local TableKey dc_keys[3], ac_keys[3];
  for (int i = 0; i < nc; ++i) {
    // Content-keyed rebuild skip: successive scans of a progressive image
    // almost always reuse the tables of the previous scan at this slot
    // (files define each DHT once).  On a miss, build ALL structures for
    // the slot — zero-count tables yield all-slow entries, so building
    // the fast tables unconditionally is correct and keeps the invariant
    // "key valid => every structure matches the key".
    if (!dc_keys[i].check(dc_counts + i * 16, dc_symbols + i * 162)) {
      if (!build_table(dc_counts + i * 16, dc_symbols + i * 162,
                       &dc_tabs[i])) {
        dc_keys[i].valid = false;
        return ERR_BAD_ARGS;
      }
      build_fast_dc(dc_counts + i * 16, dc_symbols + i * 162,
                    fast_dc_tabs[i]);
    }
    if (!ac_keys[i].check(ac_counts + i * 16, ac_symbols + i * 162)) {
      if (!build_table(ac_counts + i * 16, ac_symbols + i * 162,
                       &ac_tabs[i])) {
        ac_keys[i].valid = false;
        return ERR_BAD_ARGS;
      }
      build_fast_ac(ac_counts + i * 16, ac_symbols + i * 162, fast_tabs[i]);
    }
  }

  // Per-restart-run two-phase walk: the guarded FastState path decodes
  // units while worst-case slack remains, then the careful ProgState path
  // finishes the run's tail (with eobrun/preds handed off mid-run; restart
  // boundaries reset all decoder state anyway).
  const int64_t total_units =
      interleaved ? static_cast<int64_t>(mcu_rows) * mcu_cols
                  : static_cast<int64_t>(bw) * bh;
  // Worst-case bytes one unit can consume (+8 refill lookahead covered by
  // the init guard): DC first 4 B/block, DC refine 1 B/block, AC bands up
  // to a full kBlockSlack.
  int64_t unit_slack;
  if (ss == 0) {
    unit_slack = (ah == 0 ? 4 : 1) * (interleaved ? nslots : 1) + 16;
  } else {
    unit_slack = kBlockSlack;
  }

  int64_t u = 0;
  int32_t seg = 0;
  int64_t bitpos = (num_segs > 0 ? seg_offsets[0] : 0) * 8;
  int64_t eobrun = 0;
  int32_t preds[3] = {0, 0, 0};

  // Discard target for masked-out interleaved slots: bits are consumed
  // identically (stream position and DC predictors must track), stores
  // land here and are never read back.
  static thread_local int32_t discard_block[64];

  auto unit_block = [&](int64_t unit) -> int32_t* {
    if (interleaved) return nullptr;  // interleaved resolves per slot
    const int64_t by = unit / bw;
    const int64_t bx = unit % bw;
    return planes + comp_offset[slot_ci[0]] +
           (by * comp_bwp[slot_ci[0]] + bx) * 64;
  };

  while (u < total_units) {
    if (restart_interval && u && u % restart_interval == 0) {
      ++seg;
      if (seg >= num_segs) {
        *err_unit = static_cast<int32_t>(u);
        return ERR_MISSING_SEGMENT;
      }
      bitpos = seg_offsets[seg] * 8;
      eobrun = 0;
      preds[0] = preds[1] = preds[2] = 0;
    }
    int64_t run_end = total_units;
    if (restart_interval) {
      const int64_t next = (u / restart_interval + 1) * restart_interval;
      if (next < run_end) run_end = next;
    }

    // Fast phase (incremental row/col walkers: no per-unit div/mod).
    if (u < run_end && (bitpos >> 3) + 8 + unit_slack <= data_len) {
      FastState fs;
      fs.init(data, bitpos);
      if (interleaved) {
        int64_t my = u / mcu_cols;
        int64_t mx = u % mcu_cols;
        int32_t* row_base[10];
        int64_t col_step[10];
        auto sync_rows = [&]() {
          for (int s = 0; s < nslots; ++s) {
            const int ci = slot_ci[s];
            if (!((comp_mask >> ci) & 1)) {
              row_base[s] = discard_block;
              col_step[s] = 0;
              continue;
            }
            row_base[s] = planes + comp_offset[ci] +
                          ((my * comp_v[ci] + slot_qv[s]) * comp_bwp[ci] +
                           slot_qh[s]) * 64;
            col_step[s] = static_cast<int64_t>(comp_h[ci]) * 64;
          }
        };
        sync_rows();
        while (u < run_end && fs.pos + unit_slack <= data_len) {
          if (ah != 0) {
            // DC refinement: one bit per slot — take the whole MCU's
            // bits in one refill (first slot = first-taken bit = MSB).
            fs.refill();
            const uint32_t v = fs.take(nslots);
            for (int s = 0; s < nslots; ++s) {
              if ((v >> (nslots - 1 - s)) & 1) {
                (row_base[s] + mx * col_step[s])[0] |= 1 << al;
              }
            }
          } else {
            int32_t rc = OK;
            for (int s = 0; s < nslots && rc == OK; ++s) {
              int32_t* block = row_base[s] + mx * col_step[s];
              rc = dc_first_fs(fs, block, slot_ci[s],
                               dc_tabs[slot_scomp[s]],
                               fast_dc_tabs[slot_scomp[s]], al, preds);
            }
            if (rc != OK) {
              *err_unit = static_cast<int32_t>(u);
              return rc;
            }
          }
          ++u;
          if (++mx == mcu_cols) {
            mx = 0;
            ++my;
            sync_rows();
          }
        }
      } else {
        const int ci0 = slot_ci[0];
        int64_t by = u / bw;
        int64_t bx = u % bw;
        const int64_t row_pad = (static_cast<int64_t>(comp_bwp[ci0]) - bw)
                                * 64;
        int32_t* block = planes + comp_offset[ci0] +
                         (by * comp_bwp[ci0] + bx) * 64;
        uint64_t* nzb = nzmap + comp_offset[ci0] / 64 +
                        by * comp_bwp[ci0] + bx;
        while (u < run_end && fs.pos + unit_slack <= data_len) {
          int32_t rc;
          if (ss == 0) {
            rc = ah == 0 ? dc_first_fs(fs, block, ci0, dc_tabs[0],
                                       fast_dc_tabs[0], al, preds)
                         : dc_refine_fs(fs, block, al);
          } else {
            rc = ah == 0 ? ac_first_fs(fs, block, nzb, ac_tabs[0],
                                       fast_tabs[0], ss, se, al, &eobrun)
                         : ac_refine_fs(fs, block, nzb, ac_tabs[0],
                                        fast_tabs[0], ss, se, al, &eobrun);
          }
          if (rc != OK) {
            *err_unit = static_cast<int32_t>(u);
            return rc;
          }
          ++u;
          block += 64;
          ++nzb;
          if (++bx == bw) {
            bx = 0;
            ++by;
            block += row_pad;
            nzb += row_pad / 64;
          }
          // AC-first EOB runs are pure skips (no bits consumed, no
          // coefficients touched — unlike refinement, which reads
          // correction bits per covered block), so fast-forward the whole
          // run instead of decrementing block by block.  Capped at
          // run_end: eobrun resets at restart boundaries, identical to
          // the per-block walk.
          if (eobrun > 0 && ss != 0 && ah == 0) {
            int64_t skip = eobrun < run_end - u ? eobrun : run_end - u;
            if (skip > 0) {
              eobrun -= skip;
              u += skip;
              by = u / bw;
              bx = u % bw;
              block = planes + comp_offset[ci0] +
                      (by * comp_bwp[ci0] + bx) * 64;
              nzb = nzmap + comp_offset[ci0] / 64 + by * comp_bwp[ci0] +
                    bx;
            }
          } else if (eobrun > 0 && ss != 0) {
            // Refinement EOB runs read correction bits only at in-band
            // NONZERO positions; a covered block with none consumes no
            // bits and is untouched (ac_refine_fs tail with corr == 0) —
            // skip those in bulk by scanning the bitmap array
            // (sequential 8-byte loads; chroma planes are mostly such
            // blocks at web quality).
            const uint64_t inband =
                (~0ull >> (63 - se)) & ~((1ull << ss) - 1ull);
            while (eobrun > 0 && u < run_end && !(*nzb & inband)) {
              --eobrun;
              ++u;
              block += 64;
              ++nzb;
              if (++bx == bw) {
                bx = 0;
                ++by;
                block += row_pad;
                nzb += row_pad / 64;
              }
            }
          }
        }
      }
      bitpos = fs.bit_position();
    }

    // Careful phase: finish the run's tail with the exhaustion-tracking
    // reader (state handed off; nothing to hand back — the next run
    // starts at a restart boundary which resets everything).
    if (u < run_end) {
      ProgState st{{data, data_len, 0, 0, 0, 0},
                   eobrun,
                   {preds[0], preds[1], preds[2]}};
      st.br.seek(bitpos >> 3);
      if (bitpos & 7) {
        st.br.fill();
        st.br.drop(static_cast<int32_t>(bitpos & 7));
      }
      for (; u < run_end; ++u) {
        int32_t rc = OK;
        if (interleaved) {
          const int64_t my = u / mcu_cols;
          const int64_t mx = u % mcu_cols;
          for (int s = 0; s < nslots && rc == OK; ++s) {
            const int i = slot_scomp[s];
            const int ci = slot_ci[s];
            int32_t* block =
                ((comp_mask >> ci) & 1)
                    ? planes + comp_offset[ci] +
                          (((my * comp_v[ci] + slot_qv[s]) * comp_bwp[ci]) +
                           (mx * comp_h[ci] + slot_qh[s])) * 64
                    : discard_block;
            rc = ah == 0 ? dc_first(st, block, ci, dc_tabs[i], al)
                         : dc_refine(st, block, al);
          }
        } else {
          int32_t* block = unit_block(u);
          uint64_t* nzb = nzmap + (block - planes) / 64;
          if (ss == 0) {
            rc = ah == 0 ? dc_first(st, block, slot_ci[0], dc_tabs[0], al)
                         : dc_refine(st, block, al);
          } else if (ah == 0) {
            rc = ac_first(st, block, nzb, ac_tabs[0], fast_tabs[0], ss,
                          se, al);
          } else {
            // Same no-in-band-nonzeros EOB shortcut as the fast loop
            // (consumes no bits, touches nothing — bypasses the call).
            if (st.eobrun > 0 &&
                !(*nzb & ((~0ull >> (63 - se)) & ~((1ull << ss) - 1ull)))) {
              --st.eobrun;
              continue;
            }
            rc = ac_refine(st, block, nzb, ac_tabs[0], ss, se, al);
          }
        }
        if (rc != OK) {
          *err_unit = static_cast<int32_t>(u);
          return rc;
        }
      }
    }
  }
  return OK;
}

extern "C" {

// Per-scan export (semantic reference unit; the image-level entry below is
// the production path — one ctypes call per image instead of per scan).
int32_t pjt_decode_progressive_scan(
    const uint8_t* data, int64_t data_len,
    const int64_t* seg_offsets, int32_t num_segs, int32_t restart_interval,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    int32_t interleaved,
    int32_t mcu_rows, int32_t mcu_cols,
    int32_t nslots, const int32_t* slot_scomp, const int32_t* slot_ci,
    const int32_t* slot_qv, const int32_t* slot_qh,
    const int32_t* comp_v, const int32_t* comp_h,
    int32_t bw, int32_t bh,
    int32_t nc,
    const uint8_t* dc_counts, const uint8_t* dc_symbols,
    const uint8_t* ac_counts, const uint8_t* ac_symbols,
    int32_t* planes, const int64_t* comp_offset, const int32_t* comp_bwp,
    int32_t* err_unit) {
  // The reference entry may be handed partially-decoded planes, so the
  // nonzero bitmaps are rebuilt from plane contents here; the image-level
  // entry below maintains them incrementally across scans instead.
  const int64_t total_blocks =
      total_plane_blocks(comp_offset, comp_bwp, comp_v, mcu_rows);
  std::vector<uint64_t> nzmap(static_cast<size_t>(total_blocks));
  build_nzmap(planes, total_blocks, nzmap.data());
  return decode_progressive_scan_impl(
      data, data_len, seg_offsets, num_segs, restart_interval, ss, se, ah,
      al, interleaved, mcu_rows, mcu_cols, nslots, slot_scomp, slot_ci,
      slot_qv, slot_qh, comp_v, comp_h, bw, bh, nc, dc_counts, dc_symbols,
      ac_counts, ac_symbols, planes, comp_offset, comp_bwp, nzmap.data(),
      /*comp_mask=*/0x7, err_unit);
}

// Decode ALL scans of a progressive image in one call (binding.py stages
// every per-scan parameter as flat concatenated arrays; this removes the
// per-scan Python staging + ctypes dispatch that dominated the progressive
// wall clock).  Layouts:
//   scan_i32     [nscans, 10]: ss, se, ah, al, interleaved, restart_interval,
//                nslots, nc, bw, bh
//   scan_data    [nscans, 2] int64: (offset, length) into `data`
//   seg_idx      [nscans + 1] int64: per-scan slice of seg_offsets_all
//   slots_all    [nscans, 10, 4] int32: (scomp, ci, qv, qh)
//   dc/ac tables [nscans * 3][16] / [162] uint8
//   comp_mask    bit ci set = write component ci (see
//                decode_progressive_scan_impl; non-interleaved scans of
//                masked-out components are SKIPPED here — free, each scan
//                is its own bitstream segment).  0x7 = full decode.
//   scan_seconds optional [nscans] double: per-scan wall seconds
//                (nullptr = no timing) — the per-scan-type accounting
//                behind tools/prog_profile.py.
// On error *err_scan / *err_unit report the failing scan and unit.
int32_t pjt_decode_progressive_image(
    const uint8_t* data, int64_t data_len,
    int32_t nscans,
    const int64_t* scan_data, const int64_t* seg_offsets_all,
    const int64_t* seg_idx,
    const int32_t* scan_i32, const int32_t* slots_all,
    const int32_t* comp_v, const int32_t* comp_h,
    int32_t mcu_rows, int32_t mcu_cols,
    const uint8_t* dc_counts_all, const uint8_t* dc_symbols_all,
    const uint8_t* ac_counts_all, const uint8_t* ac_symbols_all,
    int32_t* planes, const int64_t* comp_offset, const int32_t* comp_bwp,
    int32_t comp_mask, double* scan_seconds,
    int32_t* err_scan, int32_t* err_unit) {
  if (nscans < 1) return ERR_BAD_ARGS;
  // Persistent nonzero bitmaps: planes arrive zeroed (binding.py
  // allocates them fresh per image), so all-zero maps are correct, and
  // every coefficient writer maintains them across the scan loop.
  const int64_t total_blocks =
      total_plane_blocks(comp_offset, comp_bwp, comp_v, mcu_rows);
  std::vector<uint64_t> nzmap(static_cast<size_t>(total_blocks), 0);
  for (int32_t sc = 0; sc < nscans; ++sc) {
    const int32_t* p = scan_i32 + sc * 10;
    const int64_t off = scan_data[sc * 2];
    const int64_t len = scan_data[sc * 2 + 1];
    if (off < 0 || len < 0 || off + len > data_len) return ERR_BAD_ARGS;
    int32_t slot_scomp[10], slot_ci[10], slot_qv[10], slot_qh[10];
    const int32_t nslots = p[6];
    if (nslots < 0 || nslots > 10) return ERR_BAD_ARGS;
    for (int s = 0; s < nslots; ++s) {
      const int32_t* sl = slots_all + (sc * 10 + s) * 4;
      slot_scomp[s] = sl[0];
      slot_ci[s] = sl[1];
      slot_qv[s] = sl[2];
      slot_qh[s] = sl[3];
    }
    if (scan_seconds) scan_seconds[sc] = 0.0;
    // Chain partitioning: a non-interleaved scan touches exactly one
    // component; when it is masked out, this chain skips the whole scan.
    if (!p[4] && nslots >= 1 && !((comp_mask >> slot_ci[0]) & 1)) continue;
    const int32_t num_segs = static_cast<int32_t>(seg_idx[sc + 1] -
                                                  seg_idx[sc]);
    struct timespec t0, t1;
    if (scan_seconds) clock_gettime(CLOCK_MONOTONIC, &t0);
    int32_t rc = decode_progressive_scan_impl(
        data + off, len, seg_offsets_all + seg_idx[sc], num_segs,
        /*restart_interval=*/p[5], /*ss=*/p[0], /*se=*/p[1], /*ah=*/p[2],
        /*al=*/p[3], /*interleaved=*/p[4], mcu_rows, mcu_cols, nslots,
        slot_scomp, slot_ci, slot_qv, slot_qh, comp_v, comp_h,
        /*bw=*/p[8], /*bh=*/p[9], /*nc=*/p[7],
        dc_counts_all + sc * 3 * 16, dc_symbols_all + sc * 3 * 162,
        ac_counts_all + sc * 3 * 16, ac_symbols_all + sc * 3 * 162,
        planes, comp_offset, comp_bwp, nzmap.data(), comp_mask, err_unit);
    if (scan_seconds) {
      clock_gettime(CLOCK_MONOTONIC, &t1);
      scan_seconds[sc] = (t1.tv_sec - t0.tv_sec) +
                         (t1.tv_nsec - t0.tv_nsec) * 1e-9;
    }
    if (rc != OK) {
      *err_scan = sc;
      return rc;
    }
  }
  return OK;
}

namespace {
// Inverse zigzag: natural position p holds zigzag index kUnzig[p]
// (kZigzag[kUnzig[p]] == p) — lets the transport assembly write
// SEQUENTIALLY and gather from the plane, which vectorizes.
struct UnzigTable {
  alignas(32) int32_t idx[64];
  UnzigTable() {
    for (int j = 0; j < 64; ++j) idx[kZigzag[j]] = j;
  }
};
const UnzigTable kUnzig;

inline void assemble_block(const int32_t* block, int16_t* slot_out) {
#if defined(__AVX2__)
  // 16 coefficients per step: two 8-wide gathers through the inverse
  // permutation, one saturating int32->int16 pack (the exact clamp the
  // scalar path applies), lane fix, sequential store.
  for (int p = 0; p < 64; p += 16) {
    const __m256i i0 = _mm256_load_si256(
        reinterpret_cast<const __m256i*>(kUnzig.idx + p));
    const __m256i i1 = _mm256_load_si256(
        reinterpret_cast<const __m256i*>(kUnzig.idx + p + 8));
    const __m256i a = _mm256_i32gather_epi32(block, i0, 4);
    const __m256i b = _mm256_i32gather_epi32(block, i1, 4);
    const __m256i s = _mm256_permute4x64_epi64(
        _mm256_packs_epi32(a, b), 0xD8);
    _mm256_storeu_si256(reinterpret_cast<__m256i*>(slot_out + p), s);
  }
#else
  for (int p = 0; p < 64; ++p) {
    int32_t v = block[kUnzig.idx[p]];
    v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
    slot_out[p] = static_cast<int16_t>(v);
  }
#endif
}
}  // namespace

// Assemble the [num_mcus, g, 64] int16 natural-order transport from the
// zigzag-order coefficient planes (de-zigzag + int16 saturation + slot
// gather) — the C++ equivalent of the NumPy fancy-index assembly in
// codec/progressive.py, ~10x faster on the q75 corpus.
int32_t pjt_progressive_assemble(
    const int32_t* planes, const int64_t* comp_offset,
    const int32_t* comp_bwp,
    int32_t num_mcus, int32_t mcu_cols, int32_t g,
    const int32_t* slot_ci, const int32_t* slot_qv, const int32_t* slot_qh,
    const int32_t* comp_v, const int32_t* comp_h,
    int16_t* out) {
  if (g <= 0 || g > 10 || mcu_cols <= 0) return ERR_BAD_ARGS;
  for (int64_t m = 0; m < num_mcus; ++m) {
    const int64_t my = m / mcu_cols;
    const int64_t mx = m % mcu_cols;
    int16_t* mcu_out = out + m * g * 64;
    for (int s = 0; s < g; ++s) {
      const int32_t ci = slot_ci[s];
      const int32_t* block =
          planes + comp_offset[ci] +
          (((my * comp_v[ci] + slot_qv[s]) * comp_bwp[ci]) +
           (mx * comp_h[ci] + slot_qh[s])) * 64;
      assemble_block(block, mcu_out + s * 64);
    }
  }
  return OK;
}

// Decode a RANGE of restart segments of one interleaved baseline scan.
//
// Restart segments are independent bitstream entry points (byte-aligned,
// DC predictors reset — ITU-T T.81 E.2.4), so disjoint segment ranges can
// decode concurrently into disjoint slices of `out`; binding.py fans a
// large DRI image across a thread pool this way (the segment parallelism
// the reference leaves unexploited, SURVEY.md section 2 item 4).
//
//   data / data_len       de-stuffed entropy bytes (RST markers removed)
//   seg_offsets/num_segs  byte offsets of restart-segment entry points
//   seg_begin/seg_end     segment range [begin, end) to decode
//   restart_interval      MCUs per restart segment (0 = none; then the
//                         whole scan is segment 0)
//   num_mcus              total MCUs in the scan
//   g                     8x8 block slots per MCU
//   slot_comp[g]          component index of each slot (0..2)
//   dc_counts/dc_symbols  [4][16] / [4][162] uint8 DHT definitions (DC)
//   ac_counts/ac_symbols  [4][16] / [4][162] uint8 DHT definitions (AC)
//   comp_dc_id/comp_ac_id [3] table selector per component
//   out                   [num_mcus * g * 64] int16, caller-zeroed
//
// Returns OK or a negative ErrorCode; *err_mcu reports the failing MCU.
int32_t pjt_decode_segments(
    const uint8_t* data, int64_t data_len,
    const int64_t* seg_offsets, int32_t num_segs,
    int32_t seg_begin, int32_t seg_end,
    int32_t restart_interval, int32_t num_mcus, int32_t g,
    const int32_t* slot_comp,
    const uint8_t* dc_counts, const uint8_t* dc_symbols,
    const uint8_t* ac_counts, const uint8_t* ac_symbols,
    const int32_t* comp_dc_id, const int32_t* comp_ac_id,
    int16_t* out, int32_t* err_mcu) {
  if (g <= 0 || g > 10 || num_mcus < 0 || num_segs < 1) return ERR_BAD_ARGS;
  if (seg_begin < 0 || seg_begin >= num_segs || seg_end > num_segs ||
      seg_begin >= seg_end) {
    return ERR_BAD_ARGS;
  }

  static thread_local HuffTable dc_tabs[4];
  static thread_local HuffTable ac_tabs[4];
  static thread_local FastAc fast_tabs[4][4096];
  static thread_local FastDc fast_dc_tabs[4][4096];
  static thread_local TableKey dc_keys[4], ac_keys[4];
  for (int t = 0; t < 4; ++t) {
    // Build ALL structures for a slot whenever its key misses (zero-count
    // tables correctly yield all-slow entries); a key hit means the
    // thread_local tables already hold this exact definition.
    if (!dc_keys[t].check(dc_counts + t * 16, dc_symbols + t * 162)) {
      if (!build_table(dc_counts + t * 16, dc_symbols + t * 162,
                       &dc_tabs[t])) {
        dc_keys[t].valid = false;
        return ERR_BAD_ARGS;
      }
      build_fast_dc(dc_counts + t * 16, dc_symbols + t * 162,
                    fast_dc_tabs[t]);
    }
    if (!ac_keys[t].check(ac_counts + t * 16, ac_symbols + t * 162)) {
      if (!build_table(ac_counts + t * 16, ac_symbols + t * 162,
                       &ac_tabs[t])) {
        ac_keys[t].valid = false;
        return ERR_BAD_ARGS;
      }
      build_fast_ac(ac_counts + t * 16, ac_symbols + t * 162, fast_tabs[t]);
    }
  }

  const HuffTable* slot_dc[10];
  const HuffTable* slot_ac[10];
  const FastAc* slot_fast[10];
  const FastDc* slot_fdc[10];
  int32_t slot_ci[10];
  for (int s = 0; s < g; ++s) {
    int32_t ci = slot_comp[s];
    if (ci < 0 || ci > 2) return ERR_BAD_ARGS;
    slot_ci[s] = ci;
    slot_dc[s] = &dc_tabs[comp_dc_id[ci]];
    slot_ac[s] = &ac_tabs[comp_ac_id[ci]];
    slot_fast[s] = fast_tabs[comp_ac_id[ci]];
    slot_fdc[s] = fast_dc_tabs[comp_dc_id[ci]];
  }

  const int64_t mcus_per_seg =
      restart_interval ? restart_interval : num_mcus;
  const int64_t mcu_slack = kBlockSlack * g;
  BitReader br{data, data_len, 0, 0, 0, 0};

  for (int32_t seg = seg_begin; seg < seg_end; ++seg) {
    const int64_t m_begin = seg * mcus_per_seg;
    const int64_t m_end =
        m_begin + mcus_per_seg < num_mcus ? m_begin + mcus_per_seg : num_mcus;
    int32_t dc_pred[3] = {0, 0, 0};
    int64_t bitpos = seg_offsets[seg] * 8;
    int64_t m = m_begin;

    // Fast phase: while a whole worst-case MCU plus refill lookahead fits
    // in the remaining bytes, exhaustion/overrun are impossible and the
    // branch-light cursor applies (results bit-identical to the careful
    // path below — the only differences are bookkeeping).
    if (m < m_end && (bitpos >> 3) + 8 + mcu_slack <= data_len) {
      FastState fs;
      fs.init(data, bitpos);
      while (m < m_end && fs.pos + mcu_slack <= data_len) {
        int16_t* mcu_out = out + m * g * 64;
        for (int s = 0; s < g; ++s) {
          int32_t rc = decode_block_fast(fs, mcu_out + s * 64, *slot_dc[s],
                                         slot_fdc[s], *slot_ac[s],
                                         slot_fast[s], &dc_pred[slot_ci[s]]);
          if (rc != OK) {
            *err_mcu = static_cast<int32_t>(m);
            return rc;
          }
        }
        ++m;
      }
      bitpos = fs.bit_position();
    }

    // Careful phase: stream tail (also handles entire short segments).
    if (m < m_end) {
      br.seek(bitpos >> 3);
      if (bitpos & 7) {
        br.fill();
        br.drop(static_cast<int32_t>(bitpos & 7));
      }
      for (; m < m_end; ++m) {
        int16_t* mcu_out = out + m * g * 64;
        for (int s = 0; s < g; ++s) {
          int32_t rc = decode_block(br, mcu_out + s * 64, *slot_dc[s],
                                    *slot_ac[s], slot_fast[s],
                                    &dc_pred[slot_ci[s]]);
          if (rc != OK) {
            *err_mcu = static_cast<int32_t>(m);
            return rc;
          }
        }
      }
    }
  }
  return OK;
}

// Whole-scan convenience wrapper (single-threaded path).
int32_t pjt_decode_scan(
    const uint8_t* data, int64_t data_len,
    const int64_t* seg_offsets, int32_t num_segs,
    int32_t restart_interval, int32_t num_mcus, int32_t g,
    const int32_t* slot_comp,
    const uint8_t* dc_counts, const uint8_t* dc_symbols,
    const uint8_t* ac_counts, const uint8_t* ac_symbols,
    const int32_t* comp_dc_id, const int32_t* comp_ac_id,
    int16_t* out, int32_t* err_mcu) {
  // The scan needs ceil(num_mcus / restart_interval) segments; tolerate
  // extra recorded offsets but fail early when segments are missing.
  if (restart_interval > 0) {
    int64_t needed =
        (static_cast<int64_t>(num_mcus) + restart_interval - 1) /
        restart_interval;
    if (needed > num_segs) {
      *err_mcu = static_cast<int32_t>(
          static_cast<int64_t>(num_segs) * restart_interval);
      return ERR_MISSING_SEGMENT;
    }
  }
  int32_t num_used = restart_interval
      ? static_cast<int32_t>(
            (static_cast<int64_t>(num_mcus) + restart_interval - 1) /
            restart_interval)
      : 1;
  if (num_mcus == 0) return OK;
  return pjt_decode_segments(
      data, data_len, seg_offsets, num_segs, 0, num_used,
      restart_interval, num_mcus, g, slot_comp,
      dc_counts, dc_symbols, ac_counts, ac_symbols, comp_dc_id, comp_ac_id,
      out, err_mcu);
}

// De-stuff one entropy-coded segment (native fast path for
// codec/scanner._scan_entropy; semantics mirror the reference scan,
// reference: src/jpeg_scanner.cpp:405-433): 0xFF 0x00 collapses to 0xFF,
// RST0-7 markers are removed with the de-stuffed restart offsets
// recorded, stray 0xFF fill bytes are tolerated, EOI terminates; any
// other marker terminates with stop_at_marker (multi-scan progressive)
// or is an error.
//
//   out        caller buffer, capacity >= data_len - pos
//   seg_offsets caller buffer, capacity max_segs (first entry = 0)
//   end_pos    just past EOI, or the position OF the terminating 0xFF
//              with stop_at_marker
//   term       0 = EOI consumed, 1 = stopped at marker (stop_at_marker),
//              on ERR_BAD_CODE the offending marker byte
// Returns OK, ERR_OUT_OF_DATA (truncated: *term 0 = inside data, 1 = no
// EOI), ERR_BAD_CODE (invalid marker mid-scan; *term = marker byte), or
// ERR_BAD_ARGS (segment offsets overflow — caller sized max_segs wrong).
int32_t pjt_destuff(const uint8_t* data, int64_t data_len, int64_t pos,
                    int32_t stop_at_marker,
                    uint8_t* out, int64_t* out_len,
                    int64_t* seg_offsets, int32_t max_segs,
                    int32_t* n_segs, int64_t* end_pos, int32_t* term) {
  int64_t o = 0;
  int32_t segs = 0;
  if (max_segs < 1) return ERR_BAD_ARGS;
  seg_offsets[segs++] = 0;
  int64_t p = pos;
  while (p < data_len) {
    const uint8_t b = data[p];
    if (b != 0xFF) {
      // Bulk-copy the run up to the next 0xFF (or end).
      const uint8_t* ff = static_cast<const uint8_t*>(
          memchr(data + p, 0xFF, static_cast<size_t>(data_len - p)));
      const int64_t run_end = ff ? ff - data : data_len;
      memcpy(out + o, data + p, static_cast<size_t>(run_end - p));
      o += run_end - p;
      p = run_end;
      continue;
    }
    if (p + 1 >= data_len) {
      *term = 0;
      return ERR_OUT_OF_DATA;  // 0xFF at end of buffer
    }
    const uint8_t nxt = data[p + 1];
    if (nxt == 0x00) {  // byte-stuffed 0xFF data byte
      out[o++] = 0xFF;
      p += 2;
    } else if (nxt >= 0xD0 && nxt <= 0xD7) {  // RSTn: segment boundary
      if (segs >= max_segs) return ERR_BAD_ARGS;
      seg_offsets[segs++] = o;
      p += 2;
    } else if (nxt == 0xD9) {  // EOI
      *out_len = o;
      *n_segs = segs;
      *end_pos = stop_at_marker ? p : p + 2;
      *term = stop_at_marker ? 1 : 0;
      return OK;
    } else if (nxt == 0xFF) {  // fill byte; re-examine next 0xFF
      p += 1;
    } else if (stop_at_marker) {  // next scan's marker segment
      *out_len = o;
      *n_segs = segs;
      *end_pos = p;
      *term = 1;
      return OK;
    } else {
      *term = nxt;
      return ERR_BAD_CODE;
    }
  }
  *term = 1;
  return ERR_OUT_OF_DATA;  // no EOI marker
}

// Fused int16 -> int8 coefficient-wire compaction (native fast path for
// runtime/batching.compact_wire): ONE chunked pass checks the range and
// narrows, vs NumPy's min + max + astype (three full-array passes plus
// temporaries).  Returns 1 with `out` filled when every value fits int8,
// 0 otherwise (caller keeps the int16 wire).
int32_t pjt_compact_wire(const int16_t* in, int64_t n, int8_t* out) {
  constexpr int64_t kChunk = 4096;  // L1-resident: narrow reads hot data
  for (int64_t i = 0; i < n; i += kChunk) {
    const int64_t e = i + kChunk < n ? i + kChunk : n;
    int16_t lo = 0;
    int16_t hi = 0;
    for (int64_t j = i; j < e; ++j) {  // auto-vectorizes (pminsw/pmaxsw)
      const int16_t v = in[j];
      lo = v < lo ? v : lo;
      hi = v > hi ? v : hi;
    }
    if (lo < -128 || hi > 127) return 0;
    for (int64_t j = i; j < e; ++j) {  // auto-vectorizes (packsswb-style)
      out[j] = static_cast<int8_t>(in[j]);
    }
  }
  return 1;
}

// ABI version tag so binding.py can invalidate stale cached builds.
// --- YCbCr wire transport: fused upsample + BT.601 + raster ----------------
// Consumes the device's wire-optimal output (level-shifted uint8 YCbCr
// planes in the subsampled layout, [g, 64, m_total] with the MCU axis
// minor) and produces the [height, width, 3] RGB raster.  Integer
// arithmetic is EXACTLY ops/specs.py's BT.601 spec, so the result is
// bit-identical to the fused RGB kernel path (tested).  Iteration is per
// (slot, coefficient) so every inner-loop read is a contiguous MCU run.

static const int32_t kFixCrR = 91881;    // specs.FIX_CR_R
static const int32_t kFixCbG = -22554;   // specs.FIX_CB_G
static const int32_t kFixCrG = -46802;   // specs.FIX_CR_G
static const int32_t kFixCbB = 116130;   // specs.FIX_CB_B
static const int32_t kColorBits = 16;
static const int32_t kColorHalf = 1 << (kColorBits - 1);

static inline uint8_t clamp255(int32_t x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// Shared emitter for the two destination layouts:
//   BottomUpBGR = false: top-down [height, width, 3] RGB raster
//                        (row_bytes = width * 3)
//   BottomUpBGR = true:  bottom-up padded BGR rows straight into a BMP
//                        pixel array (row_bytes >= width * 3) — fusing
//                        upsample + color + row serialization skips the
//                        intermediate RGB raster entirely (~6 B/px less
//                        memory traffic on the BMP write path).
extern "C++" {  // template: C++ linkage island inside the C export block
template <bool BottomUpBGR>
static int32_t ycbcr_emit(const uint8_t* planes, int64_t m_total,
                          int64_t mcu_off, int32_t v, int32_t h,
                          int32_t ncomp, int32_t mcu_rows, int32_t mcu_cols,
                          int32_t height, int32_t width, int64_t row_bytes,
                          uint8_t* out) {
  const int R = BottomUpBGR ? 2 : 0;
  const int B = BottomUpBGR ? 0 : 2;
  const int gy = v * h;
  for (int gr = 0; gr < mcu_rows; ++gr) {
    for (int s = 0; s < gy; ++s) {
      const int qv = s / h;
      const int qh = s % h;
      for (int cy = 0; cy < 8; ++cy) {
        const int row = gr * v * 8 + qv * 8 + cy;
        if (row >= height) continue;
        uint8_t* orow =
            out + static_cast<int64_t>(BottomUpBGR ? height - 1 - row
                                                   : row) * row_bytes;
        for (int cx = 0; cx < 8; ++cx) {
          // Wire planes use COLUMN-major pixel order (px*8 + py).
          const int c = cx * 8 + cy;
          const int64_t base = mcu_off + static_cast<int64_t>(gr) * mcu_cols;
          const uint8_t* yb =
              planes + static_cast<int64_t>(s * 64 + c) * m_total + base;
          const int col0 = qh * 8 + cx;
          if (ncomp == 1) {
            for (int mcu = 0; mcu < mcu_cols; ++mcu) {
              const int col = mcu * h * 8 + col0;
              if (col >= width) break;
              uint8_t* px = orow + static_cast<int64_t>(col) * 3;
              px[0] = px[1] = px[2] = yb[mcu];
            }
            continue;
          }
          // Nearest-neighbor upsample: this luma sample's chroma source.
          const int cc = ((qh * 8 + cx) / h) * 8 + (qv * 8 + cy) / v;
          const uint8_t* cbb =
              planes + static_cast<int64_t>(gy * 64 + cc) * m_total + base;
          const uint8_t* crb =
              planes + static_cast<int64_t>((gy + 1) * 64 + cc) * m_total +
              base;
          // In-bounds MCU count for this output column phase.
          int n = 0;
          if (col0 < width) {
            n = (width - 1 - col0) / (h * 8) + 1;
            if (n > mcu_cols) n = mcu_cols;
          }
          const int stride3 = h * 8 * 3;
          uint8_t* px0 = orow + static_cast<int64_t>(col0) * 3;
          int mcu = 0;
#if defined(__AVX2__)
          // 8 MCUs per step: the BT.601 epi32 math vectorizes (loads are
          // contiguous bytes); only the 3-byte pixel stores stay scalar
          // (AVX2 has no scatter).  Identical integer ops -> identical
          // bytes (mullo/srai/min/max == the scalar mul/>>/clamp).
          const __m256i k128 = _mm256_set1_epi32(128);
          const __m256i half = _mm256_set1_epi32(kColorHalf);
          const __m256i crr = _mm256_set1_epi32(kFixCrR);
          const __m256i cbg = _mm256_set1_epi32(kFixCbG);
          const __m256i crg = _mm256_set1_epi32(kFixCrG);
          const __m256i cbbk = _mm256_set1_epi32(kFixCbB);
          const __m256i zero = _mm256_setzero_si256();
          const __m256i v255 = _mm256_set1_epi32(255);
          for (; mcu + 8 <= n; mcu += 8) {
            const __m256i y = _mm256_cvtepu8_epi32(_mm_loadl_epi64(
                reinterpret_cast<const __m128i*>(yb + mcu)));
            const __m256i cb = _mm256_sub_epi32(
                _mm256_cvtepu8_epi32(_mm_loadl_epi64(
                    reinterpret_cast<const __m128i*>(cbb + mcu))), k128);
            const __m256i cr = _mm256_sub_epi32(
                _mm256_cvtepu8_epi32(_mm_loadl_epi64(
                    reinterpret_cast<const __m128i*>(crb + mcu))), k128);
            __m256i r = _mm256_add_epi32(y, _mm256_srai_epi32(
                _mm256_add_epi32(_mm256_mullo_epi32(crr, cr), half),
                kColorBits));
            __m256i g = _mm256_add_epi32(y, _mm256_srai_epi32(
                _mm256_add_epi32(_mm256_add_epi32(
                    _mm256_mullo_epi32(cbg, cb),
                    _mm256_mullo_epi32(crg, cr)), half), kColorBits));
            __m256i b = _mm256_add_epi32(y, _mm256_srai_epi32(
                _mm256_add_epi32(_mm256_mullo_epi32(cbbk, cb), half),
                kColorBits));
            r = _mm256_min_epi32(_mm256_max_epi32(r, zero), v255);
            g = _mm256_min_epi32(_mm256_max_epi32(g, zero), v255);
            b = _mm256_min_epi32(_mm256_max_epi32(b, zero), v255);
            alignas(32) int32_t rr[8], gg[8], bb[8];
            _mm256_store_si256(reinterpret_cast<__m256i*>(rr), r);
            _mm256_store_si256(reinterpret_cast<__m256i*>(gg), g);
            _mm256_store_si256(reinterpret_cast<__m256i*>(bb), b);
            uint8_t* p = px0 + static_cast<int64_t>(mcu) * stride3;
            for (int j = 0; j < 8; ++j, p += stride3) {
              p[R] = static_cast<uint8_t>(rr[j]);
              p[1] = static_cast<uint8_t>(gg[j]);
              p[B] = static_cast<uint8_t>(bb[j]);
            }
          }
#endif
          for (; mcu < n; ++mcu) {
            const int32_t y128 = yb[mcu];
            const int32_t cb = static_cast<int32_t>(cbb[mcu]) - 128;
            const int32_t cr = static_cast<int32_t>(crb[mcu]) - 128;
            uint8_t* px = px0 + static_cast<int64_t>(mcu) * stride3;
            px[R] = clamp255(y128 + ((kFixCrR * cr + kColorHalf)
                                     >> kColorBits));
            px[1] = clamp255(y128 + ((kFixCbG * cb + kFixCrG * cr
                                      + kColorHalf) >> kColorBits));
            px[B] = clamp255(y128 + ((kFixCbB * cb + kColorHalf)
                                     >> kColorBits));
          }
        }
      }
    }
  }
  return 0;
}
}  // extern "C++"

int32_t pjt_ycbcr_to_rgb(const uint8_t* planes, int64_t m_total,
                         int64_t mcu_off, int32_t v, int32_t h,
                         int32_t ncomp, int32_t mcu_rows, int32_t mcu_cols,
                         int32_t height, int32_t width, uint8_t* out) {
  return ycbcr_emit<false>(planes, m_total, mcu_off, v, h, ncomp, mcu_rows,
                           mcu_cols, height, width,
                           static_cast<int64_t>(width) * 3, out);
}

// Fused upsample + BT.601 + BMP row serialization: wire planes straight
// to the bottom-up padded BGR pixel array (io/bmp.py owns the headers).
// Identical integer spec to pjt_ycbcr_to_rgb -> byte-identical pixels;
// skips the intermediate [H, W, 3] raster the two-pass path writes and
// re-reads.
int32_t pjt_ycbcr_to_bmp_rows(const uint8_t* planes, int64_t m_total,
                              int64_t mcu_off, int32_t v, int32_t h,
                              int32_t ncomp, int32_t mcu_rows,
                              int32_t mcu_cols, int32_t height,
                              int32_t width, int64_t row_bytes,
                              uint8_t* out) {
  if (row_bytes < static_cast<int64_t>(width) * 3) return -7;
  const int64_t pad = row_bytes - static_cast<int64_t>(width) * 3;
  if (pad) {
    for (int64_t y = 0; y < height; ++y) {
      std::memset(out + y * row_bytes + static_cast<int64_t>(width) * 3, 0,
                  static_cast<size_t>(pad));
    }
  }
  return ycbcr_emit<true>(planes, m_total, mcu_off, v, h, ncomp, mcu_rows,
                          mcu_cols, height, width, row_bytes, out);
}

// Bottom-up padded BGR pixel rows from a dense [H, W, 3] RGB array --
// the byte-movement half of the BMP serializer (io/bmp.py owns headers
// and format decisions).  One pass, no intermediate buffers: the NumPy
// equivalent (reverse-strided gather + copy into the padded row buffer +
// tobytes) costs ~6.5 ms/MP on one core; this loop is memory-bound.
int32_t pjt_bmp_rows(const uint8_t* rgb, int64_t height, int64_t width,
                     int64_t row_bytes, uint8_t* out) {
  if (height <= 0 || width <= 0 || row_bytes < width * 3) return -7;
  const int64_t pad = row_bytes - width * 3;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = rgb + (height - 1 - y) * width * 3;
    uint8_t* dst = out + y * row_bytes;
    for (int64_t x = 0; x < width; ++x) {
      dst[x * 3 + 0] = src[x * 3 + 2];
      dst[x * 3 + 1] = src[x * 3 + 1];
      dst[x * 3 + 2] = src[x * 3 + 0];
    }
    for (int64_t p = 0; p < pad; ++p) dst[width * 3 + p] = 0;
  }
  return 0;
}

// Kernel-native raw RGB [3, V*H, n*n, M] (column-major slot pixel order,
// c = px*n + py) -> raster [out_h, out_w, 3] rows.  Pure layout inverse
// (models/pipeline.assemble_raster_raw_scaled semantics): three
// contiguous input streams per (slot, pixel) phase, strided 3-byte
// stores bounded to one output row -- the NumPy transpose chain costs
// ~5.7 ms/MP on one core; this loop sits near the pixel-scatter floor.
int32_t pjt_raster_rgb(const uint8_t* raw, int64_t m_total,
                       int64_t mcu_off, int32_t v, int32_t h, int32_t n,
                       int32_t mcu_rows, int32_t mcu_cols, int32_t out_h,
                       int32_t out_w, uint8_t* out) {
  if (v < 1 || h < 1 || n < 1 || n > 8 || m_total < 1 || mcu_off < 0 ||
      mcu_off + static_cast<int64_t>(mcu_rows) * mcu_cols > m_total) {
    return -7;
  }
  const int gy = v * h;
  const int nn = n * n;
  const int stride3 = h * n * 3;
  for (int gr = 0; gr < mcu_rows; ++gr) {
    const int64_t base = mcu_off + static_cast<int64_t>(gr) * mcu_cols;
    for (int s = 0; s < gy; ++s) {
      const int qv = s / h;
      const int qh = s % h;
      for (int cy = 0; cy < n; ++cy) {
        const int row = (gr * v + qv) * n + cy;
        if (row >= out_h) continue;
        uint8_t* orow = out + static_cast<int64_t>(row) * out_w * 3;
        for (int cx = 0; cx < n; ++cx) {
          const int c = cx * n + cy;
          const uint8_t* rb =
              raw + (static_cast<int64_t>(0 * gy + s) * nn + c) * m_total +
              base;
          const uint8_t* gb =
              raw + (static_cast<int64_t>(1 * gy + s) * nn + c) * m_total +
              base;
          const uint8_t* bb =
              raw + (static_cast<int64_t>(2 * gy + s) * nn + c) * m_total +
              base;
          const int col0 = qh * n + cx;
          int ncols = 0;
          if (col0 < out_w) {
            ncols = (out_w - 1 - col0) / (h * n) + 1;
            if (ncols > mcu_cols) ncols = mcu_cols;
          }
          uint8_t* px = orow + static_cast<int64_t>(col0) * 3;
          for (int mcu = 0; mcu < ncols; ++mcu, px += stride3) {
            px[0] = rb[mcu];
            px[1] = gb[mcu];
            px[2] = bb[mcu];
          }
        }
      }
    }
  }
  return 0;
}

int32_t pjt_abi_version() { return 13; }

}  // extern "C"
