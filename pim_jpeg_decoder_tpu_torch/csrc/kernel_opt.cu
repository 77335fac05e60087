// Experiment kernels of the fused RGB decode for Hopper (sm_90a): the
// memory floor of the tiled decode kernels' pattern and two
// restructurings of rgb_kernel (decode_kernel.cu), timed against it by
// tools/kernel_opt.py.
//
// Replaces the Pallas kernels of the repository's tools/kernel_opt.py:
//   memfloor_kernel    <- _kernel_memfloor: no decode; each luma slot's
//                         output byte is u8(c[s] + c[gy] + c[gy+1]), in all
//                         three planes
//   rgb_truerez_kernel <- _kernel_chroma_truerez: rgb_kernel's output, the
//                         BT.601 chroma terms computed at chroma resolution
//   rgb_stacked_kernel <- _kernel_stacked: rgb_kernel's output, all luma
//                         slots of an MCU in one butterfly chain
// All three read the host's [M, g, 64] coefficient wire (int8 or int16)
// directly and write uint8 [3, gy, 64, M], pixels COLUMN-major
// (px*8 + py), as rgb_kernel does; colour modes only (g = gy + 2).  The
// ragged end (M not a multiple of the block's MCUs) is masked.
//
// What bounds them on an H100 80GB HBM3 at 700 W (PERF.md): the floor,
// bytes (a 16,384-MCU 4:2:0 launch reads 12.6 MB of int16 wire and writes
// 12.6 MB of RGB: 7.54 us at 3.35 TB/s); truerez
// and stacked, like the tiled rgb_kernel, one wave's latency at M=16,384
// and issue at M=196,608.
//   - memfloor_kernel moves the bytes of the tiled decode kernels
//     (decode_tile.cuh) in their pattern, with the decode taken out: a
//     256-thread block copies a TILE_MCUS tile of the wire with load_tile
//     (16-byte cp.async, one wait a tile, the MCU_PAD-padded [MCU][slot]
//     [64] copy; FloorLayout holds nothing else and no qidx is staged),
//     then writes 16-byte row pieces to the three planes, every warp
//     store filling whole 32-byte sectors (floor_store16): lane l of warp
//     s sums rows 4j .. 4j + 3 of luma slot s and of both chroma slots of
//     16 MCUs, a 4- or 8-byte shared read an MCU and slot (floor_mcu's
//     order keeps the two halves of a warp 16 banks apart:
//     floor_conflict_free), byte by byte in 16-bit lanes, and a 4x4 byte
//     transpose of four MCUs' words gives a word of each row.  Byte stores
//     through store_rgb when M % 16 != 0 or the output is off the 16-byte
//     grid, as store_tile_rgb does.  The wrapped sum is its only
//     arithmetic (the low byte of a sum depends on the low bytes of its
//     terms only).  A decode kernel moves these bytes and more work, so
//     it cannot beat this floor by its pattern; a share over 100% is a
//     finding.  The first form (rgb_kernel's first, per-thread pattern: a
//     thread per 8x8 block of a 64-MCU block, 64 registers of 16-byte
//     loads, the low bytes parked in shared memory, byte stores) took
//     15.98-16.05 [19.01-19.07] us int8 [int16] at 4:2:0 M=16,384 and
//     144.1-144.3 us at M=196,608 int16, and the tiled rgb_kernel ran at
//     113-117% of it at M=2,048; this one 11.31-11.42 [13.06-13.10] and
//     122.8-122.9 us, 50% [58%] and 73% of the byte bound
//     (tools/decode_ab.py, H100 80GB HBM3, 700 W, digests equal), and no
//     slower than rgb_kernel at any kernel_opt.sweep() size on either wire
//     (PERF.md).  At M=196,608 its reads and writes do not overlap:
//     variants without the stores and without the loads (a throwaway
//     script, numbers not kept) took times that add up to its own, the
//     writes the larger part, so its 32-byte row pieces (one sector of a
//     row a tile) write slower than its contiguous reads; at M=16,384 it
//     is one wave that loads, then stores.  22-54 registers, 4-8 blocks an
//     SM.
//   - rgb_truerez_kernel keeps the TPU kernel's idea (each chroma
//     sample's three BT.601 terms computed once, at chroma resolution,
//     into a buffer, then added to every luma pixel the sample serves) on
//     rgb_kernel's tile: load_tile and decode_tile as rgb_kernel runs
//     them, then, after one __syncthreads, a terms step in which lane j
//     computes chroma pixel j / 4 of 8 MCUs (chroma_terms) into int16 rows
//     [3][64][TILE_MCUS] (|term| <= 227 for samples in [-128, 127]) in
//     the transpose scratch, idle once decode_tile returns (12,288 of its
//     13,312 B; 16-byte chunks XOR-swizzled by chroma pixel, so the terms
//     step's writes and the store's reads hit 32 banks without padding:
//     truerez_conflict_free), so shared memory and blocks an SM stay
//     rgb_kernel's.  After a second __syncthreads each lane writes 16
//     bytes of one luma row into each plane: 16 luma bytes, its chroma
//     pixel's 2 x 16 bytes of terms a plane, two pixels a DPX instruction
//     (__viaddmin_s16x2_relu: max(min(y + 128 + t, 255), 0)); byte stores
//     through store_rgb when M % 16 != 0.  The first form (a thread per
//     8x8 block, 64-MCU blocks of 384 threads, 48 KB of static shared
//     memory, byte stores) took 30.3 [34.4] us int8 [int16] at 4:2:0
//     M=16,384; this one 19.70-19.81 [21.55-21.68] us, and 159.3-159.5 us
//     at M=196,608 int16 (was 344.7-344.9), against rgb_kernel's 19.03-19.10
//     [20.88-20.90] and 156.4 in the same runs (tools/decode_ab.py, H100
//     80GB HBM3, 700 W): 2-4% slower than rgb_kernel's terms in
//     registers with 8-byte stores, though it issues a sixth fewer
//     instructions (376.8 against 452.5 warp instructions an MCU at 4:2:0
//     int8): the terms step is a phase of its own between two barriers.
//     48-63 registers, 4-5 blocks an SM, rgb_kernel's shared memory.
//   - rgb_stacked_kernel keeps the experiment (the GPU form of the TPU's
//     [gy, 8, T] operands: all gy luma blocks of an MCU in one unrolled
//     chain a lane) on rgb_kernel's tile machinery (decode_tile.cuh): a
//     TILE_MCUS tile copied with 16-byte cp.async (load_tile), 8 lanes an
//     MCU.  Luma lane u loads column u of all gy blocks and runs their gy
//     pass-1 chains in one basic block, parks them in an int32 scratch
//     that holds all gy blocks (rows of 8 words, each MCU's rows rotated
//     by its index and half-swapped: conflict-free both ways without
//     padding), and lane r runs the gy pass-2 chains of row r; each chroma
//     block then takes one such round on the same 8 lanes, as in
//     rgb_kernel; rgb_kernel's store follows (store_tile_rgb: chroma terms
//     once a sample, 8-byte row stores; byte stores when M % 16 != 0).
//     The scratch is gy KB an MCU, so a 4:2:0 tile takes 64,128 B (int8)
//     or 76,416 B (int16) of shared memory against rgb_kernel's 44,672 /
//     56,960 B: 79 registers (48-79 over the modes), 3 blocks an SM (24
//     warps) where rgb_kernel runs 4 (64 registers): ILP traded for
//     resident warps.  The answer (kernel_opt.sweep(), int16, one call):
//     stacked and tiled are level at M = 2,048-32,768 (10.43 / 10.19,
//     11.15 / 11.28, 22.06 / 21.18, 37.12 / 37.22 us) and stacked is
//     slower at 65,536 and 196,608 (65.17 / 61.90, 178.38 / 160.06 us):
//     four chains a lane do not lift one wave off its latency floor, and
//     the lost warps cost more once waves overlap.  20.1 [21.6] us at
//     4:2:0 M=16,384 int8 [int16], was 47.3 [49.0].

#include <type_traits>

#include "decode_common.cuh"
#include "decode_tile.cuh"

namespace {

constexpr int STACK_MIN_BLOCKS = 2;   // resident stacked blocks an SM must fit

// memfloor_kernel's shared memory: the tile's wire bytes as load_tile
// copies them ([MCU][slot][64] of T, MCU_PAD bytes after each MCU), and
// nothing else: no transpose scratch, samples or quantizer rows.
template <typename T, int G>
struct FloorLayout {
  static constexpr int kMcuBytes = G * 64 * static_cast<int>(sizeof(T));
  static constexpr int kMcuStride = kMcuBytes + MCU_PAD;
  static constexpr int kCoeffs = 0;
  static constexpr int kQrows = -1;   // load_tile stages no rows
  static constexpr int kBytes = TILE_MCUS * kMcuStride;
};

constexpr int FLOOR_HALF = TILE_MCUS / 2;   // MCUs of one 16-byte store

// The 16-byte store's lanes: lane l of warp s takes rows 4j .. 4j + 3
// (j = l & 15) of luma slot s for the tile's MCUs 16h .. 16h + 15 (h = l >>
// 4), so the 32 lanes of one store fill 16 rows' 32 bytes.  At step i
// (0..15) lane l reads MCU floor_mcu(l, i): the second half starts 4 MCUs
// on, which puts its reads 16 banks away from the first half's (MCU
// strides are 4 words past a multiple of 16, so MCUs 4 or 20 apart are 16
// banks apart); its result words come out rotated by one and are put back
// with selects.
__host__ __device__ constexpr int floor_mcu(int lane, int i) {
  return (lane >> 4) * FLOOR_HALF + ((i + 4 * (lane >> 4)) & 15);
}

// The claims: at every step and for every slot (luma and both chroma),
// the 32 lanes' 4-byte reads (int8: rows 4j .. 4j + 3) or each half
// warp's 8-byte reads (int16) fall on distinct banks.
template <typename T, int G>
constexpr bool floor_conflict_free() {
  using L = FloorLayout<T, G>;
  if (TILE_MCUS != 2 * FLOOR_HALF || FLOOR_HALF != 16) return false;
  if (L::kMcuStride % VEC != 0) return false;
  constexpr int kWidth = static_cast<int>(sizeof(T));   // words a read
  for (int s = 0; s < G; ++s) {
    for (int i = 0; i < FLOOR_HALF; ++i) {
      int w[32] = {};
      for (int l = 0; l < 32; ++l) {
        w[l] = (floor_mcu(l, i) * L::kMcuStride +
                (s * 64 + 4 * (l & 15)) * kWidth) / 4;
      }
      if (kWidth == 1 && !phase_conflict_free(w, 32, 1)) return false;
      if (kWidth == 2 && (!phase_conflict_free(w, 16, 2) ||
                          !phase_conflict_free(w + 16, 16, 2))) {
        return false;
      }
    }
  }
  return true;
}

// u8(a + b + c) of each byte: the even and the odd bytes summed apart in
// 16-bit lanes (at most 765: no carry reaches the next byte kept).
__device__ __forceinline__ uint32_t bytes_sum(uint32_t a, uint32_t b,
                                              uint32_t c) {
  constexpr uint32_t kEven = 0x00ff00ffu, kOdd = 0xff00ff00u;
  const uint32_t even = (a & kEven) + (b & kEven) + (c & kEven);
  const uint32_t odd = (a & kOdd) + (b & kOdd) + (c & kOdd);
  return (even & kEven) | (odd & kOdd);
}

// Byte r of the result: the low byte of the int32 sum of row 4j + r of
// luma slot s and of both chroma slots, p pointing at rows 4j .. 4j + 3
// of slot 0 of one MCU (slots kSlot bytes apart).  The low byte of a sum
// is the sum of the low bytes: int8 words sum byte by byte, int16 ones in
// their even bytes, gathered.
template <typename T, int GY>
__device__ __forceinline__ uint32_t floor_word(const uint8_t* p, int s) {
  constexpr int kSlot = 64 * static_cast<int>(sizeof(T));
  if constexpr (sizeof(T) == 1) {
    const auto at = [&](int slot) {
      return *reinterpret_cast<const uint32_t*>(p + slot * kSlot);
    };
    return bytes_sum(at(s), at(GY), at(GY + 1));
  } else {
    const auto at = [&](int slot) {
      return *reinterpret_cast<const uint2*>(p + slot * kSlot);
    };
    const uint2 a = at(s), b = at(GY), c = at(GY + 1);
    constexpr uint32_t kEven = 0x00ff00ffu;
    const uint32_t lo = (a.x & kEven) + (b.x & kEven) + (c.x & kEven);
    const uint32_t hi = (a.y & kEven) + (b.y & kEven) + (c.y & kEven);
    return __byte_perm(lo, hi, 0x6420);
  }
}

// The 16-byte store (every output row 16-byte aligned, valid a multiple of
// 16): lane l of warp s < GY sums rows 4j .. 4j + 3 of slot s and the two
// chroma slots for its 16 MCUs, four MCUs at a time (a 4x4 byte transpose
// turns four MCUs' words into a word of each row), and writes each row's 16
// bytes into the three planes.
template <typename T, int GY>
__device__ __forceinline__ void floor_store16(const uint8_t* smem,
                                              uint8_t* __restrict__ out,
                                              long long m0,
                                              long long num_mcus,
                                              int valid) {
  using L = FloorLayout<T, GY + 2>;
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane & 15, h = lane >> 4;
  if (s >= GY || h * FLOOR_HALF >= valid) return;
  const uint8_t* col = smem + L::kCoeffs + j * 4 * static_cast<int>(sizeof(T));
  uint32_t acc[4][4];   // [row r][word q of the rotated order]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      w[e] = floor_word<T, GY>(
          col + floor_mcu(lane, 4 * q + e) * L::kMcuStride, s);
    }
    const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
    const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
    const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
    acc[0][q] = __byte_perm(t0, t2, 0x5410);
    acc[1][q] = __byte_perm(t0, t2, 0x7632);
    acc[2][q] = __byte_perm(t1, t3, 0x5410);
    acc[3][q] = __byte_perm(t1, t3, 0x7632);
  }
  const size_t plane = static_cast<size_t>(GY) * 64 * num_mcus;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // Word p of the row holds MCUs 4p .. 4p + 3 of the half: the second
    // half computed word p into acc[(p + 3) & 3].
    const int4 v = make_int4(
        static_cast<int>(h ? acc[r][3] : acc[r][0]),
        static_cast<int>(h ? acc[r][0] : acc[r][1]),
        static_cast<int>(h ? acc[r][1] : acc[r][2]),
        static_cast<int>(h ? acc[r][2] : acc[r][3]));
    uint8_t* dst = out + static_cast<size_t>(s * 64 + 4 * j + r) * num_mcus +
                   m0 + h * FLOOR_HALF;
    *reinterpret_cast<int4*>(dst) = v;
    *reinterpret_cast<int4*>(dst + plane) = v;
    *reinterpret_cast<int4*>(dst + 2 * plane) = v;
  }
}

// The floor of the tiled decode kernels' memory pattern: load_tile's copy
// of a TILE_MCUS tile (no qidx), then the 16-byte row stores of
// floor_store16 (VEC16), or store_rgb's byte stores, which also mask the
// ragged last tile.
template <typename T, int GY, bool VEC16>
__global__ void __launch_bounds__(TILE_THREADS, TILE_MIN_BLOCKS)
memfloor_kernel(const T* __restrict__ coeffs, uint8_t* __restrict__ out,
                long long num_mcus) {
  constexpr int G = GY + 2;
  using L = FloorLayout<T, G>;
  __shared__ __align__(16) uint8_t smem[L::kBytes];
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE_MCUS;
  const int valid = tile_valid(m0, num_mcus);
  load_tile<T, G, L>(coeffs, nullptr, 0, m0, valid, smem);
  if constexpr (VEC16) {
    floor_store16<T, GY>(smem, out, m0, num_mcus, valid);
  } else {
    store_rgb<GY, 64, TILE_MCUS, TILE_THREADS>(
        out, m0, num_mcus,
        [&](int sl, int k, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
          const T* c = reinterpret_cast<const T*>(smem + L::kCoeffs +
                                                  mj * L::kMcuStride);
          const uint32_t sum = static_cast<uint32_t>(c[sl * 64 + k]) +
                               static_cast<uint32_t>(c[GY * 64 + k]) +
                               static_cast<uint32_t>(c[(GY + 1) * 64 + k]);
          r = g = b = static_cast<uint8_t>(sum);
        });
  }
}

// rgb_truerez_kernel's chroma terms: int16 [3][64 chroma pixels][TILE_MCUS]
// (R, G, B) in the transpose scratch of TileLayout (idle once decode_tile
// returns), TILE_MCUS * 2 = 64 bytes a chroma pixel, as four 16-byte chunks
// of 8 MCUs.  Chunk q of chroma pixel c sits at chunk q ^ ((c >> 1) & 3) of
// its row, so the 16-byte term reads of a quarter warp (8 luma rows of one
// column, or their 2-4 chroma pixels) and the terms step's writes hit 32
// banks without padding (truerez_conflict_free).
constexpr int TERM_ROW = TILE_MCUS * 2;             // bytes a chroma pixel
constexpr int TERM_PLANE = 64 * TERM_ROW;           // bytes a term plane

// The 16-byte unit (from the scratch's start) of chunk q of plane k's
// chroma pixel c.
__host__ __device__ constexpr int term_unit(int k, int c, int q) {
  return (k * TERM_PLANE + c * TERM_ROW) / VEC + (q ^ ((c >> 1) & 3));
}

// chroma_pix (decode_common.cuh) of luma row `row` = slot * 64 + pixel, for
// the layout claims on the host as well.
template <int H, int V>
__host__ __device__ constexpr int truerez_chroma(int row) {
  const int sl = row >> 6, px = (row >> 3) & 7, py = row & 7;
  return ((sl % H) * (8 / H) + px / H) * 8 + (sl / H) * (8 / V) + py / V;
}

// Piece j of the 16-byte store (GY * 64 rows of two 16-byte halves): the 8
// lanes of a quarter warp take 8 consecutive rows and one half, so their
// luma reads (rows SAMPLE_ROW = 3 * 16 bytes apart) hit 32 banks, and the
// two halves of a row go out in one warp store.
__host__ __device__ constexpr int piece_row(int j) {
  return (j >> 4) * 8 + (j & 7);
}
__host__ __device__ constexpr int piece_half(int j) { return (j >> 3) & 1; }

// The claims, for a tile of TILE_THREADS lanes: the terms fit the idle
// transpose scratch; the terms step's 16-byte writes (lane j: chroma pixel
// j / 4, chunk j % 4) and, in mode H x V, each of the store's two 16-byte
// term reads and its luma read fall on 32 banks in every quarter warp.
template <int H, int V>
constexpr bool truerez_conflict_free() {
  using L = TileLayout<int16_t, H * V + 2>;
  if (3 * TERM_PLANE > L::kCoeffs - L::kXpose) return false;
  if (TILE_THREADS != 64 * (TILE_MCUS / 8)) return false;
  for (int k = 0; k < 3; ++k) {
    for (int j0 = 0; j0 < TILE_THREADS; j0 += 8) {
      int w[8] = {};
      for (int l = 0; l < 8; ++l) {
        w[l] = 4 * term_unit(k, (j0 + l) >> 2, (j0 + l) & 3);
      }
      if (!phase_conflict_free(w, 8, 4)) return false;
    }
  }
  for (int j0 = 0; j0 < H * V * 64 * 2; j0 += 8) {
    int luma[8] = {};
    for (int l = 0; l < 8; ++l) {
      luma[l] = (piece_row(j0 + l) * SAMPLE_ROW + piece_half(j0 + l) * VEC) / 4;
    }
    if (!phase_conflict_free(luma, 8, 4)) return false;
    for (int k = 0; k < 3; ++k) {
      for (int q = 0; q < 2; ++q) {
        int w[8] = {};
        for (int l = 0; l < 8; ++l) {
          const int c = truerez_chroma<H, V>(piece_row(j0 + l));
          w[l] = 4 * term_unit(k, c, 2 * piece_half(j0 + l) + q);
        }
        if (!phase_conflict_free(w, 8, 4)) return false;
      }
    }
  }
  return true;
}

// The terms step: lane j computes the three terms of chroma pixel j / 4 of
// the tile's MCUs 8 (j % 4) .. + 7 once (chroma_terms, bt601's arithmetic:
// |term| <= 227 for samples in [-128, 127]) and writes them as three
// 16-byte chunks.
template <int GY>
__device__ __forceinline__ void truerez_terms(const int8_t* samples,
                                              uint8_t* terms) {
  const int c = threadIdx.x >> 2, q = threadIdx.x & 3;
  const uint2 cb = *reinterpret_cast<const uint2*>(
      samples + (GY * 64 + c) * SAMPLE_ROW + q * 8);
  const uint2 cr = *reinterpret_cast<const uint2*>(
      samples + ((GY + 1) * 64 + c) * SAMPLE_ROW + q * 8);
  uint32_t w[3][4];
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    int32_t t0[3], t1[3];
    chroma_terms(sample8_at(cb, e), sample8_at(cr, e), t0[0], t0[1], t0[2]);
    chroma_terms(sample8_at(cb, e + 1), sample8_at(cr, e + 1), t1[0], t1[1],
                 t1[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w[k][e / 2] = (static_cast<uint32_t>(t0[k]) & 0xffffu) |
                    (static_cast<uint32_t>(t1[k]) << 16);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    *reinterpret_cast<int4*>(terms + term_unit(k, c, q) * VEC) =
        make_int4(static_cast<int>(w[k][0]), static_cast<int>(w[k][1]),
                  static_cast<int>(w[k][2]), static_cast<int>(w[k][3]));
  }
}

// The term of plane k for chroma pixel c of the tile's MCU mj.
__device__ __forceinline__ int32_t term_at(const uint8_t* terms, int k, int c,
                                           int mj) {
  return reinterpret_cast<const int16_t*>(
      terms + term_unit(k, c, mj >> 3) * VEC)[mj & 7];
}

// 16 luma bytes (y + 128, as level_shift16 gives them) plus 16 int16 terms,
// clamped to [0, 255], as 16 bytes: two pixels a DPX instruction
// (max(min(y + t, 255), 0) per 16-bit half), the bytes widened to 16-bit
// halves and narrowed back with byte permutes.
__device__ __forceinline__ int4 add_terms16(const uint32_t (&y2)[8],
                                            const int4& t_lo,
                                            const int4& t_hi) {
  const uint32_t t[8] = {
      static_cast<uint32_t>(t_lo.x), static_cast<uint32_t>(t_lo.y),
      static_cast<uint32_t>(t_lo.z), static_cast<uint32_t>(t_lo.w),
      static_cast<uint32_t>(t_hi.x), static_cast<uint32_t>(t_hi.y),
      static_cast<uint32_t>(t_hi.z), static_cast<uint32_t>(t_hi.w)};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a = __viaddmin_s16x2_relu(y2[2 * i], t[2 * i], 0x00ff00ffu);
    const uint32_t b =
        __viaddmin_s16x2_relu(y2[2 * i + 1], t[2 * i + 1], 0x00ff00ffu);
    o[i] = __byte_perm(a, b, 0x6420);
  }
  return make_int4(static_cast<int>(o[0]), static_cast<int>(o[1]),
                   static_cast<int>(o[2]), static_cast<int>(o[3]));
}

// The store with every output row 16-byte aligned: lane piece j writes 16
// bytes of luma row piece_row(j) into each plane, its chroma pixel's terms
// read from the scratch.  valid is a multiple of 16 here (M % 16 == 0).
template <int H, int V>
__device__ __forceinline__ void store_truerez16(const int8_t* samples,
                                                const uint8_t* terms,
                                                uint8_t* __restrict__ out,
                                                long long m0,
                                                long long num_mcus,
                                                int valid) {
  constexpr int kPieces = H * V * 64 * 2;
  constexpr int kRounds = (kPieces + TILE_THREADS - 1) / TILE_THREADS;
  const size_t plane = static_cast<size_t>(H * V) * 64 * num_mcus;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int j = r * TILE_THREADS + threadIdx.x;
    const int row = piece_row(j), half = piece_half(j);
    if (j >= kPieces || half * VEC >= valid) continue;
    const int4 y = level_shift16(load16(samples + row * SAMPLE_ROW +
                                        half * VEC));
    const uint32_t w[4] = {static_cast<uint32_t>(y.x),
                           static_cast<uint32_t>(y.y),
                           static_cast<uint32_t>(y.z),
                           static_cast<uint32_t>(y.w)};
    uint32_t y2[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y2[2 * i] = __byte_perm(w[i], 0u, 0x4140);
      y2[2 * i + 1] = __byte_perm(w[i], 0u, 0x4342);
    }
    const int c = truerez_chroma<H, V>(row);
    uint8_t* dst = out + static_cast<size_t>(row) * num_mcus + m0 + half * VEC;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int4 t_lo = *reinterpret_cast<const int4*>(
          terms + term_unit(k, c, 2 * half) * VEC);
      const int4 t_hi = *reinterpret_cast<const int4*>(
          terms + term_unit(k, c, 2 * half + 1) * VEC);
      *reinterpret_cast<int4*>(dst + k * plane) = add_terms16(y2, t_lo, t_hi);
    }
  }
}

// rgb_kernel's output with the colour terms at chroma resolution, on
// rgb_kernel's tile (decode_tile.cuh): load_tile and decode_tile as
// rgb_kernel runs them, then the terms step into the idle transpose
// scratch, then 16-byte row stores of each plane (VEC16), or store_rgb's
// byte stores, which also mask the ragged last tile.
template <typename T, int H, int V, bool VEC16>
__global__ void __launch_bounds__(TILE_THREADS, TILE_MIN_BLOCKS)
rgb_truerez_kernel(const T* __restrict__ coeffs,
                   const int32_t* __restrict__ qidx,
                   const int32_t* __restrict__ qpool, int num_q,
                   uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  using L = TileLayout<T, GY + 2>;
  extern __shared__ __align__(16) uint8_t smem[];
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE_MCUS;
  const int valid = tile_valid(m0, num_mcus);
  load_tile<T, GY + 2>(coeffs, qidx, num_q, m0, valid, smem);
  decode_tile<T, GY + 2>(qpool, smem);
  __syncthreads();
  const int8_t* samples = reinterpret_cast<const int8_t*>(smem + L::kSamples);
  uint8_t* terms = smem + L::kXpose;
  truerez_terms<GY>(samples, terms);
  __syncthreads();
  if constexpr (VEC16) {
    store_truerez16<H, V>(samples, terms, out, m0, num_mcus, valid);
  } else {
    store_rgb<GY, 64, TILE_MCUS, TILE_THREADS>(
        out, m0, num_mcus,
        [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
          const int32_t y128 = samples[(sl * 64 + pix) * SAMPLE_ROW + mj] + 128;
          const int c = truerez_chroma<H, V>(sl * 64 + pix);
          r = to_u8(y128 + term_at(terms, 0, c, mj));
          g = to_u8(y128 + term_at(terms, 1, c, mj));
          b = to_u8(y128 + term_at(terms, 2, c, mj));
        });
  }
}

// rgb_stacked_kernel's dynamic shared memory: decode_tile.cuh's TileLayout
// with a transpose scratch that holds all GY luma blocks of every MCU at
// once, kScratch words an MCU: GY blocks of 8 rows x 8 words, laid out by
// stacked_word.
template <typename T, int GY>
struct StackedLayout {
  static constexpr int G = GY + 2;
  static constexpr int kMcuBytes = G * 64 * static_cast<int>(sizeof(T));
  static constexpr int kMcuStride = kMcuBytes + MCU_PAD;
  static constexpr int kScratch = GY * 64;
  static constexpr int kXpose = 0;
  static constexpr int kCoeffs = kXpose + TILE_MCUS * kScratch * 4;
  static constexpr int kSamples = kCoeffs + TILE_MCUS * kMcuStride;
  static constexpr int kQrows = kSamples + G * 64 * SAMPLE_ROW;
  static constexpr int kBytes = kQrows + TILE_MCUS * 4;
};

// Word of (row r, column u) of an 8x8 int32 block of MCU mj, in 8-word
// rows: row r sits in row slot (r + mj) % 8, so the 4 MCUs of a warp
// writing the same row hit 4 different groups of 8 banks (no padding
// between MCUs), and slots 4-7 keep their two 4-word halves swapped, so
// the 8 lanes of an MCU, each reading its row with 16-byte loads, hit 32
// distinct banks.
__host__ __device__ constexpr int stacked_word(int mj, int r, int u) {
  const int slot = (r + mj) & 7;
  return slot * 8 + (u ^ (slot & 4));
}

// stacked_word's claims, for MCUs SCRATCH words apart: each MCU's block is
// a permutation of its 64 words; the column writes of one row by a warp's
// 4 MCUs (lane 8j + u, MCU 4w + j) hit 32 banks; an MCU's 8 lanes reading
// rows 0-7 with 16-byte loads of either half hit 32 banks.
template <int SCRATCH>
constexpr bool stacked_conflict_free() {
  for (int mj = 0; mj < 8; ++mj) {
    bool seen[64] = {};
    for (int k = 0; k < 64; ++k) {
      const int w = stacked_word(mj, k / 8, k % 8);
      if (seen[w]) return false;
      seen[w] = true;
    }
  }
  for (int m4 = 0; m4 < 8; m4 += 4) {
    for (int r = 0; r < 8; ++r) {
      int w[32] = {};
      for (int l = 0; l < 32; ++l) {
        const int mj = m4 + l / 8;
        w[l] = mj * SCRATCH + stacked_word(mj, r, l % 8);
      }
      if (!phase_conflict_free(w, 32, 1)) return false;
    }
  }
  for (int mj = 0; mj < 8; ++mj) {
    for (int half = 0; half < 8; half += 4) {
      int w[8] = {};
      for (int r = 0; r < 8; ++r) w[r] = stacked_word(mj, r, half);
      if (!phase_conflict_free(w, 8, 4)) return false;
    }
  }
  return true;
}

// Slots s0 .. s0+NB-1 of MCU mj on the 8 lanes i of its group: lane i
// loads column u = i of all NB blocks (coefficients from the tile,
// quantizers from the pool; an out-of-range row reads row 0 masked to 0),
// then runs the NB pass-1 chains in one basic block (NB independent
// idct_1d), parks them in the MCU's scratch, and after __syncwarp runs the
// NB pass-2 chains along row r = i.  Pass 1 stays int32 (it wraps on
// extreme blocks); both passes are decode_common.cuh's idct_1d.
template <typename L, typename T, int NB>
__device__ __forceinline__ void stacked_blocks(
    const int32_t* __restrict__ qpool, uint8_t* smem, int s0, int mj, int i,
    int32_t* xp) {
  const int row = reinterpret_cast<const int32_t*>(smem + L::kQrows)[mj];
  const uint32_t keep = row < 0 ? 0u : ~0u;
  const int32_t* q = qpool +
                     (static_cast<size_t>(row < 0 ? 0 : row) * L::G + s0) * 64 +
                     i;
  const T* c = reinterpret_cast<const T*>(smem + L::kCoeffs +
                                          mj * L::kMcuStride) + s0 * 64 + i;
  int8_t* samples = reinterpret_cast<int8_t*>(smem + L::kSamples);
  int32_t cv[NB][8];
  uint32_t qv[NB][8];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      cv[b][v] = c[b * 64 + 8 * v];
      qv[b][v] = static_cast<uint32_t>(__ldg(q + b * 64 + 8 * v));
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    uint32_t x[8];
    int32_t o[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) x[v] = dequant(cv[b][v], qv[b][v] & keep);
    idct_1d<CONST_BITS - PASS1_BITS>(x, o);
#pragma unroll
    for (int r = 0; r < 8; ++r) xp[b * 64 + stacked_word(mj, r, i)] = o[r];
  }
  __syncwarp();
  const int slot = (i + mj) & 7;   // where row i sits
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int32_t* src = xp + b * 64 + slot * 8;
    const int4 lo = *reinterpret_cast<const int4*>(src + (slot & 4));
    const int4 hi = *reinterpret_cast<const int4*>(src + ((slot & 4) ^ 4));
    const uint32_t x[8] = {static_cast<uint32_t>(lo.x),
                           static_cast<uint32_t>(lo.y),
                           static_cast<uint32_t>(lo.z),
                           static_cast<uint32_t>(lo.w),
                           static_cast<uint32_t>(hi.x),
                           static_cast<uint32_t>(hi.y),
                           static_cast<uint32_t>(hi.z),
                           static_cast<uint32_t>(hi.w)};
    int32_t o[8];
    idct_1d<CONST_BITS + PASS1_BITS + 3>(x, o);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      samples[((s0 + b) * 64 + p * 8 + i) * SAMPLE_ROW + mj] =
          static_cast<int8_t>(min(max(o[p], SAMPLE_MIN), SAMPLE_MAX));
    }
  }
  __syncwarp();   // the next call overwrites the scratch
}

// A TILE_MCUS tile of TILE_THREADS threads, 8 lanes an MCU (a warp takes 4
// MCUs): the luma slots stacked in one call, then each chroma slot as
// rgb_kernel takes it, then rgb_kernel's store (store_tile_rgb).
template <typename T, int H, int V, bool VEC16>
__global__ void __launch_bounds__(TILE_THREADS, STACK_MIN_BLOCKS)
rgb_stacked_kernel(const T* __restrict__ coeffs,
                   const int32_t* __restrict__ qidx,
                   const int32_t* __restrict__ qpool, int num_q,
                   uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  using L = StackedLayout<T, GY>;
  extern __shared__ __align__(16) uint8_t smem[];
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE_MCUS;
  const int valid = tile_valid(m0, num_mcus);
  load_tile<T, L::G, L>(coeffs, qidx, num_q, m0, valid, smem);
  const int lane = threadIdx.x & 31;
  const int mj = (threadIdx.x >> 5) * 4 + (lane >> 3);
  int32_t* xp = reinterpret_cast<int32_t*>(smem + L::kXpose) +
                mj * L::kScratch;
  stacked_blocks<L, T, GY>(qpool, smem, 0, mj, lane & 7, xp);
  stacked_blocks<L, T, 1>(qpool, smem, GY, mj, lane & 7, xp);
  stacked_blocks<L, T, 1>(qpool, smem, GY + 1, mj, lane & 7, xp);
  __syncthreads();
  store_tile_rgb<H, V, 3, VEC16>(
      reinterpret_cast<const int8_t*>(smem + L::kSamples), out, m0, num_mcus,
      valid);
}

template <typename T>
using KernelFn = void (*)(const T*, const int32_t*, const int32_t*, int,
                          uint8_t*, long long);

template <typename T>
using MemfloorFn = void (*)(const T*, uint8_t*, long long);

enum class Variant { kMemfloor, kTruerez, kStacked };

// The tile kernel (truerez or stacked) of one mode and store form and its
// dynamic shared memory, prepared once per instantiation and device (the
// stacked kernel's is above the 48 KB static limit).  The layouts' bank
// claims are checked here, at build time.
template <typename T, int H, int V, bool VEC16>
cudaError_t tile_kernel(Variant var, KernelFn<T>& fn, int& smem) {
  static_assert(stacked_conflict_free<StackedLayout<T, H * V>::kScratch>(),
                "stacked scratch bank conflicts");
  static_assert(truerez_conflict_free<H, V>(),
                "truerez terms: fit or bank conflicts");
  if (var == Variant::kTruerez) {
    fn = rgb_truerez_kernel<T, H, V, VEC16>;
    smem = TileLayout<T, H * V + 2>::kBytes;
    static PerDevice prepared;
    return prepared.get(
        [&] { return prepare(reinterpret_cast<const void*>(fn), smem); });
  }
  fn = rgb_stacked_kernel<T, H, V, VEC16>;
  smem = StackedLayout<T, H * V>::kBytes;
  static PerDevice prepared;
  return prepared.get(
      [&] { return prepare(reinterpret_cast<const void*>(fn), smem); });
}

// tile_kernel for a launch with 16-byte row stores (vec16) or byte stores.
template <typename T, int H, int V>
cudaError_t pick_tile_kernel(Variant var, bool vec16, KernelFn<T>& fn,
                             int& smem) {
  return vec16 ? tile_kernel<T, H, V, true>(var, fn, smem)
               : tile_kernel<T, H, V, false>(var, fn, smem);
}

struct Args {
  const void* coeffs;
  const int32_t* qidx;
  const int32_t* qpool;
  int num_q;
  uint8_t* out;
  long long num_mcus;
  cudaStream_t stream;
};

// memfloor_kernel of one mode, wire and store form (16-byte stores or
// bytes).  The bank claims of its tile reads are checked here, at build
// time.
template <typename T, int GY>
MemfloorFn<T> memfloor_fn(bool vec16) {
  static_assert(floor_conflict_free<T, GY + 2>(),
                "memfloor tile reads: bank conflicts");
  return vec16 ? memfloor_kernel<T, GY, true> : memfloor_kernel<T, GY, false>;
}

template <typename T, int H, int V>
int launch(Variant var, const Args& a) {
  const T* c = static_cast<const T*>(a.coeffs);
  // 16-byte row stores when every output row is 16-byte aligned.
  const bool vec16 = a.num_mcus % VEC == 0 &&
                     reinterpret_cast<uintptr_t>(a.out) % VEC == 0;
  const unsigned blocks = grid(a.num_mcus, TILE_MCUS);
  if (var == Variant::kMemfloor) {
    memfloor_fn<T, H * V>(vec16)<<<blocks, TILE_THREADS, 0, a.stream>>>(
        c, a.out, a.num_mcus);
  } else {
    KernelFn<T> kernel;
    int smem;
    const cudaError_t e = pick_tile_kernel<T, H, V>(var, vec16, kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, TILE_THREADS, smem, a.stream>>>(
        c, a.qidx, a.qpool, a.num_q, a.out, a.num_mcus);
  }
  return cudaSuccess;
}

// f(std::integral_constant<int, h>, ..<v>) for the four colour modes.
template <typename F>
int dispatch_mode(int h, int v, F f) {
  using std::integral_constant;
  if (h == 1 && v == 1) {
    return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
  }
  if (h == 2 && v == 1) {
    return f(integral_constant<int, 2>{}, integral_constant<int, 1>{});
  }
  if (h == 1 && v == 2) {
    return f(integral_constant<int, 1>{}, integral_constant<int, 2>{});
  }
  if (h == 2 && v == 2) {
    return f(integral_constant<int, 2>{}, integral_constant<int, 2>{});
  }
  return cudaErrorInvalidValue;
}

int run(Variant var, const void* coeffs, int wire_bytes, const void* qidx,
        const void* qpool, int num_q, void* out, long long num_mcus, int h,
        int v, int ncomp, void* stream) {
  if (num_mcus <= 0 || num_q <= 0 || ncomp != 3) return cudaErrorInvalidValue;
  if (wire_bytes != 1 && wire_bytes != 2) return cudaErrorInvalidValue;
  const Args a{coeffs, static_cast<const int32_t*>(qidx),
               static_cast<const int32_t*>(qpool), num_q,
               static_cast<uint8_t*>(out), num_mcus,
               static_cast<cudaStream_t>(stream)};
  const int rc = dispatch_mode(h, v, [&](auto hc, auto vc) {
    constexpr int H = decltype(hc)::value, V = decltype(vc)::value;
    return wire_bytes == 2 ? launch<int16_t, H, V>(var, a)
                           : launch<int8_t, H, V>(var, a);
  });
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes), with pjt_cuda_decode_rgb's signature
// (decode_kernel.cu); ncomp must be 3.  Each launches on `stream`,
// allocates nothing, and returns cudaGetLastError() after the launch
// (0 = launched).  Output uint8 [3, h*v, 64, M].

// qidx and qpool are not read (the floor moves the coefficient bytes only).
extern "C" int pjt_cuda_memfloor(const void* coeffs, int wire_bytes,
                                 const void* qidx, const void* qpool,
                                 int num_q, void* out, long long num_mcus,
                                 int h, int v, int ncomp, void* stream) {
  return run(Variant::kMemfloor, coeffs, wire_bytes, qidx, qpool, num_q, out,
             num_mcus, h, v, ncomp, stream);
}

extern "C" int pjt_cuda_decode_rgb_truerez(const void* coeffs, int wire_bytes,
                                           const void* qidx, const void* qpool,
                                           int num_q, void* out,
                                           long long num_mcus, int h, int v,
                                           int ncomp, void* stream) {
  return run(Variant::kTruerez, coeffs, wire_bytes, qidx, qpool, num_q, out,
             num_mcus, h, v, ncomp, stream);
}

extern "C" int pjt_cuda_decode_rgb_stacked(const void* coeffs, int wire_bytes,
                                           const void* qidx, const void* qpool,
                                           int num_q, void* out,
                                           long long num_mcus, int h, int v,
                                           int ncomp, void* stream) {
  return run(Variant::kStacked, coeffs, wire_bytes, qidx, qpool, num_q, out,
             num_mcus, h, v, ncomp, stream);
}
