// Tile helpers of the full-scale decode kernels (rgb_kernel, ycbcr_kernel
// in decode_kernel.cu; rgb_stacked_kernel in kernel_opt.cu; the tile
// constants and stores also serve rgb_scaled_kernel): a CUDA block copies
// a tile of TILE_MCUS consecutive MCUs into shared memory, decodes every
// 8x8 block of it with 8 threads, and writes its output rows 16 bytes a
// lane.  The design and
// its reasons are in decode_kernel.cu's header.  The arithmetic is
// decode_common.cuh's (dequant, idct_1d, bt601, chroma_pix), unchanged;
// its byte store (store_rgb) is the fallback of the 16-byte stores.

#pragma once

#include <cuda_pipeline.h>

#include <mutex>

#include "decode_common.cuh"

namespace {

constexpr int TILE_MCUS = 32;              // MCUs per CUDA block
constexpr int TILE_THREADS = 256;          // 8 warps
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int TILE_MIN_BLOCKS = 4;         // resident blocks an SM must fit
constexpr int MCU_PAD = 16;                // bytes after each MCU's wire copy
constexpr int SAMPLE_ROW = TILE_MCUS + 16; // bytes per [slot][pixel] row
constexpr int XPOSE_ROW = 12;              // int32 words per transpose row
constexpr int XPOSE_BLOCK = 8 * XPOSE_ROW + 8;  // words per 8x8 block
constexpr int VEC = 16;                    // bytes per vector load or store

// The dynamic shared memory of one block, every part 16-byte aligned:
// the pass-1 transpose (4 blocks per warp, int32), the tile's wire bytes
// ([MCU][slot][64] of T, each MCU followed by MCU_PAD bytes), the samples
// ([slot][pixel][MCU] int8, rows of SAMPLE_ROW bytes) and each MCU's
// quantizer row (-1: qidx out of range).
template <typename T, int G>
struct TileLayout {
  static constexpr int kMcuBytes = G * 64 * static_cast<int>(sizeof(T));
  static constexpr int kMcuStride = kMcuBytes + MCU_PAD;
  static constexpr int kXpose = 0;
  static constexpr int kCoeffs = kXpose + TILE_WARPS * 4 * XPOSE_BLOCK * 4;
  static constexpr int kSamples = kCoeffs + TILE_MCUS * kMcuStride;
  static constexpr int kQrows = kSamples + G * 64 * SAMPLE_ROW;
  static constexpr int kBytes = kQrows + TILE_MCUS * 4;
};

// For the layouts' static_asserts: true when no two of n lanes, lane l
// accessing `width` consecutive int32 words from word[l] (-1: idle), touch
// different words of one bank, so that one shared-memory phase (32 lanes of
// 4-byte, 16 of 8-byte or 8 of 16-byte accesses) has no conflict.
constexpr bool phase_conflict_free(const int* word, int n, int width) {
  int held[32] = {};
  for (int b = 0; b < 32; ++b) held[b] = -1;
  for (int l = 0; l < n; ++l) {
    for (int w = 0; w < width && word[l] >= 0; ++w) {
      const int a = word[l] + w;
      if (held[a % 32] >= 0 && held[a % 32] != a) return false;
      held[a % 32] = a;
    }
  }
  return true;
}

// The block's MCUs: TILE_MCUS, or fewer in the ragged last tile.
__device__ __forceinline__ int tile_valid(long long m0, long long num_mcus) {
  const long long left = num_mcus - m0;
  return left < TILE_MCUS ? static_cast<int>(left) : TILE_MCUS;
}

// Copy the tile's wire bytes (one contiguous run of valid * kMcuBytes
// bytes, 16-byte aligned: kMcuBytes is a multiple of 64) into shared
// memory with 16-byte asynchronous copies, lane i on chunk i; meanwhile
// stage each MCU's quantizer row.  Returns after both have landed.  L is
// TileLayout, or a layout with the same members and another scratch; a
// layout whose kQrows is negative stages no rows and qidx is not read.
template <typename T, int G, typename L = TileLayout<T, G>>
__device__ __forceinline__ void load_tile(const T* __restrict__ coeffs,
                                          const int32_t* __restrict__ qidx,
                                          int num_q, long long m0, int valid,
                                          uint8_t* smem) {
  constexpr int kChunks = L::kMcuBytes / VEC;   // per MCU
  constexpr int kRounds = (TILE_MCUS * kChunks + TILE_THREADS - 1) /
                          TILE_THREADS;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(coeffs) +
                       static_cast<size_t>(m0) * L::kMcuBytes;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = k * TILE_THREADS + threadIdx.x;
    if (c < valid * kChunks) {
      __pipeline_memcpy_async(
          smem + L::kCoeffs + (c / kChunks) * L::kMcuStride +
              (c % kChunks) * VEC,
          src + static_cast<size_t>(c) * VEC, VEC);
    }
  }
  __pipeline_commit();
  if constexpr (L::kQrows >= 0) {
    if (threadIdx.x < TILE_MCUS) {
      int row = -1;
      if (static_cast<int>(threadIdx.x) < valid) {
        const int qi = __ldg(qidx + m0 + threadIdx.x);
        if (static_cast<unsigned>(qi) < static_cast<unsigned>(num_q)) row = qi;
      }
      reinterpret_cast<int32_t*>(smem + L::kQrows)[threadIdx.x] = row;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Column u = i of slot s of the thread's MCU: its 8 coefficients from
// the tile and its 8 quantizers from the pool.
template <typename T, int G>
__device__ __forceinline__ void load_column(const T* c, const int32_t* q,
                                            int s, int32_t (&cv)[8],
                                            uint32_t (&qv)[8]) {
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    cv[v] = c[s * 64 + 8 * v];
    qv[v] = static_cast<uint32_t>(__ldg(q + s * 64 + 8 * v));
  }
}

// Dequantize + 2-pass IDCT + clamp of every 8x8 block of the tile, into
// the samples.  A warp takes 4 blocks at a time, 8 lanes each, one MCU
// per 8 lanes and the slots one round after another: lane i reads column
// u = i of its block from shared memory and its 8 quantizers (an
// out-of-range row decodes against 0, read from row 0 so the loads stay
// unconditional; the next round's are loaded before this round's
// arithmetic, so their latency hides behind it), runs pass 1 down it,
// parks the 8 int32 results in its warp's transpose scratch, and after
// __syncwarp reads row r = i back with two 16-byte loads and runs pass 2
// along it.  Blocks past the ragged end decode whatever the tile holds
// there and are never stored.
template <typename T, int G>
__device__ __forceinline__ void decode_tile(const int32_t* __restrict__ qpool,
                                            uint8_t* smem) {
  using L = TileLayout<T, G>;
  static_assert(TILE_MCUS == TILE_WARPS * 4, "a round is one slot");
  const int lane = threadIdx.x & 31;
  const int i = lane & 7;
  const int mj = (threadIdx.x >> 5) * 4 + (lane >> 3);
  int32_t* xp = reinterpret_cast<int32_t*>(smem + L::kXpose) +
                mj * XPOSE_BLOCK;
  const int row = reinterpret_cast<const int32_t*>(smem + L::kQrows)[mj];
  const uint32_t keep = row < 0 ? 0u : ~0u;
  const int32_t* q =
      qpool + static_cast<size_t>(row < 0 ? 0 : row) * G * 64 + i;
  const T* c = reinterpret_cast<const T*>(smem + L::kCoeffs +
                                          mj * L::kMcuStride) + i;
  int8_t* samples = reinterpret_cast<int8_t*>(smem + L::kSamples);
  int32_t cn[8];
  uint32_t qn[8];
  load_column<T, G>(c, q, 0, cn, qn);
#pragma unroll
  for (int s = 0; s < G; ++s) {
    uint32_t x[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) x[v] = dequant(cn[v], qn[v] & keep);
    if (s + 1 < G) load_column<T, G>(c, q, s + 1, cn, qn);
    int32_t o[8];
    idct_1d<CONST_BITS - PASS1_BITS>(x, o);
#pragma unroll
    for (int r = 0; r < 8; ++r) xp[r * XPOSE_ROW + i] = o[r];
    __syncwarp();
    const int4 lo = *reinterpret_cast<const int4*>(xp + i * XPOSE_ROW);
    const int4 hi = *reinterpret_cast<const int4*>(xp + i * XPOSE_ROW + 4);
    __syncwarp();   // the next round overwrites the scratch
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
    idct_1d<CONST_BITS + PASS1_BITS + 3>(x, o);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      samples[(s * 64 + p * 8 + i) * SAMPLE_ROW + mj] =
          static_cast<int8_t>(min(max(o[p], SAMPLE_MIN), SAMPLE_MAX));
    }
  }
}

__device__ __forceinline__ int4 load16(const int8_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// Level shift of 16 int8 samples to uint8: s + 128 is s ^ 0x80.
__device__ __forceinline__ int4 level_shift16(int4 v) {
  constexpr int kBias = static_cast<int>(0x80808080u);
  return make_int4(v.x ^ kBias, v.y ^ kBias, v.z ^ kBias, v.w ^ kBias);
}

// The rows of ROWS rows x TILE_MCUS bytes, WIDTH bytes a lane, the lanes
// of a row next to each other: fn(row, offset) for every piece that lies
// inside the valid MCUs (all of them when valid is a multiple of WIDTH, as
// the vector path requires).
template <int ROWS, int WIDTH, typename F>
__device__ __forceinline__ void for_each_piece(int valid, F fn) {
  constexpr int kPerRow = TILE_MCUS / WIDTH;
  constexpr int kRounds = (ROWS * kPerRow + TILE_THREADS - 1) / TILE_THREADS;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int j = k * TILE_THREADS + threadIdx.x;
    const int off = (j % kPerRow) * WIDTH;
    if (j < ROWS * kPerRow && off < valid) fn(j / kPerRow, off);
  }
}

// Byte j (0..7) of 8 bytes, sign-extended.
__device__ __forceinline__ int32_t sample8_at(const uint2& v, int j) {
  return static_cast<int8_t>((j < 4 ? v.x : v.y) >> ((j & 3) * 8));
}

__device__ __forceinline__ uint2 pack8(const uint8_t (&b)[8]) {
  return make_uint2(
      b[0] | (b[1] << 8) | (b[2] << 16) | (static_cast<uint32_t>(b[3]) << 24),
      b[4] | (b[5] << 8) | (b[6] << 16) | (static_cast<uint32_t>(b[7]) << 24));
}

// The luma row (slot * 64 + pixel) of the k-th of the H*V luma pixels
// whose nearest chroma sample is chroma pixel c (col * 8 + row): the
// inverse of chroma_pix<H, V> (decode_common.cuh).
template <int H, int V>
__device__ __forceinline__ int luma_of_chroma(int c, int k) {
  const int col = c >> 3, row = c & 7;
  const int sl = (row / (8 / V)) * H + col / (8 / H);
  const int py = (row % (8 / V)) * V + k / H;
  const int px = (col % (8 / H)) * H + k % H;
  return sl * 64 + px * 8 + py;
}

// The three BT.601 chroma terms of bt601 (decode_common.cuh) for one
// (cb, cr) pair, the same wrap-around arithmetic: R, G and B of a pixel
// are then to_u8(y + 128 + term).
__device__ __forceinline__ void chroma_terms(int32_t cb, int32_t cr,
                                             int32_t& tr, int32_t& tg,
                                             int32_t& tb) {
  const uint32_t ucb = static_cast<uint32_t>(cb);
  const uint32_t ucr = static_cast<uint32_t>(cr);
  tr = descale_color(static_cast<uint32_t>(FIX_CR_R) * ucr);
  tg = descale_color(static_cast<uint32_t>(FIX_CB_G) * ucb +
                     static_cast<uint32_t>(FIX_CR_G) * ucr);
  tb = descale_color(static_cast<uint32_t>(FIX_CB_B) * ucb);
}

// The RGB store of a decoded tile (rgb_kernel; kernel_opt.cu's
// rgb_stacked_kernel): samples [slot][pixel][MCU] int8, rows of SAMPLE_ROW
// bytes, to uint8 [3, GY, 64, M] after the block's last __syncthreads.
// Gray: each row 16 bytes a lane, to all three planes.  Colour: chroma
// pixel c of 8 MCUs a lane, its three BT.601 terms once, then the H*V luma
// pixels it serves, 8 bytes a plane each (four lanes fill a row's 32
// bytes, so every warp store still writes whole sectors).  Without VEC16
// (a row off the 16-byte grid) store_rgb's byte stores, which also mask
// the ragged last tile.
template <int H, int V, int NC, bool VEC16>
__device__ __forceinline__ void store_tile_rgb(const int8_t* samples,
                                               uint8_t* __restrict__ out,
                                               long long m0,
                                               long long num_mcus,
                                               int valid) {
  constexpr int GY = H * V;
  const size_t plane = static_cast<size_t>(GY) * 64 * num_mcus;
  if constexpr (VEC16 && NC == 1) {
    for_each_piece<64, VEC>(valid, [&](int row, int c16) {
      const int4 y = level_shift16(load16(samples + row * SAMPLE_ROW + c16));
      uint8_t* dst = out + static_cast<size_t>(row) * num_mcus + m0 + c16;
      *reinterpret_cast<int4*>(dst) = y;
      *reinterpret_cast<int4*>(dst + plane) = y;
      *reinterpret_cast<int4*>(dst + 2 * plane) = y;
    });
  } else if constexpr (VEC16) {
    for_each_piece<64, 8>(valid, [&](int c, int c8) {
      const uint2 cb = *reinterpret_cast<const uint2*>(
          samples + (GY * 64 + c) * SAMPLE_ROW + c8);
      const uint2 cr = *reinterpret_cast<const uint2*>(
          samples + ((GY + 1) * 64 + c) * SAMPLE_ROW + c8);
      int32_t tr[8], tg[8], tb[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        chroma_terms(sample8_at(cb, j), sample8_at(cr, j), tr[j], tg[j],
                     tb[j]);
      }
#pragma unroll
      for (int k = 0; k < GY; ++k) {
        const int row = luma_of_chroma<H, V>(c, k);
        const uint2 y = *reinterpret_cast<const uint2*>(
            samples + row * SAMPLE_ROW + c8);
        uint8_t r[8], g[8], b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int32_t y128 = sample8_at(y, j) + 128;
          r[j] = to_u8(y128 + tr[j]);
          g[j] = to_u8(y128 + tg[j]);
          b[j] = to_u8(y128 + tb[j]);
        }
        uint8_t* dst = out + static_cast<size_t>(row) * num_mcus + m0 + c8;
        *reinterpret_cast<uint2*>(dst) = pack8(r);
        *reinterpret_cast<uint2*>(dst + plane) = pack8(g);
        *reinterpret_cast<uint2*>(dst + 2 * plane) = pack8(b);
      }
    });
  } else {
    store_rgb<GY, 64, TILE_MCUS, TILE_THREADS>(
        out, m0, num_mcus,
        [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
          const int32_t y = samples[(sl * 64 + pix) * SAMPLE_ROW + mj];
          if (NC == 1) {
            r = g = b = static_cast<uint8_t>(y + 128);
          } else {
            const int c = chroma_pix<H, V>(sl, pix);
            bt601(y, samples[(GY * 64 + c) * SAMPLE_ROW + mj],
                  samples[((GY + 1) * 64 + c) * SAMPLE_ROW + mj], r, g, b);
          }
        });
  }
}

// Let a tile kernel have its dynamic shared memory and the largest
// shared-memory carveout, so that its blocks fit an SM as planned.
inline cudaError_t prepare(const void* kernel, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  return e;
}

// A kernel's preparation made once for each device: function attributes
// act on the current device only, so a kernel prepared on one card is
// prepared again on the first launch that runs on another.  A launcher
// keeps one of these in a function-local static and passes it the
// preparation; the current device picks the slot.
class PerDevice {
 public:
  template <typename Prepare>
  cudaError_t get(Prepare prepare) {
    int device = 0;
    const cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(once_[device], [&] { result_[device] = prepare(); });
    return result_[device];
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::once_flag once_[kMaxDevices];
  cudaError_t result_[kMaxDevices] = {};
};

}  // namespace
