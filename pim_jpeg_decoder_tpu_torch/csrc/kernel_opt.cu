// Experiment kernels of the fused RGB decode for Hopper (sm_90a): the
// layout-matched memory floor and two restructurings of rgb_kernel
// (decode_kernel.cu), timed against it by tools/kernel_opt.py.
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
// What bounds them on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 4;
// PERF.md): the floor, bytes (a 16,384-MCU 4:2:0 launch reads 12.6 MB of
// int16 wire and writes 12.6 MB of RGB, in 19.1-19.3 us); truerez, like
// rgb_kernel's first form, its per-thread decode work (30.3 [34.4] us
// int8 [int16]); stacked, like the tiled rgb_kernel, one wave's latency
// at M=16,384 and issue at M=196,608.
//   - memfloor_kernel is rgb_kernel's first form (a thread per 8x8
//     block; decode_kernel.cu now holds a tiled redesign) with the decode
//     taken out and its memory traffic left in: thread (slot s, MCU m)
//     of a TILE-MCU block reads its block with the same 16-byte loads,
//     parks the low bytes in shared memory, and the block writes every
//     output byte once through store_rgb (decode_common.cuh), that
//     form's store loop: bytes, MCU index fastest across a warp, three
//     planes.  The wrapped sum is its only arithmetic (uint32_t; the low
//     byte of a sum depends on the low bytes of its terms only).  It keeps
//     measuring that access pattern (no wider stores), so the tiled
//     rgb_kernel can beat it.
//   - rgb_truerez_kernel: rgb_kernel computes the three colour terms for
//     every output pixel; at 4:2:0 each chroma sample's terms four times.
//     Here the block computes each chroma sample's terms once into shared
//     memory (int16: |term| <= 227 for samples in [-128, 127]), and each
//     pixel adds y + 128 and its sample's terms through rgb_kernel's
//     chroma_pix index.  24 KB of samples plus 24 KB of terms: the
//     48 KB static limit at 4:2:0.
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
// memfloor and truerez are the simple, exact first forms.

#include <type_traits>

#include "decode_common.cuh"
#include "decode_tile.cuh"

namespace {

constexpr int STACK_MIN_BLOCKS = 2;   // resident stacked blocks an SM must fit

template <typename T, int GY>
__global__ void __launch_bounds__((GY + 2) * TILE)
memfloor_kernel(const T* __restrict__ coeffs, uint8_t* __restrict__ out,
                long long num_mcus) {
  constexpr int G = GY + 2;
  __shared__ uint8_t low[G * 64 * TILE];   // [slot][coefficient][MCU]

  const int ml = threadIdx.x % TILE;
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE;
  if (m0 + ml < num_mcus) {
    const int s = threadIdx.x / TILE;
    int32_t c[64];
    load_block<T>(coeffs + (static_cast<size_t>(m0 + ml) * G + s) * 64, c);
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      low[(s * 64 + k) * TILE + ml] = static_cast<uint8_t>(c[k]);
    }
  }
  __syncthreads();

  store_rgb<GY, 64, TILE, G * TILE>(
      out, m0, num_mcus,
      [&](int sl, int k, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
        const uint32_t sum =
            static_cast<uint32_t>(low[(sl * 64 + k) * TILE + mj]) +
            low[(GY * 64 + k) * TILE + mj] +
            low[((GY + 1) * 64 + k) * TILE + mj];
        r = g = b = static_cast<uint8_t>(sum);
      });
}

template <typename T, int H, int V>
__global__ void __launch_bounds__((H * V + 2) * TILE)
rgb_truerez_kernel(const T* __restrict__ coeffs,
                   const int32_t* __restrict__ qidx,
                   const int32_t* __restrict__ qpool, int num_q,
                   uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  constexpr int G = GY + 2;
  __shared__ int8_t samples[G * 64 * TILE];   // [slot][pixel][MCU]
  __shared__ int16_t terms[3 * 64 * TILE];    // [R, G, B][chroma pixel][MCU]

  const int ml = threadIdx.x % TILE;
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE;
  if (m0 + ml < num_mcus) {
    const int s = threadIdx.x / TILE;
    uint32_t deq[64];
    int32_t spat[64];
    dequant_block<T, G>(coeffs, qidx, qpool, num_q, m0 + ml, s, deq);
    idct_block(deq, spat);
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      samples[(s * 64 + k) * TILE + ml] = static_cast<int8_t>(spat[k]);
    }
  }
  __syncthreads();

  // The terms of each chroma sample, once (j = chroma pixel * TILE + MCU).
  const long long left = num_mcus - m0;
  for (int j = threadIdx.x; j < 64 * TILE; j += G * TILE) {
    if (j % TILE >= left) continue;
    const uint32_t cb = static_cast<uint32_t>(
        static_cast<int32_t>(samples[GY * 64 * TILE + j]));
    const uint32_t cr = static_cast<uint32_t>(
        static_cast<int32_t>(samples[(GY + 1) * 64 * TILE + j]));
    terms[j] = static_cast<int16_t>(
        descale_color(static_cast<uint32_t>(FIX_CR_R) * cr));
    terms[64 * TILE + j] = static_cast<int16_t>(
        descale_color(static_cast<uint32_t>(FIX_CB_G) * cb +
                      static_cast<uint32_t>(FIX_CR_G) * cr));
    terms[2 * 64 * TILE + j] = static_cast<int16_t>(
        descale_color(static_cast<uint32_t>(FIX_CB_B) * cb));
  }
  __syncthreads();

  store_rgb<GY, 64, TILE, G * TILE>(
      out, m0, num_mcus,
      [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
        const int32_t y128 = samples[(sl * 64 + pix) * TILE + mj] + 128;
        const int c = chroma_pix<H, V>(sl, pix) * TILE + mj;
        r = to_u8(y128 + terms[c]);
        g = to_u8(y128 + terms[64 * TILE + c]);
        b = to_u8(y128 + terms[2 * 64 * TILE + c]);
      });
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

// The stacked kernel of one mode and store form and its dynamic shared
// memory, prepared once per instantiation (above the 48 KB static limit).
template <typename T, int H, int V, bool VEC16>
cudaError_t stacked_kernel(KernelFn<T>& fn, int& smem) {
  static_assert(stacked_conflict_free<StackedLayout<T, H * V>::kScratch>(),
                "stacked scratch bank conflicts");
  fn = rgb_stacked_kernel<T, H, V, VEC16>;
  smem = StackedLayout<T, H * V>::kBytes;
  static const cudaError_t ready =
      prepare(reinterpret_cast<const void*>(fn), smem);
  return ready;
}

enum class Variant { kMemfloor, kTruerez, kStacked };

struct Args {
  const void* coeffs;
  const int32_t* qidx;
  const int32_t* qpool;
  int num_q;
  uint8_t* out;
  long long num_mcus;
  cudaStream_t stream;
};

template <typename T, int H, int V>
int launch(Variant var, const Args& a) {
  constexpr int G = H * V + 2;
  const T* c = static_cast<const T*>(a.coeffs);
  if (var == Variant::kMemfloor) {
    const unsigned blocks = grid(a.num_mcus, TILE);
    memfloor_kernel<T, H * V><<<blocks, G * TILE, 0, a.stream>>>(
        c, a.out, a.num_mcus);
  } else if (var == Variant::kTruerez) {
    const unsigned blocks = grid(a.num_mcus, TILE);
    rgb_truerez_kernel<T, H, V><<<blocks, G * TILE, 0, a.stream>>>(
        c, a.qidx, a.qpool, a.num_q, a.out, a.num_mcus);
  } else {
    // 16-byte row stores when every output row is 16-byte aligned.
    const bool vec16 = a.num_mcus % VEC == 0 &&
                       reinterpret_cast<uintptr_t>(a.out) % VEC == 0;
    KernelFn<T> kernel;
    int smem;
    const cudaError_t e = vec16 ? stacked_kernel<T, H, V, true>(kernel, smem)
                                : stacked_kernel<T, H, V, false>(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid(a.num_mcus, TILE_MCUS), TILE_THREADS, smem, a.stream>>>(
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

// The stacked kernel a launch of M % 16 == 0 (vec16 = 1) or of the byte
// stores (0) takes in mode h x v on this wire: its dynamic shared memory
// in *smem_bytes and the blocks of TILE_THREADS an SM holds in
// *blocks_per_sm (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int pjt_cuda_stacked_occupancy(int wire_bytes, int h, int v,
                                          int vec16, int* blocks_per_sm,
                                          int* smem_bytes) {
  if (wire_bytes != 1 && wire_bytes != 2) return cudaErrorInvalidValue;
  return dispatch_mode(h, v, [&](auto hc, auto vc) {
    constexpr int H = decltype(hc)::value, V = decltype(vc)::value;
    const auto query = [&](auto wire) {
      using T = decltype(wire);
      KernelFn<T> kernel;
      int smem = 0;
      cudaError_t e = vec16 ? stacked_kernel<T, H, V, true>(kernel, smem)
                            : stacked_kernel<T, H, V, false>(kernel, smem);
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, kernel, TILE_THREADS, smem);
      }
      *smem_bytes = smem;
      return static_cast<int>(e);
    };
    return wire_bytes == 2 ? query(int16_t{}) : query(int8_t{});
  });
}
