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
// What bounds them on an H100: the floor, bytes (a 16,384-MCU 4:2:0
// launch reads 12.6 MB of int16 wire and writes 12.6 MB of RGB); the two
// decode variants, like rgb_kernel, their per-MCU decode work, not bytes:
// on an H100 80GB HBM3 at 700 W the floor moved those 25.2 MB in 19.3 us
// and rgb_kernel, truerez and stacked took 34-50 us (PERF.md).
//   - memfloor_kernel is rgb_kernel with the decode taken out and its
//     memory traffic left in: thread (slot s, MCU m) of a TILE-MCU block
//     reads its block with the same 16-byte loads, parks the low bytes in
//     shared memory, and the block writes every output byte once through
//     store_rgb (decode_common.cuh), the store loop rgb_kernel itself
//     calls: bytes, MCU index fastest across a warp, three planes.  The
//     wrapped sum is its only arithmetic (uint32_t; the low byte of a sum
//     depends on the low bytes of its terms only).  It must not copy
//     better than production (no wider stores), or it stops being
//     rgb_kernel's floor.
//   - rgb_truerez_kernel: rgb_kernel computes the three colour terms for
//     every output pixel; at 4:2:0 each chroma sample's terms four times.
//     Here the block computes each chroma sample's terms once into shared
//     memory (int16: |term| <= 227 for samples in [-128, 127]), and each
//     pixel adds y + 128 and its sample's terms through rgb_kernel's
//     chroma_pix index.  24 KB of samples plus 24 KB of terms: the
//     48 KB static limit at 4:2:0.
//   - rgb_stacked_kernel: 8 luma threads per MCU.  Luma thread u runs
//     pass 1 down column u of all gy luma blocks (gy 8-point chains, one
//     unrolled basic block: the GPU form of the TPU's [gy, 8, T]
//     operands), parks them in shared memory as int32 (pass 1 wraps on
//     extreme blocks, so int16 is not exact), then thread r runs pass 2
//     along row r of all gy blocks.  Two chroma threads per MCU decode
//     their blocks as in rgb_kernel.  The int32 stage takes gy*64*4 bytes
//     per MCU, so a block holds STACK_TILE = 32 MCUs (32 KB + 12 KB of
//     samples at 4:2:0, under the 48 KB static limit; TILE stays 64 for
//     the production kernels).  Shared arrays are [..][MCU], the MCU
//     index fastest across a warp: no bank conflicts.
// Tuning is for later: these are the simple, exact forms.

#include "decode_common.cuh"

namespace {

constexpr int STACK_TILE = 32;                     // MCUs per stacked block
constexpr int STACK_THREADS = (8 + 2) * STACK_TILE;

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

// Column u of the dequantized block (m, s): x[v] = deq[v*8 + u] as
// dequant_block (decode_common.cuh) computes it, one load per value.
template <typename T, int G>
__device__ __forceinline__ void dequant_column(
    const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ qpool, int num_q, long long m, int s, int u,
    uint32_t (&x)[8]) {
  const T* src = coeffs + (static_cast<size_t>(m) * G + s) * 64 + u;
  bool ok;
  const int32_t* q = quant_row<G>(qidx, qpool, num_q, m, s, ok) + u;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    x[v] = dequant(__ldg(src + 8 * v),
                   ok ? static_cast<uint32_t>(__ldg(q + 8 * v)) : 0u);
  }
}

template <typename T, int H, int V>
__global__ void __launch_bounds__(STACK_THREADS)
rgb_stacked_kernel(const T* __restrict__ coeffs,
                   const int32_t* __restrict__ qidx,
                   const int32_t* __restrict__ qpool, int num_q,
                   uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  constexpr int G = GY + 2;
  constexpr int TS = STACK_TILE;
  __shared__ int32_t rows[GY * 64 * TS];    // pass 1: [slot][r][u][MCU]
  __shared__ int8_t samples[G * 64 * TS];   // [slot][pixel][MCU]

  const int t = threadIdx.x;
  const int ml = t % TS;
  const long long m0 = static_cast<long long>(blockIdx.x) * TS;
  const long long m = m0 + ml;
  const bool live = m < num_mcus;
  const bool luma = t < 8 * TS;
  const int lane = t / TS;   // luma: column u (pass 1), then row r (pass 2)
  if (live && luma) {
    uint32_t in[GY][8];
    int32_t o[GY][8];
#pragma unroll
    for (int s = 0; s < GY; ++s) {
      dequant_column<T, G>(coeffs, qidx, qpool, num_q, m, s, lane, in[s]);
    }
#pragma unroll
    for (int s = 0; s < GY; ++s) {
      idct_1d<CONST_BITS - PASS1_BITS>(in[s], o[s]);
    }
#pragma unroll
    for (int s = 0; s < GY; ++s) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        rows[((s * 8 + r) * 8 + lane) * TS + ml] = o[s][r];
      }
    }
  } else if (live) {
    const int s = GY + lane - 8;
    uint32_t deq[64];
    int32_t spat[64];
    dequant_block<T, G>(coeffs, qidx, qpool, num_q, m, s, deq);
    idct_block(deq, spat);
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      samples[(s * 64 + k) * TS + ml] = static_cast<int8_t>(spat[k]);
    }
  }
  __syncthreads();

  if (live && luma) {
    uint32_t in[GY][8];
    int32_t o[GY][8];
#pragma unroll
    for (int s = 0; s < GY; ++s) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        in[s][u] =
            static_cast<uint32_t>(rows[((s * 8 + lane) * 8 + u) * TS + ml]);
      }
    }
#pragma unroll
    for (int s = 0; s < GY; ++s) {
      idct_1d<CONST_BITS + PASS1_BITS + 3>(in[s], o[s]);
    }
#pragma unroll
    for (int s = 0; s < GY; ++s) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        samples[(s * 64 + p * 8 + lane) * TS + ml] = static_cast<int8_t>(
            min(max(o[s][p], SAMPLE_MIN), SAMPLE_MAX));
      }
    }
  }
  __syncthreads();

  store_rgb<GY, 64, TS, STACK_THREADS>(
      out, m0, num_mcus,
      [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
        const int c = chroma_pix<H, V>(sl, pix);
        bt601(samples[(sl * 64 + pix) * TS + mj],
              samples[(GY * 64 + c) * TS + mj],
              samples[((GY + 1) * 64 + c) * TS + mj], r, g, b);
      });
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
void launch(Variant var, const Args& a) {
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
    const unsigned blocks = grid(a.num_mcus, STACK_TILE);
    rgb_stacked_kernel<T, H, V><<<blocks, STACK_THREADS, 0, a.stream>>>(
        c, a.qidx, a.qpool, a.num_q, a.out, a.num_mcus);
  }
}

template <typename T>
bool dispatch_mode(Variant var, const Args& a, int h, int v) {
  if (h == 1 && v == 1) {
    launch<T, 1, 1>(var, a);
  } else if (h == 2 && v == 1) {
    launch<T, 2, 1>(var, a);
  } else if (h == 1 && v == 2) {
    launch<T, 1, 2>(var, a);
  } else if (h == 2 && v == 2) {
    launch<T, 2, 2>(var, a);
  } else {
    return false;
  }
  return true;
}

int run(Variant var, const void* coeffs, int wire_bytes, const void* qidx,
        const void* qpool, int num_q, void* out, long long num_mcus, int h,
        int v, int ncomp, void* stream) {
  if (num_mcus <= 0 || num_q <= 0 || ncomp != 3) return cudaErrorInvalidValue;
  const Args a{coeffs, static_cast<const int32_t*>(qidx),
               static_cast<const int32_t*>(qpool), num_q,
               static_cast<uint8_t*>(out), num_mcus,
               static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (wire_bytes == 2) {
    ok = dispatch_mode<int16_t>(var, a, h, v);
  } else if (wire_bytes == 1) {
    ok = dispatch_mode<int8_t>(var, a, h, v);
  }
  if (!ok) return cudaErrorInvalidValue;
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
