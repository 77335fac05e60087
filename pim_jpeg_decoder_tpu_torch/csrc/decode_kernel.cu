// Fused MCU decode kernels for Hopper (sm_90a): dequantize -> 13-bit
// Loeffler IDCT -> (nearest-neighbour chroma upsample + BT.601) -> uint8.
//
// Replaces the Pallas kernels of the JAX package's decode paths:
//   rgb_kernel   <- pim_jpeg_decoder_tpu/ops/decode_kernel.py:_make_kernel
//                   (scale == 1), output [3, luma_slots, 64, M]
//   ycbcr_kernel <- pim_jpeg_decoder_tpu/ops/decode_kernel.py:
//                   _make_kernel_ycbcr, output [g, 64, M] (level-shifted)
//   rgb_scaled_kernel <- the same _make_kernel with scale 2/4/8 (reduced
//                   IDCT, see its comment below), output [3, gy, n*n, M]
// All read the host's [M, g, 64] coefficient wire (int16, or int8 when the
// batch fits) directly, with no transpose before the launch, and emit
// pixels COLUMN-major inside each 8x8 slot (index = px*8 + py), the layout
// the host C++ finishers read.  The arithmetic is the integer spec of
// ops/specs.py and ops/idct_math.py, bit for bit.
//
// What bounds it on an H100: bytes.  A 16,384-MCU 4:2:0 launch moves about
// 12.6 MB in (int16 wire) and 12.6 MB out (RGB), while the IDCT costs a few
// hundred integer operations per 8x8 block: far below the card's
// operations-per-byte balance point.  The design therefore reads each
// coefficient once and writes each output byte once, with the MCU index
// fastest across a warp so output stores coalesce:
//   - a CUDA block owns TILE consecutive MCUs; thread (slot s, MCU m) loads
//     its block with 16-byte loads, dequantizes against qpool[qidx[m]][s],
//     runs both IDCT passes in registers and clamps to [-128, 127];
//   - the YCbCr kernel stores sample + 128 straight to [g, 64, M];
//   - the RGB kernel parks the samples in shared memory ([slot][pixel][MCU],
//     so neighbouring threads read neighbouring bytes), synchronises, and
//     then computes each output pixel's nearest chroma sample and BT.601.
//     Taking the chroma IDCT at chroma resolution and indexing it is
//     bit-identical to the TPU kernel's row/column selection between
//     passes: replication commutes with the separable passes and with the
//     element-wise colour terms.
// The ragged end (M not a multiple of TILE) is masked in the kernel.
//
// Shared helpers (constants, the Loeffler pass, block loads, dequantize,
// the 2-pass IDCT, BT.601, the chroma index and the RGB store loop) live
// in decode_common.cuh, with the reasons for their wrap-around uint32_t
// arithmetic.

#include "decode_common.cuh"

namespace {

// Dequantize + 2-pass IDCT + clamp of block (m, s); spat[px*8 + py].
template <typename T, int G>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ qpool, int num_q, long long m, int s,
    int32_t (&spat)[64]) {
  uint32_t deq[64];
  dequant_block<T, G>(coeffs, qidx, qpool, num_q, m, s, deq);
  idct_block(deq, spat);
}

// Scaled decode (ops/specs.py "Reduced (scaled) IDCT"): a matrix IDCT of
// the top-left NY x NX frequencies, both passes by the rounded basis of
// specs.reduced_idct_matrix, also for NY or NX == 8 (not the Loeffler
// butterfly), descaled by CONST_BITS -/+ PASS1_BITS (no "+3").
// basis<N>(k, u) = round(0.5 * C_u * cos((2k + 1) u pi / 2N) * 2^13).
template <int N>
__device__ __forceinline__ uint32_t basis(int k, int u) {
  constexpr int32_t b1[1][1] = {{2896}};
  constexpr int32_t b2[2][2] = {{2896, 2896}, {2896, -2896}};
  constexpr int32_t b4[4][4] = {{2896, 3784, 2896, 1567},
                                {2896, 1567, -2896, -3784},
                                {2896, -1567, -2896, 3784},
                                {2896, -3784, 2896, -1567}};
  constexpr int32_t b8[8][8] = {
      {2896, 4017, 3784, 3406, 2896, 2276, 1567, 799},
      {2896, 3406, 1567, -799, -2896, -4017, -3784, -2276},
      {2896, 2276, -1567, -4017, -2896, 799, 3784, 3406},
      {2896, 799, -3784, -2276, 2896, 3406, -1567, -4017},
      {2896, -799, -3784, 2276, 2896, -3406, -1567, 4017},
      {2896, -2276, -1567, 4017, -2896, -799, 3784, -3406},
      {2896, -3406, 1567, 799, -2896, 4017, -3784, 2276},
      {2896, -4017, 3784, -3406, 2896, -2276, 1567, -799}};
  static_assert(N == 1 || N == 2 || N == 4 || N == 8, "reduced IDCT size");
  int32_t c;
  if constexpr (N == 1) {
    c = b1[k][u];
  } else if constexpr (N == 2) {
    c = b2[k][u];
  } else if constexpr (N == 4) {
    c = b4[k][u];
  } else {
    c = b8[k][u];
  }
  return static_cast<uint32_t>(c);
}

// One N-point reduced pass (decode_kernel.py:_reduced_pass): o[k] =
// descale(sum_u basis[k][u] * x[u], SHIFT), in wrap-around arithmetic.
template <int N, int SHIFT>
__device__ __forceinline__ void reduced_pass(const uint32_t (&x)[N],
                                             int32_t (&o)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint32_t acc = x[0] * basis<N>(k, 0);
#pragma unroll
    for (int u = 1; u < N; ++u) acc += x[u] * basis<N>(k, u);
    o[k] = sra(acc + (1u << (SHIFT - 1)), SHIFT);
  }
}

// Dequantize + reduced (NY x NX)-point IDCT + clamp of block (m, s):
// spat[px*NY + py] (decode_kernel.py:_reduced_idct_lists + _assemble_pm).
template <typename T, int G, int NY, int NX>
__device__ __forceinline__ void decode_block_reduced(
    const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ qpool, int num_q, long long m, int s,
    int32_t (&spat)[NY * NX]) {
  uint32_t deq[64];
  dequant_block<T, G>(coeffs, qidx, qpool, num_q, m, s, deq);
  // Pass 1 down each of the NX frequency columns: w[py][u].
  int32_t w[NY][NX];
#pragma unroll
  for (int u = 0; u < NX; ++u) {
    uint32_t in[NY];
    int32_t out[NY];
#pragma unroll
    for (int v = 0; v < NY; ++v) in[v] = deq[v * 8 + u];
    reduced_pass<NY, CONST_BITS - PASS1_BITS>(in, out);
#pragma unroll
    for (int r = 0; r < NY; ++r) w[r][u] = out[r];
  }
  // Pass 2 along each spatial row.
#pragma unroll
  for (int r = 0; r < NY; ++r) {
    uint32_t in[NX];
    int32_t out[NX];
#pragma unroll
    for (int u = 0; u < NX; ++u) in[u] = static_cast<uint32_t>(w[r][u]);
    reduced_pass<NX, CONST_BITS + PASS1_BITS>(in, out);
#pragma unroll
    for (int p = 0; p < NX; ++p) {
      spat[p * NY + r] = min(max(out[p], SAMPLE_MIN), SAMPLE_MAX);
    }
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(G * TILE)
ycbcr_kernel(const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
             const int32_t* __restrict__ qpool, int num_q,
             uint8_t* __restrict__ out, long long num_mcus) {
  const int s = threadIdx.x / TILE;
  const long long m =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x % TILE;
  if (m >= num_mcus) return;
  int32_t spat[64];
  decode_block<T, G>(coeffs, qidx, qpool, num_q, m, s, spat);
  uint8_t* dst = out + static_cast<size_t>(s) * 64 * num_mcus + m;
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    dst[static_cast<size_t>(k) * num_mcus] =
        static_cast<uint8_t>(spat[k] + 128);
  }
}

template <typename T, int H, int V, int NC>
__global__ void __launch_bounds__((NC == 1 ? 1 : H * V + 2) * TILE)
rgb_kernel(const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
           const int32_t* __restrict__ qpool, int num_q,
           uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  constexpr int G = NC == 1 ? 1 : GY + 2;
  __shared__ int8_t samples[G * 64 * TILE];   // [slot][pixel][MCU]

  const int ml = threadIdx.x % TILE;
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE;
  if (m0 + ml < num_mcus) {
    const int s = threadIdx.x / TILE;
    int32_t spat[64];
    decode_block<T, G>(coeffs, qidx, qpool, num_q, m0 + ml, s, spat);
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      samples[(s * 64 + k) * TILE + ml] = static_cast<int8_t>(spat[k]);
    }
  }
  __syncthreads();

  store_rgb<GY, 64, TILE, G * TILE>(
      out, m0, num_mcus,
      [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
        const int32_t y = samples[(sl * 64 + pix) * TILE + mj];
        if (NC == 1) {
          r = g = b = static_cast<uint8_t>(y + 128);
        } else {
          const int c = chroma_pix<H, V>(sl, pix);
          bt601(y, samples[(GY * 64 + c) * TILE + mj],
                samples[((GY + 1) * 64 + c) * TILE + mj], r, g, b);
        }
      });
}

// Scaled decode at 1/(8/N): the same thread layout and shared-memory
// staging as rgb_kernel.  A luma thread takes the N-point reduced IDCT of
// its block (n*n samples); a chroma thread the (V*N) x (H*N)-point one,
// since a chroma block covers V x H luma blocks: no upsampling at scale
// >= 2, each luma slot (qv, qh) reads its N x N region.  Output
// [3, GY, N*N, M], pixels column-major (px*N + py).
template <typename T, int H, int V, int NC, int N>
__global__ void __launch_bounds__((NC == 1 ? 1 : H * V + 2) * TILE)
rgb_scaled_kernel(const T* __restrict__ coeffs,
                  const int32_t* __restrict__ qidx,
                  const int32_t* __restrict__ qpool, int num_q,
                  uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  constexpr int G = NC == 1 ? 1 : GY + 2;
  constexpr int NN = N * N;
  constexpr int CY = V * N, CX = H * N;     // chroma rows, columns
  constexpr int CNN = CY * CX;
  // [luma slot][NN pixels][MCU], then [Cb, Cr][CNN pixels][MCU].
  __shared__ int8_t samples[(GY * NN + (G - GY) * CNN) * TILE];

  const int ml = threadIdx.x % TILE;
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE;
  if (m0 + ml < num_mcus) {
    const int s = threadIdx.x / TILE;
    if (s < GY) {
      int32_t spat[NN];
      decode_block_reduced<T, G, N, N>(coeffs, qidx, qpool, num_q, m0 + ml,
                                       s, spat);
#pragma unroll
      for (int k = 0; k < NN; ++k) {
        samples[(s * NN + k) * TILE + ml] = static_cast<int8_t>(spat[k]);
      }
    } else {
      int32_t spat[CNN];
      decode_block_reduced<T, G, CY, CX>(coeffs, qidx, qpool, num_q,
                                         m0 + ml, s, spat);
      const int base = GY * NN + (s - GY) * CNN;
#pragma unroll
      for (int k = 0; k < CNN; ++k) {
        samples[(base + k) * TILE + ml] = static_cast<int8_t>(spat[k]);
      }
    }
  }
  __syncthreads();

  store_rgb<GY, NN, TILE, G * TILE>(
      out, m0, num_mcus,
      [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
        const int32_t y = samples[(sl * NN + pix) * TILE + mj];
        if (NC == 1) {
          r = g = b = to_u8(y + 128);
        } else {
          const int row = (sl / H) * N + pix % N;
          const int col = (sl % H) * N + pix / N;
          const int cpix = GY * NN + col * CY + row;
          bt601(y, samples[cpix * TILE + mj],
                samples[(cpix + CNN) * TILE + mj], r, g, b);
        }
      });
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

template <typename T>
using KernelFn = void (*)(const T*, const int32_t*, const int32_t*, int,
                          uint8_t*, long long);

template <typename T, int H, int V, int NC>
bool launch(const Args& a, bool ycbcr, int scale) {
  constexpr int G = NC == 1 ? 1 : H * V + 2;
  KernelFn<T> kernel;
  if (ycbcr) {
    if (scale != 1) return false;
    kernel = ycbcr_kernel<T, G>;
  } else if (scale == 1) {
    kernel = rgb_kernel<T, H, V, NC>;
  } else if (scale == 2) {
    kernel = rgb_scaled_kernel<T, H, V, NC, 4>;
  } else if (scale == 4) {
    kernel = rgb_scaled_kernel<T, H, V, NC, 2>;
  } else if (scale == 8) {
    kernel = rgb_scaled_kernel<T, H, V, NC, 1>;
  } else {
    return false;
  }
  kernel<<<grid(a.num_mcus, TILE), G * TILE, 0, a.stream>>>(
      static_cast<const T*>(a.coeffs), a.qidx, a.qpool, a.num_q, a.out,
      a.num_mcus);
  return true;
}

template <typename T>
bool dispatch_mode(const Args& a, int h, int v, int ncomp, bool ycbcr,
                   int scale) {
  if (ncomp == 1 && h == 1 && v == 1) {
    return launch<T, 1, 1, 1>(a, ycbcr, scale);
  } else if (ncomp == 3 && h == 1 && v == 1) {
    return launch<T, 1, 1, 3>(a, ycbcr, scale);
  } else if (ncomp == 3 && h == 2 && v == 1) {
    return launch<T, 2, 1, 3>(a, ycbcr, scale);
  } else if (ncomp == 3 && h == 1 && v == 2) {
    return launch<T, 1, 2, 3>(a, ycbcr, scale);
  } else if (ncomp == 3 && h == 2 && v == 2) {
    return launch<T, 2, 2, 3>(a, ycbcr, scale);
  }
  return false;
}

int decode(const void* coeffs, int wire_bytes, const void* qidx,
           const void* qpool, int num_q, void* out, long long num_mcus,
           int h, int v, int ncomp, void* stream, bool ycbcr, int scale) {
  if (num_mcus <= 0 || num_q <= 0) return cudaErrorInvalidValue;
  const Args a{coeffs, static_cast<const int32_t*>(qidx),
               static_cast<const int32_t*>(qpool), num_q,
               static_cast<uint8_t*>(out), num_mcus,
               static_cast<cudaStream_t>(stream)};
  bool ok;
  if (wire_bytes == 2) {
    ok = dispatch_mode<int16_t>(a, h, v, ncomp, ycbcr, scale);
  } else if (wire_bytes == 1) {
    ok = dispatch_mode<int8_t>(a, h, v, ncomp, ycbcr, scale);
  } else {
    ok = false;
  }
  if (!ok) return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes).  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pjt_cuda_decode_rgb(const void* coeffs, int wire_bytes,
                                   const void* qidx, const void* qpool,
                                   int num_q, void* out, long long num_mcus,
                                   int h, int v, int ncomp, void* stream) {
  return decode(coeffs, wire_bytes, qidx, qpool, num_q, out, num_mcus, h, v,
                ncomp, stream, false, 1);
}

extern "C" int pjt_cuda_decode_ycbcr(const void* coeffs, int wire_bytes,
                                     const void* qidx, const void* qpool,
                                     int num_q, void* out, long long num_mcus,
                                     int h, int v, int ncomp, void* stream) {
  return decode(coeffs, wire_bytes, qidx, qpool, num_q, out, num_mcus, h, v,
                ncomp, stream, true, 1);
}

// Scaled decode, scale 2, 4 or 8: output [3, luma_slots, (8/scale)^2, M].
extern "C" int pjt_cuda_decode_rgb_scaled(const void* coeffs, int wire_bytes,
                                          const void* qidx, const void* qpool,
                                          int num_q, void* out,
                                          long long num_mcus, int h, int v,
                                          int ncomp, int scale, void* stream) {
  if (scale == 1) return cudaErrorInvalidValue;
  return decode(coeffs, wire_bytes, qidx, qpool, num_q, out, num_mcus, h, v,
                ncomp, stream, false, scale);
}
