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
// rgb_kernel and ycbcr_kernel (the main path) are tiled; their first form ran
// one thread per whole 8x8 block, which loaded 32 scattered sectors a warp,
// held ~200 live values a thread (88 registers, one 384-thread block an
// SM) and stored bytes.  The redesign (helpers in decode_tile.cuh):
//   - a CUDA block of TILE_THREADS = 256 owns TILE_MCUS = 32 consecutive
//     MCUs, whose wire bytes are one contiguous run; the block copies it
//     into shared memory with 16-byte cp.async copies, lane i on chunk i,
//     each MCU padded by 16 bytes so the column reads below hit 32 banks;
//   - every 8x8 block, luma and chroma, is split over 8 lanes: lane u runs
//     pass 1 down column u (dequantized against qpool[qidx[m]][s], loaded
//     from the pool, which stays in the L2; the next slot's operands are
//     loaded before this slot's arithmetic), the 8 int32 results go through
//     a per-warp transpose scratch (rows of 12 words: conflict-free both
//     ways) and lane r runs pass 2 along row r.  Pass 1 stays int32 and
//     both passes are decode_common.cuh's idct_1d, unchanged;
//   - samples park in shared memory as [slot][pixel][MCU] int8 (rows of 48
//     bytes: the 8 lanes of a block write 8 banks); after one
//     __syncthreads each output row of the tile (T contiguous bytes of one
//     plane) is written 16 bytes a lane (YCbCr: sample ^ 0x80, which is
//     sample + 128; gray RGB: the same to three planes).  The colour RGB
//     kernel takes one chroma pixel of 8 MCUs a lane: its three BT.601
//     terms once (bt601's arithmetic), then each of the H*V luma pixels
//     that sample serves, 8 bytes a plane (4 lanes fill a row's 32 bytes,
//     so warp stores still write whole sectors);
//   - vector stores need every output row 16-byte aligned, i.e. M % 16 ==
//     0 (and an aligned output): the launch picks the VEC16 kernel then,
//     else the byte-store form (store_rgb, the MCU index fastest across a
//     warp), which also masks the ragged last tile.
// The chroma IDCT is taken at chroma resolution and indexed per luma
// pixel (chroma_pix): bit-identical to the TPU kernel's row/column
// selection between passes, since replication commutes with the separable
// passes and with the element-wise colour terms.
//
// Sizing for the card (132 SMs, 228 KB of shared memory an SM): dynamic
// shared memory is 13,312 B of transpose scratch + 32 MCUs of wire + g*64
// sample rows + 128 B, from 19,072 B (gray, int8) to 56,960 B (4:2:0,
// int16); launch bounds ask for 4 blocks an SM (at most 64 registers), and
// prepare() lifts the dynamic limit and asks for the largest shared-memory
// carveout.  A 16,384-MCU launch is 512 blocks, one wave of 4-8 blocks
// (32-64 warps) an SM.  ptxas and the occupancy calculator on an H100
// (chip_smoke.py phase 4; int8 [int16]): rgb_kernel 31 [24] registers,
// 8 blocks/SM gray; 48 [48], 5 at 4:4:4; 55 [55], 4 at 4:2:2 and 4:4:0;
// 64 [64], 4 at 4:2:0.  ycbcr_kernel 31 [24], 8 gray; 48 [48], 5 at 4:4:4;
// 56 [56], 4 at g = 4 and 4:2:0.  No spills.
//
// What bounds them on an H100 80GB HBM3 at 700 W (PERF.md): neither
// bytes nor the integer rate alone.  At 4:2:0, M=16,384, int8: rgb_kernel
// 19.0 us against a 6.2 us bound (its operations at half the float32
// rate) and 7.1 us of SASS issue (452 warp instructions an MCU at one a
// clock per scheduler); ycbcr_kernel 15.9 us against 3.8 us (bytes) and
// 4.9 us of issue.  One wave runs load, decode and store one after
// another and the decode keeps about a third of the issue slots busy
// (latency of the barriers, the shared-memory transposes and the L2
// quantizer loads at 32 warps an SM).  At M=196,608 the waves overlap:
// 142 and 108 us, 52% and 42% of the bounds.

// Shared helpers (constants, the Loeffler pass, dequantize, BT.601, the
// chroma index and the byte store loop) live in decode_common.cuh, with
// the reasons for their wrap-around uint32_t arithmetic; rgb_scaled_kernel
// keeps the per-thread form (a thread per 8x8 block, TILE = 64 MCUs).

#include "decode_common.cuh"
#include "decode_tile.cuh"

namespace {

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

template <typename T, int G, bool VEC16>
__global__ void __launch_bounds__(TILE_THREADS, TILE_MIN_BLOCKS)
ycbcr_kernel(const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
             const int32_t* __restrict__ qpool, int num_q,
             uint8_t* __restrict__ out, long long num_mcus) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int8_t* samples =
      reinterpret_cast<const int8_t*>(smem + TileLayout<T, G>::kSamples);
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE_MCUS;
  const int valid = tile_valid(m0, num_mcus);
  load_tile<T, G>(coeffs, qidx, num_q, m0, valid, smem);
  decode_tile<T, G>(qpool, smem);
  __syncthreads();

  if (VEC16) {
    for_each_piece<G * 64, VEC>(valid, [&](int row, int c16) {
      *reinterpret_cast<int4*>(out + static_cast<size_t>(row) * num_mcus +
                               m0 + c16) =
          level_shift16(load16(samples + row * SAMPLE_ROW + c16));
    });
  } else {
    for (int j = threadIdx.x; j < G * 64 * TILE_MCUS; j += TILE_THREADS) {
      const int mj = j % TILE_MCUS;
      const int row = j / TILE_MCUS;
      if (mj < valid) {
        out[static_cast<size_t>(row) * num_mcus + m0 + mj] =
            static_cast<uint8_t>(samples[row * SAMPLE_ROW + mj] ^ 0x80);
      }
    }
  }
}

template <typename T, int H, int V, int NC, bool VEC16>
__global__ void __launch_bounds__(TILE_THREADS, TILE_MIN_BLOCKS)
rgb_kernel(const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
           const int32_t* __restrict__ qpool, int num_q,
           uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  constexpr int G = NC == 1 ? 1 : GY + 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const int8_t* samples =
      reinterpret_cast<const int8_t*>(smem + TileLayout<T, G>::kSamples);
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE_MCUS;
  const int valid = tile_valid(m0, num_mcus);
  load_tile<T, G>(coeffs, qidx, num_q, m0, valid, smem);
  decode_tile<T, G>(qpool, smem);
  __syncthreads();

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
    // Chroma pixel c of 8 MCUs a lane: its terms once, then the H*V luma
    // pixels it serves, 8 bytes a plane each (four lanes fill a row's 32
    // bytes, so every warp store still writes whole sectors).
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
  bool vec16;   // every output row 16-byte aligned: the tile kernels' stores
};

template <typename T>
using KernelFn = void (*)(const T*, const int32_t*, const int32_t*, int,
                          uint8_t*, long long);

// Let a tile kernel have its dynamic shared memory and the largest
// shared-memory carveout, so that TILE_MIN_BLOCKS blocks fit an SM.
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

// A full-scale tile kernel and its dynamic shared memory, prepared once
// per instantiation.
template <typename T, int H, int V, int NC, bool YCBCR, bool VEC16>
cudaError_t tile_kernel(KernelFn<T>& fn, int& smem) {
  constexpr int G = NC == 1 ? 1 : H * V + 2;
  if constexpr (YCBCR) {
    fn = ycbcr_kernel<T, G, VEC16>;
  } else {
    fn = rgb_kernel<T, H, V, NC, VEC16>;
  }
  smem = TileLayout<T, G>::kBytes;
  static const cudaError_t ready =
      prepare(reinterpret_cast<const void*>(fn), smem);
  return ready;
}

template <typename T, int H, int V, int NC>
cudaError_t pick_tile_kernel(bool ycbcr, bool vec16, KernelFn<T>& fn,
                             int& smem) {
  if (ycbcr) {
    return vec16 ? tile_kernel<T, H, V, NC, true, true>(fn, smem)
                 : tile_kernel<T, H, V, NC, true, false>(fn, smem);
  }
  return vec16 ? tile_kernel<T, H, V, NC, false, true>(fn, smem)
               : tile_kernel<T, H, V, NC, false, false>(fn, smem);
}

template <typename T, int H, int V, int NC>
int launch(const Args& a, bool ycbcr, int scale) {
  constexpr int G = NC == 1 ? 1 : H * V + 2;
  const T* coeffs = static_cast<const T*>(a.coeffs);
  KernelFn<T> kernel;
  if (scale == 1) {
    int smem;
    const cudaError_t e =
        pick_tile_kernel<T, H, V, NC>(ycbcr, a.vec16, kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid(a.num_mcus, TILE_MCUS), TILE_THREADS, smem, a.stream>>>(
        coeffs, a.qidx, a.qpool, a.num_q, a.out, a.num_mcus);
    return cudaGetLastError();
  }
  if (ycbcr) {
    return cudaErrorInvalidValue;
  } else if (scale == 2) {
    kernel = rgb_scaled_kernel<T, H, V, NC, 4>;
  } else if (scale == 4) {
    kernel = rgb_scaled_kernel<T, H, V, NC, 2>;
  } else if (scale == 8) {
    kernel = rgb_scaled_kernel<T, H, V, NC, 1>;
  } else {
    return cudaErrorInvalidValue;
  }
  kernel<<<grid(a.num_mcus, TILE), G * TILE, 0, a.stream>>>(
      coeffs, a.qidx, a.qpool, a.num_q, a.out, a.num_mcus);
  return cudaGetLastError();
}

template <int H, int V, int NC>
struct Mode {
  static constexpr int h = H, v = V, nc = NC;
};

// f(Mode<h, v, ncomp>{}) for the five sampling modes; f(T{}) for the two
// wires.
template <typename F>
int dispatch_mode(int h, int v, int ncomp, F f) {
  if (ncomp == 1 && h == 1 && v == 1) return f(Mode<1, 1, 1>{});
  if (ncomp == 3 && h == 1 && v == 1) return f(Mode<1, 1, 3>{});
  if (ncomp == 3 && h == 2 && v == 1) return f(Mode<2, 1, 3>{});
  if (ncomp == 3 && h == 1 && v == 2) return f(Mode<1, 2, 3>{});
  if (ncomp == 3 && h == 2 && v == 2) return f(Mode<2, 2, 3>{});
  return cudaErrorInvalidValue;
}

template <typename F>
int dispatch_wire(int wire_bytes, F f) {
  if (wire_bytes == 2) return f(int16_t{});
  if (wire_bytes == 1) return f(int8_t{});
  return cudaErrorInvalidValue;
}

int decode(const void* coeffs, int wire_bytes, const void* qidx,
           const void* qpool, int num_q, void* out, long long num_mcus,
           int h, int v, int ncomp, void* stream, bool ycbcr, int scale) {
  if (num_mcus <= 0 || num_q <= 0) return cudaErrorInvalidValue;
  const Args a{coeffs, static_cast<const int32_t*>(qidx),
               static_cast<const int32_t*>(qpool), num_q,
               static_cast<uint8_t*>(out), num_mcus,
               static_cast<cudaStream_t>(stream),
               num_mcus % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(out) % VEC == 0};
  return dispatch_wire(wire_bytes, [&](auto wire) {
    using T = decltype(wire);
    return dispatch_mode(h, v, ncomp, [&](auto mode) {
      using M = decltype(mode);
      return launch<T, M::h, M::v, M::nc>(a, ycbcr, scale);
    });
  });
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

// The full-scale tile kernel a decode launches (ycbcr or RGB; with the
// 16-byte stores or the byte stores): its dynamic shared memory in
// *smem_bytes and the blocks of TILE_THREADS an SM holds in
// *blocks_per_sm (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int pjt_cuda_decode_occupancy(int wire_bytes, int h, int v,
                                         int ncomp, int ycbcr, int vec16,
                                         int* blocks_per_sm,
                                         int* smem_bytes) {
  return dispatch_wire(wire_bytes, [&](auto wire) {
    using T = decltype(wire);
    return dispatch_mode(h, v, ncomp, [&](auto mode) {
      using M = decltype(mode);
      KernelFn<T> kernel;
      int smem = 0;
      cudaError_t e = pick_tile_kernel<T, M::h, M::v, M::nc>(
          ycbcr != 0, vec16 != 0, kernel, smem);
      if (e == cudaSuccess) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, kernel, TILE_THREADS, smem);
      }
      *smem_bytes = smem;
      return static_cast<int>(e);
    });
  });
}
