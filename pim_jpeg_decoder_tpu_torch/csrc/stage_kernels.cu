// Unfused stage kernels for Hopper (sm_90a): dequantize, IDCT and
// (nearest-neighbour chroma upsample + BT.601) as three launches, each
// round-tripping device memory, as the reference DPU's three phases do.
//
// Replaces the Pallas kernels of pim_jpeg_decoder_tpu/ops/stage_kernels.py:
//   dequant_stage_kernel <- _dequant_kernel: the [M, g, 64] int8 or int16
//                           wire -> int16 [M, g, 64],
//                           clamp(coeff * qpool[qidx[m]], -32768, 32767)
//   idct_stage_kernel    <- _idct_kernel: int16 [M, g, 64] (v*8 + u) ->
//                           int16 [M, g, 64] samples clamped to [-128, 127],
//                           ROW-major (r*8 + p), as the TPU kernel writes
//   color_stage_kernel   <- _color_kernel: int16 row-major samples ->
//                           uint8 [3, gy, 64, M], pixels COLUMN-major
//                           (px*8 + py): the fused rgb_kernel's raw layout
// Composed, they equal the fused rgb_kernel byte for byte.  They exist for
// the device profile (runtime/device_profile.py: the per-phase times of the
// reference's dequantization / inverse DCT / colour conversion counters)
// and to measure what fusion saves on this card.
//
// What bounds them on an H100: bytes, as for the fused kernels, and three
// times as many of them: each stage reads and writes a whole [M, g, 64]
// array (4:2:0, M=16,384, int16: 12.6 MB in and 12.6 MB out for the first
// two stages).
//   - dequantize is elementwise, so it runs in address order: a lane takes
//     8 consecutive coefficients (one 16-byte load on the int16 wire, 8
//     bytes on int8; one 16-byte store), neighbouring lanes neighbouring
//     addresses, so every load and store instruction of a warp covers
//     whole 128-byte lines.  A thread takes DEQ_UNROLL such vectors a
//     block-stride apart and starts all their coefficient and qidx loads
//     before the first multiply.  A warp's 256 coefficients are 4 blocks of
//     (usually) one MCU, so its qidx load is a broadcast, and its 8
//     quantizers a lane (two 16-byte loads of the int32 pool, 24.6 KB at
//     Q=16 and 4:2:0) come from the L1 after the first touch, never from
//     device memory.  An out-of-range qidx reads row 0 and is masked to a
//     zero quantizer (decode_common.cuh: quant_row explains why the row
//     stays a valid address);
//   - IDCT: one thread per 8x8 block, 16-byte loads and stores of its 128
//     contiguous bytes, neighbouring threads on neighbouring blocks;
//   - colour: a CUDA block copies the contiguous samples of its
//     COLOR_TILE MCUs into shared memory with coalesced 4-byte loads, then
//     computes each output pixel with the MCU index fastest across a warp,
//     so the uint8 stores coalesce.  Rows of the shared tile are padded by
//     one word, so the 32 MCUs a warp reads fall on 32 banks.
// The ragged end (M not a multiple of the tile) is masked in the kernels.

#include "decode_common.cuh"

namespace {

constexpr int DEQ_THREADS = 256;   // dequantize: threads per CUDA block
constexpr int DEQ_UNROLL = 4;      // 16-byte output vectors per thread
constexpr int IDCT_THREADS = 256;  // 8x8 blocks per CUDA block
constexpr int COLOR_TILE = 32;     // MCUs per CUDA block (one warp wide)

// Stores 64 values that fit in int16 at dst (16-byte aligned) with 16-byte
// stores.
template <typename V>
__device__ __forceinline__ void store_block_i16(int16_t* __restrict__ dst,
                                                const V (&v)[64]) {
  int4* vec = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = (static_cast<uint32_t>(v[8 * i + 2 * j]) & 0xffffu) |
             (static_cast<uint32_t>(v[8 * i + 2 * j + 1]) << 16);
    }
    vec[i] = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                       static_cast<int>(w[2]), static_cast<int>(w[3]));
  }
}

// 8 consecutive coefficients at src (16-byte aligned on the int16 wire, 8
// on int8), sign-extended.
template <typename T>
struct Coeffs8;

template <>
struct Coeffs8<int16_t> {
  int4 v;
  __device__ __forceinline__ void load(const int16_t* __restrict__ src) {
    v = __ldg(reinterpret_cast<const int4*>(src));
  }
  __device__ __forceinline__ int32_t at(int j) const {
    return element<int16_t>(v, j);
  }
};

template <>
struct Coeffs8<int8_t> {
  uint2 v;
  __device__ __forceinline__ void load(const int8_t* __restrict__ src) {
    v = __ldg(reinterpret_cast<const uint2*>(src));
  }
  __device__ __forceinline__ int32_t at(int j) const {
    return static_cast<int8_t>((j < 4 ? v.x : v.y) >> ((j & 3) * 8));
  }
};

// Vector i of the launch is coefficients [8i, 8i + 8) of the flat
// [M, G, 64] array: MCU i / (G*8), and entries (i % (G*8)) * 8 onwards of
// that MCU's G*64 quantizers.
template <typename T, int G>
__global__ void __launch_bounds__(DEQ_THREADS)
dequant_stage_kernel(const T* __restrict__ coeffs,
                     const int32_t* __restrict__ qidx,
                     const int32_t* __restrict__ qpool, int num_q,
                     int16_t* __restrict__ out, long long num_vecs) {
  constexpr int PER_MCU = G * 8;   // vectors per MCU
  const long long block0 =
      static_cast<long long>(blockIdx.x) * (DEQ_THREADS * DEQ_UNROLL);
  const long long mcu0 = block0 / PER_MCU;
  const int lane0 = static_cast<int>(block0 % PER_MCU) + threadIdx.x;
  const long long left = num_vecs - block0 - threadIdx.x;

  Coeffs8<T> c[DEQ_UNROLL];
  int qi[DEQ_UNROLL];
#pragma unroll
  for (int u = 0; u < DEQ_UNROLL; ++u) {
    if (u * DEQ_THREADS < left) {
      const int r = lane0 + u * DEQ_THREADS;
      c[u].load(coeffs + (block0 + threadIdx.x + u * DEQ_THREADS) * 8);
      qi[u] = __ldg(qidx + mcu0 + r / PER_MCU);
    }
  }
#pragma unroll
  for (int u = 0; u < DEQ_UNROLL; ++u) {
    if (u * DEQ_THREADS < left) {
      const int r = lane0 + u * DEQ_THREADS;
      const bool ok =
          static_cast<unsigned>(qi[u]) < static_cast<unsigned>(num_q);
      const uint32_t keep = ok ? ~0u : 0u;
      const int4* q = reinterpret_cast<const int4*>(
          qpool + (static_cast<size_t>(ok ? qi[u] : 0) * PER_MCU +
                   r % PER_MCU) * 8);
      const int4 lo = __ldg(q), hi = __ldg(q + 1);
      uint32_t d[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t qv =
            static_cast<uint32_t>(element<int32_t>(j < 4 ? lo : hi, j & 3));
        d[j] = dequant(c[u].at(j), qv & keep) & 0xffffu;
      }
      *reinterpret_cast<int4*>(
          out + (block0 + threadIdx.x + u * DEQ_THREADS) * 8) =
          make_int4(static_cast<int>(d[0] | (d[1] << 16)),
                    static_cast<int>(d[2] | (d[3] << 16)),
                    static_cast<int>(d[4] | (d[5] << 16)),
                    static_cast<int>(d[6] | (d[7] << 16)));
    }
  }
}

__global__ void __launch_bounds__(IDCT_THREADS)
idct_stage_kernel(const int16_t* __restrict__ deq,
                  int16_t* __restrict__ out, long long num_blocks) {
  const long long blk =
      static_cast<long long>(blockIdx.x) * IDCT_THREADS + threadIdx.x;
  if (blk >= num_blocks) return;
  int32_t c[64];
  load_block<int16_t>(deq + static_cast<size_t>(blk) * 64, c);
  uint32_t x[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) x[k] = static_cast<uint32_t>(c[k]);
  int32_t spat[64];   // px*8 + py
  idct_block(x, spat);
  int32_t rows[64];   // r*8 + p (decode_kernel.py:_assemble)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int p = 0; p < 8; ++p) rows[r * 8 + p] = spat[p * 8 + r];
  }
  store_block_i16(out + static_cast<size_t>(blk) * 64, rows);
}

// Sample e (slot*64 + r*8 + p) of one MCU's row in the shared tile.
__device__ __forceinline__ int32_t sample(const uint32_t* mcu, int e) {
  return static_cast<int16_t>(mcu[e >> 1] >> ((e & 1) * 16));
}

template <int H, int V, int NC>
__global__ void __launch_bounds__((NC == 1 ? 1 : H * V + 2) * COLOR_TILE)
color_stage_kernel(const int16_t* __restrict__ spat,
                   uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  constexpr int G = NC == 1 ? 1 : GY + 2;
  constexpr int WORDS = G * 32;          // one MCU's samples, 32-bit words
  constexpr int STRIDE = WORDS + 1;      // padded: one bank per MCU
  __shared__ uint32_t tile[COLOR_TILE * STRIDE];

  const long long m0 = static_cast<long long>(blockIdx.x) * COLOR_TILE;
  const long long left = num_mcus - m0;
  const int valid = left < COLOR_TILE ? static_cast<int>(left) : COLOR_TILE;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(
      spat + static_cast<size_t>(m0) * G * 64);
  for (int i = threadIdx.x; i < valid * WORDS; i += blockDim.x) {
    tile[(i / WORDS) * STRIDE + i % WORDS] = __ldg(src + i);
  }
  __syncthreads();

  store_rgb<GY, 64, COLOR_TILE, G * COLOR_TILE>(
      out, m0, num_mcus,
      [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
        const int px = pix >> 3, py = pix & 7;   // pix = px*8 + py
        const uint32_t* mcu = tile + mj * STRIDE;
        const int32_t y = sample(mcu, sl * 64 + py * 8 + px);
        if (NC == 1) {
          r = g = b = to_u8(y + 128);
        } else {
          // chroma_pix's sample, row-major here: row*8 + col.
          const int c = chroma_pix<H, V>(sl, pix);
          const int rm = (c & 7) * 8 + (c >> 3);
          bt601(y, sample(mcu, GY * 64 + rm), sample(mcu, (GY + 1) * 64 + rm),
                r, g, b);
        }
      });
}

template <typename T, int G>
int launch_dequant(const void* coeffs, const void* qidx, const void* qpool,
                   int num_q, void* out, long long num_mcus,
                   cudaStream_t stream) {
  const long long num_vecs = num_mcus * G * 8;
  dequant_stage_kernel<T, G>
      <<<grid(num_vecs, DEQ_THREADS * DEQ_UNROLL), DEQ_THREADS, 0, stream>>>(
          static_cast<const T*>(coeffs), static_cast<const int32_t*>(qidx),
          static_cast<const int32_t*>(qpool), num_q,
          static_cast<int16_t*>(out), num_vecs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dequant_g(const void* coeffs, const void* qidx, const void* qpool,
              int num_q, void* out, long long num_mcus, int g,
              cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch_dequant<T, 1>(coeffs, qidx, qpool, num_q, out, num_mcus,
                                  stream);
    case 3:
      return launch_dequant<T, 3>(coeffs, qidx, qpool, num_q, out, num_mcus,
                                  stream);
    case 4:
      return launch_dequant<T, 4>(coeffs, qidx, qpool, num_q, out, num_mcus,
                                  stream);
    case 6:
      return launch_dequant<T, 6>(coeffs, qidx, qpool, num_q, out, num_mcus,
                                  stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int dequant_occupancy(int g, int* blocks) {
  const void* kernel = nullptr;
  switch (g) {
    case 1:
      kernel = reinterpret_cast<const void*>(dequant_stage_kernel<T, 1>);
      break;
    case 3:
      kernel = reinterpret_cast<const void*>(dequant_stage_kernel<T, 3>);
      break;
    case 4:
      kernel = reinterpret_cast<const void*>(dequant_stage_kernel<T, 4>);
      break;
    case 6:
      kernel = reinterpret_cast<const void*>(dequant_stage_kernel<T, 6>);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, DEQ_THREADS, 0));
}

template <int H, int V, int NC>
int launch_color(const void* spat, void* out, long long num_mcus,
                 cudaStream_t stream) {
  constexpr int G = NC == 1 ? 1 : H * V + 2;
  color_stage_kernel<H, V, NC>
      <<<grid(num_mcus, COLOR_TILE), G * COLOR_TILE, 0, stream>>>(
          static_cast<const int16_t*>(spat), static_cast<uint8_t*>(out),
          num_mcus);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (bound with ctypes).  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = launched).

// g = blocks per MCU (1, 3, 4 or 6); output int16 [M, g, 64].
extern "C" int pjt_cuda_dequant_stage(const void* coeffs, int wire_bytes,
                                      const void* qidx, const void* qpool,
                                      int num_q, void* out,
                                      long long num_mcus, int g,
                                      void* stream) {
  if (num_mcus <= 0 || num_q <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wire_bytes == 2) {
    return dequant_g<int16_t>(coeffs, qidx, qpool, num_q, out, num_mcus, g,
                              st);
  }
  if (wire_bytes == 1) {
    return dequant_g<int8_t>(coeffs, qidx, qpool, num_q, out, num_mcus, g,
                             st);
  }
  return cudaErrorInvalidValue;
}

// Blocks of the dequantize kernel for this wire and g that one SM holds.
extern "C" int pjt_cuda_dequant_occupancy(int wire_bytes, int g,
                                          int* blocks) {
  if (wire_bytes != 1 && wire_bytes != 2) return cudaErrorInvalidValue;
  return wire_bytes == 2 ? dequant_occupancy<int16_t>(g, blocks)
                         : dequant_occupancy<int8_t>(g, blocks);
}

// num_blocks = M * g independent 8x8 blocks; output int16, row-major.
extern "C" int pjt_cuda_idct_stage(const void* deq, void* out,
                                   long long num_blocks, void* stream) {
  if (num_blocks <= 0) return cudaErrorInvalidValue;
  idct_stage_kernel<<<grid(num_blocks, IDCT_THREADS), IDCT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(deq), static_cast<int16_t*>(out),
      num_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Output uint8 [3, h*v, 64, M] (gray: h = v = 1, the luma in all three).
extern "C" int pjt_cuda_color_stage(const void* spat, void* out,
                                    long long num_mcus, int h, int v,
                                    int ncomp, void* stream) {
  if (num_mcus <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ncomp == 1 && h == 1 && v == 1) {
    return launch_color<1, 1, 1>(spat, out, num_mcus, st);
  } else if (ncomp == 3 && h == 1 && v == 1) {
    return launch_color<1, 1, 3>(spat, out, num_mcus, st);
  } else if (ncomp == 3 && h == 2 && v == 1) {
    return launch_color<2, 1, 3>(spat, out, num_mcus, st);
  } else if (ncomp == 3 && h == 1 && v == 2) {
    return launch_color<1, 2, 3>(spat, out, num_mcus, st);
  } else if (ncomp == 3 && h == 2 && v == 2) {
    return launch_color<2, 2, 3>(spat, out, num_mcus, st);
  }
  return cudaErrorInvalidValue;
}
