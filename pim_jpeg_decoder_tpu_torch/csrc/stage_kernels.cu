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
//   - IDCT: every 8x8 block is split over 8 lanes, as the fused tile
//     kernels split it (decode_tile.cuh): lane i loads row v = i of its
//     block (16 bytes; a warp's 4 blocks are 512 contiguous bytes), parks
//     it in a per-block int16 scratch and reads column u = i back, runs
//     pass 1 down it, parks the 8 int32 results in decode_tile.cuh's
//     transpose scratch (XPOSE_ROW rows), reads spatial row r = i back and
//     runs pass 2 along it.  Lane i then holds exactly row r of the
//     row-major output: one 16-byte store, a block's 8 lanes its 128
//     contiguous bytes.  Both scratches are conflict-free both ways (a
//     block's input rows take 36 words: the 4 blocks of a warp start 4
//     banks apart).  A 16,384-MCU launch is 786,432 threads, about three
//     waves, where one thread per block made one partial wave that waited
//     on its 8 serial loads;
//   - colour: a CUDA block copies the contiguous samples of its
//     COLOR_TILE MCUs into shared memory with 16-byte cp.async copies (each
//     slot padded to 36 words, 8 more words after every run of 8 MCUs, so
//     that the reads below fall on distinct banks), then a lane takes one
//     pixel position of one run of 8 MCUs: in colour modes a chroma pixel,
//     its three BT.601 chroma terms once (chroma_terms, bt601's wrap-around
//     arithmetic on any int16 sample) and then the H*V luma pixels it
//     serves; in gray one luma pixel.  Each output row gets 8 bytes a lane
//     and plane (4 lanes fill the 32 bytes of a row's tile: whole sectors)
//     when M % 8 == 0 and the output is 8-byte aligned; else the same lanes
//     store byte by byte (the VEC8 = false instantiation).  Samples stay
//     int16 in shared memory: the stage takes any int16 sample, not only
//     the IDCT's [-128, 127].
// The ragged end (M not a multiple of the tile) is masked in the kernels.
//
// On an H100 80GB HBM3 at 700 W (PERF.md): the
// IDCT kernel has 26 registers and 17,920 B of shared memory, 8 blocks an
// SM; 4:2:0, M=16,384, int16 it takes 12.0-12.2 us (61% of its 7.51 us
// byte bound), at M=196,608 104.6 us (86%).  The 4:2:0 colour kernel has
// 60 registers (48 with byte stores) and 27,776 B, 4 blocks an SM: 14.0-
// 14.4 us (53%) and 122.9 us (73%): at M=16,384 its 512 tiles are one
// wave that loads, then computes and stores, with nothing to overlap.

#include "decode_common.cuh"
#include "decode_tile.cuh"

namespace {

constexpr int DEQ_THREADS = 256;   // dequantize: threads per CUDA block
constexpr int DEQ_UNROLL = 4;      // 16-byte output vectors per thread
constexpr int IDCT_THREADS = 256;  // IDCT: threads per CUDA block
constexpr int IDCT_BLOCKS = IDCT_THREADS / 8;   // 8x8 blocks per CUDA block
constexpr int IN_BLOCK = 36;       // words of a block's input transpose
constexpr int COLOR_TILE = 32;     // colour: MCUs per CUDA block
constexpr int COLOR_THREADS = 256; // 64 pixel positions x 4 runs of 8 MCUs
constexpr int SLOT_WORDS = 36;     // a slot's 64 int16 samples + 4 words
constexpr int RUN_PAD = 8;         // words after each run of 8 MCUs

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

// Block blk of the launch on 8 lanes; lane i loads input row v = i and
// stores output row r = i.  Lanes past the end re-read the last block and
// store nothing, so that every lane reaches the __syncwarp()s.
__global__ void __launch_bounds__(IDCT_THREADS)
idct_stage_kernel(const int16_t* __restrict__ deq,
                  int16_t* __restrict__ out, long long num_blocks) {
  __shared__ __align__(16) uint32_t rows_in[IDCT_BLOCKS * IN_BLOCK];
  __shared__ __align__(16) int32_t xpose[IDCT_BLOCKS * XPOSE_BLOCK];
  const int i = threadIdx.x & 7;
  const int bj = threadIdx.x >> 3;
  const long long blk =
      static_cast<long long>(blockIdx.x) * IDCT_BLOCKS + bj;
  const bool valid = blk < num_blocks;
  const size_t at = static_cast<size_t>(valid ? blk : num_blocks - 1) * 64 +
                    i * 8;
  uint32_t* t = rows_in + bj * IN_BLOCK;
  *reinterpret_cast<int4*>(t + i * 4) =
      __ldg(reinterpret_cast<const int4*>(deq + at));
  __syncwarp();
  // Pass 1 down column u = i (natural order v*8 + u).
  const int16_t* th = reinterpret_cast<const int16_t*>(t);
  uint32_t x[8];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    x[v] = static_cast<uint32_t>(static_cast<int32_t>(th[v * 8 + i]));
  }
  int32_t o[8];
  idct_1d<CONST_BITS - PASS1_BITS>(x, o);
  int32_t* xp = xpose + bj * XPOSE_BLOCK;
#pragma unroll
  for (int r = 0; r < 8; ++r) xp[r * XPOSE_ROW + i] = o[r];
  __syncwarp();
  // Pass 2 along spatial row r = i: output r*8 + p (_assemble's order).
  const int4 lo = *reinterpret_cast<const int4*>(xp + i * XPOSE_ROW);
  const int4 hi = *reinterpret_cast<const int4*>(xp + i * XPOSE_ROW + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  idct_1d<CONST_BITS + PASS1_BITS + 3>(x, o);
  if (valid) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a = static_cast<uint32_t>(
          min(max(o[2 * j], SAMPLE_MIN), SAMPLE_MAX));
      const uint32_t b = static_cast<uint32_t>(
          min(max(o[2 * j + 1], SAMPLE_MIN), SAMPLE_MAX));
      w[j] = (a & 0xffffu) | (b << 16);
    }
    *reinterpret_cast<int4*>(out + at) =
        make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                  static_cast<int>(w[2]), static_cast<int>(w[3]));
  }
}

// The colour stage's shared tile: COLOR_TILE MCUs of G slots, each slot's
// 8 rows of 8 int16 samples in 32 words then 4 words of padding, and
// RUN_PAD words after every 8 MCUs.  A warp reads one pixel row (one
// sample position of each lane's 8 columns) of 4 runs: the slot padding
// puts the two luma slots a chroma row serves 4 banks apart, the run
// padding puts the runs 8 banks apart, so no two words collide.
template <int G>
struct ColorTile {
  static constexpr int kMcuWords = G * SLOT_WORDS;
  static constexpr int kWords =
      COLOR_TILE * kMcuWords + (COLOR_TILE / 8) * RUN_PAD;
};

template <int H, int V, int NC, bool VEC8>
__global__ void __launch_bounds__(COLOR_THREADS)
color_stage_kernel(const int16_t* __restrict__ spat,
                   uint8_t* __restrict__ out, long long num_mcus) {
  constexpr int GY = H * V;
  constexpr int G = NC == 1 ? 1 : GY + 2;
  using L = ColorTile<G>;
  __shared__ __align__(16) uint32_t tile[L::kWords];

  const long long m0 = static_cast<long long>(blockIdx.x) * COLOR_TILE;
  const long long left = num_mcus - m0;
  const int valid = left < COLOR_TILE ? static_cast<int>(left) : COLOR_TILE;
  // The tile's samples are one contiguous run of valid * G * 128 bytes;
  // chunk k (16 bytes: slot s, row r of MCU mj) goes to its padded place.
  constexpr int kChunks = G * 8;
  constexpr int kRounds =
      (COLOR_TILE * kChunks + COLOR_THREADS - 1) / COLOR_THREADS;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(spat) +
                       static_cast<size_t>(m0) * G * 128;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = k * COLOR_THREADS + threadIdx.x;
    if (c < valid * kChunks) {
      const int mj = c / kChunks, sr = c % kChunks;
      __pipeline_memcpy_async(
          tile + mj * L::kMcuWords + (mj >> 3) * RUN_PAD +
              (sr >> 3) * SLOT_WORDS + (sr & 7) * 4,
          src + static_cast<size_t>(c) * VEC, VEC);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Lane: pixel column col and row row (one row a warp) of run `run`.
  const int col = threadIdx.x & 7;
  const int run = (threadIdx.x >> 3) & 3;
  const int row = threadIdx.x >> 5;
  const int c8 = run * 8;
  if (c8 >= valid) return;
  const int n = VEC8 ? 8 : min(valid - c8, 8);
  const int16_t* base = reinterpret_cast<const int16_t*>(
      tile + c8 * L::kMcuWords + run * RUN_PAD);
  // Sample h (r*8 + p) of slot s of the run's MCU j.
  auto sample = [&](int j, int s, int h) -> int32_t {
    return base[j * 2 * L::kMcuWords + s * 2 * SLOT_WORDS + h];
  };
  const size_t plane = static_cast<size_t>(GY) * 64 * num_mcus;
  // Output row lr (slot*64 + px*8 + py) of the run's 8 MCUs, 3 planes.
  auto put = [&](int lr, const uint8_t(&r)[8], const uint8_t(&g)[8],
                 const uint8_t(&b)[8]) {
    uint8_t* d = out + static_cast<size_t>(lr) * num_mcus + m0 + c8;
    if (VEC8) {
      *reinterpret_cast<uint2*>(d) = pack8(r);
      *reinterpret_cast<uint2*>(d + plane) = pack8(g);
      *reinterpret_cast<uint2*>(d + 2 * plane) = pack8(b);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < n) {
          d[j] = r[j];
          d[plane + j] = g[j];
          d[2 * plane + j] = b[j];
        }
      }
    }
  };
  if constexpr (NC == 1) {
    uint8_t y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = to_u8(sample(j, 0, row * 8 + col) + 128);
    put(col * 8 + row, y, y, y);
  } else {
    // Chroma pixel col*8 + row: its terms once, then the GY luma pixels
    // whose nearest chroma sample it is.
    int32_t tr[8], tg[8], tb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      chroma_terms(sample(j, GY, row * 8 + col),
                   sample(j, GY + 1, row * 8 + col), tr[j], tg[j], tb[j]);
    }
#pragma unroll
    for (int k = 0; k < GY; ++k) {
      const int lr = luma_of_chroma<H, V>(col * 8 + row, k);
      const int sl = lr >> 6, px = (lr >> 3) & 7, py = lr & 7;
      uint8_t r[8], g[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int32_t y128 = sample(j, sl, py * 8 + px) + 128;
        r[j] = to_u8(y128 + tr[j]);
        g[j] = to_u8(y128 + tg[j]);
        b[j] = to_u8(y128 + tb[j]);
      }
      put(lr, r, g, b);
    }
  }
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

// The largest shared-memory carveout for a kernel, asked once per kernel
// and device, so that shared memory does not cap the blocks an SM holds (8
// IDCT blocks of 17.9 KB; registers hold the 4:2:0 colour tile, 27.8 KB,
// to 4).
inline cudaError_t max_shared(const void* kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t idct_ready() {
  static PerDevice prepared;
  return prepared.get([] {
    return max_shared(reinterpret_cast<const void*>(idct_stage_kernel));
  });
}

template <int H, int V, int NC, bool VEC8>
cudaError_t color_ready() {
  static PerDevice prepared;
  return prepared.get([] {
    return max_shared(
        reinterpret_cast<const void*>(color_stage_kernel<H, V, NC, VEC8>));
  });
}

template <int H, int V, int NC, bool VEC8>
int launch_color(const void* spat, void* out, long long num_mcus,
                 cudaStream_t stream) {
  const cudaError_t ready = color_ready<H, V, NC, VEC8>();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  color_stage_kernel<H, V, NC, VEC8>
      <<<grid(num_mcus, COLOR_TILE), COLOR_THREADS, 0, stream>>>(
          static_cast<const int16_t*>(spat), static_cast<uint8_t*>(out),
          num_mcus);
  return static_cast<int>(cudaGetLastError());
}

template <int H, int V, int NC>
struct ColorMode {
  static constexpr int kH = H, kV = V, kNC = NC;
};

// f(ColorMode<h, v, ncomp>{}) for the five sampling modes.
template <typename F>
int color_mode(int h, int v, int ncomp, F f) {
  if (ncomp == 1 && h == 1 && v == 1) return f(ColorMode<1, 1, 1>{});
  if (ncomp == 3 && h == 1 && v == 1) return f(ColorMode<1, 1, 3>{});
  if (ncomp == 3 && h == 2 && v == 1) return f(ColorMode<2, 1, 3>{});
  if (ncomp == 3 && h == 1 && v == 2) return f(ColorMode<1, 2, 3>{});
  if (ncomp == 3 && h == 2 && v == 2) return f(ColorMode<2, 2, 3>{});
  return cudaErrorInvalidValue;
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

// num_blocks = M * g independent 8x8 blocks (16-byte aligned input and
// output); output int16, row-major.
extern "C" int pjt_cuda_idct_stage(const void* deq, void* out,
                                   long long num_blocks, void* stream) {
  if (num_blocks <= 0) return cudaErrorInvalidValue;
  const cudaError_t ready = idct_ready();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  idct_stage_kernel<<<grid(num_blocks, IDCT_BLOCKS), IDCT_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(deq), static_cast<int16_t*>(out),
      num_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Output uint8 [3, h*v, 64, M] (gray: h = v = 1, the luma in all three);
// the input 16-byte aligned.  8-byte stores when every output row is
// 8-byte aligned, byte stores otherwise.
extern "C" int pjt_cuda_color_stage(const void* spat, void* out,
                                    long long num_mcus, int h, int v,
                                    int ncomp, void* stream) {
  if (num_mcus <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec8 =
      num_mcus % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  return color_mode(h, v, ncomp, [&](auto mode) {
    using M = decltype(mode);
    return vec8 ? launch_color<M::kH, M::kV, M::kNC, true>(spat, out,
                                                           num_mcus, st)
                : launch_color<M::kH, M::kV, M::kNC, false>(spat, out,
                                                            num_mcus, st);
  });
}
