// Fused MCU decode kernels for Hopper (sm_90a): dequantize -> 13-bit
// Loeffler IDCT -> (nearest-neighbour chroma upsample + BT.601) -> uint8.
//
// Replaces the two Pallas kernels of the JAX package's main path:
//   rgb_kernel   <- pim_jpeg_decoder_tpu/ops/decode_kernel.py:_make_kernel
//                   (scale == 1), output [3, luma_slots, 64, M]
//   ycbcr_kernel <- pim_jpeg_decoder_tpu/ops/decode_kernel.py:
//                   _make_kernel_ycbcr, output [g, 64, M] (level-shifted)
// Both read the host's [M, g, 64] coefficient wire (int16, or int8 when the
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
// Signed overflow is undefined in C++, while the spec relies on int32
// two's-complement wrap (dequantized coefficients at the DEQUANT_CLAMP
// limits overflow the butterfly).  All adds, multiplies and left shifts
// therefore run on uint32_t; values are cast back to int32_t only for the
// arithmetic right shift of the descale.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // MCUs per CUDA block

// ops/specs.py
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int DEQUANT_CLAMP = 32767;
constexpr int SAMPLE_MIN = -128;
constexpr int SAMPLE_MAX = 127;
constexpr int COLOR_BITS = 16;
constexpr int FIX_CR_R = 91881;
constexpr int FIX_CB_G = -22554;
constexpr int FIX_CR_G = -46802;
constexpr int FIX_CB_B = 116130;

__device__ __forceinline__ int32_t sra(uint32_t v, int shift) {
  return static_cast<int32_t>(v) >> shift;
}

// One 8-point Loeffler pass (ops/idct_math.py:idct_1d) in wrap-around
// arithmetic; outputs descaled by SHIFT with the rounding bias folded in.
template <int SHIFT>
__device__ __forceinline__ void idct_1d(const uint32_t (&x)[8],
                                        int32_t (&o)[8]) {
  const uint32_t half = 1u << (SHIFT - 1);
  // Even part.
  const uint32_t z1e = (x[2] + x[6]) * 4433u;             // FIX_0_541196100
  const uint32_t tmp2 = z1e - x[6] * 15137u;              // FIX_1_847759065
  const uint32_t tmp3 = z1e + x[2] * 6270u;               // FIX_0_765366865
  const uint32_t tmp0 = ((x[0] + x[4]) << CONST_BITS) + half;
  const uint32_t tmp1 = ((x[0] - x[4]) << CONST_BITS) + half;
  const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const uint32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // Odd part.
  uint32_t t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  uint32_t z1 = t0 + t3, z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  const uint32_t z5 = (z3 + z4) * 9633u;                  // FIX_1_175875602
  t0 *= 2446u;                                            // FIX_0_298631336
  t1 *= 16819u;                                           // FIX_2_053119869
  t2 *= 25172u;                                           // FIX_3_072711026
  t3 *= 12299u;                                           // FIX_1_501321110
  z1 *= static_cast<uint32_t>(-7373);                     // FIX_0_899976223
  z2 *= static_cast<uint32_t>(-20995);                    // FIX_2_562915447
  z3 *= static_cast<uint32_t>(-16069);                    // FIX_1_961570560
  z4 *= static_cast<uint32_t>(-3196);                     // FIX_0_390180644
  z3 += z5;
  z4 += z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = sra(tmp10 + t3, SHIFT);
  o[1] = sra(tmp11 + t2, SHIFT);
  o[2] = sra(tmp12 + t1, SHIFT);
  o[3] = sra(tmp13 + t0, SHIFT);
  o[4] = sra(tmp13 - t0, SHIFT);
  o[5] = sra(tmp12 - t1, SHIFT);
  o[6] = sra(tmp11 - t2, SHIFT);
  o[7] = sra(tmp10 - t3, SHIFT);
}

// Element j of the 16 bytes in v as a sign-extended T (j < 16 / sizeof(T)).
template <typename T>
__device__ __forceinline__ int32_t element(const int4& v, int j) {
  constexpr int per_word = 4 / sizeof(T);
  const int wi = j / per_word;
  const uint32_t word = static_cast<uint32_t>(
      wi == 0 ? v.x : wi == 1 ? v.y : wi == 2 ? v.z : v.w);
  return static_cast<T>(word >> ((j % per_word) * 8 * sizeof(T)));
}

// Dequantize + 2-pass IDCT + clamp of block (m, s); spat[px*8 + py].
// An out-of-range qidx decodes against a zero quantizer (as the TPU
// kernel's one-hot gather does) instead of reading out of bounds.
template <typename T, int G>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ qpool, int num_q, long long m, int s,
    int32_t (&spat)[64]) {
  constexpr int per_vec = 16 / sizeof(T);
  const int4* src = reinterpret_cast<const int4*>(
      coeffs + (static_cast<size_t>(m) * G + s) * 64);
  int32_t c[64];
#pragma unroll
  for (int i = 0; i < 64 / per_vec; ++i) {
    const int4 v = __ldg(src + i);
#pragma unroll
    for (int j = 0; j < per_vec; ++j) c[i * per_vec + j] = element<T>(v, j);
  }
  const int qi = __ldg(qidx + m);
  const bool q_ok = static_cast<unsigned>(qi) < static_cast<unsigned>(num_q);
  const int4* qrow = reinterpret_cast<const int4*>(
      qpool + (static_cast<size_t>(q_ok ? qi : 0) * G + s) * 64);

  uint32_t deq[64];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int4 q = q_ok ? __ldg(qrow + i) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * i + j;
      const uint32_t qk = static_cast<uint32_t>(element<int32_t>(q, j));
      int32_t d = static_cast<int32_t>(static_cast<uint32_t>(c[k]) * qk);
      d = min(max(d, -DEQUANT_CLAMP - 1), DEQUANT_CLAMP);
      deq[k] = static_cast<uint32_t>(d);
    }
  }

  // Pass 1 down each column of vertical frequencies: w[py*8 + u].
  int32_t w[64];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    uint32_t in[8];
    int32_t out[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) in[v] = deq[v * 8 + u];
    idct_1d<CONST_BITS - PASS1_BITS>(in, out);
#pragma unroll
    for (int r = 0; r < 8; ++r) w[r * 8 + u] = out[r];
  }
  // Pass 2 along each spatial row: spat[px*8 + py], clamped.
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t in[8];
    int32_t out[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) in[u] = static_cast<uint32_t>(w[r * 8 + u]);
    idct_1d<CONST_BITS + PASS1_BITS + 3>(in, out);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      spat[p * 8 + r] = min(max(out[p], SAMPLE_MIN), SAMPLE_MAX);
    }
  }
}

__device__ __forceinline__ uint8_t to_u8(int32_t v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

__device__ __forceinline__ int32_t descale_color(int32_t x) {
  return (x + (1 << (COLOR_BITS - 1))) >> COLOR_BITS;
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

  const long long left = num_mcus - m0;
  const int valid = left < TILE ? static_cast<int>(left) : TILE;
  const size_t plane = static_cast<size_t>(GY) * 64 * num_mcus;
  for (int j = threadIdx.x; j < GY * 64 * TILE; j += G * TILE) {
    const int mj = j % TILE;
    if (mj >= valid) continue;
    const int pix = (j / TILE) % 64;
    const int sl = j / (TILE * 64);
    const int32_t y128 = samples[(sl * 64 + pix) * TILE + mj] + 128;
    uint8_t r, g, b;
    if (NC == 1) {
      r = g = b = static_cast<uint8_t>(y128);
    } else {
      const int px = pix >> 3, py = pix & 7;
      const int row = (sl / H) * (8 / V) + py / V;
      const int col = (sl % H) * (8 / H) + px / H;
      const int cpix = col * 8 + row;
      const int32_t cb = samples[(GY * 64 + cpix) * TILE + mj];
      const int32_t cr = samples[((GY + 1) * 64 + cpix) * TILE + mj];
      r = to_u8(y128 + descale_color(FIX_CR_R * cr));
      g = to_u8(y128 + descale_color(FIX_CB_G * cb + FIX_CR_G * cr));
      b = to_u8(y128 + descale_color(FIX_CB_B * cb));
    }
    const size_t o = (static_cast<size_t>(sl) * 64 + pix) * num_mcus + m0 + mj;
    out[o] = r;
    out[plane + o] = g;
    out[2 * plane + o] = b;
  }
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

template <typename T, int H, int V, int NC>
void launch(const Args& a, bool ycbcr) {
  constexpr int G = NC == 1 ? 1 : H * V + 2;
  const unsigned blocks =
      static_cast<unsigned>((a.num_mcus + TILE - 1) / TILE);
  const T* coeffs = static_cast<const T*>(a.coeffs);
  if (ycbcr) {
    ycbcr_kernel<T, G><<<blocks, G * TILE, 0, a.stream>>>(
        coeffs, a.qidx, a.qpool, a.num_q, a.out, a.num_mcus);
  } else {
    rgb_kernel<T, H, V, NC><<<blocks, G * TILE, 0, a.stream>>>(
        coeffs, a.qidx, a.qpool, a.num_q, a.out, a.num_mcus);
  }
}

template <typename T>
bool dispatch_mode(const Args& a, int h, int v, int ncomp, bool ycbcr) {
  if (ncomp == 1 && h == 1 && v == 1) {
    launch<T, 1, 1, 1>(a, ycbcr);
  } else if (ncomp == 3 && h == 1 && v == 1) {
    launch<T, 1, 1, 3>(a, ycbcr);
  } else if (ncomp == 3 && h == 2 && v == 1) {
    launch<T, 2, 1, 3>(a, ycbcr);
  } else if (ncomp == 3 && h == 1 && v == 2) {
    launch<T, 1, 2, 3>(a, ycbcr);
  } else if (ncomp == 3 && h == 2 && v == 2) {
    launch<T, 2, 2, 3>(a, ycbcr);
  } else {
    return false;
  }
  return true;
}

int decode(const void* coeffs, int wire_bytes, const void* qidx,
           const void* qpool, int num_q, void* out, long long num_mcus,
           int h, int v, int ncomp, void* stream, bool ycbcr) {
  if (num_mcus <= 0 || num_q <= 0) return cudaErrorInvalidValue;
  const Args a{coeffs, static_cast<const int32_t*>(qidx),
               static_cast<const int32_t*>(qpool), num_q,
               static_cast<uint8_t*>(out), num_mcus,
               static_cast<cudaStream_t>(stream)};
  bool ok;
  if (wire_bytes == 2) {
    ok = dispatch_mode<int16_t>(a, h, v, ncomp, ycbcr);
  } else if (wire_bytes == 1) {
    ok = dispatch_mode<int8_t>(a, h, v, ncomp, ycbcr);
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
                ncomp, stream, false);
}

extern "C" int pjt_cuda_decode_ycbcr(const void* coeffs, int wire_bytes,
                                     const void* qidx, const void* qpool,
                                     int num_q, void* out, long long num_mcus,
                                     int h, int v, int ncomp, void* stream) {
  return decode(coeffs, wire_bytes, qidx, qpool, num_q, out, num_mcus, h, v,
                ncomp, stream, true);
}
