// Device helpers shared by the decode kernels (decode_kernel.cu), the
// unfused stage kernels (stage_kernels.cu) and the experiment kernels
// (kernel_opt.cu): the integer spec of ops/specs.py and ops/idct_math.py,
// bit for bit, and the RGB kernels' one store path (store_rgb).
//
// Signed overflow is undefined in C++, while the spec relies on int32
// two's-complement wrap (dequantized coefficients at the DEQUANT_CLAMP
// limits overflow the butterfly; the colour stage takes any int16 sample).
// All adds, multiplies and left shifts therefore run on uint32_t; values
// are cast back to int32_t only for the arithmetic right shift of a
// descale.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// The 64 quantizers of block (m, s) in the int32 pool: row qidx[m], or
// row 0 with ok = false when qidx[m] is out of range, and that block then
// decodes against a zero quantizer (as the TPU kernel's one-hot gather
// does) instead of reading out of bounds.  The row is always a valid
// address, so callers load unconditionally and select `ok ? load : 0`;
// a null row in its place makes the loads conditional, and the RGB
// kernels slower on an H100 (PERF.md).
template <int G>
__device__ __forceinline__ const int32_t* quant_row(
    const int32_t* __restrict__ qidx, const int32_t* __restrict__ qpool,
    int num_q, long long m, int s, bool& ok) {
  const int qi = __ldg(qidx + m);
  ok = static_cast<unsigned>(qi) < static_cast<unsigned>(num_q);
  return qpool + (static_cast<size_t>(ok ? qi : 0) * G + s) * 64;
}

// One dequantized coefficient: c * q, wrapped, clamped to the int16 range.
__device__ __forceinline__ uint32_t dequant(int32_t c, uint32_t q) {
  const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(c) * q);
  return static_cast<uint32_t>(min(max(d, -DEQUANT_CLAMP - 1),
                                   DEQUANT_CLAMP));
}

__device__ __forceinline__ uint8_t to_u8(int32_t v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// (x + 2^15) >> 16 of a wrapped int32 product sum.
__device__ __forceinline__ int32_t descale_color(uint32_t x) {
  return sra(x + (1u << (COLOR_BITS - 1)), COLOR_BITS);
}

// Fixed-point BT.601 of one pixel (decode_kernel.py:_color), clamped to
// uint8.  Samples in [-128, 127] never wrap; the colour stage's any-int16
// input wraps like the spec's int32.
__device__ __forceinline__ void bt601(int32_t y, int32_t cb, int32_t cr,
                                      uint8_t& r, uint8_t& g, uint8_t& b) {
  const int32_t y128 = y + 128;
  const uint32_t ucb = static_cast<uint32_t>(cb);
  const uint32_t ucr = static_cast<uint32_t>(cr);
  r = to_u8(y128 + descale_color(static_cast<uint32_t>(FIX_CR_R) * ucr));
  g = to_u8(y128 + descale_color(static_cast<uint32_t>(FIX_CB_G) * ucb +
                                 static_cast<uint32_t>(FIX_CR_G) * ucr));
  b = to_u8(y128 + descale_color(static_cast<uint32_t>(FIX_CB_B) * ucb));
}

// Index (col*8 + row) of the nearest chroma sample of luma pixel pix
// (px*8 + py) of luma slot sl, in a column-major chroma block at H x V
// sampling (decode_kernel.py:_upsample; slot (qv, qh) = (sl / H, sl % H)).
template <int H, int V>
__device__ __forceinline__ int chroma_pix(int sl, int pix) {
  const int px = pix >> 3, py = pix & 7;
  const int row = (sl / H) * (8 / V) + py / V;
  const int col = (sl % H) * (8 / H) + px / H;
  return col * 8 + row;
}

// The RGB kernels' store: a block's TS MCUs of uint8 [3, GY, NPIX, M], each
// byte written once, with NT threads striding over (slot, pixel, MCU), the
// MCU index fastest, so a warp stores consecutive bytes of each plane.
// rgb(sl, pix, mj, r, g, b) gives pixel pix of luma slot sl of the block's
// MCU mj; MCUs at or past num_mcus are skipped.
template <int GY, int NPIX, int TS, int NT, typename F>
__device__ __forceinline__ void store_rgb(uint8_t* __restrict__ out,
                                          long long m0, long long num_mcus,
                                          F rgb) {
  const long long left = num_mcus - m0;
  const int valid = left < TS ? static_cast<int>(left) : TS;
  const size_t plane = static_cast<size_t>(GY) * NPIX * num_mcus;
  for (int j = threadIdx.x; j < GY * NPIX * TS; j += NT) {
    const int mj = j % TS;
    if (mj >= valid) continue;
    const int pix = (j / TS) % NPIX;
    const int sl = j / (TS * NPIX);
    uint8_t r, g, b;
    rgb(sl, pix, mj, r, g, b);
    const size_t o =
        (static_cast<size_t>(sl) * NPIX + pix) * num_mcus + m0 + mj;
    out[o] = r;
    out[plane + o] = g;
    out[2 * plane + o] = b;
  }
}

// Blocks of per_block items covering n.
inline unsigned grid(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace
