// Raster epilogue of the device-resident batch path for Hopper (sm_90a):
// kernel-native decode output -> [B, out_h, out_w, 3] training batch, with
// the per-image crop offset and the (x - mean) * inv_std normalisation in
// the same pass.
//
// It has no Pallas counterpart.  In the JAX package three XLA ops do this
// as one fusion (pim_jpeg_decoder_tpu/models/input_pipeline.py):
// _raster_relayout (the [3, V*H, n*n, B*M] -> raster transpose), the crop
// dynamic_slice of _decode_batch_crops_jit, and _apply_norm.  Here it is
// one kernel instead of three PyTorch passes over device memory.
//
// Input: u8 [3, gy, n*n, M] from rgb_kernel / rgb_scaled_kernel, pixels
// column-major inside each slot (px*n + py); image b owns the gh x gw MCUs
// at b*gh*gw.  Output element (b, y, x, c) reads the pixel at (oy[b] + y,
// ox[b] + x) of image b's MCU grid (offsets clamped like dynamic_slice;
// none for a full batch).  It writes u8 unchanged, or float32, bfloat16 or
// float16 as (x - mean[c]) * inv_std[c] computed in float32 and rounded to
// the output type last (round to nearest even), which is what XLA and
// PyTorch compute for the same constants.
//
// What bounds it on an H100: bytes.  It moves 3 B/px in and 3 or 6 B/px
// out, with no arithmetic to speak of.  This first version is the simple
// one: one thread per output pixel, so stores are coalesced and loads are
// gathers (neighbouring threads read pixels n*M bytes apart; the L2 serves
// the rest of each sector to the threads of the same output row).  Staging
// MCU tiles in shared memory, or writing the raster straight from the
// decode kernel's store, is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 32;   // grid-stride past 4,224 blocks

struct Geometry {
  long long num_mcus;   // M, the last dimension of the input
  int v, h, n;          // luma sampling factors, pixels per slot side
  int batch, gh, gw;    // images, MCU rows and columns per image
  int out_h, out_w;
};

struct Norm {
  float mean[3];
  float inv_std[3];
};

template <typename OutT>
__device__ __forceinline__ OutT from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

template <typename OutT>
__device__ __forceinline__ void store(OutT* dst, const uint8_t (&px)[3],
                                      const Norm& norm) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dst[c] = from_float<OutT>(
        (static_cast<float>(px[c]) - norm.mean[c]) * norm.inv_std[c]);
  }
}

template <>
__device__ __forceinline__ void store<uint8_t>(uint8_t* dst,
                                               const uint8_t (&px)[3],
                                               const Norm&) {
  dst[0] = px[0];
  dst[1] = px[1];
  dst[2] = px[2];
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
raster_epilogue_kernel(const uint8_t* __restrict__ raw,
                       const int32_t* __restrict__ oys,
                       const int32_t* __restrict__ oxs, Geometry g, Norm norm,
                       OutT* __restrict__ out) {
  const int tile_h = g.v * g.n, tile_w = g.h * g.n;
  const int nn = g.n * g.n;
  const size_t plane = static_cast<size_t>(g.v * g.h) * nn * g.num_mcus;
  const long long per_image = static_cast<long long>(g.gh) * g.gw;
  const long long total =
      static_cast<long long>(g.batch) * g.out_h * g.out_w;
  for (long long p = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       p < total; p += static_cast<long long>(gridDim.x) * THREADS) {
    const int x = static_cast<int>(p % g.out_w);
    const long long row = p / g.out_w;
    const int y = static_cast<int>(row % g.out_h);
    const int b = static_cast<int>(row / g.out_h);
    int yy = y, xx = x;
    if (oys != nullptr) {
      yy += min(max(__ldg(oys + b), 0), g.gh * tile_h - g.out_h);
      xx += min(max(__ldg(oxs + b), 0), g.gw * tile_w - g.out_w);
    }
    const int wy = yy % tile_h, wx = xx % tile_w;
    const int slot = (wy / g.n) * g.h + wx / g.n;
    const int pix = (wx % g.n) * g.n + wy % g.n;
    const long long m =
        b * per_image + static_cast<long long>(yy / tile_h) * g.gw +
        xx / tile_w;
    const size_t src = (static_cast<size_t>(slot) * nn + pix) * g.num_mcus + m;
    const uint8_t px[3] = {__ldg(raw + src), __ldg(raw + plane + src),
                           __ldg(raw + 2 * plane + src)};
    store<OutT>(out + p * 3, px, norm);
  }
}

template <typename OutT>
void launch(const void* raw, const void* oys, const void* oxs,
            const Geometry& g, const Norm& norm, void* out,
            cudaStream_t stream) {
  const long long total =
      static_cast<long long>(g.batch) * g.out_h * g.out_w;
  const long long want = (total + THREADS - 1) / THREADS;
  const unsigned blocks =
      static_cast<unsigned>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  raster_epilogue_kernel<OutT><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<const int32_t*>(oys),
      static_cast<const int32_t*>(oxs), g, norm, static_cast<OutT*>(out));
}

}  // namespace

// C entry point (bound with ctypes).  out_kind: 0 u8 (mean/inv_std unused),
// 1 float32, 2 bfloat16, 3 float16.  oys/oxs: int32 [batch] device arrays,
// or both null for a full batch.  Launches on `stream`, allocates nothing,
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pjt_cuda_raster_epilogue(
    const void* raw, long long num_mcus, int v, int h, int n, int batch,
    int gh, int gw, int out_h, int out_w, const void* oys, const void* oxs,
    int out_kind, float mean0, float mean1, float mean2, float inv0,
    float inv1, float inv2, void* out, void* stream) {
  if (batch <= 0 || out_h <= 0 || out_w <= 0 || n <= 0 ||
      (oys == nullptr) != (oxs == nullptr) || out_h > gh * v * n ||
      out_w > gw * h * n ||
      static_cast<long long>(batch) * gh * gw > num_mcus) {
    return cudaErrorInvalidValue;
  }
  const Geometry g{num_mcus, v, h, n, batch, gh, gw, out_h, out_w};
  const Norm norm{{mean0, mean1, mean2}, {inv0, inv1, inv2}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      launch<uint8_t>(raw, oys, oxs, g, norm, out, s);
      break;
    case 1:
      launch<float>(raw, oys, oxs, g, norm, out, s);
      break;
    case 2:
      launch<__nv_bfloat16>(raw, oys, oxs, g, norm, out, s);
      break;
    case 3:
      launch<__half>(raw, oys, oxs, g, norm, out, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
