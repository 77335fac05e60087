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
// ox[b] + x) of image b's MCU grid (offsets read as dynamic_slice reads
// them: a negative one counts from the far end, then all are clamped into
// the grid; none for a full batch).  It writes u8 unchanged, or float32,
// bfloat16 or float16 as (x - mean[c]) * inv_std[c] computed in float32
// and rounded to the output type last (round to nearest even), which is
// what XLA and PyTorch compute for the same constants.
//
// What bounds it on an H100: bytes.  It moves 3 B/px in and 3 to 12 B/px
// out, with no arithmetic to speak of, so the design is about memory
// transactions that carry only wanted bytes:
//   - a CUDA block owns a band of one image: one MCU row (v*n output rows)
//     by CHUNK = 32 consecutive MCU columns.  In the input the chunk's MCUs
//     are 32 contiguous bytes for every (channel, slot, pixel), so the band
//     is 3*gy*n*n runs of 32 bytes.  The block copies the runs that its
//     output window reaches (pixel rows and MCU columns outside it are
//     skipped) into shared memory with 16-byte cp.async when the runs are
//     16-byte aligned (M % 16 == 0 and the chunk's first MCU a multiple of
//     16), and with coalesced byte loads otherwise (a per-block branch);
//   - inside the band every output row is contiguous.  A lane assembles one
//     16-byte-aligned piece of a row (16 u8, 8 bf16/f16 or 4 f32 elements:
//     6, 4 or 2 pixels read from shared memory byte by byte, shifted into
//     place with one funnel shift a word) and writes it with one 16-byte
//     store; the pieces at a row's two ends, where the row does not start
//     or end on the 16-byte grid, store their elements one by one;
//   - shared-memory rows are 32 bytes with 16 bytes of padding after every
//     n rows, so that the pixel column wx moves a byte read by 4 banks.
//     The padding is kept for the crop form alone: measured on an H100
//     against ROW_PAD = 0 in one call it is worth 2% on 224x224 crops and
//     nothing (within 0.5%) on full batches, where device memory and not
//     the shared-memory byte reads bounds the kernel;
//   - the block decodes its image, MCU row, chunk and crop origin once;
//     n and h are template parameters, so the per-pixel index arithmetic is
//     shifts and masks.  No division remains per element.
// Writing the raster straight from the decode kernel's store is the other
// route; it changes what decode_mcus returns and is not taken here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;     // MCU columns per CUDA block: bytes per run
constexpr int VEC = 16;       // bytes per vector load or store
constexpr int ROW_PAD = 16;   // bytes of padding after every n band rows

struct Geometry {
  long long num_mcus;   // M, the last dimension of the input
  int v;                // luma sampling factor down (1 or 2)
  int batch, gh, gw;    // images, MCU rows and columns per image
  int out_h, out_w;
  int rows, chunks;     // bands per image: MCU rows x column chunks
};

struct Norm {
  float mean[3];
  float inv_std[3];
};

// Byte offset in the band of input row rho ((c*gy + slot)*n*n + pixel).
template <int N>
__device__ __forceinline__ int band_offset(int rho) {
  return rho * CHUNK + (rho / N) * ROW_PAD;
}

// A crop origin as jax.lax.dynamic_slice reads a start index: a negative
// one counts from the far end, and the result is clamped into the axis.
__device__ __forceinline__ int crop_origin(int o, int dim, int size) {
  if (o < 0) o += dim;
  return min(max(o, 0), dim - size);
}

// The 16 or 32 bits of one normalised element.
template <typename OutT>
__device__ __forceinline__ uint32_t encode(float x);

template <>
__device__ __forceinline__ uint32_t encode<float>(float x) {
  return __float_as_uint(x);
}

template <>
__device__ __forceinline__ uint32_t encode<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <>
__device__ __forceinline__ uint32_t encode<__half>(float x) {
  return __half_as_ushort(__float2half_rn(x));
}

template <typename OutT, int N, int H>
__global__ void __launch_bounds__(THREADS)
raster_epilogue_kernel(const uint8_t* __restrict__ raw,
                       const int32_t* __restrict__ oys,
                       const int32_t* __restrict__ oxs, Geometry g, Norm norm,
                       OutT* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t band[];
  constexpr int NN = N * N, TW = H * N;
  constexpr int TW_SHIFT = TW == 16 ? 4 : TW == 8 ? 3 : TW == 4 ? 2
                           : TW == 2 ? 1 : 0;
  constexpr int ELEM = static_cast<int>(sizeof(OutT));
  constexpr int EPP = VEC / ELEM;            // elements per piece
  constexpr int NPX = (EPP + 2 + 2) / 3;     // pixels a piece can touch
  constexpr int WORDS = (NPX * 3 + 3) / 4;
  const int th = g.v * N, gy = g.v * H;

  // The block's band: image b, MCU row mrow, MCU columns from mcu0.
  unsigned id = blockIdx.x;
  const int k = static_cast<int>(id % g.chunks);
  id /= g.chunks;
  const int j = static_cast<int>(id % g.rows);
  const int b = static_cast<int>(id / g.rows);
  int oy = 0, ox = 0;
  if (oys != nullptr) {
    oy = crop_origin(__ldg(oys + b), g.gh * th, g.out_h);
    ox = crop_origin(__ldg(oxs + b), g.gw * TW, g.out_w);
  }
  const int mrow = oy / th + j;
  const int mcu0 = ((ox >> TW_SHIFT) / CHUNK + k) * CHUNK;
  const int valid = min(CHUNK, g.gw - mcu0);   // MCUs of the chunk
  // Its output window: rows [y_lo, y_hi), columns [x_lo, x_hi).
  const int y_lo = max(0, mrow * th - oy);
  const int y_hi = min(g.out_h, (mrow + 1) * th - oy);
  const int x_lo = max(0, mcu0 * TW - ox);
  const int x_hi = min(g.out_w, (mcu0 + valid) * TW - ox);
  if (y_lo >= y_hi || x_lo >= x_hi) return;
  // The pixel rows of the MCU row and the MCUs of the chunk it reaches.
  const int wy_lo = oy + y_lo - mrow * th, wy_hi = oy + y_hi - 1 - mrow * th;
  const int col0 = ox + x_lo - mcu0 * TW;      // first column, in the chunk
  const int m_lo = col0 >> TW_SHIFT;
  const int m_hi = (col0 + x_hi - x_lo - 1) >> TW_SHIFT;

  // Load the band: row rho = c*gy*NN + sy*H*NN + N*wx + wy%N holds pixel
  // (wy, wx) of channel c for the chunk's MCUs.
  const long long m_first =
      (static_cast<long long>(b) * g.gh + mrow) * g.gw + mcu0;
  const uint8_t* src0 = raw + m_first;
  const int rows_total = 3 * gy * NN;
  const bool aligned = g.num_mcus % VEC == 0 && m_first % VEC == 0 &&
                       reinterpret_cast<uintptr_t>(raw) % VEC == 0;
  if (aligned) {
    constexpr int PIECES = CHUNK / VEC;
    for (int i = threadIdx.x; i < rows_total * PIECES; i += THREADS) {
      const int rho = i / PIECES, first = (i % PIECES) * VEC;
      const int wy = ((rho / (H * NN)) & (g.v - 1)) * N + rho % N;
      if (wy < wy_lo || wy > wy_hi || first > m_hi || first + VEC <= m_lo) {
        continue;
      }
      uint8_t* dst = band + band_offset<N>(rho) + first;
      const uint8_t* src =
          src0 + static_cast<size_t>(rho) * g.num_mcus + first;
      if (first + VEC <= valid) {
        __pipeline_memcpy_async(dst, src, VEC);
      } else {   // the ragged end of the grid: never read past it
        for (int t = 0; first + t <= m_hi; ++t) dst[t] = __ldg(src + t);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int i = threadIdx.x; i < rows_total * CHUNK; i += THREADS) {
      const int rho = i / CHUNK, mj = i % CHUNK;
      const int wy = ((rho / (H * NN)) & (g.v - 1)) * N + rho % N;
      if (wy < wy_lo || wy > wy_hi || mj < m_lo || mj > m_hi) continue;
      band[band_offset<N>(rho) + mj] =
          __ldg(src0 + static_cast<size_t>(rho) * g.num_mcus + mj);
    }
  }
  __syncthreads();

  // Store the window's rows, one 16-byte-aligned piece a lane.
  constexpr int WX_STEP = N * CHUNK + ROW_PAD;          // band bytes per wx
  constexpr int SY_STEP = H * NN * CHUNK + H * N * ROW_PAD;
  const int plane = gy * (NN * CHUNK + N * ROW_PAD);    // band bytes per c
  const int npx = x_hi - x_lo, seg_elems = 3 * npx;
  const unsigned ppr = (seg_elems * ELEM + VEC - 1) / VEC + 1;
  const unsigned items = static_cast<unsigned>(y_hi - y_lo) * ppr;
  uint8_t* const out_bytes = reinterpret_cast<uint8_t*>(out);
  for (unsigned it = threadIdx.x; it < items; it += THREADS) {
    const int yi = static_cast<int>(it / ppr);
    const int p = static_cast<int>(it - yi * ppr);
    const int y = y_lo + yi;
    // The row's segment starts at element 3*x_lo of output row (b, y).
    const size_t seg_byte =
        ((static_cast<size_t>(b) * g.out_h + y) * g.out_w + x_lo) * 3 * ELEM;
    const int head = static_cast<int>(
        reinterpret_cast<uintptr_t>(out_bytes + seg_byte) % VEC);
    // Piece p: elements [e0, e0 + EPP) of the segment (e0 < 0: the piece
    // begins before it).
    const int e0 = (p * VEC - head) / ELEM;
    if (e0 >= seg_elems) continue;
    const int x0 = (e0 + 18) / 3 - 6, phi = (e0 + 18) % 3;
    const int wy = oy + y - mrow * th;
    const uint8_t* row = band + (wy / N) * SY_STEP + (wy % N) * CHUNK;

    // NPX pixels from x0 (clamped into the window), 3 bytes each.
    uint32_t w[WORDS + 1] = {};
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
      const int col = col0 + min(max(x0 + i, 0), npx - 1);
      const uint8_t* px =
          row + (col & (TW - 1)) * WX_STEP + (col >> TW_SHIFT);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int at = i * 3 + c;
        w[at / 4] |= static_cast<uint32_t>(px[c * plane]) << (at % 4 * 8);
      }
    }
    // Byte i of s: channel (phi + i) % 3 of element e0 + i.
    uint32_t s[(EPP + 3) / 4];
#pragma unroll
    for (int i = 0; i < (EPP + 3) / 4; ++i) {
      s[i] = __funnelshift_r(w[i], w[i + 1], phi * 8);
    }
    uint32_t bits[EPP];   // one element each, ELEM bytes
    if constexpr (ELEM == 1) {
#pragma unroll
      for (int i = 0; i < EPP; ++i) bits[i] = (s[i / 4] >> (i % 4 * 8)) & 0xffu;
    } else {
      float mean[3], inv[3];   // rotated: [i % 3] is element i's channel
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        mean[c] = phi == 0 ? norm.mean[c]
                  : phi == 1 ? norm.mean[(c + 1) % 3] : norm.mean[(c + 2) % 3];
        inv[c] = phi == 0 ? norm.inv_std[c]
                 : phi == 1 ? norm.inv_std[(c + 1) % 3]
                            : norm.inv_std[(c + 2) % 3];
      }
#pragma unroll
      for (int i = 0; i < EPP; ++i) {
        const float x =
            static_cast<float>((s[i / 4] >> (i % 4 * 8)) & 0xffu);
        bits[i] = encode<OutT>(__fmul_rn(__fsub_rn(x, mean[i % 3]),
                                         inv[i % 3]));
      }
    }
    uint8_t* dst = out_bytes + seg_byte + (p * VEC - head);
    if (e0 >= 0 && e0 + EPP <= seg_elems) {
      uint32_t v[4];
      if constexpr (ELEM == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = s[i];
      } else if constexpr (ELEM == 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = bits[2 * i] | (bits[2 * i + 1] << 16);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = bits[i];
      }
      *reinterpret_cast<int4*>(dst) =
          make_int4(static_cast<int>(v[0]), static_cast<int>(v[1]),
                    static_cast<int>(v[2]), static_cast<int>(v[3]));
    } else {   // a row's first or last piece: element by element
#pragma unroll
      for (int i = 0; i < EPP; ++i) {
        if (e0 + i < 0 || e0 + i >= seg_elems) continue;
        if constexpr (ELEM == 1) {
          dst[i] = static_cast<uint8_t>(bits[i]);
        } else if constexpr (ELEM == 2) {
          reinterpret_cast<uint16_t*>(dst)[i] = static_cast<uint16_t>(bits[i]);
        } else {
          reinterpret_cast<uint32_t*>(dst)[i] = bits[i];
        }
      }
    }
  }
}

template <typename OutT>
using Kernel = void (*)(const uint8_t*, const int32_t*, const int32_t*,
                        Geometry, Norm, OutT*);

template <typename OutT, int N>
Kernel<OutT> kernel_for_h(int h) {
  return h == 1 ? raster_epilogue_kernel<OutT, N, 1>
                : raster_epilogue_kernel<OutT, N, 2>;
}

template <typename OutT>
Kernel<OutT> kernel_for(int n, int h) {
  switch (n) {
    case 8:
      return kernel_for_h<OutT, 8>(h);
    case 4:
      return kernel_for_h<OutT, 4>(h);
    case 2:
      return kernel_for_h<OutT, 2>(h);
  }
  return kernel_for_h<OutT, 1>(h);
}

// Dynamic shared memory of a band: 3*gy*n*n rows and their padding.
int band_bytes(int v, int h, int n) {
  const int rows = 3 * v * h * n * n;
  return rows * CHUNK + rows / n * ROW_PAD;
}

template <typename OutT>
void launch(const void* raw, const void* oys, const void* oxs,
            const Geometry& g, int h, int n, const Norm& norm, void* out,
            cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(g.batch) * g.rows * g.chunks;
  const Kernel<OutT> kernel = kernel_for<OutT>(n, h);
  kernel<<<blocks, THREADS, band_bytes(g.v, h, n), stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<const int32_t*>(oys),
      static_cast<const int32_t*>(oxs), g, norm, static_cast<OutT*>(out));
}

template <typename OutT>
int occupancy(int v, int h, int n, int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_for<OutT>(n, h), THREADS, band_bytes(v, h, n)));
}

bool supported(int v, int h, int n) {
  return (v == 1 || v == 2) && (h == 1 || h == 2) &&
         (n == 1 || n == 2 || n == 4 || n == 8);
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
  if (batch <= 0 || out_h <= 0 || out_w <= 0 || !supported(v, h, n) ||
      (oys == nullptr) != (oxs == nullptr) || out_h > gh * v * n ||
      out_w > gw * h * n ||
      static_cast<long long>(batch) * gh * gw > num_mcus) {
    return cudaErrorInvalidValue;
  }
  // Bands per image: the MCU rows and 32-column chunks an output window
  // can reach (a crop's origin may put it across one more of each).
  const int th = v * n, cw = CHUNK * h * n;
  const bool crop = oys != nullptr;
  int rows = (out_h - 1) / th + (crop ? 2 : 1);
  int chunks = (out_w - 1) / cw + (crop ? 2 : 1);
  if (rows > gh) rows = gh;
  if (chunks > (gw + CHUNK - 1) / CHUNK) chunks = (gw + CHUNK - 1) / CHUNK;
  if (static_cast<long long>(batch) * rows * chunks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const Geometry g{num_mcus, v, batch, gh, gw, out_h, out_w, rows, chunks};
  const Norm norm{{mean0, mean1, mean2}, {inv0, inv1, inv2}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      launch<uint8_t>(raw, oys, oxs, g, h, n, norm, out, s);
      break;
    case 1:
      launch<float>(raw, oys, oxs, g, h, n, norm, out, s);
      break;
    case 2:
      launch<__nv_bfloat16>(raw, oys, oxs, g, h, n, norm, out, s);
      break;
    case 3:
      launch<__half>(raw, oys, oxs, g, h, n, norm, out, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the epilogue kernel for this geometry and output kind that one
// SM holds, and the band's dynamic shared memory in bytes.
extern "C" int pjt_cuda_raster_occupancy(int v, int h, int n, int out_kind,
                                         int* blocks, int* smem_bytes) {
  if (!supported(v, h, n)) return cudaErrorInvalidValue;
  *smem_bytes = band_bytes(v, h, n);
  switch (out_kind) {
    case 0:
      return occupancy<uint8_t>(v, h, n, blocks);
    case 1:
      return occupancy<float>(v, h, n, blocks);
    case 2:
      return occupancy<__nv_bfloat16>(v, h, n, blocks);
    case 3:
      return occupancy<__half>(v, h, n, blocks);
  }
  return cudaErrorInvalidValue;
}
