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
// the grid; none for a full batch).  With destination rows, image b is
// written as image dst[b] of an output of out_batch images, which every
// launch of a batch that mixes sampling modes shares (a row outside it is
// not written); without, as image b.  It writes u8 unchanged, or float32,
// bfloat16 or float16 as (x - mean[c]) * inv_std[c] computed in float32
// and rounded to the output type last (round to nearest even), which is
// what XLA and PyTorch compute for the same constants.
//
// What bounds it on an H100: bytes.  It moves 3 B/px in and 3 to 12 B/px
// out, with no arithmetic to speak of, so the design is about memory
// transactions that carry only wanted bytes, enough of them in flight,
// and few instructions a stored byte.  One kernel template, two forms,
// chosen per launch by pjt_cuda_raster_epilogue from what the call shows:
//
// The row form (ROWS = true): full batches (no crop origins) at scale 1 of
// 4:2:0 or 4:2:2 (MCU rows RTW = 16 pixels wide), with images at most
// CHUNK = 32 MCUs wide, output rows a multiple of 16 pixels and the output
// on the 16-byte grid, and an input, M and band run that a 4-, 8- or
// 16-byte copy divides: the loader's batches (256x256 is gw = 16), and
// 224, 384 or 512 pixels wide.  There every staging store and output
// store is a whole 16-byte granule.
//   - A band is R = 32 / gw whole MCU rows: R*gw <= 32 consecutive MCUs of
//     the input (at gw = 16, two MCU rows), so that each of its 3*gy*64
//     input rows is one run of R*gw bytes, copied whole with cp.async (16,
//     8 or 4 bytes a copy, the widest that R*gw, M and the input address
//     allow); no copy carries another band's bytes, so no sector is read
//     by two blocks.  Its output is one contiguous range of the batch: the
//     rows of its MCU rows that the output window keeps, image after
//     image.
//   - One band a block, the grid one block a band.  Loads overlap stores
//     across the blocks an SM holds (4 at 4:2:0, by shared memory): a
//     block issues its copies first and sets up its tables while they fly.
//     A persistent grid whose blocks walked their bands through a ring of
//     two band buffers, loading band i+1 while storing band i, was built
//     and measured first on an H100 (3 blocks an SM): at the loader's
//     batch it took 74.1 us against this form's 63.9 in one call, as
//     persistent rings lost in mxu_idct.cu before.
//   - The band is transposed once in shared memory into its raster rows,
//     channel-interleaved u8 in output order (the staging buffer): a lane
//     reads a word of 4 MCUs from 4 consecutive (channel, pixel) rows and
//     one 4x4 byte transpose (8 byte permutes) gives a word of each MCU's
//     48-byte row segment, stored as three 16-byte granules.  The staging
//     granules are XOR-swizzled inside each 128-byte line, so that those
//     stores spread over the banks while a line still reads in one sweep.
//   - The stores: a warp takes 96 consecutive 16-byte output pieces, lane l
//     pieces l, l + 32 and l + 64, so each store instruction writes 512
//     contiguous bytes.  A piece is one staging read (16, 8 or 4 bytes);
//     the channel of its elements depends on the lane and on which of its
//     three pieces it is, not on the band, so the mean and 1/std are
//     rotated once per thread.  A bfloat16 or float16 piece converts its
//     elements in pairs (__floats2bfloat162_rn / __floats2half2_rn), each
//     byte made a float by a byte permute into 2^23 and one exact subtract.
//     A band's output starts and ends on a row, so on a whole piece.
//     Threads that stored straight from their transposed registers, 16
//     bytes a lane at 96-byte strides, took 2.1x as long: the stores have
//     to be whole lines.
//   - The rule keeps to 16-pixel MCU rows, where every store is whole.
//     Timed on an H100 against the banded form, a row form that also took
//     rows off that grid lost 16% (uint8) and 2.1x (bfloat16 at scale 2)
//     at 500x375 and 2% at 4:4:4; where it won off the grid (500x375 to
//     float32, 12%; 256x256 at scale 2, 11%) it needs word and byte
//     staging stores and per-element band ends, left out here (PERF.md).
//
// The banded form (ROWS = false): crops, launches with destination rows,
// and every full batch the row form does not take.
//   - a CUDA block owns a band of one image: one MCU row (v*n output rows)
//     by CHUNK = 32 consecutive MCU columns.  In the input the chunk's MCUs
//     are up to 32 contiguous bytes for every (channel, slot, pixel), so
//     the band is 3*gy*n*n runs.  Run rho starts at raw + rho*M + m_first,
//     s(rho) = (s(0) + rho * (M % 16)) % 16 bytes past the 16-byte grid.
//     The block copies each run as the 16-byte granules that cover it,
//     with cp.async, into a shared-memory row at the same offset inside
//     the granule, so MCU m of the run sits at row byte s(rho) + m; bytes
//     of a granule outside the run (the next MCUs, or the next image) are
//     never stored.  Only a granule that would reach before raw or past
//     the array's end loads byte by byte, and only its bytes inside.
//     Pixel rows and granules outside the output window are skipped.
//     This replaced a load that took 16-byte copies only where every run
//     was on the grid (M % 16 == 0 and the chunk's first MCU a multiple of
//     16) and one byte a lane otherwise, with a run's ragged end serialised
//     on one thread: the crop path's sub-grids (15 MCUs wide at 4:2:0, M
//     rarely a multiple of 16) took the byte loads in every band;
//   - inside the band every output row is contiguous.  A lane assembles one
//     16-byte-aligned piece of a row (16 u8, 8 bf16/f16 or 4 f32 elements:
//     6, 4 or 2 pixels read from shared memory byte by byte, shifted into
//     place with one funnel shift a word) and writes it with one 16-byte
//     store; the pieces at a row's two ends, where the row does not start
//     or end on the 16-byte grid, store their elements one by one.  Where
//     M % 16 == 0 every run of the block has the shift s(0), folded into
//     the row's address once; otherwise each byte read adds its run's
//     shift, a multiply-add and a mask from the pixel and channel;
//   - shared-memory rows are 32 bytes, or 48 where a run plus its shift
//     can pass 32 (a launch off the grid with chunks over 17 MCUs: 4:4:4
//     crops' 29-wide sub-grids), chosen per launch (band_row_bytes), so a
//     4:2:0 band at scale 1 keeps 8 blocks an SM wherever it can.  After
//     every n rows come 16 bytes of padding, so that the pixel column wx
//     moves a byte read by 4 banks at either width.  Measured on an H100
//     against ROW_PAD = 0 in one call it is worth 2% on 224x224 crops;
//   - the block decodes its image, MCU row, chunk, crop origin and
//     destination row once;
//     n and h are template parameters, so the per-pixel index arithmetic is
//     shifts and masks.  No division remains per element.
// Writing the raster straight from the decode kernel's store is the other
// route; it changes what decode_mcus returns and is not taken here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_tile.cuh"   // VEC, PerDevice, phase_conflict_free

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;       // MCUs per band at most: bytes per run
constexpr int ROW_PAD = 16;     // banded form: bytes after every n rows
constexpr int LINE = 128;       // staging bytes one sweep of the banks holds
constexpr int ROUND = 3 * 32;   // output pieces a warp stores in a round
constexpr int RN = 8, RH = 2;   // row form: n and h (scale 1, 4:2:0/4:2:2)
constexpr int RTW = RH * RN;    // row form: pixels an MCU row is wide

struct Geometry {
  long long num_mcus;   // M, the last dimension of the input
  int v;                // luma sampling factor down (1 or 2)
  int batch, gh, gw;    // images, MCU rows and columns per image
  int out_h, out_w;
  int rows, chunks;     // banded form: bands per image (rows x chunks)
  int row_bytes;        // banded form: bytes of a band's shared-memory row
  int band_rows;        // row form: R, the MCU rows of a band; 0: banded
  int copy;             // row form: bytes per cp.async (16, 8 or 4)
  int out_batch;        // images of the output (batch without dst rows)
};

struct Norm {
  float mean[3];
  float inv_std[3];
};

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

// --- the banded form ---------------------------------------------------------

// Byte offset in the band of input row rho ((c*gy + slot)*n*n + pixel), in
// rows of rw bytes.
template <int N>
__device__ __forceinline__ int band_offset(int rho, int rw) {
  return rho * rw + (rho / N) * ROW_PAD;
}

// At either row width the pixel column wx (n = 8 rows and their padding)
// moves a byte read by 4 banks.
static_assert((8 * CHUNK + ROW_PAD) / 4 % 32 == 4 &&
                  (8 * (CHUNK + VEC) + ROW_PAD) / 4 % 32 == 4,
              "a band row width puts wx's byte reads on the same banks");

// What a banded-form block decodes once: its image's place in the output,
// its crop origin and MCU row, its output window (rows [y_lo, y_hi),
// columns [x_lo, x_hi)), the window's first column in the chunk, and the
// shift of the band's run 0 with M % VEC, from which every run's follows.
struct Band {
  int ob, oy, mrow;
  int y_lo, y_hi, x_lo, x_hi;
  int col0;
  int s0, mm;
};

// Copy the band's runs as the G granules of VEC bytes that cover each (rows
// of G * VEC bytes).  at0: the input byte of run 0's first MCU (run rho
// starts rho * M bytes later); total: the input's bytes; s0 = (raw + at0) %
// VEC and mm = M % VEC, so run rho starts (s0 + rho * mm) % VEC bytes past
// the grid.
template <int N, int H, int G>
__device__ __forceinline__ void load_band(const uint8_t* __restrict__ raw,
                                          long long at0, long long num_mcus,
                                          long long total, int rows_total,
                                          int v, int s0, int mm, int wy_lo,
                                          int wy_hi, int m_lo, int m_hi,
                                          uint8_t* band) {
  constexpr int NN = N * N;
  for (int i = threadIdx.x; i < rows_total * G; i += THREADS) {
    const int rho = i / G, gi = i - rho * G;
    const int wy = ((rho / (H * NN)) & (v - 1)) * N + rho % N;
    // The granule's first byte, counted from the run's (negative: before).
    const int first = gi * VEC - ((s0 + rho * mm) & (VEC - 1));
    if (wy < wy_lo || wy > wy_hi || first > m_hi || first + VEC <= m_lo) {
      continue;
    }
    uint8_t* dst = band + band_offset<N>(rho, G * VEC) + gi * VEC;
    const long long at = at0 + rho * num_mcus + first;
    if (at >= 0 && at + VEC <= total) {
      __pipeline_memcpy_async(dst, raw + at, VEC);
    } else {   // the array's first or last granule: only its bytes inside
      for (int t = 0; t < VEC; ++t) {
        if (at + t >= 0 && at + t < total) dst[t] = __ldg(raw + at + t);
      }
    }
  }
}

// Store a loaded band's window rows, one 16-byte-aligned piece a lane.
// PER_RUN: the runs' shifts differ (M % VEC != 0), so each byte read adds
// its own, (s0 + rho * mm) % VEC for its run rho; else every run's is s0,
// added to the row's address once (adding a per-byte shift on every launch
// cost 5% at scale 2 on an H100).
template <typename OutT, int N, int H, bool PER_RUN>
__device__ __forceinline__ void store_band(const uint8_t* __restrict__ band,
                                           const Geometry& g,
                                           const Norm& norm, const Band& bd,
                                           OutT* __restrict__ out) {
  constexpr int NN = N * N, TW = H * N;
  constexpr int TW_SHIFT = TW == 16 ? 4 : TW == 8 ? 3 : TW == 4 ? 2
                           : TW == 2 ? 1 : 0;
  constexpr int ELEM = static_cast<int>(sizeof(OutT));
  constexpr int EPP = VEC / ELEM;            // elements per piece
  constexpr int NPX = (EPP + 2 + 2) / 3;     // pixels a piece can touch
  constexpr int WORDS = (NPX * 3 + 3) / 4;
  const int th = g.v * N, gy = g.v * H;
  const int rw = g.row_bytes;
  const int wx_step = N * rw + ROW_PAD;                 // band bytes per wx
  const int sy_step = H * N * wx_step;
  const int plane = gy * N * wx_step;                   // band bytes per c
  // A run's shift grows by wx * n_mm from pixel column wx, and by c * c_mm
  // from channel c (0 mod VEC where n*n is a multiple of VEC).
  const int n_mm = N * bd.mm, c_mm = NN % VEC == 0 ? 0 : gy * NN * bd.mm;
  const int npx = bd.x_hi - bd.x_lo, seg_elems = 3 * npx;
  const unsigned ppr = (seg_elems * ELEM + VEC - 1) / VEC + 1;
  const unsigned items = static_cast<unsigned>(bd.y_hi - bd.y_lo) * ppr;
  uint8_t* const out_bytes = reinterpret_cast<uint8_t*>(out);
  for (unsigned it = threadIdx.x; it < items; it += THREADS) {
    const int yi = static_cast<int>(it / ppr);
    const int p = static_cast<int>(it - yi * ppr);
    const int y = bd.y_lo + yi;
    // The row's segment starts at element 3*x_lo of output row (ob, y).
    const size_t seg_byte =
        ((static_cast<size_t>(bd.ob) * g.out_h + y) * g.out_w + bd.x_lo) *
        3 * ELEM;
    const int head = static_cast<int>(
        reinterpret_cast<uintptr_t>(out_bytes + seg_byte) % VEC);
    // Piece p: elements [e0, e0 + EPP) of the segment (e0 < 0: the piece
    // begins before it).
    const int e0 = (p * VEC - head) / ELEM;
    if (e0 >= seg_elems) continue;
    const int x0 = (e0 + 18) / 3 - 6, phi = (e0 + 18) % 3;
    const int wy = bd.oy + y - bd.mrow * th;
    const uint8_t* row =
        band + (wy / N) * sy_step + (wy % N) * rw + (PER_RUN ? 0 : bd.s0);
    // The shift of the row's run at wx = 0 and c = 0.
    const int sy = bd.s0 + ((wy / N) * H * NN + wy % N) * bd.mm;

    // NPX pixels from x0 (clamped into the window), 3 bytes each.
    uint32_t w[WORDS + 1] = {};
#pragma unroll
    for (int i = 0; i < NPX; ++i) {
      const int col = bd.col0 + min(max(x0 + i, 0), npx - 1);
      const int wx = col & (TW - 1);
      const uint8_t* px = row + wx * wx_step + (col >> TW_SHIFT);
      const int sx = sy + wx * n_mm;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int at = i * 3 + c;
        const int shift = PER_RUN ? (sx + c * c_mm) & (VEC - 1) : 0;
        w[at / 4] |= static_cast<uint32_t>(px[c * plane + shift])
                     << (at % 4 * 8);
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

template <typename OutT, int N, int H>
__device__ __forceinline__ void banded(const uint8_t* __restrict__ raw,
                                       const int32_t* __restrict__ oys,
                                       const int32_t* __restrict__ oxs,
                                       const int32_t* __restrict__ dst_rows,
                                       const Geometry& g, const Norm& norm,
                                       OutT* __restrict__ out, uint8_t* band) {
  constexpr int NN = N * N, TW = H * N;
  constexpr int TW_SHIFT = TW == 16 ? 4 : TW == 8 ? 3 : TW == 4 ? 2
                           : TW == 2 ? 1 : 0;
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
  int ob = b;   // the image's place in the output
  if (dst_rows != nullptr) {
    ob = __ldg(dst_rows + b);
    if (ob < 0 || ob >= g.out_batch) return;
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
  // (wy, wx) of channel c for the chunk's MCUs, MCU m at byte shift + m.
  const long long m_first =
      (static_cast<long long>(b) * g.gh + mrow) * g.gw + mcu0;
  const int rows_total = 3 * gy * NN;
  const int s0 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(raw) + m_first) % VEC);
  const int mm = static_cast<int>(g.num_mcus % VEC);
  const long long total = rows_total * g.num_mcus;
  if (g.row_bytes == 2 * VEC) {
    load_band<N, H, 2>(raw, m_first, g.num_mcus, total, rows_total, g.v, s0,
                       mm, wy_lo, wy_hi, m_lo, m_hi, band);
  } else {
    load_band<N, H, 3>(raw, m_first, g.num_mcus, total, rows_total, g.v, s0,
                       mm, wy_lo, wy_hi, m_lo, m_hi, band);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const Band bd{ob, oy, mrow, y_lo, y_hi, x_lo, x_hi, col0, s0, mm};
  if (mm == 0) {
    store_band<OutT, N, H, false>(band, g, norm, bd, out);
  } else {
    store_band<OutT, N, H, true>(band, g, norm, bd, out);
  }
}

// --- the row form ------------------------------------------------------------

// Where the band's MCU rows land in the staging buffer: filled by threads
// 0..R before the band's first barrier.  rowoff[dr] is the staging offset
// of MCU row dr's first output row (rowoff[R]: the end of the band's
// output); nrows[dr] its output rows (0 past the batch or the window).
struct RowTable {
  long long ebase;      // the output element at staging offset 0
  int rowoff[CHUNK + 1];
  int nrows[CHUNK];
};

// Staging bytes: a band's output elements (at most 32 MCUs' pixels, so the
// band's input bytes) after up to LINE - 1 bytes that the 128-byte-aligned
// start adds, in whole lines.
__host__ __device__ constexpr int stage_bytes(int band_bytes) {
  return (band_bytes + LINE - 1) / LINE * LINE + LINE;
}

__host__ __device__ constexpr int rows_smem(int band_bytes) {
  return band_bytes + stage_bytes(band_bytes) +
         static_cast<int>(sizeof(RowTable));
}

// The staging byte of logical offset s: granule (s / 16) XORed inside its
// 128-byte line with the line's index, bytes inside a granule in place.
__host__ __device__ constexpr int swz(int s) {
  return s ^ (((s >> 7) & 7) << 4);
}

// The stage-T lane layout: lane l of a warp takes word column jw = l / 4
// (MCUs 4jw..4jw+3 of the band) of pixel row 4*warp + l % 4, so a load of
// (channel, pixel) rows reads four consecutive 32-byte rows whole.  For a
// 4:2:0 band at full scale (rows of 32 bytes, pixel rows 16) no two lanes
// of a load meet in a bank:
constexpr bool stage_t_loads_conflict_free() {
  int word[32] = {};
  for (int l = 0; l < 32; ++l) word[l] = (l % 4) * (CHUNK / 4) + l / 4;
  return phase_conflict_free(word, 32, 1);
}
static_assert(stage_t_loads_conflict_free(),
              "stage-T loads of 4 rows x 8 words meet in a bank");

// And a store round of the row form (half a warp of 8-byte staging reads,
// a quarter of 16-byte ones, a warp of 4-byte ones) reads one 128-byte line
// through the swizzle without a conflict, wherever the line lies:
constexpr bool stage_s_reads_conflict_free(int bytes) {
  for (int line = 0; line < 64; ++line) {
    int word[32] = {};
    const int lanes = LINE / bytes;
    for (int l = 0; l < lanes; ++l) {
      word[l] = swz(line * LINE + l * bytes) / 4;
    }
    if (!phase_conflict_free(word, lanes, bytes / 4)) return false;
  }
  return true;
}
static_assert(stage_s_reads_conflict_free(4) &&
                  stage_s_reads_conflict_free(8) &&
                  stage_s_reads_conflict_free(16),
              "the staging swizzle splits a line's read");

// 4x4 byte transpose: y[b] byte i = x[i] byte b.
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4],
                                           uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

// Stage T of one thread: pixel row wy of the band's MCUs 4jw..4jw+3 (all
// RTW = 16 of their columns, 48 bytes each) from the band buffer into the
// staging buffer, three whole granules an MCU.  dr/x0: each MCU's row in
// the band and first output column (dr < 0: no such MCU).
__device__ __forceinline__ void rows_transpose(
    const uint8_t* __restrict__ slot, uint8_t* __restrict__ stage,
    const RowTable& t, int jw, int wy, const int (&dr)[4],
    const int (&x0)[4], int plane_words, int row_len) {
  constexpr int NN = RN * RN, SEG = 3 * RTW, GRANULES = SEG / VEC;
  int off[4];
  bool keep[4], any = false;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    keep[b] = dr[b] >= 0 && wy < t.nrows[dr[b]];
    off[b] = keep[b] ? t.rowoff[dr[b]] + wy * row_len + 3 * x0[b] : 0;
    any |= keep[b];
  }
  if (!any) return;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(slot) +
                        ((wy / RN) * RH * NN + wy % RN) * (CHUNK / 4) + jw;
#pragma unroll
  for (int gi = 0; gi < GRANULES; ++gi) {
    uint32_t y[4][4];   // [MCU][word of the granule]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x[4], col[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = 16 * gi + 4 * i + k;   // byte e of a segment
        const int c = e % 3, p = e / 3;      // pixel p = sx*RN + px
        x[k] = src[c * plane_words +
                   ((p / RN) * NN + (p % RN) * RN) * (CHUNK / 4)];
      }
      transpose4(x, col);
#pragma unroll
      for (int b = 0; b < 4; ++b) y[b][i] = col[b];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (keep[b]) {
        *reinterpret_cast<uint4*>(stage + swz(off[b] + VEC * gi)) =
            make_uint4(y[b][0], y[b][1], y[b][2], y[b][3]);
      }
    }
  }
}

// Byte i of w as a float: 0x4B0000bb is 2^23 + bb, and the subtract is
// exact.
__device__ __forceinline__ float byte_float(uint32_t w, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)),
                   8388608.0f);
}

__device__ __forceinline__ float pick3(const float (&v)[3], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : v[2];
}

template <typename OutT>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Stage S: the band's output elements [e_lo, e_hi) (staging offset 0 is
// element ebase; both ends start an output row, so a piece) as 16-byte
// pieces, lane l of a warp pieces l, l + 32 and
// l + 64 of each round of 96 (rounds counted from the output's start, so a
// round starts on channel 0).  Element i of the lane's piece k has channel
// (rot + k * KSTEP + i) % 3, rot = l * EPP % 3: mean/inv hold the
// statistics rotated by rot, and the rest of the index is known here.
template <typename OutT>
__device__ __forceinline__ void rows_store(const uint8_t* __restrict__ stage,
                                           long long ebase, long long e_lo,
                                           long long e_hi,
                                           const float (&mean)[3],
                                           const float (&inv)[3],
                                           uint8_t* __restrict__ out_bytes) {
  constexpr int ELEM = static_cast<int>(sizeof(OutT));
  constexpr int EPP = VEC / ELEM;
  constexpr int KSTEP = 32 * EPP % 3;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // Pieces and elements from the band's first round on, in 32 bits.
  const long long q0 = e_lo / EPP / ROUND;
  const long long e0_base = q0 * ROUND * EPP;
  const int lo = static_cast<int>(e_lo - e0_base);
  const int hi = static_cast<int>(e_hi - e0_base);
  const int to_stage = static_cast<int>(e0_base - ebase);
  uint8_t* const out0 = out_bytes + e0_base * ELEM;
  for (int r = warp; r * ROUND * EPP < hi; r += WARPS) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int e0 = (r * ROUND + lane + 32 * k) * EPP;
      if (e0 < lo || e0 >= hi) continue;
      const uint8_t* src = stage + swz(e0 + to_stage);
      uint32_t v[4];
      if constexpr (ELEM == 1) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
      } else if constexpr (ELEM == 2) {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t w = i < 2 ? u.x : u.y;
          const int c0 = (k * KSTEP + 2 * i) % 3, c1 = (c0 + 1) % 3;
          v[i] = pack2<OutT>(
              __fmul_rn(__fsub_rn(byte_float(w, 2 * i % 4), mean[c0]),
                        inv[c0]),
              __fmul_rn(__fsub_rn(byte_float(w, (2 * i + 1) % 4), mean[c1]),
                        inv[c1]));
        }
      } else {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = (k * KSTEP + i) % 3;
          v[i] = __float_as_uint(
              __fmul_rn(__fsub_rn(byte_float(w, i), mean[c]), inv[c]));
        }
      }
      *reinterpret_cast<uint4*>(out0 + e0 * ELEM) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Issue the copies of band `band` into `slot`: every input row's run of
// R*gw bytes, CB bytes a copy, except pixel rows no MCU row of the band
// keeps and copies that start past the batch's last MCU (a copy that
// starts inside it ends inside M, since CB divides R*gw and M).
template <int CB>
__device__ __forceinline__ void issue_runs(const uint8_t* __restrict__ src,
                                           uint8_t* slot, long long stride,
                                           int rows_total, int need,
                                           int valid, int v) {
  constexpr int NN = RN * RN, PIECES = CHUNK / CB;
  for (int i = threadIdx.x; i < rows_total * PIECES; i += THREADS) {
    const int rho = i / PIECES, first = i % PIECES * CB;
    const int wy = ((rho / (RH * NN)) & (v - 1)) * RN + rho % RN;
    if (wy < need && first < valid) {
      __pipeline_memcpy_async(slot + rho * CHUNK + first,
                              src + rho * stride + first, CB);
    }
  }
}

__device__ __forceinline__ void rows_issue(const uint8_t* __restrict__ raw,
                                           uint8_t* slot, const Geometry& g,
                                           int band, int rows_total) {
  const int th = g.v * RN, total = g.batch * g.gh;
  const int r0 = band * g.band_rows;
  const int here = min(g.band_rows, total - r0);
  const int valid = here * g.gw;
  // Pixel rows a band needs: all of the first MCU row's that the window
  // keeps (a band that wraps into the next image holds its row 0).
  const int mrow0 = r0 % g.gh;
  const int first_y = mrow0 + here > g.gh ? 0 : mrow0 * th;
  const int need = min(th, g.out_h - first_y);
  const uint8_t* src = raw + static_cast<long long>(r0) * g.gw;
  if (g.copy == 16) {
    issue_runs<16>(src, slot, g.num_mcus, rows_total, need, valid, g.v);
  } else if (g.copy == 8) {
    issue_runs<8>(src, slot, g.num_mcus, rows_total, need, valid, g.v);
  } else {
    issue_runs<4>(src, slot, g.num_mcus, rows_total, need, valid, g.v);
  }
}

template <typename OutT>
__device__ __forceinline__ void row_form(const uint8_t* __restrict__ raw,
                                         const Geometry& g, const Norm& norm,
                                         OutT* __restrict__ out,
                                         uint8_t* smem) {
  constexpr int NN = RN * RN;
  constexpr int EPP = VEC / static_cast<int>(sizeof(OutT));
  const int tid = threadIdx.x, lane = tid % 32;
  const int th = g.v * RN, gy = g.v * RH, R = g.band_rows;
  const int rows_total = 3 * gy * NN, slot_bytes = rows_total * CHUNK;
  const int total = g.batch * g.gh, row_len = 3 * g.out_w;
  const int band = blockIdx.x, r0 = band * R;
  uint8_t* const stage = smem + slot_bytes;
  RowTable& t = *reinterpret_cast<RowTable*>(stage + stage_bytes(slot_bytes));

  // The band's copies first; the rest of the set-up while they fly.
  rows_issue(raw, smem, g, band, rows_total);
  __pipeline_commit();

  const auto estart = [&](int r) {   // output element of MCU row r
    const int b = r / g.gh, mrow = r - b * g.gh;
    return (static_cast<long long>(b) * g.out_h + min(mrow * th, g.out_h)) *
           row_len;
  };
  if (tid <= R) {
    const long long ebase = estart(r0) / LINE * LINE;
    const int r = min(r0 + tid, total);
    t.rowoff[tid] = static_cast<int>(estart(r) - ebase);
    if (tid < R) {
      const int mrow = r - r / g.gh * g.gh;
      t.nrows[tid] = r < total ? max(0, min(th, g.out_h - mrow * th)) : 0;
    }
    if (tid == 0) t.ebase = ebase;
  }
  // Stage T: this thread's pixel row and MCUs, if any.
  const int units = CHUNK / 4 * th;
  const int jw = (tid / 4) % 8, wy = tid / 32 * 4 + tid % 4;
  int dr[4], x0[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = 4 * jw + b;
    dr[b] = j < R * g.gw ? j / g.gw : -1;
    x0[b] = (j - (j / g.gw) * g.gw) * RTW;
    if (x0[b] >= g.out_w) dr[b] = -1;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (tid < units) {
    rows_transpose(smem, stage, t, jw, wy, dr, x0, gy * NN * CHUNK / 4,
                   row_len);
  }
  // Stage S, with the statistics rotated by the lane's first channel.
  float mean[3], inv[3];
  const int rot = lane * EPP % 3;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    mean[r] = pick3(norm.mean, (rot + r) % 3);
    inv[r] = pick3(norm.inv_std, (rot + r) % 3);
  }
  const long long ebase = t.ebase;
  const long long e_lo = ebase + t.rowoff[0], e_hi = ebase + t.rowoff[R];
  __syncthreads();
  rows_store<OutT>(stage, ebase, e_lo, e_hi, mean, inv,
                   reinterpret_cast<uint8_t*>(out));
}

// The banded form asks for 8 blocks an SM (32 registers a thread), which
// its code fits without spilling: left free, the compiler took 48 and an
// SM held 5, 6% slower at scale 2 on an H100.  0 leaves the row form's
// allocation free (4 blocks an SM by shared memory).
template <typename OutT, int N, int H, bool ROWS>
__global__ void __launch_bounds__(THREADS, ROWS ? 0 : 8)
raster_epilogue_kernel(const uint8_t* __restrict__ raw,
                       const int32_t* __restrict__ oys,
                       const int32_t* __restrict__ oxs,
                       const int32_t* __restrict__ dst_rows, Geometry g,
                       Norm norm, OutT* __restrict__ out) {
  static_assert(!ROWS || (N == RN && H == RH), "the row form is 16 px wide");
  extern __shared__ __align__(16) uint8_t smem[];
  if constexpr (ROWS) {
    row_form<OutT>(raw, g, norm, out, smem);
  } else {
    banded<OutT, N, H>(raw, oys, oxs, dst_rows, g, norm, out, smem);
  }
}

template <typename OutT>
using Kernel = void (*)(const uint8_t*, const int32_t*, const int32_t*,
                        const int32_t*, Geometry, Norm, OutT*);

template <typename OutT, int N>
Kernel<OutT> kernel_for_h(int h) {
  return h == 1 ? raster_epilogue_kernel<OutT, N, 1, false>
                : raster_epilogue_kernel<OutT, N, 2, false>;
}

// The banded form's kernel.
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

// The row form's kernel (n = RN, h = RH only).
template <typename OutT>
Kernel<OutT> rows_kernel() {
  return raster_epilogue_kernel<OutT, RN, RH, true>;
}

// Dynamic shared memory of a banded-form band: 3*gy*n*n rows of row_bytes
// and their padding.
int band_bytes(int v, int h, int n, int row_bytes) {
  const int rows = 3 * v * h * n * n;
  return rows * row_bytes + rows / n * ROW_PAD;
}

// Whether some run of a banded-form launch starts off the 16-byte grid:
// the input address or M off it, or the image width over more than one
// MCU row of the batch (a chunk's first MCU is a multiple of CHUNK).  The
// launch counter raster_shifted (ops/decode_kernel.py) reads this rule.
bool band_shifted(const void* raw, long long num_mcus, int batch, int gh,
                  int gw) {
  return reinterpret_cast<uintptr_t>(raw) % VEC != 0 ||
         num_mcus % VEC != 0 ||
         (gw % VEC != 0 && static_cast<long long>(batch) * gh > 1);
}

// A banded-form row: the granules of a run of up to CHUNK bytes at its
// shift.  32 bytes where every run plus its shift fits (no shift, or
// chunks of at most 17 MCUs), else 48.
int band_row_bytes(bool shifted, int gw) {
  const int widest = gw < CHUNK ? gw : CHUNK;
  return shifted && widest + VEC - 1 > CHUNK ? CHUNK + VEC : CHUNK;
}

// Dynamic shared memory of a row-form block: the band, the staging buffer
// and the table (49.5 KB at v = 2, over the 48 KB default).
int rows_bytes(int v) {
  return rows_smem(3 * v * RH * RN * RN * CHUNK);
}

bool supported(int v, int h, int n) {
  return (v == 1 || v == 2) && (h == 1 || h == 2) &&
         (n == 1 || n == 2 || n == 4 || n == 8);
}

// The row form's copy size, or 0 where it does not take the call.  It
// takes a full batch (no crop origins) whose transpose and stores move
// whole 16-byte granules: h*n = RTW = 16 (4:2:0 or 4:2:2 at scale 1: an
// MCU's row segment is 48 bytes), output rows a multiple of 16 pixels
// (3*out_w staging bytes and 3*out_w*elem output bytes on the 16-byte
// grid) and the output address on it, of images at most CHUNK MCUs wide,
// whose band run (R*gw MCUs), M and input address a 16-, 8- or 4-byte
// cp.async divides.  Each of these paths was timed faster than the banded
// form on an H100 (PERF.md, section 6); the row form lost where a band row
// leaves the 16-byte grid (500x375 at uint8, scale 2 at bfloat16) and at
// 4:4:4 (MCU rows 8 pixels wide), so everything else stays banded.
int rows_copy(const void* raw, long long num_mcus, int h, int n, int gw,
              int out_w, bool crop, const void* out) {
  if (crop || h * n != RTW || gw > CHUNK || out_w % VEC != 0 ||
      reinterpret_cast<uintptr_t>(out) % VEC != 0) {
    return 0;
  }
  const long long span = CHUNK / gw * gw;
  const uintptr_t at = reinterpret_cast<uintptr_t>(raw);
  for (int cb = VEC; cb >= 4; cb /= 2) {
    if (span % cb == 0 && num_mcus % cb == 0 && at % cb == 0) return cb;
  }
  return 0;
}

// Row-form kernels get the dynamic shared memory of their larger geometry
// (v = 2) and the largest carveout, once per device.
template <typename OutT>
cudaError_t rows_prepared() {
  static PerDevice prepared;
  return prepared.get([&] {
    return prepare(reinterpret_cast<const void*>(rows_kernel<OutT>()),
                   rows_bytes(2));
  });
}

template <typename OutT>
int launch(const void* raw, const void* oys, const void* oxs,
           const void* dst_rows, const Geometry& g, int h, int n,
           const Norm& norm, void* out, cudaStream_t stream) {
  const auto* in = static_cast<const uint8_t*>(raw);
  auto* dst = static_cast<OutT*>(out);
  if (g.band_rows == 0) {
    const unsigned blocks =
        static_cast<unsigned>(g.batch) * g.rows * g.chunks;
    const Kernel<OutT> kernel = kernel_for<OutT>(n, h);
    const int smem = band_bytes(g.v, h, n, g.row_bytes);
    kernel<<<blocks, THREADS, smem, stream>>>(
        in, static_cast<const int32_t*>(oys),
        static_cast<const int32_t*>(oxs),
        static_cast<const int32_t*>(dst_rows), g, norm, dst);
    return static_cast<int>(cudaGetLastError());
  }
  const cudaError_t e = rows_prepared<OutT>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned bands = static_cast<unsigned>(
      (static_cast<long long>(g.batch) * g.gh + g.band_rows - 1) /
      g.band_rows);
  const Kernel<OutT> kernel = rows_kernel<OutT>();
  kernel<<<bands, THREADS, rows_bytes(g.v), stream>>>(
      in, nullptr, nullptr, nullptr, g, norm, dst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes).  out_kind: 0 u8 (mean/inv_std unused),
// 1 float32, 2 bfloat16, 3 float16.  oys/oxs: int32 [batch] device arrays,
// or both null for a full batch.  dst_rows: int32 [batch] device array of
// each image's place in an output of out_batch images, or null (out holds
// the batch in order; out_batch is then not read).  Launches on `stream`,
// allocates nothing, returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int pjt_cuda_raster_epilogue(
    const void* raw, long long num_mcus, int v, int h, int n, int batch,
    int gh, int gw, int out_h, int out_w, const void* oys, const void* oxs,
    const void* dst_rows, int out_batch, int out_kind, float mean0,
    float mean1, float mean2, float inv0, float inv1, float inv2, void* out,
    void* stream) {
  if (dst_rows == nullptr) out_batch = batch;
  if (batch <= 0 || out_batch <= 0 || out_h <= 0 || out_w <= 0 ||
      !supported(v, h, n) || (oys == nullptr) != (oxs == nullptr) ||
      out_h > gh * v * n || out_w > gw * h * n ||
      static_cast<long long>(batch) * gh * gw > num_mcus) {
    return cudaErrorInvalidValue;
  }
  // Banded form: bands per image, the MCU rows and 32-column chunks an
  // output window can reach (a crop's origin may put it across one more of
  // each).  Row form: bands of R whole MCU rows over the batch.
  const int th = v * n, cw = CHUNK * h * n;
  const bool crop = oys != nullptr;
  int rows = (out_h - 1) / th + (crop ? 2 : 1);
  int chunks = (out_w - 1) / cw + (crop ? 2 : 1);
  if (rows > gh) rows = gh;
  if (chunks > (gw + CHUNK - 1) / CHUNK) chunks = (gw + CHUNK - 1) / CHUNK;
  if (static_cast<long long>(batch) * rows * chunks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  const int copy = rows_copy(raw, num_mcus, h, n, gw, out_w,
                             crop || dst_rows != nullptr, out);
  const int row_bytes =
      band_row_bytes(band_shifted(raw, num_mcus, batch, gh, gw), gw);
  const Geometry g{num_mcus, v,         batch, gh, gw, out_h,
                   out_w,    rows,      chunks, row_bytes,
                   copy ? CHUNK / gw : 0, copy, out_batch};
  const Norm norm{{mean0, mean1, mean2}, {inv0, inv1, inv2}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      return launch<uint8_t>(raw, oys, oxs, dst_rows, g, h, n, norm, out, s);
    case 1:
      return launch<float>(raw, oys, oxs, dst_rows, g, h, n, norm, out, s);
    case 2:
      return launch<__nv_bfloat16>(raw, oys, oxs, dst_rows, g, h, n, norm,
                                   out, s);
    case 3:
      return launch<__half>(raw, oys, oxs, dst_rows, g, h, n, norm, out, s);
  }
  return cudaErrorInvalidValue;
}

// 1 when pjt_cuda_raster_epilogue takes the row form for these arguments
// (crop: oys/oxs or dst_rows given), else 0.
extern "C" int pjt_cuda_raster_rows(const void* raw, long long num_mcus,
                                    int h, int n, int gw, int out_w, int crop,
                                    const void* out) {
  return rows_copy(raw, num_mcus, h, n, gw, out_w, crop != 0, out) != 0;
}
