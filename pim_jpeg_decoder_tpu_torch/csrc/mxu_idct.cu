// The 8x8 IDCT as float32 matrix products on Hopper's tensor cores (TF32
// operands, float32 sums): the A/B of the matrix unit against the integer
// butterflies (idct_stage_kernel in stage_kernels.cu).
//
// Replaces the Pallas kernels of tools/mxu_idct_ab.py:
//   mxu2pass_kernel<1> <- _kernel_mxu2pass: each 8-point pass one product
//                         with the [8, 8] basis A = reduced_idct_matrix(8),
//                         y1 = round(A X 2^-11), y2 = round(y1 A^T 2^-15)
//   mxu2pass_kernel<2> <- _kernel_mxu2pass(pieces=2): each pass four
//                         products of 8-bit hi/lo pieces of A and of its
//                         operand, recombined as hh*65536 + hl*256 +
//                         lh*256 + ll (the exact formulation's op count)
//   mxu64_kernel       <- _kernel_mxu64: both passes as one product with
//                         the [64, 64] kron(A, A), round(y 2^-26)
// Each takes int16 [num_blocks, 64] (the [M, g, 64] wire of the stage
// kernels, index v*8 + h) and writes int16 [num_blocks, 64], index r*8 + p,
// clipped to [-128, 127]: the JAX tool's [g, 64, M] output transposed.
// Rounding is rintf (half to even, as jnp.round), never roundf.
//
// The products run on the tensor cores with
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, the operands rounded
// to TF32 by cvt.rna.tf32.f32 (to nearest; the unit would truncate raw
// float32 bits).  One MMA takes a 16x8 A operand: the two-pass kernel
// computes each pass transposed, D = X^T A^T, so the 16 rows are the 8 rows
// of two 8x8 blocks and no row is padding; the second pass reads the first
// pass's D back from shared memory transposed.  The 64-point kernel is a
// [16 blocks, 64] x [64, 64] product per warp, 8 x 8 MMAs into 32 float32
// accumulators.  On the tool's inputs (|x| < 2^11) the hi/lo pieces are
// integers below 2^8, exact in TF32, and the products' sums stay below
// 2^24, so mxu2pass4 equals its float32 plain version
// bit for bit; its recombination uses __fmul_rn / __fadd_rn in the JAX
// order, so nvcc cannot contract it into FMAs.  pieces=1 and the 64-point
// product round their 12-bit (and 24-bit) basis entries to TF32's 11
// significant bits and differ from float32 by 1-2 in a few percent of
// samples.
//
// What bounds them on an H100: bytes.  At the tool's geometry (4:2:0,
// M=16,384: 98,304 blocks) each moves 12.6 MB in and 12.6 MB out, ~7.5 us at
// 3.35 TB/s; the TF32 work is 0.2-0.8 GFLOP, 0.4-1.6 us at 495 TFLOP/s.  The
// design is the simple one: a CUDA block stages 64 blocks (8 KB of int16)
// into shared memory as float32 with 16-byte loads, its four warps run the
// MMAs out of shared memory, and the results leave with 16-byte stores.
// Shared rows of the 64-point kernel are padded to 68 words, so the
// fragment loads of a warp fall on 32 different banks.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_BLOCKS = WARPS * 16;   // 8x8 blocks per CUDA block
constexpr int CHUNKS = TILE_BLOCKS * 8;   // 16-byte chunks of a tile
constexpr int ROW64 = 68;                 // padded row of the 64-point tiles
constexpr int MXU64_MAX_GRID = 132 * 4;   // blocks walk the tiles beyond

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d = a (16x8, row-major) * b (8x8, column-major) + c on the tensor cores.
// Fragments (lane = 4 * gid + tid): a0 (gid, tid), a1 (gid + 8, tid),
// a2 (gid, tid + 4), a3 (gid + 8, tid + 4); b0 (k = tid, n = gid),
// b1 (tid + 4, gid); c/d0 (gid, 2 tid), d1 (gid, 2 tid + 1),
// d2 (gid + 8, 2 tid), d3 (gid + 8, 2 tid + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2],
                                    const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// int16 blocks [b0, b0 + nb) -> float32 rows of `row` words in `tile`
// (blocks past nb are zeros).
__device__ __forceinline__ void load_tile(const int16_t* __restrict__ src,
                                          int nb, float* tile, int row) {
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int blk = c / 8, e = (c % 8) * 8;
    int4 v = make_int4(0, 0, 0, 0);
    if (blk < nb) v = __ldg(reinterpret_cast<const int4*>(src) + c);
    const uint32_t w[4] = {static_cast<uint32_t>(v.x),
                           static_cast<uint32_t>(v.y),
                           static_cast<uint32_t>(v.z),
                           static_cast<uint32_t>(v.w)};
    float* dst = tile + blk * row + e;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[2 * j] = static_cast<float>(static_cast<int16_t>(w[j] & 0xffffu));
      dst[2 * j + 1] = static_cast<float>(static_cast<int16_t>(w[j] >> 16));
    }
  }
}

// float32 rows of `row` words (integers in the int16 range) -> int16
// blocks [b0, b0 + nb).
__device__ __forceinline__ void store_tile(const float* tile, int row,
                                           int nb,
                                           int16_t* __restrict__ dst) {
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int blk = c / 8, e = (c % 8) * 8;
    if (blk >= nb) continue;
    const float* s = tile + blk * row + e;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = (static_cast<uint32_t>(static_cast<int>(s[2 * j])) & 0xffffu) |
             (static_cast<uint32_t>(static_cast<int>(s[2 * j + 1])) << 16);
    }
    reinterpret_cast<int4*>(dst)[c] =
        make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                  static_cast<int>(w[2]), static_cast<int>(w[3]));
  }
}

__device__ __forceinline__ float clip_sample(float y) {
  return fminf(fmaxf(y, -128.0f), 127.0f);
}

// jnp.floor(x / 256.0) and x - hi * 256.0, exactly.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = floorf(__fmul_rn(x, 1.0f / 256.0f));
  lo = __fsub_rn(x, __fmul_rn(hi, 256.0f));
}

// One pass on a pair of blocks: d = X^T B for the A operand fragments
// x[4] (float32) and the basis fragments b (TF32, [piece][2]), then
// round(d * inv).  PIECES == 2 splits x into hi/lo and recombines four
// products in the JAX order.
template <int PIECES>
__device__ __forceinline__ void matpass(const float (&x)[4],
                                        const uint32_t (&b)[2][2], float inv,
                                        float (&y)[4]) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (PIECES == 1) {
    const uint32_t a[4] = {tf32(x[0]), tf32(x[1]), tf32(x[2]), tf32(x[3])};
    mma(y, a, b[0], zero);
  } else {
    uint32_t x_hi[4], x_lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hi, lo;
      split(x[i], hi, lo);
      x_hi[i] = tf32(hi);
      x_lo[i] = tf32(lo);
    }
    // b[0]: the basis's hi pieces a_hi, b[1]: its lo pieces a_lo.
    float hh[4], hl[4], lh[4], ll[4];
    mma(hh, x_hi, b[0], zero);   // dot(a_hi, x_hi)
    mma(hl, x_lo, b[0], zero);   // dot(a_hi, x_lo)
    mma(lh, x_hi, b[1], zero);   // dot(a_lo, x_hi)
    mma(ll, x_lo, b[1], zero);   // dot(a_lo, x_lo)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(hh[i], 65536.0f),
                                           __fmul_rn(hl[i], 256.0f)),
                                 __fmul_rn(lh[i], 256.0f)),
                       ll[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) y[i] = rintf(__fmul_rn(y[i], inv));
}

template <int PIECES>
__global__ void __launch_bounds__(THREADS)
mxu2pass_kernel(const int16_t* __restrict__ deq,
                const float* __restrict__ mat, int16_t* __restrict__ out,
                long long num_blocks, float inv1, float inv2) {
  __shared__ float tile[TILE_BLOCKS * 64];
  const long long b0 = static_cast<long long>(blockIdx.x) * TILE_BLOCKS;
  const long long left = num_blocks - b0;
  const int nb = left < TILE_BLOCKS ? static_cast<int>(left) : TILE_BLOCKS;
  load_tile(deq + b0 * 64, nb, tile, 64);

  const int lane = threadIdx.x % 32, gid = lane >> 2, tid = lane & 3;
  // B = A^T: b0 = A[gid][tid], b1 = A[gid][tid + 4] (hi/lo pieces for 2).
  uint32_t b[2][2];
  {
    const float a0 = __ldg(mat + gid * 8 + tid);
    const float a1 = __ldg(mat + gid * 8 + tid + 4);
    if (PIECES == 1) {
      b[0][0] = tf32(a0);
      b[0][1] = tf32(a1);
      b[1][0] = b[1][1] = 0u;
    } else {
      float hi0, lo0, hi1, lo1;
      split(a0, hi0, lo0);
      split(a1, hi1, lo1);
      b[0][0] = tf32(hi0);
      b[0][1] = tf32(hi1);
      b[1][0] = tf32(lo0);
      b[1][1] = tf32(lo1);
    }
  }
  __syncthreads();

  float* warp_tile = tile + (threadIdx.x / 32) * 16 * 64;
  // Pass 1 on blocks (2j, 2j + 1): A operand row h + 8*blk, column v, is
  // X[v][h]; d row h + 8*blk, column r, is (A X)[r][h], kept as y1[r][h].
  for (int j = 0; j < 8; ++j) {
    float* p = warp_tile + 2 * j * 64;
    const float x[4] = {p[tid * 8 + gid], p[64 + tid * 8 + gid],
                        p[(tid + 4) * 8 + gid], p[64 + (tid + 4) * 8 + gid]};
    float y[4];
    matpass<PIECES>(x, b, inv1, y);
    __syncwarp();
    p[(2 * tid) * 8 + gid] = y[0];
    p[(2 * tid + 1) * 8 + gid] = y[1];
    p[64 + (2 * tid) * 8 + gid] = y[2];
    p[64 + (2 * tid + 1) * 8 + gid] = y[3];
  }
  __syncwarp();
  // Pass 2: A operand row r + 8*blk, column h, is y1[r][h]; d row
  // r + 8*blk, column p, is (y1 A^T)[r][p], stored at r*8 + p.
  for (int j = 0; j < 8; ++j) {
    float* p = warp_tile + 2 * j * 64;
    const float x[4] = {p[gid * 8 + tid], p[64 + gid * 8 + tid],
                        p[gid * 8 + tid + 4], p[64 + gid * 8 + tid + 4]};
    float y[4];
    matpass<PIECES>(x, b, inv2, y);
    __syncwarp();
    p[gid * 8 + 2 * tid] = clip_sample(y[0]);
    p[gid * 8 + 2 * tid + 1] = clip_sample(y[1]);
    p[64 + gid * 8 + 2 * tid] = clip_sample(y[2]);
    p[64 + gid * 8 + 2 * tid + 1] = clip_sample(y[3]);
  }
  __syncthreads();
  store_tile(tile, 64, nb, out + b0 * 64);
}

__global__ void __launch_bounds__(THREADS)
mxu64_kernel(const int16_t* __restrict__ deq, const float* __restrict__ mat,
             int16_t* __restrict__ out, long long num_blocks, float inv) {
  __shared__ uint32_t basis[64 * ROW64];   // kron(A, A)[o][i] as TF32
  __shared__ float tile[TILE_BLOCKS * ROW64];
  for (int i = threadIdx.x; i < 64 * 64; i += THREADS) {
    basis[(i / 64) * ROW64 + i % 64] = tf32(__ldg(mat + i));
  }
  const int lane = threadIdx.x % 32, gid = lane >> 2, tid = lane & 3;
  const int wrow = (threadIdx.x / 32) * 16;   // the warp's first block
  const long long tiles = (num_blocks + TILE_BLOCKS - 1) / TILE_BLOCKS;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long b0 = t * TILE_BLOCKS;
    const long long left = num_blocks - b0;
    const int nb = left < TILE_BLOCKS ? static_cast<int>(left) : TILE_BLOCKS;
    __syncthreads();   // the previous tile's stores have read `tile`
    load_tile(deq + b0 * 64, nb, tile, ROW64);
    __syncthreads();
    // [16 blocks, 64] x kron(A, A)^T: A operand row = block, column =
    // input index; B (k = input index, n = output index) = basis[n][k].
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
    }
    const float* rows = tile + wrow * ROW64;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int col = k * 8 + tid;
      const uint32_t a[4] = {tf32(rows[gid * ROW64 + col]),
                             tf32(rows[(gid + 8) * ROW64 + col]),
                             tf32(rows[gid * ROW64 + col + 4]),
                             tf32(rows[(gid + 8) * ROW64 + col + 4])};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const uint32_t* bn = basis + (n * 8 + gid) * ROW64 + col;
        const uint32_t b[2] = {bn[0], bn[4]};
        mma(acc[n], a, b, acc[n]);
      }
    }
    __syncwarp();
    float* dst = tile + wrow * ROW64;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int o = n * 8 + 2 * tid;
      dst[gid * ROW64 + o] = clip_sample(rintf(__fmul_rn(acc[n][0], inv)));
      dst[gid * ROW64 + o + 1] =
          clip_sample(rintf(__fmul_rn(acc[n][1], inv)));
      dst[(gid + 8) * ROW64 + o] =
          clip_sample(rintf(__fmul_rn(acc[n][2], inv)));
      dst[(gid + 8) * ROW64 + o + 1] =
          clip_sample(rintf(__fmul_rn(acc[n][3], inv)));
    }
    __syncthreads();
    store_tile(tile, ROW64, nb, out + b0 * 64);
  }
}

unsigned grid_for(long long num_blocks) {
  return static_cast<unsigned>((num_blocks + TILE_BLOCKS - 1) / TILE_BLOCKS);
}

}  // namespace

// C entry points (bound with ctypes).  Each launches on `stream`, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = launched).
// deq and out: int16 [num_blocks, 64], 16-byte aligned; mat: float32 on the
// card, [8, 8] reduced_idct_matrix(8) or [64, 64] its Kronecker square.

// pieces = 1 or 2; inv1 = 2^-(CONST_BITS - PASS1_BITS),
// inv2 = 2^-(CONST_BITS + PASS1_BITS).
extern "C" int pjt_cuda_mxu2pass(const void* deq, const void* mat, void* out,
                                 long long num_blocks, int pieces, float inv1,
                                 float inv2, void* stream) {
  if (num_blocks <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* in = static_cast<const int16_t*>(deq);
  const float* m = static_cast<const float*>(mat);
  int16_t* o = static_cast<int16_t*>(out);
  if (pieces == 1) {
    mxu2pass_kernel<1><<<grid_for(num_blocks), THREADS, 0, st>>>(
        in, m, o, num_blocks, inv1, inv2);
  } else if (pieces == 2) {
    mxu2pass_kernel<2><<<grid_for(num_blocks), THREADS, 0, st>>>(
        in, m, o, num_blocks, inv1, inv2);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// inv = 2^-(2 CONST_BITS).
extern "C" int pjt_cuda_mxu64(const void* deq, const void* mat, void* out,
                              long long num_blocks, float inv, void* stream) {
  if (num_blocks <= 0) return cudaErrorInvalidValue;
  const unsigned tiles = grid_for(num_blocks);
  mxu64_kernel<<<tiles < MXU64_MAX_GRID ? tiles : MXU64_MAX_GRID, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(deq), static_cast<const float*>(mat),
      static_cast<int16_t*>(out), num_blocks, inv);
  return static_cast<int>(cudaGetLastError());
}
