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
// of two 8x8 blocks and no row is padding.  The 64-point kernel is a
// [16 blocks, 64] x [64, 64] product per warp, 8 x 8 MMAs into 32 float32
// accumulators.  On the tool's inputs (|x| < 2^11) the hi/lo pieces are
// integers below 2^8, exact in TF32, and the products' sums stay below
// 2^24, so mxu2pass4 equals its float32 plain version bit for bit.
// pieces=1 and the 64-point product round their 12-bit (and 24-bit) basis
// entries to TF32's 11 significant bits and differ from float32 by 1-2 in
// a few percent of samples.
//
// Their bound on an H100 is bytes.  At the tool's geometry (4:2:0,
// M=16,384: 98,304 blocks) each moves 12.6 MB in and 12.6 MB out, 7.51 us
// at 3.35 TB/s; the TF32 work is 0.2-0.8 GFLOP, 0.4-1.6 us at 495 TFLOP/s.
//
// mxu2pass_kernel's first form staged 64 blocks a CUDA block as float32 in
// shared memory (16 KB, scalar stores 8 words apart), one tile a block with
// synchronous loads, the pass-1 results and the output back through that
// tile with 2-way bank conflicts: 18.2 [23.4-24.0] us with pieces 1 [2] on
// an H100 80GB HBM3 at 700 W (PERF.md), 42% [32%] of the byte bound.  The
// redesign:
//   - a warp owns kTiles tiles of M2_TILE blocks (1 KB of int16 a tile, one
//     contiguous 128-byte-aligned run): lane 0 issues every tile's bulk
//     copy (cp.async.bulk, Hopper's 1-D TMA, only the valid blocks of a
//     ragged tile) at once, each completing a transaction count on its own
//     mbarrier, so the second tile lands while the first computes.  Warps
//     share no barrier.  Pieces 2, about twice the instructions a block,
//     takes two tiles a warp, pieces 1 one.  A persistent grid whose warps
//     walk their tiles through a 2-4 stage ring (tried first: 1 or 2 KB
//     tiles, contiguous or strided shares, bulk or 16-byte copies) lost to
//     this at M=196,608 by more than a tenth, and so did copy-only kernels
//     of the same persistent shape against one-tile warps (PERF.md);
//   - fragments read straight from the int16 tile (2-byte loads, a block's
//     32 words over 32 banks), every pair's before the first product (the
//     tile and the scratch may alias as far as the compiler knows, so it
//     would not hoist them past a store), converted in registers; pieces 2
//     splits an int16 exactly into (x >> 8, x & 255), which TF32 holds;
//   - between the passes a per-warp float32 scratch of [block][h][r]
//     (8-byte stores of two r, 4-byte loads down h), one __syncwarp;
//   - the pass-2 results leave rounded, clipped and converted by one
//     saturating cvt.rni.sat.s8.f32 each, packed as int16 pairs by one
//     prmt, 4 bytes a lane: each warp store writes a block's 128
//     contiguous bytes.
// The bank claims of the three shared-memory accesses are static_asserts
// on the index functions the kernel uses (mxu2pass_conflict_free).  The
// arithmetic is the first form's: the same products with the same
// contraction order (k = v, then k = h), TF32 operands rounded to nearest
// with ties away (cvt.rna's rounding, as tf32_rna), rintf's rounding and
// the per-pass scale, the pieces-2 recombination in the JAX order (its
// terms exact and its scale a power of two, so fused multiply-adds round
// as the __fmul_rn / __fadd_rn chain does), so the output equals the first
// form's byte for byte.  On an H100 80GB HBM3 at 700 W (PERF.md;
// tools/decode_ab.py against the first form, digests equal): pieces 1
// [2] 12.46-12.54 [15.87-15.98] us at M=16,384 (was 17.98-18.03
// [23.38-23.54]) and 105.6-105.7 [117.0-117.1] us at M=196,608 (was 127.0
// [176.1-176.2]); 32 [64] registers, 12,320 [16,448] B of shared memory,
// 16 [8] blocks an SM.  Pieces 1 is bound by bytes now (60% of 7.51 us,
// level with the butterfly stage at M=196,608); pieces 2 by issue (1,124
// SASS instructions for a warp's 16 blocks, four products and their
// recombination a pass).
// mxu64_kernel's first form was a persistent grid of at most 528 CUDA
// blocks, each converting the 16 KB basis to TF32 in shared memory, then
// walking 64-block tiles staged as float32 with synchronous 16-byte loads,
// two __syncthreads a tile and the results back through the tile: 20.45
// us at M=16,384 on an H100 80GB HBM3 at 700 W (PERF.md), 37% of the byte
// bound.  The redesign takes mxu2pass_kernel's shape where the card
// agreed (variants timed against each other in one call each by a
// throwaway script, their numbers not kept):
//   - short-lived warps: a warp owns M64_UNITS units of M64_PAIR MMA tiles
//     of 16 blocks (64 blocks, 8 KB of int16), copies every unit's valid
//     blocks at once, works through them and exits;
//   - loads: 16-byte cp.async into rows 144 bytes apart, so that the 8 rows
//     of an A fragment load fall on 8 groups of banks, one commit group a
//     unit.  Bulk copies (cp.async.bulk on an mbarrier a unit, as
//     mxu2pass_kernel does) were built and lost: a contiguous copy cannot
//     pad the rows, so they took a copy a block (128 bytes: slower at both
//     sizes) or, with rows interleaved in groups so that a copy held 4
//     blocks, one per 512 bytes (slower at M=16,384, level at 196,608);
//   - the basis is the design question this kernel adds: 64 x 64 TF32, 16
//     KB, read as 64 B of fragments an MMA.  Each CUDA block of M64_WARPS
//     warps stages it once in fragment order (one 8-byte load an MMA), with
//     coalesced 16-byte loads all issued before the first conversion, while
//     its copies are in flight, behind the kernel's one __syncthreads; the
//     M64_PAIR tiles of a unit share every B fragment (64 accumulators a
//     lane), so a block's 256 8x8 blocks pay 64 bytes each of L2 reads for
//     the basis and 4 shared-memory wavefronts each for its fragments.
//     Staging with 4-byte loads cost far more than this form; a kernel
//     that skipped the staging (wrong bytes) was faster by less than a
//     tenth at both sizes.  Eight warps a block (half the staging traffic)
//     lost at M=16,384 (192 blocks on 132 SMs) and was about level at
//     M=196,608; 3 blocks an SM and one tile a unit lost.  A cluster of 2
//     or 4 CTAs that staged a share each into every CTA's shared memory
//     (distributed shared memory, the L2 reads halved or quartered) lost at
//     both sizes, the more CTAs the more: the cluster barrier cost more
//     than the reads it saved.  A TMA multicast would need the same
//     barrier.  Forming B in registers from kron(A, A)'s factors (A[nt][kt] *
//     A[gid][tid], exact) would drop the staging, but assumes the structure
//     of mat, which the C entry point cannot check without a copy to the
//     host; it is not taken, and any mat is computed as given;
//   - A fragments read straight from the int16 tile (2-byte loads) and
//     rounded in registers (tf32_rna);
//   - results scaled, rounded, clipped and converted by one saturating
//     cvt.rni.sat.s8.f32 each, packed as int16 pairs by one prmt, and
//     stored from the accumulators: lanes tid and tid ^ 1 swap one word,
//     so each 8-byte warp store writes a whole 32-byte sector of each of
//     16 blocks, and four of them a block's 128 bytes.  No __syncthreads
//     between tiles, no result through shared memory.
// The arithmetic is the first form's: the same TF32 operands (cvt.rna's
// rounding), mma.sync.m16n8k8 into each accumulator over k-steps 0..7 in
// order, __fmul_rn by inv and rintf's rounding, so the output equals the
// first form's byte for byte.  On an H100 80GB HBM3 at 700 W (PERF.md;
// tools/decode_ab.py against the first form, digests equal): 15.36-15.54
// us at M=16,384 (was 20.40-20.45) and 116.6 us at M=196,608 (was
// 179.2-179.3), 49% and 77% of the byte bound, against 21.9 and 220.0 us
// for the TF32 torch.matmul product alone; 128 registers, 53,248 B of
// dynamic shared memory, 4 blocks an SM, 28.7 warp instructions a block (4
// HMMA).  What bounds it now: at M=16,384 one wave of copies, staging,
// four HMMA a block and stores; at M=196,608 bytes, with the staging's L2
// reads (64 bytes a block) on top.

#include <cstdint>

#include <cuda_runtime.h>

#include "decode_tile.cuh"   // phase_conflict_free

namespace {

// mxu64_kernel: CUDA blocks of M64_WARPS warps sharing one copy of the
// basis in shared memory; each warp takes M64_UNITS units of M64_PAIR MMA
// tiles of M64_TILE blocks side by side (the tiles of a unit share every
// basis fragment), each unit one cp.async group.
constexpr int M64_WARPS = 4;
constexpr int M64_THREADS = M64_WARPS * 32;
constexpr int M64_MIN_BLOCKS = 4;         // resident blocks an SM must fit
constexpr int M64_TILE = 16;              // blocks an MMA tile (A's rows)
constexpr int M64_PAIR = 2;               // MMA tiles a unit
constexpr int M64_UNIT = M64_TILE * M64_PAIR;
constexpr int M64_UNITS = 2;              // units a warp
constexpr int M64_WARP_BLOCKS = M64_UNIT * M64_UNITS;
constexpr int M64_ROW = 144;              // bytes a block in shared memory
constexpr int M64_BASIS = 64 * 32 * 8;    // bytes of the fragment-order basis
constexpr int M64_SMEM =
    M64_BASIS + M64_WARPS * M64_WARP_BLOCKS * M64_ROW;   // dynamic bytes

// mxu2pass_kernel: CUDA blocks of M2_WARPS warps, each warp with its own
// kTiles tiles of M2_TILE blocks in shared memory and its own pass-1
// scratch.
constexpr int M2_WARPS = 4;
constexpr int M2_THREADS = M2_WARPS * 32;
constexpr int M2_MIN_BLOCKS = 8;          // resident blocks an SM must fit
constexpr int M2_TILE = 8;                // blocks a tile (1 KB)
constexpr int M2_TILES_P1 = 1;            // tiles a warp, pieces 1
constexpr int M2_TILES_P2 = 2;            // tiles a warp, pieces 2
constexpr int M2_PAIRS = M2_TILE / 2;     // MMA pairs a tile

// Tiles a warp takes: pieces 2 runs about twice the instructions a block,
// and a second tile landing while the first computes keeps its loads in
// flight.
template <int PIECES>
constexpr int kTiles = PIECES == 1 ? M2_TILES_P1 : M2_TILES_P2;
constexpr int M2_PAIR_WORDS = 128;        // scratch of one pair: 2 x 64

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

// The shared-memory address of p, for the mbarrier and bulk-copy PTX.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase on one arrival and its transactions.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on bar expecting `bytes`, and copy them from global src to shared
// dst with one bulk copy that completes them on bar (both addresses
// 16-byte aligned, bytes a multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// jnp.floor(x / 256.0) and x - hi * 256.0, exactly.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = floorf(__fmul_rn(x, 1.0f / 256.0f));
  lo = __fsub_rn(x, __fmul_rn(hi, 256.0f));
}

// --- mxu2pass_kernel ----------------------------------------------------------
//
// One MMA takes a pair of blocks (P0, P1).  Pass 1: A row gid is (P0, h =
// gid), row gid + 8 (P1, h = gid), column k = v; D column n = r.  Pass 2:
// A row gid is (P0, r = gid), row gid + 8 (P1, r = gid), column k = h; D
// column n = p.  The index functions below give, for lane (gid, tid), the
// int16 a pass-1 fragment reads in the pair's 128 values (P1 64 after P0),
// the float32 words of the pass-1 scratch it writes and reads ([block][h]
// [r], 64 words a block), and the static_assert below holds their bank
// claims.

// Pass-1 A fragment i (0..3) of lane: X_blk[v][h] at blk*64 + v*8 + h.
__host__ __device__ constexpr int pass1_elem(int lane, int i) {
  return (i & 1) * 64 + ((lane & 3) + 4 * (i >> 1)) * 8 + (lane >> 2);
}

// First of the two words lane stores for pass-1 D fragments 2q, 2q + 1:
// y1_blk[r = 2 tid, 2 tid + 1][h = gid] of block q.
__host__ __device__ constexpr int scratch_store(int lane, int q) {
  return q * 64 + (lane >> 2) * 8 + 2 * (lane & 3);
}

// Pass-2 A fragment i of lane: y1_blk[r = gid][h = tid + 4 (i >> 1)] of
// block i & 1.
__host__ __device__ constexpr int scratch_load(int lane, int i) {
  return (i & 1) * 64 + ((lane & 3) + 4 * (i >> 1)) * 8 + (lane >> 2);
}

// The claims: each pass-1 fragment load (32 lanes, 2-byte, lanes of one
// word share it), each scratch store (two phases of 16 lanes, 8-byte) and
// each scratch load (32 lanes, 4-byte) falls on distinct banks.
constexpr bool mxu2pass_conflict_free() {
  for (int i = 0; i < 4; ++i) {
    int w[32] = {};
    for (int l = 0; l < 32; ++l) w[l] = pass1_elem(l, i) / 2;
    if (!phase_conflict_free(w, 32, 1)) return false;
    for (int l = 0; l < 32; ++l) w[l] = scratch_load(l, i);
    if (!phase_conflict_free(w, 32, 1)) return false;
  }
  for (int q = 0; q < 2; ++q) {
    for (int half = 0; half < 32; half += 16) {
      int w[16] = {};
      for (int l = 0; l < 16; ++l) w[l] = scratch_store(half + l, q);
      if (!phase_conflict_free(w, 16, 2)) return false;
    }
  }
  return true;
}
static_assert(mxu2pass_conflict_free(), "mxu2pass shared-memory banks");
static_assert(M2_TILE % 2 == 0 && M2_TILE * 128 % 16 == 0,
              "a tile is whole pairs and a whole number of 16-byte chunks");

// cvt.rna.tf32.f32 of a finite float32 as the tensor core reads it: adding
// half an ulp of TF32 at bit 13 rounds the magnitude to nearest, ties away
// from zero, and the unit ignores the 13 bits below (as CUTLASS's
// round_half_ulp_truncate relies on): one integer add where cvt.rna also
// tests for NaN and infinity, which these integers never are.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// An A operand as TF32 fragments: pieces 1 in hi, pieces 2 its hi and lo
// 8-bit pieces.
struct Operand {
  uint32_t hi[4], lo[4];
};

// Pass 1's operand from the int16 coefficients.  Pieces 2: jnp.floor(x /
// 256) and x - 256 hi of an integer are x >> 8 and x & 255, which TF32
// holds exactly (cvt.rna would leave them as they are).
template <int PIECES>
__device__ __forceinline__ Operand int_operand(const int32_t (&x)[4]) {
  Operand a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (PIECES == 1) {
      a.hi[i] = tf32_rna(static_cast<float>(x[i]));
      a.lo[i] = 0u;
    } else {
      a.hi[i] = __float_as_uint(static_cast<float>(x[i] >> 8));
      a.lo[i] = __float_as_uint(static_cast<float>(x[i] & 255));
    }
  }
  return a;
}

// Pass 2's operand from the float32 pass-1 results (integers).  Pieces 2:
// split(), with lo = x - 256 hi as one fused multiply-add (256 hi is exact,
// so it rounds as __fsub_rn does); lo is an integer in [0, 256), exact in
// TF32.
template <int PIECES>
__device__ __forceinline__ Operand float_operand(const float (&x)[4]) {
  Operand a;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (PIECES == 1) {
      a.hi[i] = tf32_rna(x[i]);
      a.lo[i] = 0u;
    } else {
      const float hi = floorf(__fmul_rn(x[i], 1.0f / 256.0f));
      a.hi[i] = tf32_rna(hi);
      a.lo[i] = __float_as_uint(__fmaf_rn(hi, -256.0f, x[i]));
    }
  }
  return a;
}

// One pass on a pair of blocks: d = X^T B for the operand a and the basis
// fragments b (TF32, [piece][2]), scaled: y = d * inv, which the caller
// rounds (rintf after pass 1, the saturating conversion after pass 2).
// Pieces 2 recombines its four products in the JAX order,
// ((hh*65536 + hl*256) + lh*256) + ll, then scales by inv: inv is a power
// of two, and every term and partial sum is an integer far from the
// float32 range's ends, so scaling each term first rounds each sum the
// same way, and hh*65536*inv, hl*256*inv, lh*256*inv and ll*inv are exact:
// one multiply and three fused multiply-adds give the first form's
// __fmul_rn / __fadd_rn chain bit for bit.
template <int PIECES>
__device__ __forceinline__ void matpass(const Operand& a,
                                        const uint32_t (&b)[2][2], float inv,
                                        float (&y)[4]) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (PIECES == 1) {
    mma(y, a.hi, b[0], zero);
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = __fmul_rn(y[i], inv);
  } else {
    // b[0]: the basis's hi pieces a_hi, b[1]: its lo pieces a_lo.
    float hh[4], hl[4], lh[4], ll[4];
    mma(hh, a.hi, b[0], zero);   // dot(a_hi, x_hi)
    mma(hl, a.lo, b[0], zero);   // dot(a_hi, x_lo)
    mma(lh, a.hi, b[1], zero);   // dot(a_lo, x_hi)
    mma(ll, a.lo, b[1], zero);   // dot(a_lo, x_lo)
    const float s8 = 256.0f * inv;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float t = __fmaf_rn(
          lh[i], s8, __fmaf_rn(hl[i], s8, __fmul_rn(hh[i], 65536.0f * inv)));
      y[i] = __fmaf_rn(ll[i], inv, t);
    }
  }
}

// rintf, then the clip to [-128, 127], as one conversion: cvt.rni rounds
// half to even, as rintf does, and .sat clamps to the int8 range, whose
// ends are the clip's (round then clamp equals clamp then round for
// integer bounds).  The low byte holds the sample.
__device__ __forceinline__ uint32_t to_sample(float y) {
  uint32_t r;
  asm("cvt.rni.sat.s8.f32 %0, %1;" : "=r"(r) : "f"(y));
  return r;
}

// Bytes 0 and 4 of (lo, hi), each sign-extended to 16 bits: PTX prmt's
// selectors 8 and 12 replicate the sign of bytes 0 and 4 (__byte_perm
// reads only the low 3 bits of a selector).
__device__ __forceinline__ uint32_t sign_pack(uint32_t lo, uint32_t hi) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, 0xC480;" : "=r"(r) : "r"(lo), "r"(hi));
  return r;
}

// Two samples as one word of int16 (lo first).
__device__ __forceinline__ uint32_t pack_samples(float lo, float hi) {
  return sign_pack(to_sample(lo), to_sample(hi));
}

// Both passes over one tile into dst, of which the first nb blocks are
// stored: pass 1 on every pair, y1[r][h] of both blocks to the scratch as
// float32 (integers), one __syncwarp, then pass 2, whose d0, d1 are
// samples (r = gid, p = 2 tid, 2 tid + 1) of the pair's first block and d2,
// d3 of its second: one word each, so a warp store writes a block's 128
// bytes.  Each pass loads every pair's fragments before its first product
// (the tile and the scratch may alias as far as the compiler knows, so it
// would not hoist them), and a ragged tile's pairs past nb run on stale
// blocks and are never stored.
template <int PIECES>
__device__ __forceinline__ void run_tile(const int16_t* tile, float* sc,
                                         int16_t* __restrict__ dst, int nb,
                                         int lane, const uint32_t (&b)[2][2],
                                         float inv1, float inv2) {
  int32_t x1[M2_PAIRS][4];
#pragma unroll
  for (int j = 0; j < M2_PAIRS; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x1[j][i] = tile[j * 128 + pass1_elem(lane, i)];
  }
#pragma unroll
  for (int j = 0; j < M2_PAIRS; ++j) {
    float y[4];
    matpass<PIECES>(int_operand<PIECES>(x1[j]), b, inv1, y);
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = rintf(y[i]);
    float* q = sc + j * M2_PAIR_WORDS;
    *reinterpret_cast<float2*>(q + scratch_store(lane, 0)) =
        make_float2(y[0], y[1]);
    *reinterpret_cast<float2*>(q + scratch_store(lane, 1)) =
        make_float2(y[2], y[3]);
  }
  __syncwarp();
  float x2[M2_PAIRS][4];
#pragma unroll
  for (int j = 0; j < M2_PAIRS; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x2[j][i] = sc[j * M2_PAIR_WORDS + scratch_load(lane, i)];
    }
  }
#pragma unroll
  for (int j = 0; j < M2_PAIRS; ++j) {
    float y[4];
    matpass<PIECES>(float_operand<PIECES>(x2[j]), b, inv2, y);
    uint32_t* o = reinterpret_cast<uint32_t*>(dst + j * 128) + lane;
    if (2 * j < nb) o[0] = pack_samples(y[0], y[1]);
    if (2 * j + 1 < nb) o[32] = pack_samples(y[2], y[3]);
  }
}

template <int PIECES>
__global__ void __launch_bounds__(M2_THREADS, M2_MIN_BLOCKS)
mxu2pass_kernel(const int16_t* __restrict__ deq,
                const float* __restrict__ mat, int16_t* __restrict__ out,
                long long num_blocks, float inv1, float inv2) {
  constexpr int T = kTiles<PIECES>;
  __shared__ __align__(128) int16_t tiles[M2_WARPS][T][M2_TILE * 64];
  __shared__ __align__(16) float scratch[M2_WARPS][M2_PAIRS * M2_PAIR_WORDS];
  __shared__ __align__(8) uint64_t full[M2_WARPS][T];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // The warp's blocks: [b0, b0 + T * M2_TILE), cut at num_blocks.
  // Warps share no barrier, so a warp past the end leaves at once.
  const long long b0 =
      (static_cast<long long>(blockIdx.x) * M2_WARPS + warp) * M2_TILE * T;
  if (b0 >= num_blocks) return;
  const long long left = num_blocks - b0;
  uint64_t* bars = full[warp];
  if (lane == 0) {
    // Every tile's copy in flight at once, each on its own mbarrier.
#pragma unroll
    for (int k = 0; k < T; ++k) {
      const long long rest = left - k * M2_TILE;
      if (rest <= 0) break;
      mbar_init(bars + k);
      bulk_load(tiles[warp][k], deq + (b0 + k * M2_TILE) * 64,
                static_cast<uint32_t>((rest < M2_TILE ? rest : M2_TILE) * 128),
                bars + k);
    }
  }

  const int gid = lane >> 2, tid = lane & 3;
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
  __syncwarp();   // the barriers are initialised before any lane waits

#pragma unroll
  for (int k = 0; k < T; ++k) {
    const long long rest = left - k * M2_TILE;
    if (rest <= 0) break;
    mbar_wait(bars + k, 0);
    run_tile<PIECES>(tiles[warp][k], scratch[warp],
                     out + (b0 + k * M2_TILE) * 64,
                     rest < M2_TILE ? static_cast<int>(rest) : M2_TILE, lane,
                     b, inv1, inv2);
    __syncwarp();   // the scratch is refilled next
  }
}

// --- mxu64_kernel -------------------------------------------------------------
//
// [16 blocks, 64] x kron(A, A)^T a tile: A operand row = block, column k =
// input index (v*8 + h); B (k, n = output index r*8 + p) = mat[n][k].  A
// warp's blocks sit M64_ROW bytes apart in shared memory (128 and a pad of
// 16, 4 words past a multiple of 32), so the 8 rows of a fragment load fall
// on 8 groups of banks.  The basis sits in fragment order: word pair
// (nt*8 + kt)*32 + lane is lane's (b0, b1) of n-step nt and k-step kt, one
// 8-byte load.

// Shared-memory byte of lane's A fragment i (0..3) of k-step kt, from its
// tile's first block: (row gid or gid + 8, column kt*8 + tid or + 4).
__host__ __device__ constexpr int m64_a_byte(int lane, int i, int kt) {
  return ((lane >> 2) + 8 * (i & 1)) * M64_ROW +
         (kt * 8 + (lane & 3) + 4 * (i >> 1)) * 2;
}

// The claims: each A fragment load (32 lanes, 2-byte, lanes of one word
// share it) and each basis load (two phases of 16 lanes, 8-byte) falls on
// distinct banks; rows and the basis keep the copies' 16-byte alignment.
constexpr bool mxu64_conflict_free() {
  if (M64_ROW % 16 != 0 || M64_BASIS % 16 != 0) return false;
  for (int kt = 0; kt < 8; ++kt) {
    for (int i = 0; i < 4; ++i) {
      int w[32] = {};
      for (int l = 0; l < 32; ++l) w[l] = m64_a_byte(l, i, kt) / 4;
      if (!phase_conflict_free(w, 32, 1)) return false;
    }
  }
  for (int half = 0; half < 32; half += 16) {
    int w[16] = {};
    for (int l = 0; l < 16; ++l) w[l] = 2 * (half + l);
    if (!phase_conflict_free(w, 16, 2)) return false;
  }
  return true;
}
static_assert(mxu64_conflict_free(), "mxu64 shared-memory banks");
static_assert(M64_UNIT * 8 % 32 == 0, "whole rounds of 16-byte copies");

// A unit's blocks through the product: M64_PAIR tiles, every accumulator
// summed over k-steps 0..7 in order (the first form's contraction), then
// y * inv rounded, clipped and converted by to_sample and stored straight
// from the accumulators: lanes tid and tid ^ 1 swap one word so that each
// holds 8 contiguous bytes, and each warp store writes 32 contiguous bytes
// (a whole sector) of each of 16 blocks.  The first nb blocks are stored.
__device__ __forceinline__ void mxu64_unit(const uint8_t* tile,
                                           const uint2* basis,
                                           int16_t* __restrict__ dst, int nb,
                                           int lane, float inv) {
  float acc[M64_PAIR][8][4];
#pragma unroll
  for (int j = 0; j < M64_PAIR; ++j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][n][i] = 0.0f;
    }
  }
#pragma unroll
  for (int kt = 0; kt < 8; ++kt) {
    uint32_t a[M64_PAIR][4];
#pragma unroll
    for (int j = 0; j < M64_PAIR; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int16_t x = *reinterpret_cast<const int16_t*>(
            tile + j * M64_TILE * M64_ROW + m64_a_byte(lane, i, kt));
        a[j][i] = tf32_rna(static_cast<float>(x));
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint2 bb = basis[(n * 8 + kt) * 32 + lane];
      const uint32_t b[2] = {bb.x, bb.y};
#pragma unroll
      for (int j = 0; j < M64_PAIR; ++j) mma(acc[j][n], a[j], b, acc[j][n]);
    }
  }
  const int gid = lane >> 2, tid = lane & 3, odd = tid & 1;
  // Lane's 8 bytes of n-steps 2p, 2p + 1: even lanes n-step 2p, odd lanes
  // 2p + 1, at byte 32p + 16 odd + 8 (tid >> 1) of the block.
  const int off = 16 * odd + 8 * (tid >> 1);
#pragma unroll
  for (int j = 0; j < M64_PAIR; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {   // rows gid, gid + 8
      const int blk = j * M64_TILE + gid + 8 * q;
      uint8_t* row = reinterpret_cast<uint8_t*>(dst + blk * 64) + off;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t w0 =
            pack_samples(__fmul_rn(acc[j][2 * p][2 * q], inv),
                         __fmul_rn(acc[j][2 * p][2 * q + 1], inv));
        const uint32_t w1 =
            pack_samples(__fmul_rn(acc[j][2 * p + 1][2 * q], inv),
                         __fmul_rn(acc[j][2 * p + 1][2 * q + 1], inv));
        const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? w0 : w1, 1);
        if (blk < nb) {
          *reinterpret_cast<uint2*>(row + 32 * p) =
              odd ? make_uint2(got, w1) : make_uint2(w0, got);
        }
      }
    }
  }
}

// Each warp's blocks [b0, b0 + M64_WARP_BLOCKS), cut at num_blocks: its
// lanes copy every unit's valid blocks with 16-byte cp.async, a lane a
// chunk, one commit group a unit, before the CUDA block stages the basis
// (every entry rounded to TF32 by cvt.rna once), so the copies are in
// flight meanwhile; one __syncthreads publishes the basis, and from then on
// a warp waits only for its own units' groups.  Warps share nothing else,
// and leave when done.
__global__ void __launch_bounds__(M64_THREADS, M64_MIN_BLOCKS)
mxu64_kernel(const int16_t* __restrict__ deq, const float* __restrict__ mat,
             int16_t* __restrict__ out, long long num_blocks, float inv) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long b0 = (static_cast<long long>(blockIdx.x) * M64_WARPS +
                        warp) * M64_WARP_BLOCKS;
  const long long left = num_blocks - b0;
  uint8_t* tiles = smem + M64_BASIS + warp * M64_WARP_BLOCKS * M64_ROW;
#pragma unroll
  for (int u = 0; u < M64_UNITS; ++u) {
#pragma unroll
    for (int k = 0; k < M64_UNIT * 8 / 32; ++k) {
      const int c = (u * M64_UNIT * 8) + k * 32 + lane, blk = c / 8;
      if (blk < left) {
        __pipeline_memcpy_async(tiles + blk * M64_ROW + (c % 8) * 16,
                                deq + (b0 + blk) * 64 + (c % 8) * 8, 16);
      }
    }
    __pipeline_commit();
  }
  // The basis in fragment order: pair p is row n and k-step kt of mat, 32
  // contiguous bytes holding b0 (then b1) of lanes (n % 8, 0..3) of n-step
  // n / 8, which become those lanes' 4 entries, 32 contiguous bytes.  Every
  // load is issued before the first conversion.
  constexpr int kPairs = 64 * 8 / M64_THREADS;   // (n, kt) pairs a thread
  static_assert(64 * 8 % M64_THREADS == 0, "whole pairs a thread");
  float4 row[kPairs][2];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = i * M64_THREADS + threadIdx.x, n = p % 64, kt = p / 64;
    const float4* src = reinterpret_cast<const float4*>(mat + n * 64 + kt * 8);
    row[i][0] = __ldg(src);
    row[i][1] = __ldg(src + 1);
  }
  uint2* basis = reinterpret_cast<uint2*>(smem);
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = i * M64_THREADS + threadIdx.x, n = p % 64, kt = p / 64;
    const float4 lo = row[i][0], hi = row[i][1];
    uint4* dst = reinterpret_cast<uint4*>(basis + ((n / 8) * 8 + kt) * 32 +
                                          (n % 8) * 4);
    dst[0] = make_uint4(tf32(lo.x), tf32(hi.x), tf32(lo.y), tf32(hi.y));
    dst[1] = make_uint4(tf32(lo.z), tf32(hi.z), tf32(lo.w), tf32(hi.w));
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < M64_UNITS; ++u) {
    const long long rest = left - u * M64_UNIT;
    if (rest <= 0) break;
    __pipeline_wait_prior(M64_UNITS - 1 - u);   // unit u's group has landed
    __syncwarp();                               // and every lane's is seen
    mxu64_unit(tiles + u * M64_UNIT * M64_ROW, basis,
               out + (b0 + u * M64_UNIT) * 64,
               rest < M64_UNIT ? static_cast<int>(rest) : M64_UNIT, lane,
               inv);
  }
}

// The grid of a launch: a warp for every M64_WARP_BLOCKS blocks.
unsigned mxu64_grid(long long num_blocks) {
  constexpr long long kPerBlock =
      static_cast<long long>(M64_WARPS) * M64_WARP_BLOCKS;
  return static_cast<unsigned>((num_blocks + kPerBlock - 1) / kPerBlock);
}

// mxu64_kernel's dynamic shared memory (above the 48 KB static limit) and
// the largest carveout, once a device.
cudaError_t mxu64_ready() {
  static PerDevice prepared;
  return prepared.get([] {
    return prepare(reinterpret_cast<const void*>(mxu64_kernel), M64_SMEM);
  });
}

// The grid of a launch: a warp for every kTiles tiles.
unsigned mxu2pass_grid(int pieces, long long num_blocks) {
  const long long per_block = static_cast<long long>(M2_WARPS) * M2_TILE *
                              (pieces == 1 ? kTiles<1> : kTiles<2>);
  return static_cast<unsigned>((num_blocks + per_block - 1) / per_block);
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
  if (num_blocks <= 0 || (pieces != 1 && pieces != 2)) {
    return cudaErrorInvalidValue;
  }
  if (reinterpret_cast<uintptr_t>(deq) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorMisalignedAddress;
  }
  const unsigned blocks = mxu2pass_grid(pieces, num_blocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int16_t* in = static_cast<const int16_t*>(deq);
  const float* m = static_cast<const float*>(mat);
  int16_t* o = static_cast<int16_t*>(out);
  if (pieces == 1) {
    mxu2pass_kernel<1><<<blocks, M2_THREADS, 0, st>>>(in, m, o, num_blocks,
                                                      inv1, inv2);
  } else {
    mxu2pass_kernel<2><<<blocks, M2_THREADS, 0, st>>>(in, m, o, num_blocks,
                                                      inv1, inv2);
  }
  return static_cast<int>(cudaGetLastError());
}

// inv = 2^-(2 CONST_BITS).  mat is the [64, 64] basis as float32 (its
// structure, kron(A, A), is not assumed).
extern "C" int pjt_cuda_mxu64(const void* deq, const void* mat, void* out,
                              long long num_blocks, float inv, void* stream) {
  if (num_blocks <= 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(deq) % 16 ||
      reinterpret_cast<uintptr_t>(mat) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorMisalignedAddress;
  }
  const cudaError_t e = mxu64_ready();
  if (e != cudaSuccess) return static_cast<int>(e);
  mxu64_kernel<<<mxu64_grid(num_blocks), M64_THREADS, M64_SMEM,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(deq), static_cast<const float*>(mat),
      static_cast<int16_t*>(out), num_blocks, inv);
  return static_cast<int>(cudaGetLastError());
}
