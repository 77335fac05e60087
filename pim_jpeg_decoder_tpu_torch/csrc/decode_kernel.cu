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
//     warp), which also masks the ragged last tile.  A tile's 32-byte row
//     off the grid straddles two sectors, each shared with a neighbouring
//     tile, so any store of it writes two sectors in part; at 4:2:0 that
//     costs the byte form about 1.5x the VEC16 kernel's time (PERF.md).
//     Timed on the card and not kept: aligned 8-byte words built by
//     shuffles and funnel shifts, with each row's end words stored in
//     4/2/1-byte pieces (more partial-sector writes: 1.65x slower than the
//     byte form), and rows staged in the dead shared memory then written
//     a row a warp store (the byte form's sectors without its recomputed
//     chroma terms: 7% slower at 4:2:0, 5-10% faster elsewhere).  The
//     batch paths pad each launch's M to a multiple of 16 instead
//     (models/input_pipeline.py).
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
// (PERF.md; int8 [int16]): rgb_kernel 31 [24] registers, 8 blocks/SM
// gray; 48 [48], 5 at 4:4:4; 55 [55], 4 at 4:2:2 and 4:4:0; 64 [64], 4 at
// 4:2:0.  ycbcr_kernel 31 [24], 8 gray; 48 [48], 5 at 4:4:4;
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

//
// rgb_scaled_kernel (the batch path's scale-2 decode, the CLI's --scale)
// is tiled the same way; its first form ran a thread per whole block (a
// chroma thread's 8x8 matrix IDCT, 2,304 operations, was the critical
// path), dequantized all 64 coefficients though the reduced IDCT reads
// NY x NX of them, and stored bytes.  The redesign:
//   - the tile copies only the 16-byte chunks that hold rows 0..NY-1 of
//     each block (at scale 2 half of a luma block; 32-byte sectors are
//     what the device reads) with cp.async, MCUs an odd number of chunks
//     apart (ScaledLayout), and stages each MCU's quantizer row;
//   - every block is split over max(NY, NX) lanes (Reduced): lane u runs
//     pass 1 down frequency column u, dequantizing only the NY
//     coefficients it reads, an int32 transpose (pass 1 wraps on extreme
//     blocks) padded so both directions are conflict-free, then lane r
//     runs pass 2 along spatial row r.  A warp takes 32 / lanes blocks of
//     one slot a round; every warp runs its luma rounds, then its chroma
//     rounds, so no warp is all chroma (4:2:0 scale 2: 2 + 2 rounds);
//   - both passes run the rounded basis through its exact even/odd split
//     (reduced_sums): 22 multiplies for 8 points, bit-identical in
//     uint32_t wrap-around;
//   - samples park in shared memory and rows are stored like rgb_kernel's
//     (8 bytes of a row a lane in colour, 16 in gray; byte stores when M %
//     16 != 0).
// On an H100 80GB HBM3 at 700 W (PERF.md): 18-40
// registers, 1.7-39.6 KB of shared memory, 5-8 blocks an SM (4:2:0 scale
// 2: 40 registers, 31,360 B int8 [39,552 B int16], 6 [5] blocks).  4:2:0
// scale 2 int8 on a B=256 batch (M=196,608): 65.4 us, was 97.4-98.3; at
// M=16,384: 12.1 us, was 14.6-14.9.  What bounds it is issue and latency,
// not bytes: 234.5 warp instructions an MCU (SASS), 44.1 us of issue at
// M=196,608 against a 30.1 us bound (operations, even/odd form) and 26.5
// us of bytes (the sectors read); at M=16,384 one wave of 512 tiles (3.9
// an SM) loads, decodes and stores one phase after another.  Timed on the
// card against this form and not kept: 16-MCU tiles, 512-thread tiles, two
// tiles a block (the second's copy in flight during the first's decode),
// two rounds a step, a zero quantizer row in place of the mask: none
// faster at M=16,384, each slower or level at M=196,608.
// Blocks that walk tiles.  On the int16 wire the copy does not hide: at
// 4:2:0 scale 2, M=262,144 (a B=256 batch of 512x512 files), 110 us
// against 89.7 on int8, the 67 MB more of rows at about their DRAM time,
// since a block's only bytes in flight were its own tile's while its
// warps waited.  Where a tile copies at least WALK_MIN_COPY_BYTES (4:2:0
// and 4:4:0 at scale 2, int16) and a launch has more tiles than one wave
// of resident blocks, every resident block walks tiles b, b + grid, ...
// (ops/decode_kernel.scaled_plan: 660 blocks of 12-13 tiles there).  The
// tile's luma and chroma rows are two cp.async groups into the block's one
// copy: the next tile's luma rows are issued once this tile's luma blocks
// are decoded, its chroma rows once the chroma blocks are, and its qidx
// entries go with the luma rows into the other of two slots of quantizer
// rows, each range-checked by the thread that copied it once it lands.
// So the shared memory stays that of a block of one tile (39,680 B at
// 4:2:0 int16, 5 blocks an SM at WALK_MIN_BLOCKS, at most 48 registers, no
// spills) for a third barrier a tile.  The step is not inlined
// (walk_scaled_tile).  4:2:0 int16 at M=262,144: 110.3 -> 105.5 us, at
// 196,608: 86.8 -> 82.9; 4:4:0 int16 at 196,608: 65.3 -> 59.2 (PERF.md).  Timed and not kept: a ring of two whole tiles (4 blocks
// an SM at int16: 106 us, int8 99), the step inlined (55-64 registers),
// 6 blocks an SM (40 registers: level), grids of ceil(tiles / per) blocks
// (some SMs a block short: 107 us), 2 or 4 tiles a block (105, 104 us),
// the next copy in flight during the store only (106 us), and the walk's
// last tile on a second copy of the decode and store (108 us).  At 4:2:0
// int8, 4:2:2 and scale 8 every walk lost 2-14%, so those forms keep a
// block a tile, with the shared memory and code of a block of one tile
// before the walk.
// Shared helpers (constants, the Loeffler pass, dequantize, BT.601, the
// chroma index and the byte store loop) live in decode_common.cuh, with
// the reasons for their wrap-around uint32_t arithmetic.

#include <type_traits>

#include "decode_common.cuh"
#include "decode_tile.cuh"

namespace {

// Scaled decode (ops/specs.py "Reduced (scaled) IDCT"): an IDCT of the
// top-left NY x NX frequencies, both passes by the rounded basis of
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

// The sums o[k] = sum_u basis<N>(k, u) * x[u] of one N-point reduced pass,
// by the exact even/odd split of the rounded basis: basis[N-1-k][u] ==
// (-1)^u basis[k][u], so with E[k] the sum over even u and O[k] over odd
// u, o[k] = E[k] + O[k] and o[N-1-k] = E[k] - O[k]; and basis<N>(k, 2j) ==
// basis<N/2>(k, j), so E is the N/2-point pass of the even inputs
// (tests/test_torch_scaled.py holds both identities against the spec).
// In wrap-around uint32_t arithmetic this is the matrix sum itself, bit for
// bit; 8 points take 22 multiplies instead of 64.
template <int N>
__device__ __forceinline__ void reduced_sums(const uint32_t (&x)[N],
                                             uint32_t (&o)[N]) {
  if constexpr (N == 1) {
    o[0] = x[0] * basis<1>(0, 0);
  } else {
    constexpr int HALF = N / 2;
    uint32_t xe[HALF], e[HALF];
#pragma unroll
    for (int j = 0; j < HALF; ++j) xe[j] = x[2 * j];
    reduced_sums<HALF>(xe, e);
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      uint32_t odd = x[1] * basis<N>(k, 1);
#pragma unroll
      for (int j = 1; j < HALF; ++j) {
        odd += x[2 * j + 1] * basis<N>(k, 2 * j + 1);
      }
      o[k] = e[k] + odd;
      o[N - 1 - k] = e[k] - odd;
    }
  }
}

// One N-point reduced pass (decode_kernel.py:_reduced_pass): o[k] =
// descale(sum_u basis[k][u] * x[u], SHIFT), in wrap-around arithmetic.
template <int N, int SHIFT>
__device__ __forceinline__ void reduced_pass(const uint32_t (&x)[N],
                                             int32_t (&o)[N]) {
  uint32_t acc[N];
  reduced_sums<N>(x, acc);
#pragma unroll
  for (int k = 0; k < N; ++k) o[k] = sra(acc[k] + (1u << (SHIFT - 1)), SHIFT);
}

// One reduced IDCT of NY x NX samples on kLanes = max(NY, NX) lanes (pass 1:
// lane u down frequency column u; pass 2: lane r along spatial row r),
// through an int32 transpose of NY rows of kRow words.  Rows of 4 or 8
// words are padded to 8 words, or to 12 on 8 lanes, so that the row reads
// of pass 2 (16-byte loads, 8 lanes a phase) hit distinct banks; kBlock is
// the first size >= NY * kRow with kBlock % 32 == kLanes, so the kPerWarp
// blocks of a warp start kLanes banks apart and the column writes of pass
// 1 hit distinct banks.  Conflict-free both ways for every kind with NX >=
// 4 (all of scale 2); the 2-wide kinds of scale 4 and 8 read 2-way.
// Kind's static_asserts hold every instantiated kind to these claims.
template <int NY, int NX>
struct Reduced {
  static constexpr int kLanes = NY > NX ? NY : NX;
  static constexpr int kPerWarp = 32 / kLanes;
  static constexpr int kRow = NX >= 4 ? (kLanes == 8 ? 12 : 8) : NX;
  static constexpr int kBlock = NY * kRow + (kLanes - NY * kRow % 32 + 32) % 32;
  static constexpr int kWarpWords = kPerWarp * kBlock;
  static constexpr int kWidth = NX < 4 ? NX : 4;   // words a row load
  static_assert(kLanes * kPerWarp == 32, "a warp's blocks fill its lanes");
  static_assert(kRow % kWidth == 0 && kBlock % kWidth == 0,
                "row loads aligned");

  // Pass-1 column writes (lane j * kLanes + u: the word of row r, column
  // u of the warp's block j) and, for rows of 4 or 8 words, pass-2 row
  // reads (lane j * kLanes + r: 4 words from column h of row r) without
  // bank conflicts.
  static constexpr int word(int lane, int r, int u) {
    return lane / kLanes * kBlock + r * kRow + u;
  }
  static constexpr bool conflict_free() {
    for (int r = 0; r < NY; ++r) {
      int w[32] = {};
      for (int l = 0; l < 32; ++l)
        w[l] = l % kLanes < NX ? word(l, r, l % kLanes) : -1;
      if (!phase_conflict_free(w, 32, 1)) return false;
    }
    for (int h = 0; NX >= 4 && h < NX; h += 4) {
      int w[32] = {};
      for (int l = 0; l < 32; ++l)
        w[l] = l % kLanes < NY ? word(l, l % kLanes, h) : -1;
      for (int p = 0; p < 32; p += 8)
        if (!phase_conflict_free(w + p, 8, 4)) return false;
    }
    return true;
  }
};

// The launch bounds of a scaled kernel form whose blocks walk tiles: 5
// blocks an SM (at most 48 registers), as many as the shared memory of
// 4:2:0 int16 fits.
constexpr int WALK_MIN_BLOCKS = 5;

// The least copy a tile (bytes of wire rows in shared memory) for which a
// scaled block walks several tiles.  The walk hides the copy behind the
// decode but costs a barrier a tile and a call; on an H100 it won where a
// tile copies 12.5-16.5 KB (4:2:0 and 4:4:0 at scale 2, int16) and lost
// at 4:2:0 int8, 4:2:2 and scale 8 (8.5 KB and less; PERF.md).
constexpr int WALK_MIN_COPY_BYTES = 12 * 1024;

// The dynamic shared memory of a scaled decode block, every part 16-byte
// aligned: each warp's transpose scratch (the larger of its luma and
// chroma kind), the tile's (TILE_MCUS MCUs) copy of the rows the reduced
// IDCTs read ([MCU][slot][row][8] of T: the first kLumaChunks /
// kChromaChunks 16-byte chunks of each block on the wire, MCUs an odd
// number of chunks apart so that the column reads of pass 1 spread over
// the banks), the samples ([row][MCU] int8: GY * NN luma rows, slot-major,
// pixel px * N + py; then each chroma block's CY * CX, col * CY + row) and
// each MCU's quantizer row (-1: qidx out of range), in one slot, or in
// two where the form walks tiles (this tile's and the next one's, by the
// parity of the tile's place in the walk).  Where tiles are walked, the
// luma and chroma chunks are copied as two groups, so the next tile's luma
// chunks stream in while this tile's chroma blocks decode, and its chroma
// chunks while this tile stores and the next one's luma blocks decode.
template <typename T, int H, int V, int NC, int N>
struct ScaledLayout {
  static constexpr int GY = H * V;
  static constexpr int G = NC == 1 ? 1 : GY + 2;
  static constexpr int kN = N, NN = N * N;
  static constexpr int CY = V * N, CX = H * N;   // chroma rows, columns
  using Luma = Reduced<N, N>;
  using Chroma = Reduced<CY, CX>;
  static constexpr int kBytesT = static_cast<int>(sizeof(T));
  static constexpr int kLumaChunks = (N * 8 * kBytesT + VEC - 1) / VEC;
  static constexpr int kChromaChunks = (CY * 8 * kBytesT + VEC - 1) / VEC;
  static constexpr int kMcuLuma = GY * kLumaChunks;   // chunks an MCU
  static constexpr int kMcuChroma = (G - GY) * kChromaChunks;
  static constexpr int kMcuChunks = kMcuLuma + kMcuChroma;
  static constexpr int kMcuStride = (kMcuChunks | 1) * VEC;
  static constexpr int kChromaRow0 = GY * NN;
  static constexpr int kSampleRows = NC == 1 ? GY * NN : 3 * GY * NN;
  static constexpr int kWarpWords =
      ((NC == 1 || Luma::kWarpWords >= Chroma::kWarpWords
            ? Luma::kWarpWords
            : Chroma::kWarpWords) + 3) & ~3;
  static constexpr int kCopyBytes = TILE_MCUS * kMcuStride;
  static constexpr bool kWalks = kCopyBytes >= WALK_MIN_COPY_BYTES;
  static constexpr int kMinBlocks = kWalks ? WALK_MIN_BLOCKS : TILE_MIN_BLOCKS;
  static constexpr int kXpose = 0;
  static constexpr int kCoeffs = kXpose + TILE_WARPS * kWarpWords * 4;
  static constexpr int kSamples = kCoeffs + kCopyBytes;
  static constexpr int kQrows = kSamples + kSampleRows * SAMPLE_ROW;
  static constexpr int kBytes = kQrows + (kWalks ? 2 : 1) * TILE_MCUS * 4;
  static_assert(kCoeffs % VEC == 0 && kSamples % VEC == 0 &&
                    kQrows % VEC == 0,
                "every part 16-byte aligned");

  // The quantizer rows of a block's j-th tile.
  __device__ static int32_t* qrows(uint8_t* smem, int j) {
    return reinterpret_cast<int32_t*>(smem + kQrows) +
           (kWalks ? (j & 1) * TILE_MCUS : 0);
  }
  // First chunk of block s in an MCU's copy.
  __device__ static int block_chunk(int s) {
    return s < GY ? s * kLumaChunks : kMcuLuma + (s - GY) * kChromaChunks;
  }
};

// Issue the copies of part of a tile (the caller commits them): the chunks
// of ScaledLayout of its valid MCUs by 16-byte asynchronous copies, lane i
// on chunk i; LUMA and CHROMA pick the rows 0..N-1 of each luma block and
// 0..CY-1 of each chroma block.
template <typename L, bool LUMA, bool CHROMA, typename T>
__device__ __forceinline__ void issue_scaled_part(const T* __restrict__ coeffs,
                                                  long long m0, int valid,
                                                  uint8_t* smem) {
  constexpr int kPart =
      (LUMA ? L::kMcuLuma : 0) + (CHROMA ? L::kMcuChroma : 0);   // an MCU
  constexpr int kFirst = LUMA ? 0 : L::kMcuLuma;
  constexpr int kRounds =
      (TILE_MCUS * kPart + TILE_THREADS - 1) / TILE_THREADS;
  constexpr int kBlockBytes = 64 * L::kBytesT;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(coeffs) +
                       static_cast<size_t>(m0) * L::G * kBlockBytes;
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const int c = k * TILE_THREADS + threadIdx.x;
    if (c < valid * kPart) {
      const int mj = c / kPart, chunk = kFirst + c % kPart;
      const int s = LUMA && (!CHROMA || chunk < L::kMcuLuma)
                        ? chunk / L::kLumaChunks
                        : L::GY + (chunk - L::kMcuLuma) / L::kChromaChunks;
      __pipeline_memcpy_async(
          smem + L::kCoeffs + mj * L::kMcuStride + chunk * VEC,
          src + (static_cast<size_t>(mj) * L::G + s) * kBlockBytes +
              (chunk - L::block_chunk(s)) * VEC,
          VEC);
    }
  }
}

// A block of one tile: copy the tile's chunks, and meanwhile stage each
// MCU's quantizer row.  Returns after both have landed.
template <typename L, typename T>
__device__ __forceinline__ void load_scaled_tile(
    const T* __restrict__ coeffs, const int32_t* __restrict__ qidx, int num_q,
    long long m0, int valid, uint8_t* smem) {
  issue_scaled_part<L, true, true>(coeffs, m0, valid, smem);
  __pipeline_commit();
  if (threadIdx.x < TILE_MCUS) {
    int row = -1;
    if (static_cast<int>(threadIdx.x) < valid) {
      const int qi = __ldg(qidx + m0 + threadIdx.x);
      if (static_cast<unsigned>(qi) < static_cast<unsigned>(num_q)) row = qi;
    }
    L::qrows(smem, 0)[threadIdx.x] = row;
  }
  __pipeline_wait_prior(0);
  __syncthreads();
}

// NX int32 words of a transpose row (16-byte aligned for NX >= 4, 8-byte
// for NX == 2).
template <int NX>
__device__ __forceinline__ void load_row(const int32_t* p, uint32_t (&x)[NX]) {
  if constexpr (NX == 8) {
    const int4 lo = *reinterpret_cast<const int4*>(p);
    const int4 hi = *reinterpret_cast<const int4*>(p + 4);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else if constexpr (NX == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (NX == 2) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

// The NY x NX reduced IDCTs of slots S0 .. S0+NSLOTS-1 of every MCU of the
// tile ("a kind": the luma blocks, or the chroma blocks).  Warp-round wr
// takes Reduced::kPerWarp blocks of one slot and consecutive MCUs (block bi
// = wr * kPerWarp + j on lanes j * kLanes ..); warp w takes the
// warp-rounds wr = w - FIRST_WARP (mod TILE_WARPS), so that a kind that
// ends part-way through the warps hands the next kind's first rounds to
// the idle ones.  Round k of a warp: load_q fetches lane i's quantizers of
// column u = i (from the pool, which stays in the L2; an out-of-range row
// reads row 0 masked to 0) a round ahead; run dequantizes that column and
// runs pass 1 down it on lanes i < NX, and after __syncwarp pass 2 along
// row r = i on lanes i < NY.  Blocks past the ragged end decode whatever
// the tile holds there and are never stored.
template <typename L, typename T, int NY, int NX, int S0, int NSLOTS,
          int FIRST_WARP>
struct Kind {
  using R = Reduced<NY, NX>;
  static_assert(R::conflict_free(), "transpose bank conflicts");
  static constexpr int kWarpRounds = TILE_MCUS * NSLOTS / R::kPerWarp;
  static constexpr int kRounds = (kWarpRounds + TILE_WARPS - 1) / TILE_WARPS;

  // Whether this warp has a round k, and that round's block of lane j.
  __device__ static bool block(int k, int& mj, int& s) {
    const int warp = threadIdx.x >> 5;
    const int wr =
        k * TILE_WARPS + (warp + TILE_WARPS - FIRST_WARP) % TILE_WARPS;
    const int bi = wr * R::kPerWarp + (threadIdx.x & 31) / R::kLanes;
    mj = bi % TILE_MCUS;
    s = S0 + bi / TILE_MCUS;
    return wr < kWarpRounds;                       // the same for the warp
  }

  __device__ static void load_q(int k, const int32_t* __restrict__ qpool,
                                const int32_t* qrows, uint32_t (&q)[8]) {
    int mj, s;
    const int i = threadIdx.x % R::kLanes;
    if (!block(k, mj, s) || i >= NX) return;
    const int row = qrows[mj];
    const uint32_t keep = row < 0 ? 0u : ~0u;
    const int32_t* src =
        qpool + (static_cast<size_t>(row < 0 ? 0 : row) * L::G + s) * 64 + i;
#pragma unroll
    for (int v = 0; v < NY; ++v) {
      q[v] = static_cast<uint32_t>(__ldg(src + 8 * v)) & keep;
    }
  }

  __device__ static void run(int k, const uint32_t (&q)[8], uint8_t* smem) {
    int mj, s;
    if (!block(k, mj, s)) return;
    const int lane = threadIdx.x & 31;
    const int i = lane % R::kLanes;
    int32_t* xp = reinterpret_cast<int32_t*>(smem + L::kXpose) +
                  (threadIdx.x >> 5) * L::kWarpWords +
                  lane / R::kLanes * R::kBlock;
    if (i < NX) {
      const T* c = reinterpret_cast<const T*>(
                       smem + L::kCoeffs + mj * L::kMcuStride +
                       L::block_chunk(s) * VEC) + i;
      uint32_t x[NY];
#pragma unroll
      for (int v = 0; v < NY; ++v) x[v] = dequant(c[8 * v], q[v]);
      int32_t o[NY];
      reduced_pass<NY, CONST_BITS - PASS1_BITS>(x, o);
#pragma unroll
      for (int r = 0; r < NY; ++r) xp[r * R::kRow + i] = o[r];
    }
    __syncwarp();
    if (i < NY) {
      uint32_t x[NX];
      load_row<NX>(xp + i * R::kRow, x);
      int32_t o[NX];
      reduced_pass<NX, CONST_BITS + PASS1_BITS>(x, o);
      const int base = s < L::GY ? s * L::NN
                                 : L::kChromaRow0 + (s - L::GY) * NY * NX;
      int8_t* samples = reinterpret_cast<int8_t*>(smem + L::kSamples);
#pragma unroll
      for (int p = 0; p < NX; ++p) {
        samples[(base + p * NY + i) * SAMPLE_ROW + mj] =
            static_cast<int8_t>(min(max(o[p], SAMPLE_MIN), SAMPLE_MAX));
      }
    }
    __syncwarp();   // the next round overwrites the scratch
  }
};

// Every round of kind A, then of kind B (B::kRounds may be 0), each
// round's quantizers (rows in `qrows`) loaded during the round before it;
// mid() between the two kinds, in every thread (where tiles are walked,
// B's rows land there).
template <typename A, typename B, typename Mid>
__device__ __forceinline__ void run_kinds(const int32_t* __restrict__ qpool,
                                          const int32_t* qrows, uint8_t* smem,
                                          Mid mid) {
  uint32_t next[8] = {};
  A::load_q(0, qpool, qrows, next);
#pragma unroll
  for (int k = 0; k < A::kRounds + B::kRounds; ++k) {
    uint32_t q[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) q[v] = next[v];
    if (k + 1 < A::kRounds) {
      A::load_q(k + 1, qpool, qrows, next);
    } else if (k + 1 < A::kRounds + B::kRounds) {
      B::load_q(k + 1 - A::kRounds, qpool, qrows, next);
    }
    if (k == A::kRounds) mid();
    if (k < A::kRounds) {
      A::run(k, q, smem);
    } else {
      B::run(k - A::kRounds, q, smem);
    }
  }
  if (B::kRounds == 0) mid();
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
  constexpr int G = NC == 1 ? 1 : H * V + 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const long long m0 = static_cast<long long>(blockIdx.x) * TILE_MCUS;
  const int valid = tile_valid(m0, num_mcus);
  load_tile<T, G>(coeffs, qidx, num_q, m0, valid, smem);
  decode_tile<T, G>(qpool, smem);
  __syncthreads();
  store_tile_rgb<H, V, NC, VEC16>(
      reinterpret_cast<const int8_t*>(smem + TileLayout<T, G>::kSamples), out,
      m0, num_mcus, valid);
}

// The RGB store of a decoded scaled tile: samples ([row][MCU] int8, rows of
// SAMPLE_ROW bytes) to uint8 [3, GY, NN, M] after the block's barrier.
// Gray: 16 bytes of a row a lane, to all three planes; colour: 8 pixels of
// a row a lane, their BT.601 terms, then 8 bytes a plane; without VEC16
// (a row off the 16-byte grid) store_rgb's byte stores, which also mask
// the ragged last tile.
template <typename L, int H, int NC, bool VEC16>
__device__ __forceinline__ void store_scaled_tile(const int8_t* samples,
                                                  uint8_t* __restrict__ out,
                                                  long long m0,
                                                  long long num_mcus,
                                                  int valid) {
  constexpr int GY = L::GY, NN = L::NN, CY = L::CY, N = L::kN;
  const size_t plane = static_cast<size_t>(GY) * NN * num_mcus;
  // The sample row of the chroma pixel that luma pixel pix of slot sl reads
  // (decode_kernel.py's region (qv, qh) of the chroma IDCT).
  const auto chroma_row = [](int sl, int pix) {
    return L::kChromaRow0 + ((sl % H) * N + pix / N) * CY + (sl / H) * N +
           pix % N;
  };
  if constexpr (VEC16 && NC == 1) {
    for_each_piece<NN, VEC>(valid, [&](int row, int c16) {
      const int4 y = level_shift16(load16(samples + row * SAMPLE_ROW + c16));
      uint8_t* dst = out + static_cast<size_t>(row) * num_mcus + m0 + c16;
      *reinterpret_cast<int4*>(dst) = y;
      *reinterpret_cast<int4*>(dst + plane) = y;
      *reinterpret_cast<int4*>(dst + 2 * plane) = y;
    });
  } else if constexpr (VEC16) {
    for_each_piece<GY * NN, 8>(valid, [&](int row, int c8) {
      const int c = chroma_row(row / NN, row % NN);
      const uint2 y = *reinterpret_cast<const uint2*>(
          samples + row * SAMPLE_ROW + c8);
      const uint2 cb = *reinterpret_cast<const uint2*>(
          samples + c * SAMPLE_ROW + c8);
      const uint2 cr = *reinterpret_cast<const uint2*>(
          samples + (c + GY * NN) * SAMPLE_ROW + c8);
      uint8_t r[8], g[8], b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        int32_t tr, tg, tb;
        chroma_terms(sample8_at(cb, j), sample8_at(cr, j), tr, tg, tb);
        const int32_t y128 = sample8_at(y, j) + 128;
        r[j] = to_u8(y128 + tr);
        g[j] = to_u8(y128 + tg);
        b[j] = to_u8(y128 + tb);
      }
      uint8_t* dst = out + static_cast<size_t>(row) * num_mcus + m0 + c8;
      *reinterpret_cast<uint2*>(dst) = pack8(r);
      *reinterpret_cast<uint2*>(dst + plane) = pack8(g);
      *reinterpret_cast<uint2*>(dst + 2 * plane) = pack8(b);
    });
  } else {
    store_rgb<GY, NN, TILE_MCUS, TILE_THREADS>(
        out, m0, num_mcus,
        [&](int sl, int pix, int mj, uint8_t& r, uint8_t& g, uint8_t& b) {
          const int32_t y = samples[(sl * NN + pix) * SAMPLE_ROW + mj];
          if (NC == 1) {
            r = g = b = to_u8(y + 128);
          } else {
            const int c = chroma_row(sl, pix);
            bt601(y, samples[c * SAMPLE_ROW + mj],
                  samples[(c + GY * NN) * SAMPLE_ROW + mj], r, g, b);
          }
        });
  }
}

// Where tiles are walked: issue one part of this block's j-th tile, tile
// t, and commit it as one group; the luma part with the tile's qidx
// entries (4-byte copies into its quantizer rows, checked where they land,
// walk_scaled_tile).
template <typename L, typename T>
__device__ __forceinline__ void issue_scaled(const T* __restrict__ coeffs,
                                             const int32_t* __restrict__ qidx,
                                             long long num_mcus, long long t,
                                             int j, bool luma) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long m0 = t * TILE_MCUS;
  const int valid = tile_valid(m0, num_mcus);
  if (luma) {
    issue_scaled_part<L, true, false>(coeffs, m0, valid, smem);
    if (static_cast<int>(threadIdx.x) < valid) {
      __pipeline_memcpy_async(L::qrows(smem, j) + threadIdx.x,
                              qidx + m0 + threadIdx.x, 4);
    }
  } else {
    issue_scaled_part<L, false, true>(coeffs, m0, valid, smem);
  }
  __pipeline_commit();
}

// The luma blocks of the block's j-th tile, tile t, in shared memory, then
// its chroma blocks (run_kinds, mid() between them), a barrier, freed()
// (nothing reads the copy any more), then the tile's store.
template <typename T, int H, int V, int NC, int N, bool VEC16, typename Mid,
          typename Freed>
__device__ __forceinline__ void decode_scaled_tile(
    const int32_t* __restrict__ qpool, uint8_t* __restrict__ out,
    long long num_mcus, long long t, int j, Mid mid, Freed freed) {
  using L = ScaledLayout<T, H, V, NC, N>;
  constexpr int GY = L::GY;
  using Luma = Kind<L, T, N, N, 0, GY, 0>;
  using Chroma = Kind<L, T, L::CY, L::CX, GY, NC == 3 ? 2 : 0,
                      Luma::kWarpRounds % TILE_WARPS>;
  extern __shared__ __align__(16) uint8_t smem[];
  run_kinds<Luma, Chroma>(qpool, L::qrows(smem, j), smem, mid);
  __syncthreads();
  freed();
  const long long m0 = t * TILE_MCUS;
  store_scaled_tile<L, H, NC, VEC16>(
      reinterpret_cast<const int8_t*>(smem + L::kSamples), out, m0,
      num_mcus, tile_valid(m0, num_mcus));
}

// The j-th tile of this block's walk, tile t, whose luma and chroma parts
// are the two newest commit groups: wait for the luma part and turn each
// qidx entry this thread copied into its quantizer row (-1: out of range,
// as load_scaled_tile stages it), decode the luma blocks, wait for the
// chroma part and issue the next tile's luma part, decode the chroma
// blocks, issue the next tile's chroma part, store.  The walk's last tile
// issues nothing, through the same single copy of the decode and store (a
// second copy for it took 4% more at 4:2:0 int16).  Not inlined: inlined
// into the kernel's loop, the compiler keeps every tile-invariant address
// live across it (55-64 registers, 4 blocks an SM, where a block of one
// tile takes 40).
template <typename T, int H, int V, int NC, int N, bool VEC16>
__device__ __noinline__ void walk_scaled_tile(
    const T* __restrict__ coeffs, const int32_t* __restrict__ qidx,
    const int32_t* __restrict__ qpool, int num_q, uint8_t* __restrict__ out,
    long long num_mcus, long long t, int j) {
  using L = ScaledLayout<T, H, V, NC, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  const long long next = t + gridDim.x;
  const bool ahead = next * TILE_MCUS < num_mcus;
  __pipeline_wait_prior(1);
  if (threadIdx.x < TILE_MCUS) {
    int32_t* rows = L::qrows(smem, j);
    int row = -1;
    if (static_cast<int>(threadIdx.x) < tile_valid(t * TILE_MCUS, num_mcus)) {
      const int qi = rows[threadIdx.x];
      if (static_cast<unsigned>(qi) < static_cast<unsigned>(num_q)) row = qi;
    }
    rows[threadIdx.x] = row;
  }
  __syncthreads();   // the luma part has landed; the last store has read
  decode_scaled_tile<T, H, V, NC, N, VEC16>(
      qpool, out, num_mcus, t, j,
      [&] {
        __pipeline_wait_prior(0);
        __syncthreads();   // the chroma part has landed; luma is read
        if (ahead) issue_scaled<L>(coeffs, qidx, num_mcus, next, j + 1, true);
      },
      [&] {
        if (ahead) issue_scaled<L>(coeffs, qidx, num_mcus, next, j + 1, false);
      });
}

// Scaled decode at 1/(8/N), output [3, GY, N*N, M], pixels column-major
// (px*N + py).  A luma block takes the N-point reduced IDCT (N*N samples);
// a chroma block the (V*N) x (H*N)-point one, since it covers V x H luma
// blocks: no upsampling at scale >= 2, each luma slot (qv, qh) reads its
// N x N region, and each chroma sample serves one luma pixel.  A tile's
// luma blocks decode, then its chroma blocks (run_kinds), and it stores
// like rgb_kernel (gray 16 bytes a lane, colour 8 pixels of a row a lane:
// their BT.601 terms, then 8 bytes a plane; byte stores without VEC16).
// A form whose tile copies at least WALK_MIN_COPY_BYTES may walk tiles b,
// b + gridDim.x, ... (walk_scaled_tile), the next tile's copy streaming in
// meanwhile; any other form takes a block a tile.
template <typename T, int H, int V, int NC, int N, bool VEC16>
__global__ void __launch_bounds__(TILE_THREADS,
                                  (ScaledLayout<T, H, V, NC, N>::kMinBlocks))
rgb_scaled_kernel(const T* __restrict__ coeffs,
                  const int32_t* __restrict__ qidx,
                  const int32_t* __restrict__ qpool, int num_q,
                  uint8_t* __restrict__ out, long long num_mcus) {
  using L = ScaledLayout<T, H, V, NC, N>;
  extern __shared__ __align__(16) uint8_t smem[];
  if constexpr (L::kWalks) {
    const long long tiles = (num_mcus + TILE_MCUS - 1) / TILE_MCUS;
    const long long step = gridDim.x;
    issue_scaled<L>(coeffs, qidx, num_mcus, blockIdx.x, 0, true);
    issue_scaled<L>(coeffs, qidx, num_mcus, blockIdx.x, 0, false);
    int j = 0;
    for (long long t = blockIdx.x; t < tiles; t += step, ++j) {
      walk_scaled_tile<T, H, V, NC, N, VEC16>(coeffs, qidx, qpool, num_q,
                                              out, num_mcus, t, j);
    }
  } else {
    const long long m0 = static_cast<long long>(blockIdx.x) * TILE_MCUS;
    load_scaled_tile<L>(coeffs, qidx, num_q, m0, tile_valid(m0, num_mcus),
                        smem);
    decode_scaled_tile<T, H, V, NC, N, VEC16>(qpool, out, num_mcus,
                                              blockIdx.x, 0, [] {}, [] {});
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
  bool vec16;   // every output row 16-byte aligned: the tile kernels' stores
  long long blocks;   // rgb_scaled_kernel's grid (0: a block a tile)
};

template <typename T>
using KernelFn = void (*)(const T*, const int32_t*, const int32_t*, int,
                          uint8_t*, long long);

// The tile kernel of one decode form (N == 8: ycbcr_kernel or rgb_kernel;
// else rgb_scaled_kernel at N points), its dynamic shared memory, and
// whether its blocks may walk several tiles, prepared once per
// instantiation and device.
template <typename T, int H, int V, int NC, bool YCBCR, int N, bool VEC16>
cudaError_t kernel_of(KernelFn<T>& fn, int& smem, bool& walks) {
  constexpr int G = NC == 1 ? 1 : H * V + 2;
  walks = false;
  if constexpr (N == 8 && YCBCR) {
    fn = ycbcr_kernel<T, G, VEC16>;
    smem = TileLayout<T, G>::kBytes;
  } else if constexpr (N == 8) {
    fn = rgb_kernel<T, H, V, NC, VEC16>;
    smem = TileLayout<T, G>::kBytes;
  } else {
    using L = ScaledLayout<T, H, V, NC, N>;
    fn = rgb_scaled_kernel<T, H, V, NC, N, VEC16>;
    smem = L::kBytes;
    walks = L::kWalks;
  }
  static PerDevice prepared;
  return prepared.get(
      [&] { return prepare(reinterpret_cast<const void*>(fn), smem); });
}

// The kernel a decode launches (TILE_THREADS threads a TILE_MCUS tile):
// ycbcr or RGB at scale 1, scaled RGB at 2, 4 or 8; with the 16-byte
// stores (vec16) or the byte stores.
template <typename T, int H, int V, int NC>
cudaError_t pick_kernel(bool ycbcr, int scale, bool vec16, KernelFn<T>& fn,
                        int& smem, bool& walks) {
  const auto pick = [&](auto ycbcr_c, auto n) {
    constexpr bool Y = decltype(ycbcr_c)::value;
    constexpr int N = decltype(n)::value;
    return vec16 ? kernel_of<T, H, V, NC, Y, N, true>(fn, smem, walks)
                 : kernel_of<T, H, V, NC, Y, N, false>(fn, smem, walks);
  };
  using std::integral_constant;
  if (scale == 1) {
    return ycbcr ? pick(std::true_type{}, integral_constant<int, 8>{})
                 : pick(std::false_type{}, integral_constant<int, 8>{});
  }
  if (ycbcr) return cudaErrorInvalidValue;
  if (scale == 2) return pick(std::false_type{}, integral_constant<int, 4>{});
  if (scale == 4) return pick(std::false_type{}, integral_constant<int, 2>{});
  if (scale == 8) return pick(std::false_type{}, integral_constant<int, 1>{});
  return cudaErrorInvalidValue;
}

template <typename T, int H, int V, int NC>
int launch(const Args& a, bool ycbcr, int scale) {
  KernelFn<T> kernel;
  int smem;
  bool walks;
  const cudaError_t e =
      pick_kernel<T, H, V, NC>(ycbcr, scale, a.vec16, kernel, smem, walks);
  if (e != cudaSuccess) return e;
  const unsigned tiles = grid(a.num_mcus, TILE_MCUS);
  unsigned blocks = tiles;
  if (scale != 1) {
    // The wrapper's plan (ops/decode_kernel.scaled_plan): a block a tile,
    // or, where the form walks, fewer blocks that walk several tiles.
    if (a.blocks < 1 || a.blocks > tiles || (a.blocks < tiles && !walks)) {
      return cudaErrorInvalidValue;
    }
    blocks = static_cast<unsigned>(a.blocks);
  }
  kernel<<<blocks, TILE_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.coeffs), a.qidx, a.qpool, a.num_q, a.out,
      a.num_mcus);
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
           int h, int v, int ncomp, void* stream, bool ycbcr, int scale,
           long long blocks = 0) {
  if (num_mcus <= 0 || num_q <= 0) return cudaErrorInvalidValue;
  const Args a{coeffs, static_cast<const int32_t*>(qidx),
               static_cast<const int32_t*>(qpool), num_q,
               static_cast<uint8_t*>(out), num_mcus,
               static_cast<cudaStream_t>(stream),
               num_mcus % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(out) % VEC == 0,
               blocks};
  return dispatch_wire(wire_bytes, [&](auto wire) {
    using T = decltype(wire);
    return dispatch_mode(h, v, ncomp, [&](auto mode) {
      using M = decltype(mode);
      return launch<T, M::h, M::v, M::nc>(a, ycbcr, scale);
    });
  });
}

// The blocks of the scaled kernel that the current device holds at once,
// on every SM, where its form walks tiles; 0 where it does not.
int scaled_resident(int wire_bytes, int h, int v, int ncomp, int scale,
                    bool vec16, int* resident) {
  if (scale == 1) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e != cudaSuccess) return e;
  return dispatch_wire(wire_bytes, [&](auto wire) {
    using T = decltype(wire);
    return dispatch_mode(h, v, ncomp, [&](auto mode) {
      using M = decltype(mode);
      KernelFn<T> fn;
      int smem, per_sm = 0;
      bool walks;
      cudaError_t err = pick_kernel<T, M::h, M::v, M::nc>(
          false, scale, vec16, fn, smem, walks);
      if (err == cudaSuccess && walks) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fn, TILE_THREADS, smem);
      }
      *resident = per_sm * sms;
      return static_cast<int>(err);
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

// Scaled decode, scale 2, 4 or 8: output [3, luma_slots, (8/scale)^2, M],
// on `blocks` CUDA blocks (1 to ceil(M / 32); below that each walks
// several tiles, see ops/decode_kernel.scaled_plan).
extern "C" int pjt_cuda_decode_rgb_scaled(const void* coeffs, int wire_bytes,
                                          const void* qidx, const void* qpool,
                                          int num_q, void* out,
                                          long long num_mcus, int h, int v,
                                          int ncomp, int scale,
                                          long long blocks, void* stream) {
  if (scale == 1) return cudaErrorInvalidValue;
  return decode(coeffs, wire_bytes, qidx, qpool, num_q, out, num_mcus, h, v,
                ncomp, stream, false, scale, blocks);
}

// The scaled kernel's resident blocks on the current device (vec16: its
// 16-byte store form) where that form walks tiles, else 0.
extern "C" int pjt_cuda_rgb_scaled_resident(int wire_bytes, int h, int v,
                                            int ncomp, int scale, int vec16,
                                            int* resident) {
  return scaled_resident(wire_bytes, h, v, ncomp, scale, vec16 != 0,
                         resident);
}
