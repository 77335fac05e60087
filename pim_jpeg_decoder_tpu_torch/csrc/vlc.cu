// The variable-length-code symbol loop, decoded as chunk maps composed
// across one thread-block cluster.
//
// Replaces the Pallas kernel of tools/tpu_vlc_bench.py:
//   vlc_kernel <- _vlc_kernel: from bit (seed & 1) of a 2,048-word
//                 bitstream, read a 32-bit window at the bit position, look
//                 its top 8 bits up in a 256-entry table (entry & 0xF: code
//                 bits, (entry >> 4) & 0xF: value bits, (entry >> 8) & 0xFF:
//                 added to a sum) and advance by code + value bits, until
//                 the position reaches 2,048*32 - 64; writes int32
//                 [acc, nsym, bitpos].
// The TPU kernel runs the loop on the scalar core, one symbol after
// another, because only that core can make a dynamic load a step.
//
// What bounds it on an H100: neither bytes (9 KB in, 12 bytes out) nor
// operations (~9 integer operations a symbol): both come to a few
// nanoseconds.  Run as one loop on one thread it is its dependency chain,
// two dependent shared-memory loads and the window funnel a symbol, 8,639
// symbols long on the tool's draw, with 131 SMs idle.  The chain is not a
// property of the function: a symbol's advance depends only on its bit
// position, so the stream can be decoded from every position at once.
// What is left is a launch (a 4-byte fill_ takes ~5 us from launch to
// launch), each lane's ~34 symbols, issued by 16 warps an SM, and the
// barriers between the phases.
//
// The design.  [0, NBITS) is cut into CHUNKS chunks of CHUNK_BITS bits.  A
// symbol advances at most 15 + 15 bits, so the path enters a chunk at one
// of its first ENTRY_OFFSETS = 30 positions.  One warp a chunk:
// lane o decodes serially from the chunk's start + o until its position
// reaches the chunk's end (NBITS for the last chunk), and writes a map
// entry, (exit position, symbols, sum, fixed point).  A table entry with no
// advance is a fixed point: the serial loop circles it until its count
// reaches NBITS, so the lane stops there and records the entry's value.
// On the tool's draw a lane decodes ~34 symbols instead of 8,639.  The
// table is staged as advance | value << 8.
//   The maps compose: the entry of chunk c at offset o, followed by the
// entry of chunk c + 1 that its exit lands on, is the entry of chunks
// [c, c + 1] at o.  The 16 blocks of a cluster (above the portable 8, so
// the launch opts in) own 16 chunks each, a warp a chunk: the lanes' loops
// are bound by issue, and 16 warps an SM finish them sooner than 8 blocks
// of 32 warps did (~1.3 us of ~13 on an H100 SXM).  Lane o of a
// block's warp 0 composes the block's 16 maps in order from offset o (16
// dependent lookups, cheaper than a tree's block barriers) and stores the
// block's map into block 0's shared memory through distributed shared
// memory.  One cluster barrier later, one thread of block 0 walks the 16
// block maps from offset seed & 1.  A fixed point p* reached after n
// symbols with sum a ends the walk at [a + (NBITS - n) * value(p*), NBITS,
// p*], what the serial loop's nsym cap gives; an exit at or past NBITS
// ends it at [a, n, exit].  A relaxed cluster arrive after the staging,
// waited on before the stores, tells that every block has started before
// any writes into another.
//
// Arithmetic is uint32_t, as the TPU kernel's int32 with logical shifts;
// sums wrap as the serial loop's do.  lo >> (32 - shift) is undefined in C
// at shift == 0, where the TPU kernel selects 0: kept as an explicit
// branch.  A block stages the words its chunks read (its 128 and the next
// one) and the table into shared memory; no lane reads at or past NBITS,
// so the window's second word stays clear of the stream's last word.
// Every chunk exit must land on one of the next chunk's entry offsets: the
// constants assert it, and an exit that does not is counted on the card
// (pjt_cuda_vlc_exit_violations) instead of being read out of range.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "decode_tile.cuh"   // PerDevice

namespace cg = cooperative_groups;

namespace {

constexpr int NWORDS = 2048;
constexpr int LUT_SIZE = 256;
constexpr uint32_t NBITS = NWORDS * 32 - 64;
// A symbol advances at most 15 code + 15 value bits (advance_of below).
constexpr uint32_t ENTRY_OFFSETS = 30;
constexpr uint32_t CHUNK_BITS = 256;
constexpr int CHUNKS = (NBITS + CHUNK_BITS - 1) / CHUNK_BITS;
constexpr int CLUSTER_CTAS = 16;    // non-portable: the launch opts in
constexpr int CHUNKS_PER_CTA = CHUNKS / CLUSTER_CTAS;   // a warp a chunk
constexpr int THREADS = CHUNKS_PER_CTA * 32;
constexpr uint32_t CTA_BITS = CHUNKS_PER_CTA * CHUNK_BITS;
constexpr int CTA_WORDS = CTA_BITS / 32 + 1;   // and the next word

// A table entry's advance: code bits + value bits.
__host__ __device__ constexpr uint32_t advance_of(uint32_t entry) {
  return (entry & 0xFu) + ((entry >> 4) & 0xFu);
}

// Lane o starts at offset o < ENTRY_OFFSETS: one lane a warp each.
static_assert(ENTRY_OFFSETS <= 32, "an entry offset a lane");
// A lane stops at its first position >= the chunk's end E; from E - 1 at
// most, one symbol takes it to E + advance_of(0xFF) - 1, an entry offset of
// the next chunk, if every lane starts before the next chunk.  (A lane of
// the last chunk may start at or past NBITS: it writes its start, no
// symbol.)
static_assert(ENTRY_OFFSETS >= advance_of(0xFFu),
              "an exit past the entry offsets");
static_assert(CHUNK_BITS >= ENTRY_OFFSETS, "a lane starts past its chunk");
static_assert(CHUNKS % CLUSTER_CTAS == 0, "whole chunks a block");
static_assert(THREADS <= 1024, "a block too large");
static_assert(CTA_BITS % 32 == 0, "a block's bits end on a word");
static_assert(CLUSTER_CTAS <= 16, "the largest cluster an H100 takes");

// One map entry: where the path leaves the chunk (or its fixed point),
// the symbols and the sum up to there, and 0x100 | the fixed point's
// value (0: none).
struct __align__(16) Entry {
  uint32_t exit, n, a, fix;
};

__device__ unsigned int g_exit_violations = 0;

__device__ __forceinline__ Entry compose(const Entry& left,
                                         const Entry* right,
                                         uint32_t right_start) {
  if (left.fix != 0 || left.exit >= NBITS) return left;
  const uint32_t o = left.exit - right_start;
  if (o >= ENTRY_OFFSETS) {           // unsigned: an exit before it too
    atomicAdd(&g_exit_violations, 1u);
    return left;
  }
  const Entry r = right[o];
  return Entry{r.exit, left.n + r.n, left.a + r.a, r.fix};
}

// The cluster barrier in two halves (PTX barrier.cluster): arrive, then
// wait.  Arrive is relaxed where it only tells that the block has started,
// and releases the block's writes otherwise; wait acquires them.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

__global__ void __launch_bounds__(THREADS)
vlc_kernel(const int32_t* __restrict__ seed, const int32_t* __restrict__ data,
           const int32_t* __restrict__ lut, int32_t* __restrict__ out) {
  __shared__ uint32_t words[CTA_WORDS];
  __shared__ uint32_t table[LUT_SIZE];   // advance | value << 8
  __shared__ Entry maps[CHUNKS_PER_CTA][ENTRY_OFFSETS];
  __shared__ Entry heads[CLUSTER_CTAS][ENTRY_OFFSETS];   // block 0's only

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned cta = cluster.block_rank();
  const unsigned tid = threadIdx.x;
  const uint32_t first_word = cta * (CTA_BITS / 32);
  for (unsigned i = tid; i < CTA_WORDS; i += THREADS) {
    const uint32_t w = first_word + i;
    words[i] = w < NWORDS ? static_cast<uint32_t>(__ldg(data + w)) : 0u;
  }
  for (unsigned i = tid; i < LUT_SIZE; i += THREADS) {
    const uint32_t entry = static_cast<uint32_t>(__ldg(lut + i));
    table[i] = advance_of(entry) | (entry & 0xFF00u);
  }
  __syncthreads();
  cluster_arrive_relaxed();   // this block has started (waited on below)

  // Phase 1: lane o of warp w decodes chunk cta * CHUNKS_PER_CTA + w from
  // its start + o.
  const unsigned w = tid / 32, o = tid % 32;
  const uint32_t chunk_start = (cta * CHUNKS_PER_CTA + w) * CHUNK_BITS;
  const uint32_t chunk_end = min(chunk_start + CHUNK_BITS, NBITS);
  if (o < ENTRY_OFFSETS) {
    uint32_t p = chunk_start + o, n = 0, a = 0, fix = 0;
    while (p < chunk_end) {
      const uint32_t widx = (p >> 5) - first_word, shift = p & 31u;
      const uint32_t hi = words[widx], lo = words[widx + 1];
      const uint32_t win =
          (hi << shift) | (shift == 0 ? 0u : lo >> (32 - shift));
      const uint32_t t = table[win >> 24];
      const uint32_t advance = t & 0xFFu;
      if (advance == 0) {
        fix = 0x100u | (t >> 8);
        break;
      }
      a += t >> 8;
      p += advance;
      ++n;
    }
    maps[w][o] = Entry{p, n, a, fix};
  }
  __syncthreads();

  // Phase 2: lane o of warp 0 composes the block's chunk maps in order from
  // offset o: the block's map, pushed into block 0's heads through
  // distributed shared memory once every block has started.
  cluster_wait();
  if (w == 0 && o < ENTRY_OFFSETS) {
    Entry e = maps[0][o];
    for (unsigned c = 1; c < CHUNKS_PER_CTA; ++c) {
      e = compose(e, maps[c], chunk_start + c * CHUNK_BITS);
    }
    cluster.map_shared_rank(&heads[0][0], 0)[cta * ENTRY_OFFSETS + o] = e;
  }
  __syncwarp();       // the barrier's .aligned form wants whole warps
  cluster_arrive();   // releases the pushes; the others may exit after it
  cluster_wait();
  if (cta != 0 || tid != 0) return;

  // Phase 3: one thread walks the blocks' maps from seed & 1.
  Entry path{static_cast<uint32_t>(__ldg(seed)) & 1u, 0, 0, 0};
  for (int k = 0; k < CLUSTER_CTAS; ++k) {
    path = compose(path, heads[k], k * CTA_BITS);
  }
  if (path.fix != 0) {
    path.a += (NBITS - path.n) * (path.fix & 0xFFu);
    path.n = NBITS;
  }
  out[0] = static_cast<int32_t>(path.a);
  out[1] = static_cast<int32_t>(path.n);
  out[2] = static_cast<int32_t>(path.exit);
}

}  // namespace

// C entry point (bound with ctypes): launches one cluster of CLUSTER_CTAS
// blocks on `stream` (once per device, the kernel first opts in to a
// cluster above the portable 8), allocates nothing, returns the error of
// that or cudaGetLastError() after the launch (0 = launched).  seed int32
// [1], data int32 [2048], lut int32 [256], out int32 [3], all on the card.
extern "C" int pjt_cuda_vlc(const void* seed, const void* data,
                            const void* lut, void* out, void* stream) {
  static PerDevice prepared;
  const cudaError_t ready = prepared.get([] {
    return cudaFuncSetAttribute(
        vlc_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  });
  if (ready != cudaSuccess) return static_cast<int>(ready);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CLUSTER_CTAS;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER_CTAS);
  config.blockDim = dim3(THREADS);
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &cluster;
  config.numAttrs = 1;
  cudaLaunchKernelEx(&config, vlc_kernel, static_cast<const int32_t*>(seed),
                     static_cast<const int32_t*>(data),
                     static_cast<const int32_t*>(lut),
                     static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The chunk exits that landed on no entry offset of the next chunk, summed
// over every launch on the current device so far, into *count; waits for
// the device.  Returns the cudaError of the copy (0 = read).
extern "C" int pjt_cuda_vlc_exit_violations(unsigned int* count) {
  return static_cast<int>(cudaMemcpyFromSymbol(count, g_exit_violations,
                                               sizeof(unsigned int)));
}
