// The serial variable-length-code symbol loop on one GPU thread.
//
// Replaces the Pallas kernel of tools/tpu_vlc_bench.py:
//   vlc_kernel <- _vlc_kernel: from bit (seed & 1) of a 2,048-word
//                 bitstream, read a 32-bit window at the bit position, look
//                 its top 8 bits up in a 256-entry table (entry & 0xF: code
//                 bits, (entry >> 4) & 0xF: value bits, (entry >> 8) & 0xFF:
//                 added to a sum) and advance by code + value bits, until
//                 the position reaches 2,048*32 - 64; writes int32
//                 [acc, nsym, bitpos].
// The TPU kernel runs on the scalar core with the stream and the table in
// SMEM.  Here one block stages both into shared memory (SMEM's
// counterpart; 9 KB) with all its threads, then one thread runs the loop.
//
// What bounds it on an H100: the loop's dependency chain, not bytes (9 KB)
// or operations.  Each symbol waits for two dependent shared-memory loads
// (the window words, then the table entry) and a few integer operations:
// the chain's latency times the number of symbols (8,639 on the tool's
// seed-0 draw).  A GPU gains nothing from its width here; that is the
// measurement.
//
// Arithmetic is uint32_t, as the TPU kernel's int32 with logical shifts.
// lo >> (32 - shift) is undefined in C at shift == 0, where the TPU kernel
// selects 0: kept as an explicit branch.  data[widx + 1] stays in range
// only because the loop stops at 2,048*32 - 64.  A table entry with no
// advance (code + value bits == 0) would loop forever in the TPU kernel;
// here the loop also stops after 2,048*32 - 64 symbols, which no table with
// a non-zero advance reaches, and the plain version stops at the same
// count.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int NWORDS = 2048;
constexpr int LUT_SIZE = 256;
constexpr uint32_t NBITS = NWORDS * 32 - 64;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
vlc_kernel(const int32_t* __restrict__ seed, const int32_t* __restrict__ data,
           const int32_t* __restrict__ lut, int32_t* __restrict__ out) {
  __shared__ uint32_t words[NWORDS];
  __shared__ uint32_t table[LUT_SIZE];
  for (int i = threadIdx.x; i < NWORDS; i += THREADS) {
    words[i] = static_cast<uint32_t>(__ldg(data + i));
  }
  for (int i = threadIdx.x; i < LUT_SIZE; i += THREADS) {
    table[i] = static_cast<uint32_t>(__ldg(lut + i));
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  uint32_t bitpos = static_cast<uint32_t>(__ldg(seed)) & 1u;
  uint32_t acc = 0, nsym = 0;
  while (bitpos < NBITS && nsym < NBITS) {
    const uint32_t widx = bitpos >> 5, shift = bitpos & 31u;
    const uint32_t hi = words[widx], lo = words[widx + 1];
    const uint32_t win = (hi << shift) | (shift == 0 ? 0u : lo >> (32 - shift));
    const uint32_t entry = table[win >> 24];
    acc += (entry >> 8) & 0xFFu;
    bitpos += (entry & 0xFu) + ((entry >> 4) & 0xFu);
    ++nsym;
  }
  out[0] = static_cast<int32_t>(acc);
  out[1] = static_cast<int32_t>(nsym);
  out[2] = static_cast<int32_t>(bitpos);
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, allocates
// nothing, returns cudaGetLastError() after the launch (0 = launched).
// seed int32 [1], data int32 [2048], lut int32 [256], out int32 [3], all
// on the card.
extern "C" int pjt_cuda_vlc(const void* seed, const void* data,
                            const void* lut, void* out, void* stream) {
  vlc_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seed), static_cast<const int32_t*>(data),
      static_cast<const int32_t*>(lut), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
