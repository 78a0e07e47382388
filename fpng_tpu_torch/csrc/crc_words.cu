// B2: the word-domain IDAT CRC (init-0 register of each 1024-word chunk).
//
// Replaces fpng_tpu/ops/checksum.py:crc32_words_masked_raw (Pallas kernel
// _crc_words_kernel).  CRC-32 is GF(2)-linear in the message, so the raw
// register of a 4096-byte chunk is the XOR of the contributions of its set
// bits; table[k][j] (fpng_tpu_torch/ops/checksum.py:_word_bit_table) is the
// contribution of bit k of word j.  Bytes outside [lo, hi) read as zero.
// The log-depth combine of the chunk registers stays in torch ops.
//
// What bounds it on the H100: bytes in, plus table lookups that hit L1/L2
// (the table is 128 KB).  One block per (chunk, image); each thread takes
// words j = tid, tid + 256, ... so the word reads are coalesced, XORs the
// table entries of the word's set bits, and the block reduces with
// __shfl_xor_sync and shared memory.  Chunks wholly outside [lo, hi) are all
// zero after masking and skip the work.

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kChunkWords = 1024;

__device__ __forceinline__ uint32_t ones_below(long long c) {
  // mask of the low 8*c bits of a word, c clipped to [0, 4]
  if (c <= 0) return 0u;
  if (c >= 4) return 0xFFFFFFFFu;
  return (1u << (8 * (int)c)) - 1u;
}

__global__ void __launch_bounds__(kThreads)
crc_words_kernel(const uint32_t* __restrict__ words, const int* __restrict__ lo,
                 const int* __restrict__ hi, const uint32_t* __restrict__ table,
                 int NW, uint32_t* __restrict__ regs) {
  __shared__ uint32_t red[kThreads / 32];
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int K = NW / kChunkWords;
  const long long b0 = (long long)c * kChunkWords * 4;  // first byte
  const long long l = lo[b], h = hi[b];
  uint32_t acc = 0;
  if (b0 < h && b0 + 4 * kChunkWords > l) {  // uniform across the block
    const uint32_t* w = words + (size_t)b * NW + (size_t)c * kChunkWords;
    for (int j = threadIdx.x; j < kChunkWords; j += kThreads) {
      const long long p = b0 + 4 * j;
      uint32_t x = w[j] & ~ones_below(l - p) & ones_below(h - p);
      while (x != 0) {
        const int k = __ffs(x) - 1;
        acc ^= __ldg(table + k * kChunkWords + j);
        x &= x - 1;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) r ^= red[i];
    regs[(size_t)b * K + c] = r;
  }
}

}  // namespace
}  // namespace fpng

// words (B, NW) with NW % 1024 == 0, lo/hi (B,) byte bounds, table (32, 1024)
// -> regs (B, NW / 1024) raw chunk registers.
extern "C" int fpng_crc_words(const int* words, const int* lo, const int* hi,
                              const int* table, int B, int NW, int* regs,
                              void* stream) {
  using namespace fpng;
  if (B <= 0 || NW <= 0) return 0;
  const dim3 grid(NW / kChunkWords, B);
  crc_words_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, lo, hi, (const uint32_t*)table, NW,
      (uint32_t*)regs);
  return (int)cudaGetLastError();
}
