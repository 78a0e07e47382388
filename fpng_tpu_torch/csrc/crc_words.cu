// B2: the word-domain IDAT CRC.
//
// Replaces fpng_tpu/ops/checksum.py:crc32_words_masked_raw (Pallas kernel
// _crc_words_kernel plus its log-depth GF(2) combine) together with the
// variable-length finish of fpng_tpu/ops/assemble.py:idat_crc_words.
// CRC-32 is GF(2)-linear in the message, so the raw (init-0) register of a
// 4096-byte chunk is the XOR of the contributions of its set bits;
// table[k][j] (fpng_tpu_torch/ops/checksum.py:_word_bit_table) is the
// contribution of bit k of word j.  Bytes outside [plen, tb) read as zero.
//
// fpng_idat_crc computes the whole IDAT CRC in one launch.  Each chunk
// block shifts its register by the 4096 * (K - 1 - c) zero bytes that follow
// it in the N-byte buffer and XORs it into a per-image word; the last block
// of an image to finish (a counter beside that word) then runs the finish:
// the unshift of the N - tb zero tail, the 4 big-endian adler bytes, the
// prefix shift of raw(b"IDAT" + prefix) by tb + 4 - plen, the init term
// shift_{tb+8}(0xFFFFFFFF) and the final XOR.  The register of the full
// buffer is the XOR of the shifted chunk registers by linearity; the plain
// version's combine tree (ops/assemble.py:idat_crc_words_plain) prepends a
// zero chunk at odd levels, which is raw-neutral, so the bits are the same.
//
// A shift by k zero bytes is multiplication by x^(8k) mod P: a GF(2)
// mat-vec per set bit of k with the host's 2^t-byte matrices (shift and
// inverse, ops/checksum.py:_shift_tables).  One warp applies a matrix:
// lane i takes basis image i where bit i of the register is set, and five
// shuffles XOR the lanes together.
//
// What bounds it on the H100: bytes in (the words of the chunks that
// overlap [plen, tb)), plus table lookups that hit L1/L2 (the table is
// 128 KB).  One block per (chunk, image); each thread takes words j = tid,
// tid + 256, ... so the word reads are coalesced, XORs the table entries of
// the word's set bits, and the block reduces with __shfl_xor_sync and
// shared memory.  Chunks wholly outside [plen, tb) are all zero after
// masking and skip the work.  The finish is a few dozen warp mat-vecs per
// image, off the bytes' critical path.

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kChunkWords = 1024;
constexpr int kShiftLevels = 32;   // 2^t-byte matrices, t < 32
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t ones_below(long long c) {
  // mask of the low 8*c bits of a word, c clipped to [0, 4]
  if (c <= 0) return 0u;
  if (c >= 4) return 0xFFFFFFFFu;
  return (1u << (8 * (int)c)) - 1u;
}

// Raw register of chunk c of image b with bytes outside [l, h) zeroed;
// every thread of the block calls and gets the result.
__device__ __forceinline__ uint32_t chunk_register(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ table,
    int NW, int b, int c, long long l, long long h, uint32_t* red) {
  const long long b0 = (long long)c * kChunkWords * 4;  // first byte
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
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(kFull, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) r ^= red[i];
  return r;
}

// Apply a GF(2) matrix given as 32 basis images to v (uniform across the
// warp); every lane of the warp calls and gets the result.
__device__ __forceinline__ uint32_t gf2_apply(const uint32_t* __restrict__ m,
                                              uint32_t v) {
  const int lane = threadIdx.x & 31;
  uint32_t x = ((v >> lane) & 1u) ? __ldg(m + lane) : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(kFull, x, o);
  return x;
}

// Advance (pow2 = the shift matrices) or reverse (the inverse ones) v
// through k zero bytes, k < 2^32; k is uniform across the warp.
__device__ __forceinline__ uint32_t gf2_shift(
    const uint32_t* __restrict__ pow2, uint32_t v, unsigned long long k) {
  for (int t = 0; k != 0 && t < kShiftLevels; ++t, k >>= 1)
    if (k & 1ull) v = gf2_apply(pow2 + 32 * t, v);
  return v;
}

__device__ __forceinline__ int bit_length(unsigned long long x) {
  return x == 0 ? 0 : 64 - __clzll(x);
}

// The plain finish clamps each shift count at 0 and reads only the low
// max(bit_length(max_k), 1) bits of it (ops/checksum.py:_var_shift).
__device__ __forceinline__ unsigned long long shift_count(long long k,
                                                          long long max_k) {
  const int bits = max(bit_length((unsigned long long)max_k), 1);
  const unsigned long long m = bits >= 64 ? ~0ull : (1ull << bits) - 1ull;
  return (unsigned long long)max(k, 0ll) & m;
}

// meta (B, 4) int32: plen, raw(b"IDAT" + prefix), and two scratch words (the
// image's XOR of shifted chunk registers and its count of finished chunk
// blocks) that the caller uploads as zero.  shifts: 32 shift matrices, 32
// inverse ones and the 4-byte word table (ops/checksum.py:_bit_table_4).
__global__ void __launch_bounds__(kThreads)
idat_crc_kernel(const uint32_t* __restrict__ words,
                const long long* __restrict__ total_bits,
                const long long* __restrict__ adler, int* __restrict__ meta,
                const uint32_t* __restrict__ table,
                const uint32_t* __restrict__ shifts, int NW,
                long long* __restrict__ crc) {
  __shared__ uint32_t red[kThreads / 32];
  const int b = blockIdx.y, c = blockIdx.x;
  const int K = NW / kChunkWords;
  const long long N = 4ll * NW;
  const long long tb = (total_bits[b] + 7) >> 3;
  const long long plen = meta[4 * b];
  const uint32_t r = chunk_register(words, table, NW, b, c, plen, tb, red);
  if (threadIdx.x >= 32) return;

  const uint32_t* fwd = shifts;
  const uint32_t* inv = shifts + 32 * kShiftLevels;
  const uint32_t* raw4 = shifts + 64 * kShiftLevels;
  unsigned int* acc = (unsigned int*)(meta + 4 * b + 2);
  unsigned int* done = (unsigned int*)(meta + 4 * b + 3);
  const uint32_t v =
      r ? gf2_shift(fwd, r, (unsigned long long)kChunkWords * 4 * (K - 1 - c))
        : 0u;
  int last = 0;
  if (threadIdx.x == 0) {
    if (v) atomicXor(acc, v);
    __threadfence();
    last = atomicAdd(done, 1u) == (unsigned)(K - 1);
  }
  if (!__shfl_sync(kFull, last, 0)) return;

  // the last chunk block of image b: the finish
  __threadfence();
  const uint32_t full =
      __shfl_sync(kFull, threadIdx.x == 0 ? atomicOr(acc, 0u) : 0u, 0);
  // the registers describe the full N-byte masked buffer: strip the tail
  const uint32_t stuff = gf2_shift(inv, full, shift_count(N - tb, N));
  // append the 4 big-endian adler bytes
  const uint32_t a = (uint32_t)adler[b];
  const uint32_t a_le = __byte_perm(a, 0, 0x0123);
  const uint32_t raw1 = gf2_apply(fwd + 32 * 2, stuff) ^ gf2_apply(raw4, a_le);
  // prepend b"IDAT" + prefix: raw(A||X) = shift_{|X|}(raw(A)) ^ raw(X)
  const uint32_t raw_m = gf2_shift(fwd, (uint32_t)meta[4 * b + 1],
                                   shift_count(tb + 4 - plen, N + 8)) ^
                         raw1;
  // standard CRC init/final: crc = raw ^ shift_len(0xFFFFFFFF) ^ ~0
  const uint32_t init = gf2_shift(fwd, 0xFFFFFFFFu, shift_count(tb + 8, N + 8));
  if (threadIdx.x == 0) crc[b] = (long long)(raw_m ^ init ^ 0xFFFFFFFFu);
}

}  // namespace
}  // namespace fpng

// words (B, NW) with NW % 1024 == 0 and 4 * NW + 8 < 2^32, total_bits (B,)
// int64, adler (B,) int64, meta (B, 4) int32 (plen, raw_ip, 0, 0), table
// (32, 1024), shifts (65, 32) -> crc (B,) int64 IDAT chunk CRCs.
extern "C" int fpng_idat_crc(const int* words, const long long* total_bits,
                             const long long* adler, int* meta,
                             const int* table, const int* shifts, int B,
                             int NW, long long* crc, void* stream) {
  using namespace fpng;
  if (B <= 0 || NW <= 0) return 0;
  const dim3 grid(NW / kChunkWords, B);
  idat_crc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, total_bits, adler, meta, (const uint32_t*)table,
      (const uint32_t*)shifts, NW, crc);
  return (int)cudaGetLastError();
}
