// B1: the encoder deposit (desc -> code lookup -> bit offsets -> words).
//
// Replaces fpng_tpu/ops/encfuse.py:encode_bits_fused (Pallas kernel
// _make_encfuse_kernel / _encfuse_body).  Per unit of the (B, N) desc stream
// (layout in fpng_tpu_torch/ops/encfuse.py): look up code | size << 16 in the
// image's 288-entry table, add the extra bits, and deposit (value, nbits) at
// the unit's exclusive bit offset from base_bits into little-endian words.
// Also emits total_bits and the start of the last token (stored-fallback
// rule, fpng.cpp:1744).
//
// What bounds it on the H100: bytes.  It reads the 4-byte desc twice (sum
// pass and deposit pass) and writes about N * bits / 8 bytes of words, so it
// is a streaming kernel with a few integer ops per unit.  The TPU carried
// the running bit offset through its sequential grid; here blocks run in no
// order, so the offsets are a real per-image scan in three launches:
//   1. encfuse_sums:    per-block sums of nbits,
//   2. encfuse_scan:    exclusive scan of the block sums per image,
//   3. encfuse_deposit: lookup, in-block scan, and the deposit itself.
// Each thread owns kItems consecutive units and ORs whole words (BitSink),
// so atomics are about one per output word, not one per unit.  Bit offsets
// are int64 (a raster past 2^27 bytes has streams near 2^31 bits); the
// int32 outputs total_bits and last_tok saturate at 2^31 - 1, as the plain
// version's do, and such a stream is past the stored-fallback budget.

#include <climits>

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kTblEntries = 512;  // sym is 9 bits; the table holds 1024

struct Unit {
  uint32_t val;
  int n;
  int ts;
};

__device__ __forceinline__ Unit decode_unit(int d, const int* tbl_s) {
  const int sym = d & 511;
  const int use_t = (d >> 9) & 1;
  const int en = (d >> 10) & 7;
  const uint32_t ev = (uint32_t)((d >> 13) & 0x1FFF);
  const int e = use_t ? tbl_s[sym] : 0;
  const int sz = e >> 16;
  Unit u;
  u.val = (uint32_t)(e & 0xFFFF) | (ev << sz);
  u.n = sz + en;
  u.ts = (d >> 26) & 1;
  return u;
}

__device__ __forceinline__ void load_table(const int* tbl, int b, int* tbl_s) {
  for (int i = threadIdx.x; i < kTblEntries; i += blockDim.x)
    tbl_s[i] = tbl[(size_t)b * 1024 + i];
}

__global__ void __launch_bounds__(kThreads)
encfuse_sums(const int* __restrict__ desc, const int* __restrict__ tbl, int N,
             int nblk, long long* __restrict__ block_offs) {
  __shared__ int tbl_s[kTblEntries];
  __shared__ int red[32];
  const int b = blockIdx.y;
  load_table(tbl, b, tbl_s);
  __syncthreads();
  const int* d = desc + (size_t)b * N;
  const long long start = (long long)blockIdx.x * kTile;
  int s = 0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long j = start + i;
    if (j < N) s += decode_unit(d[j], tbl_s).n;
  }
  int total;
  block_incl_scan<kThreads>(s, red, total);
  if (threadIdx.x == 0) block_offs[(size_t)b * nblk + blockIdx.x] = total;
}

// One block per image: block sums -> base_bits + exclusive prefix, in place.
__global__ void __launch_bounds__(1024)
encfuse_scan(long long* __restrict__ block_offs,
             const int* __restrict__ base_bits, int nblk,
             int* __restrict__ total_bits) {
  __shared__ int red[32];
  const int b = blockIdx.x;
  long long* s = block_offs + (size_t)b * nblk;
  long long carry = base_bits[b];
  for (int start = 0; start < nblk; start += 1024) {
    const int i = start + threadIdx.x;
    // a block sum is under 2^17 and 1024 of them under 2^27: int scans
    const int v = i < nblk ? (int)s[i] : 0;
    int chunk;
    const int incl = block_incl_scan<1024>(v, red, chunk);
    if (i < nblk) s[i] = carry + incl - v;
    carry += chunk;
  }
  if (threadIdx.x == 0) total_bits[b] = (int)min(carry, (long long)INT_MAX);
}

__global__ void __launch_bounds__(kThreads)
encfuse_deposit(const int* __restrict__ desc, const int* __restrict__ tbl,
                const long long* __restrict__ block_offs, int N, int nblk,
                int num_words, uint32_t* __restrict__ words,
                int* __restrict__ last_tok) {
  __shared__ int tbl_s[kTblEntries];
  __shared__ int d_s[kTilePadded];
  __shared__ int red[32];
  const int b = blockIdx.y;
  load_table(tbl, b, tbl_s);
  const int* d = desc + (size_t)b * N;
  const long long start = (long long)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long j = start + i;
    d_s[pad(i)] = j < N ? d[j] : 0;  // desc 0 is a zero-width unit
  }
  __syncthreads();

  Unit u[kItems];
  int s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    u[k] = decode_unit(d_s[pad(threadIdx.x * kItems + k)], tbl_s);
    s += u[k].n;
  }
  int unused;
  const int incl = block_incl_scan<kThreads>(s, red, unused);
  long long off = block_offs[(size_t)b * nblk + blockIdx.x] + incl - s;

  uint32_t* w = words + (size_t)b * num_words;
  BitSink sink;
  int lt = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (u[k].ts) lt = (int)min(off, (long long)INT_MAX);
    sink.put(w, num_words, u[k].val, off);
    off += u[k].n;
  }
  sink.flush(w, num_words);
  lt = block_max<kThreads>(lt, red);
  if (threadIdx.x == 0 && lt >= 0) atomicMax(last_tok + b, lt);
}

}  // namespace
}  // namespace fpng

// desc (B, N), tbl (B, 1024) packed code | size << 16, base_bits (B,)
// -> words (B, num_words) zeroed by the caller, total_bits (B,),
// last_tok (B,) set to -1 by the caller; block_offs (B, nblk) int64
// scratch.
extern "C" int fpng_encfuse(const int* desc, const int* tbl,
                            const int* base_bits, int B, int N, int num_words,
                            int* words, int* total_bits, int* last_tok,
                            long long* block_offs, void* stream) {
  using namespace fpng;
  if (B <= 0 || N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (N + kTile - 1) / kTile;
  const dim3 grid(nblk, B);
  encfuse_sums<<<grid, kThreads, 0, s>>>(desc, tbl, N, nblk, block_offs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  encfuse_scan<<<B, 1024, 0, s>>>(block_offs, base_bits, nblk, total_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  encfuse_deposit<<<grid, kThreads, 0, s>>>(
      desc, tbl, block_offs, N, nblk, num_words, (uint32_t*)words, last_tok);
  return (int)cudaGetLastError();
}
