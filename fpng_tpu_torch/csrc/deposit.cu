// B10: the generic monotone bit deposit (decoder record expansion).
//
// Replaces fpng_tpu/ops/bitpack.py:scatter_bits_tpu (Pallas kernel
// _make_deposit_kernel in generic mode, with _window_deposit), as reached
// through deposit_bits with zero_init=True.  Each unit ORs its value at its
// absolute bit offset into zeroed little-endian words; words at index >=
// num_words are dropped and zero values deposit nothing, so every word
// equals what the plain scatter-add (ops/bitpack.py:scatter_bits) gives.
//
// What bounds it on the H100: bytes.  It streams 8 bytes per unit in and
// writes each touched word once; the decoder's record stream is mostly
// zero-width slots, so the reads dominate.  Loads are staged through shared
// memory so that global reads are coalesced while each thread still walks
// kItems consecutive units and ORs whole words (the same BitSink as the
// encoder's deposit, fpng_tpu_torch/csrc/common.cuh).

#include "common.cuh"

namespace fpng {
namespace {

__global__ void __launch_bounds__(kThreads)
deposit_kernel(const int* __restrict__ vals, const int* __restrict__ offs,
               int N, int num_words, uint32_t* __restrict__ words) {
  __shared__ int v_s[kTilePadded];
  __shared__ int o_s[kTilePadded];
  const int b = blockIdx.y;
  const int* v = vals + (size_t)b * N;
  const int* o = offs + (size_t)b * N;
  const long long start = (long long)blockIdx.x * kTile;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long j = start + i;
    v_s[pad(i)] = j < N ? v[j] : 0;
    o_s[pad(i)] = j < N ? o[j] : 0;
  }
  __syncthreads();
  uint32_t* w = words + (size_t)b * num_words;
  BitSink sink;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = pad(threadIdx.x * kItems + k);
    sink.put(w, num_words, (uint32_t)v_s[i], (long long)o_s[i]);
  }
  sink.flush(w, num_words);
}

}  // namespace
}  // namespace fpng

// vals, offsets (B, N) -> words (B, num_words), zeroed by the caller.
extern "C" int fpng_deposit(const int* vals, const int* offsets, int B, int N,
                            int num_words, int* words, void* stream) {
  using namespace fpng;
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, B);
  deposit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      vals, offsets, N, num_words, (uint32_t*)words);
  return (int)cudaGetLastError();
}
