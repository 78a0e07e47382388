// B10: the generic monotone bit deposit (the chunked decode's record
// expansion), and B5: the walk8 decode's literal deposit.
//
// Replaces fpng_tpu/ops/bitpack.py:scatter_bits_tpu (Pallas kernel
// _make_deposit_kernel in generic mode, with _window_deposit), as reached
// through deposit_bits with zero_init=True.  Each unit ORs its value at its
// absolute bit offset into zeroed little-endian words; words at index >=
// num_words are dropped and zero values deposit nothing, so every word
// equals what the plain scatter-add (ops/bitpack.py:scatter_bits) gives.
//
// Offsets are int32 in units of 2^shift bits (the chunked decode passes
// 16-bit slot indices with shift 4), widened to 64-bit bit offsets in the
// kernel: a raster past 2^27 bytes has record offsets past 2^31 bits, and
// int64 offsets in memory would add 4 bytes a unit that carry nothing.
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
               int shift, int N, long long num_words,
               uint32_t* __restrict__ words) {
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
    sink.put(w, num_words, (uint32_t)v_s[i], (long long)o_s[i] << shift);
  }
  sink.flush(w, num_words);
}

// B5 replaces fpng_tpu/ops/bitpack.py:scatter_packed16_tpu (the packed16
// "pair" mode of _make_deposit_kernel with wide records).  The TPU deposited
// 32-bit units at bit offset slot * 16 through a carried VMEM window; the
// walk's literal slots are distinct, so here each record is two plain
// 16-bit stores into the zeroed raster - (0x100 | v1) at slot and, when
// present, (0x100 | v2) at slot + 1 - with no atomics.  One thread per
// record; a warp's records are consecutive lanes of one step, so their
// loads are contiguous.  What bounds it on the H100: bytes (the value word
// read per record, the slot word only where a literal lands, 2 bytes
// written per slot counting the wrapper's zero fill).
__global__ void __launch_bounds__(kThreads)
scatter_packed16_kernel(const int* __restrict__ meta,
                        const int* __restrict__ metb, long long n,
                        int N, int n_slots, uint16_t* __restrict__ raster) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const uint32_t v = (uint32_t)metb[t];
  if (v == 0) return;
  const int slot = meta[t];
  if (slot < 0) return;
  uint16_t* r = raster + (size_t)(t / N) * n_slots;
  const uint32_t lo = v & 0xFFFF, hi = v >> 16;
  if (lo != 0 && slot < n_slots) r[slot] = (uint16_t)lo;
  if (hi != 0 && slot + 1 < n_slots) r[slot + 1] = (uint16_t)hi;
}

}  // namespace
}  // namespace fpng

// vals, offsets (B, N) int32, offsets in units of 2^shift bits -> words
// (B, num_words), zeroed by the caller.
extern "C" int fpng_deposit(const int* vals, const int* offsets, int shift,
                            int B, int N, long long num_words, int* words,
                            void* stream) {
  using namespace fpng;
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kTile - 1) / kTile, B);
  deposit_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      vals, offsets, shift, N, num_words, (uint32_t*)words);
  return (int)cudaGetLastError();
}

// meta (slots), metb (values) (B, N) -> raster (B, n_slots) int16, zeroed by
// the caller.
extern "C" int fpng_scatter_packed16(const int* meta, const int* metb, int B,
                                     int N, int n_slots, short* raster,
                                     void* stream) {
  using namespace fpng;
  if (B <= 0 || N <= 0) return 0;
  const long long n = (long long)B * N;
  scatter_packed16_kernel<<<(unsigned)((n + kThreads - 1) / kThreads),
                            kThreads, 0, (cudaStream_t)stream>>>(
      meta, metb, n, N, n_slots, (uint16_t*)raster);
  return (int)cudaGetLastError();
}
