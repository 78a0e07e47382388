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
// kItems consecutive units and ORs whole words (BitSink,
// fpng_tpu_torch/csrc/common.cuh).

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
// present, (0x100 | v2) at slot + 1 - with no atomics.
//
// What bounds it on the H100: bytes - the value word of every record, the
// slot word of each record that carries a literal, 2 bytes a slot written
// (the zero fill, cudaMemsetAsync in the C entry, then the literals).  The
// records arrive step-major from the finalize, (B, S, NC): a step's NC
// lanes are contiguous, and one lane's records, S apart, fill rising,
// mostly adjacent slots.  So the kernel transposes them in shared memory:
//
//   * a block owns a tile of kP16R = 32 steps x kP16L = 64 lanes of one
//     image (the image from blockIdx.z, no division); it loads the tile's
//     value words coalesced along lanes (8 a thread, all issued before any
//     is used), then each record's slot word only where its value is not
//     zero, and a tile whose values are all zero (rows past every lane's
//     step count) stops there;
//   * then each warp takes one lane at a time, its 32 threads the lane's
//     32 steps: their slots rise, so the warp's 2-byte stores fall in a few
//     sectors instead of one sector a store.
//
// Tiles: walk8 (S <= 96) is 3 step tiles, PK=1 (S <= 536) 17; NC is cut
// into ceil(NC / 64) lane tiles (ragged edges masked).  A (B, N) call is
// one step of N lanes (S = 1).
constexpr int kP16R = 32;          // steps a tile: one warp's run
constexpr int kP16L = 64;          // lanes a tile
constexpr int kP16Threads = 256;
constexpr int kP16Per = kP16R * kP16L / kP16Threads;  // records a thread

__global__ void __launch_bounds__(kP16Threads)
scatter_packed16_kernel(const int* __restrict__ meta,
                        const int* __restrict__ metb, int S, int NC,
                        int n_slots, uint16_t* __restrict__ raster) {
  __shared__ int sv[kP16L][kP16R + 1];  // [lane][step], padded
  __shared__ int ss[kP16L][kP16R + 1];
  const int l0 = blockIdx.x * kP16L, s0 = blockIdx.y * kP16R;
  const int b = blockIdx.z, tid = threadIdx.x;
  const size_t img = (size_t)b * S * NC;
  const int l = tid % kP16L;
  int v[kP16Per];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kP16Per; ++i) {
    const int s = tid / kP16L + i * (kP16Threads / kP16L);
    v[i] = 0;
    if (l0 + l < NC && s0 + s < S)
      v[i] = metb[img + (size_t)(s0 + s) * NC + l0 + l];
    any |= v[i] != 0;
  }
  if (!__syncthreads_or(any)) return;
#pragma unroll
  for (int i = 0; i < kP16Per; ++i) {
    const int s = tid / kP16L + i * (kP16Threads / kP16L);
    sv[l][s] = v[i];
    ss[l][s] = v[i] != 0 ? meta[img + (size_t)(s0 + s) * NC + l0 + l] : 0;
  }
  __syncthreads();
  uint16_t* r = raster + (size_t)b * n_slots;
  const int lane = tid & 31;
  for (int ln = tid >> 5; ln < kP16L; ln += kP16Threads / 32) {
    const uint32_t x = (uint32_t)sv[ln][lane];
    const int slot = ss[ln][lane];
    if (x == 0 || slot < 0) continue;
    const uint32_t lo = x & 0xFFFF, hi = x >> 16;
    if (lo != 0 && slot < n_slots) r[slot] = (uint16_t)lo;
    if (hi != 0 && slot < n_slots - 1) r[slot + 1] = (uint16_t)hi;
  }
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

// meta (slots), metb (values) (B, S, NC) int32, step-major (a (B, N) call
// passes S = 1) -> raster (B, n_slots) int16, zero-filled here first.
extern "C" int fpng_scatter_packed16(const int* meta, const int* metb, int B,
                                     int S, int NC, int n_slots,
                                     short* raster, void* stream) {
  using namespace fpng;
  if (B < 0 || B > 65535 || S < 0 || NC < 0 || n_slots < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (B == 0 || n_slots == 0) return 0;
  cudaError_t e = cudaMemsetAsync(raster, 0, (size_t)B * n_slots * 2, st);
  if (e != cudaSuccess || S == 0 || NC == 0) return (int)e;
  const dim3 grid((NC + kP16L - 1) / kP16L, (S + kP16R - 1) / kP16R, B);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  scatter_packed16_kernel<<<grid, kP16Threads, 0, st>>>(
      meta, metb, S, NC, n_slots, (uint16_t*)raster);
  return (int)cudaGetLastError();
}
