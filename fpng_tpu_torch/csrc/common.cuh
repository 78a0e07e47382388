// Device helpers shared by the port's kernels: block scans and reductions,
// and the monotone bit deposit of the chunked decode's record expansion
// (deposit.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fpng {

constexpr int kThreads = 256;            // threads per block
constexpr int kItems = 8;                // consecutive units per thread
constexpr int kTile = kThreads * kItems; // units per block

// Shared-memory index of tile element i, padded by one word every 32 so a
// warp reading kItems-strided elements hits 32 distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
constexpr int kTilePadded = kTile + kTile / 32;

// Inclusive prefix sum over a block of NT threads; `total` gets the block
// sum.  smem holds at least 32 ints.  Every thread of the block must call.
template <int NT>
__device__ __forceinline__ int block_incl_scan(int v, int* smem, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? smem[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    smem[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += smem[warp - 1];
  total = smem[NT / 32 - 1];
  __syncthreads();
  return v;
}

// Block-wide max; the result is valid in every thread.
template <int NT>
__device__ __forceinline__ int block_max(int v, int* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  int r = smem[0];
#pragma unroll
  for (int i = 1; i < NT / 32; ++i) r = max(r, smem[i]);
  __syncthreads();
  return r;
}

// Accumulates one thread's run of (value, bit offset) units into the word
// it is writing, and ORs each finished word into device memory.  Bit ranges
// of distinct units never overlap, so on zeroed words the ORs give exactly
// the sum the plain scatter-add computes.  Words outside [0, nw) are
// dropped.
struct BitSink {
  long long cw = -1;  // word being accumulated
  uint32_t cv = 0;    // its bits so far

  __device__ __forceinline__ void flush(uint32_t* words, long long nw) {
    if (cv != 0 && cw >= 0 && cw < nw) atomicOr(words + cw, cv);
  }

  __device__ __forceinline__ void put(uint32_t* words, long long nw,
                                      uint32_t val, long long off) {
    if (val == 0) return;
    const long long wi = off >> 5;
    const int sh = (int)(off & 31);
    const uint32_t lo = val << sh;
    const uint32_t hi = (val >> 1) >> (31 - sh);  // no shift by 32
    if (wi != cw) {
      flush(words, nw);
      cw = wi;
      cv = 0;
    }
    cv |= lo;
    if (hi != 0) {
      flush(words, nw);
      cw = wi + 1;
      cv = hi;
    }
  }
};

}  // namespace fpng
