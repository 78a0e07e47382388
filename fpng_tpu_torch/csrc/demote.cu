// B7: the 32 bpp 1-pass cost check (fpng.cpp:1520-1528).
//
// Replaces fpng_tpu/ops/encfuse.py:demote_mask_tpu (Pallas kernel
// _demote_kernel).  A 1-pixel match start (cand) costs size(len_sym) +
// len_extra + 1 distance bit; when that is strictly more than the sizes of
// the pixel's four literal bytes, the encoder emits the literals instead.
//
// One thread per pixel: it reads cand, and only where cand is set its four
// delta bytes as one 32-bit word, its len_sym and its len_extra; it writes
// one byte.  A block never straddles two images, so it loads that image's
// 288 code sizes (tbl >> 16, as pack_table packs them) into shared memory
// first.  The TPU kernel's channel planes stacked along sublanes, (8, 128)
// pixel tiles and pad pixels are TPU layout and are not carried over.
//
// What bounds it on the H100: bytes (1 read and 1 written per pixel, 12
// more read per candidate); the table lookups hit shared memory.

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kDemoteThreads = 256;
constexpr int kSyms = 288;

__global__ void __launch_bounds__(kDemoteThreads)
demote_kernel(const uint32_t* __restrict__ deltas,
              const int* __restrict__ len_sym,
              const int* __restrict__ len_extra,
              const uint8_t* __restrict__ cand, const int* __restrict__ tbl,
              int HW, uint8_t* __restrict__ out) {
  __shared__ int size_s[kSyms];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < kSyms; i += kDemoteThreads)
    size_s[i] = tbl[(size_t)b * 1024 + i] >> 16;
  __syncthreads();
  const int p = blockIdx.x * kDemoteThreads + threadIdx.x;
  if (p >= HW) return;
  const size_t i = (size_t)b * HW + p;
  bool demote = false;
  if (cand[i]) {
    const uint32_t d = deltas[i];
    const int lit = size_s[d & 0xFF] + size_s[(d >> 8) & 0xFF] +
                    size_s[(d >> 16) & 0xFF] + size_s[d >> 24];
    demote = size_s[len_sym[i]] + len_extra[i] + 1 > lit;
  }
  out[i] = demote ? 1 : 0;
}

}  // namespace
}  // namespace fpng

// deltas (B, HW) 4-byte pixels, len_sym/len_extra (B, HW) int32, cand
// (B, HW) bool, tbl (B, 1024) int32 -> out (B, HW) bool.  len_sym must be a
// symbol below 288 wherever cand is set.
extern "C" int fpng_demote(const unsigned* deltas, const int* len_sym,
                           const int* len_extra, const unsigned char* cand,
                           const int* tbl, int B, int HW, unsigned char* out,
                           void* stream) {
  using namespace fpng;
  if (B <= 0 || HW <= 0) return 0;
  const dim3 grid((HW + kDemoteThreads - 1) / kDemoteThreads, B);
  demote_kernel<<<grid, kDemoteThreads, 0, (cudaStream_t)stream>>>(
      deltas, len_sym, len_extra, cand, tbl, HW, out);
  return (int)cudaGetLastError();
}
