// B7: the 32 bpp 1-pass cost check (fpng.cpp:1520-1528).
//
// Replaces fpng_tpu/ops/encfuse.py:demote_mask_tpu (Pallas kernel
// _demote_kernel).  A 1-pixel match start (cand) costs size(len_sym) +
// len_extra + 1 distance bit; when that is strictly more than the sizes of
// the pixel's four literal bytes, the encoder emits the literals instead.
//
// What bounds it on the H100: bytes (1 read and 1 written per pixel, 12
// more read per candidate); the table lookups hit shared memory.  So a
// thread takes 16 consecutive pixels of one image: it reads their cand
// bytes as one 16-byte load and writes their mask as one 16-byte store,
// and reads the four delta bytes (one 32-bit word), len_sym and len_extra
// only under a set cand byte; the next group's cand is in flight
// meanwhile.  A block walks its image in a grid-stride
// loop, so it loads the image's 288 code sizes (tbl >> 16, as pack_table
// packs them) into shared memory once.  Image b starts at byte b * HW,
// which is 16-byte aligned only when HW % 16 == 0: each image's head (up to
// its first 16-byte boundary) and tail (after its last) go a byte at a
// time, so no 16-pixel group straddles two images' tables.  The TPU
// kernel's channel planes stacked along sublanes, (8, 128) pixel tiles and
// pad pixels are TPU layout and are not carried over.

#include <algorithm>

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kDemoteThreads = 256;
constexpr int kSyms = 288;
constexpr int kGroup = 16;  // pixels a thread takes at a time

__device__ __forceinline__ bool demote_px(size_t i,
                                          const uint32_t* __restrict__ deltas,
                                          const int* __restrict__ len_sym,
                                          const int* __restrict__ len_extra,
                                          const int* size_s) {
  const uint32_t d = deltas[i];
  const int lit = size_s[d & 0xFF] + size_s[(d >> 8) & 0xFF] +
                  size_s[(d >> 16) & 0xFF] + size_s[d >> 24];
  return size_s[len_sym[i]] + len_extra[i] + 1 > lit;
}

__global__ void __launch_bounds__(kDemoteThreads)
demote_kernel(const uint32_t* __restrict__ deltas,
              const int* __restrict__ len_sym,
              const int* __restrict__ len_extra,
              const uint8_t* __restrict__ cand, const int* __restrict__ tbl,
              int HW, bool vec, uint8_t* __restrict__ out) {
  __shared__ int size_s[kSyms];
  const int b = blockIdx.y;
  const size_t p0 = (size_t)b * HW;
  // cand and out share their alignment (the entry point checks), so one
  // head serves both
  const int head =
      vec ? min(HW, (int)((16 - ((uintptr_t)(cand + p0) & 15)) & 15)) : HW;
  const int groups = (HW - head) / kGroup;
  const int rest = HW - head - kGroup * groups;
  const size_t g0 = p0 + head;
  const uint4* c4 = reinterpret_cast<const uint4*>(cand + g0);
  uint4* o4 = reinterpret_cast<uint4*>(out + g0);
  const int stride = gridDim.x * kDemoteThreads;
  int g = blockIdx.x * kDemoteThreads + threadIdx.x;
  // a thread's first cand group is in flight while the sizes load; each
  // later one while the group before it is worked
  uint4 c = g < groups ? __ldcs(c4 + g) : make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < kSyms; i += kDemoteThreads)
    size_s[i] = tbl[(size_t)b * 1024 + i] >> 16;
  __syncthreads();
  for (; g < groups; g += stride) {
    const uint4 next =
        g + stride < groups ? __ldcs(c4 + g + stride) : make_uint4(0, 0, 0, 0);
    uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t o = 0;
      if (cw[k]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const size_t q = g0 + (size_t)g * kGroup + 4 * k + r;
          if (((cw[k] >> (8 * r)) & 0xFF) &&
              demote_px(q, deltas, len_sym, len_extra, size_s))
            o |= 1u << (8 * r);
        }
      }
      cw[k] = o;
    }
    __stcs(o4 + g, make_uint4(cw[0], cw[1], cw[2], cw[3]));
    c = next;
  }
  if (blockIdx.x == 0) {  // the head and the tail, a pixel a thread
    for (int i = threadIdx.x; i < head + rest; i += kDemoteThreads) {
      const size_t q = p0 + (i < head ? i : i + kGroup * groups);
      out[q] = cand[q] && demote_px(q, deltas, len_sym, len_extra, size_s);
    }
  }
}

}  // namespace
}  // namespace fpng

// deltas (B, HW) 4-byte pixels, len_sym/len_extra (B, HW) int32, cand
// (B, HW) bool, tbl (B, 1024) int32 -> out (B, HW) bool.  len_sym must be a
// symbol below 288 wherever cand is set.  One launch; a grid of at most
// 8 blocks an image (more when the batch is small), each walking its image
// in 16-pixel groups.
extern "C" int fpng_demote(const unsigned* deltas, const int* len_sym,
                           const int* len_extra, const unsigned char* cand,
                           const int* tbl, int B, int HW, unsigned char* out,
                           void* stream) {
  using namespace fpng;
  if (B <= 0 || HW <= 0) return 0;
  const bool vec = (((uintptr_t)cand ^ (uintptr_t)out) & 15) == 0;
  const int per_block = kDemoteThreads * kGroup;
  const int want = (HW + per_block - 1) / per_block;
  const dim3 grid(std::min(want, std::max(8, 1024 / B)), B);
  demote_kernel<<<grid, kDemoteThreads, 0, (cudaStream_t)stream>>>(
      deltas, len_sym, len_extra, cand, tbl, HW, vec, out);
  return (int)cudaGetLastError();
}
