// P1: the deposit-parts probe (one-hot build vs tensor-core product).
//
// Replaces the Pallas kernel of fpng_tpu's tools/prof_depparts.py (the
// jitted pallas_call over make_kernel), which priced the parts of the TPU
// decode deposit: per walk k < WPS of every grid step (b, t), the slot
// column c_u[g] = ((cu[b, t, 32k + g/128, g%128] << 4) >> 5) & 127 (or
// none, where that word is negative) of 4096 units g, the 4096 x 128
// one-hot ohc[g][j] = (c_u[g] == j), and the product big[b, k] @ ohc.  Only
// rows 0..7 of the product reach the output, and only step t = T-1's
// result survives (the TPU's output block is the same for every t):
//
//   src   prod     probe modes          out[b, i, j] (i < 8)
//   cu    int8     full, fulli8cmp      sum_k sum_g big[b,k,i,g] [c_u[g]==j]
//   cu    bf16     fullbf16             the same through bf16, f32 sums
//   cu    none     ohc                  sum_k [c_u[i] == j]
//   ohc0  int8     dot                  sum_k (big[b,k,:8] @ ohc0[b])[i, j]
//   ohc0  bf16     dotbf16              the same through bf16, f32 sums
//   ohc0  none     none                 WPS * ohc0[b, i, j]
//
// Rows 8..M-1 of big are the TPU's matrix-unit tile and are never read.
//
// What bounds it on the H100: bytes at the probe's size (B = 32, T = 18,
// WPS = 4): cu (37.7 MB) and big[..., :8, :] (4.2 MB) for full, 12.5 us,
// against 19.3 G int8 operations, 9.8 us.  The design prices the route the
// probe exists for: one block per step (b, t), which runs every walk, as
// the probe does.  The block builds the one-hot in shared memory, 128 units
// at a time (a 128 x 128 chunk, stored column-major so that a thread's B
// fragment is one 32-bit load, with rows padded to keep the eight columns a
// warp reads in distinct banks): zero it, then one byte per unit.  Then the
// eight warps run mma.sync (m16n8k32 s8, or m16n8k16 bf16) with big's rows
// 0..7 as A (rows 8..15 of the fragment zero), two n8 tiles each.  For the
// ohc0 modes the chunk comes from ohc0 instead, loaded once per chunk and
// used for every walk.  Each step writes its own output slot, (B, T, 8,
// 128); the wrapper returns slot T-1, so no two blocks write one word.

#include <cuda_bf16.h>

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kGroup = 4096;   // units per walk
constexpr int kGC = 128;       // units per shared-memory chunk
constexpr int kDepThreads = 256;
enum { kSrcCu = 0, kSrcOhc0 = 1 };
enum { kProdNone = 0, kProdS8 = 1, kProdBf16 = 2 };

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint16_t bf16_bits(int x) {  // exact for int8
  __nv_bfloat16 v = __float2bfloat16_rn((float)x);
  return *reinterpret_cast<uint16_t*>(&v);
}

template <int SRC, int PROD>
__global__ void __launch_bounds__(kDepThreads)
depparts_kernel(const int* __restrict__ cu, const int8_t* __restrict__ big,
                const int8_t* __restrict__ ohc0, int T, int WPS, int M,
                int* __restrict__ out) {
  // chunk column n holds units 0..kGC-1 of the chunk, then padding
  constexpr int kEl = PROD == kProdBf16 ? 2 : 1;
  constexpr int kStride = (kGC + 16 / kEl) * kEl;  // bytes: 144 or 272
  __shared__ __align__(16) uint8_t tile[128 * kStride];
  const int t = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  int* o = out + ((size_t)b * T + t) * 8 * 128;

  if (SRC == kSrcOhc0 && PROD == kProdNone) {  // out = WPS * ohc0[b, :8]
    const int8_t* s = ohc0 + (size_t)b * kGroup * 128 + tid * 4;
    int r[4] = {};
    for (int k = 0; k < WPS; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) r[e] += s[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[tid * 4 + e] = r[e];
    return;
  }

  int acc[2][4] = {};     // int8 products: two n8 tiles of 16 x 8
  float accf[2][4] = {};  // bf16 products
  int res[4] = {};        // ohc: out[tid / 32][4 * (tid % 32) + e]
  for (int c = 0; c < kGroup / kGC; ++c) {
    for (int k = 0; k < WPS; ++k) {
      if (SRC == kSrcCu || k == 0) {
        int m = 0;
        if (SRC == kSrcCu && tid < kGC)  // issued before the zeroing
          m = cu[(((size_t)b * T + t) * WPS * 32 + 32 * k + c) * 128 + tid];
        __syncthreads();  // every warp is done with the last chunk
        if (SRC == kSrcCu) {
          int4* z = reinterpret_cast<int4*>(tile);
          for (int i = tid; i < 128 * kStride / 16; i += kDepThreads)
            z[i] = make_int4(0, 0, 0, 0);
          __syncthreads();
          const int word = (int)((unsigned)m << 4) >> 5;
          if (tid < kGC && word >= 0) {
            uint8_t* col = tile + (word & 127) * kStride;
            if (PROD == kProdBf16)
              reinterpret_cast<uint16_t*>(col)[tid] = 0x3F80;  // 1.0
            else
              col[tid] = 1;
          }
        } else {  // chunk c of ohc0[b], transposed: 32 bits per thread
          constexpr int kPer = 4 / kEl;  // units per 32-bit word
          const int8_t* s = ohc0 + ((size_t)b * kGroup + c * kGC) * 128;
          for (int i = tid; i < kGC / kPer * 128; i += kDepThreads) {
            const int n = i & 127, u = (i >> 7) * kPer;
            uint32_t w;
            if (PROD == kProdBf16)
              w = bf16_bits(s[u * 128 + n]) |
                  (uint32_t)bf16_bits(s[(u + 1) * 128 + n]) << 16;
            else
              w = (uint32_t)(uint8_t)s[u * 128 + n] |
                  (uint32_t)(uint8_t)s[(u + 1) * 128 + n] << 8 |
                  (uint32_t)(uint8_t)s[(u + 2) * 128 + n] << 16 |
                  (uint32_t)(uint8_t)s[(u + 3) * 128 + n] << 24;
            *reinterpret_cast<uint32_t*>(tile + n * kStride + u * kEl) = w;
          }
        }
        __syncthreads();
      }
      if (PROD == kProdNone) {  // ohc: rows 0..7 of the one-hot
        if (c == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            res[e] += tile[(4 * (tid & 31) + e) * kStride + (tid >> 5)];
        }
        continue;
      }
      const int8_t* row = big + (((size_t)b * WPS + k) * M + g) * kGroup +
                          c * kGC;  // A row g (rows 8..15 are zero)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint8_t* col = tile + (warp * 16 + nt * 8 + g) * kStride;
        if (PROD == kProdS8) {
#pragma unroll
          for (int ks = 0; ks < kGC; ks += 32) {
            const uint32_t a[4] = {
                *reinterpret_cast<const uint32_t*>(row + ks + 4 * q), 0,
                *reinterpret_cast<const uint32_t*>(row + ks + 16 + 4 * q), 0};
            const uint32_t bb[2] = {
                *reinterpret_cast<const uint32_t*>(col + ks + 4 * q),
                *reinterpret_cast<const uint32_t*>(col + ks + 16 + 4 * q)};
            mma_s8(acc[nt], a, bb);
          }
        } else {
#pragma unroll
          for (int ks = 0; ks < kGC; ks += 16) {
            const int8_t* r0 = row + ks + 2 * q;
            const uint32_t a[4] = {
                bf16_bits(r0[0]) | (uint32_t)bf16_bits(r0[1]) << 16, 0,
                bf16_bits(r0[8]) | (uint32_t)bf16_bits(r0[9]) << 16, 0};
            const uint32_t bb[2] = {
                *reinterpret_cast<const uint32_t*>(col + (ks + 2 * q) * 2),
                *reinterpret_cast<const uint32_t*>(col + (ks + 8 + 2 * q) *
                                                   2)};
            mma_bf16(accf[nt], a, bb);
          }
        }
      }
    }
  }
  if (PROD == kProdNone) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[tid * 4 + e] = res[e];
    return;
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {  // rows 0..7 only: c[0], c[1]
    const int col = warp * 16 + nt * 8 + 2 * q;
    if (PROD == kProdS8) {
      o[g * 128 + col] = acc[nt][0];
      o[g * 128 + col + 1] = acc[nt][1];
    } else {
      o[g * 128 + col] = __float2int_rz(accf[nt][0]);
      o[g * 128 + col + 1] = __float2int_rz(accf[nt][1]);
    }
  }
}

template <int SRC, int PROD>
void launch(const int* cu, const int8_t* big, const int8_t* ohc0, int B,
            int T, int WPS, int M, int* out, cudaStream_t stream) {
  depparts_kernel<SRC, PROD><<<dim3(T, B), kDepThreads, 0, stream>>>(
      cu, big, ohc0, T, WPS, M, out);
}

}  // namespace
}  // namespace fpng

// cu (B, T, WPS*32, 128) int32, big (B, WPS, M, 4096) int8 with M >= 8,
// ohc0 (B, 4096, 128) int8 -> out (B, T, 8, 128) int32, slot t holding step
// t's result.  src: 0 = the one-hot of cu, 1 = ohc0; prod: 0 = none,
// 1 = int8 products, 2 = bf16 products (table in the header).
extern "C" int fpng_depparts(const int* cu, const signed char* big,
                             const signed char* ohc0, int B, int T, int WPS,
                             int M, int src, int prod, int* out,
                             void* stream) {
  using namespace fpng;
  if (B <= 0 || T <= 0 || WPS <= 0 || M < 8) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* bg = reinterpret_cast<const int8_t*>(big);
  const int8_t* oh = reinterpret_cast<const int8_t*>(ohc0);
  switch (src * 3 + prod) {
    case 0: launch<kSrcCu, kProdNone>(cu, bg, oh, B, T, WPS, M, out, s); break;
    case 1: launch<kSrcCu, kProdS8>(cu, bg, oh, B, T, WPS, M, out, s); break;
    case 2: launch<kSrcCu, kProdBf16>(cu, bg, oh, B, T, WPS, M, out, s); break;
    case 3: launch<kSrcOhc0, kProdNone>(cu, bg, oh, B, T, WPS, M, out, s); break;
    case 4: launch<kSrcOhc0, kProdS8>(cu, bg, oh, B, T, WPS, M, out, s); break;
    case 5: launch<kSrcOhc0, kProdBf16>(cu, bg, oh, B, T, WPS, M, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
