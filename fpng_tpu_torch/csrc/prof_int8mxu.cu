// P2: the int8 / bf16 tensor-core product probe.
//
// Replaces the Pallas kernel of fpng_tpu's tools/prof_int8mxu.py (bench,
// make_kernel): out = sum over r < reps of cast(a + r) @ cast(b), a (128, K)
// and b (K, 128) int32, accumulated in int32 (int8 operands, the cast wraps
// mod 256) or in float32 and then truncated to int32 (bf16 operands, the
// cast rounds to nearest even).  The TPU ran the product T times over its
// grid, for timing; here each of T block slabs does the whole product and
// writes its own output slot (Hopper blocks run in no order, so no two
// blocks write the same word), and the wrapper returns the last slot.
//
// What bounds it on the H100: operations, 2 * 128 * K * 128 * reps * T of
// them against the dense tensor-core peak (1,979 TOP/s int8, 989 TFLOP/s
// bf16); its bytes (a and b, 4 MB at K = 4096) are ~1% of that.  The
// design: mma.sync tensor-core products written out in the kernel
// (m16n8k32 s8.s8.s32, m16n8k16 bf16.bf16.f32).  A block of 4 warps owns a
// 64 x 32 output tile; each warp a 16 x 32 slice, four n8 tiles.  Per k
// step a thread loads its A fragment as int32 once and its B fragment once,
// casts B once, and then for each rep only re-casts A: for int8 one
// byte-wise add (__vadd4) per register, since int8(a + r) is the low byte
// of (a mod 256) + r; for bf16 two int-to-float conversions and one packed
// rounding per register.  The operands are read from device memory through
// L1/L2 (both are 2 MB and shared by every block); staging them through
// shared memory with TMA, and wgmma, are left for a later change.

#include <cuda_bf16.h>

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kMxuThreads = 128;  // 4 warps
constexpr int kTileM = 64, kTileN = 32, kNT = kTileN / 8;

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

// The low bytes of four int32 values, packed low to high: int8(x) each.
__device__ __forceinline__ uint32_t pack_s8(int x0, int x1, int x2, int x3) {
  return (uint32_t)(x0 & 0xFF) | (uint32_t)(x1 & 0xFF) << 8 |
         (uint32_t)(x2 & 0xFF) << 16 | (uint32_t)(x3 & 0xFF) << 24;
}

// Two int32 values as a bf16 pair (the first in the low half): int ->
// float -> bf16, each rounding to nearest even, as int32 -> bfloat16 does
// in JAX and in PyTorch.
__device__ __forceinline__ uint32_t pack_bf16(int x0, int x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn((float)x0, (float)x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ int wrap_add(int x, int r) {
  return (int)((unsigned)x + (unsigned)r);
}

__global__ void __launch_bounds__(kMxuThreads)
int8mxu_s8_kernel(const int* __restrict__ a, const int* __restrict__ b,
                  int K, int reps, int* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * kTileM + warp * 16;
  const int n0 = blockIdx.x * kTileN;
  int acc[kNT][4] = {};
  const int* a0 = a + (size_t)(m0 + g) * K + 4 * q;  // row g
  const int* a1 = a0 + (size_t)8 * K;                // row g + 8
  for (int k0 = 0; k0 < K; k0 += 32) {
    // A fragment: rows g, g+8 x columns 4q..4q+3 and 16+4q..16+4q+3
    const int4 x0 = *reinterpret_cast<const int4*>(a0 + k0);
    const int4 x1 = *reinterpret_cast<const int4*>(a1 + k0);
    const int4 x2 = *reinterpret_cast<const int4*>(a0 + k0 + 16);
    const int4 x3 = *reinterpret_cast<const int4*>(a1 + k0 + 16);
    const uint32_t pa[4] = {pack_s8(x0.x, x0.y, x0.z, x0.w),
                            pack_s8(x1.x, x1.y, x1.z, x1.w),
                            pack_s8(x2.x, x2.y, x2.z, x2.w),
                            pack_s8(x3.x, x3.y, x3.z, x3.w)};
    // B fragment: rows 4q..4q+3 and 16+4q..16+4q+3 x column g of each n8
    uint32_t pb[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int* bc = b + (size_t)(k0 + 4 * q) * 128 + n0 + nt * 8 + g;
      pb[nt][0] = pack_s8(bc[0], bc[128], bc[256], bc[384]);
      pb[nt][1] = pack_s8(bc[16 * 128], bc[17 * 128], bc[18 * 128],
                          bc[19 * 128]);
    }
    for (int r = 0; r < reps; ++r) {
      const uint32_t add = (uint32_t)(r & 0xFF) * 0x01010101u;
      const uint32_t ar[4] = {__vadd4(pa[0], add), __vadd4(pa[1], add),
                              __vadd4(pa[2], add), __vadd4(pa[3], add)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[nt], ar, pb[nt]);
    }
  }
  int* o = out + (size_t)blockIdx.z * 128 * 128;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + nt * 8 + 2 * q;
    o[(m0 + g) * 128 + col] = acc[nt][0];
    o[(m0 + g) * 128 + col + 1] = acc[nt][1];
    o[(m0 + g + 8) * 128 + col] = acc[nt][2];
    o[(m0 + g + 8) * 128 + col + 1] = acc[nt][3];
  }
}

__global__ void __launch_bounds__(kMxuThreads)
int8mxu_bf16_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    int K, int reps, int* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * kTileM + warp * 16;
  const int n0 = blockIdx.x * kTileN;
  float acc[kNT][4] = {};
  const int* a0 = a + (size_t)(m0 + g) * K + 2 * q;
  const int* a1 = a0 + (size_t)8 * K;
  for (int k0 = 0; k0 < K; k0 += 16) {
    // A fragment: rows g, g+8 x columns 2q, 2q+1 and 8+2q, 8+2q+1
    const int2 x[4] = {*reinterpret_cast<const int2*>(a0 + k0),
                       *reinterpret_cast<const int2*>(a1 + k0),
                       *reinterpret_cast<const int2*>(a0 + k0 + 8),
                       *reinterpret_cast<const int2*>(a1 + k0 + 8)};
    uint32_t pb[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int* bc = b + (size_t)(k0 + 2 * q) * 128 + n0 + nt * 8 + g;
      pb[nt][0] = pack_bf16(bc[0], bc[128]);
      pb[nt][1] = pack_bf16(bc[8 * 128], bc[9 * 128]);
    }
    for (int r = 0; r < reps; ++r) {
      uint32_t ar[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ar[i] = pack_bf16(wrap_add(x[i].x, r), wrap_add(x[i].y, r));
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[nt], ar, pb[nt]);
    }
  }
  int* o = out + (size_t)blockIdx.z * 128 * 128;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + nt * 8 + 2 * q;
    o[(m0 + g) * 128 + col] = __float2int_rz(acc[nt][0]);
    o[(m0 + g) * 128 + col + 1] = __float2int_rz(acc[nt][1]);
    o[(m0 + g + 8) * 128 + col] = __float2int_rz(acc[nt][2]);
    o[(m0 + g + 8) * 128 + col + 1] = __float2int_rz(acc[nt][3]);
  }
}

}  // namespace
}  // namespace fpng

// a (128, K) int32, b (K, 128) int32, K a multiple of 32 -> out (T, 128,
// 128) int32, slot t holding the whole product.  bf16 != 0 selects bf16
// operands with float32 sums, else int8 operands with int32 sums.
extern "C" int fpng_int8mxu(const int* a, const int* b, int K, int reps,
                            int T, int bf16, int* out, void* stream) {
  using namespace fpng;
  if (K <= 0 || K % 32 || reps < 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(128 / kTileN, 128 / kTileM, T);
  if (bf16)
    int8mxu_bf16_kernel<<<grid, kMxuThreads, 0, (cudaStream_t)stream>>>(
        a, b, K, reps, out);
  else
    int8mxu_s8_kernel<<<grid, kMxuThreads, 0, (cudaStream_t)stream>>>(
        a, b, K, reps, out);
  return (int)cudaGetLastError();
}
