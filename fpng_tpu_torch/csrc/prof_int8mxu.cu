// P2: the int8 / bf16 tensor-core product probe, on Hopper's warpgroup
// tensor cores (wgmma).
//
// Replaces the Pallas kernel of fpng_tpu's tools/prof_int8mxu.py (bench,
// make_kernel): out = sum over r < reps of cast(a + r) @ cast(b), a (128, K)
// and b (K, 128) int32, accumulated in int32 (int8 operands, the cast wraps
// mod 256) or in float32 and then truncated to int32 (bf16 operands, the
// cast rounds to nearest even).  The TPU ran the product T times over its
// grid, for timing; here every one of the T slots is computed in full, by
// its own blocks, into its own output slot (Hopper blocks run in no order,
// so no two blocks write the same word); the wrapper returns the last.
// Nothing is shared between slots or reps: each block runs all
// reps * K / k of its products.
//
// What bounds it on the H100: operations, 2 * 128 * K * 128 * reps * T of
// them against the dense tensor-core peak (1,979 TOP/s int8, 989 TFLOP/s
// bf16); its bytes (a and b, 4 MB at K = 4096) are ~1% of that.  Only
// wgmma.mma_async reaches that rate, so the design is built around it:
//
//   * One call, two launches.  The first (int8mxu_stage_kernel) casts b
//     once into a K-major int8 or bf16 copy laid out exactly as the
//     products read it from shared memory, and a into each thread's
//     register-fragment order (int8: the low byte of a, since
//     int8(a + r) = int8(a) + r mod 256 byte-wise; bf16: a itself, int32,
//     since bf16(a + r) must round a + r), both into scratch the wrapper
//     allocates.  K is padded to whole stages with zero operands, which add
//     exact zeros.  Its cost is inside the timed call.
//   * The second launch: one block of one warpgroup (128 threads) for each
//     64 x 128 output tile of each slot, 2 * T blocks (128 at T = 64 for
//     the 132 SMs; the 96 or 128 KB of shared memory keep one block on an
//     SM).  A stage is 4 k-steps (k32 int8, k16 bf16) of B (16 KB) and of
//     the block's A fragments (8 KB int8, 16 KB bf16); thread 0 brings each
//     stage with two 1-D bulk copies (cp.async.bulk, the TMA engine) into
//     a ring of 4 stages in shared memory, completing on an mbarrier.
//   * B is read from shared memory by the wgmma descriptor, K-major (the
//     only major order wgmma takes for 8-bit B), in the no-swizzle
//     canonical layout: 8 x 16-byte core matrices, element (n, kb) of a
//     k-step at (n / 8) * 256 + (kb / 16) * 128 + (n % 8) * 16 + kb % 16
//     bytes (leading byte offset 128 along K, stride byte offset 256 along
//     N).  A core matrix is 128 contiguous bytes, so the reads are free of
//     bank conflicts without a swizzle.
//   * A stays in registers (wgmma's register-A form, which takes .s8 and
//     .bf16): each thread loads its raw fragment of a stage from shared
//     memory once (16-byte loads, consecutive threads on consecutive
//     addresses), and each rep re-casts it: four __vadd4 a k-step for s8,
//     eight adds, eight int-to-float and four packed roundings for bf16.
//     A group is one rep over the stage's 4 k-steps (4 wgmma m64n128, one
//     64-register accumulator for the whole product); two register sets
//     alternate, and wgmma.wait_group 1 after each commit keeps one group
//     in flight while the next is cast.  An odd rep count pads the last
//     group with a zero A, which adds exact zeros.  A stage's buffer is
//     refilled once the first group of the next stage is committed (then
//     every group that read it has completed).
//
// bf16 exactness: the output is the float32 sum truncated to int32; it is
// exact wherever partial sums stay below 2^24 (int8_mxu_plain's docstring).

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace fpng {
namespace {

constexpr int kMxuThreads = 128;             // one warpgroup
constexpr int kSteps = 4;                    // k-steps a stage
constexpr int kStepB = 128 * 32;             // B bytes a k-step
constexpr int kStageB = kSteps * kStepB;     // 16 KB
constexpr int kRing = 4;                     // stages in shared memory
constexpr int kPrepThreads = 256;

// The shapes that depend on the operand type.
template <bool BF16>
struct Geom {
  static constexpr int kk = BF16 ? 16 : 32;      // k a k-step
  static constexpr int ab = BF16 ? 32 : 16;      // A bytes a thread a k-step
  static constexpr int halves = ab / 16;         // 16-byte chunks of those
  static constexpr int step_a = kMxuThreads * ab;  // A bytes a k-step
  static constexpr int stage_a = kSteps * step_a;
  static constexpr int smem = kRing * (kStageB + stage_a) + kRing * 8;
};

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

// Scratch: B as NKP k-steps of kStepB bytes, then A as [mt 2][NKP k-steps]
// [Geom::halves][128 threads][16 bytes].  Thread tid of the
// warpgroup (warp w = tid / 32, g = tid % 32 / 4, q = tid % 4) holds rows
// 16w + g (registers 0, 2) and 16w + g + 8 (registers 1, 3) of its m tile;
// s8 register i holds k 16 (i / 2) + 4q .. + 3 of its row, bf16 register i
// k 8 (i / 2) + 2q, + 1 (the m16nNk32 / m16nNk16 A fragments).
template <bool BF16>
__global__ void __launch_bounds__(kPrepThreads)
int8mxu_stage_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     int K, int NKP, uint8_t* __restrict__ scratch) {
  constexpr int kk = Geom<BF16>::kk, halves = Geom<BF16>::halves;
  const int nb = NKP * (kStepB / 16);
  const int na = 2 * NKP * halves * kMxuThreads;
  for (int ci = blockIdx.x * blockDim.x + threadIdx.x; ci < nb + na;
       ci += gridDim.x * blockDim.x) {
    uint32_t v[4];
    if (ci < nb) {
      // 16 bytes of one core-matrix row: n, k-half kh of k-step ks
      const int ks = ci / (kStepB / 16), off = (ci % (kStepB / 16)) * 16;
      const int n = (off >> 8) * 8 + ((off >> 4) & 7), kh = (off >> 7) & 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (BF16) {
          const int k = ks * kk + kh * 8 + 2 * i;
          v[i] = pack_bf16(k < K ? b[(size_t)k * 128 + n] : 0,
                           k + 1 < K ? b[(size_t)(k + 1) * 128 + n] : 0);
        } else {
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = ks * kk + kh * 16 + 4 * i + e;
            w |= (uint32_t)((k < K ? b[(size_t)k * 128 + n] : 0) & 0xFF)
                 << (8 * e);
          }
          v[i] = w;
        }
      }
    } else {
      const int c = ci - nb;
      const int tid = c % kMxuThreads, hf = c / kMxuThreads % halves;
      const int ks = c / (kMxuThreads * halves) % NKP;
      const int mt = c / (kMxuThreads * halves * NKP);
      const int lane = tid & 31, g = lane >> 2, q = lane & 3;
      const int row0 = mt * 64 + (tid >> 5) * 16 + g;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (BF16) {
          // int u of half hf: register (4 hf + u) / 2, element u % 2
          const int i = (4 * hf + u) >> 1, e = u & 1;
          const int row = row0 + 8 * (i & 1);
          const int k = ks * kk + 8 * (i >> 1) + 2 * q + e;
          v[u] = (uint32_t)(k < K ? a[(size_t)row * K + k] : 0);
        } else {
          const int row = row0 + 8 * (u & 1);
          uint32_t w = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = ks * kk + 16 * (u >> 1) + 4 * q + e;
            w |= (uint32_t)((k < K ? a[(size_t)row * K + k] : 0) & 0xFF)
                 << (8 * e);
          }
          v[u] = w;
        }
      }
    }
    *reinterpret_cast<uint4*>(scratch + (size_t)ci * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// --- wgmma (helpers in wgmma.cuh) ---------------------------------------

#define FPNG_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}, "
#define FPNG_R8(c, k)                                                    \
  c(d[k]), c(d[k + 1]), c(d[k + 2]), c(d[k + 3]), c(d[k + 4]),           \
      c(d[k + 5]), c(d[k + 6]), c(d[k + 7])
#define FPNG_R64(c)                                                      \
  FPNG_R8(c, 0), FPNG_R8(c, 8), FPNG_R8(c, 16), FPNG_R8(c, 24),          \
      FPNG_R8(c, 32), FPNG_R8(c, 40), FPNG_R8(c, 48), FPNG_R8(c, 56)
#define FPNG_RW(x) "+r"(x)
#define FPNG_FW(x) "+f"(x)

// d (64 x 128 s32) += A (64 x 32 s8, registers) * B (32 x 128 s8, smem)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t* a,
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " FPNG_D64
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : FPNG_R64(FPNG_RW)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128 bf16, smem)
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t* a,
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FPNG_D64
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : FPNG_R64(FPNG_FW)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One rep's A fragments for the stage's 4 k-steps from the raw ones; zero
// when !on (the pad group of an odd rep count).
__device__ __forceinline__ void cast_a(uint32_t (&x)[kSteps][4],
                                       const uint32_t (&raw)[kSteps][8],
                                       int r, bool on, int) {
  const uint32_t add = (uint32_t)(r & 0xFF) * 0x01010101u;
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) x[j][i] = on ? __vadd4(raw[j][i], add) : 0u;
}
__device__ __forceinline__ void cast_a(uint32_t (&x)[kSteps][4],
                                       const uint32_t (&raw)[kSteps][8],
                                       int r, bool on, float) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[j][i] = on ? pack_bf16(wrap_add((int)raw[j][2 * i], r),
                               wrap_add((int)raw[j][2 * i + 1], r))
                   : 0u;
}

__device__ __forceinline__ void mma(int (&d)[64], const uint32_t* a,
                                    uint64_t desc) {
  wgmma_s8(d, a, desc);
}
__device__ __forceinline__ void mma(float (&d)[64], const uint32_t* a,
                                    uint64_t desc) {
  wgmma_bf16(d, a, desc);
}

__device__ __forceinline__ int to_out(int v) { return v; }
__device__ __forceinline__ int to_out(float v) { return __float2int_rz(v); }

// One group: the 4 k-steps of the stage in buffer sb with A fragments x.
template <class Acc>
__device__ __forceinline__ void group(Acc (&d)[64],
                                      const uint32_t (&x)[kSteps][4],
                                      const uint8_t* sb) {
  wg::fence_regs(d);
  wg::fence();
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
    mma(d, x[j], wg::desc(sb + j * kStepB, 128, 256));
  wg::commit();
  wg::fence_regs(d);
  wg::wait<1>();
}

template <bool BF16>
__global__ void __launch_bounds__(kMxuThreads, 1)
int8mxu_wgmma_kernel(const uint8_t* __restrict__ scratch, int NKP, int reps,
                     int* __restrict__ out) {
  using Acc = typename std::conditional<BF16, float, int>::type;
  constexpr int kStepA = Geom<BF16>::step_a, kStageA = Geom<BF16>::stage_a;
  constexpr int halves = Geom<BF16>::halves;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* sb = smem;                     // kRing stages of B
  uint8_t* sa = smem + kRing * kStageB;   // kRing stages of A
  uint64_t* bar = reinterpret_cast<uint64_t*>(sa + kRing * kStageA);
  const int tid = threadIdx.x, mt = blockIdx.x;
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int row0 = mt * 64 + (tid >> 5) * 16 + g;
  int* o = out + (size_t)blockIdx.y * 128 * 128;
  Acc d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  if (reps > 0) {
    const int nst = NKP / kSteps;
    const uint8_t* gb = scratch;
    const uint8_t* ga = scratch + (size_t)NKP * kStepB +
                        (size_t)mt * NKP * kStepA;
    auto load = [&](int s) {
      uint64_t* bb = bar + s % kRing;
      wg::mbar_expect(bb, kStageB + kStageA);
      wg::bulk_load(sb + (s % kRing) * kStageB, gb + (size_t)s * kStageB,
                    kStageB, bb);
      wg::bulk_load(sa + (s % kRing) * kStageA, ga + (size_t)s * kStageA,
                    kStageA, bb);
    };
    if (tid == 0) {
      for (int i = 0; i < kRing; ++i) wg::mbar_init(bar + i, 1);
      wg::mbar_init_fence();
      for (int s = 0; s < min(kRing, nst); ++s) load(s);
    }
    __syncthreads();
    uint32_t raw[kSteps][8];
    uint32_t x0[kSteps][4], x1[kSteps][4];
    for (int s = 0; s < nst; ++s) {
      const int buf = s % kRing;
      wg::mbar_wait(bar + buf, (s / kRing) & 1);
      const uint8_t* bs = sb + buf * kStageB;
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
#pragma unroll
        for (int hf = 0; hf < halves; ++hf) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              sa + buf * kStageA + j * kStepA + hf * kMxuThreads * 16 +
              tid * 16);
          raw[j][4 * hf] = v.x;
          raw[j][4 * hf + 1] = v.y;
          raw[j][4 * hf + 2] = v.z;
          raw[j][4 * hf + 3] = v.w;
        }
      for (int r = 0; r < reps; r += 2) {
        cast_a(x0, raw, r, true, Acc());
        group(d, x0, bs);
        if (r == 0 && s > 0) {
          // every group that read stage s - 1 has completed
          __syncthreads();
          if (tid == 0 && s - 1 + kRing < nst) load(s - 1 + kRing);
        }
        cast_a(x1, raw, r + 1, r + 1 < reps, Acc());
        group(d, x1, bs);
      }
    }
    wg::wait<0>();
    wg::fence_regs(d);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * q;
    *reinterpret_cast<int2*>(o + row0 * 128 + col) =
        make_int2(to_out(d[4 * j]), to_out(d[4 * j + 1]));
    *reinterpret_cast<int2*>(o + (row0 + 8) * 128 + col) =
        make_int2(to_out(d[4 * j + 2]), to_out(d[4 * j + 3]));
  }
}

template <bool BF16>
int launch(const int* a, const int* b, int K, int reps, int T,
           uint8_t* scratch, int* out, cudaStream_t s) {
  using G = Geom<BF16>;
  const int NKP = (K / G::kk + kSteps - 1) / kSteps * kSteps;
  const int chunks = NKP * (kStepB / 16) + 2 * NKP * G::halves * kMxuThreads;
  int8mxu_stage_kernel<BF16>
      <<<(chunks + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0, s>>>(
          a, b, K, NKP, scratch);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8mxu_wgmma_kernel<BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Geom<BF16>::smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  int8mxu_wgmma_kernel<BF16>
      <<<dim3(2, T), kMxuThreads, Geom<BF16>::smem, s>>>(scratch, NKP,
                                                           reps, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fpng

// Bytes of scratch fpng_int8mxu needs for a (128, K), b (K, 128).
extern "C" long long fpng_int8mxu_scratch(int K, int bf16) {
  using namespace fpng;
  const int kk = bf16 ? Geom<true>::kk : Geom<false>::kk;
  const int ab = bf16 ? Geom<true>::ab : Geom<false>::ab;
  const long long nkp = (K / kk + kSteps - 1) / kSteps * kSteps;
  return nkp * kStepB + 2 * nkp * kMxuThreads * ab;
}

// a (128, K) int32, b (K, 128) int32, K a multiple of 32, scratch of
// fpng_int8mxu_scratch(K, bf16) bytes -> out (T, 128, 128) int32, slot t
// holding the whole product.  bf16 != 0 selects bf16 operands with float32
// sums, else int8 operands with int32 sums.
extern "C" int fpng_int8mxu(const int* a, const int* b, int K, int reps,
                            int T, int bf16, void* scratch, int* out,
                            void* stream) {
  using namespace fpng;
  if (K <= 0 || K % 32 || reps < 0 || T <= 0 || T > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  return bf16 ? launch<true>(a, b, K, reps, T, sc, out, s)
              : launch<false>(a, b, K, reps, T, sc, out, s);
}
