// P1: the deposit-parts probe (one-hot build vs tensor-core product), on
// Hopper's warpgroup tensor cores (wgmma).
//
// Replaces the Pallas kernel of fpng_tpu's tools/prof_depparts.py (the
// jitted pallas_call over make_kernel), which priced the parts of the TPU
// decode deposit: per walk k < WPS of every grid step (b, t), the slot
// column c_u[g] = ((cu[b, t, 32k + g/128, g%128] << 4) >> 5) & 127 (or
// none, where that word is negative) of 4096 units g, the 4096 x 128
// one-hot ohc[g][j] = (c_u[g] == j), and the product big[b, k] @ ohc.  Only
// rows 0..7 of the product reach the output:
//
//   src   prod     probe modes          out[b, t, i, j] (i < 8)
//   cu    int8     full, fulli8cmp      sum_k sum_g big[b,k,i,g] [c_u[g]==j]
//   cu    bf16     fullbf16             the same through bf16, f32 sums
//   cu    none     ohc                  sum_k [c_u[i] == j]
//   ohc0  int8     dot                  sum_k (big[b,k,:8] @ ohc0[b])[i, j]
//   ohc0  bf16     dotbf16              the same through bf16, f32 sums
//   ohc0  none     none                 WPS * ohc0[b, i, j]
//
// Rows 8..M-1 of big are the TPU's matrix-unit tile and are never read.
// Every step (b, t) writes its own output slot, (B, T, 8, 128); the
// wrapper returns slot T-1.  Every step runs all WPS of its products, also
// where (the ohc0 modes) they do not depend on t: nothing is computed once
// and copied.
//
// What bounds it on the H100 at the probe's size (B = 32, T = 18, WPS = 4):
// 19.3 G multiply-add operations, 9.8 us at the int8 tensor-core peak and
// 19.5 us at the bf16 one, against 12.6 us of bytes for the cu modes (cu
// 37.7 MB, big's rows 4.2 MB).  The products are turned around so that
// the one-hot fills wgmma's 64-row M side:
//
//   out^T (128 x 8) = one-hot^T (128 x K) . big[b, k, :8]^T (K x 8)
//
// and both operands are K-major as they stand: a one-hot column's units
// are contiguous (the one-hot is built that way), and big's rows are K-
// contiguous.  One k-step is 32 bytes of K: k32 for int8, k16 for bf16.
//
//   * One call, up to three launches.  depparts_stage_b_kernel writes
//     big[b, k, :8] for every walk, as int8 or cast to bf16, K-major in the
//     no-swizzle canonical layout for N = 32: walks side by side in groups
//     of four (n = 8 (k % 4) + i, rows of walks >= WPS zero), element
//     (n, kb) of k-step ks of walk group wg at ((b * NKS + ks) * NG + wg) *
//     1024 + (n / 8) * 256 + (kb / 16) * 128 + (n % 8) * 16 + kb % 16
//     (leading byte offset 128 along K, stride byte offset 256 along N).
//     For the ohc0 modes depparts_stage_a_kernel casts and transposes ohc0
//     once into the one-hot^T's register fragments (wgmma's A in
//     registers; an 8-bit A must be K-major), through a shared-memory
//     tile of 64 units x 128 columns.  Both go into scratch the wrapper
//     allocates; their cost is inside the timed call.  There is no cast in
//     the product loops.
//   * ohc0 modes (dot, dotbf16): the one-hot is the same for every walk,
//     so the four walks of a group go side by side in N: m64n32 products,
//     A in registers, summed over the walk groups, the walks folded in the
//     epilogue (the four n8 blocks of a thread's accumulator are the four
//     walks' rows i = 2q, 2q + 1).  A block is one warpgroup on one 64-row
//     half of one image's output columns for kTG = 9 steps t: it streams
//     stages of 4 k-steps (its A fragments, 8 KB, and B, 4 KB a walk
//     group) through a ring of 4 in shared memory by cp.async.bulk on
//     mbarriers, and issues each k-step's product once for each of its
//     steps into that step's accumulator: the staged tile is reused across
//     steps, as the TPU's sequential t grid reused its VMEM block.  At T =
//     18 that is 2 x 2 x 32 = 128 blocks, fewer than the 132 SMs, so each
//     has an SM to itself and the SMs share the products evenly (9 x 16
//     accumulator registers a thread, ~200 registers); each block reads
//     its half of the image's A (256 KB int8, 512 KB bf16) once, where a
//     block a step would read it 18 times.
//   * cu modes (full, fulli8cmp, fullbf16): each walk has its own one-hot,
//     so the walks go along K (K = WPS x 4096), N = 8.  A block is one step
//     (b, t), two warpgroups, one 64-row half each; 576 blocks at the
//     probe's size, up to three an SM (68 KB of shared memory each).  The
//     one-hot is built straight into wgmma's shared-memory layout, 8 k-steps
//     (256 int8 or 128 bf16 units) a chunk, in two buffers: both are zeroed
//     once, then each unit's thread sets its byte (1, or bf16 1.0) at
//     (c_u, unit) before the chunk's product and clears it once the product
//     has read it, two stores a unit instead of 128 zero bytes.  The
//     chunk's B (8 rows, 2 KB) comes from the staged scratch.  Both m64n8
//     products of a chunk read A and B from shared memory by descriptor;
//     the next chunk is built while they run (wgmma.wait_group 1).
//   * ohc and none do no product; they keep the CUDA-core kernel of the
//     first port (depparts_noprod_kernel): ohc builds every chunk's one-hot
//     in shared memory and reads rows 0..7 of its first chunk.
//
// bf16 exactness: each sum is at most 4 x 4096 x 128 < 2^24 in magnitude
// (ohc0 in {0, 1}, as the probe's operands), so the float32 sums are exact
// in any order and the result is bit-identical to the plain version.

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace fpng {
namespace {

constexpr int kGroup = 4096;         // units per walk
constexpr int kKB = 32;              // bytes of K a k-step
constexpr int kStepB = 32 * kKB;     // staged B a k-step and walk group
constexpr int kFragA = 128 * 16;     // A fragments a k-step and 64-row half
constexpr int kTG = 9;               // steps t a block (ohc0 modes)
constexpr int kSteps = 4;            // k-steps a stage (ohc0 modes)
constexpr int kRing = 4;             // stages in shared memory
constexpr int kChunkSteps = 8;       // k-steps a one-hot chunk (cu modes)
constexpr int kTileA = kChunkSteps * 128 * kKB;  // 32 KB a one-hot chunk
constexpr int kTileB = kChunkSteps * 8 * kKB;    // 2 KB of B a chunk
constexpr int kMaxNG = 8;            // walk groups: WPS <= 32
constexpr int kStageThreads = 256;
constexpr int kDepThreads = 256;
enum { kSrcCu = 0, kSrcOhc0 = 1 };
enum { kProdNone = 0, kProdS8 = 1, kProdBf16 = 2 };

template <bool BF16>
struct Op {
  using Acc = typename std::conditional<BF16, float, int>::type;
  static constexpr int el = BF16 ? 2 : 1;  // bytes an element
  static constexpr int kk = kKB / el;      // units a k-step
  static constexpr int nks = kGroup / kk;  // k-steps a walk
};

__device__ __forceinline__ uint16_t bf16_bits(int x) {  // exact for int8
  __nv_bfloat16 v = __float2bfloat16_rn((float)x);
  return *reinterpret_cast<uint16_t*>(&v);
}

// The probe's slot column of a cu word, or -1.
__device__ __forceinline__ int slot_column(int m) {
  const int word = (int)((unsigned)m << 4) >> 5;
  return word >= 0 ? (word & 127) : -1;
}

// --- staging ----------------------------------------------------------------

// B scratch: big[b, k, :8] K-major for N = 32 (the header's layout), one
// 16-byte piece (one row n, one half kh of a k-step) a thread.
template <bool BF16>
__global__ void __launch_bounds__(kStageThreads)
depparts_stage_b_kernel(const int8_t* __restrict__ big, int B, int WPS, int M,
                        int NG, uint8_t* __restrict__ sb) {
  using O = Op<BF16>;
  const long long n_pieces = (long long)B * O::nks * NG * (kStepB / 16);
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_pieces; p += (long long)gridDim.x * blockDim.x) {
    const int r = p % 8, kh = p / 8 % 2, n8 = p / 16 % 4;
    const long long rest = p / 64;  // (b * NKS + ks) * NG + wg
    const int wg = rest % NG;
    const int ks = rest / NG % O::nks;
    const int b = rest / NG / O::nks;
    const int walk = 4 * wg + n8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (walk < WPS) {
      const int g0 = ks * O::kk + kh * 16 / O::el;
      const int8_t* src = big + (((size_t)b * WPS + walk) * M + r) * kGroup +
                          g0;
      if (BF16) {
        const uint2 u = *reinterpret_cast<const uint2*>(src);
        const int8_t* s8 = reinterpret_cast<const int8_t*>(&u);
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = bf16_bits(s8[2 * e]) |
                 (uint32_t)bf16_bits(s8[2 * e + 1]) << 16;
        v = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        v = *reinterpret_cast<const uint4*>(src);
      }
    }
    *reinterpret_cast<uint4*>(sb + (size_t)p * 16) = v;
  }
}

// A scratch (ohc0 modes): the one-hot^T A[j][g] = ohc0[b, g, j] in the
// register fragments of wgmma's A, [b][half mt][k-step][thread][16 bytes].
// Thread tid (warp w, g = tid % 32 / 4, q = tid % 4) of a warpgroup holds
// rows 64 mt + 16 w + g (registers 0, 2) and + 8 (registers 1, 3); s8
// register i holds k 16 (i / 2) + 4q .. + 3 of the k-step, bf16 register
// i k 8 (i / 2) + 2q, + 1.  A block takes 64 units of one image through a
// shared-memory tile [unit][column] (rows padded to 132 bytes).
template <bool BF16>
__global__ void __launch_bounds__(kStageThreads)
depparts_stage_a_kernel(const int8_t* __restrict__ ohc0,
                        uint8_t* __restrict__ sa) {
  using O = Op<BF16>;
  constexpr int kU = 64, kRow = 132;
  __shared__ __align__(16) uint8_t tile[kU * kRow];
  const int u0 = blockIdx.x * kU, b = blockIdx.y, tid = threadIdx.x;
  const int8_t* src = ohc0 + ((size_t)b * kGroup + u0) * 128;
  for (int i = tid; i < kU * 128 / 4; i += kStageThreads) {
    const int u = i / 32, c = i % 32;
    *reinterpret_cast<uint32_t*>(tile + u * kRow + 4 * c) =
        *reinterpret_cast<const uint32_t*>(src + u * 128 + 4 * c);
  }
  __syncthreads();
  constexpr int kStepsHere = kU / O::kk;  // k-steps in the tile
  for (int f = tid; f < kStepsHere * 2 * 128; f += kStageThreads) {
    const int ft = f % 128, mt = f / 128 % 2, ksl = f / 256;
    const int lane = ft & 31, g = lane >> 2, q = lane & 3;
    const int row0 = mt * 64 + (ft >> 5) * 16 + g;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = row0 + 8 * (i & 1);
      uint32_t w = 0;
      if (BF16) {
        const int k = ksl * O::kk + 8 * (i >> 1) + 2 * q;
        w = bf16_bits((int8_t)tile[k * kRow + j]) |
            (uint32_t)bf16_bits((int8_t)tile[(k + 1) * kRow + j]) << 16;
      } else {
        const int k = ksl * O::kk + 16 * (i >> 1) + 4 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w |= (uint32_t)tile[(k + e) * kRow + j] << (8 * e);
      }
      v[i] = w;
    }
    const int ks = u0 / O::kk + ksl;
    *reinterpret_cast<uint4*>(
        sa + (((size_t)b * 2 + mt) * O::nks + ks) * kFragA + ft * 16) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// --- the products -------------------------------------------------------------

#define FPNG_D16                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}, "
#define FPNG_R16(c)                                                      \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), \
      c(d[15])
#define FPNG_RW(x) "+r"(x)
#define FPNG_FW(x) "+f"(x)

// d (64 x 32) += A (64 x 32 bytes of K, registers) * B (K x 32, smem)
__device__ __forceinline__ void mma_n32(int (&d)[16], const uint32_t* a,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 " FPNG_D16
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : FPNG_R16(FPNG_RW)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t* a,
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " FPNG_D16
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : FPNG_R16(FPNG_FW)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 8) += A (64 x 32 bytes of K, smem) * B (K x 8, smem)
__device__ __forceinline__ void mma_n8(int (&d)[4], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_n8(float (&d)[4], uint64_t da,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ int to_int(int v) { return v; }
__device__ __forceinline__ int to_int(float v) { return __float2int_rz(v); }

// ohc0 modes: the A fragments of stage s, once its buffer has arrived.
__device__ __forceinline__ void ohc0_frags(uint32_t (&x)[kSteps * 4],
                                           const uint8_t* buf, uint64_t* bar,
                                           int s, int tid) {
  wg::mbar_wait(bar, (s / kRing) & 1);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf + j * kFragA +
                                                    tid * 16);
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }
}

// One group: the stage's products (B at bs) for every step of the block.
template <class Acc>
__device__ __forceinline__ void ohc0_group(Acc (&d)[kTG][16],
                                           const uint32_t (&x)[kSteps * 4],
                                           const uint8_t* bs, int NG) {
#pragma unroll
  for (int tt = 0; tt < kTG; ++tt) wg::fence_regs(d[tt]);
  wg::fence();
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
    for (int w = 0; w < NG; ++w) {
      const uint64_t db = wg::desc(bs + (j * NG + w) * kStepB, 128, 256);
#pragma unroll
      for (int tt = 0; tt < kTG; ++tt) mma_n32(d[tt], &x[4 * j], db);
    }
  wg::commit();
#pragma unroll
  for (int tt = 0; tt < kTG; ++tt) wg::fence_regs(d[tt]);
}

// ohc0 modes: grid (ceil(T / kTG), 2 halves, B), one warpgroup.  Every
// block issues kTG steps' products (a last block of a T that kTG does not
// divide computes the spare ones and stores nothing of them).
template <bool BF16>
__global__ void __launch_bounds__(128, 1)
depparts_ohc0_kernel(const uint8_t* __restrict__ sb_g,
                     const uint8_t* __restrict__ sa_g, int T, int NG,
                     int* __restrict__ out) {
  using O = Op<BF16>;
  using Acc = typename O::Acc;
  constexpr int nst = O::nks / kSteps;  // stages: 32 int8, 64 bf16 (even)
  constexpr int kStageA = kSteps * kFragA;
  extern __shared__ __align__(128) uint8_t smem[];
  const int stage_b = kSteps * NG * kStepB;
  const int stage = kStageA + stage_b;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kRing * stage);
  const int tid = threadIdx.x, mt = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * kTG;
  const uint8_t* ga = sa_g + ((size_t)b * 2 + mt) * O::nks * kFragA;
  const uint8_t* gb = sb_g + (size_t)b * O::nks * NG * kStepB;
  auto load = [&](int s) {  // thread 0: stage s into its ring buffer
    uint8_t* dst = smem + (s % kRing) * stage;
    uint64_t* bb = bar + s % kRing;
    wg::mbar_expect(bb, stage);
    wg::bulk_load(dst, ga + (size_t)s * kStageA, kStageA, bb);
    wg::bulk_load(dst + kStageA, gb + (size_t)s * stage_b, stage_b, bb);
  };

  Acc d[kTG][16];
#pragma unroll
  for (int tt = 0; tt < kTG; ++tt)
#pragma unroll
    for (int i = 0; i < 16; ++i) d[tt][i] = 0;
  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) wg::mbar_init(bar + i, 1);
    wg::mbar_init_fence();
    for (int s = 0; s < min(kRing, nst); ++s) load(s);
  }
  __syncthreads();
  uint32_t x0[kSteps * 4], x1[kSteps * 4] = {};
  ohc0_frags(x0, smem, bar, 0, tid);
  for (int s = 0; s < nst; s += 2) {
    // After group s is committed, wait until group s - 1 has completed:
    // then its A registers and its stage buffer are free.
    ohc0_group(d, x0, smem + (s % kRing) * stage + kStageA, NG);
    wg::wait<1>();
    wg::fence_regs(x1);
    __syncthreads();
    if (s > 0 && tid == 0 && s - 1 + kRing < nst) load(s - 1 + kRing);
    ohc0_frags(x1, smem + ((s + 1) % kRing) * stage, bar + (s + 1) % kRing,
               s + 1, tid);
    ohc0_group(d, x1, smem + ((s + 1) % kRing) * stage + kStageA, NG);
    wg::wait<1>();
    wg::fence_regs(x0);
    __syncthreads();
    if (tid == 0 && s + kRing < nst) load(s + kRing);
    if (s + 2 < nst)
      ohc0_frags(x0, smem + ((s + 2) % kRing) * stage,
                 bar + (s + 2) % kRing, s + 2, tid);
  }
  wg::wait<0>();
#pragma unroll
  for (int tt = 0; tt < kTG; ++tt) wg::fence_regs(d[tt]);

  // d[4 w4 + e]: row 16 warp + g (+ 8 for e >= 2) of the half, column
  // 8 w4 + 2q + (e & 1), i.e. walk w4 of the group, big's row 2q + (e & 1)
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int j0 = mt * 64 + (tid >> 5) * 16 + g;
#pragma unroll
  for (int tt = 0; tt < kTG; ++tt) {
    if (t0 + tt >= T) break;
    int* o = out + ((size_t)b * T + t0 + tt) * 8 * 128;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Acc v = d[tt][e] + d[tt][4 + e] + d[tt][8 + e] + d[tt][12 + e];
      o[(2 * q + (e & 1)) * 128 + j0 + 8 * (e >> 1)] = to_int(v);
    }
  }
}

// The byte offset of one-hot element (column j, unit u of the chunk) in a
// chunk tile: k-steps of 4 KB, 64-row halves of 2 KB, 8-row core-matrix
// groups 256 bytes apart (stride byte offset), 16-byte halves of a k-step
// 128 apart (leading byte offset).
template <bool BF16>
__device__ __forceinline__ int onehot_at(int j, int u) {
  const int kb = u * Op<BF16>::el;
  return (kb >> 5) * 4096 + (j >> 6) * 2048 + ((j >> 3) & 7) * 256 +
         ((kb >> 4) & 1) * 128 + (j & 7) * 16 + (kb & 15);
}

// cu modes: grid (T, B), two warpgroups.
template <bool BF16>
__global__ void __launch_bounds__(kDepThreads)
depparts_cu_kernel(const int* __restrict__ cu, const uint8_t* __restrict__ sb_g,
                   int T, int WPS, int NG, int* __restrict__ out) {
  using O = Op<BF16>;
  using Acc = typename O::Acc;
  constexpr int kc = kChunkSteps * O::kk;  // units a chunk: 256 or 128
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* tile = smem;                    // 2 one-hot chunks
  uint8_t* bsm = smem + 2 * kTileA;        // 2 chunks of B
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int half = tid >> 7;
  const int* cub = cu + ((size_t)b * T + t) * WPS * kGroup;
  const int nch = WPS * (kGroup / kc);

  for (int i = tid; i < 2 * kTileA / 16; i += kDepThreads)
    reinterpret_cast<uint4*>(tile)[i] = make_uint4(0, 0, 0, 0);
  int m = tid < kc ? cub[tid] : 0;
  int old0 = -1, old1 = -1;  // this unit's set byte in each buffer
  Acc d[4] = {0, 0, 0, 0};
  __syncthreads();

  for (int c = 0; c < nch; ++c) {
    const int p = c & 1;
    uint8_t* tp = tile + p * kTileA;
    uint8_t* bp = bsm + p * kTileB;
    if (tid < kc) {  // buffer p was last read by chunk c - 2's products
      const int col = slot_column(m);
      const int at = col >= 0 ? onehot_at<BF16>(col, tid) : -1;
      const int prev = p ? old1 : old0;
      if (BF16) {
        if (prev >= 0) *reinterpret_cast<uint16_t*>(tp + prev) = 0;
        if (at >= 0) *reinterpret_cast<uint16_t*>(tp + at) = 0x3F80;  // 1.0
      } else {
        if (prev >= 0) tp[prev] = 0;
        if (at >= 0) tp[at] = 1;
      }
      if (p)
        old1 = at;
      else
        old0 = at;
    }
    if (tid < kTileB / 16) {  // B: walk k's 8 rows, this chunk's k-steps
      const int k = c / (kGroup / kc);
      const int ks = (c % (kGroup / kc)) * kChunkSteps + tid / 16;
      reinterpret_cast<uint4*>(bp)[tid] = *reinterpret_cast<const uint4*>(
          sb_g + (((size_t)b * O::nks + ks) * NG + k / 4) * kStepB +
          (k % 4) * 256 + (tid % 16) * 16);
    }
    wg::fence_proxy_async();
    __syncthreads();
    if (c + 1 < nch && tid < kc) m = cub[(c + 1) * kc + tid];
    wg::fence_regs(d);
    wg::fence();
#pragma unroll
    for (int ks = 0; ks < kChunkSteps; ++ks)
      mma_n8(d, wg::desc(tp + ks * 4096 + half * 2048, 128, 256),
             wg::desc(bp + ks * 256, 128, 256));
    wg::commit();
    wg::fence_regs(d);
    wg::wait<1>();
    __syncthreads();  // chunk c - 1's products are done in both halves
  }
  wg::wait<0>();
  wg::fence_regs(d);
  // d[e]: output column j = 64 half + 16 warp + g (+ 8 for e >= 2), big's
  // row i = 2q + (e & 1)
  const int lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int j0 = half * 64 + ((tid >> 5) & 3) * 16 + g;
  int* o = out + ((size_t)b * T + t) * 8 * 128;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[(2 * q + (e & 1)) * 128 + j0 + 8 * (e >> 1)] = to_int(d[e]);
}

// ohc and none: the first port's CUDA-core kernel, one block a step.
template <int SRC>
__global__ void __launch_bounds__(kDepThreads)
depparts_noprod_kernel(const int* __restrict__ cu,
                       const int8_t* __restrict__ ohc0, int T, int WPS,
                       int* __restrict__ out) {
  constexpr int kGC = 128;               // units a chunk
  constexpr int kStride = kGC + 16;      // bytes a column, padded
  __shared__ __align__(16) uint8_t tile[128 * kStride];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  int* o = out + ((size_t)b * T + t) * 8 * 128;
  int res[4] = {};  // out[tid / 32][4 * (tid % 32) + e]
  if (SRC == kSrcOhc0) {  // out = WPS * ohc0[b, :8]
    const int8_t* s = ohc0 + (size_t)b * kGroup * 128 + tid * 4;
    for (int k = 0; k < WPS; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) res[e] += s[e];
    }
  } else {  // one-hot chunks built column-major; rows 0..7 read from c = 0
    for (int c = 0; c < kGroup / kGC; ++c) {
      for (int k = 0; k < WPS; ++k) {
        int m = 0;
        if (tid < kGC)  // issued before the zeroing
          m = cu[(((size_t)b * T + t) * WPS * 32 + 32 * k + c) * 128 + tid];
        __syncthreads();  // every warp is done with the last chunk
        int4* z = reinterpret_cast<int4*>(tile);
        for (int i = tid; i < 128 * kStride / 16; i += kDepThreads)
          z[i] = make_int4(0, 0, 0, 0);
        __syncthreads();
        const int col = slot_column(m);
        if (tid < kGC && col >= 0) tile[col * kStride + tid] = 1;
        __syncthreads();
        if (c == 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            res[e] += tile[(4 * (tid & 31) + e) * kStride + (tid >> 5)];
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) o[tid * 4 + e] = res[e];
}

// --- launch -------------------------------------------------------------------

struct Layout {
  long long b_bytes, a_bytes;
};

Layout layout(int B, int WPS, int src, int prod) {
  if (prod == kProdNone) return {0, 0};
  const int nks = prod == kProdBf16 ? Op<true>::nks : Op<false>::nks;
  const int NG = (WPS + 3) / 4;
  return {(long long)B * nks * NG * kStepB,
          src == kSrcOhc0 ? (long long)B * 2 * nks * kFragA : 0};
}

template <class K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool BF16>
int launch_products(const int* cu, const int8_t* big, const int8_t* ohc0,
                    int B, int T, int WPS, int M, int src, uint8_t* scratch,
                    int* out, cudaStream_t s) {
  const int NG = (WPS + 3) / 4;
  const Layout L = layout(B, WPS, src, BF16 ? kProdBf16 : kProdS8);
  uint8_t* sb = scratch;
  const long long pieces = L.b_bytes / 16;
  depparts_stage_b_kernel<BF16>
      <<<(unsigned)((pieces + kStageThreads - 1) / kStageThreads),
         kStageThreads, 0, s>>>(big, B, WPS, M, NG, sb);
  if (src == kSrcOhc0) {
    uint8_t* sa = scratch + L.b_bytes;
    depparts_stage_a_kernel<BF16>
        <<<dim3(kGroup / 64, B), kStageThreads, 0, s>>>(ohc0, sa);
    const int smem = kRing * (kSteps * kFragA + kSteps * NG * kStepB) +
                     kRing * 8;
    static bool attr = false;
    if (!attr) {
      const int most = kRing * (kSteps * kFragA + kSteps * kMaxNG * kStepB) +
                       kRing * 8;
      const int e = allow_smem(depparts_ohc0_kernel<BF16>, most);
      if (e) return e;
      attr = true;
    }
    depparts_ohc0_kernel<BF16>
        <<<dim3((T + kTG - 1) / kTG, 2, B), 128, smem, s>>>(sb, sa, T, NG,
                                                            out);
  } else {
    constexpr int smem = 2 * kTileA + 2 * kTileB;
    static bool attr = false;
    if (!attr) {
      const int e = allow_smem(depparts_cu_kernel<BF16>, smem);
      if (e) return e;
      attr = true;
    }
    depparts_cu_kernel<BF16><<<dim3(T, B), kDepThreads, smem, s>>>(
        cu, sb, T, WPS, NG, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fpng

// Bytes of scratch fpng_depparts needs (0 for the modes without a product).
extern "C" long long fpng_depparts_scratch(int B, int WPS, int src,
                                           int prod) {
  const fpng::Layout L = fpng::layout(B, WPS, src, prod);
  return L.b_bytes + L.a_bytes;
}

// cu (B, T, WPS*32, 128) int32, big (B, WPS, M, 4096) int8 with M >= 8,
// ohc0 (B, 4096, 128) int8, scratch of fpng_depparts_scratch bytes -> out
// (B, T, 8, 128) int32, slot t holding step t's result.  src: 0 = the
// one-hot of cu, 1 = ohc0; prod: 0 = none, 1 = int8 products, 2 = bf16
// products (table in the header).  WPS <= 32.
extern "C" int fpng_depparts(const int* cu, const signed char* big,
                             const signed char* ohc0, int B, int T, int WPS,
                             int M, int src, int prod, void* scratch,
                             int* out, void* stream) {
  using namespace fpng;
  if (B <= 0 || B > 65535 || T <= 0 || WPS <= 0 || WPS > 4 * kMaxNG ||
      M < 8 || src < 0 || src > 1 || prod < 0 || prod > 2)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* bg = reinterpret_cast<const int8_t*>(big);
  const int8_t* oh = reinterpret_cast<const int8_t*>(ohc0);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  if (prod == kProdNone) {
    if (src == kSrcCu)
      depparts_noprod_kernel<kSrcCu><<<dim3(T, B), kDepThreads, 0, s>>>(
          cu, oh, T, WPS, out);
    else
      depparts_noprod_kernel<kSrcOhc0><<<dim3(T, B), kDepThreads, 0, s>>>(
          cu, oh, T, WPS, out);
    return (int)cudaGetLastError();
  }
  return prod == kProdBf16
             ? launch_products<true>(cu, bg, oh, B, T, WPS, M, src, sc, out, s)
             : launch_products<false>(cu, bg, oh, B, T, WPS, M, src, sc, out,
                                      s);
}
