// B4 (and B9): walk records -> deposit records, plus fpng's constraint
// checks.
//
// Replaces fpng_tpu/ops/walk8.py:_finalize_records8 (Pallas kernel
// _make_finalize8_kernel) and, at k8 <= 536, fpng_tpu/ops/specdec_tpu.py:
// _finalize_records.  Each chunk lane's first k8 record rows, with the
// lane's output offset running down them from out0:
//
//   * rows recorded before the lane's converged entry e_fin are dropped; a
//     two-literal step whose second literal starts exactly at e_fin is
//     demoted to that literal;
//   * each row becomes one deposit record: a data-raster slot
//     (row * bpl + column, filter bytes excluded) and a value word
//     (0x100 | v1) | (0x100 | v2) << 16 for the step's literals, 0 for a
//     match, a filter byte or a dropped row (the "wide" record of
//     fpng_tpu/ops/bitpack.py:485-488, for every raster size);
//   * the reference decoder's checks (fpng.cpp:2257-2584: filter bytes,
//     match alignment and row caps, early EOB, the true EOB position and
//     anything reaching the raster end before it) reduce to per-image
//     fail / eob_end / bad_end.
//
// _divmod_const (an f32 reciprocal for the TPU) is an exact multiply-shift
// division here (FastDiv).  Literals at or past the raster end (post-EOB garbage, which the
// TPU clamps into a padding row) deposit nothing, so deposited slots are
// distinct.  Records are step-major (B, ST, NC) in and (B, k8, NC) out.
//
// What bounds it on the H100: bytes (12 read per recorded step, rows past a
// lane's step count are not read; 8 written per output row; 12 read per
// lane).  A row's record and output length depend only on the row and the
// lane's e_fin; the only thing carried down a lane is the running output
// offset, which is therefore an exclusive prefix sum of rec * outlen
// seeded by out0.  So no thread walks a lane: a block of 8 warps owns 32
// lanes of one image (kFinLanes, one lane a thread, loads coalesced along
// lanes) and walks down them in row tiles of 32 rows (kFinTileRows); in a
// tile warp w takes rows 4w .. 4w + 3 (kFinRows), loads all of them at
// once (12 independent loads a thread), sums their output lengths, and
// the 8 warp sums of each lane are scanned through shared memory (double
// buffered, one __syncthreads a tile) on top of the column total carried
// from the tiles above.  Then every row's record and checks are computed
// in parallel.  The tiling alone, with the one-thread walk's per-row
// arithmetic, took the walk's time (0.35 ms for B4 on the H100): the
// instructions of a row, three of them integer divisions, and not the
// serial offset, set it.  So a row that records nothing (dropped, or past
// the step count: most rows of a trimmed tile) only stores its slot and a
// zero, from the raster row and position of the running offset, which
// each recorded row moves with one multiply-shift division.  The tile is the same at both row caps: k8 <= 96 (walk8) is
// 3 tiles, k8 <= 536 (PK=1) 17; a partial last tile masks its rows.  The
// checks reduce in each warp (vote, min) and then in the block, with one
// set of atomics a block.  chk is set to (0, INF, INF) by a first launch
// of the same C entry, so the wrapper uploads nothing.
//
// Bit positions (posr, e_fin and chk's eob_end and bad_end) are of the
// type P, as in csrc/walk8.cu: int under 2^31 bits, long long past them,
// with INF the type's largest value.  Output offsets stay int: the raster
// is under 2^30 bytes (ops/walk8.fits).

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kFinLanes = 32;                        // lanes a block
constexpr int kFinWarps = 8;                         // warps a block
constexpr int kFinRows = 4;                          // rows a warp a tile
constexpr int kFinTileRows = kFinWarps * kFinRows;   // rows a tile
constexpr int kFinThreads = kFinLanes * kFinWarps;
// INF: the position type's largest value ("no position")
template <typename P>
struct Inf;
template <>
struct Inf<int> {
  static constexpr int v = 0x7FFFFFFF;
};
template <>
struct Inf<long long> {
  static constexpr long long v = 0x7FFFFFFFFFFFFFFFLL;
};

// Division by a divisor d >= 1 fixed for the launch, for 0 <= n < 2^31:
// n / d = (n * m) >> k with k = 31 + ceil(log2 d), m = ceil(2^k / d)
// (m * d - 2^k < d <= 2^(k - 31), so the quotient is exact), a 64-bit
// multiply and a shift instead of the ~20 instructions of an int division.
struct FastDiv {
  unsigned long long m;
  int k;
};

__device__ __forceinline__ FastDiv make_fastdiv(int d) {
  const int k = 31 + (d > 1 ? 32 - __clz(d - 1) : 0);
  return {((1ull << k) + (unsigned)d - 1) / (unsigned)d, k};
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return (int)(((unsigned long long)(unsigned)n * f.m) >> f.k);
}

template <typename P>
__global__ void chk_init_kernel(P* __restrict__ chk, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 3 * B) chk[i] = i % 3 == 0 ? 0 : Inf<P>::v;
}

__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(0xffffffffu, v);
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

template <typename P>
__global__ void __launch_bounds__(kFinThreads)
finalize8_kernel(const P* __restrict__ posr, const int* __restrict__ raw0,
                 const int* __restrict__ raw1, int ST,
                 const int* __restrict__ nst, const P* __restrict__ e_fin,
                 const int* __restrict__ out0, int NC, int k8, int h, int bpl,
                 int c, int* __restrict__ meta, int* __restrict__ metb,
                 P* __restrict__ chk) {
  constexpr P INF = Inf<P>::v;
  __shared__ int part[2][kFinWarps][kFinLanes];
  __shared__ P red[3][kFinWarps];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lc = blockIdx.x * kFinLanes + lane;
  const bool active = lc < NC;
  const size_t in0 = (size_t)b * ST * NC + lc;
  const size_t o0 = (size_t)b * k8 * NC + lc;
  const int rs = bpl + 1, total = h * rs, n_slots = h * bpl;
  const FastDiv frs = make_fastdiv(rs), fc = make_fastdiv(c);
  P e_l = 0;
  int n_l = 0, carry = 0;
  if (active) {
    const size_t l = (size_t)b * NC + lc;
    e_l = e_fin[l];
    n_l = nst[l];
    carry = out0[l];
  }
  bool fail = false;
  P eobm = INF, badm = INF;
  for (int t0 = 0, buf = 0; t0 < k8; t0 += kFinTileRows, buf ^= 1) {
    const int j0 = t0 + warp * kFinRows;
    // rows at or past the lane's step count hold no record: read nothing
    // there (zeros make every flag below false)
    P p[kFinRows];
    int r0[kFinRows], r1[kFinRows];
#pragma unroll
    for (int i = 0; i < kFinRows; ++i) {
      const bool live = active && j0 + i < k8 && j0 + i < n_l;
      const size_t r = in0 + (size_t)(j0 + i) * NC;
      p[i] = live ? posr[r] : 0;
      r0[i] = live ? raw0[r] : 0;
      r1[i] = live ? raw1[r] : 0;
    }
    bool rec[kFinRows], dem[kFinRows];
    int outlen[kFinRows], sum = 0;
#pragma unroll
    for (int i = 0; i < kFinRows; ++i) {
      const bool recbit = (r0[i] >> 9) & 1;
      const int clen = (r0[i] >> 19) & 15;
      dem[i] = recbit && r1[i] != 0 && p[i] < e_l && p[i] + clen == e_l;
      rec[i] = (recbit && p[i] >= e_l) || dem[i];
      outlen[i] = dem[i] ? 1 : ((r0[i] >> 10) & 511);
      if (rec[i]) sum += outlen[i];
    }
    part[buf][warp][lane] = sum;
    __syncthreads();
    // this warp's first row starts after the tiles above and the warps
    // before it in this tile
    int outp = carry, tile = 0;
#pragma unroll
    for (int w = 0; w < kFinWarps; ++w) {
      const int v = part[buf][w][lane];
      if (w < warp) outp += v;
      tile += v;
    }
    carry += tile;
    if (!active) continue;
    // the raster row and position of the running offset, kept until a
    // recorded row moves it
    int q = fdiv(outp, frs), rowpos = outp - q * rs;
#pragma unroll
    for (int i = 0; i < kFinRows; ++i) {
      const int j = j0 + i;
      if (j >= k8) break;
      const size_t o = o0 + (size_t)j * NC;
      if (!rec[i]) {
        // a dropped row or one past the step count: no literal, no check
        meta[o] = min(max(q * bpl + rowpos - 1, 0), n_slots);
        metb[o] = 0;
        continue;
      }
      const int s2 = r1[i] & 0xFF;
      const int clen = (r0[i] >> 19) & 15;
      const bool is_m = (r0[i] >> 23) & 1;
      const int sym = dem[i] ? s2 : (r0[i] & 511);
      const bool two = r1[i] != 0 && !dem[i];
      const int op = outp;

      const int rowpos2 = rowpos + 1 == rs ? 0 : rowpos + 1;
      const bool lit = sym < 256 && rowpos != 0 && op < total;
      const bool lit2 = two && rowpos2 != 0 && op + 1 < total;
      const bool lit2_only = lit2 && !lit;
      const int off = q * bpl + (lit2_only ? rowpos2 : rowpos) - 1;
      meta[o] = min(max(off, 0), n_slots);
      metb[o] = (lit || lit2_only ? ((lit ? sym : s2) | 0x100) : 0) |
                (lit && lit2 ? (s2 | 0x100) << 16 : 0);

      const bool lv = op < total;
      const int x = rowpos - 1;
      bool f = lv && sym > 285;
      const int fexp = op >= rs ? 2 : 0;
      f |= lv && rowpos == 0 && (sym >= 256 || sym != fexp);
      // x and outlen are >= 0 where their residues are read
      const bool xc = rowpos >= 1 && x - fdiv(x, fc) * c == 0;
      const bool mok = xc && outlen[i] - fdiv(outlen[i], fc) * c == 0 &&
                       x + outlen[i] <= bpl;
      f |= lv && is_m && !mok;
      f |= lv && rowpos >= 1 && !xc && sym >= 256;
      f |= lv && sym == 256;
      const bool at_total = op == total;
      if (at_total && sym == 256) eobm = min(eobm, p[i] + (P)clen);
      if (at_total && sym != 256) badm = min(badm, p[i]);
      const int op2 = op + 1;
      const int fexp2 = op2 >= rs ? 2 : 0;
      f |= two && op2 < total && rowpos2 == 0 && s2 != fexp2;
      if (two && op2 == total) badm = min(badm, p[i] + (P)clen);
      fail |= f;
      outp += outlen[i];
      q = fdiv(outp, frs);
      rowpos = outp - q * rs;
    }
  }
  const bool any_fail = __any_sync(0xffffffffu, fail);
  eobm = warp_min(eobm);
  badm = warp_min(badm);
  if (lane == 0) {
    red[0][warp] = any_fail;
    red[1][warp] = eobm;
    red[2][warp] = badm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool f = false;
    P e = INF, m = INF;
#pragma unroll
    for (int w = 0; w < kFinWarps; ++w) {
      f |= red[0][w] != 0;
      e = min(e, red[1][w]);
      m = min(m, red[2][w]);
    }
    P* ck = chk + (size_t)b * 3;
    if (f) ck[0] = 1;  // every block that fails stores the same 1
    if (e != INF) atomicMin(ck + 1, e);
    if (m != INF) atomicMin(ck + 2, m);
  }
}

template <typename P>
int launch_finalize(const void* posr, const int* raw0, const int* raw1,
                    int ST, const int* nst, const void* e_fin,
                    const int* out0, int B, int NC, int k8, int h, int bpl,
                    int c, int* meta, int* metb, void* chk, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  chk_init_kernel<P><<<(3 * B + 255) / 256, 256, 0, s>>>((P*)chk, B);
  if (NC > 0 && k8 > 0) {
    const dim3 grid((NC + kFinLanes - 1) / kFinLanes, B);
    finalize8_kernel<P><<<grid, kFinThreads, 0, s>>>(
        (const P*)posr, raw0, raw1, ST, nst, (const P*)e_fin, out0, NC, k8,
        h, bpl, c, meta, metb, (P*)chk);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fpng

// posr/raw0/raw1 (B, ST, NC), nst/e_fin/out0 (B, NC) -> meta/metb
// (B, k8, NC), chk (B, 3).  Two launches: chk set to (0, INF, INF), then
// the finalize.  With wide, posr, e_fin and chk hold 64-bit positions,
// else 32-bit ones.
extern "C" int fpng_finalize8(const void* posr, const int* raw0,
                              const int* raw1, int ST, const int* nst,
                              const void* e_fin, const int* out0, int B,
                              int NC, int k8, int h, int bpl, int c,
                              int wide, int* meta, int* metb, void* chk,
                              void* stream) {
  using namespace fpng;
  if (B <= 0) return 0;
  return wide ? launch_finalize<long long>(posr, raw0, raw1, ST, nst, e_fin,
                                           out0, B, NC, k8, h, bpl, c, meta,
                                           metb, chk, stream)
              : launch_finalize<int>(posr, raw0, raw1, ST, nst, e_fin, out0,
                                     B, NC, k8, h, bpl, c, meta, metb, chk,
                                     stream);
}
