// B4: walk records -> deposit records, plus fpng's constraint checks.
//
// Replaces fpng_tpu/ops/walk8.py:_finalize_records8 (Pallas kernel
// _make_finalize8_kernel).  One thread per chunk lane walks its first k8
// record rows, carrying the lane's output offset from out0:
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
//     fail / eob_end / bad_end.  Each warp reduces its lanes and one lane
//     commits them with atomicOr / atomicMin.
//
// _divmod_const (an f32 reciprocal for the TPU) is plain integer division
// here.  Literals at or past the raster end (post-EOB garbage, which the
// TPU clamps into a padding row) deposit nothing, so deposited slots are
// distinct.  Records are step-major (B, ST, NC) in and (B, k8, NC) out, so
// a warp's loads and stores are contiguous.
//
// What bounds it on the H100: bytes (12 read per recorded step, rows past a
// lane's step count are not read; 8 written per output row; 12 read per
// lane).

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kFinThreads = 128;
constexpr int kInf = 0x7FFFFFFF;

__global__ void __launch_bounds__(kFinThreads)
finalize8_kernel(const int* __restrict__ posr, const int* __restrict__ raw0,
                 const int* __restrict__ raw1, int ST,
                 const int* __restrict__ nst, const int* __restrict__ e_fin,
                 const int* __restrict__ out0, int NC, int k8, int h, int bpl,
                 int c, int* __restrict__ meta, int* __restrict__ metb,
                 int* __restrict__ chk) {
  const int b = blockIdx.y;
  const int lc = blockIdx.x * kFinThreads + threadIdx.x;
  bool fail = false;
  int eobm = kInf, badm = kInf;
  if (lc < NC) {
    const size_t lane = (size_t)b * NC + lc;
    const size_t in0 = (size_t)b * ST * NC + lc;
    const size_t o0 = (size_t)b * k8 * NC + lc;
    const int rs = bpl + 1, total = h * rs, n_slots = h * bpl;
    const int e_l = e_fin[lane], n_l = nst[lane];
    int carry = out0[lane];
    for (int j = 0; j < k8; ++j) {
      // rows at or past the lane's step count hold no record: read
      // nothing there (zeros make every flag below false)
      const size_t r = in0 + (size_t)j * NC;
      const bool live = j < n_l;
      const int p = live ? posr[r] : 0, r0 = live ? raw0[r] : 0,
                r1 = live ? raw1[r] : 0;
      const bool recbit = (r0 >> 9) & 1;
      const int clen = (r0 >> 19) & 15;
      const bool is_m = (r0 >> 23) & 1;
      const int s2 = r1 & 0xFF;
      const bool dem = recbit && r1 != 0 && p < e_l && p + clen == e_l;
      const bool rec = (recbit && p >= e_l) || dem;
      const int sym = dem ? s2 : (r0 & 511);
      const int outlen = dem ? 1 : ((r0 >> 10) & 511);
      const bool two = rec && r1 != 0 && !dem;
      const int outp = carry;
      if (rec) carry += outlen;

      const int q = outp / rs, rowpos = outp - q * rs;
      const int rowpos2 = rowpos + 1 == rs ? 0 : rowpos + 1;
      const bool lit = rec && sym < 256 && rowpos != 0 && outp < total;
      const bool lit2 = two && rowpos2 != 0 && outp + 1 < total;
      const bool lit2_only = lit2 && !lit;
      const int off = q * bpl + (lit2_only ? rowpos2 : rowpos) - 1;
      const size_t o = o0 + (size_t)j * NC;
      meta[o] = min(max(off, 0), n_slots);
      metb[o] = (lit || lit2_only ? ((lit ? sym : s2) | 0x100) : 0) |
                (lit && lit2 ? (s2 | 0x100) << 16 : 0);

      const bool lv = rec && outp < total;
      const int x = rowpos - 1;
      bool f = lv && sym > 285;
      const int fexp = outp >= rs ? 2 : 0;
      f |= lv && rowpos == 0 && (sym >= 256 || sym != fexp);
      const bool mok = rowpos >= 1 && x % c == 0 && outlen % c == 0 &&
                       x + outlen <= bpl;
      f |= lv && is_m && !mok;
      f |= lv && rowpos >= 1 && x % c != 0 && sym >= 256;
      f |= lv && sym == 256;
      const bool at_total = rec && outp == total;
      if (at_total && sym == 256) eobm = min(eobm, p + clen);
      if (at_total && sym != 256) badm = min(badm, p);
      const int outp2 = outp + 1;
      const int fexp2 = outp2 >= rs ? 2 : 0;
      f |= two && outp2 < total && rowpos2 == 0 && s2 != fexp2;
      if (two && outp2 == total) badm = min(badm, p + clen);
      fail |= f;
    }
  }
  const bool any_fail = __any_sync(0xffffffffu, fail);
  eobm = __reduce_min_sync(0xffffffffu, eobm);
  badm = __reduce_min_sync(0xffffffffu, badm);
  if ((threadIdx.x & 31) == 0) {
    int* ck = chk + (size_t)b * 3;
    if (any_fail) atomicOr(ck, 1);
    if (eobm != kInf) atomicMin(ck + 1, eobm);
    if (badm != kInf) atomicMin(ck + 2, badm);
  }
}

}  // namespace
}  // namespace fpng

// posr/raw0/raw1 (B, ST, NC), nst/e_fin/out0 (B, NC) -> meta/metb
// (B, k8, NC); chk (B, 3) must hold (0, INF, INF) on entry.
extern "C" int fpng_finalize8(const int* posr, const int* raw0,
                              const int* raw1, int ST, const int* nst,
                              const int* e_fin, const int* out0, int B,
                              int NC, int k8, int h, int bpl, int c,
                              int* meta, int* metb, int* chk, void* stream) {
  using namespace fpng;
  if (B <= 0 || NC <= 0) return 0;
  const dim3 grid((NC + kFinThreads - 1) / kFinThreads, B);
  finalize8_kernel<<<grid, kFinThreads, 0, (cudaStream_t)stream>>>(
      posr, raw0, raw1, ST, nst, e_fin, out0, NC, k8, h, bpl, c, meta, metb,
      chk);
  return (int)cudaGetLastError();
}
