// B3: speculative Huffman walk from every 512-bit chunk boundary, and one
// pass of the chunk-entry fixpoint per launch.
//
// Replaces fpng_tpu/ops/walk8.py:walk_fix8_tpu (Pallas kernel
// _make_walk8_kernel / _walk8_body).  One thread walks one chunk lane: it
// reads the 32-bit stream window at its bit position from two words, looks
// the low 12 bits up in the packed LUT (ops/specdec.pack_lut) held in shared
// memory, and records one row per step - position, sym | rec << 9 |
// outlen << 10 | clen << 19 | is_match << 23, and the packed second literal
// (0x100 | s2, or 0) - until it reaches its chunk's end, hits an invalid
// code, or fills its ST rows (then it reports overflow).
//
// The TPU ran the groups of lanes in grid order and carried the previous
// group's converged exit in SMEM; Hopper blocks run in no order.  So the
// fixpoint is one launch per pass over every lane: pass 0 walks each lane
// from its chunk boundary (lane 0 from p0); pass k sets
// entry[c] = exit[c-1] from pass k-1's exits (double-buffered, so every
// pass reads a consistent snapshot) and re-walks a lane only when its entry
// changed and is absent from the first 32 recorded positions (or second-
// literal positions) of its last walk - the same membership window as the
// TPU kernel, so the converged entries, exits and overflow flags match it.
// The host reads a changed flag after each pass and stops when it is 0.
//
// Records are step-major, (B, ST, NC): the lanes of a warp write one
// contiguous run per step.  A block never straddles two images, so it
// loads one image's 16 KB LUT into shared memory.
//
// What bounds it on the H100: the record bytes (12 per step) against a
// latency-bound dependent chain of ~ST steps per lane (window load -> LUT
// lookup -> next position); the stream words come through L1/L2.

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kChunkBits = 512;
constexpr int kMemb = 32;
constexpr int kWalkThreads = 128;

__device__ __forceinline__ uint32_t window32(const uint32_t* __restrict__ s,
                                             int nw, int pos) {
  const int wi = pos >> 5, sh = pos & 31;
  const uint32_t w0 = wi < nw ? __ldg(s + wi) : 0u;
  const uint32_t w1 = wi + 1 < nw ? __ldg(s + wi + 1) : 0u;
  return (w0 >> sh) | ((w1 << (31 - sh)) << 1);  // no shift by 32
}

__global__ void __launch_bounds__(kWalkThreads)
walk8_pass_kernel(const uint32_t* __restrict__ words, int nw,
                  const int* __restrict__ lut, const int* __restrict__ p0,
                  const int* __restrict__ zl8, int NC, int ST, int first,
                  int* __restrict__ ent, const int* __restrict__ exit_in,
                  int* __restrict__ exit_out, int* __restrict__ nst,
                  int* __restrict__ ovf, int* __restrict__ posr,
                  int* __restrict__ raw0, int* __restrict__ raw1,
                  int* __restrict__ changed) {
  __shared__ int lut_s[4096];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < 4096; i += kWalkThreads)
    lut_s[i] = lut[(size_t)b * 4096 + i];
  __syncthreads();
  const int c = blockIdx.x * kWalkThreads + threadIdx.x;
  if (c >= NC) return;
  const size_t lane = (size_t)b * NC + c;
  const size_t row0 = (size_t)b * ST * NC + c;
  const int bit0 = c * kChunkBits;
  const int z = zl8[b];
  const bool live = bit0 < z;
  const int bound = min(bit0 + kChunkBits, z);

  int pos;
  if (first) {
    pos = c == 0 ? p0[b] : bit0;
    ent[lane] = pos;
  } else {
    pos = c == 0 ? p0[b] : exit_in[lane - 1];
    if (!live || pos == ent[lane]) {
      exit_out[lane] = exit_in[lane];
      return;
    }
    *changed = 1;
    ent[lane] = pos;
    // a recorded path that holds the new entry is the walk from it
    const int m = min(min(kMemb, ST), nst[lane]);
    for (int j = 0; j < m; ++j) {
      const size_t r = row0 + (size_t)j * NC;
      const int p = posr[r];
      if (p == pos || (raw1[r] != 0 && p + ((raw0[r] >> 19) & 15) == pos)) {
        exit_out[lane] = exit_in[lane];
        return;
      }
    }
  }

  const uint32_t* s = words + (size_t)b * nw;
  bool act = live && pos < bound;
  int j = 0;
  for (; j < ST && act; ++j) {
    const uint32_t w = window32(s, nw, pos);
    const int e = lut_s[w & 0xFFF];
    const int sym = e & 511, clen = (e >> 9) & 15, nextra = (e >> 13) & 7;
    const bool is_m = sym > 256 && sym <= 285;
    const int extra = (int)((w >> clen) & ((1u << nextra) - 1u));
    const bool stop = clen == 0;
    const int l2 = (e >> 25) & 15;
    const bool two = sym < 256 && !stop && l2 > 0;
    const int tok = clen + (is_m ? nextra + 1 : 0) + (two ? l2 : 0);
    const int outlen =
        (sym < 256 ? 1 : (is_m ? ((e >> 16) & 0x1FF) + extra : 0)) + two;
    const size_t r = row0 + (size_t)j * NC;
    posr[r] = pos;
    raw0[r] = sym | (stop ? 0 : 1 << 9) | (outlen << 10) | (clen << 19) |
              (is_m ? 1 << 23 : 0);
    raw1[r] = two ? (((e >> 16) & 0xFF) | 0x100) : 0;
    if (stop) {
      act = false;
    } else {
      pos += tok;
      act = pos < bound;
    }
  }
  exit_out[lane] = pos;
  nst[lane] = j;
  ovf[lane] = act ? 1 : 0;
}

}  // namespace
}  // namespace fpng

// One walk pass over B images x NC lanes (first = 1: pass 0; exit_in is
// then unread).  changed is set to 1 when any live lane's entry moved.
extern "C" int fpng_walk8_pass(const int* words, int nw, const int* lut,
                               const int* p0, const int* zl8, int B, int NC,
                               int ST, int first, int* ent,
                               const int* exit_in, int* exit_out, int* nst,
                               int* ovf, int* posr, int* raw0, int* raw1,
                               int* changed, void* stream) {
  using namespace fpng;
  if (B <= 0 || NC <= 0) return 0;
  const dim3 grid((NC + kWalkThreads - 1) / kWalkThreads, B);
  walk8_pass_kernel<<<grid, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, nw, lut, p0, zl8, NC, ST, first, ent, exit_in,
      exit_out, nst, ovf, posr, raw0, raw1, changed);
  return (int)cudaGetLastError();
}
