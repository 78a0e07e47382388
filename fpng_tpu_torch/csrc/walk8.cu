// B3 and B8: speculative Huffman walk from every 512-bit chunk boundary,
// then the chunk-entry fixpoint, in one cooperative launch (and the jump's
// launch after it, below).
//
// Replaces fpng_tpu/ops/walk8.py:walk_fix8_tpu (B3, Pallas kernel
// _make_walk8_kernel / _walk8_body) and fpng_tpu/ops/specdec_tpu.py:
// walk_fix_tpu (B8, the PK=1 walk): the same walk at ST = 96 and ST = 536
// step rows a lane.  One thread walks one chunk lane: it reads the 32-bit
// stream window at its bit position from two words, looks the low 12 bits
// up in the packed LUT (ops/specdec.pack_lut) held in shared memory, and
// records one row per step - position, sym | rec << 9 | outlen << 10 |
// clen << 19 | is_match << 23, and the packed second literal (0x100 | s2,
// or 0) - in its first ST steps.  It walks on, unrecorded, until it
// reaches its chunk's end, hits an invalid code, or has taken kMaxSteps
// (536: B8's rows) steps; a walk that did not fit its ST rows reports
// overflow.  So a lane's exit does not depend on ST: B3 at 96 rows
// computes B8's exits, passes and converged entries, and B8 can resume
// from them (the seed, ops/walk8.resume_seed).
//
// The TPU ran the groups of lanes in grid order, carrying the previous
// group's converged exit in SMEM, and iterated inside the kernel.  Here
// the blocks of one cooperative grid (the occupancy limit, capped by the
// work) run every pass and meet at a grid-wide barrier between passes:
// pass 0 walks each lane from its chunk boundary (lane 0 from p0), or
// from its seed; pass k sets entry[c] = exit[c-1] from pass k-1's exits
// (double-buffered in device memory, read past L1, so every pass reads a
// consistent snapshot) and re-walks a lane only when its entry changed
// and is absent from the first 32 recorded positions (or second-literal
// positions) of its last walk - the same membership window as the TPU
// kernel.  On an image that fits its rows the converged entries, exits
// and overflow flags match fpng_tpu's walk8; on an overflowing image only
// the per-image overflow flag does (fpng_tpu's walk stops at its rows),
// and the entries are B8's.  A block that saw a change sets the pass's
// flag; after the barrier every block reads the same flag and stops
// together, at most NC + 1 fixpoint passes.  A seed is each lane's
// converged entry, or ~p where the entry is the second literal of a
// literal pair at p: a walk from that entry would pair the literals after
// it otherwise and could exit a literal away, so the lane walks from p
// and its entry is p plus the first literal's length.  Every exit is then
// the converged one, and the seeded walk reads 2 passes: pass 0 walks and
// records, pass 1 finds no change.  The host sees no pass: the pass count
// is written to device memory.
//
// Work split: 256-lane tiles of one image each; each block owns a
// contiguous run of tiles for the whole launch, so a lane's records are
// always written and read by the same thread.  A block loads the LUTs of
// its images into shared memory once (up to kMaxLuts; an image past those
// slots is looked up through L1).
//
// Bit positions (p0, zl8, entries, exits, the position records) are of the
// type P: int for streams under 2^31 bits, long long past them (the
// wrapper picks, ops/walk8.pos_dtype), so an everyday stream's walk holds
// and moves the bytes it always did.
//
// What bounds it on the H100: the serial chain of re-walks - up to
// kMaxSteps dependent steps of window, then LUT lookup, per fixpoint pass
// - against the record bytes (12 per step) of pass 0 and pass 1, where
// most lanes walk.  The design keeps the chain on the card and short: no
// launch, memset or readback between passes and no LUT reload; each walk
// stages its chunk's stream words in shared memory with one burst of
// loads, so a step from the chunk reads no device memory; the membership
// test issues its row loads eight at a time.
//
// A fixpoint can still move a wrong exit one lane a pass: on RGBA tiles
// with alpha ramps a lane walked from a wrong bit offset rarely rejoins the
// true walk within its chunk, so a wrong phase crosses the image one lane
// a pass, for hundreds of passes.  So when pass kJumpPass still changed a
// lane (and the rows can hold kMap + 1 maps and lists), the walk stops,
// and a second cooperative launch replays the rest of the fixpoint on maps
// instead of walks (the jump): each lane of an image still moving gets,
// for each entry bit0 + o, o < kMap (every exit lies under kMap bits past
// its chunk end), its exit and the entries among the first kMemb steps of
// that walk - all the fixpoint ever reads of a walk - in its record rows;
// one block an image then runs the same passes on those maps, a few
// lookups and two block barriers a pass in place of a walk and a grid
// barrier; and each lane walks once more, recorded, from the start of the
// walk its last pass kept.  The replay is the Jacobi loop itself, moved
// onto the maps (a lane's state is the start of its last walk), so every
// output is the one the loop gives: composing exits from exact entries
// would not be, since which walk a lane keeps, and where it exits (a
// literal pair split another way), depends on the entries it saw before.
// A state or an entry the maps do not cover (an exit at an invalid code)
// is walked there and then.  The jump has a launch of its own so that the
// walk keeps its registers and its occupancy; a walk that converged before
// pass kJumpPass costs that launch a read a block.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace fpng {
namespace {

namespace cg = cooperative_groups;

constexpr int kChunkBits = 512;
constexpr int kMemb = 32;
// the steps a walk takes at most: one a bit of its chunk, plus the token
// tail (ops/walk8.CAP, B8's rows ops/specdec_tpu.ST8)
constexpr int kMaxSteps = kChunkBits + 24;
constexpr int kWalkThreads = 256;  // one 256-lane tile at a time
constexpr int kLutWords = 4096;
constexpr int kMaxLuts = 12;       // 12 x 16 KB of shared memory
// stream words staged per lane: a walk from its chunk boundary reads 17
constexpr int kStage = 18;
// the fixpoint pass after which a walk still moving is replayed on maps
constexpr int kJumpPass = 16;
// entry offsets a lane's maps cover: a token is at most 18 bits, so an exit
// lies under 18 bits past its chunk end.  The maps take raw0 and raw1 rows
// [0, kMap), the replay's lists row kMap.
constexpr int kMap = 18;
// devices whose jump occupancy launch_walk keeps
constexpr int kDevices = 64;

template <typename P>
struct WalkArgs {
  const uint32_t* words;
  const int* lut;
  const P* p0;
  const P* zl8;
  int nw, B, NC, ST, tpi, nt, nlut, seeded;
  int kmax;  // the last fixpoint pass of the launch
  P* ent;  // entries; with seeded, the seeds on entry
  P* ex0;  // exits of even passes
  P* ex1;  // exits of odd passes
  int* nst;
  int* ovf;
  P* posr;
  int* raw0;
  int* raw1;
  int* ctl;  // changed flags [0, 3), passes, images mapped, replay passes
};

// Tiles [t0, t1) of block `blk` among G: a balanced contiguous split.
__host__ __device__ __forceinline__ int tile_begin(int nt, int blk, int G) {
  return (int)((long long)nt * blk / G);
}

template <typename P>
__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ s,
                                         int nw, P wi) {
  return wi < nw ? __ldg(s + wi) : 0u;
}

// Stage the kStage stream words from `base` on in the thread's column of
// `stage` (shared memory, [word][thread]), their loads issued together.
template <typename P>
__device__ __forceinline__ void stage_words(const uint32_t* s, int nw,
                                            uint32_t* stage, P base) {
#pragma unroll
  for (int i = 0; i < kStage; ++i)
    stage[i * kWalkThreads] = word(s, nw, base + i);
}

// The 32-bit stream window at bit p of a walk whose words from `base` on
// are staged.
template <typename P>
__device__ __forceinline__ uint32_t window(const uint32_t* s, int nw,
                                           const uint32_t* stage, P base,
                                           P p) {
  const int sh = (int)(p & 31), k = (int)((p >> 5) - base);
  uint32_t w0, w1;
  if (k + 1 < kStage) {
    w0 = stage[k * kWalkThreads];
    w1 = stage[(k + 1) * kWalkThreads];
  } else {
    w0 = word(s, nw, base + k);
    w1 = word(s, nw, base + k + 1);
  }
  return (w0 >> sh) | ((w1 << (31 - sh)) << 1);  // no >> 32
}

// Walk lane (b, c) from pos: records its first ST steps, nst and ovf,
// then walks on unrecorded; returns its exit.  The kStage stream words
// from pos's word on are first copied into the thread's column of `stage`
// (shared memory, [word][thread], so a warp reads 32 banks whatever its
// lanes' offsets), with their loads issued together; each step then cuts
// its 32-bit window from shared memory, and only a walk that runs past
// the staged words reads device memory again.  The tail is a loop of its
// own: a record branch inside the recording loop put a divergence point
// on every step of the serial chain and slowed the walk by a sixth.
template <typename P>
__device__ P walk(const WalkArgs<P>& a, const int* lut, uint32_t* stage,
                  int b, int c, P pos) {
  const size_t lane = (size_t)b * a.NC + c;
  const size_t row0 = (size_t)b * a.ST * a.NC + c;
  const P bit0 = (P)c * kChunkBits;
  const P z = __ldg(a.zl8 + b);
  const P bound = min(bit0 + (P)kChunkBits, z);
  const uint32_t* s = a.words + (size_t)b * a.nw;
  bool act = bit0 < z && pos < bound;
  const P base = pos >> 5;
  if (act) stage_words(s, a.nw, stage, base);
  auto window = [&](P p) { return fpng::window(s, a.nw, stage, base, p); };
  int j = 0;
  for (; j < a.ST && act; ++j) {
    const uint32_t w = window(pos);
    const int e = lut[w & 0xFFF];
    const int sym = e & 511, clen = (e >> 9) & 15, nextra = (e >> 13) & 7;
    const bool is_m = sym > 256 && sym <= 285;
    const int extra = (int)((w >> clen) & ((1u << nextra) - 1u));
    const bool stop = clen == 0;
    const int l2 = (e >> 25) & 15;
    const bool two = sym < 256 && !stop && l2 > 0;
    const int tok = clen + (is_m ? nextra + 1 : 0) + (two ? l2 : 0);
    const int outlen =
        (sym < 256 ? 1 : (is_m ? ((e >> 16) & 0x1FF) + extra : 0)) + two;
    const size_t r = row0 + (size_t)j * a.NC;
    a.posr[r] = pos;
    a.raw0[r] = sym | (stop ? 0 : 1 << 9) | (outlen << 10) | (clen << 19) |
                (is_m ? 1 << 23 : 0);
    a.raw1[r] = two ? (((e >> 16) & 0xFF) | 0x100) : 0;
    if (stop) {
      act = false;
    } else {
      pos += tok;
      act = pos < bound;
    }
  }
  a.nst[lane] = j;
  a.ovf[lane] = act ? 1 : 0;  // the walk did not fit its rows
  for (; j < kMaxSteps && act; ++j) {
    const int e = lut[window(pos) & 0xFFF];
    const int sym = e & 511, clen = (e >> 9) & 15, l2 = (e >> 25) & 15;
    if (clen == 0) break;  // an invalid code: the exit stays
    const bool is_m = sym > 256 && sym <= 285;
    pos += clen + (is_m ? ((e >> 13) & 7) + 1 : 0) +
           (sym < 256 && l2 > 0 ? l2 : 0);
    act = pos < bound;
  }
  return pos;
}

// Walk lane (b, c) from pos, unrecorded, to walk's exit, and return it.
// Bit o < kMap of *mask is set where one of the first min(kMemb, ST) steps
// (the rows walk records and the membership test reads) starts at lo + o
// or has its second literal there.
template <typename P>
__device__ P walk_map(const WalkArgs<P>& a, const int* lut, uint32_t* stage,
                      int b, int c, P pos, P lo, int* mask) {
  const P bit0 = (P)c * kChunkBits;
  const P z = __ldg(a.zl8 + b);
  const P bound = min(bit0 + (P)kChunkBits, z);
  const uint32_t* s = a.words + (size_t)b * a.nw;
  const int M = min(kMemb, a.ST);
  bool act = bit0 < z && pos < bound;
  const P base = pos >> 5;
  if (act) stage_words(s, a.nw, stage, base);
  int m = 0;
  for (int j = 0; j < kMaxSteps && act; ++j) {
    const int e = lut[window(s, a.nw, stage, base, pos) & 0xFFF];
    const int sym = e & 511, clen = (e >> 9) & 15, l2 = (e >> 25) & 15;
    const bool two = sym < 256 && clen != 0 && l2 > 0;
    if (j < M) {
      const P d = pos - lo;
      if (d >= 0 && d < kMap) m |= 1 << (int)d;
      if (two && d + clen >= 0 && d + clen < kMap) m |= 1 << (int)(d + clen);
    }
    if (clen == 0) break;  // an invalid code: the exit stays
    const bool is_m = sym > 256 && sym <= 285;
    pos += clen + (is_m ? ((e >> 13) & 7) + 1 : 0) + (two ? l2 : 0);
    act = pos < bound;
  }
  *mask = m;
  return pos;
}

// Whether the last walk of lane (b, c) passed through pos within its first
// kMemb steps: then the walk from pos is that walk's tail, with its exit.
// The rows are read eight at a time, their loads issued together.
template <typename P>
__device__ bool recorded(const WalkArgs<P>& a, int b, int c, P pos) {
  const size_t row0 = (size_t)b * a.ST * a.NC + c;
  const int top = min(kMemb, a.ST) - 1;
  const int m = min(top + 1, a.nst[(size_t)b * a.NC + c]);
  bool hit = false;
  for (int j0 = 0; j0 < m; j0 += 8) {
    P p[8];
    int r0[8], r1[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const size_t r = row0 + (size_t)min(j0 + u, top) * a.NC;
      p[u] = a.posr[r];
      r0[u] = a.raw0[r];
      r1[u] = a.raw1[r];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      hit |= j0 + u < m && (p[u] == pos || (r1[u] != 0 &&
                                            p[u] + ((r0[u] >> 19) & 15) == pos));
  }
  return hit;
}

// The replay's two lists of lanes (one a pass, by turns), each lane with
// its new entry: the first kList in shared memory, the rest in raw0 or raw1
// row kMap past lane 0's word, their entries then read from the exits.
constexpr int kList = 512;

template <typename P>
struct Lists {
  int* lane[2];  // shared
  P* ent[2];     // shared
  int* far[2];   // device memory
  int* cnt;      // shared, 2
};

// Replay image b's fixpoint on its lanes' maps, with the block's threads,
// from the state after pass kJumpPass: xa holds the lanes' exits and xb is
// free past lane 0's word.  A lane's state is the start of its last walk,
// in its posr row 0; its maps, at each entry bit0 + o (o < kMap), are the
// exit less the next chunk's bit in raw0 row o and the membership mask in
// raw1 row o.  A pass is the fixpoint's own: a lane whose predecessor's
// exit moved takes it as its entry, and unless that entry is in the
// membership mask of its state it walks from it - here, a lookup of the
// exit in its map.  A state or an entry the maps do not cover is walked
// (walk_map).  Only the lanes whose entry is not their predecessor's exit
// can move, a few a pass: each pass takes them from a list with their new
// entries, computes their exits (into xb, or a register for a thread's
// first lane), then moves the exits that changed into xa and lists their
// successors.  A pass costs two dependent loads of device memory (a lane's
// state, old exit and map exit; its membership mask) and two barriers.
// Returns the passes that moved; the exits end in xa.
template <typename P>
__device__ int replay(const WalkArgs<P>& a, const int* lut, uint32_t* stage,
                      const Lists<P>& L, int b, P* xa, P* xb) {
  const size_t l0 = (size_t)b * a.NC, r0 = (size_t)b * a.ST * a.NC;
  const P z = __ldg(a.zl8 + b);
  const int nl = (int)min((P)a.NC, (z + kChunkBits - 1) / kChunkBits);
  auto put = [&](int k, int s, int c, P e) {
    if (s < kList) {
      L.lane[k][s] = c;
      L.ent[k][s] = e;
    } else {
      L.far[k][s - kList] = c;
    }
  };
  if (threadIdx.x == 0) L.cnt[0] = 0;
  __syncthreads();
  for (int c = 1 + threadIdx.x; c < nl; c += kWalkThreads) {
    const P e = __ldcg(xa + l0 + c - 1);
    if (e != __ldcg(a.ent + l0 + c)) put(0, atomicAdd(L.cnt, 1), c, e);
  }
  __syncthreads();
  int t = 0;
  for (int n = L.cnt[0]; n > 0 && t <= a.NC; ++t) {
    const int k = t & 1;
    int v0 = 0;  // the thread's first lane, ~lane where its exit changed
    P x0 = 0;
    for (int i = threadIdx.x; i < n; i += kWalkThreads) {
      const int c = i < kList ? L.lane[k][i] : __ldcg(L.far[k] + i - kList);
      const size_t lane = l0 + c;
      // a listed lane's entry moved: it is not its recorded one
      const P e = i < kList ? L.ent[k][i] : __ldcg(xa + lane - 1);
      const P bit0 = (P)c * kChunkBits, eo = e - bit0;
      const bool in_e = eo >= 0 && eo < kMap;
      const P r = __ldcg(a.posr + r0 + c), x_old = __ldcg(xa + lane);
      const int xm = in_e ? __ldcg(a.raw0 + r0 + (size_t)eo * a.NC + c) : 0;
      a.ent[lane] = e;
      const P ro = r - bit0;
      int m = 0;  // an entry before the state's walk is none of its steps
      if (ro >= 0 && ro < kMap && eo < kMap) {
        if (eo >= 0)
          m = __ldcg(a.raw1 + r0 + (size_t)ro * a.NC + c) >> (int)eo;
      } else {
        walk_map(a, lut, stage, b, c, r, e, &m);
      }
      P x = x_old;
      if (!(m & 1)) {  // a walk from e
        a.posr[r0 + c] = e;
        x = in_e ? bit0 + (P)kChunkBits + (P)xm
                 : walk_map(a, lut, stage, b, c, e, e, &m);
      }
      const int v = x != x_old ? ~c : c;
      if (i == threadIdx.x) {
        v0 = v;
        x0 = x;
      } else if (v < 0) {
        xb[lane] = x;
        if (i < kList)
          L.lane[k][i] = v;
        else
          L.far[k][i - kList] = v;
      }
    }
    if (threadIdx.x == 0) L.cnt[k ^ 1] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kWalkThreads) {
      const int v = i == threadIdx.x ? v0
                    : i < kList      ? L.lane[k][i]
                                     : __ldcg(L.far[k] + i - kList);
      if (v >= 0) continue;
      const int c = ~v;
      const P x = i == threadIdx.x ? x0 : __ldcg(xb + l0 + c);
      xa[l0 + c] = x;
      if (c + 1 < nl) put(k ^ 1, atomicAdd(L.cnt + (k ^ 1), 1), c + 1, x);
    }
    __syncthreads();
    n = L.cnt[k ^ 1];
  }
  return t;
}

// The jump, after pass kJumpPass changed a lane (header).  ex holds that
// pass's exits; xb, the exits before it, is free: word b * NC marks image
// b (-1) until the next pass overwrites it.  Four phases, a grid barrier
// after each: mark the images with a lane whose entry is not its
// predecessor's exit (and put each lane's state in its posr row 0: a walk
// that took no step exits where it starts); build the marked images'
// maps, their (lane, offset) items spread over the grid; replay each
// marked image on one block; re-walk each mapped lane, recorded, from its
// state, on the thread that owns it in the passes after.  A lane's entry
// is read past L1 until the replay has written it, so the passes after
// read the replay's.
template <typename P>
__device__ void jump(const WalkArgs<P>& a, cg::grid_group& grid,
                     uint32_t* stage, const Lists<P>& L, int t0, int t1,
                     P* ex, P* xb) {
  for (int t = t0; t < t1; ++t) {
    const int b = t / a.tpi, c = (t - b * a.tpi) * kWalkThreads + threadIdx.x;
    if (c >= a.NC) continue;
    const size_t lane = (size_t)b * a.NC + c;
    if (a.nst[lane] == 0)
      a.posr[(size_t)b * a.ST * a.NC + c] = __ldcg(ex + lane);
    if (c > 0 && (P)c * kChunkBits < __ldg(a.zl8 + b) &&
        __ldcg(ex + lane - 1) != __ldcg(a.ent + lane))
      xb[(size_t)b * a.NC] = -1;
  }
  grid.sync();

  const size_t nthr = (size_t)gridDim.x * kWalkThreads;
  const size_t items = (size_t)a.B * a.NC * kMap;
  for (size_t i = (size_t)blockIdx.x * kWalkThreads + threadIdx.x; i < items;
       i += nthr) {
    const int o = (int)(i % kMap);
    const size_t lane = i / kMap;
    const int b = (int)(lane / a.NC), c = (int)(lane - (size_t)b * a.NC);
    const P bit0 = (P)c * kChunkBits;
    if (c == 0 || bit0 >= __ldg(a.zl8 + b) ||
        __ldcg(xb + (size_t)b * a.NC) != -1)
      continue;
    int m;
    const P x = walk_map(a, a.lut + (size_t)b * kLutWords, stage, b, c,
                         bit0 + o, bit0, &m);
    const size_t r = (size_t)b * a.ST * a.NC + (size_t)o * a.NC + c;
    a.raw0[r] = (int)(x - bit0 - kChunkBits);
    a.raw1[r] = m;
  }
  grid.sync();

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    if (__ldcg(xb + (size_t)b * a.NC) != -1) continue;
    const size_t row = (size_t)b * a.ST * a.NC + (size_t)kMap * a.NC + 1;
    const Lists<P> Lb{{L.lane[0], L.lane[1]}, {L.ent[0], L.ent[1]},
                      {a.raw0 + row, a.raw1 + row}, L.cnt};
    const int moved = replay(a, a.lut + (size_t)b * kLutWords, stage, Lb, b,
                             ex, xb);
    if (threadIdx.x == 0) {
      atomicAdd(a.ctl + 4, 1);
      atomicAdd(a.ctl + 5, moved);
    }
  }
  grid.sync();

  for (int t = t0; t < t1; ++t) {
    const int b = t / a.tpi, c = (t - b * a.tpi) * kWalkThreads + threadIdx.x;
    if (c == 0 || c >= a.NC || (P)c * kChunkBits >= __ldg(a.zl8 + b) ||
        __ldcg(xb + (size_t)b * a.NC) != -1)
      continue;
    const size_t lane = (size_t)b * a.NC + c;
    ex[lane] = walk(a, a.lut + (size_t)b * kLutWords, stage, b, c,
                    __ldcg(a.posr + (size_t)b * a.ST * a.NC + c));
  }
  grid.sync();
}

// Fixpoint passes k0 ... a.kmax over the block's tiles [t0, t1), until one
// finds no change.  Pass k sets entry[c] = exit[c-1] from pass k-1's exits
// (double-buffered, read past L1, so every pass reads a consistent
// snapshot) and re-walks a lane only when its entry changed and is absent
// from the first kMemb recorded positions (or second-literal positions) of
// its last walk.  Returns the passes counted: pass k counts k + 1 + extra.
template <typename P, typename LutOf>
__device__ __forceinline__ int fix_passes(const WalkArgs<P>& a,
                                          cg::grid_group& grid, LutOf lut_of,
                                          uint32_t* stage, int t0, int t1,
                                          int k0, int extra) {
  int* changed = a.ctl;
  int passes = k0 + extra;
  for (int k = k0; k <= a.kmax; ++k) {
    const P* ex_in = (k & 1) ? a.ex0 : a.ex1;
    P* ex_out = (k & 1) ? a.ex1 : a.ex0;
    // the flag of pass k + 1 was last read before pass k - 1's barrier
    if (blockIdx.x == 0 && threadIdx.x == 0) changed[(k + 1) % 3] = 0;
    int moved = 0;
    for (int t = t0; t < t1; ++t) {
      const int b = t / a.tpi;
      const int c = (t - b * a.tpi) * kWalkThreads + threadIdx.x;
      if (c >= a.NC) continue;
      const size_t lane = (size_t)b * a.NC + c;
      P out = __ldcg(ex_in + lane);
      const P pos = c == 0 ? __ldg(a.p0 + b) : __ldcg(ex_in + lane - 1);
      if ((P)c * kChunkBits < __ldg(a.zl8 + b) && pos != a.ent[lane]) {
        moved = 1;
        a.ent[lane] = pos;
        if (!recorded(a, b, c, pos))
          out = walk(a, lut_of(b), stage, b, c, pos);
      }
      ex_out[lane] = out;
    }
    if (__syncthreads_or(moved) && threadIdx.x == 0) changed[k % 3] = 1;
    grid.sync();
    passes = k + 1 + extra;
    if (__ldcg(changed + k % 3) == 0) break;  // the same word for all
  }
  return passes;
}

template <typename P>
__global__ void __launch_bounds__(kWalkThreads) walk8_kernel(WalkArgs<P> a) {
  // shared memory: the staged stream words, then the LUTs
  extern __shared__ int smem[];
  uint32_t* stage = (uint32_t*)smem + threadIdx.x;
  int* lut_s = smem + kStage * kWalkThreads;
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x;
  const int t0 = tile_begin(a.nt, blockIdx.x, G);
  const int t1 = tile_begin(a.nt, blockIdx.x + 1, G);
  const int b_first = t0 / a.tpi;
  const int nl = min(a.nlut, (t1 - 1) / a.tpi - b_first + 1);
  for (int i = threadIdx.x; i < nl * kLutWords; i += kWalkThreads)
    lut_s[i] = __ldg(a.lut + (size_t)b_first * kLutWords + i);
  __syncthreads();
  auto lut_of = [&](int b) {
    return b - b_first < nl ? lut_s + (b - b_first) * kLutWords
                            : a.lut + (size_t)b * kLutWords;
  };

  // pass 0: every lane from its chunk boundary (lane 0 from p0), or from
  // its seed: its entry, or ~p for the pair at p whose second literal is
  // its entry (then row 0 holds that pair)
  for (int t = t0; t < t1; ++t) {
    const int b = t / a.tpi, c = (t - b * a.tpi) * kWalkThreads + threadIdx.x;
    if (c >= a.NC) continue;
    const size_t lane = (size_t)b * a.NC + c;
    const P s = a.seeded ? a.ent[lane]
                         : c == 0 ? __ldg(a.p0 + b) : (P)c * kChunkBits;
    const P pos = s < 0 ? ~s : s;
    a.ex0[lane] = walk(a, lut_of(b), stage, b, c, pos);
    a.ent[lane] =
        s < 0 ? pos + ((a.raw0[(size_t)b * a.ST * a.NC + c] >> 19) & 15) : s;
  }
  grid.sync();

  // to pass kmax: kJumpPass where the rows hold the maps, and the jump's
  // launch goes on from there; else NC + 1 (lane c's entry is final after
  // pass c + 1)
  const int passes = fix_passes(a, grid, lut_of, stage, t0, t1, 1, 0);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[3] = passes;
}

// The jump's launch, after walk8_kernel: it returns at once unless that
// stopped after pass kJumpPass with the pass still changing a lane, and
// then runs the jump and the passes after it - the first of which finds no
// change - on its own tile split, its LUTs read through L1.  The jump
// counts as a pass.
template <typename P>
__global__ void __launch_bounds__(kWalkThreads)
    walk8_jump_kernel(WalkArgs<P> a) {
  // the same words for all
  if (__ldcg(a.ctl + 3) != kJumpPass + 1 ||
      __ldcg(a.ctl + kJumpPass % 3) == 0)
    return;
  // shared memory: the staged stream words, the lists' entries, lanes and
  // counts
  extern __shared__ long long smem2[];
  uint32_t* stage = (uint32_t*)smem2 + threadIdx.x;
  P* ents = (P*)((uint32_t*)smem2 + kStage * kWalkThreads);
  int* lanes = (int*)(ents + 2 * kList);
  const Lists<P> L{{lanes, lanes + kList}, {ents, ents + kList},
                   {nullptr, nullptr}, lanes + 2 * kList};
  cg::grid_group grid = cg::this_grid();
  const int t0 = tile_begin(a.nt, blockIdx.x, gridDim.x);
  const int t1 = tile_begin(a.nt, blockIdx.x + 1, gridDim.x);
  P* ex = (kJumpPass & 1) ? a.ex1 : a.ex0;  // pass kJumpPass's exits
  jump(a, grid, stage, L, t0, t1, ex, (kJumpPass & 1) ? a.ex0 : a.ex1);
  auto lut_of = [&](int b) { return a.lut + (size_t)b * kLutWords; };
  WalkArgs<P> rest = a;
  rest.kmax = a.NC + 1;
  const int passes =
      fix_passes(rest, grid, lut_of, stage, t0, t1, kJumpPass + 1, 1);
  if (blockIdx.x == 0 && threadIdx.x == 0) a.ctl[3] = passes;
}

// The most images any block's tile run spans on a grid of G blocks.
int max_span(int nt, int tpi, int G) {
  int span = 1;
  for (int blk = 0; blk < G; ++blk) {
    const int t0 = tile_begin(nt, blk, G), t1 = tile_begin(nt, blk + 1, G);
    if (t1 > t0) span = std::max(span, (t1 - 1) / tpi - t0 / tpi + 1);
  }
  return span;
}

// The launch of walk8_kernel<P> (fpng_walk8's contract).
template <typename P>
int launch_walk(const int* words, int nw, const int* lut, const void* p0,
                const void* zl8, int B, int NC, int ST, int seeded,
                void* ent, void* ex0, void* ex1, int* nst, int* ovf,
                void* posr, int* raw0, int* raw1, int* ctl, int* info,
                void* stream) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tpi = (NC + kWalkThreads - 1) / kWalkThreads;
  if ((long long)B * tpi >= 1LL << 31) return (int)cudaErrorInvalidValue;
  const int nt = B * tpi;
  // more LUT slots cost occupancy, and fewer blocks span more images:
  // grow the slots until every block's images fit (or kMaxLuts)
  int nlut = 1, G = 0;
  size_t smem = 0;
  for (;;) {
    smem = ((size_t)nlut * kLutWords + kStage * kWalkThreads) * sizeof(int);
    e = cudaFuncSetAttribute(walk8_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, walk8_kernel<P>,
                                                        kWalkThreads, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    G = (int)std::min<long long>((long long)occ * sms, nt);
    const int need = std::min(max_span(nt, tpi, G), kMaxLuts);
    if (need <= nlut) break;
    nlut = need;
  }
  info[0] = G;
  info[1] = occ;
  info[2] = nlut;
  const int kmax = ST > kMap ? std::min(kJumpPass, NC + 1) : NC + 1;
  WalkArgs<P> a{(const uint32_t*)words, lut, (const P*)p0, (const P*)zl8,
                nw, B, NC, ST, tpi, nt, nlut, seeded, kmax, (P*)ent,
                (P*)ex0, (P*)ex1, nst, ovf, (P*)posr, raw0, raw1, ctl};
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)walk8_kernel<P>, dim3(G),
                                  dim3(kWalkThreads), args, smem,
                                  (cudaStream_t)stream);
  info[3] = e == cudaSuccess;
  if (e != cudaSuccess || ST <= kMap) return (int)e;
  // the jump's launch, queued behind the walk whatever it finds: a walk that
  // converged costs it a read of ctl a block.  Its shared memory is fixed,
  // so its blocks per SM are asked once a device.
  const size_t smem2 = kStage * kWalkThreads * sizeof(int) +
                       2 * kList * (sizeof(P) + sizeof(int)) +
                       2 * sizeof(int);
  static int occ2_of[kDevices];
  int occ2 = dev < kDevices ? occ2_of[dev] : 0;
  if (occ2 <= 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ2, walk8_jump_kernel<P>, kWalkThreads, smem2);
    if (e != cudaSuccess) return (int)e;
    if (occ2 <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (dev < kDevices) occ2_of[dev] = occ2;
  }
  e = cudaLaunchCooperativeKernel((const void*)walk8_jump_kernel<P>,
                                  dim3(occ2 * sms), dim3(kWalkThreads), args,
                                  smem2, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  info[3] = 2;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fpng

// The whole walk over B images x NC lanes with ST step rows a lane, in one
// cooperative launch, and where ST > kMap the jump's launch after it.
// With seeded, ent (B, NC) holds the seeds on entry; without, each lane
// starts at its chunk boundary (lane 0 at p0).  ex0,
// ex1 (B, NC) are scratch; ctl (6 ints, zeroed by the caller) gets the
// pass count at ctl[3], the images the jump mapped at ctl[4] and their
// replay passes at ctl[5].  info (host, 4 ints) gets the grid, the blocks
// per SM and the shared-memory LUT slots, and the kernels launched (1 or
// 2).  The grid is the co-resident
// limit for the launch's shared memory, capped by the tiles; a launch the
// card refuses returns its error.  With wide, p0, zl8, ent, ex0, ex1 and
// posr hold 64-bit positions, else 32-bit ones (a stream under 2^31 bits).
extern "C" int fpng_walk8(const int* words, int nw, const int* lut,
                          const void* p0, const void* zl8, int B, int NC,
                          int ST, int seeded, int wide, void* ent, void* ex0,
                          void* ex1, int* nst, int* ovf, void* posr,
                          int* raw0, int* raw1, int* ctl, int* info,
                          void* stream) {
  using namespace fpng;
  if (B <= 0 || NC <= 0) return 0;
  if (ST <= 0 || ST > kMaxSteps) return (int)cudaErrorInvalidValue;
  if (!wide && (long long)(NC + 1) * kChunkBits >= 1LL << 31)
    return (int)cudaErrorInvalidValue;
  return wide ? launch_walk<long long>(words, nw, lut, p0, zl8, B, NC, ST,
                                       seeded, ent, ex0, ex1, nst, ovf, posr,
                                       raw0, raw1, ctl, info, stream)
              : launch_walk<int>(words, nw, lut, p0, zl8, B, NC, ST, seeded,
                                 ent, ex0, ex1, nst, ovf, posr, raw0, raw1,
                                 ctl, info, stream);
}
