// B1: the encoder deposit (desc -> code lookup -> bit offsets -> words).
//
// Replaces fpng_tpu/ops/encfuse.py:encode_bits_fused (Pallas kernel
// _make_encfuse_kernel / _encfuse_body).  Per unit of the (B, N) desc stream
// (layout in fpng_tpu_torch/ops/encfuse.py): look up code | size << 16 in the
// image's 288-entry table, add the extra bits, and deposit (value, nbits) at
// the unit's exclusive bit offset from base_bits into little-endian words.
// Also emits total_bits and the start of the last token (stored-fallback
// rule, fpng.cpp:1744).
//
// What bounds it on the H100: bytes - the 4-byte desc read once and every
// word of the (B, num_words) output written once - with integer work close
// behind (a decode, a scan and a shift-and-OR a unit, and 32-bit integer
// operations issue at half the float rate).  The TPU carried the running
// bit offset through its sequential grid.  Here one launch does it all:
//   - A block takes one tile of kEncTile units from an atomic ticket (so a
//     tile only ever waits on tiles whose blocks are already running) and
//     issues all its 16-byte desc loads and its table loads at once.  Each
//     unit is decoded once in shared memory, the widths are scanned in the
//     block, and the tile's units are ORed into words of its own, in
//     shared memory, from the tile's first bit: a thread gathers its bits
//     in a 64-bit register and stores each word that fills.
//   - The running offset is a decoupled look-back over the tiles of the
//     image.  Its state (Run) is a bit count, the last 32 bits of the
//     stream so far and the offset of the last token start, so a tile
//     learns both where it starts and the bits of the word it starts in
//     that earlier tiles wrote.  A tile publishes its own run before it
//     builds its words, and its first look-back reads are in flight while
//     it builds them.  Runs are published as three 64-bit words that each
//     carry the status, so no fence orders data and flag.  All threads of
//     the block look back, one earlier tile each, 256 a round, so a single
//     long image (a 4K or larger raster) needs few rounds.
//   - Each word of the output is stored whole, once, with a plain store,
//     by the tile whose bit range holds its last bit (the image's last tile
//     also stores the partial word at the end); no global atomics.  Words
//     wholly below base_bits or past the end of the stream are zeroed under
//     the tickets after the last tile, so no zero fill runs before the
//     kernel.  A tile may hold no bits at all (the desc-0 units after a
//     match start); its range is empty, it stores nothing, and the state
//     passes through it.
// Bit offsets are int64 (a raster past 2^27 bytes has streams past 2^31
// bits), and so are the outputs total_bits and last_tok.  A unit holds at
// most 22 bits (code sizes up to 15, 7 extra bits), so a tile's words fit
// in kEncTile + 2 words of shared memory.

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kEncThreads = 256;
constexpr int kUnits = 16;                        // units a thread
constexpr int kEncTile = kEncThreads * kUnits;    // units a tile
constexpr int kEncTilePadded = kEncTile + kEncTile / 32;
constexpr int kChunks = kEncTile / 4 / kEncThreads + 1;  // int4 a thread
constexpr int kTblEntries = 512;  // sym is 9 bits; the table holds 1024
constexpr int kLocalWords = kEncTile + 2;  // a tile's words, 32 bits a unit
constexpr int kZeroWords = 8192;           // words a zeroing ticket covers
constexpr int kAgg = 1, kIncl = 2;
constexpr uint32_t kValMask = (1u << 27) - 1;  // a decoded unit's value
constexpr unsigned kFull = 0xffffffffu;

struct Unit {
  uint32_t val;
  int n;
  int ts;
};

__device__ __forceinline__ Unit decode_unit(int d, const int* tbl_s) {
  const int sym = d & 511;
  const int use_t = (d >> 9) & 1;
  const int en = (d >> 10) & 7;
  const uint32_t ev = (uint32_t)((d >> 13) & 0x1FFF);
  const int e = use_t ? tbl_s[sym] : 0;
  const int sz = e >> 16;
  Unit u;
  u.val = (uint32_t)(e & 0xFFFF) | (ev << sz);
  u.n = sz + en;
  u.ts = (d >> 26) & 1;
  return u;
}

// A run of units: n bits; tail = its last min(n, 32) bits (bit i of tail is
// bit n - min(n, 32) + i of the run); lt = the offset of its last token
// start from the run's start, -1 if it has none.
struct Run {
  long long n;
  long long lt;
  long long tail;  // 32 bits used; 64 keeps the struct 8-byte aligned
};

__device__ __forceinline__ Run identity_run() { return Run{0, -1, 0}; }

// The run l followed by the run r.
__device__ __forceinline__ Run combine(const Run& l, const Run& r) {
  Run o;
  o.n = l.n + r.n;
  o.lt = r.lt >= 0 ? l.n + r.lt : l.lt;
  if (r.n >= 32) {
    o.tail = r.tail;
  } else if (r.n == 0) {
    o.tail = l.tail;
  } else {
    const int kl = (int)min(l.n, 32LL);
    const int from_l = (int)min(o.n, 32LL) - (int)r.n;  // 0..31
    const uint32_t lt = (uint32_t)l.tail, rt = (uint32_t)r.tail;
    o.tail = (from_l ? lt >> (kl - from_l) : 0u) | (rt << from_l);
  }
  return o;
}

__device__ __forceinline__ Run shfl_down_run(const Run& r, int off) {
  Run o;
  o.n = __shfl_down_sync(kFull, r.n, off);
  o.lt = __shfl_down_sync(kFull, r.lt, off);
  o.tail = __shfl_down_sync(kFull, r.tail, off);
  return o;
}

// A published run: three 64-bit words, each carrying its status (kAgg or
// kIncl) in its top two bits.  Each word is stored once a launch with one
// 8-byte store, so a reader that sees the status in all three has the
// whole run: no fence between the data and a flag.  The slots start zeroed
// (no status).
struct Slot {
  unsigned long long n, lt, tail;
};

__device__ __forceinline__ void publish(Slot* s, const Run& r, int status) {
  const unsigned long long m = (unsigned long long)status << 62;
  volatile unsigned long long* v = &s->n;
  v[0] = (unsigned long long)r.n | m;
  v[1] = (unsigned long long)(r.lt + 1) | m;
  v[2] = (unsigned long long)(uint32_t)r.tail | m;
}

// The three words of slot s, read through to L2 each time.
__device__ __forceinline__ void load_slot(const Slot* s,
                                          unsigned long long w[3]) {
  const volatile unsigned long long* v = &s->n;
  w[0] = v[0];
  w[1] = v[1];
  w[2] = v[2];
}

// Whether the words w hold a run of `status`, and that run in r.
__device__ __forceinline__ bool check_slot(const unsigned long long w[3],
                                           int status, Run& r) {
  const unsigned long long m = (unsigned long long)status << 62;
  constexpr unsigned long long kLow = (1ull << 62) - 1;
  r = Run{(long long)(w[0] & kLow), (long long)(w[1] & kLow) - 1,
          (long long)(w[2] & kLow)};
  return (w[0] & ~kLow) == m && (w[1] & ~kLow) == m && (w[2] & ~kLow) == m;
}

// Spin until slot s holds a run of `status`, backing off so that waiting
// blocks do not crowd L2 with reads; a slot that never fills traps (an
// error on the host) instead of hanging the card.
__device__ __forceinline__ Run wait_slot(const Slot* s, int status) {
  const long long t0 = clock64();
  unsigned long long w[3];
  Run r;
  for (unsigned ns = 32;; ns = min(2 * ns, 512u)) {
    load_slot(s, w);
    if (check_slot(w, status, r)) return r;
    if (clock64() - t0 > (1ll << 34)) __trap();  // ~10 s
    __nanosleep(ns);
  }
}

struct Args {
  const int* desc;
  const int* tbl;
  const int* base_bits;
  int B, N, nblk, num_words;
  int tickets;         // tiles, then the zeroing tickets
  bool vec;            // desc is 16-byte aligned
  int* ticket;
  Slot* agg;           // a tile's own run (every tile writes one)
  Slot* incl;          // the image's run up to and including the tile
  uint32_t* words;
  long long* total_bits;
  long long* last_tok;
};

// A tile's desc and table in registers, every load issued before any is
// used: chunk c of the tile is the 16-byte aligned group of units
// 4c - a .. 4c - a + 3, a = the tile's first unit's place in its group.
struct Loaded {
  int4 q[kChunks];
  int2 tb;
};

__device__ __forceinline__ void load_tile(const Args& g, int t, Loaded& ld) {
  const int b = t / g.nblk, j = t - b * g.nblk;
  const long long g0 = (long long)b * g.N + (long long)j * kEncTile;
  const int a = (int)(g0 & 3);
  const long long total = (long long)g.B * g.N;
  const int len = (int)min((long long)kEncTile,
                           (long long)g.N - (long long)j * kEncTile);
  const int nch = (a + len + 3) >> 2;  // chunks that hold the tile
  const int* tb = g.tbl + (size_t)b * 1024 + 2 * threadIdx.x;
  ld.tb = make_int2(__ldg(tb), __ldg(tb + 1));
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kEncThreads;
    const long long e0 = g0 - a + 4 * c;
    if (c >= nch) {
      ld.q[i] = make_int4(0, 0, 0, 0);
    } else if (g.vec && e0 + 4 <= total) {
      ld.q[i] = __ldcs(reinterpret_cast<const int4*>(g.desc + e0));
    } else {
      int v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[r] = e0 + r < total ? __ldcs(g.desc + e0 + r) : 0;
      ld.q[i] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The loaded tile into shared memory: units past the image's end (the
// chunks also reach into the next image) become desc 0, a zero-width unit.
__device__ __forceinline__ void commit(const Args& g, int t, const Loaded& ld,
                                       int* d_s, int* tbl_s) {
  const int b = t / g.nblk, j = t - b * g.nblk;
  const long long g0 = (long long)b * g.N + (long long)j * kEncTile;
  const int a = (int)(g0 & 3);
  const int len = (int)min((long long)kEncTile,
                           (long long)g.N - (long long)j * kEncTile);
  reinterpret_cast<int2*>(tbl_s)[threadIdx.x] = ld.tb;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = threadIdx.x + i * kEncThreads;
    const int v[4] = {ld.q[i].x, ld.q[i].y, ld.q[i].z, ld.q[i].w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int u = 4 * c + r - a;
      if (u >= 0 && u < kEncTile) d_s[pad(u)] = u < len ? v[r] : 0;
    }
  }
}

// Zeroing ticket z: words [lo, hi) of one image that lie below base_bits
// or past the end of the stream; the image's last tile holds the end.
__device__ __forceinline__ void zero_words(const Args& g, int z,
                                           long long* end_s) {
  const int zblk = (g.num_words + kZeroWords - 1) / kZeroWords;
  const int b = z / zblk;
  const int lo = (z - b * zblk) * kZeroWords;
  const int hi = min(lo + kZeroWords, g.num_words);
  if (threadIdx.x == 0)
    *end_s = (wait_slot(g.incl + (size_t)b * g.nblk + g.nblk - 1, kIncl).n +
              31) >> 5;
  __syncthreads();
  const long long head = g.base_bits[b] >> 5, tail = *end_s;
  uint32_t* w = g.words + (size_t)b * g.num_words;
  const bool vec = ((uintptr_t)w & 15) == 0;
  for (int i = lo + 4 * threadIdx.x; i < hi; i += 4 * kEncThreads) {
    if (vec && i + 4 <= hi && (i + 3 < head || i >= tail)) {
      *reinterpret_cast<uint4*>(w + i) = make_uint4(0, 0, 0, 0);
    } else {
      for (int q = i; q < min(i + 4, hi); ++q)
        if (q < head || q >= tail) w[q] = 0;
    }
  }
}

struct Shared {
  int tbl[kTblEntries];
  int d[kEncTilePadded];  // desc, then value | width << 27
  uint32_t w[kLocalWords];
  int red[32];
  Run warp_run[kEncThreads / 32];
  Run pre;
  long long end;
  int next;  // the block's ticket
  int nearest;
  uint32_t tail;  // the tile's last min(n, 32) bits
};

// One tile: decode, scan, deposit into shared memory, publish, look back,
// store the words.  d and tbl hold the tile; every thread calls.
__device__ void do_tile(const Args& g, int t, Shared& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = t / g.nblk, j = t - b * g.nblk;

  // 1. each unit decoded once and written back over its desc as value |
  // width << 27 (read again below rather than kept in registers); the
  // thread's bits and last token start, then offsets by a block scan
  int s = 0, lt_rel = -1;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    const int i = pad(tid * kUnits + k);
    const Unit u = decode_unit(sm.d[i], sm.tbl);
    if (u.ts) lt_rel = s;
    sm.d[i] = (int)(u.val | (uint32_t)u.n << 27);
    s += u.n;
  }
  int n_tile;
  const int off = block_incl_scan<kEncThreads>(s, sm.red, n_tile) - s;

  // 2. the tile's run, published before its words are built, so that the
  // tiles after it wait less: its last min(n, 32) bits come from the
  // threads whose units reach into them
  const int win = n_tile - min(n_tile, 32);
  if (s > 0 && off + s > win) {
    int o = off;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const uint32_t x = (uint32_t)sm.d[pad(tid * kUnits + k)];
      const uint32_t v = x & kValMask;
      const int n = (int)(x >> 27);
      if (n > 0 && o + n > win)
        atomicOr(&sm.tail, o >= win ? v << (o - win) : v >> (win - o));
      o += n;
    }
  }
  const int lt =
      block_max<kEncThreads>(lt_rel >= 0 ? off + lt_rel : -1, sm.red);
  const Run mine{n_tile, lt, sm.tail};
  if (tid == 0) {
    publish(g.agg + t, mine, kAgg);
    if (j == 0) {
      sm.pre = Run{g.base_bits[b], -1, 0};
      publish(g.incl + t, combine(sm.pre, mine), kIncl);
    }
  }
  // the look-back's first reads are in flight while the words are built
  const int p0 = j - 1 - tid;
  unsigned long long wi[3], wa[3];
  if (j > 0) {
    const size_t tp = (size_t)b * g.nblk + max(p0, 0);
    load_slot(g.incl + tp, wi);
    load_slot(g.agg + tp, wa);
  }

  // 3. the tile's words in shared memory, from the tile's first bit: the
  // thread's bits gather in a 64-bit register from the start of its first
  // word, and each word that fills goes out.  Words strictly inside the
  // thread's bit range are its own (a plain store); its first and last
  // may hold bits of the threads before and after it (an OR).
  {
    int o = off;
    const int w_first = off >> 5;
    int cw = w_first;
    unsigned long long acc = 0;
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const uint32_t x = (uint32_t)sm.d[pad(tid * kUnits + k)];
      acc |= (unsigned long long)(x & kValMask) << (o - 32 * cw);  // < 32
      o += (int)(x >> 27);
      if (o - 32 * cw >= 32) {  // at most once: a unit holds <= 22 bits
        if (cw < kLocalWords) {
          if (cw == w_first)
            atomicOr(sm.w + cw, (uint32_t)acc);
          else
            sm.w[cw] = (uint32_t)acc;
        }
        acc >>= 32;
        ++cw;
      }
    }
    if ((uint32_t)acc != 0 && cw < kLocalWords)
      atomicOr(sm.w + cw, (uint32_t)acc);
  }

  // 4. decoupled look-back: thread d looks at tile q - d, 256 a round.
  // The nearest inclusive run in the round ends it; the tiles after it
  // need only have published their aggregates.  A look-back that finds no
  // inclusive run folds every aggregate down to tile 0 and then base_bits.
  // The runs fold in order, the older first.
  if (j > 0) {
    Run run = identity_run();
    bool found = false;
    for (int q = j - 1; q >= 0 && !found; q -= kEncThreads) {
      const int p = q - tid;
      const size_t tp = (size_t)b * g.nblk + max(p, 0);
      if (q != j - 1) {  // both slots in one round trip
        load_slot(g.incl + tp, wi);
        load_slot(g.agg + tp, wa);
      }
      Run x, y;
      const bool inc = p >= 0 && check_slot(wi, kIncl, x);
      const bool agg = p >= 0 && check_slot(wa, kAgg, y);
      if (tid == 0) sm.nearest = kEncThreads;
      __syncthreads();
      if (inc) atomicMin(&sm.nearest, tid);
      __syncthreads();
      const int m = sm.nearest;
      if (p < 0 || tid > m)
        x = identity_run();
      else if (tid < m)
        x = agg ? y : wait_slot(g.agg + tp, kAgg);
      for (int o = 1; o < 32; o <<= 1) {  // lane i: lanes i .. i + 2o - 1
        const Run y = shfl_down_run(x, o);
        if (lane + o < 32) x = combine(y, x);
      }
      if (lane == 0) sm.warp_run[warp] = x;
      __syncthreads();
      if (tid == 0) {
        Run r = sm.warp_run[kEncThreads / 32 - 1];
        for (int w = kEncThreads / 32 - 2; w >= 0; --w)
          r = combine(r, sm.warp_run[w]);
        run = combine(r, run);
      }
      found = m < kEncThreads;
      __syncthreads();  // warp_run and nearest are rewritten next round
    }
    if (tid == 0) {
      if (!found) run = combine(Run{g.base_bits[b], -1, 0}, run);
      publish(g.incl + t, combine(run, mine), kIncl);
      sm.pre = run;
    }
  }
  __syncthreads();

  // 5. the words whose last bit lies in the tile's range [s, e), whole and
  // once each, shifted to the tile's offset in the word; the last tile
  // also stores the stream's partial last word and the image's outputs
  const Run pre = sm.pre;
  const long long s0 = pre.n, e0 = s0 + n_tile;
  const int sh = (int)(s0 & 31);
  const uint32_t pb =
      sh ? (uint32_t)pre.tail >> ((int)min(s0, 32LL) - sh) : 0u;
  const bool last = j == g.nblk - 1;
  const long long w0 = s0 >> 5;
  const int kmax = (int)((e0 >> 5) - w0) + (last && (e0 & 31) ? 1 : 0);
  uint32_t* w = g.words + (size_t)b * g.num_words;
  for (int k = tid; k < kmax && w0 + k < g.num_words; k += kEncThreads) {
    const uint32_t cur = k < kLocalWords ? sm.w[k] : 0u;
    uint32_t v = cur;
    if (sh) {
      const uint32_t prev = k == 0 ? pb
                            : (k - 1 < kLocalWords ? sm.w[k - 1] : 0u) >>
                                  (32 - sh);
      v = (cur << sh) | prev;
    }
    w[w0 + k] = v;
  }
  if (last && tid == 0) {
    g.total_bits[b] = e0;
    const long long l = lt >= 0 ? s0 + lt : pre.lt;  // last token start
    g.last_tok[b] = l < 0 ? -1 : l;
  }
}

// at most 64 registers, so that 4 blocks fit on an SM
__global__ void __launch_bounds__(kEncThreads, 4)
encfuse_kernel(Args g) {
  __shared__ Shared sm;
  const int tiles = g.B * g.nblk;
  if (threadIdx.x == 0) sm.next = atomicAdd(g.ticket, 1);
  __syncthreads();
  const int t = sm.next;
  if (t >= tiles) {
    zero_words(g, t - tiles, &sm.end);
    return;
  }
  Loaded ld;
  load_tile(g, t, ld);  // in flight while the words clear
  for (int i = threadIdx.x; i < kLocalWords; i += kEncThreads) sm.w[i] = 0;
  if (threadIdx.x == 0) sm.tail = 0;
  commit(g, t, ld, sm.d, sm.tbl);
  __syncthreads();
  do_tile(g, t, sm);
}

}  // namespace
}  // namespace fpng

// desc (B, N), tbl (B, 1024) packed code | size << 16, base_bits (B,)
// -> words (B, num_words), every word written, total_bits (B,) and
// last_tok (B,) int64.  scratch: the ticket (16 bytes), then an aggregate and an
// inclusive slot a tile (ops/encfuse.py:_scratch_bytes), zeroed here.  One
// memset of the scratch, one launch of a block a ticket.
extern "C" int fpng_encfuse(const int* desc, const int* tbl,
                            const int* base_bits, int B, int N, int num_words,
                            int* words, long long* total_bits,
                            long long* last_tok, void* scratch,
                            void* stream) {
  using namespace fpng;
  if (B <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  Args g;
  g.desc = desc;
  g.tbl = tbl;
  g.base_bits = base_bits;
  g.B = B;
  g.N = N;
  g.nblk = N > 0 ? (N + kEncTile - 1) / kEncTile : 1;
  g.num_words = num_words;
  const long long tiles = (long long)B * g.nblk;
  const long long zblk = (num_words + kZeroWords - 1) / kZeroWords;
  g.tickets = (int)(tiles + B * zblk);
  g.vec = ((uintptr_t)desc & 15) == 0;
  uint8_t* base = (uint8_t*)scratch;
  g.ticket = (int*)base;
  g.agg = (Slot*)(base + 16);
  g.incl = g.agg + tiles;
  g.words = (uint32_t*)words;
  g.total_bits = total_bits;
  g.last_tok = last_tok;
  cudaError_t err =
      cudaMemsetAsync(base, 0, 16 + 2 * tiles * sizeof(Slot), st);
  if (err != cudaSuccess) return (int)err;
  encfuse_kernel<<<g.tickets, kEncThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}
