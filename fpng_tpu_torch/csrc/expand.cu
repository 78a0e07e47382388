// B6: 16-bit-slot literal raster -> pixels (RLE fill, Up defilter, bytes).
//
// Replaces fpng_tpu/ops/specdec_tpu.py:expand_tpu (Pallas kernel
// _make_expand_kernel).  The TPU ran a log-step forward-fill scan on
// (8, bpl_pad/2) word tiles with rows padded to 256 slots; here the raster
// is unpadded (h rows of bpl = w*c slots) and the work is one launch that
// reads each slot once and writes each output byte once.
//
// A slot is value | literal << 8; its other bits are ignored.  Within a row
// a match slot takes the last literal at or before it at the same position
// mod c (a slot with none keeps its own low byte); every row but the first
// is Up filtered, so a pixel byte is the column's sum of filled bytes down
// to its row, mod 256.
//
// Tiles and the carries between them.  A block owns a band of R rows of one
// image and walks the band's strips of S slots left to right (one strip
// when bpl <= 4096).  For a strip it
//   1. loads the R x S slots into shared memory (16-byte loads where the
//      rows allow);
//   2. fills them: each thread takes a run of consecutive slots, a
//      block-wide segmented scan carries "last literal per residue mod c"
//      (c <= 4 bytes plus valid bits) between runs, row starts reset it to
//      the row's carry out of the previous strip;
//   3. sums each column down the band in shared memory (4 bytes a word,
//      byte-wise mod 256); the last row is the band's aggregate;
//   4. gets the sum of the bands above by decoupled look-back: it publishes
//      its aggregate and a flag, then reads back 32 bands a round (a lane
//      of warp 0 waits on each band's flag), adding aggregates until it
//      meets a band that has published its inclusive sum; then it publishes
//      its own inclusive sum;
//   5. writes the band's pixel bytes: its own column sums plus that prefix.
// Bands are taken in order from an atomic ticket, so a band only ever waits
// on a band whose block is already running: no block waits on one that is
// not resident.  The scratch (ticket, flags, aggregates, inclusive sums) is
// laid out by the wrapper (ops/expand.py); the entry point zeroes the
// ticket and the flags before the launch.
//
// What bounds it on the H100: bytes - 2 read and 1 written per slot; the
// look-back adds 2 bytes written and at least 1 read per column of a band
// (1/R of the raster).

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kExpThreads = 256;
constexpr int kTileSlots = 12288;  // R * S_pad at most
constexpr int kStripMax = 4096;    // S at most
constexpr int kRowsMax = 256;      // R at most
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAgg = 1, kIncl = 2;

// Fill state: byte k of `val` is the last literal of residue k, valid where
// bit 32 + k is set; bit 36 marks a run that contains a row start, which
// cuts off whatever came before it.
typedef unsigned long long State;
constexpr State kReset = 1ull << 36;

__device__ __forceinline__ State combine(State l, State r) {
  if (r & kReset) return r;
  const uint32_t vm = (uint32_t)(r >> 32) & 0xF;
  const uint32_t bytes = (vm & 1 ? 0xFFu : 0u) | (vm & 2 ? 0xFF00u : 0u) |
                         (vm & 4 ? 0xFF0000u : 0u) |
                         (vm & 8 ? 0xFF000000u : 0u);
  const uint32_t val = ((uint32_t)r & bytes) | ((uint32_t)l & ~bytes);
  const uint32_t mask = (((uint32_t)(l >> 32) | vm) & 0xF) |
                        ((uint32_t)(l >> 32) & 0x10);
  return ((State)mask << 32) | val;
}

__device__ __forceinline__ State put_literal(State s, int k, uint32_t v) {
  const uint32_t sh = 8 * k;
  const uint32_t val = ((uint32_t)s & ~(0xFFu << sh)) | (v << sh);
  return (s & ~0xFFFFFFFFull) | (1ull << (32 + k)) | val;
}

// Byte-wise a + b mod 256 on four bytes a word.
__device__ __forceinline__ uint32_t add4(uint32_t a, uint32_t b) {
  return ((a & 0x7F7F7F7Fu) + (b & 0x7F7F7F7Fu)) ^ ((a ^ b) & 0x80808080u);
}

struct Geometry {
  int B, h, bpl, c, R, S, S_pad, nS, nbands;
  bool vec_in, vec_out;  // 16-byte loads / stores
};

__global__ void __launch_bounds__(kExpThreads)
expand_kernel(const uint16_t* __restrict__ raster, Geometry g,
              int* __restrict__ ticket, int* __restrict__ flags,
              uint8_t* __restrict__ agg, uint8_t* __restrict__ incl,
              uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint16_t slots[kTileSlots];
  __shared__ __align__(16) uint8_t bytes[kTileSlots];
  __shared__ __align__(16) uint32_t pre[kStripMax / 4];
  __shared__ State carry[2][kRowsMax];
  __shared__ State warp_tot[kExpThreads / 32];
  __shared__ int sh_int;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh_int = atomicAdd(ticket, 1);
  __syncthreads();
  const int t = sh_int;
  const int b = t / g.nbands, j = t - b * g.nbands;
  const int row0 = j * g.R;
  const int R = min(g.R, g.h - row0);
  const int W4 = g.S_pad / 4;

  for (int s = 0; s < g.nS; ++s) {
    const int x0 = s * g.S;
    const int Ss = min(g.S, g.bpl - x0);
    const int n = R * Ss;
    const size_t row_base = ((size_t)b * g.h + row0) * g.bpl + x0;

    // 1. the tile's slots into shared memory
    if (g.vec_in) {
      const int per_row = Ss / 8;
      for (int i = tid; i < R * per_row; i += kExpThreads) {
        const int r = i / per_row, v = i - r * per_row;
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(
            raster + row_base + (size_t)r * g.bpl) + v);
        *reinterpret_cast<uint4*>(slots + r * g.S_pad + 8 * v) = q;
      }
    } else {
      for (int i = tid; i < n; i += kExpThreads) {
        const int r = i / Ss, x = i - r * Ss;
        slots[r * g.S_pad + x] =
            __ldg(raster + row_base + (size_t)r * g.bpl + x);
      }
    }
    __syncthreads();

    // 2. the fill: each thread's run [lo, hi) of the tile's slots in row
    // order, a segmented scan of the runs' last literals, then the run again
    // (an odd run length spreads a warp's shared-memory reads over the
    // banks; the last runs may be empty)
    const int per = ((n + kExpThreads - 1) / kExpThreads) | 1;
    const int lo = min(tid * per, n), hi = min(lo + per, n);
    const State* cin = carry[s & 1];
    State* cout = carry[(s & 1) ^ 1];
    // the run's summary, read backwards from its end: each residue's last
    // literal, until every residue has one or the last row start is met
    State sum = 0;
    if (lo < hi) {
      int r = (hi - 1) / Ss, x = hi - 1 - r * Ss, k = (x0 + x) % g.c;
      const int all = (1 << g.c) - 1;
      int found = 0;
      for (;;) {
        const uint32_t v = slots[r * g.S_pad + x];
        if ((v & 0x100u) && !(found >> k & 1)) {
          sum = put_literal(sum, k, v & 0xFFu);
          found |= 1 << k;
        }
        if (x == 0 || found == all || r * Ss + x == lo) break;
        --x;
        if (--k < 0) k = g.c - 1;
      }
      if (x == 0 && found != all && s) {  // the rest from the row's carry
        const State cr = cin[r];
        for (int q = 0; q < g.c; ++q)
          if (!(found >> q & 1) && (cr >> (32 + q) & 1ull))
            sum = put_literal(sum, q, (uint32_t)(cr >> (8 * q)) & 0xFFu);
      }
      // a run that holds a row start cuts off what came before it
      if (lo % Ss == 0 || (hi - 1) / Ss != lo / Ss) sum |= kReset;
    }
    State inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const State u = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc = combine(u, inc);
    }
    if (lane == 31) warp_tot[warp] = inc;
    State st = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) st = 0;
    __syncthreads();
    State wpre = 0;
    for (int q = 0; q < warp; ++q) wpre = combine(wpre, warp_tot[q]);
    st = combine(wpre, st);
    int r = lo / Ss, x = lo - r * Ss, k = (x0 + x) % g.c;
    for (int i = lo; i < hi; ++i) {
      if (x == 0) st = (s ? cin[r] : 0ull) | kReset;
      const uint32_t v = slots[r * g.S_pad + x];
      if (v & 0x100u) st = put_literal(st, k, v & 0xFFu);
      bytes[r * g.S_pad + x] = (st >> (32 + k)) & 1ull
                                   ? (uint8_t)(st >> (8 * k))
                                   : (uint8_t)v;
      if (++x == Ss) {
        cout[r] = st & ~kReset;
        x = 0; ++r; k = x0 % g.c;
      } else if (++k == g.c) {
        k = 0;
      }
    }
    __syncthreads();

    // 3. column sums down the band; the last row is the aggregate
    uint32_t* b32 = reinterpret_cast<uint32_t*>(bytes);
    const int nw = (Ss + 3) / 4;
    for (int w = tid; w < nw; w += kExpThreads) {
      uint32_t acc = 0;
      for (int rr = 0; rr < R; ++rr) {
        acc = add4(acc, b32[rr * W4 + w]);
        b32[rr * W4 + w] = acc;
      }
    }
    __syncthreads();

    // 4. decoupled look-back over the bands above, strip s
    const size_t tile = ((size_t)b * g.nbands + j) * g.nS + s;
    const uint32_t* mine = b32 + (R - 1) * W4;
    uint32_t* agg32 = reinterpret_cast<uint32_t*>(agg + tile * g.S_pad);
    uint32_t* incl32 = reinterpret_cast<uint32_t*>(incl + tile * g.S_pad);
    for (int w = tid; w < nw; w += kExpThreads) {
      pre[w] = 0;
      (j == 0 ? incl32 : agg32)[w] = mine[w];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicExch(flags + tile, j == 0 ? kIncl : kAgg);
    // 32 bands a round: lane d of warp 0 waits for band q - d to publish,
    // and the round adds the bands down to the nearest inclusive sum (band
    // 0 always publishes one), or all 32 aggregates
    for (int q = j - 1; q >= 0; q -= 32) {
      if (warp == 0) {
        int f = 0;
        if (q - lane >= 0) {
          const int* fl = flags + tile - (size_t)(j - q + lane) * g.nS;
          while ((f = *(volatile const int*)fl) == 0) {
          }
        }
        const unsigned inc = __ballot_sync(kFull, f == kIncl);
        if (lane == 0) sh_int = inc ? (__ffs(inc) - 1) | 0x100 : 31;
      }
      __syncthreads();
      const int m = sh_int & 0xFF;
      const bool found = sh_int & 0x100;
      __threadfence();
      for (int d = 0; d <= m; ++d) {
        const size_t up = tile - (size_t)(j - q + d) * g.nS;
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            (found && d == m ? incl : agg) + up * g.S_pad);
        for (int w = tid; w < nw; w += kExpThreads)
          pre[w] = add4(pre[w], __ldcg(src + w));
      }
      __syncthreads();
      if (found) {
        for (int w = tid; w < nw; w += kExpThreads)
          incl32[w] = add4(pre[w], mine[w]);
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicExch(flags + tile, kIncl);
        break;
      }
    }

    // 5. the band's bytes: its column sums plus the bands above
    const uint8_t* pre8 = reinterpret_cast<const uint8_t*>(pre);
    if (g.vec_out) {
      const int per_row = Ss / 16;
      for (int i = tid; i < R * per_row; i += kExpThreads) {
        const int rr = i / per_row, v = i - rr * per_row;
        uint4 q =
            *reinterpret_cast<const uint4*>(bytes + rr * g.S_pad + 16 * v);
        const uint4 p = *reinterpret_cast<const uint4*>(pre8 + 16 * v);
        q.x = add4(q.x, p.x); q.y = add4(q.y, p.y);
        q.z = add4(q.z, p.z); q.w = add4(q.w, p.w);
        uint4* dst =
            reinterpret_cast<uint4*>(out + row_base + (size_t)rr * g.bpl);
        dst[v] = q;
      }
    } else {
      for (int i = tid; i < n; i += kExpThreads) {
        const int rr = i / Ss, xx = i - rr * Ss;
        out[row_base + (size_t)rr * g.bpl + xx] =
            (uint8_t)(bytes[rr * g.S_pad + xx] + pre8[xx]);
      }
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace fpng

// raster (B, h*w*c) int16 slots -> out (B, h, w, c) uint8.  rows (R), strip
// (S, a multiple of 16 when it is less than w*c) and bands (ceil(h / R))
// are the wrapper's tiling; scratch holds the ticket and flags (zeroed here)
// then the aggregates and inclusive sums (ops/expand.py:_scratch_layout).
extern "C" int fpng_expand(const short* raster, int B, int h, int w, int c,
                           int rows, int strip, int bands, void* scratch,
                           unsigned char* out, void* stream) {
  using namespace fpng;
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  if (c < 1 || c > 4 || rows < 1 || rows > kRowsMax || strip < 1 ||
      strip > kStripMax)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.B = B; g.h = h; g.bpl = w * c; g.c = c; g.R = rows; g.S = strip;
  g.S_pad = (strip + 15) / 16 * 16;
  g.nS = (g.bpl + strip - 1) / strip;
  g.nbands = bands;
  if (rows * g.S_pad > kTileSlots) return (int)cudaErrorInvalidValue;
  g.vec_in = g.bpl % 8 == 0 && strip % 8 == 0 &&
             ((uintptr_t)raster & 15) == 0;
  g.vec_out = g.bpl % 16 == 0 && strip % 16 == 0 &&
              ((uintptr_t)out & 15) == 0;
  const size_t tiles = (size_t)B * bands * g.nS;
  const size_t head = (4 + tiles * 4 + 15) / 16 * 16;
  uint8_t* base = (uint8_t*)scratch;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(base, 0, head, st);
  if (err != cudaSuccess) return (int)err;
  expand_kernel<<<(unsigned)((size_t)B * bands), kExpThreads, 0, st>>>(
      (const uint16_t*)raster, g, (int*)base, (int*)(base + 4), base + head,
      base + head + tiles * g.S_pad, out);
  return (int)cudaGetLastError();
}
