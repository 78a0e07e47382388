// B6: 16-bit-slot literal raster -> pixels (RLE fill, Up defilter, bytes).
//
// Replaces fpng_tpu/ops/specdec_tpu.py:expand_tpu (Pallas kernel
// _make_expand_kernel).  The TPU ran a log-step forward-fill scan on
// (8, bpl_pad/2) word tiles with rows padded to 256 slots; here the raster
// is unpadded (h rows of bpl = w*c slots) and the work is two launches:
//
//   fill      one thread per (image, row, residue mod c) walks its row at
//             stride c, replacing every non-literal slot by the last
//             literal before it (a slot with none keeps its own low byte),
//             and writes the bytes into the output;
//   defilter  one thread per (image, column byte) adds down the rows, mod
//             256, in place (every row but the first is Up filtered).
//
// A slot is value | literal << 8; its other bits are ignored.
//
// What bounds it on the H100: bytes (2 read and 1 written per slot, plus
// the defilter's read and write of the output); neither launch is tuned.

#include "common.cuh"

namespace fpng {
namespace {

constexpr int kExpThreads = 256;

__global__ void __launch_bounds__(kExpThreads)
fill_kernel(const uint16_t* __restrict__ raster, long long rows_x_c, int w,
            int c, uint8_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kExpThreads + threadIdx.x;
  if (t >= rows_x_c) return;
  const long long row = t / c;
  const int k = (int)(t - row * c);
  const size_t base = (size_t)row * w * c + k;
  int cur = -1;
  for (int x = 0; x < w; ++x) {
    const uint32_t s = raster[base + (size_t)x * c];
    if (s & 0x100) cur = (int)(s & 0xFF);
    out[base + (size_t)x * c] = (uint8_t)(cur >= 0 ? cur : (int)(s & 0xFF));
  }
}

__global__ void __launch_bounds__(kExpThreads)
defilter_kernel(uint8_t* __restrict__ out, long long cols, int h, int bpl) {
  const long long t = (long long)blockIdx.x * kExpThreads + threadIdx.x;
  if (t >= cols) return;
  const long long b = t / bpl;
  uint8_t* p = out + (size_t)b * h * bpl + (size_t)(t - b * bpl);
  uint32_t acc = 0;
  for (int r = 0; r < h; ++r) {
    acc = (acc + p[(size_t)r * bpl]) & 0xFF;
    p[(size_t)r * bpl] = (uint8_t)acc;
  }
}

}  // namespace
}  // namespace fpng

// raster (B, h*w*c) int16 slots -> out (B, h, w, c) uint8.
extern "C" int fpng_expand(const short* raster, int B, int h, int w, int c,
                           unsigned char* out, void* stream) {
  using namespace fpng;
  if (B <= 0 || h <= 0 || w <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows_x_c = (long long)B * h * c;
  fill_kernel<<<(unsigned)((rows_x_c + kExpThreads - 1) / kExpThreads),
                kExpThreads, 0, st>>>((const uint16_t*)raster, rows_x_c, w,
                                      c, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cols = (long long)B * w * c;
  defilter_kernel<<<(unsigned)((cols + kExpThreads - 1) / kExpThreads),
                    kExpThreads, 0, st>>>(out, cols, h, w * c);
  return (int)cudaGetLastError();
}
