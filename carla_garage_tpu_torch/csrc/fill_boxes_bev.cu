// Oriented-box rasterization into the BEV class grid, for Hopper.
//
// Replaces the Pallas TPU kernel carla_garage_tpu/ops/pallas/bev_fill.py
// fill_boxes_bev (_fill_kernel). Every pixel (col = x, row = y, in grid
// pixels) of an episode's [h,w] uint8 map gets the class of the LAST valid
// box whose oriented rectangle holds it (inclusive test |lx| <= ex,
// |ly| <= ey), or 0 where no valid box does. Box fields, per episode and
// box: cx, cy, cos, sin, ex, ey, cls, valid.
//
// What bounds it on an H100: writing the map. A pixel-box test is 8
// floating-point operations (two subtractions, the rotation's four
// multiplies and two adds), but only a box's footprint on the grid needs
// testing, and at the training shape most boxes (stops, lights and traffic
// of the whole town) lie off the 64 m window: about 1.6e4 tests against
// the 1 MB map, about 0.34 us at 3.35 TB/s.
//
// Design: tiles of 64 x 16 pixels, grid (tiles, B), 256 threads a block,
// each thread four neighbouring pixels of a row, stored as one 4-byte word
// where the row allows (w a multiple of 4 and all four pixels inside).
//  1. Staging, once per block: each thread takes a box, and a valid box
//     whose footprint meets the tile is kept. The survivors are compacted
//     into dynamic shared memory in ascending box order (a ballot and popc
//     prefix within each warp, then the warp counts in order), as two
//     16-byte records: cx, cy, cos, sin and ex, ey, cls, -sin.
//  2. Per pixel: the survivors from the last to the first with the
//     unchanged exact test (dx, dy; lx = c*dx + s*dy; ly = (-s)*dx + c*dy,
//     the TPU kernel's order), stopping at the first that holds the pixel,
//     so the later box wins as in the plain version. A tile with no
//     survivor writes zeros. Built with -fmad=false, no multiply-add is
//     contracted: the map equals the plain PyTorch version bit for bit.
//     h, w and V need not be multiples of anything: edge tiles are masked.
//
// The footprint cull. With k^2 = cos^2 + sin^2, M the rotation by
// (cos, sin) (|M v| = k |v|), u = 2^-24 and R = |(ex, ey)|: fp32 rounding of
// dx, dy, the products and the sum puts the test's lx within 3u (|c| |dx| +
// |s| |dy|) <= 3u k |p - c| of (M(p - c))_x, and likewise ly, so a pixel p
// the test accepts lies within about R / k of the centre and within
// (|c| |ex| + |s| |ey|) / k^2 + 4.3u R / k of cx in x (p - c =
// M^T M(p - c) / k^2), likewise in y. The kept half-sizes are
//   ax = ((|c| |ex| + |s| |ey|) * (1 + 1e-5) + 1e-5 (|ex| + |ey|)) / k^2 + 1,
//   ay = ((|s| |ex| + |c| |ey|) * (1 + 1e-5) + 1e-5 (|ex| + |ey|)) / k^2 + 1
// pixels (no cull unless 0.5 <= k^2 <= 2). The 1e-5 terms take 25x the
// 4.3u R / k and the rounding of ax itself. The whole pixel covers the
// rounding of cx - ax against the tile's pixel range: where the exact
// value is at most col - 1 and above -2^23, its float is below col, and
// below -2^23 it is negative. So no accepted pixel's box is dropped, at any
// finite coordinates on grids under 2^23 pixels a side. A box is dropped
// only when cx - ax > last column, cx + ax < first column, or the same in
// rows, so a NaN drops nothing. ops/bev_fill.py fill_tile_candidates_plain
// is this predicate in plain fp32; the CPU tests hold it against the exact
// test.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 64;            // columns of a tile: 16 threads x 4
constexpr int kTileH = kThreads * 4 / kTileW;
constexpr float kGrow = 1.00001f;     // the footprint's margins, above
constexpr float kRel = 1e-5f;

__global__ void __launch_bounds__(kThreads)
fill_kernel(const float* __restrict__ boxes,  // [B,V,8]
            uint8_t* __restrict__ out,        // [B,h,w]
            int h, int w, int v) {
  extern __shared__ float4 staged[];   // 2 per survivor
  __shared__ int warp_count[kWarps];
  const int b = blockIdx.y;
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const int y0 = (blockIdx.x / tiles_x) * kTileH;
  const float first_col = static_cast<float>(x0);
  const float last_col = static_cast<float>(min(x0 + kTileW, w) - 1);
  const float first_row = static_cast<float>(y0);
  const float last_row = static_cast<float>(min(y0 + kTileH, h) - 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* src = boxes + static_cast<size_t>(b) * v * kFields;
  int n = 0;
  for (int base = 0; base < v; base += kThreads) {
    const int k = base + threadIdx.x;
    const float* bx = src + static_cast<size_t>(k) * kFields;
    bool keep = k < v && bx[7] > 0.0f;
    float cx = 0.0f, cy = 0.0f, c = 0.0f, s = 0.0f, ex = 0.0f, ey = 0.0f;
    if (keep) {
      cx = bx[0], cy = bx[1], c = bx[2], s = bx[3], ex = bx[4], ey = bx[5];
      const float kk = c * c + s * s;
      if (kk >= 0.5f && kk <= 2.0f) {
        const float ac = fabsf(c), as = fabsf(s);
        const float aex = fabsf(ex), aey = fabsf(ey);
        const float slack = kRel * (aex + aey);
        const float ax = ((ac * aex + as * aey) * kGrow + slack) / kk + 1.0f;
        const float ay = ((as * aex + ac * aey) * kGrow + slack) / kk + 1.0f;
        keep = !(cx - ax > last_col || cx + ax < first_col ||
                 cy - ay > last_row || cy + ay < first_row);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = n, chunk = 0;
    for (int i = 0; i < kWarps; ++i) {
      if (i < warp) slot += warp_count[i];
      chunk += warp_count[i];
    }
    if (keep) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      staged[2 * slot] = make_float4(cx, cy, c, s);
      staged[2 * slot + 1] = make_float4(ex, ey, bx[6], -s);
    }
    n += chunk;
    __syncthreads();   // warp_count is rewritten by the next chunk
  }

  const int row = y0 + threadIdx.x / (kTileW / 4);
  const int col0 = x0 + 4 * (threadIdx.x % (kTileW / 4));
  if (row >= h || col0 >= w) return;
  const float fy = static_cast<float>(row);
  uint8_t cls[4] = {0, 0, 0, 0};
  unsigned open = 0xfu;   // pixels no box holds yet
  for (int k = n - 1; k >= 0 && open; --k) {
    const float4 p = staged[2 * k];
    const float4 e = staged[2 * k + 1];
    const float dy = fy - p.y;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(open >> j & 1u)) continue;
      const float dx = static_cast<float>(col0 + j) - p.x;
      const float lx = p.z * dx + p.w * dy;
      const float ly = e.w * dx + p.z * dy;
      if (fabsf(lx) <= e.x && fabsf(ly) <= e.y) {
        cls[j] = static_cast<uint8_t>(static_cast<int32_t>(e.z));
        open &= ~(1u << j);
      }
    }
  }
  uint8_t* dst = out + (static_cast<size_t>(b) * h + row) * w + col0;
  if ((w & 3) == 0) {   // col0 + 3 < w, and the word is 4-byte aligned
    *reinterpret_cast<uchar4*>(dst) = make_uchar4(cls[0], cls[1], cls[2],
                                                  cls[3]);
  } else {
    for (int j = 0; j < 4 && col0 + j < w; ++j) dst[j] = cls[j];
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
extern "C" int fill_boxes_bev_launch(const float* boxes, uint8_t* out,
                                     int batch, int h, int w, int v,
                                     void* stream) {
  const size_t smem = static_cast<size_t>(v) * 2 * sizeof(float4);
  if (smem > 47 * 1024) {   // 48 KB less the static warp counts
    const cudaError_t err = cudaFuncSetAttribute(
        fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = ((w + kTileW - 1) / kTileW) * ((h + kTileH - 1) / kTileH);
  const dim3 grid(tiles, batch);
  fill_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, out, h, w, v);
  return static_cast<int>(cudaGetLastError());
}
