// Ray vs box-set intersection for camera and LiDAR rendering, for Hopper.
//
// Replaces the Pallas TPU kernel carla_garage_tpu/ops/pallas/raycast.py
// raycast_boxes (_ray_box_kernel). For every ray of an episode it finds the
// nearest slab hit against that episode's K upright oriented boxes standing
// on z = 0 (fields cx, cy, cos, sin, ex, ey, ez, cls, valid). A box wins
// only when strictly nearer (t_hit < t_best), so on a tie the earlier box
// wins; a ray that starts inside a box hits at the exit; 1e9 marks a miss.
//
// What bounds it on an H100: the bytes. A ray moves 20 bytes (12 in, 8
// out); a ray-box test is 30 floating-point operations, but a ray needs it
// only for the boxes whose footprint its planar half-line meets, a few of
// the 48 (ops/raycast.py raycast_boxes_cost counts them). The kernel of the
// first port tested every ray against every box slot, recomputing the
// box's terms each time: instruction issue, not the flop rate, set its time.
//
// Design: one thread per ray, blocks of 256 rays, grid (ceil(N/256), B).
//  1. Staging, once per block. The block drops the invalid boxes, keeping
//     their order (a ballot and popc prefix within each warp, then the warp
//     counts in order), and writes one 64-byte record per valid box into
//     dynamic shared memory, read back with float4 loads. The record holds
//     what depends only on the box and the episode's origin, computed with
//     the plain version's fp32 operations in its order: cos, sin, -sin, the
//     class, the six slab numerators (-e) - p and e - p of the origin in the
//     box frame (p = lx, ly, lz), and the cull terms below.
//  2. Per ray, for each chunk of 32 staged boxes: the cull of every box,
//     without branches, into a bit mask, then, for the boxes that survive
//     it in ascending order, the unchanged exact test (the direction
//     rotated into the box frame, three slabs with the r_safe guard and
//     IEEE division, the selection). Built with -fmad=false, no multiply-add
//     is contracted, so t and cls equal the plain version bit for bit: the
//     cull only decides which pairs reach the exact test, and it rejects no
//     pair that test accepts (below). Survivors are rare (about 0.3 a camera
//     ray of 48 box slots), so the cull's per-box cost sets the time; the
//     mask keeps it free of branches.
//
// The cull. q = c - o is the box centre relative to the origin (fp32,
// q = -(o - c) exactly), d = (dx, dy) the planar direction, L = |d|.
// A pair is skipped when
//   (a) L >= kMinPlanar and (|q x d| > R' L or q . d < -R' L): the planar
//       half-line from the origin misses the disc of radius R' around the
//       centre; or
//   (b) the origin is above the box top ((-ez) - lz < 0 and ez - lz < 0,
//       the test's own z numerators) and dz >= 0.
// (b) is exact: with dz >= 0 the z divisor r_safe is positive, both z slab
// times are <= 0 (-0 at worst), so tmax <= 0 and the test rejects. For
// (a), R' = (R (1 + 1e-5) + 1e-5 |q| + 1e-3 m) / k with R = |(ex, ey)| and
// k = |(cos, sin)| (R' = inf, no cull, unless 0.25 <= k^2 <= 4). Why it is
// conservative, with u = 2^-24 and M the rotation by (cos, sin), |M v| =
// k |v|: let the test accept at t* = tmax > 0. Each axis brackets t*
// between fl(n0/r) and fl(n1/r) with n = fl(+-e - p), so the point
// s = p + t* r lies within |e| + 2.01u(|e| + |p|) of the centre on that
// axis. p = (lx, ly) is M(o - c) to within 3u k|q|, the rotated direction
// M d to within 2u k L, and r_safe moves a component by < 2e-9, which for
// L >= 0.01 is < 2e-7 of the travel t* L. So the true planar point
// w = o + t* d lies within D of the centre, where k D <= R (1 + 2e-7) +
// (6e-7 k + 3e-7) |q| + (2e-7 k + 3e-7) D, hence, for 0.5 <= k <= 2,
// D <= (R (1 + 1.2e-6) + 1.3e-6 |q|) / k. The half-line meets that disc,
// so |q x d| <= D L and q . d >= -D L (a ray starting inside it included,
// which is why no separate "origin inside" flag is needed). The cull's own
// fp32 evaluation (q, the cross and dot products, L, R' and R' L) errs by
// < 5u |q| L + 10u R' L. The 1e-5 terms take 5x what all this needs, and
// 1e-3 m covers underflow, at every coordinate up to the float range (town
// coordinates reach some hundreds of metres; cull_boxes keeps boxes within
// 1,015 m of the ego).
// Rays with L < kMinPlanar (vertical, or unnormalized and tiny) skip only by
// (b). A NaN anywhere makes every comparison false: nothing is skipped.
// ops/raycast.py raycast_candidates_plain is this predicate in plain fp32;
// the CPU tests hold it against the exact test on adversarial rays.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 9;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kMinPlanar = 0.01f;   // planar cull only for L >= this
constexpr float kGrow = 1.00001f;     // R' = (R kGrow + kRel |q| + kAbs) / k
constexpr float kRel = 1e-5f;
constexpr float kAbs = 1e-3f;

// One valid box in shared memory: 4 x float4.
//   cull: qx, qy, R', above (1 or 0)
//   rot:  cos, sin, -sin, cls
//   nxy:  (-ex) - lx, ex - lx, (-ey) - ly, ey - ly
//   nz:   (-ez) - lz, ez - lz, 0, 0
struct __align__(16) Staged {
  float4 cull, rot, nxy, nz;
};

__device__ __forceinline__ void slab(float n0, float n1, float r, float* lo,
                                     float* hi) {
  const float ta = n0 / r;
  const float tb = n1 / r;
  *lo = fminf(ta, tb);
  *hi = fmaxf(ta, tb);
}

__device__ __forceinline__ float guard(float r) {
  return fabsf(r) < 1e-9f ? 1e-9f : r;
}

// Writes the block's valid boxes, in order, to `out`; returns their count.
__device__ int stage_boxes(const float* __restrict__ src, int k, float ox,
                           float oy, float oz, Staged* out) {
  __shared__ int warp_count[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int total = 0;
  for (int base = 0; base < k; base += kThreads) {
    const int v = base + threadIdx.x;
    const float* bx = src + static_cast<size_t>(v) * kFields;
    const bool keep = v < k && bx[8] > 0.0f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int slot = total, chunk = 0;
    for (int i = 0; i < kWarps; ++i) {
      if (i < warp) slot += warp_count[i];
      chunk += warp_count[i];
    }
    if (keep) {
      slot += __popc(ballot & ((1u << lane) - 1u));
      const float cx = bx[0], cy = bx[1], cs = bx[2], sn = bx[3];
      const float ex = bx[4], ey = bx[5], ez = bx[6];
      const float px = ox - cx;
      const float py = oy - cy;
      const float lx = cs * px + sn * py;
      const float ly = -sn * px + cs * py;
      const float lz = oz - ez;
      const float nz0 = -ez - lz;
      const float nz1 = ez - lz;
      const float kk = cs * cs + sn * sn;
      const float r = sqrtf(ex * ex + ey * ey);
      const float q = sqrtf(px * px + py * py);
      const float rp = (kk >= 0.25f && kk <= 4.0f)
                           ? (r * kGrow + kRel * q + kAbs) / sqrtf(kk)
                           : __int_as_float(0x7f800000);   // +inf: no cull
      const float above = (nz0 < 0.0f && nz1 < 0.0f) ? 1.0f : 0.0f;
      Staged s;
      s.cull = make_float4(-px, -py, rp, above);
      s.rot = make_float4(cs, sn, -sn, bx[7]);
      s.nxy = make_float4(-ex - lx, ex - lx, -ey - ly, ey - ly);
      s.nz = make_float4(nz0, nz1, 0.0f, 0.0f);
      out[slot] = s;
    }
    total += chunk;
    __syncthreads();   // warp_count is rewritten by the next chunk
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
ray_box_kernel(const float* __restrict__ origins,  // [B,3]
               const float* __restrict__ dirs,     // [B,N,3]
               const float* __restrict__ boxes,    // [B,K,9]
               float* __restrict__ t_out,          // [B,N]
               int32_t* __restrict__ cls_out,      // [B,N]
               int n, int k) {
  extern __shared__ Staged staged[];
  const int b = blockIdx.y;
  const float ox = origins[3 * b + 0];
  const float oy = origins[3 * b + 1];
  const float oz = origins[3 * b + 2];
  const int n_staged = stage_boxes(boxes + static_cast<size_t>(b) * k *
                                   kFields, k, ox, oy, oz, staged);

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const size_t r = static_cast<size_t>(b) * n + ray;
  const float dx = dirs[3 * r + 0];
  const float dy = dirs[3 * r + 1];
  const float dz = dirs[3 * r + 2];
  const float len = sqrtf(dx * dx + dy * dy);
  // rule (a) only for L >= kMinPlanar: otherwise the reach R' * inf is
  // inf (R' > 0), and neither of its comparisons can hold
  const float span = len >= kMinPlanar ? len : __int_as_float(0x7f800000);
  const bool rising = dz >= 0.0f;
  const float rz = guard(dz);

  float t_best = 1e9f;
  int32_t c_best = 0;
  for (int base = 0; base < n_staged; base += 32) {
    // the cull of up to 32 staged boxes, without branches, into a mask
    const int count = min(32, n_staged - base);
    unsigned live = 0u;
#pragma unroll 8
    for (int i = 0; i < count; ++i) {
      const float4 cu = staged[base + i].cull;
      const float cross = cu.x * dy - cu.y * dx;
      const float dot = cu.x * dx + cu.y * dy;
      const float reach = cu.z * span;
      const bool skip = fabsf(cross) > reach || dot < -reach ||
                        (rising && cu.w > 0.0f);
      live |= static_cast<unsigned>(!skip) << i;
    }
    // the exact test of the survivors, in ascending box order
    while (live) {
      const int v = base + __ffs(live) - 1;
      live &= live - 1u;
      const float4 rot = staged[v].rot;
      const float4 nxy = staged[v].nxy;
      const float4 nz = staged[v].nz;
      const float rdx = rot.x * dx + rot.y * dy;
      const float rdy = rot.z * dx + rot.x * dy;
      float tx0, tx1, ty0, ty1, tz0, tz1;
      slab(nxy.x, nxy.y, guard(rdx), &tx0, &tx1);
      slab(nxy.z, nxy.w, guard(rdy), &ty0, &ty1);
      slab(nz.x, nz.y, rz, &tz0, &tz1);
      const float tmin = fmaxf(fmaxf(tx0, ty0), tz0);
      const float tmax = fminf(fminf(tx1, ty1), tz1);
      const bool hit = (tmax >= tmin) && (tmax > 0.0f);
      const float t_hit = tmin > 0.0f ? tmin : tmax;
      if (hit && t_hit < t_best) {
        t_best = t_hit;
        c_best = static_cast<int32_t>(rot.w);
      }
    }
  }
  t_out[r] = t_best;
  cls_out[r] = c_best;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch (0 = ok).
extern "C" int raycast_boxes_launch(const float* origins, const float* dirs,
                                    const float* boxes, float* t,
                                    int32_t* cls, int batch, int n, int k,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(k) * sizeof(Staged);
  if (smem > 47 * 1024) {   // 48 KB less the static warp counts
    const cudaError_t err = cudaFuncSetAttribute(
        ray_box_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  ray_box_kernel<<<grid, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, boxes, t, cls, n, k);
  return static_cast<int>(cudaGetLastError());
}
