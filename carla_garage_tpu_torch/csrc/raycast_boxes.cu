// Ray vs box-set intersection for camera and LiDAR rendering, for Hopper.
//
// Replaces the Pallas TPU kernel carla_garage_tpu/ops/pallas/raycast.py
// raycast_boxes (_ray_box_kernel). For every ray of an episode it finds the
// nearest slab hit against that episode's K upright oriented boxes standing
// on z = 0 (fields cx, cy, cos, sin, ex, ey, ez, cls, valid). A box wins
// only when strictly nearer (t_hit < t_best), so on a tie the earlier box
// wins; a ray that starts inside a box hits at the exit; 1e9 marks a miss.
//
// What bounds it on an H100: fp32 arithmetic. A ray-box test needs 30
// floating-point operations that depend on the ray, 6 of them IEEE
// divisions (the box's own terms, 19 more, are needed once per box and
// episode), while a ray moves 20 bytes (12 in, 8 out) whatever K is. At
// the camera's shape (16 episodes x 262,144 rays x 48 boxes, about 2.0e8
// tests, about 6 GFLOP) that is about 0.09 ms at 67 TFLOP/s against about
// 0.025 ms for its 84 MB at 3.35 TB/s. In instructions it costs more than
// that flop count says: this kernel recomputes the box's terms for every
// ray; with -fmad=false every multiply and add issues on its own (the peak
// counts a fused multiply-add as two); and each IEEE division is a
// sequence of several instructions: the loop body over one box is 139
// instructions in the built SASS, so the card's instruction issue, not its
// flop rate, sets the kernel's time.
//
// Design: one thread per ray, blocks of 256 rays, grid (ceil(N/256), B).
// A block stages its episode's K x 9 box array into shared memory once
// (48 boxes = 1.7 KB; dynamic shared memory, so any K fits up to the
// card's limit) and every thread loops over the boxes with the running
// t_best / c_best in registers, so device memory is read once per ray and
// written once per ray. N is not padded: the ragged tail is masked. The
// arithmetic keeps the TPU kernel's order and its r_safe guard, with IEEE
// division; built with -fmad=false, so no multiply-add is contracted and
// the result equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 9;
constexpr int kThreads = 256;

__device__ __forceinline__ void slab(float p, float r, float e, float* lo,
                                     float* hi) {
  const float r_safe = fabsf(r) < 1e-9f ? 1e-9f : r;
  const float ta = (-e - p) / r_safe;
  const float tb = (e - p) / r_safe;
  *lo = fminf(ta, tb);
  *hi = fmaxf(ta, tb);
}

__global__ void __launch_bounds__(kThreads)
ray_box_kernel(const float* __restrict__ origins,  // [B,3]
               const float* __restrict__ dirs,     // [B,N,3]
               const float* __restrict__ boxes,    // [B,K,9]
               float* __restrict__ t_out,          // [B,N]
               int32_t* __restrict__ cls_out,      // [B,N]
               int n, int k) {
  extern __shared__ float sbox[];
  const int b = blockIdx.y;
  const float* src = boxes + static_cast<size_t>(b) * k * kFields;
  for (int i = threadIdx.x; i < k * kFields; i += blockDim.x) {
    sbox[i] = src[i];
  }
  __syncthreads();

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const size_t r = static_cast<size_t>(b) * n + ray;
  const float dx = dirs[3 * r + 0];
  const float dy = dirs[3 * r + 1];
  const float dz = dirs[3 * r + 2];
  const float ox = origins[3 * b + 0];
  const float oy = origins[3 * b + 1];
  const float oz = origins[3 * b + 2];

  float t_best = 1e9f;
  int32_t c_best = 0;
  for (int v = 0; v < k; ++v) {
    const float* bx = sbox + v * kFields;
    const float cx = bx[0], cy = bx[1], cs = bx[2], sn = bx[3];
    const float ex = bx[4], ey = bx[5], ez = bx[6];
    const int32_t cls_v = static_cast<int32_t>(bx[7]);
    const bool valid = bx[8] > 0.0f;

    const float px = ox - cx;
    const float py = oy - cy;
    const float lx = cs * px + sn * py;
    const float ly = -sn * px + cs * py;
    const float lz = oz - ez;
    const float rdx = cs * dx + sn * dy;
    const float rdy = -sn * dx + cs * dy;

    float tx0, tx1, ty0, ty1, tz0, tz1;
    slab(lx, rdx, ex, &tx0, &tx1);
    slab(ly, rdy, ey, &ty0, &ty1);
    slab(lz, dz, ez, &tz0, &tz1);
    const float tmin = fmaxf(fmaxf(tx0, ty0), tz0);
    const float tmax = fminf(fminf(tx1, ty1), tz1);
    const bool hit = (tmax >= tmin) && (tmax > 0.0f) && valid;
    const float t_hit = tmin > 0.0f ? tmin : tmax;
    if (hit && t_hit < t_best) {
      t_best = t_hit;
      c_best = cls_v;
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
  const size_t smem = static_cast<size_t>(k) * kFields * sizeof(float);
  if (smem > 48 * 1024) {
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
