// GroupNorm over channel-first maps, with an optional ReLU, for Hopper.
//
// Replaces no Pallas kernel: the JAX package's TpuGroupNorm
// (carla_garage_tpu/ops/norm.py) is plain jnp. It was added because, in the
// bf16 RegNetY branches of TransFuser++, the plain version's eager float32
// passes (an upcast copy, squares, spatial and group means, two
// repeat_interleaves, x * a + b, a cast back: about 20 launches and 40
// bytes of traffic an element) held the largest share of the forward's
// device time. It keeps the JAX package's numerics: moments in float32, the
// group's mean and E[x^2], the variance E[x^2] - E[x]^2 clipped at 0, then
// y = x * a + b in float32 (a = scale / sqrt(var + eps), b = bias - mean a,
// built with -fmad=false, so nothing is contracted), cast to the input's
// type; with relu, max(y, 0) before the cast. Only the order of the float32
// sums differs from the plain version (ops/norm.py).
//
// Layouts, in bf16 or float32, S the spatial axes flattened:
//  - contiguous [B, C, S]: group (b, g) is one contiguous range of
//    n = (C / G) S elements, the kernel's unit;
//  - channels-last [B, S, C] (torch.channels_last, channels_last_3d): the
//    unit is a sample's contiguous [S, C]; a thread keeps to one run of
//    channels (blockDim is a multiple of C / VEC), so it sums each of its
//    channels in registers, and the block adds them up channel by channel,
//    then group by group.
//
// What bounds it on an H100: the bytes. An element needs one read and one
// write (4 bytes in bf16) and a few float operations; the least time is the
// map's bytes at 3.35 TB/s. The statistics need the whole group before the
// first output, so the kernel reads the map twice, and small maps pay for
// each launch.
//
// Design: two passes. kMoments writes each CTA's sums (a group's, or in a
// channels-last sample each group's) to a scratch array, with few CTAs
// (about two an SM in all) so that the sums are few; kApply's CTAs each
// add up their unit's in order and read the map again. kApply takes its
// CTAs in reverse order, so that it first reads what kMoments read last,
// still in the 50 MB L2, and it is launched as kMoments' programmatic
// dependent: its CTAs start while kMoments' finish and wait
// (griddepcontrol.wait) until the sums are visible, which hides the second
// launch. A map moves 6 bytes an element at worst in bf16, 4 where it fits
// in L2. In the TransFuser++ branches every map is channels-last, whose
// unit is a whole sample (0.2-9.4 MB at bf16) with the groups interleaved:
// reading it once needs a sample in one thread-block cluster, which holds
// one only where the map of all 16 samples fits in L2 anyway, and measured
// on an H100 such a form was no faster than the two passes (7 CTAs a sample
// leave the card half idle).
// Where the vector width does not divide S (contiguous) or C (channels-
// last), or a pointer is not 16-byte aligned, the same code runs one
// element a load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;      // loads in flight a thread

enum Mode { kMoments = 0, kApply = 1 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A read-only load of one pack, as one instruction of its width.
template <typename V>
__device__ __forceinline__ V load(const V* p) {
  V v;
  if constexpr (sizeof(V) == 16) {
    *reinterpret_cast<uint4*>(&v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (sizeof(V) == 8) {
    *reinterpret_cast<uint2*>(&v) = __ldg(reinterpret_cast<const uint2*>(p));
  } else if constexpr (sizeof(V) == 4) {
    *reinterpret_cast<unsigned*>(&v) =
        __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    static_assert(sizeof(V) == 2, "packs of 2, 4, 8 or 16 bytes");
    *reinterpret_cast<unsigned short*>(&v) =
        __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return v;
}

struct Args {
  const void* x;
  void* y;
  const void* scale;   // [C], in x's type
  const void* bias;
  float2* partials;    // the two-pass form's sums, [units, mparts, G or 1]
  long long unit;      // elements a unit: (C / G) S, or S C channels-last
  long long chunk;     // elements a CTA: whole packs, or whole rows of C
  int parts;           // CTAs a unit
  long long mchunk;    // the same for kMoments, whose CTAs are fewer
  int mparts;
  int spatial;         // S
  int channels;        // C
  int cpg;             // channels a group
  int groups;          // G
  float eps;
  int relu;
};

// For i = threadIdx.x, + blockDim.x, ... < nvec: v = get(i), then use(i, v),
// with kUnroll gets issued before their uses.
template <typename V, typename Get, typename Use>
__device__ __forceinline__ void sweep(int nvec, Get get, Use use) {
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < nvec; i0 += step * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step;
      if (i < nvec) v[u] = get(i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * step;
      if (i < nvec) use(i, v[u]);
    }
  }
}

// The block's sums, the same in every thread (each reads the warps' sums in
// order). blockDim.x is a multiple of 32; called once a block.
__device__ __forceinline__ float2 block_sum(float s, float q, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = make_float2(s, q);
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) {
    t.x += red[w].x;
    t.y += red[w].y;
  }
  return t;
}

// (mean, 1 / sqrt(var + eps)) of a group from its sums over count elements.
__device__ __forceinline__ float2 moments(float sum, float sumsq,
                                          float count, float eps) {
  const float mean = sum / count;
  const float var = sumsq / count - mean * mean;
  return make_float2(mean, 1.0f / sqrtf((var < 0.0f ? 0.0f : var) + eps));
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> affine(const Pack<T, VEC>& p,
                                               const float* a,
                                               const float* b, int relu) {
  Pack<T, VEC> out;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float y = to_f32(p.v[j]) * a[j] + b[j];
    if (relu && y < 0.0f) y = 0.0f;
    out.v[j] = from_f32<T>(y);
  }
  return out;
}

// grid: `mparts` (kMoments) or `parts` (kApply) CTAs for each unit,
// unit-major.
template <typename T, int VEC, int MODE, bool CL>
__global__ void __launch_bounds__(kMaxThreads)
    group_norm_kernel(const Args a) {
  using V = Pack<T, VEC>;
  __shared__ float2 red[kMaxThreads / 32];
  extern __shared__ __align__(16) unsigned char dyn[];

  // kApply takes the CTAs in reverse: what kMoments read last comes first
  const long long bid = MODE == kApply ? gridDim.x - 1 - blockIdx.x
                                       : blockIdx.x;
  const int nparts = MODE == kMoments ? a.mparts : a.parts;
  const long long size = MODE == kMoments ? a.mchunk : a.chunk;
  const long long unit = bid / nparts;
  const int part = static_cast<int>(bid % nparts);
  const long long begin = static_cast<long long>(part) * size;
  const long long len =
      begin < a.unit ? (a.unit - begin < size ? a.unit - begin : size) : 0;
  const int nvec = static_cast<int>(len / VEC);
  const V* xv = reinterpret_cast<const V*>(static_cast<const T*>(a.x) +
                                           unit * a.unit + begin);
  V* yv = reinterpret_cast<V*>(static_cast<T*>(a.y) + unit * a.unit + begin);
  const T* scale = static_cast<const T*>(a.scale);
  const T* bias = static_cast<const T*>(a.bias);
  const float count = static_cast<float>(
      static_cast<long long>(a.cpg) * a.spatial);
  auto get_x = [&](int i) { return load(xv + i); };
  // kApply is launched as kMoments' programmatic dependent: its CTAs may
  // start while kMoments' finish, and wait here until kMoments' sums are
  // all written and visible; kMoments lets it start at once
  if constexpr (MODE == kApply) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  } else if constexpr (MODE == kMoments) {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  }

  if constexpr (CL) {
    // a thread's packs all hold channels c0 .. c0 + VEC - 1
    const int cols = a.channels / VEC;
    const int c0 = (threadIdx.x % cols) * VEC;
    // dyn: in kMoments per[rows][C] (each thread's channel sums), then
    // chan[C] (the block's); in kApply the groups' (mean, inv)
    float2* per = reinterpret_cast<float2*>(dyn);
    if constexpr (MODE == kMoments) {
      float s[VEC], q[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.0f;
      sweep<V>(nvec, get_x, [&](int, const V& v) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float f = to_f32(v.v[j]);
          s[j] += f;
          q[j] += f * f;
        }
      });
      const int rows = blockDim.x / cols;
      float2* chan = per + static_cast<long long>(rows) * a.channels;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        per[threadIdx.x * VEC + j] = make_float2(s[j], q[j]);
      }
      __syncthreads();
      for (int c = threadIdx.x; c < a.channels; c += blockDim.x) {
        float2 t = make_float2(0.0f, 0.0f);
        for (int r = 0; r < rows; ++r) {
          t.x += per[r * a.channels + c].x;
          t.y += per[r * a.channels + c].y;
        }
        chan[c] = t;
      }
      __syncthreads();
      float2* out = a.partials + bid * a.groups;
      for (int g = threadIdx.x; g < a.groups; g += blockDim.x) {
        float2 t = make_float2(0.0f, 0.0f);
        for (int j = 0; j < a.cpg; ++j) {
          t.x += chan[g * a.cpg + j].x;
          t.y += chan[g * a.cpg + j].y;
        }
        out[g] = t;
      }
    } else {
      // the groups' (mean, inv) from kMoments' sums, added in order
      const float2* in = a.partials + unit * a.mparts * a.groups;
      for (int g = threadIdx.x; g < a.groups; g += blockDim.x) {
        float sum = 0.0f, sumsq = 0.0f;
#pragma unroll 8
        for (int r = 0; r < a.mparts; ++r) {
          sum += in[r * a.groups + g].x;
          sumsq += in[r * a.groups + g].y;
        }
        per[g] = moments(sum, sumsq, count, a.eps);
      }
      __syncthreads();
      float ca[VEC], cb[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float2 m = per[(c0 + j) / a.cpg];
        ca[j] = m.y * to_f32(scale[c0 + j]);
        cb[j] = to_f32(bias[c0 + j]) - m.x * ca[j];
      }
      sweep<V>(nvec, get_x, [&](int i, const V& v) {
        yv[i] = affine<T, VEC>(v, ca, cb, a.relu);
      });
    }
  } else if constexpr (MODE == kMoments) {
    float s = 0.0f, q = 0.0f;
    sweep<V>(nvec, get_x, [&](int, const V& v) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(v.v[j]);
        s += f;
        q += f * f;
      }
    });
    const float2 t = block_sum(s, q, red);
    if (threadIdx.x == 0) a.partials[bid] = t;
  } else {
    const float2* in = a.partials + unit * a.mparts;
    float sum = 0.0f, sumsq = 0.0f;
#pragma unroll 8
    for (int r = 0; r < a.mparts; ++r) {
      sum += in[r].x;
      sumsq += in[r].y;
    }
    const float2 m = moments(sum, sumsq, count, a.eps);
    const int cbase = static_cast<int>(unit % a.groups) * a.cpg;
    sweep<V>(nvec, get_x, [&](int i, const V& v) {
      // S is a multiple of VEC: a pack lies in one channel
      const int c = cbase + static_cast<int>(
          (begin + static_cast<long long>(i) * VEC) / a.spatial);
      float ca[VEC], cb[VEC];
      ca[0] = m.y * to_f32(scale[c]);
      cb[0] = to_f32(bias[c]) - m.x * ca[0];
#pragma unroll
      for (int j = 1; j < VEC; ++j) {
        ca[j] = ca[0];
        cb[j] = cb[0];
      }
      yv[i] = affine<T, VEC>(v, ca, cb, a.relu);
    });
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  // the opt-in beyond 48 KB, which the static bytes count against too
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int VEC, bool CL>
int launch(const Args& a, long long units, int threads, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>(units * a.parts);
  const unsigned mgrid = static_cast<unsigned>(units * a.mparts);
  auto* moments_k = group_norm_kernel<T, VEC, kMoments, CL>;
  auto* apply_k = group_norm_kernel<T, VEC, kApply, CL>;
  const int rows = CL ? threads / (a.channels / VEC) : 0;
  const size_t smem_m =
      CL ? sizeof(float2) * (static_cast<size_t>(rows) + 1) * a.channels : 0;
  const size_t smem_a = CL ? sizeof(float2) * a.groups : 0;
  cudaError_t err = allow_smem(moments_k, smem_m);
  if (err == cudaSuccess) err = allow_smem(apply_k, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  moments_k<<<mgrid, threads, smem_m, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_a;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, apply_k, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vec(const Args& a, long long units, int threads,
               int channels_last, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    return channels_last ? launch<T, kVec, true>(a, units, threads, stream)
                         : launch<T, kVec, false>(a, units, threads, stream);
  }
  if (vec == 1) {
    return channels_last ? launch<T, 1, true>(a, units, threads, stream)
                         : launch<T, 1, false>(a, units, threads, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches the two kernels on `stream`; returns the first CUDA error of
// the launches (0 = ok). x and y hold `units` units of `unit` elements, in
// bf16 (x_bf16) or float32: units = B G groups of a contiguous map, B
// samples of a channels-last one. scale and bias [C] in x's type. kMoments
// covers a unit with `mparts` CTAs of `mchunk` elements, kApply with
// `parts` of `chunk`; partials [units, mparts, G or 1] float2. threads: a
// multiple of 32 for a contiguous map, of C / vec channels-last.
extern "C" int group_norm_launch(const void* x, void* y, const void* scale,
                                 const void* bias, void* partials,
                                 long long units, long long unit,
                                 long long chunk, int parts,
                                 long long mchunk, int mparts, int spatial,
                                 int channels, int cpg, int groups,
                                 int threads, int channels_last, int x_bf16,
                                 int vec, float eps, int relu, void* stream) {
  const int quantum = channels_last ? channels : vec;
  if (parts < 1 || chunk < 1 || mparts < 1 || mchunk < 1 || spatial < 1 ||
      groups < 1 || cpg < 1 || vec < 1 || chunk % quantum != 0 ||
      mchunk % quantum != 0 ||
      (channels_last ? channels % vec != 0 ||
                           threads % (channels / vec) != 0
                     : spatial % vec != 0 || threads % 32 != 0) ||
      threads < 1 || threads > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = x;
  a.y = y;
  a.scale = scale;
  a.bias = bias;
  a.partials = static_cast<float2*>(partials);
  a.unit = unit;
  a.chunk = chunk;
  a.parts = parts;
  a.mchunk = mchunk;
  a.mparts = mparts;
  a.spatial = spatial;
  a.channels = channels;
  a.cpg = cpg;
  a.groups = groups;
  a.eps = eps;
  a.relu = relu;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_vec<__nv_bfloat16>(a, units, threads, channels_last,
                                            vec, s)
                : launch_vec<float>(a, units, threads, channels_last, vec, s);
}
