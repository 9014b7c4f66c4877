// Marker kernels for the program's spans inside a captured CUDA graph
// (utils/profiling.py). A span opened during a stream capture launches
// cgt_span_begin<id> where it opens and cgt_span_end<id> where it closes;
// both are empty, so each replay of the graph runs them around the
// span's work, and a profiler's trace, which names every kernel of a
// replay, shows where the span began and ended. The id tells the spans
// apart (profiling.marker_ids()).
#include <cuda_runtime.h>

namespace {

constexpr int kMarkers = 16;

template <int ID>
__global__ void cgt_span_begin() {}

template <int ID>
__global__ void cgt_span_end() {}

#define CGT_MARKER(i) \
  {reinterpret_cast<const void*>(&cgt_span_begin<i>), \
   reinterpret_cast<const void*>(&cgt_span_end<i>)},

const void* const kKernels[kMarkers][2] = {
    CGT_MARKER(0) CGT_MARKER(1) CGT_MARKER(2) CGT_MARKER(3)
    CGT_MARKER(4) CGT_MARKER(5) CGT_MARKER(6) CGT_MARKER(7)
    CGT_MARKER(8) CGT_MARKER(9) CGT_MARKER(10) CGT_MARKER(11)
    CGT_MARKER(12) CGT_MARKER(13) CGT_MARKER(14) CGT_MARKER(15)};

}  // namespace

extern "C" int span_marker_count() { return kMarkers; }

// Loads every marker kernel now, so that none loads inside a capture.
extern "C" int span_marker_load() {
  for (int i = 0; i < kMarkers; ++i) {
    for (int end = 0; end < 2; ++end) {
      cudaFuncAttributes attr;
      cudaError_t err = cudaFuncGetAttributes(&attr, kKernels[i][end]);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// One block of one thread on `stream`: the begin (end = 0) or end marker
// of span `id`.
extern "C" int span_marker_launch(int id, int end, void* stream) {
  if (id < 0 || id >= kMarkers) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaLaunchKernel(
      kKernels[id][end ? 1 : 0], dim3(1), dim3(1), nullptr, 0,
      static_cast<cudaStream_t>(stream)));
}
