// Shared helpers for the port's CUDA kernels.
//
// Every kernel library exposes plain `extern "C"` entry points (bound with
// ctypes). An entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define LBT_EXPORT extern "C" __attribute__((visibility("default")))

namespace lbt {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

inline int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

}  // namespace lbt
