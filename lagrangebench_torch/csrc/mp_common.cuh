// Building blocks shared by the fused message-passing kernels (K3 forward,
// K4 backward): the latent width, and for the float32 instances (the bf16
// ones are built from mp_warp.cuh) the shared-memory layout, the block GEMM
// C (+)= A @ W on CUDA-core FMAs and the warp-per-row LayerNorm.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int F = 128;       // latent width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDF = F + 4;   // float row stride in shared memory
constexpr float kEps = 1e-5f;

template <typename T>
struct Layout;
template <>
struct Layout<float> {
  static constexpr int LDA = F + 4;  // row stride in shared memory; weights stay in global
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// C[rows, F] (+)= A[rows, F] @ W[F, F]; rows is a multiple of 16.
template <typename T>
__device__ void block_gemm(const T* A, const T* W, float* C, int rows, bool accumulate);

template <>
__device__ void block_gemm<float>(const float* A, const float* W, float* C, int rows,
                                  bool accumulate) {
  constexpr int LDA = Layout<float>::LDA;
  const int c = threadIdx.x % F;
  for (int r0 = (threadIdx.x / F) * 8; r0 < rows; r0 += (THREADS / F) * 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = accumulate ? C[(r0 + i) * LDF + c] : 0.f;
    for (int kk = 0; kk < F; ++kk) {
      const float w = W[kk * F + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += A[(r0 + i) * LDA + kk] * w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) C[(r0 + i) * LDF + c] = acc[i];
  }
}

// LayerNorm of one F-wide float row held by a warp (4 values per lane).
__device__ __forceinline__ void warp_layernorm(float (&x)[F / 32], const float* scale,
                                               const float* bias, int lane) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < F / 32; ++i) s += x[i];
  const float mean = lbt::warp_sum(s) * (1.f / F);
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < F / 32; ++i) {
    const float d = x[i] - mean;
    v += d * d;
  }
  const float inv = rsqrtf(lbt::warp_sum(v) * (1.f / F) + kEps);
#pragma unroll
  for (int i = 0; i < F / 32; ++i) {
    const int c = lane + 32 * i;
    x[i] = (x[i] - mean) * inv * scale[c] + bias[c];
  }
}

}  // namespace
