// Building blocks shared by the fused message-passing kernels (K3 forward,
// K4 backward), templated on the latent width F: for the float32 instances
// (the bf16 ones are built from mp_warp.cuh) the shared-memory layout, the
// block GEMM C (+)= A @ W on CUDA-core FMAs and the warp-per-row LayerNorm.
// The entry points instantiate F = 64 and F = 128 (latent_dispatch).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
template <int F>
constexpr int kLdf = F + 4;  // float row stride in shared memory
constexpr float kEps = 1e-5f;

template <typename T, int F>
struct Layout;
template <int F>
struct Layout<float, F> {
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

// C[rows, F] (+)= A[rows, F] @ W[F, F]; rows is a multiple of 16. Thread
// column c = threadIdx.x % F; the THREADS / F thread groups take 8-row
// blocks in turn.
template <int F>
__device__ void block_gemm(const float* A, const float* W, float* C, int rows, bool accumulate) {
  static_assert(THREADS % F == 0, "a thread group covers whole rows");
  constexpr int LDA = Layout<float, F>::LDA;
  const int c = threadIdx.x % F;
  for (int r0 = (threadIdx.x / F) * 8; r0 < rows; r0 += (THREADS / F) * 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = accumulate ? C[(r0 + i) * kLdf<F> + c] : 0.f;
    for (int kk = 0; kk < F; ++kk) {
      const float w = W[kk * F + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += A[(r0 + i) * LDA + kk] * w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) C[(r0 + i) * kLdf<F> + c] = acc[i];
  }
}

// LayerNorm of one F-wide float row held by a warp (V = F / 32 values per
// lane, column lane + 32 i).
template <int V>
__device__ __forceinline__ void warp_layernorm(float (&x)[V], const float* scale,
                                               const float* bias, int lane) {
  constexpr float kInvF = 1.f / (32 * V);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += x[i];
  const float mean = lbt::warp_sum(s) * kInvF;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = x[i] - mean;
    v += d * d;
  }
  const float inv = rsqrtf(lbt::warp_sum(v) * kInvF + kEps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    x[i] = (x[i] - mean) * inv * scale[c] + bias[c];
  }
}

// Calls fn(std::integral_constant<int, F>{}) for latent == F in {64, 128},
// the widths the kernels are instantiated at (ops/fused_mp.py LATENTS);
// any other width is cudaErrorInvalidValue.
template <typename Fn>
int latent_dispatch(int latent, Fn fn) {
  switch (latent) {
    case 64:
      return fn(std::integral_constant<int, 64>{});
    case 128:
      return fn(std::integral_constant<int, 128>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
