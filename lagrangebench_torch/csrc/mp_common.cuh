// Building blocks shared by the fused message-passing kernels (K3 forward,
// K4 backward), templated on the instance width F (64, 128, 192 or 256):
// the float32 tile design's shared-memory layout, its block GEMM C (+)= A @ W
// (CUDA-core FMAs, W read from the (in, out) weight in device memory), the
// warp-per-row LayerNorm, and the width map (latent_dispatch).
//
// Width map: a latent width nf in [1, 256] runs the instance F = 64
// ceil(nf / 64). The wrapper (ops/fused_mp.py) pads every tensor and
// weight to F with zeros, LayerNorm scale and bias included, and the
// kernels take nf: every LayerNorm's mean, variance and backward run over
// the first nf channels, and the padded channels come out 0.
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

// C[rows, F] (+)= A[rows, F] @ W[F, F]; rows is a multiple of 16. float32:
// each thread takes (8-row block, column c) pairs in turn (with F dividing
// THREADS, column c = threadIdx.x % F throughout), the sum over k in order.
template <int F>
__device__ void block_gemm(const float* A, const float* W, float* C, int rows, bool accumulate) {
  constexpr int LDA = Layout<float, F>::LDA;
  for (int idx = threadIdx.x; idx < (rows / 8) * F; idx += THREADS) {
    const int c = idx % F, r0 = (idx / F) * 8;
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
// lane, column lane + 32 i) over its first nf columns; the others come out 0.
template <int V>
__device__ __forceinline__ void warp_layernorm(float (&x)[V], const float* scale,
                                               const float* bias, int lane, int nf) {
  const float inv_n = 1.f / nf;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += lane + 32 * i < nf ? x[i] : 0.f;
  const float mean = lbt::warp_sum(s) * inv_n;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = lane + 32 * i < nf ? x[i] - mean : 0.f;
    v += d * d;
  }
  const float inv = rsqrtf(lbt::warp_sum(v) * inv_n + kEps);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    x[i] = c < nf ? (x[i] - mean) * inv * scale[c] + bias[c] : 0.f;
  }
}

constexpr int kMaxLatent = 256;  // the widest instance (ops/fused_mp.py INSTANCES; mp_wide.cuh above)

// Calls fn(std::integral_constant<int, F>{}) for the instance F that runs
// latent width nf (the width map above); nf outside [1, kMaxLatent] is
// cudaErrorInvalidValue.
template <typename Fn>
int latent_dispatch(int nf, Fn fn) {
  if (nf < 1 || nf > kMaxLatent) return (int)cudaErrorInvalidValue;
  switch ((nf + 63) / 64) {
    case 1:
      return fn(std::integral_constant<int, 64>{});
    case 2:
      return fn(std::integral_constant<int, 128>{});
    case 3:
      return fn(std::integral_constant<int, 192>{});
    default:
      return fn(std::integral_constant<int, 256>{});
  }
}

}  // namespace
