// Building blocks shared by the fused message-passing kernels (K3 forward,
// K4 backward): the latent width, the shared-memory layouts of the bf16 and
// float32 instances, weight staging, the block GEMM C (+)= A @ W on
// nvcuda::wmma bf16 16x16x16 tiles with float32 accumulators (CUDA-core
// FMAs in the float32 instance), and the warp-per-row LayerNorm.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int F = 128;       // latent width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LDF = F + 4;   // float row stride in shared memory
constexpr float kEps = 1e-5f;

template <typename T>
struct Layout;
template <>
struct Layout<bf16> {
  static constexpr int LDA = F + 8;  // bf16 row stride (wmma ldm % 8 == 0)
  static constexpr bool kStageWeights = true;
};
template <>
struct Layout<float> {
  static constexpr int LDA = F + 4;
  static constexpr bool kStageWeights = false;  // read from global (L1/L2)
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// Stage a (F, F) row-major weight into shared memory with row stride LDA.
template <typename T>
__device__ void stage_weight(T* dst, const void* src) {
  constexpr int LDA = Layout<T>::LDA;
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  const int4* s = reinterpret_cast<const int4*>(src);
  for (int i = threadIdx.x; i < F * F / V; i += THREADS) {
    const int r = i / (F / V), c = (i % (F / V)) * V;
    *reinterpret_cast<int4*>(dst + r * LDA + c) = s[i];
  }
}

// C[rows, F] (+)= A[rows, F] @ W[F, F]; rows is a multiple of 16.
template <typename T>
__device__ void block_gemm(const T* A, const T* W, float* C, int rows, bool accumulate);

template <>
__device__ void block_gemm<bf16>(const bf16* A, const bf16* W, float* C, int rows,
                                 bool accumulate) {
  constexpr int LDA = Layout<bf16>::LDA;
  const int warp = threadIdx.x / 32;
  const int tiles = (rows / 16) * (F / 16);
  for (int t = warp; t < tiles; t += WARPS) {
    const int r0 = (t / (F / 16)) * 16, c0 = (t % (F / 16)) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
    if (accumulate)
      wmma::load_matrix_sync(fc, C + r0 * LDF + c0, LDF, wmma::mem_row_major);
    else
      wmma::fill_fragment(fc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < F; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, A + r0 * LDA + kk, LDA);
      wmma::load_matrix_sync(fb, W + kk * LDA + c0, LDA);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(C + r0 * LDF + c0, fc, LDF, wmma::mem_row_major);
  }
}

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
