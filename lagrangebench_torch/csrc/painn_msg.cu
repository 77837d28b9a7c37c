// K6: PaiNN message block and its K-sum, dense (N, K) layout.
//
// Replaces: lagrangebench_tpu/ops/painn_msg.py::_msg_kernel, launched by
// _painn_message_pallas. Per receiver i over its K slots, with H = 128:
//
//   msg   = wij * g[:, :3H]               (filters pre-masked: padded slots 0)
//   ds    = sum_K msg[:H]
//   dv_d  = sum_K (nd_d * msg[H:2H] + g[:, (3+d)H:(4+d)H] * msg[2H:3H])
//
// g (N, K, (3 + dim) H) is the packed sender gather [x, v], wij (N, K, 3H)
// the masked filters, nd (N, K, dim) the receiver->sender direction, all in
// the compute type T (float32 or bf16); products and sums run in float32 and
// ds (N, H), dv (N, dim H) are written in float32.
//
// Bound on an H100: bytes. Each edge row reads (6 + dim) H + dim values of T
// and does ~(4 + 3 dim) H FLOP, under 1 FLOP per byte in float32.
//
// Design: one warp per receiver, each lane owning 4 channels, so every load
// of a row segment is one 16-byte (float32) or 8-byte (bf16) access per lane
// and a warp reads whole 512- or 256-byte segments; the K-sum runs in
// registers, slot by slot in k order (the same on every run), and the
// outputs are written once. No shared memory; 8 warps per block.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int H = 128;
constexpr int WARPS = 8;

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(WARPS * 32)
    painn_msg(const T* __restrict__ g, const T* __restrict__ wij, const T* __restrict__ nd,
              float* __restrict__ ds, float* __restrict__ dv, int n, int k) {
  constexpr int GW = (3 + DIM) * H;
  const int node = blockIdx.x * WARPS + threadIdx.x / 32;
  if (node >= n) return;
  const int c = (threadIdx.x % 32) * 4;

  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float v[DIM][4];
#pragma unroll
  for (int d = 0; d < DIM; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) v[d][i] = 0.f;

  const int64_t row0 = (int64_t)node * k;
#pragma unroll 2
  for (int j = 0; j < k; ++j) {
    const int64_t row = row0 + j;
    const T* gr = g + row * GW;
    const T* wr = wij + row * (3 * H);
    float w1[4], w2[4], w3[4], x1[4], x2[4], x3[4];
    load4(wr + c, w1);
    load4(wr + H + c, w2);
    load4(wr + 2 * H + c, w3);
    load4(gr + c, x1);
    load4(gr + H + c, x2);
    load4(gr + 2 * H + c, x3);
    float m1[4], m2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] += w1[i] * x1[i];
      m1[i] = w2[i] * x2[i];
      m2[i] = w3[i] * x3[i];
    }
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const float ndd = to_f(nd[row * DIM + d]);
      float u[4];
      load4(gr + (3 + d) * H + c, u);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[d][i] += ndd * m1[i] + u[i] * m2[i];
    }
  }
  store4(ds + (int64_t)node * H + c, s);
#pragma unroll
  for (int d = 0; d < DIM; ++d) store4(dv + (int64_t)node * DIM * H + d * H + c, v[d]);
}

template <typename T, int DIM>
int launch(const void* g, const void* wij, const void* nd, void* ds, void* dv, int n, int k,
           cudaStream_t stream) {
  painn_msg<T, DIM><<<lbt::ceil_div(n, WARPS), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(wij), static_cast<const T*>(nd),
      static_cast<float*>(ds), static_cast<float*>(dv), n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// g, wij, nd in the compute type (is_bf16 ? bf16 : float32), ds and dv
// float32; g and wij 16-byte (float32) or 8-byte (bf16) aligned.
LBT_EXPORT int lbt_painn_msg(const void* g, const void* wij, const void* nd, void* ds, void* dv,
                             int n, int k, int h, int dim, int is_bf16, cudaStream_t stream) {
  if (h != H || n < 1 || k < 1 || (dim != 2 && dim != 3)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dim == 3 ? launch<bf16, 3>(g, wij, nd, ds, dv, n, k, stream)
                    : launch<bf16, 2>(g, wij, nd, ds, dv, n, k, stream);
  return dim == 3 ? launch<float, 3>(g, wij, nd, ds, dv, n, k, stream)
                  : launch<float, 2>(g, wij, nd, ds, dv, n, k, stream);
}
