// K6: PaiNN message block and its K-sum, dense (N, K) layout.
//
// Replaces: lagrangebench_tpu/ops/painn_msg.py::_msg_kernel, launched by
// _painn_message_pallas. Per receiver i over its K slots, at any hidden
// width H:
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
// Design: one warp per receiver, each lane owning V adjacent channels (V = 4
// where H % 4 == 0, else 2 or 1, so that every row segment is aligned for
// one V-wide load), so that a warp reads whole 32 V-channel segments (512
// bytes of float32 at V = 4); the warp walks the H channels in such
// segments (one at H = 128, two at H = 256), each with its own K-sum in
// registers, slot by slot in k order (the same on every run), and writes
// the outputs once. No shared memory; 8 warps per block. The segment loop
// carries to any H.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 8;

// V consecutive values of T at p (aligned for one V-wide load) as float
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

__device__ __forceinline__ float2 bf2(unsigned int raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}

template <int V>
__device__ __forceinline__ void loadv(const bf16* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = bf2(raw.x), b = bf2(raw.y);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  } else if constexpr (V == 2) {
    const float2 a = bf2(__ldg(reinterpret_cast<const unsigned int*>(p)));
    x[0] = a.x;
    x[1] = a.y;
  } else {
    x[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <int V>
__device__ __forceinline__ void storev(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

template <typename T, int DIM, int V>
__global__ void __launch_bounds__(WARPS * 32)
    painn_msg(const T* __restrict__ g, const T* __restrict__ wij, const T* __restrict__ nd,
              float* __restrict__ ds, float* __restrict__ dv, int n, int k, int h) {
  const int64_t gw = (int64_t)(3 + DIM) * h;
  const int node = blockIdx.x * WARPS + threadIdx.x / 32;
  if (node >= n) return;
  const int64_t row0 = (int64_t)node * k;
  for (int c = (threadIdx.x % 32) * V; c < h; c += 32 * V) {  // this lane's segments
    float s[V], v[DIM][V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) v[d][i] = 0.f;
    }
#pragma unroll 2
    for (int j = 0; j < k; ++j) {
      const int64_t row = row0 + j;
      const T* gr = g + row * gw;
      const T* wr = wij + row * (3 * h);
      float w1[V], w2[V], w3[V], x1[V], x2[V], x3[V];
      loadv<V>(wr + c, w1);
      loadv<V>(wr + h + c, w2);
      loadv<V>(wr + 2 * h + c, w3);
      loadv<V>(gr + c, x1);
      loadv<V>(gr + h + c, x2);
      loadv<V>(gr + 2 * h + c, x3);
      float m1[V], m2[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += w1[i] * x1[i];
        m1[i] = w2[i] * x2[i];
        m2[i] = w3[i] * x3[i];
      }
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        const float ndd = to_f(nd[row * DIM + d]);
        float u[V];
        loadv<V>(gr + (3 + d) * h + c, u);
#pragma unroll
        for (int i = 0; i < V; ++i) v[d][i] += ndd * m1[i] + u[i] * m2[i];
      }
    }
    storev<V>(ds + (int64_t)node * h + c, s);
#pragma unroll
    for (int d = 0; d < DIM; ++d) storev<V>(dv + (int64_t)node * DIM * h + d * h + c, v[d]);
  }
}

template <typename T, int DIM>
int launch(const void* g, const void* wij, const void* nd, void* ds, void* dv, int n, int k,
           int h, cudaStream_t stream) {
  const dim3 grid(lbt::ceil_div(n, WARPS)), block(WARPS * 32);
  const T *pg = static_cast<const T*>(g), *pw = static_cast<const T*>(wij),
          *pn = static_cast<const T*>(nd);
  float *pds = static_cast<float*>(ds), *pdv = static_cast<float*>(dv);
  if (h % 4 == 0)
    painn_msg<T, DIM, 4><<<grid, block, 0, stream>>>(pg, pw, pn, pds, pdv, n, k, h);
  else if (h % 2 == 0)
    painn_msg<T, DIM, 2><<<grid, block, 0, stream>>>(pg, pw, pn, pds, pdv, n, k, h);
  else
    painn_msg<T, DIM, 1><<<grid, block, 0, stream>>>(pg, pw, pn, pds, pdv, n, k, h);
  return (int)cudaGetLastError();
}

}  // namespace

// g, wij, nd in the compute type (is_bf16 ? bf16 : float32), ds and dv
// float32; g, wij, ds and dv aligned for loads of V elements (V = 4 where
// h % 4 == 0, else 2 where h % 2 == 0, else 1).
LBT_EXPORT int lbt_painn_msg(const void* g, const void* wij, const void* nd, void* ds, void* dv,
                             int n, int k, int h, int dim, int is_bf16, cudaStream_t stream) {
  if (h < 1 || n < 1 || k < 1 || (dim != 2 && dim != 3)) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dim == 3 ? launch<bf16, 3>(g, wij, nd, ds, dv, n, k, h, stream)
                    : launch<bf16, 2>(g, wij, nd, ds, dv, n, k, h, stream);
  return dim == 3 ? launch<float, 3>(g, wij, nd, ds, dv, n, k, h, stream)
                  : launch<float, 2>(g, wij, nd, ds, dv, n, k, h, stream);
}
