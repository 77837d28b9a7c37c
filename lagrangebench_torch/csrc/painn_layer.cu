// K5: one fused PaiNN layer (everything after the interaction context net),
// dense (N, K) layout.
//
// Replaces: lagrangebench_tpu/ops/painn_msg.py::_layer_kernel, launched by
// _painn_layer_pallas. Per receiver, with H = 128 channels, R = 20 radial
// basis functions and d over the dim axes:
//
//   W      = (phi[:, :R] @ filt_w + filt_b) * phi[:, R]     (K, 3H) filters
//   ds     = sum_K W[:H] * g[:H]
//   msg1   = W[H:2H] * g[H:2H]
//   dv_d   = sum_K (nd_d * msg1 + W[2H:] * g[(2+d)H:(3+d)H])
//   s1     = T(s + clip(ds)),  v1_d = T(v_d + clip(dv_d))
//   vm_d   = v1_d @ vmix_w = [vl_d, vr_d]
//   ts     = T([s1, sqrt(sum_d vr_d^2 + 1e-8)])
//   z      = T(silu(ts @ mix_w1 + mix_b1)),  m = z @ mix_w2 + mix_b2
//   s_out  = T(s1 + clip(m[:H] + m[2H:] * sum_d vr_d vl_d))
//   v_out_d = T(v1_d + clip(vl_d * m[H:2H]))
//
// with clip to +-100 and T the compute type (float32 or bf16) of every
// activation input and output; products of T operands are summed in float32,
// as the TPU kernel's jnp.dot(..., preferred_element_type=float32) does.
//
// Bound on an H100: bytes. The edge rows (g, (2 + dim) H wide, and phi,
// R + 1 wide) dominate: ~2.8 KB per edge in float32 against ~16 kFLOP (the
// filter product 2 R 3H plus the messages), ~6 FLOP per byte, below the
// ~20 FLOP per byte at which the card's CUDA-core float32 rate (67 TFLOP/s)
// would bind instead.
//
// Design: one block of 128 threads per tile of 8 receivers; thread c owns
// channel c. Edge phase: each thread keeps its three filter columns
// (3 x 20 values of filt_w) and biases in registers for the whole tile, so a
// filter costs 60 register FMAs; the receiver's K basis rows (padded to 24)
// and directions are staged in shared memory and read as broadcasts; the
// K-sums run in registers, slot by slot in k order. Node phase: the tile's
// s1, v1_d, ts, z and m live in shared memory as float32 rows; the three
// products (vmix, mix_w1, mix_w2) are the kernel's own CUDA-core FMA loops
// over the tile's rows, each thread one output column with the rows'
// accumulators in registers, weights read from global memory through L1/L2
// (vmix_w, mix_w1 and mix_w2 take 448 KB in float32, more than a block's
// 227 KB of shared memory; each tile reads each weight once, coalesced).
// No tensor cores, TMA or wgmma: a simple, right kernel first.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int H = 128;
constexpr int R = 20;       // radial basis functions (build_painn)
constexpr int RP = 24;      // padded basis row in shared memory (float4 reads)
constexpr int TR = 8;       // receivers per block
constexpr int THREADS = H;  // thread c owns channel c
constexpr float kClip = 100.f;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }
__device__ __forceinline__ float clip(float v) { return fminf(fmaxf(v, -kClip), kClip); }

struct Args {
  const void* g;      // (N, K, (2 + dim) H) T
  const void* phi;    // (N, K, R + 1) T
  const void* nd;     // (N, K, dim) T
  const void* s;      // (N, H) T
  const void* v;      // (N, dim H) T
  const void* filt_w;  // (R, 3H) T
  const float* filt_b;  // (3H)
  const void* vmix_w;  // (H, 2H) T
  const void* mix_w1;  // (2H, H) T
  const float* mix_b1;  // (H)
  const void* mix_w2;  // (H, 3H) T
  const float* mix_b2;  // (3H)
  void* s_out;        // (N, H) T
  void* v_out;        // (N, dim H) T
  int n, k;
};

// Shared-memory layout (float32), fixed part; the K basis rows and
// directions of the current receiver follow it.
template <int DIM>
struct Smem {
  static constexpr int kS1 = 0;
  static constexpr int kV1 = kS1 + TR * H;
  static constexpr int kVM = kV1 + TR * DIM * H;
  static constexpr int kTS = kVM + TR * DIM * 2 * H;
  static constexpr int kZ = kTS + TR * 2 * H;
  static constexpr int kDot = kZ + TR * H;
  static constexpr int kM = kDot + TR * H;
  static constexpr int kPhi = kM + TR * 3 * H;
  static int bytes(int k) { return (kPhi + k * (RP + 4)) * 4; }
};

// C[ROWS, cols] = A[ROWS, kd] @ W[kd, cols] (+ bias). A: float32 rows in
// shared memory (row stride lda, a multiple of 4); W: row-major T in global
// memory; each thread computes whole output columns, ROWS accumulators in
// registers, the sum over kd in order.
template <typename T, int ROWS>
__device__ void tile_gemm(const float* A, int lda, const T* __restrict__ W, int kd, int cols,
                          const float* __restrict__ bias, float* C, int ldc) {
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < kd; kk += 4) {
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = to_f(W[(int64_t)(kk + q) * cols + c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(A + r * lda + kk);
        acc[r] = fmaf(a.x, w[0], acc[r]);
        acc[r] = fmaf(a.y, w[1], acc[r]);
        acc[r] = fmaf(a.z, w[2], acc[r]);
        acc[r] = fmaf(a.w, w[3], acc[r]);
      }
    }
    const float b = bias != nullptr ? bias[c] : 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) C[r * ldc + c] = acc[r] + b;
  }
}

template <typename T, int DIM>
__global__ void __launch_bounds__(THREADS, 3) painn_layer(const Args a) {
  using L = Smem<DIM>;
  constexpr int GW = (2 + DIM) * H;
  extern __shared__ __align__(16) float smem[];
  float* sS1 = smem + L::kS1;   // (TR, H)        s1
  float* sV1 = smem + L::kV1;   // (TR DIM, H)    v1_d, row i * DIM + d
  float* sVM = smem + L::kVM;   // (TR DIM, 2H)   [vl_d, vr_d]
  float* sTS = smem + L::kTS;   // (TR, 2H)       ts
  float* sZ = smem + L::kZ;     // (TR, H)        z
  float* sDot = smem + L::kDot;  // (TR, H)       sum_d vr_d vl_d
  float* sM = smem + L::kM;     // (TR, 3H)       m
  float* sPhi = smem + L::kPhi;  // (K, RP)       basis rows of one receiver
  float* sNd = sPhi + a.k * RP;  // (K, 4)        its directions

  const int K = a.k;
  const int c = threadIdx.x;
  const int node0 = blockIdx.x * TR;
  const int nodes = min(TR, a.n - node0);
  const T* g = static_cast<const T*>(a.g);
  const T* phi = static_cast<const T*>(a.phi);
  const T* nd = static_cast<const T*>(a.nd);
  const T* s = static_cast<const T*>(a.s);
  const T* v = static_cast<const T*>(a.v);

  // this channel's three filter columns and biases, for the whole tile
  const T* fw = static_cast<const T*>(a.filt_w);
  float f0[R], f1[R], f2[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    f0[q] = to_f(fw[q * 3 * H + c]);
    f1[q] = to_f(fw[q * 3 * H + H + c]);
    f2[q] = to_f(fw[q * 3 * H + 2 * H + c]);
  }
  const float b0 = a.filt_b[c], b1 = a.filt_b[H + c], b2 = a.filt_b[2 * H + c];

  // ---- edge phase: filters, messages, K-sums, clipped residuals
  for (int i = 0; i < TR; ++i) {
    float ds = 0.f, dv[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dv[d] = 0.f;
    const int64_t node = node0 + i;
    if (i < nodes) {  // uniform over the block
      const int64_t row0 = node * K;
      __syncthreads();  // the previous receiver is done with sPhi / sNd
      for (int e = c; e < K * (R + 1); e += THREADS)
        sPhi[(e / (R + 1)) * RP + e % (R + 1)] = to_f(phi[row0 * (R + 1) + e]);
      for (int e = c; e < K * DIM; e += THREADS) sNd[(e / DIM) * 4 + e % DIM] = to_f(nd[row0 * DIM + e]);
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < K; ++j) {
        const float* ph = sPhi + j * RP;
        float w0 = 0.f, w1 = 0.f, w2 = 0.f;
#pragma unroll
        for (int q = 0; q < R; q += 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(ph + q);
          w0 = fmaf(p4.x, f0[q], w0);
          w1 = fmaf(p4.x, f1[q], w1);
          w2 = fmaf(p4.x, f2[q], w2);
          w0 = fmaf(p4.y, f0[q + 1], w0);
          w1 = fmaf(p4.y, f1[q + 1], w1);
          w2 = fmaf(p4.y, f2[q + 1], w2);
          w0 = fmaf(p4.z, f0[q + 2], w0);
          w1 = fmaf(p4.z, f1[q + 2], w1);
          w2 = fmaf(p4.z, f2[q + 2], w2);
          w0 = fmaf(p4.w, f0[q + 3], w0);
          w1 = fmaf(p4.w, f1[q + 3], w1);
          w2 = fmaf(p4.w, f2[q + 3], w2);
        }
        const float scale = ph[R];
        w0 = (w0 + b0) * scale;
        w1 = (w1 + b1) * scale;
        w2 = (w2 + b2) * scale;
        const T* gr = g + (row0 + j) * GW;
        ds += w0 * to_f(gr[c]);
        const float m1 = w1 * to_f(gr[H + c]);
#pragma unroll
        for (int d = 0; d < DIM; ++d)
          dv[d] += sNd[j * 4 + d] * m1 + w2 * to_f(gr[(2 + d) * H + c]);
      }
    }
    // rows past the last receiver stay 0 through the node phase
    sS1[i * H + c] = i < nodes ? round_to<T>(to_f(s[node * H + c]) + clip(ds)) : 0.f;
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      sV1[(i * DIM + d) * H + c] =
          i < nodes ? round_to<T>(to_f(v[node * DIM * H + d * H + c]) + clip(dv[d])) : 0.f;
  }
  __syncthreads();

  // ---- node phase
  tile_gemm<T, TR * DIM>(sV1, H, static_cast<const T*>(a.vmix_w), H, 2 * H, nullptr, sVM, 2 * H);
  __syncthreads();
  for (int i = 0; i < TR; ++i) {
    float nrm = 0.f, dot = 0.f;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const float vl = sVM[(i * DIM + d) * 2 * H + c];
      const float vr = sVM[(i * DIM + d) * 2 * H + H + c];
      nrm += vr * vr;
      dot += vr * vl;
    }
    sTS[i * 2 * H + c] = sS1[i * H + c];
    sTS[i * 2 * H + H + c] = round_to<T>(sqrtf(nrm + kEps));
    sDot[i * H + c] = dot;
  }
  __syncthreads();
  tile_gemm<T, TR>(sTS, 2 * H, static_cast<const T*>(a.mix_w1), 2 * H, H, a.mix_b1, sZ, H);
  __syncthreads();
  for (int i = 0; i < TR; ++i) {
    const float z = sZ[i * H + c];
    sZ[i * H + c] = round_to<T>(z * (1.f / (1.f + expf(-z))));
  }
  __syncthreads();
  tile_gemm<T, TR>(sZ, H, static_cast<const T*>(a.mix_w2), H, 3 * H, a.mix_b2, sM, 3 * H);
  __syncthreads();

  T* s_out = static_cast<T*>(a.s_out);
  T* v_out = static_cast<T*>(a.v_out);
  for (int i = 0; i < nodes; ++i) {
    const int64_t node = node0 + i;
    const float* m = sM + i * 3 * H;
    s_out[node * H + c] = from_f<T>(sS1[i * H + c] + clip(m[c] + m[2 * H + c] * sDot[i * H + c]));
    const float dv2 = m[H + c];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const float vl = sVM[(i * DIM + d) * 2 * H + c];
      v_out[node * DIM * H + d * H + c] = from_f<T>(sV1[(i * DIM + d) * H + c] + clip(vl * dv2));
    }
  }
}

template <typename T, int DIM>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = Smem<DIM>::bytes(a.k);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // K too large for one block
  cudaError_t err = cudaFuncSetAttribute(painn_layer<T, DIM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  painn_layer<T, DIM><<<lbt::ceil_div(a.n, TR), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs (host array of device pointers), in order:
//   0 g, 1 phi, 2 nd, 3 s, 4 v, 5 filt_w, 6 filt_b, 7 vmix_w, 8 mix_w1,
//   9 mix_b1, 10 mix_w2, 11 mix_b2, 12 s_out, 13 v_out.
// Matrices and activations in the compute type (is_bf16 ? bf16 : float32),
// biases float32.
LBT_EXPORT int lbt_painn_layer(const void* const* ptrs, int n, int k, int h, int r, int dim,
                               int is_bf16, cudaStream_t stream) {
  if (h != H || r != R || n < 1 || k < 1 || (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.g = ptrs[0];
  a.phi = ptrs[1];
  a.nd = ptrs[2];
  a.s = ptrs[3];
  a.v = ptrs[4];
  a.filt_w = ptrs[5];
  a.filt_b = static_cast<const float*>(ptrs[6]);
  a.vmix_w = ptrs[7];
  a.mix_w1 = ptrs[8];
  a.mix_b1 = static_cast<const float*>(ptrs[9]);
  a.mix_w2 = ptrs[10];
  a.mix_b2 = static_cast<const float*>(ptrs[11]);
  a.s_out = const_cast<void*>(ptrs[12]);
  a.v_out = const_cast<void*>(ptrs[13]);
  a.n = n;
  a.k = k;
  if (is_bf16) return dim == 3 ? launch<bf16, 3>(a, stream) : launch<bf16, 2>(a, stream);
  return dim == 3 ? launch<float, 3>(a, stream) : launch<float, 2>(a, stream);
}
