// K4: the backward of one fused GNS message-passing step, dense (N, K)
// layout.
//
// Replaces: lagrangebench_tpu/ops/fused_mp.py::_fused_bwd_kernel, launched
// by _gns_mp_step_bwd_pallas. Per receiver, with F = 128, it rematerializes
// the forward of K3 (csrc/fused_mp.cu) from the inputs,
//
//   first = e @ W_e + hs + hr + b1,  r1 = relu(first)
//   x1    = T(r1) @ W2 + b2,  m = LN1(x1),  agg = sum_K m * mask
//   nf    = h @ W_nh + T(agg) @ W_na + bn1,  r2 = relu(nf)
//   y1    = T(r2) @ W_n2 + bn2,  h' = h + LN2(y1)
//
// and from the cotangents ge = d e', gh = d h' computes de, dhs (= d first),
// dhr, dh and the 13 parameter gradients, with the TPU kernel's casts:
// dy1, dnf, dx1 and dfirst are rounded to the compute type T before their
// products, which accumulate in float32; LayerNorm and its backward run in
// float32. A float32 instance (CUDA-core FMAs) exists to check the
// arithmetic against the plain version with TF32 off.
//
// Bound on an H100: bytes. Per edge row it reads e, hs, ge and writes de,
// dhs (5 x 256 B in bf16) against 6 x 2 x 128 x 128 FLOP of edge products
// that the function needs (the forward rematerialization adds 4 more).
//
// Design: a persistent grid of about one block per SM; each block of 8
// warps walks receiver tiles of 16. The node path needs agg, which needs
// every edge of the tile, and the tile's float32 LayerNorm activations do
// not fit in shared memory (16 x 40 rows x 128 x 4 B = 320 KB), so the
// tile's edges stream through shared memory twice, 64 rows at a time:
//   pass 1: rematerialize to agg; then the node-path backward, which
//           leaves dagg in shared memory;
//   pass 2: rematerialize again; then the edge-path backward with dagg.
// Products are bf16 nvcuda::wmma 16x16x16 tiles with float32 accumulators
// (the transposed operands load as col_major fragments). The weights take
// turns in three shared-memory slots: W_e, W2 for the edge passes, W_nh,
// W_na, W_n2 for the node path; in pass 2 the free third slot holds the
// bf16 dx1 / dfirst chunk. Weight gradients are deterministic: no atomics.
// Each block accumulates its own float32 partials (the five matrix
// gradients in device memory, owned by one warp per 16x16 tile; the eight
// vector gradients in registers, row by row, then summed over the warps in
// order), and a second launch sums the partials in block order. dhr sums a
// receiver's K rows in k order. Simple first: no TMA, no wgmma.
#include "mp_common.cuh"

namespace {

constexpr int TR = 16;  // receivers per tile
constexpr int M = 64;   // edge rows per chunk
constexpr int NV = 8;   // vector gradients
constexpr int GRADS = 5 * F * F + NV * F;  // floats of one block's partials

// partials layout: dW_e, dW2, dW_nh, dW_na, dW_n2 (F x F, row-major), then
// the vectors in the order of Args::vec
enum { G_WE = 0, G_W2 = 1, G_WNH = 2, G_WNA = 3, G_WN2 = 4 };
enum { V_B1 = 0, V_B2, V_G1, V_BE1, V_BN1, V_BN2, V_G2, V_BE2 };

struct Args {
  const void* e;      // (N, K, F) T
  const void* hs;     // (N, K, F) T: gathered sender projections
  const void* hr;     // (N, F) T
  const void* h;      // (N, F) T
  const float* mask;  // (N, K)
  const void* ge;     // (N, K, F) T: d e'
  const void* gh;     // (N, F) T: d h'
  void* de;           // (N, K, F) T
  void* dhs;          // (N, K, F) T
  void* dhr;          // (N, F) T
  void* dh;           // (N, F) T
  const void* w[5];   // W_e, W2, W_nh, W_na, W_n2: (F, F) T, row-major (in, out)
  const float* vec[8];  // b1, b2, ln1 scale, ln1 bias, bn1, bn2, ln2 scale, ln2 bias
  float* partials;    // (gridDim.x, GRADS)
  int n, k;
};

template <typename T>
struct Smem {
  static constexpr bool kStage = Layout<T>::kStageWeights;
  static constexpr int LDA = Layout<T>::LDA;
  static constexpr int kW = kStage ? F * LDA * (int)sizeof(T) : 0;
  static constexpr int kA = M * LDA * (int)sizeof(T);
  static constexpr int kC = kStage ? 0 : kA;  // bf16: in the third weight slot
  static constexpr int kF = M * LDF * 4;
  static constexpr int kNode = TR * F * 4;
  static constexpr int kBytes = 3 * kW + 2 * kA + kC + 2 * kF + 2 * kNode;
};

// C[rows, F] = A[rows, F] @ W^T, W (F, F) row-major (in, out); rows % 16 == 0.
template <typename T>
__device__ void block_gemm_nt(const T* A, const T* W, float* C, int rows);

template <>
__device__ void block_gemm_nt<bf16>(const bf16* A, const bf16* W, float* C, int rows) {
  constexpr int LDA = Layout<bf16>::LDA;
  const int warp = threadIdx.x / 32;
  const int tiles = (rows / 16) * (F / 16);
  for (int t = warp; t < tiles; t += WARPS) {
    const int r0 = (t / (F / 16)) * 16, c0 = (t % (F / 16)) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
    wmma::fill_fragment(fc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < F; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, A + r0 * LDA + kk, LDA);
      // W^T[kk.., c0..]: element (k, n) at W[(c0 + n) * LDA + kk + k]
      wmma::load_matrix_sync(fb, W + c0 * LDA + kk, LDA);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(C + r0 * LDF + c0, fc, LDF, wmma::mem_row_major);
  }
}

template <>
__device__ void block_gemm_nt<float>(const float* A, const float* W, float* C, int rows) {
  constexpr int LDA = Layout<float>::LDA;
  const int c = threadIdx.x % F;
  for (int r0 = (threadIdx.x / F) * 8; r0 < rows; r0 += (THREADS / F) * 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int kk = 0; kk < F; ++kk) {
      const float w = W[c * F + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += A[(r0 + i) * LDA + kk] * w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) C[(r0 + i) * LDF + c] = acc[i];
  }
}

// G[F, F] += A[rows, F]^T @ B[rows, F], G a float32 matrix in device memory
// (row stride F) that this block alone writes; rows % 16 == 0.
template <typename T>
__device__ void block_gemm_tn(const T* A, const T* B, float* G, int rows);

template <>
__device__ void block_gemm_tn<bf16>(const bf16* A, const bf16* B, float* G, int rows) {
  constexpr int LDA = Layout<bf16>::LDA;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (F / 16) * (F / 16); t += WARPS) {
    const int i0 = (t / (F / 16)) * 16, j0 = (t % (F / 16)) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
    wmma::load_matrix_sync(fc, G + i0 * F + j0, F, wmma::mem_row_major);
    for (int kk = 0; kk < rows; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      // A^T[i0.., kk..]: element (i, r) at A[(kk + r) * LDA + i0 + i]
      wmma::load_matrix_sync(fa, A + kk * LDA + i0, LDA);
      wmma::load_matrix_sync(fb, B + kk * LDA + j0, LDA);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(G + i0 * F + j0, fc, F, wmma::mem_row_major);
  }
}

template <>
__device__ void block_gemm_tn<float>(const float* A, const float* B, float* G, int rows) {
  constexpr int LDA = Layout<float>::LDA;
  for (int idx = threadIdx.x; idx < F * F; idx += THREADS) {
    const int i = idx / F, j = idx % F;
    float s = G[idx];
    for (int r = 0; r < rows; ++r) s += A[r * LDA + i] * B[r * LDA + j];
    G[idx] = s;
  }
}

// Row statistics of one F-wide float row held by a warp (4 values per
// lane): xhat = (x - mean) * inv in place; returns inv.
__device__ __forceinline__ float warp_normalize(float (&x)[F / 32]) {
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
  for (int i = 0; i < F / 32; ++i) x[i] = (x[i] - mean) * inv;
  return inv;
}

// LayerNorm input gradient of a warp-held row: dx = inv * (dxhat - mean(dxhat)
// - xhat * mean(dxhat * xhat)), dxhat = dy * scale. Overwrites dy with dx.
__device__ __forceinline__ void warp_ln_bwd(float (&dy)[F / 32], const float (&xhat)[F / 32],
                                            float inv, const float* scale, int lane) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < F / 32; ++i) {
    dy[i] *= scale[lane + 32 * i];
    s1 += dy[i];
    s2 += dy[i] * xhat[i];
  }
  const float m1 = lbt::warp_sum(s1) * (1.f / F);
  const float m2 = lbt::warp_sum(s2) * (1.f / F);
#pragma unroll
  for (int i = 0; i < F / 32; ++i) dy[i] = inv * (dy[i] - m1 - xhat[i] * m2);
}

// The tile's edge rows [c0, c0 + rows) -> sA (e) and sB (T(relu(first))),
// first = e @ W_e + hs + hr + b1; rows past `rows` up to rows_pad are zero.
// Leaves relu(first) @ W2 in sF. Starts and ends with the block in step.
template <typename T>
__device__ void remat_chunk(const Args& a, const T* wE, const T* w2, T* sA, T* sB,
                            float* sF, int64_t row0, int node0, int c0, int rows,
                            int rows_pad) {
  constexpr int LDA = Layout<T>::LDA;
  constexpr int V = 16 / sizeof(T);
  const T* e = static_cast<const T*>(a.e);
  const T* hs = static_cast<const T*>(a.hs);
  const T* hr = static_cast<const T*>(a.hr);
  for (int i = threadIdx.x; i < rows_pad * (F / V); i += THREADS) {
    const int r = i / (F / V), c = (i % (F / V)) * V;
    int4 v = make_int4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const int4*>(e + (row0 + c0 + r) * F + c);
    *reinterpret_cast<int4*>(sA + r * LDA + c) = v;
  }
  __syncthreads();
  block_gemm<T>(sA, wE, sF, rows_pad, false);
  __syncthreads();
  for (int i = threadIdx.x; i < rows_pad * F; i += THREADS) {
    const int r = i / F, c = i % F;
    float x = 0.f;
    if (r < rows) {
      const int64_t er = row0 + c0 + r;
      const int64_t node = node0 + (c0 + r) / a.k;
      x = sF[r * LDF + c] + to_f(hs[er * F + c]);
      x = x + to_f(hr[node * F + c]) + a.vec[V_B1][c];
      x = fmaxf(x, 0.f);
    }
    sB[r * LDA + c] = from_f<T>(x);
  }
  __syncthreads();
  block_gemm<T>(sB, w2, sF, rows_pad, false);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd(const Args a) {
  using S = Smem<T>;
  constexpr int LDA = Layout<T>::LDA;
  constexpr bool kStage = S::kStage;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sW0 = reinterpret_cast<T*>(smem);
  T* sW1 = reinterpret_cast<T*>(smem + S::kW);
  T* sW2 = reinterpret_cast<T*>(smem + 2 * S::kW);
  unsigned char* p = smem + 3 * S::kW;
  T* sA = reinterpret_cast<T*>(p);
  T* sB = reinterpret_cast<T*>(p + S::kA);
  T* sC = kStage ? sW2 : reinterpret_cast<T*>(p + 2 * S::kA);
  p += 2 * S::kA + S::kC;
  float* sF = reinterpret_cast<float*>(p);
  float* sG = reinterpret_cast<float*>(p + S::kF);
  float* sNode = reinterpret_cast<float*>(p + 2 * S::kF);  // agg, then dagg
  float* sDhr = reinterpret_cast<float*>(p + 2 * S::kF + S::kNode);

  const int K = a.k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (a.n + TR - 1) / TR;
  float* part = a.partials + (int64_t)blockIdx.x * GRADS;
  const T* ge = static_cast<const T*>(a.ge);
  const T* gh = static_cast<const T*>(a.gh);
  const T* h = static_cast<const T*>(a.h);

  // the weights in use: staged in shared memory (bf16) or read from global
  const T* wE = static_cast<const T*>(a.w[0]);
  const T* w2 = static_cast<const T*>(a.w[1]);
  const T* wNh = static_cast<const T*>(a.w[2]);
  const T* wNa = static_cast<const T*>(a.w[3]);
  const T* wN2 = static_cast<const T*>(a.w[4]);
  if constexpr (kStage) {
    stage_weight<T>(sW0, a.w[0]);
    stage_weight<T>(sW1, a.w[1]);
  }
  const T* wE_s = kStage ? sW0 : wE;
  const T* w2_s = kStage ? sW1 : w2;
  const T* wNh_s = kStage ? sW0 : wNh;
  const T* wNa_s = kStage ? sW1 : wNa;
  const T* wN2_s = kStage ? sW2 : wN2;

  for (int i = threadIdx.x; i < 5 * F * F; i += THREADS) part[i] = 0.f;
  float vacc[NV][F / 32];  // this thread's vector-gradient sums (row per warp)
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < F / 32; ++i) vacc[v][i] = 0.f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int node0 = tile * TR;
    const int nodes = min(TR, a.n - node0);
    const int rows_tile = nodes * K;
    const int64_t row0 = (int64_t)node0 * K;
    __syncthreads();  // previous tile done; edge weights staged
    for (int i = threadIdx.x; i < TR * F; i += THREADS) {
      sNode[i] = 0.f;
      sDhr[i] = 0.f;
    }

    // ---- pass 1: rematerialize to agg ----------------------------------
    for (int c0 = 0; c0 < rows_tile; c0 += M) {
      const int rows = min(M, rows_tile - c0);
      const int rows_pad = (rows + 15) / 16 * 16;
      __syncthreads();
      remat_chunk<T>(a, wE_s, w2_s, sA, sB, sF, row0, node0, c0, rows, rows_pad);
      for (int r = warp; r < rows; r += WARPS) {
        float x[F / 32];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) x[i] = sF[r * LDF + lane + 32 * i] + a.vec[V_B2][lane + 32 * i];
        warp_normalize(x);
        const float m = a.mask[row0 + c0 + r];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          const int c = lane + 32 * i;
          sF[r * LDF + c] = (x[i] * a.vec[V_G1][c] + a.vec[V_BE1][c]) * m;
        }
      }
      __syncthreads();
      if (threadIdx.x < F) {  // agg, row by row in k order
        const int c = threadIdx.x;
        for (int r = 0; r < rows; ++r) sNode[((c0 + r) / K) * F + c] += sF[r * LDF + c];
      }
    }
    __syncthreads();

    // ---- node-path backward (TR rows; rows past `nodes` are zero) --------
    if constexpr (kStage) {
      stage_weight<T>(sW0, a.w[2]);
      stage_weight<T>(sW1, a.w[3]);
      stage_weight<T>(sW2, a.w[4]);
    }
    T* nH = sA;
    T* nAggc = sA + TR * LDA;
    T* nR2c = sA + 2 * TR * LDA;
    T* nDy1c = sA + 3 * TR * LDA;
    T* nDnfc = sB;
    float* nR2 = sF;             // r2 = relu(nf)
    float* nY = sF + TR * LDF;   // y1
    float* nDnf = sF + 2 * TR * LDF;
    float* nDh = sG;             // dnfc @ W_nh^T
    float* nDagg = sG + TR * LDF;
    for (int i = threadIdx.x; i < TR * F; i += THREADS) {
      const int r = i / F, c = i % F;
      nH[r * LDA + c] = r < nodes ? h[(int64_t)(node0 + r) * F + c] : from_f<T>(0.f);
      nAggc[r * LDA + c] = from_f<T>(sNode[i]);
    }
    __syncthreads();
    block_gemm<T>(nH, wNh_s, nR2, TR, false);
    __syncthreads();
    block_gemm<T>(nAggc, wNa_s, nR2, TR, true);
    __syncthreads();
    for (int i = threadIdx.x; i < TR * F; i += THREADS) {
      const int r = i / F, c = i % F;
      const float r2 = fmaxf(nR2[r * LDF + c] + a.vec[V_BN1][c], 0.f);
      nR2[r * LDF + c] = r2;
      nR2c[r * LDA + c] = from_f<T>(r2);
    }
    __syncthreads();
    block_gemm<T>(nR2c, wN2_s, nY, TR, false);
    __syncthreads();
    for (int r = warp; r < TR; r += WARPS) {
      float x[F / 32], g[F / 32];
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        const int c = lane + 32 * i;
        x[i] = nY[r * LDF + c] + a.vec[V_BN2][c];
        g[i] = r < nodes ? to_f(gh[(int64_t)(node0 + r) * F + c]) : 0.f;
      }
      const float inv = warp_normalize(x);
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        vacc[V_G2][i] += g[i] * x[i];
        vacc[V_BE2][i] += g[i];
      }
      warp_ln_bwd(g, x, inv, a.vec[V_G2], lane);
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        vacc[V_BN2][i] += g[i];
        nDy1c[r * LDA + lane + 32 * i] = from_f<T>(g[i]);
      }
    }
    __syncthreads();
    block_gemm_tn<T>(nR2c, nDy1c, part + G_WN2 * F * F, TR);
    block_gemm_nt<T>(nDy1c, wN2_s, nDnf, TR);
    __syncthreads();
    for (int r = warp; r < TR; r += WARPS) {
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        const int c = lane + 32 * i;
        const float d = nR2[r * LDF + c] > 0.f ? nDnf[r * LDF + c] : 0.f;
        vacc[V_BN1][i] += d;
        nDnfc[r * LDA + c] = from_f<T>(d);
      }
    }
    __syncthreads();
    block_gemm_tn<T>(nH, nDnfc, part + G_WNH * F * F, TR);
    block_gemm_tn<T>(nAggc, nDnfc, part + G_WNA * F * F, TR);
    block_gemm_nt<T>(nDnfc, wNh_s, nDh, TR);
    block_gemm_nt<T>(nDnfc, wNa_s, nDagg, TR);
    __syncthreads();
    {
      T* dh = static_cast<T*>(a.dh);
      for (int i = threadIdx.x; i < TR * F; i += THREADS) {
        const int r = i / F, c = i % F;
        if (r < nodes) {
          const int64_t at = (int64_t)(node0 + r) * F + c;
          dh[at] = from_f<T>(to_f(gh[at]) + nDh[r * LDF + c]);
        }
        sNode[i] = nDagg[r * LDF + c];
      }
    }
    __syncthreads();

    // ---- pass 2: rematerialize again, then the edge-path backward ---------
    if constexpr (kStage) {
      stage_weight<T>(sW0, a.w[0]);
      stage_weight<T>(sW1, a.w[1]);
    }
    T* de = static_cast<T*>(a.de);
    T* dhs = static_cast<T*>(a.dhs);
    for (int c0 = 0; c0 < rows_tile; c0 += M) {
      const int rows = min(M, rows_tile - c0);
      const int rows_pad = (rows + 15) / 16 * 16;
      __syncthreads();
      remat_chunk<T>(a, wE_s, w2_s, sA, sB, sF, row0, node0, c0, rows, rows_pad);
      // LN1 and its backward: dm = ge + dagg * mask -> dx1 -> sC
      for (int r = warp; r < rows_pad; r += WARPS) {
        if (r >= rows) {
#pragma unroll
          for (int i = 0; i < F / 32; ++i) sC[r * LDA + lane + 32 * i] = from_f<T>(0.f);
          continue;
        }
        const int64_t er = row0 + c0 + r;
        const int nl = (c0 + r) / K;
        float x[F / 32], d[F / 32];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) x[i] = sF[r * LDF + lane + 32 * i] + a.vec[V_B2][lane + 32 * i];
        const float inv = warp_normalize(x);
        const float m = a.mask[er];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          const int c = lane + 32 * i;
          d[i] = to_f(ge[er * F + c]) + sNode[nl * F + c] * m;
          vacc[V_G1][i] += d[i] * x[i];
          vacc[V_BE1][i] += d[i];
        }
        warp_ln_bwd(d, x, inv, a.vec[V_G1], lane);
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          vacc[V_B2][i] += d[i];
          sC[r * LDA + lane + 32 * i] = from_f<T>(d[i]);
        }
      }
      __syncthreads();
      block_gemm_tn<T>(sB, sC, part + G_W2 * F * F, rows_pad);  // dW2 += T(r1)^T dx1c
      block_gemm_nt<T>(sC, w2_s, sG, rows_pad);                // dx1c @ W2^T
      __syncthreads();
      // dfirst = (dx1c @ W2^T) * (first > 0) -> sG (float), sC (T), dhs
      for (int r = warp; r < rows_pad; r += WARPS) {
        const int64_t er = row0 + c0 + r;
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          const int c = lane + 32 * i;
          float d = 0.f;
          if (r < rows && to_f(sB[r * LDA + c]) > 0.f) d = sG[r * LDF + c];
          vacc[V_B1][i] += d;
          sG[r * LDF + c] = d;
          const T dc = from_f<T>(d);
          sC[r * LDA + c] = dc;
          if (r < rows) dhs[er * F + c] = dc;
        }
      }
      __syncthreads();
      if (threadIdx.x < F) {  // dhr, row by row in k order
        const int c = threadIdx.x;
        for (int r = 0; r < rows; ++r) sDhr[((c0 + r) / K) * F + c] += sG[r * LDF + c];
      }
      block_gemm_tn<T>(sA, sC, part + G_WE * F * F, rows_pad);  // dW_e += e^T dfirstc
      block_gemm_nt<T>(sC, wE_s, sF, rows_pad);                // dfirstc @ W_e^T
      __syncthreads();
      for (int i = threadIdx.x; i < rows * F; i += THREADS) {
        const int r = i / F, c = i % F;
        const int64_t at = (row0 + c0 + r) * F + c;
        de[at] = from_f<T>(to_f(ge[at]) + sF[r * LDF + c]);
      }
    }
    __syncthreads();
    T* dhr = static_cast<T*>(a.dhr);
    for (int i = threadIdx.x; i < nodes * F; i += THREADS)
      dhr[(int64_t)node0 * F + i] = from_f<T>(sDhr[i]);
  }

  // vector gradients: the warps' sums added in warp order
  __syncthreads();
  float* sVec = sF;
  for (int i = threadIdx.x; i < NV * F; i += THREADS) sVec[i] = 0.f;
  for (int w = 0; w < WARPS; ++w) {
    __syncthreads();
    if (warp == w) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int i = 0; i < F / 32; ++i) sVec[v * F + lane + 32 * i] += vacc[v][i];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NV * F; i += THREADS) part[5 * F * F + i] = sVec[i];
}

// out[j] = sum over blocks b, in order, of partials[b][j]
__global__ void reduce_partials(const float* partials, float* out, int blocks, int per_block) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= per_block) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partials[(int64_t)b * per_block + j];
  out[j] = s;
}

template <typename T>
int launch(const Args& a, int grid, cudaStream_t stream) {
  constexpr int smem = Smem<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mp_bwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mp_bwd<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs (host array of device pointers), in order:
//   0 e, 1 hs_gath, 2 hr, 3 h, 4 mask, 5 ge, 6 gh, 7 de, 8 dhs, 9 dhr, 10 dh,
//   11 W_e, 12 W2, 13 W_nh, 14 W_na, 15 W_n2,
//   16 b1, 17 b2, 18 ln1_scale, 19 ln1_bias, 20 bn1, 21 bn2, 22 ln2_scale,
//   23 ln2_bias, 24 partials ((grid, 5 F^2 + 8 F) float32).
LBT_EXPORT int lbt_fused_mp_bwd(const void* const* ptrs, int n, int k, int is_bf16, int grid,
                                cudaStream_t stream) {
  if (n < 1 || k < 1 || grid < 1 || grid > lbt::ceil_div(n, TR))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.e = ptrs[0];
  a.hs = ptrs[1];
  a.hr = ptrs[2];
  a.h = ptrs[3];
  a.mask = static_cast<const float*>(ptrs[4]);
  a.ge = ptrs[5];
  a.gh = ptrs[6];
  a.de = const_cast<void*>(ptrs[7]);
  a.dhs = const_cast<void*>(ptrs[8]);
  a.dhr = const_cast<void*>(ptrs[9]);
  a.dh = const_cast<void*>(ptrs[10]);
  for (int i = 0; i < 5; ++i) a.w[i] = ptrs[11 + i];
  for (int i = 0; i < 8; ++i) a.vec[i] = static_cast<const float*>(ptrs[16 + i]);
  a.partials = static_cast<float*>(const_cast<void*>(ptrs[24]));
  a.n = n;
  a.k = k;
  return is_bf16 ? launch<bf16>(a, grid, stream) : launch<float>(a, grid, stream);
}

LBT_EXPORT int lbt_fused_mp_bwd_reduce(const float* partials, float* out, int blocks,
                                       int per_block, cudaStream_t stream) {
  if (blocks < 1 || per_block != GRADS) return (int)cudaErrorInvalidValue;
  reduce_partials<<<lbt::ceil_div(per_block, 256), 256, 0, stream>>>(partials, out, blocks,
                                                                      per_block);
  return (int)cudaGetLastError();
}
