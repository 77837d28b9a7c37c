// K4: the backward of one fused GNS message-passing step, dense (N, K)
// layout.
//
// Replaces: lagrangebench_tpu/ops/fused_mp.py::_fused_bwd_kernel, launched
// by _gns_mp_step_bwd_pallas. Per receiver, at latent width nf in [1, 256]
// (every kernel is a template on the instance width F = 64 ceil(nf / 64),
// chosen by the entry points' `latent` argument nf; tensors and weights
// zero-padded to F, LayerNorm and its backward over the first nf channels,
// mp_common.cuh), it rematerializes
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
// dhs (5 x 2F B in bf16) against 6 x 2 x F x F FLOP of edge products
// that the function needs (the forward rematerialization adds 4 more).
//
// Design, bf16 at F = 64 and 128 (the warp design): four hand-written
// kernels and a sum, on
// the forward's machinery (mp_warp.cuh: warp-owned 16-row slices, cp.async
// rings, mma.sync m16n8k16 with register accumulators and register A
// operands, transposed products by ldmatrix without .trans on the same
// swizzled weight tiles). The node path needs agg, which needs every edge
// of a receiver, and dagg flows back into every edge row, so the step
// rematerializes its edges twice, as the TPU kernel does:
//   1. fused_mp_bwd_agg (K3's edge body, agg only): agg to a float32 scratch.
//   2. fused_mp_bwd_node: 4 warps x 16 nodes per block, W_nh, W_na, W_n2 staged once;
//      the node forward and its backward in registers; dh out, dagg to a
//      float32 scratch; the block's h, T(agg), T(r2), T(dy1), T(dnf) slices
//      stay in shared memory for its three weight gradients, which it
//      writes once to its own partials.
//   3. fused_mp_bwd_edge_a: persistent, 8 warps, W_e and W2 resident; the warps own
//      even shares of the block's receivers and step through their slices
//      in lockstep: each rematerializes first and x1, runs LN1's backward
//      (dm = ge + dagg * mask) into dx1, then dfirst = T(dx1) @ W2^T * (first
//      > 0) -> dhs (= T(dfirst)) and dhr (summed per receiver by its warp,
//      in row order). T(relu(first)) and T(dx1) go back into the slice's
//      ring slots, and after a block barrier each warp w < F / 16 adds its
//      16 rows [16 w, 16 w + 16) of dW2 += T(r1)^T T(dx1) over the 8 slices,
//      in a register accumulator it keeps for the whole launch (at F = 64
//      warps 4-7 own no rows and skip the sum).
//   4. fused_mp_bwd_edge_b: persistent, W_e resident, the same lockstep: de = ge +
//      dhs @ W_e^T, and dW_e += e^T dhs in registers for the whole launch,
//      rows owned as in 3.
//   5. fused_mp_bwd_reduce: each gradient summed over its kernel's blocks in
//      block order.
// No atomics: every sum has a fixed order, so the weight gradients are the
// same bits on every launch. The vector gradients are summed per warp by
// shuffles over each slice's rows (owner lanes keep them in registers),
// then over the warps in order. Shared memory at F = 128: the node kernel
// 186 KB, edge kernel a 226 KB (2 weights, 8 warps x 2 stages x (e, hs), 8
// warps x one ge slice), edge kernel b 224 KB (W_e, 8 warps x 2 stages x
// (e, dhs, ge)); at F = 64 about half, with the same grids and blocks.
//
// Design, bf16 at F = 192 and 256 (the stream design, mp_stream.cuh; GNS-10-
// 256). What bounded the WMMA tile design that ran here before was the
// weight gradients: each block added every tile's rows into its five F x F
// float32 partials in device memory, loading and storing each 16 x 16 tile
// of them once per 32-row chunk (~20 GB of round trips a call at F = 256,
// 173 MB of partials, past the 50 MB L2). Of the two ways to keep those sums
// off device memory, this design takes (a), two stages, over (b), a column
// split across a 2-CTA cluster: (a) reuses the stream design's row kernels
// unchanged in shape, needs no exchange of LayerNorm sums between CTAs, and
// its extra traffic (writing and reading T(relu(first)) and T(dx1), 2 x 2 n k
// F bytes, ~0.4 ms at F = 256 at the rollout shape) is a fraction of the
// row products' time. Five kernels and the sum:
//   1. fused_mp_bwd_agg_stream (K3's stream edge body, agg only): agg to a
//      float32 scratch.
//   2. fused_mp_bwd_node_stream: 16 nodes per warp, 128 per block; the node
//      forward and backward on the streamed W_nh, W_na, W_n2 (and their
//      transposes, streamed as column blocks): dh, dagg to a float32
//      scratch, and the bf16 operands T(agg), T(r2), T(dy1), T(dnf) of the
//      node weight gradients, written once, rounded as the products take them.
//   3. fused_mp_bwd_edge_stream: persistent, warps owning even shares of the
//      receivers as the forward's; per 16-row slice it rematerializes first
//      and x1, runs LN1's backward (dm = ge + dagg * mask) into dx1, then
//      dfirst = T(dx1) @ W2^T * (first > 0) -> dhs (= T(dfirst)) and dhr
//      (summed per receiver by its warp, in row order), and de = ge +
//      T(dfirst) @ W_e^T, on the streamed W_e, W2, W2, W_e; it writes the
//      operands T(relu(first)) and T(dx1) of dW2 once. dW_e's operands are e
//      (an input) and dhs (an output): nothing more to write.
//   4. fused_mp_bwd_tn: the five weight gradients X^T Y, hand-written on
//      mma.sync m16n8k16 (bf16 in, float32 sums): each job's rows (n k for
//      dW_e and dW2, n for the node three) split into a fixed partition of
//      row ranges (ops/fused_mp.py bwd_stream_plan), each range summed by
//      two blocks (the two halves of the output rows) through a 3-stage
//      cp.async ring of 32-row chunks, each warp's 64 x 64 (F = 256) output
//      tile in registers for the whole range, written once to its range's
//      partial.
//   5. fused_mp_bwd_reduce: each gradient's partials summed in range (block)
//      order.
// No atomics: the weight gradients are the same bits on every launch.
// Shared memory at F = 256: the node and edge kernels 220 KB (a 3-stage ring
// 48 KB, slots 128 KB, each warp's vector sums and dhr row 40 KB, vectors),
// the TN kernel 96 KB.
// What bounds it (an H100 at F = 256, the rollout shape 16,000 x 40;
// experiments/stream_ablation.py): K4 takes 7.24 ms, 5.27 of it the edge
// kernel, whose four products alone take 2.04; taking out LN1's backward
// saves 2.05 ms, the four slice stores 1.35, the dagg loads 0.39, dfirst's
// column sums and dhr 0.27. As in the forward, the block's warps take each
// slab in step, so the epilogues, the stores and the products do not
// overlap; the agg pass takes 1.07 ms and the product kernel 0.73 (its 1.3
// GB of edge operands are 0.39 ms of the card's bytes).
//
// Past F = 256 the entry points run the wide path (mp_wide.cuh
// wide_backward): the forward rematerialized by product launches, the
// node and edge backward as product launches with epilogues and row
// kernels, the five weight gradients as products over fixed row ranges,
// and its own sum of the partials (fused_mp_bwd_wide_reduce). In bf16 up
// to F = 512 the edge side is the wgmma design's instead (mp_wgmma_bwd.cuh
// wgmma_backward: the forward's edge kernel, one edge-backward kernel, a
// wgmma product kernel for dW_e and dW2).
//
// The tile design (fused_mp_bwd below) is the float32 instance at every F:
// a persistent grid of about one block per SM; each block of 8 warps walks
// receiver tiles of 16. The tile's float32 LayerNorm activations do not fit
// in shared memory (16 x 40 rows x 128 x 4 B = 320 KB at F = 128), so the
// tile's edges stream through shared memory twice, 64 rows at a time (32 at
// F > 128, so that five row buffers fit: 195 KB at F = 256):
//   pass 1: rematerialize to agg; then the node-path backward, which
//           leaves dagg in shared memory;
//   pass 2: rematerialize again; then the edge-path backward with dagg.
// Products are CUDA-core FMAs with the weights read from global memory.
// Each block accumulates its own float32 partials (the five matrix
// gradients in device memory, owned by one thread per element; the eight
// vector gradients in registers, row by row, then summed over the warps in
// order), and the sum adds the partials in block order. dhr sums a
// receiver's K rows in k order.
#include "mp_stream.cuh"
#include "mp_wgmma_bwd.cuh"

namespace {

constexpr int TR = 16;  // receivers per tile
template <int F>
constexpr int kRows = F <= 128 ? 64 : 32;  // edge rows per chunk of the tile design
constexpr int NV = 8;   // vector gradients
template <int F>
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
  float* partials;    // float32: (gridDim.x, GRADS); bf16: see lbt_fused_mp_bwd
  float* agg;         // bf16: (N, F) float32 scratch; float32 tile design: agg out or null
  float* dagg;        // bf16: (N, F) float32 scratch
  void* ops;          // bf16 stream design: the weight gradients' operands (Ops)
  int n, k;
  int nf;             // the true latent width, <= F
};

template <typename T, int F>
struct Smem {
  static constexpr int LDA = Layout<T, F>::LDA;
  static constexpr int kA = kRows<F> * LDA * (int)sizeof(T);
  static constexpr int kF = kRows<F> * kLdf<F> * 4;
  static constexpr int kNode = TR * F * 4;
  static constexpr int kBytes = 3 * kA + 2 * kF + 2 * kNode;
  static_assert(kRows<F> >= 2 * TR, "the node path's buffers: two tiles in each row buffer");
  static_assert(kBytes <= kSmemMax, "tile design shared memory");
};

// C[rows, F] = A[rows, F] @ W^T, W (F, F) row-major (in, out); rows % 16 == 0.
template <int F>
__device__ void block_gemm_nt(const float* A, const float* W, float* C, int rows) {
  constexpr int LDA = Layout<float, F>::LDA, LDF = kLdf<F>;
  for (int idx = threadIdx.x; idx < (rows / 8) * F; idx += THREADS) {
    const int c = idx % F, r0 = (idx / F) * 8;
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
template <int F>
__device__ void block_gemm_tn(const float* A, const float* B, float* G, int rows) {
  constexpr int LDA = Layout<float, F>::LDA;
  for (int idx = threadIdx.x; idx < F * F; idx += THREADS) {
    const int i = idx / F, j = idx % F;
    float s = G[idx];
    for (int r = 0; r < rows; ++r) s += A[r * LDA + i] * B[r * LDA + j];
    G[idx] = s;
  }
}

// Row statistics of one F-wide float row held by a warp (V = F / 32 values
// per lane) over its first nf columns: xhat = (x - mean) * inv in place, 0
// past nf; returns inv.
template <int V>
__device__ __forceinline__ float warp_normalize(float (&x)[V], int lane, int nf) {
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
  for (int i = 0; i < V; ++i) x[i] = lane + 32 * i < nf ? (x[i] - mean) * inv : 0.f;
  return inv;
}

// LayerNorm input gradient of a warp-held row over its first nf columns: dx
// = inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dy *
// scale, 0 past nf. Overwrites dy with dx.
template <int V>
__device__ __forceinline__ void warp_ln_bwd(float (&dy)[V], const float (&xhat)[V], float inv,
                                            const float* scale, int lane, int nf) {
  const float inv_n = 1.f / nf;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    dy[i] = lane + 32 * i < nf ? dy[i] * scale[lane + 32 * i] : 0.f;
    s1 += dy[i];
    s2 += dy[i] * xhat[i];
  }
  const float m1 = lbt::warp_sum(s1) * inv_n;
  const float m2 = lbt::warp_sum(s2) * inv_n;
#pragma unroll
  for (int i = 0; i < V; ++i)
    dy[i] = lane + 32 * i < nf ? inv * (dy[i] - m1 - xhat[i] * m2) : 0.f;
}

// The tile's edge rows [c0, c0 + rows) -> sA (e) and sB (T(relu(first))),
// first = e @ W_e + hs + hr + b1; rows past `rows` up to rows_pad are zero.
// Leaves relu(first) @ W2 in sF. Starts and ends with the block in step.
template <typename T, int F>
__device__ void remat_chunk(const Args& a, const T* wE, const T* w2, T* sA, T* sB,
                            float* sF, int64_t row0, int node0, int c0, int rows,
                            int rows_pad) {
  constexpr int LDA = Layout<T, F>::LDA, LDF = kLdf<F>;
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
  block_gemm<F>(sA, wE, sF, rows_pad, false);
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
  block_gemm<F>(sB, w2, sF, rows_pad, false);
  __syncthreads();
}

template <typename T, int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd(const Args a) {
  using S = Smem<T, F>;
  constexpr int LDA = S::LDA, LDF = kLdf<F>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + S::kA);
  T* sC = reinterpret_cast<T*>(smem + 2 * S::kA);
  unsigned char* p = smem + 3 * S::kA;
  float* sF = reinterpret_cast<float*>(p);
  float* sG = reinterpret_cast<float*>(p + S::kF);
  float* sNode = reinterpret_cast<float*>(p + 2 * S::kF);  // agg, then dagg
  float* sDhr = reinterpret_cast<float*>(p + 2 * S::kF + S::kNode);

  const int K = a.k;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (a.n + TR - 1) / TR;
  float* part = a.partials + (int64_t)blockIdx.x * GRADS<F>;
  const T* ge = static_cast<const T*>(a.ge);
  const T* gh = static_cast<const T*>(a.gh);
  const T* h = static_cast<const T*>(a.h);

  // the weights, read from global memory (L1/L2)
  const T* wE = static_cast<const T*>(a.w[0]);
  const T* w2 = static_cast<const T*>(a.w[1]);
  const T* wNh = static_cast<const T*>(a.w[2]);
  const T* wNa = static_cast<const T*>(a.w[3]);
  const T* wN2 = static_cast<const T*>(a.w[4]);

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
    __syncthreads();  // previous tile done
    for (int i = threadIdx.x; i < TR * F; i += THREADS) {
      sNode[i] = 0.f;
      sDhr[i] = 0.f;
    }

    // ---- pass 1: rematerialize to agg ----------------------------------
    for (int c0 = 0; c0 < rows_tile; c0 += kRows<F>) {
      const int rows = min(kRows<F>, rows_tile - c0);
      const int rows_pad = (rows + 15) / 16 * 16;
      __syncthreads();
      remat_chunk<T, F>(a, wE, w2, sA, sB, sF, row0, node0, c0, rows, rows_pad);
      for (int r = warp; r < rows; r += WARPS) {
        float x[F / 32];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) x[i] = sF[r * LDF + lane + 32 * i] + a.vec[V_B2][lane + 32 * i];
        warp_normalize(x, lane, a.nf);
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

    if (a.agg)  // the caller asked for the step's agg as summed here
      for (int i = threadIdx.x; i < nodes * F; i += THREADS) a.agg[(int64_t)node0 * F + i] = sNode[i];

    // ---- node-path backward (TR rows; rows past `nodes` are zero) --------
    // two TR-row tiles in each row buffer (kRows >= 2 TR)
    T* nH = sA;
    T* nAggc = sA + TR * LDA;
    T* nR2c = sC;
    T* nDy1c = sC + TR * LDA;
    T* nDnfc = sB;
    float* nR2 = sF;             // r2 = relu(nf)
    float* nY = sF + TR * LDF;   // y1
    float* nDnf = nY;            // written once y1 is read
    float* nDh = sG;             // dnfc @ W_nh^T
    float* nDagg = sG + TR * LDF;
    for (int i = threadIdx.x; i < TR * F; i += THREADS) {
      const int r = i / F, c = i % F;
      nH[r * LDA + c] = r < nodes ? h[(int64_t)(node0 + r) * F + c] : from_f<T>(0.f);
      nAggc[r * LDA + c] = from_f<T>(sNode[i]);
    }
    __syncthreads();
    block_gemm<F>(nH, wNh, nR2, TR, false);
    __syncthreads();
    block_gemm<F>(nAggc, wNa, nR2, TR, true);
    __syncthreads();
    for (int i = threadIdx.x; i < TR * F; i += THREADS) {
      const int r = i / F, c = i % F;
      const float r2 = fmaxf(nR2[r * LDF + c] + a.vec[V_BN1][c], 0.f);
      nR2[r * LDF + c] = r2;
      nR2c[r * LDA + c] = from_f<T>(r2);
    }
    __syncthreads();
    block_gemm<F>(nR2c, wN2, nY, TR, false);
    __syncthreads();
    for (int r = warp; r < TR; r += WARPS) {
      float x[F / 32], g[F / 32];
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        const int c = lane + 32 * i;
        x[i] = nY[r * LDF + c] + a.vec[V_BN2][c];
        g[i] = r < nodes ? to_f(gh[(int64_t)(node0 + r) * F + c]) : 0.f;
      }
      const float inv = warp_normalize(x, lane, a.nf);
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        vacc[V_G2][i] += g[i] * x[i];
        vacc[V_BE2][i] += g[i];
      }
      warp_ln_bwd(g, x, inv, a.vec[V_G2], lane, a.nf);
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        vacc[V_BN2][i] += g[i];
        nDy1c[r * LDA + lane + 32 * i] = from_f<T>(g[i]);
      }
    }
    __syncthreads();
    block_gemm_tn<F>(nR2c, nDy1c, part + G_WN2 * F * F, TR);
    block_gemm_nt<F>(nDy1c, wN2, nDnf, TR);
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
    block_gemm_tn<F>(nH, nDnfc, part + G_WNH * F * F, TR);
    block_gemm_tn<F>(nAggc, nDnfc, part + G_WNA * F * F, TR);
    block_gemm_nt<F>(nDnfc, wNh, nDh, TR);
    block_gemm_nt<F>(nDnfc, wNa, nDagg, TR);
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
    T* de = static_cast<T*>(a.de);
    T* dhs = static_cast<T*>(a.dhs);
    for (int c0 = 0; c0 < rows_tile; c0 += kRows<F>) {
      const int rows = min(kRows<F>, rows_tile - c0);
      const int rows_pad = (rows + 15) / 16 * 16;
      __syncthreads();
      remat_chunk<T, F>(a, wE, w2, sA, sB, sF, row0, node0, c0, rows, rows_pad);
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
        const float inv = warp_normalize(x, lane, a.nf);
        const float m = a.mask[er];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          const int c = lane + 32 * i;
          d[i] = to_f(ge[er * F + c]) + sNode[nl * F + c] * m;
          vacc[V_G1][i] += d[i] * x[i];
          vacc[V_BE1][i] += d[i];
        }
        warp_ln_bwd(d, x, inv, a.vec[V_G1], lane, a.nf);
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          vacc[V_B2][i] += d[i];
          sC[r * LDA + lane + 32 * i] = from_f<T>(d[i]);
        }
      }
      __syncthreads();
      block_gemm_tn<F>(sB, sC, part + G_W2 * F * F, rows_pad);  // dW2 += T(r1)^T dx1c
      block_gemm_nt<F>(sC, w2, sG, rows_pad);                // dx1c @ W2^T
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
      block_gemm_tn<F>(sA, sC, part + G_WE * F * F, rows_pad);  // dW_e += e^T dfirstc
      block_gemm_nt<F>(sC, wE, sF, rows_pad);                // dfirstc @ W_e^T
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

// ---- bf16 ---------------------------------------------------------------

constexpr int NB_WARPS = 4;              // fused_mp_bwd_node: warps per block
constexpr int NB_ROWS = NB_WARPS * SR;   // fused_mp_bwd_node: nodes per block
template <int F>
constexpr int P_NODE = 3 * F * F + 4 * F;  // node kernel: dW_nh, dW_na, dW_n2, bn1..ln2 bias
template <int F>
constexpr int P_EA = F * F + 4 * F;        // edge kernel a: dW2, b1, b2, ln1 scale, ln1 bias
template <int F>
constexpr int P_EB = F * F;                // edge kernel b: dW_e

template <int F>
struct NodeBwdSmem {
  static constexpr int kVec = 3 * Tile<F>::WEIGHT_BYTES;  // bn1, bn2, ln2 scale, ln2 bias
  static constexpr int kTiles = kVec + 4 * F * 4;
  static constexpr int kTile = NB_WARPS * Tile<F>::SLICE_BYTES;  // H, AGGC, R2C, DY1C, DNFC
  static constexpr int kOwn = kTiles + 5 * kTile;        // warps x 4 vector sums
  static constexpr int kBytes = kOwn + NB_WARPS * 4 * F * 4;
  static_assert(kBytes <= kSmemMax, "node kernel shared memory");
};

// the warps' slice counts of this block
__device__ __forceinline__ void block_slices(const Args& a, int* cnt) {
  for (int w = 0; w < WARPS; ++w) {
    int64_t lo, hi;
    block_warp_range(a.n, blockIdx.x, gridDim.x, w, lo, hi);
    cnt[w] = (int)(((hi - lo) * a.k + SR - 1) / SR);
  }
}

// K3's edge body with no e' out: the step's agg, rematerialized.
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd_agg(const EdgeArgs a) {
  edge_fwd<F, false, Src::kGathered>(a);
}

// The node path's forward and backward, 16 nodes per warp.
template <int F>
__global__ void __launch_bounds__(NB_WARPS * 32, 1) fused_mp_bwd_node(const Args a) {
  using S = NodeBwdSmem<F>;
  using D = Tile<F>;
  constexpr int NB = D::NB, KB = D::KB, NH = D::NH, WEIGHT_BYTES = D::WEIGHT_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  for (int i = 0; i < 3; ++i)
    stage_rows<F>(sb + i * WEIGHT_BYTES, static_cast<const bf16*>(a.w[2 + i]), F, F);
  const int64_t r0 = (int64_t)blockIdx.x * NB_ROWS + warp * SR;
  const bf16* h = static_cast<const bf16*>(a.h);
  auto tile = [&](int which, int w) {
    return (u32)(S::kTiles + which * S::kTile + w * D::SLICE_BYTES);
  };
  enum { H = 0, AGGC, R2C, DY1C, DNFC };
#pragma unroll
  for (int i = 0; i < D::CP_ITERS; ++i) {
    int r, c;
    slice_chunk<F>(lane, i, r, c);
    const bool v = r0 + r < a.n;
    cp_async16(sb + tile(H, warp) + swz<F>(r, c), v ? h + (r0 + r) * F + c * 8 : h, v);
  }
  cp_commit();
  float* vec = reinterpret_cast<float*>(smem + S::kVec);
  for (int i = threadIdx.x; i < 4 * F; i += blockDim.x) vec[i] = a.vec[V_BN1 + i / F][i % F];
  cp_wait<0>();
  __syncthreads();
  const float *bn1 = vec, *bn2 = vec + F, *s2 = vec + 2 * F;
  const u32 wNh = sb, wNa = sb + WEIGHT_BYTES, wN2 = sb + 2 * WEIGHT_BYTES;

  const bool vg = r0 + g < a.n, vg8 = r0 + g + 8 < a.n;
  float own[4][NH][2] = {};  // bn1, bn2, ln2 scale, ln2 bias
  u32 ha[KB][4], ga[KB][4], ra[KB][4];
  load_a(ha, sb + tile(H, warp), lane);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    const float2 x = vg ? *reinterpret_cast<const float2*>(a.agg + (r0 + g) * F + c)
                        : make_float2(0.f, 0.f);
    const float2 x8 = vg8 ? *reinterpret_cast<const float2*>(a.agg + (r0 + g + 8) * F + c)
                          : make_float2(0.f, 0.f);
    ga[nb >> 1][(nb & 1) * 2] = pack(x.x, x.y);
    ga[nb >> 1][(nb & 1) * 2 + 1] = pack(x8.x, x8.y);
    sts32(smem, tile(AGGC, warp) + swz_pair<F>(g, c), frag_pair(ga, nb, 0));
    sts32(smem, tile(AGGC, warp) + swz_pair<F>(g + 8, c), frag_pair(ga, nb, 1));
  }
  float acc[NB][4];
  zero(acc);
  gemm(acc, ha, wNh, lane);
  gemm(acc, ga, wNa, lane);
  to_frag(ra, acc, [&](float x, int nb, int j) { return fmaxf(x + bn1[nb * 8 + 2 * t + j], 0.f); });
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    sts32(smem, tile(R2C, warp) + swz_pair<F>(g, c), frag_pair(ra, nb, 0));
    sts32(smem, tile(R2C, warp) + swz_pair<F>(g + 8, c), frag_pair(ra, nb, 1));
  }
  zero(acc);
  gemm(acc, ra, wN2, lane);
  add_bias(acc, bn2, t);
  float inv0, inv1;
  row_normalize(acc, inv0, inv1, a.nf);  // acc = xhat2 (-mean inv past nf)

  // LN2 backward with gh: dy1 = inv (gh s - mean(gh s) - xhat mean(gh s xhat))
  const bf16* gh = static_cast<const bf16*>(a.gh);
  u32 ghp[NB][2];
  float p1[2] = {0.f, 0.f}, p2[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    ghp[nb][0] = vg ? ldg32(gh + (r0 + g) * F + c) : 0u;
    ghp[nb][1] = vg8 ? ldg32(gh + (r0 + g + 8) * F + c) : 0u;
    const float2 d = unpack(ghp[nb][0]), d8 = unpack(ghp[nb][1]);
    const float dv[4] = {d.x, d.y, d8.x, d8.y};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      colsum_add(own[2], dv[j] * acc[nb][j] + dv[2 + j] * acc[nb][2 + j], nb, j, g);
      colsum_add(own[3], dv[j] + dv[2 + j], nb, j, g);
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        const float dx = dv[2 * r8 + j] * s2[c + j];
        p1[r8] += dx;
        p2[r8] += dx * acc[nb][2 * r8 + j];
      }
    }
  }
  const float inv[2] = {inv0, inv1};
  const float inv_n = 1.f / a.nf;
  float m1[2], m2[2];
#pragma unroll
  for (int r8 = 0; r8 < 2; ++r8) {
    m1[r8] = quad_sum(p1[r8]) * inv_n;
    m2[r8] = quad_sum(p2[r8]) * inv_n;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    const float2 d = unpack(ghp[nb][0]), d8 = unpack(ghp[nb][1]);
    const float dv[4] = {d.x, d.y, d8.x, d8.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r8 = i >> 1, j = i & 1;
      acc[nb][i] = inv[r8] * (dv[i] * s2[c + j] - m1[r8] - acc[nb][i] * m2[r8]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) colsum_add(own[1], acc[nb][j] + acc[nb][2 + j], nb, j, g);
  }
  u32 da[KB][4];  // T(dy1), then T(dnf)
  to_frag(da, acc, [](float x, int, int) { return x; });
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    sts32(smem, tile(DY1C, warp) + swz_pair<F>(g, c), frag_pair(da, nb, 0));
    sts32(smem, tile(DY1C, warp) + swz_pair<F>(g + 8, c), frag_pair(da, nb, 1));
  }
  zero(acc);
  gemm_t(acc, da, wN2, lane);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {  // dnf = (T(dy1) @ W_n2^T) * (nf > 0)
    const float2 r = unpack(frag_pair(ra, nb, 0)), r8 = unpack(frag_pair(ra, nb, 1));
    acc[nb][0] = r.x > 0.f ? acc[nb][0] : 0.f;
    acc[nb][1] = r.y > 0.f ? acc[nb][1] : 0.f;
    acc[nb][2] = r8.x > 0.f ? acc[nb][2] : 0.f;
    acc[nb][3] = r8.y > 0.f ? acc[nb][3] : 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) colsum_add(own[0], acc[nb][j] + acc[nb][2 + j], nb, j, g);
  }
  to_frag(da, acc, [](float x, int, int) { return x; });
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    sts32(smem, tile(DNFC, warp) + swz_pair<F>(g, c), frag_pair(da, nb, 0));
    sts32(smem, tile(DNFC, warp) + swz_pair<F>(g + 8, c), frag_pair(da, nb, 1));
  }
  zero(acc);
  gemm_t(acc, da, wNh, lane);  // dh = gh + T(dnf) @ W_nh^T
  bf16* dh = static_cast<bf16*>(a.dh);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    const float2 d = unpack(ghp[nb][0]), d8 = unpack(ghp[nb][1]);
    if (vg)
      *reinterpret_cast<u32*>(dh + (r0 + g) * F + c) = pack(d.x + acc[nb][0], d.y + acc[nb][1]);
    if (vg8)
      *reinterpret_cast<u32*>(dh + (r0 + g + 8) * F + c) =
          pack(d8.x + acc[nb][2], d8.y + acc[nb][3]);
  }
  zero(acc);
  gemm_t(acc, da, wNa, lane);  // dagg = T(dnf) @ W_na^T
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    if (vg)
      *reinterpret_cast<float2*>(a.dagg + (r0 + g) * F + c) = make_float2(acc[nb][0], acc[nb][1]);
    if (vg8)
      *reinterpret_cast<float2*>(a.dagg + (r0 + g + 8) * F + c) =
          make_float2(acc[nb][2], acc[nb][3]);
  }
  float* own_s = reinterpret_cast<float*>(smem + S::kOwn);
#pragma unroll
  for (int v = 0; v < 4; ++v) store_own(own_s + (warp * 4 + v) * F, own[v], g, t);
  __syncthreads();

  // the block's weight gradients: warp w owns rows [RW w, RW w + RW) of each,
  // RW = F / NB_WARPS (32 at F = 128, 16 at F = 64), 16 at a time
  constexpr int RW = F / NB_WARPS;
  static_assert(RW % 16 == 0, "whole 16-row blocks per warp");
  float* part = a.partials + (int64_t)blockIdx.x * P_NODE<F>;
  const int xs[3] = {H, AGGC, R2C}, ys[3] = {DNFC, DNFC, DY1C};  // dW_nh, dW_na, dW_n2
#pragma unroll 1
  for (int gi = 0; gi < 3; ++gi) {
#pragma unroll 1
    for (int hf = 0; hf < RW / 16; ++hf) {
      const int i0 = warp * RW + hf * 16;
      zero(acc);
      for (int w = 0; w < NB_WARPS; ++w)
        gemm_tn(acc, sb + tile(xs[gi], w), sb + tile(ys[gi], w), i0, lane);
      float* dst = part + gi * F * F;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        *reinterpret_cast<float2*>(dst + (i0 + g) * F + c) = make_float2(acc[nb][0], acc[nb][1]);
        *reinterpret_cast<float2*>(dst + (i0 + g + 8) * F + c) =
            make_float2(acc[nb][2], acc[nb][3]);
      }
    }
  }
  for (int i = threadIdx.x; i < 4 * F; i += blockDim.x) {  // warps in order
    float sum = 0.f;
    for (int w = 0; w < NB_WARPS; ++w) sum += own_s[w * 4 * F + i];
    part[3 * F * F + i] = sum;
  }
}

// The warps that own rows of an edge kernel's weight gradient: warp w owns
// rows [16 w, 16 w + 16), so at F = 64 warps 4-7 own none.
template <int F>
__device__ __forceinline__ bool owns_grad_rows(int warp) {
  static_assert(F <= WARPS * SR, "8 warps x 16 rows cover the gradient");
  return warp * SR < F;
}

template <int F>
struct EdgeBwdASmem {
  static constexpr int SLICE_BYTES = Tile<F>::SLICE_BYTES;
  // W_e, W2; then b1, b2, ln1 scale, ln1 bias
  static constexpr int kVec = 2 * Tile<F>::WEIGHT_BYTES;
  static constexpr int kRing = kVec + 4 * F * 4;
  static constexpr int kStage = 2 * SLICE_BYTES;  // e (then T(r1)), hs (then T(dx1))
  static constexpr int kGe = kRing + WARPS * 2 * kStage;
  static constexpr int kBytes = kGe + WARPS * SLICE_BYTES;
  static_assert(kBytes + WARPS * 4 <= kSmemMax, "edge kernel a shared memory");
};

// Rematerialization and the edge-path backward up to dfirst: dhs, dhr,
// dW2 and the vector gradients b1, b2, ln1 scale, ln1 bias.
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd_edge_a(const Args a) {
  using S = EdgeBwdASmem<F>;
  using D = Tile<F>;
  constexpr int NB = D::NB, KB = D::KB, NH = D::NH;
  constexpr int SLICE_BYTES = D::SLICE_BYTES, WEIGHT_BYTES = D::WEIGHT_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int cnt[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  stage_rows<F>(sb, static_cast<const bf16*>(a.w[0]), F, F);
  stage_rows<F>(sb + WEIGHT_BYTES, static_cast<const bf16*>(a.w[1]), F, F);
  cp_commit();
  float* vec = reinterpret_cast<float*>(smem + S::kVec);
  for (int i = threadIdx.x; i < 4 * F; i += THREADS) vec[i] = a.vec[i / F][i % F];
  if (threadIdx.x == 0) block_slices(a, cnt);
  cp_wait<0>();
  __syncthreads();
  int iters = 0;
  for (int w = 0; w < WARPS; ++w) iters = max(iters, cnt[w]);
  const float *b1 = vec, *b2 = vec + F, *s1 = vec + 2 * F;
  const u32 wE = sb, w2 = sb + WEIGHT_BYTES;

  const int K = a.k;
  int64_t rc0, rc1;
  block_warp_range(a.n, blockIdx.x, gridDim.x, warp, rc0, rc1);
  const int64_t r_lo = rc0 * K, r_hi = rc1 * K;
  const int mine = cnt[warp];
  const u32 ring = S::kRing + warp * 2 * S::kStage;
  const u32 ge_slot = S::kGe + warp * SLICE_BYTES;
  const bf16 *e = static_cast<const bf16*>(a.e), *hs = static_cast<const bf16*>(a.hs);
  const bf16 *ge = static_cast<const bf16*>(a.ge), *hr = static_cast<const bf16*>(a.hr);

  auto copy_slice = [&](u32 dst, const bf16* src, int64_t s0) {
#pragma unroll
    for (int i = 0; i < D::CP_ITERS; ++i) {
      int r, c;
      slice_chunk<F>(lane, i, r, c);
      const bool v = s0 + r < r_hi;
      cp_async16(sb + dst + swz<F>(r, c), v ? src + (s0 + r) * F + c * 8 : src, v);
    }
  };
  float m_next = 0.f;
  auto issue = [&](int j) {
    const int64_t s0 = r_lo + (int64_t)j * SR;
    const u32 st = ring + (j & 1) * S::kStage;
    copy_slice(st, e, s0);
    copy_slice(st + SLICE_BYTES, hs, s0);
    const int64_t rr = s0 + (lane & 15);
    m_next = rr < r_hi ? a.mask[rr] : 0.f;
    cp_commit();
  };

  float gw2[NB][4];  // rows [16 warp, 16 warp + 16) of dW2, for the whole launch
  zero(gw2);
  float own[4][NH][2] = {};  // b1, b2, ln1 scale, ln1 bias
  int64_t cur = -1;          // the receiver whose dhr `dhr_own` holds
  float dhr_own[NH][2] = {};
  bf16* dhr = static_cast<bf16*>(a.dhr);
  auto flush = [&]() {
    if (cur < 0) return;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      *reinterpret_cast<u32*>(dhr + cur * F + (g + 8 * hh) * 8 + 2 * t) =
          pack(dhr_own[hh][0], dhr_own[hh][1]);
  };

  if (mine > 0) issue(0);
  for (int j = 0; j < iters; ++j) {
    const bool active = j < mine;
    const int64_t s0 = r_lo + (int64_t)j * SR;
    const u32 st = ring + (j & 1) * S::kStage, st_hs = st + SLICE_BYTES;
    const float m_row = m_next;
    u32 dxa[KB][4];  // T(dx1), kept across the block's dW2 step
    float acc[NB][4];
    if (active) {
      copy_slice(ge_slot, ge, s0);
      cp_commit();
      const bool next = j + 1 < mine;
      if (next) issue(j + 1);
      if (next) cp_wait<2>(); else cp_wait<1>();
      __syncwarp();

      const bool vg = s0 + g < r_hi, vg8 = s0 + g + 8 < r_hi;
      const int64_t ig = vg ? (s0 + g) / K : 0, ig8 = vg8 ? (s0 + g + 8) / K : 0;
      const float mg = __shfl_sync(lbt::kFullMask, m_row, g);
      const float mg8 = __shfl_sync(lbt::kFullMask, m_row, g + 8);
      {  // first = e @ W_e + hs + hr + b1 -> T(relu(first)), into the e slot
        u32 ea[KB][4];
        load_a(ea, sb + st, lane);
        zero(acc);
        gemm(acc, ea, wE, lane);
      }
      u32 ra[KB][4];
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        u32 h4[4];
        ldsm(h4, sb + st_hs + swz<F>(lane & 15, kb * 2 + (lane >> 4)));
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int nb = 2 * kb + hf, c = nb * 8 + 2 * t;
          const float2 s_g = unpack(h4[2 * hf]), s_g8 = unpack(h4[2 * hf + 1]);
          const float2 r_g = unpack(vg ? ldg32(hr + ig * F + c) : 0u);
          const float2 r_g8 = unpack(vg8 ? ldg32(hr + ig8 * F + c) : 0u);
          ra[kb][2 * hf] = vg ? pack(fmaxf(acc[nb][0] + s_g.x + r_g.x + b1[c], 0.f),
                                     fmaxf(acc[nb][1] + s_g.y + r_g.y + b1[c + 1], 0.f))
                              : 0u;
          ra[kb][2 * hf + 1] = vg8 ? pack(fmaxf(acc[nb][2] + s_g8.x + r_g8.x + b1[c], 0.f),
                                          fmaxf(acc[nb][3] + s_g8.y + r_g8.y + b1[c + 1], 0.f))
                                   : 0u;
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        sts32(smem, st + swz_pair<F>(g, c), frag_pair(ra, nb, 0));
        sts32(smem, st + swz_pair<F>(g + 8, c), frag_pair(ra, nb, 1));
      }
      zero(acc);
      gemm(acc, ra, w2, lane);
      add_bias(acc, b2, t);
      float inv[2];
      row_normalize(acc, inv[0], inv[1], a.nf);  // acc = xhat1 (-mean inv past nf)
      if (next) cp_wait<1>(); else cp_wait<0>();  // this slice's ge
      __syncwarp();

      // LN1 backward: dm = ge + dagg * mask; dx1 = inv (dm s - mean(dm s) -
      // xhat mean(dm s xhat)); dm is formed twice rather than kept
      auto dm_of = [&](int nb, float (&dv)[4]) {
        const int c = nb * 8 + 2 * t;
        const float2 q = unpack(lds32(smem, ge_slot + swz_pair<F>(g, c)));
        const float2 q8 = unpack(lds32(smem, ge_slot + swz_pair<F>(g + 8, c)));
        const float2 d = vg ? *reinterpret_cast<const float2*>(a.dagg + ig * F + c)
                            : make_float2(0.f, 0.f);
        const float2 d8 = vg8 ? *reinterpret_cast<const float2*>(a.dagg + ig8 * F + c)
                              : make_float2(0.f, 0.f);
        dv[0] = q.x + d.x * mg;
        dv[1] = q.y + d.y * mg;
        dv[2] = q8.x + d8.x * mg8;
        dv[3] = q8.y + d8.y * mg8;
      };
      float p1[2] = {0.f, 0.f}, p2[2] = {0.f, 0.f};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        float dv[4];
        dm_of(nb, dv);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          colsum_add(own[2], dv[jj] * acc[nb][jj] + dv[2 + jj] * acc[nb][2 + jj], nb, jj, g);
          colsum_add(own[3], dv[jj] + dv[2 + jj], nb, jj, g);
#pragma unroll
          for (int r8 = 0; r8 < 2; ++r8) {
            const float dx = dv[2 * r8 + jj] * s1[c + jj];
            p1[r8] += dx;
            p2[r8] += dx * acc[nb][2 * r8 + jj];
          }
        }
      }
      const float inv_n = 1.f / a.nf;
      float m1[2], m2[2];
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        m1[r8] = quad_sum(p1[r8]) * inv_n;
        m2[r8] = quad_sum(p2[r8]) * inv_n;
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        float dv[4];
        dm_of(nb, dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r8 = i >> 1, jj = i & 1;
          acc[nb][i] = inv[r8] * (dv[i] * s1[c + jj] - m1[r8] - acc[nb][i] * m2[r8]);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) colsum_add(own[1], acc[nb][jj] + acc[nb][2 + jj], nb, jj, g);
      }
      to_frag(dxa, acc, [](float x, int, int) { return x; });
      if (!vg || !vg8) {
#pragma unroll
        for (int kb = 0; kb < KB; ++kb) {
          if (!vg) dxa[kb][0] = dxa[kb][2] = 0u;
          if (!vg8) dxa[kb][1] = dxa[kb][3] = 0u;
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {  // T(dx1) into the hs slot
        const int c = nb * 8 + 2 * t;
        sts32(smem, st_hs + swz_pair<F>(g, c), frag_pair(dxa, nb, 0));
        sts32(smem, st_hs + swz_pair<F>(g + 8, c), frag_pair(dxa, nb, 1));
      }
    }
    __syncthreads();
    // dW2 += T(r1)^T T(dx1) over the block's slices, in warp order
    if (owns_grad_rows<F>(warp))
      for (int w = 0; w < WARPS; ++w)
        if (j < cnt[w]) {
          const u32 sw = S::kRing + w * 2 * S::kStage + (j & 1) * S::kStage;
          gemm_tn(gw2, sb + sw, sb + sw + SLICE_BYTES, warp * SR, lane);
        }
    __syncthreads();
    if (!active) continue;

    // dfirst = (T(dx1) @ W2^T) * (first > 0)
    zero(acc);
    gemm_t(acc, dxa, w2, lane);
    const bool vg = s0 + g < r_hi, vg8 = s0 + g + 8 < r_hi;
    const int64_t ig = vg ? (s0 + g) / K : 0, ig8 = vg8 ? (s0 + g + 8) / K : 0;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + 2 * t;
      const float2 r = unpack(lds32(smem, st + swz_pair<F>(g, c)));
      const float2 r8 = unpack(lds32(smem, st + swz_pair<F>(g + 8, c)));
      acc[nb][0] = r.x > 0.f ? acc[nb][0] : 0.f;
      acc[nb][1] = r.y > 0.f ? acc[nb][1] : 0.f;
      acc[nb][2] = r8.x > 0.f ? acc[nb][2] : 0.f;
      acc[nb][3] = r8.y > 0.f ? acc[nb][3] : 0.f;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) colsum_add(own[0], acc[nb][jj] + acc[nb][2 + jj], nb, jj, g);
      sts32(smem, st + swz_pair<F>(g, c), pack(acc[nb][0], acc[nb][1]));
      sts32(smem, st + swz_pair<F>(g + 8, c), pack(acc[nb][2], acc[nb][3]));
    }
    __syncwarp();
    store_slice<F>(static_cast<bf16*>(a.dhs), s0, r_hi, smem, st, lane);
    __syncwarp();
    // dhr: dfirst summed per receiver, in row order
    const int64_t first = s0 / K, last = ((s0 + SR < r_hi ? s0 + SR : r_hi) - 1) / K;
    for (int64_t i = first; i <= last; ++i) {
      if (i != cur) {
        flush();
        cur = i;
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) dhr_own[hh][0] = dhr_own[hh][1] = 0.f;
      }
      const bool in_g = vg && ig == i, in_g8 = vg8 && ig8 == i;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          colsum_add(dhr_own, (in_g ? acc[nb][jj] : 0.f) + (in_g8 ? acc[nb][2 + jj] : 0.f), nb,
                     jj, g);
    }
  }
  flush();

  float* part = a.partials + (int64_t)blockIdx.x * P_EA<F>;
  if (owns_grad_rows<F>(warp)) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + 2 * t, i0 = warp * SR;
      *reinterpret_cast<float2*>(part + (i0 + g) * F + c) = make_float2(gw2[nb][0], gw2[nb][1]);
      *reinterpret_cast<float2*>(part + (i0 + g + 8) * F + c) =
          make_float2(gw2[nb][2], gw2[nb][3]);
    }
  }
  __syncthreads();  // the rings are free: the warps' vector sums go there
  float* own_s = reinterpret_cast<float*>(smem + S::kRing);
#pragma unroll
  for (int v = 0; v < 4; ++v) store_own(own_s + (warp * 4 + v) * F, own[v], g, t);
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * F; i += THREADS) {
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += own_s[w * 4 * F + i];
    part[F * F + i] = sum;
  }
}

template <int F>
struct EdgeBwdBSmem {
  static constexpr int kRing = Tile<F>::WEIGHT_BYTES;      // after W_e
  static constexpr int kStage = 3 * Tile<F>::SLICE_BYTES;  // e, dhs, ge (then de)
  static constexpr int kBytes = kRing + WARPS * 2 * kStage;
  static_assert(kBytes + WARPS * 4 <= kSmemMax, "edge kernel b shared memory");
};

// de = ge + dhs @ W_e^T and dW_e = e^T dhs.
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd_edge_b(const Args a) {
  using S = EdgeBwdBSmem<F>;
  using D = Tile<F>;
  constexpr int NB = D::NB, KB = D::KB, SLICE_BYTES = D::SLICE_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int cnt[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  stage_rows<F>(sb, static_cast<const bf16*>(a.w[0]), F, F);
  cp_commit();
  if (threadIdx.x == 0) block_slices(a, cnt);
  cp_wait<0>();
  __syncthreads();
  int iters = 0;
  for (int w = 0; w < WARPS; ++w) iters = max(iters, cnt[w]);

  int64_t rc0, rc1;
  block_warp_range(a.n, blockIdx.x, gridDim.x, warp, rc0, rc1);
  const int64_t r_lo = rc0 * a.k, r_hi = rc1 * a.k;
  const int mine = cnt[warp];
  const u32 ring = S::kRing + warp * 2 * S::kStage;
  const bf16 *e = static_cast<const bf16*>(a.e), *ge = static_cast<const bf16*>(a.ge);
  const bf16* dhs = static_cast<const bf16*>(a.dhs);
  auto issue = [&](int j) {
    const int64_t s0 = r_lo + (int64_t)j * SR;
    const u32 st = ring + (j & 1) * S::kStage;
#pragma unroll
    for (int i = 0; i < D::CP_ITERS; ++i) {
      int r, c;
      slice_chunk<F>(lane, i, r, c);
      const bool v = s0 + r < r_hi;
      const int64_t at = v ? (s0 + r) * F + c * 8 : 0;
      cp_async16(sb + st + swz<F>(r, c), e + at, v);
      cp_async16(sb + st + SLICE_BYTES + swz<F>(r, c), dhs + at, v);
      cp_async16(sb + st + 2 * SLICE_BYTES + swz<F>(r, c), ge + at, v);
    }
    cp_commit();
  };

  float gwe[NB][4];  // rows [16 warp, 16 warp + 16) of dW_e, for the whole launch
  zero(gwe);
  if (mine > 0) issue(0);
  for (int j = 0; j < iters; ++j) {
    const bool active = j < mine;
    const int64_t s0 = r_lo + (int64_t)j * SR;
    const u32 st = ring + (j & 1) * S::kStage, st_ge = st + 2 * SLICE_BYTES;
    if (active) {
      if (j + 1 < mine) {
        issue(j + 1);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncwarp();
      u32 da[KB][4];
      load_a(da, sb + st + SLICE_BYTES, lane);
      float acc[NB][4];
      zero(acc);
      gemm_t(acc, da, sb, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {  // de = T(ge + T(dfirst) @ W_e^T), into the ge slot
        const int c = nb * 8 + 2 * t;
        const float2 q = unpack(lds32(smem, st_ge + swz_pair<F>(g, c)));
        const float2 q8 = unpack(lds32(smem, st_ge + swz_pair<F>(g + 8, c)));
        sts32(smem, st_ge + swz_pair<F>(g, c), pack(q.x + acc[nb][0], q.y + acc[nb][1]));
        sts32(smem, st_ge + swz_pair<F>(g + 8, c), pack(q8.x + acc[nb][2], q8.y + acc[nb][3]));
      }
      __syncwarp();
      store_slice<F>(static_cast<bf16*>(a.de), s0, r_hi, smem, st_ge, lane);
    }
    __syncthreads();
    if (owns_grad_rows<F>(warp))
      for (int w = 0; w < WARPS; ++w)
        if (j < cnt[w]) {
          const u32 sw = S::kRing + w * 2 * S::kStage + (j & 1) * S::kStage;
          gemm_tn(gwe, sb + sw, sb + sw + SLICE_BYTES, warp * SR, lane);
        }
    __syncthreads();
  }
  if (!owns_grad_rows<F>(warp)) return;
  float* part = a.partials + (int64_t)blockIdx.x * P_EB<F>;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t, i0 = warp * SR;
    *reinterpret_cast<float2*>(part + (i0 + g) * F + c) = make_float2(gwe[nb][0], gwe[nb][1]);
    *reinterpret_cast<float2*>(part + (i0 + g + 8) * F + c) = make_float2(gwe[nb][2], gwe[nb][3]);
  }
}

// ---- bf16 at F = 192 and 256: the stream design ---------------------------

// The stream design's bf16 operands of the weight-gradient products, in one
// (2 n k + 4 n, F) buffer: T(relu(first)) and T(dx1) (n k rows each), then
// T(agg), T(r2), T(dy1), T(dnf) (n rows each).
struct Ops {
  bf16 *r1c, *dx1c, *aggc, *r2c, *dy1c, *dnfc;
  __host__ __device__ Ops(void* base, int n, int k, int f) {
    const int64_t edge = (int64_t)n * k * f, node = (int64_t)n * f;
    r1c = static_cast<bf16*>(base);
    dx1c = r1c + edge;
    aggc = dx1c + edge;
    r2c = aggc + node;
    dy1c = r2c + node;
    dnfc = dy1c + node;
  }
};

// The stream backward's row kernels keep each warp's vector-gradient sums
// (and the edge kernel its receiver's dhr) in shared memory, out of the
// registers that the accumulator fills, and take a 3-stage ring for room.
constexpr int BWD_STAGES = 3;

template <int F>
struct BwdStreamSmem {  // the node and edge kernels
  static constexpr int kSlots = Stream<F, BWD_STAGES>::RING_BYTES;
  static constexpr int kOwn = kSlots + Stream<F>::SLOTS_BYTES;  // each warp's 4 vector sums
  static constexpr int kDhr = kOwn + WARPS * 4 * F * 4;         // each warp's dhr row
  static constexpr int kVec = kDhr + WARPS * F * 4;              // 4 float vectors
  static constexpr int kBytes = kVec + 4 * F * 4;
  static_assert(kBytes <= kSmemMax, "stream backward shared memory");
};

// zeroes the warps' vector sums and dhr rows (seen after the ring's first
// barrier)
template <int F>
__device__ __forceinline__ void zero_sums(unsigned char* smem) {
  using S = BwdStreamSmem<F>;
  float* z = reinterpret_cast<float*>(smem + S::kOwn);
  for (int i = threadIdx.x; i < WARPS * 5 * F; i += THREADS) z[i] = 0.f;
}

// this block's 4 vector gradients: the warps' sums added in warp order into
// part[0, 4 F)
template <int F>
__device__ __forceinline__ void block_vectors(const unsigned char* smem, float* part) {
  const float* own = reinterpret_cast<const float*>(smem + BwdStreamSmem<F>::kOwn);
  cp_wait<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * F; i += THREADS) {
    float sum = 0.f;
    for (int w = 0; w < WARPS; ++w) sum += own[w * 4 * F + i];
    part[i] = sum;
  }
}

// K3's stream edge body with no e' out: the step's agg, rematerialized.
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd_agg_stream(const EdgeArgs a) {
  edge_fwd_stream<F, false, Src::kGathered>(a);
}

// The node path's forward and backward in the stream design: 16 nodes per
// warp, 128 per block and iteration. Slots s_h (h, then T(dy1), then dh) and
// s_a (T(agg), then T(r2), then T(dnf)); the ring streams W_nh, W_na, W_n2,
// then W_n2, W_nh, W_na as column blocks (the transposed products). Writes dh,
// dagg (float32 scratch), the operands T(agg), T(r2), T(dy1), T(dnf), and
// the block's sums of bn1, bn2, ln2 scale and ln2 bias (4 F floats).
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd_node_stream(const Args a) {
  using S = BwdStreamSmem<F>;
  using D = Tile<F>;
  constexpr int NB = D::NB, SLICE = D::SLICE_BYTES, ROWS = WARPS * SR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  float* vec = reinterpret_cast<float*>(smem + S::kVec);
  for (int i = threadIdx.x; i < 4 * F; i += THREADS) vec[i] = a.vec[V_BN1 + i / F][i % F];
  const float *bn1 = vec, *bn2 = vec + F, *s2 = vec + 2 * F;
  const int groups = (a.n + ROWS - 1) / ROWS;
  const int iters = (int)blockIdx.x < groups ? (groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const bf16 *wNh = static_cast<const bf16*>(a.w[G_WNH]), *wNa = static_cast<const bf16*>(a.w[G_WNA]);
  const bf16* wN2 = static_cast<const bf16*>(a.w[G_WN2]);
  zero_sums<F>(smem);
  Ring<F, BWD_STAGES> ring;
  ring.base = sb;
  ring.nseq = 6;
  ring.cols = 0b111000;  // W_n2, W_nh, W_na transposed
  ring.seq[0] = wNh;
  ring.seq[1] = wNa;
  ring.seq[2] = wN2;
  ring.seq[3] = wN2;
  ring.seq[4] = wNh;
  ring.seq[5] = wNa;
  ring.start(iters);
  const u32 s_h = S::kSlots + warp * 2 * SLICE, s_a = s_h + SLICE;
  const Ops ops(a.ops, a.n, a.k, F);
  const bf16 *h = static_cast<const bf16*>(a.h), *gh = static_cast<const bf16*>(a.gh);
  bf16* dh = static_cast<bf16*>(a.dh);
  const float inv_n = 1.f / a.nf;

  // this warp's sums of bn1, bn2, ln2 scale, ln2 bias, F floats each
  float* own = reinterpret_cast<float*>(smem + S::kOwn) + warp * 4 * F;
  float acc[NB][4];
  for (int it = 0; it < iters; ++it) {
    const int64_t r0 = ((int64_t)(blockIdx.x + it * gridDim.x) * WARPS + warp) * SR;
    const bool live = r0 < a.n;
    const bool vg = r0 + g < a.n, vg8 = r0 + g + 8 < a.n;
    if (live) {
      copy_slice<F>(sb + s_h, h, r0, a.n, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {  // T(agg)
        const int c = nb * 8 + 2 * t;
        const float2 x = vg ? *reinterpret_cast<const float2*>(a.agg + (r0 + g) * F + c)
                            : make_float2(0.f, 0.f);
        const float2 x8 = vg8 ? *reinterpret_cast<const float2*>(a.agg + (r0 + g + 8) * F + c)
                              : make_float2(0.f, 0.f);
        sts32(smem, s_a + swz_pair<F>(g, c), pack(x.x, x.y));
        sts32(smem, s_a + swz_pair<F>(g + 8, c), pack(x8.x, x8.y));
      }
    }
    cp_commit();
    if (live) {
      __syncwarp();
      store_slice<F>(ops.aggc, r0, a.n, smem, s_a, lane);
    }
    zero(acc);  // nf - bn1 = h @ W_nh + T(agg) @ W_na, one sum
    product<false>(acc, ring, sb + s_h, live, true, lane);
    product<false>(acc, ring, sb + s_a, live, false, lane);
    if (live) {  // T(r2) = T(relu(nf)), over T(agg)
      __syncwarp();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        sts32(smem, s_a + swz_pair<F>(g, c),
              pack(fmaxf(acc[nb][0] + bn1[c], 0.f), fmaxf(acc[nb][1] + bn1[c + 1], 0.f)));
        sts32(smem, s_a + swz_pair<F>(g + 8, c),
              pack(fmaxf(acc[nb][2] + bn1[c], 0.f), fmaxf(acc[nb][3] + bn1[c + 1], 0.f)));
      }
      __syncwarp();
      store_slice<F>(ops.r2c, r0, a.n, smem, s_a, lane);
    }
    zero(acc);  // y1 - bn2 = T(r2) @ W_n2
    product<false>(acc, ring, sb + s_a, live, false, lane);
    if (live) {
      add_bias(acc, bn2, t);
      float inv[2];
      row_normalize(acc, inv[0], inv[1], a.nf);  // acc = xhat2 (-mean inv past nf)
      // LN2 backward with gh: dy1 = inv (gh s - mean(gh s) - xhat mean(gh s xhat))
      auto gh_of = [&](int nb, float (&dv)[4]) {
        const int c = nb * 8 + 2 * t;
        const float2 d = unpack(vg ? ldg32(gh + (r0 + g) * F + c) : 0u);
        const float2 d8 = unpack(vg8 ? ldg32(gh + (r0 + g + 8) * F + c) : 0u);
        dv[0] = d.x;
        dv[1] = d.y;
        dv[2] = d8.x;
        dv[3] = d8.y;
      };
      float p1[2] = {0.f, 0.f}, p2[2] = {0.f, 0.f};
#pragma unroll
      for (int b0 = 0; b0 < NB; b0 += 8) {
        float dv[8][4];
#pragma unroll
        for (int k = 0; k < 8; ++k) gh_of(b0 + k, dv[k]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float vs[8], vb[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const int nb = b0 + k, c = nb * 8 + 2 * t;
            vs[k] = dv[k][j] * acc[nb][j] + dv[k][2 + j] * acc[nb][2 + j];
            vb[k] = dv[k][j] + dv[k][2 + j];
#pragma unroll
            for (int r8 = 0; r8 < 2; ++r8) {
              const float dx = dv[k][2 * r8 + j] * s2[c + j];
              p1[r8] += dx;
              p2[r8] += dx * acc[nb][2 * r8 + j];
            }
          }
          colsum8_to(own + 2 * F, vs, b0, j, g, t);
          colsum8_to(own + 3 * F, vb, b0, j, g, t);
        }
      }
      float m1[2], m2[2];
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        m1[r8] = quad_sum(p1[r8]) * inv_n;
        m2[r8] = quad_sum(p2[r8]) * inv_n;
      }
#pragma unroll
      for (int b0 = 0; b0 < NB; b0 += 8) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int nb = b0 + k, c = nb * 8 + 2 * t;
          float dv[4];
          gh_of(nb, dv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r8 = i >> 1, j = i & 1;
            acc[nb][i] = inv[r8] * (dv[i] * s2[c + j] - m1[r8] - acc[nb][i] * m2[r8]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = acc[b0 + k][j] + acc[b0 + k][2 + j];
          colsum8_to(own + F, v, b0, j, g, t);
        }
      }
      __syncwarp();  // h, in s_h, was the first product's operand
      put_pairs(acc, smem, s_h, lane);  // T(dy1)
      __syncwarp();
      store_slice<F>(ops.dy1c, r0, a.n, smem, s_h, lane);
    }
    zero(acc);  // T(dy1) @ W_n2^T
    product<true>(acc, ring, sb + s_h, live, false, lane);
    if (live) {  // dnf = . * (nf > 0) -> T(dnf), over T(r2)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        const float2 r = unpack(lds32(smem, s_a + swz_pair<F>(g, c)));
        const float2 r8 = unpack(lds32(smem, s_a + swz_pair<F>(g + 8, c)));
        acc[nb][0] = r.x > 0.f ? acc[nb][0] : 0.f;
        acc[nb][1] = r.y > 0.f ? acc[nb][1] : 0.f;
        acc[nb][2] = r8.x > 0.f ? acc[nb][2] : 0.f;
        acc[nb][3] = r8.y > 0.f ? acc[nb][3] : 0.f;
        sts32(smem, s_a + swz_pair<F>(g, c), pack(acc[nb][0], acc[nb][1]));
        sts32(smem, s_a + swz_pair<F>(g + 8, c), pack(acc[nb][2], acc[nb][3]));
      }
#pragma unroll
      for (int b0 = 0; b0 < NB; b0 += 8)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = acc[b0 + k][j] + acc[b0 + k][2 + j];
          colsum8_to(own, v, b0, j, g, t);
        }
      __syncwarp();
      store_slice<F>(ops.dnfc, r0, a.n, smem, s_a, lane);
    }
    zero(acc);  // T(dnf) @ W_nh^T
    product<true>(acc, ring, sb + s_a, live, false, lane);
    if (live) {  // dh = T(gh + .), out through s_h
      __syncwarp();  // T(dy1), in s_h, was an operand
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        const float2 d = unpack(vg ? ldg32(gh + (r0 + g) * F + c) : 0u);
        const float2 d8 = unpack(vg8 ? ldg32(gh + (r0 + g + 8) * F + c) : 0u);
        sts32(smem, s_h + swz_pair<F>(g, c), pack(d.x + acc[nb][0], d.y + acc[nb][1]));
        sts32(smem, s_h + swz_pair<F>(g + 8, c), pack(d8.x + acc[nb][2], d8.y + acc[nb][3]));
      }
      __syncwarp();
      store_slice<F>(dh, r0, a.n, smem, s_h, lane);
    }
    zero(acc);  // dagg = T(dnf) @ W_na^T
    product<true>(acc, ring, sb + s_a, live, false, lane);
    if (live) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        if (vg)
          *reinterpret_cast<float2*>(a.dagg + (r0 + g) * F + c) = make_float2(acc[nb][0], acc[nb][1]);
        if (vg8)
          *reinterpret_cast<float2*>(a.dagg + (r0 + g + 8) * F + c) =
              make_float2(acc[nb][2], acc[nb][3]);
      }
      __syncwarp();  // both slots are refilled by the next iteration
    }
  }
  block_vectors<F>(smem, a.partials + (int64_t)blockIdx.x * 4 * F);
}

// The edge path's backward in the stream design, from the rematerialized
// forward: dhs, dhr, de, the operands T(relu(first)) and T(dx1) of dW2, and
// the block's sums of b1, b2, ln1 scale and ln1 bias (4 F floats).
// Persistent, each warp owning the receivers it owns in the agg pass; slots
// s_0 (e, then ge, then T(dx1), then T(dfirst)) and s_1 (hs, then
// T(relu(first)), then ge, then de); the ring streams W_e, W2, then W2 and
// W_e as column blocks (the transposed products).
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd_edge_stream(const Args a) {
  using S = BwdStreamSmem<F>;
  using D = Tile<F>;
  constexpr int NB = D::NB, NH = D::NH, SLICE = D::SLICE_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  float* vec = reinterpret_cast<float*>(smem + S::kVec);
  for (int i = threadIdx.x; i < 4 * F; i += THREADS) vec[i] = a.vec[i / F][i % F];
  const float *b1 = vec, *b2 = vec + F, *s1 = vec + 2 * F;

  const int K = a.k;
  int64_t rc0, rc1;
  block_warp_range(a.n, blockIdx.x, gridDim.x, warp, rc0, rc1);
  const int64_t r_lo = rc0 * K, r_hi = rc1 * K;
  const int mine = (int)((r_hi - r_lo + SR - 1) / SR);
  const int iters = block_iters(a.n, K);
  const bf16 *wE = static_cast<const bf16*>(a.w[G_WE]), *w2 = static_cast<const bf16*>(a.w[G_W2]);
  zero_sums<F>(smem);
  Ring<F, BWD_STAGES> ring;
  ring.base = sb;
  ring.nseq = 4;
  ring.cols = 0b1100;  // W2, W_e transposed
  ring.seq[0] = wE;
  ring.seq[1] = w2;
  ring.seq[2] = w2;
  ring.seq[3] = wE;
  ring.start(iters);
  const u32 s_0 = S::kSlots + warp * 2 * SLICE, s_1 = s_0 + SLICE;
  const Ops ops(a.ops, a.n, K, F);
  const bf16 *e = static_cast<const bf16*>(a.e), *hs = static_cast<const bf16*>(a.hs);
  const bf16 *ge = static_cast<const bf16*>(a.ge), *hr = static_cast<const bf16*>(a.hr);
  bf16 *dhs = static_cast<bf16*>(a.dhs), *de = static_cast<bf16*>(a.de);
  bf16* dhr = static_cast<bf16*>(a.dhr);
  const float inv_n = 1.f / a.nf;

  float m_next = 0.f;
  auto mask_of = [&](int64_t s0) {  // lane r < 16: row r's mask
    const int64_t rr = s0 + (lane & 15);
    return rr < r_hi ? a.mask[rr] : 0.f;
  };
  if (mine > 0) {
    copy_slice<F>(sb + s_0, e, r_lo, r_hi, lane);
    copy_slice<F>(sb + s_1, hs, r_lo, r_hi, lane);
    m_next = mask_of(r_lo);
  }
  cp_commit();

  // this warp's sums of b1, b2, ln1 scale, ln1 bias, F floats each, and the
  // dhr of receiver `cur`, each column kept by its owner lane
  float* own = reinterpret_cast<float*>(smem + S::kOwn) + warp * 4 * F;
  float* dhr_row = reinterpret_cast<float*>(smem + S::kDhr) + warp * F;
  int64_t cur = -1;
  auto flush = [&]() {  // T(dhr) out, the row zeroed
    if (cur < 0) return;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int c = (g + 8 * hh) * 8 + 2 * t;
      *reinterpret_cast<u32*>(dhr + cur * F + c) = pack(dhr_row[c], dhr_row[c + 1]);
      dhr_row[c] = dhr_row[c + 1] = 0.f;
    }
  };
  float acc[NB][4];
  for (int j = 0; j < iters; ++j) {
    const bool live = j < mine;
    const int64_t s0 = r_lo + (int64_t)j * SR;
    const bool vg = s0 + g < r_hi, vg8 = s0 + g + 8 < r_hi;
    const int64_t ig = vg ? (s0 + g) / K : 0, ig8 = vg8 ? (s0 + g + 8) / K : 0;
    const float m_row = m_next;

    zero(acc);  // first = e @ W_e + hs + hr + b1 -> T(relu(first)) in s_1
    product<false>(acc, ring, sb + s_0, live, true, lane);
    if (live) {
      relu_first(acc, smem, s_1, hr, b1, vg, vg8, ig, ig8, lane);
      store_slice<F>(ops.r1c, s0, r_hi, smem, s_1, lane);
      copy_slice<F>(sb + s_0, ge, s0, r_hi, lane);  // e was the product's operand
    }
    cp_commit();  // ge: waited for by the third slab of W2

    zero(acc);  // x1 - b2 = T(relu(first)) @ W2
    product<false>(acc, ring, sb + s_1, live, false, lane);
    if (live) {
      add_bias(acc, b2, t);
      float inv[2];
      row_normalize(acc, inv[0], inv[1], a.nf);  // acc = xhat1 (-mean inv past nf)
      // LN1 backward: dm = ge + dagg * mask; dx1 = inv (dm s - mean(dm s) -
      // xhat mean(dm s xhat)); dm is formed twice rather than kept, its
      // dagg loaded LB n-blocks at a time
      const float mg = __shfl_sync(lbt::kFullMask, m_row, g);
      const float mg8 = __shfl_sync(lbt::kFullMask, m_row, g + 8);
      auto dm_batch = [&](int b0, float (&dv)[LB][4]) {
        float2 d[LB][2];
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int c = (b0 + i) * 8 + 2 * t;
          d[i][0] = vg ? __ldg(reinterpret_cast<const float2*>(a.dagg + ig * F + c))
                       : make_float2(0.f, 0.f);
          d[i][1] = !vg8 ? make_float2(0.f, 0.f)
                    : ig8 == ig && vg ? d[i][0]
                                      : __ldg(reinterpret_cast<const float2*>(a.dagg + ig8 * F + c));
        }
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int c = (b0 + i) * 8 + 2 * t;
          const float2 q = unpack(lds32(smem, s_0 + swz_pair<F>(g, c)));
          const float2 q8 = unpack(lds32(smem, s_0 + swz_pair<F>(g + 8, c)));
          dv[i][0] = q.x + d[i][0].x * mg;
          dv[i][1] = q.y + d[i][0].y * mg;
          dv[i][2] = q8.x + d[i][1].x * mg8;
          dv[i][3] = q8.y + d[i][1].y * mg8;
        }
      };
      float p1[2] = {0.f, 0.f}, p2[2] = {0.f, 0.f};
#pragma unroll
      for (int b0 = 0; b0 < NB; b0 += LB) {
        float dv[LB][4];
        dm_batch(b0, dv);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float vs[LB], vb[LB];
#pragma unroll
          for (int i = 0; i < LB; ++i) {
            const int nb = b0 + i, c = nb * 8 + 2 * t;
            vs[i] = dv[i][jj] * acc[nb][jj] + dv[i][2 + jj] * acc[nb][2 + jj];
            vb[i] = dv[i][jj] + dv[i][2 + jj];
#pragma unroll
            for (int r8 = 0; r8 < 2; ++r8) {
              const float dx = dv[i][2 * r8 + jj] * s1[c + jj];
              p1[r8] += dx;
              p2[r8] += dx * acc[nb][2 * r8 + jj];
            }
          }
          colsum8_to(own + 2 * F, vs, b0, jj, g, t);
          colsum8_to(own + 3 * F, vb, b0, jj, g, t);
        }
      }
      float m1[2], m2[2];
#pragma unroll
      for (int r8 = 0; r8 < 2; ++r8) {
        m1[r8] = quad_sum(p1[r8]) * inv_n;
        m2[r8] = quad_sum(p2[r8]) * inv_n;
      }
#pragma unroll
      for (int b0 = 0; b0 < NB; b0 += LB) {  // T(dx1), 0 on rows past r_hi, over ge
        float dv[LB][4];
        dm_batch(b0, dv);
#pragma unroll
        for (int i = 0; i < LB; ++i) {
          const int nb = b0 + i, c = nb * 8 + 2 * t;
#pragma unroll
          for (int e4 = 0; e4 < 4; ++e4) {
            const int r8 = e4 >> 1, jj = e4 & 1;
            acc[nb][e4] = inv[r8] * (dv[i][e4] * s1[c + jj] - m1[r8] - acc[nb][e4] * m2[r8]);
          }
          sts32(smem, s_0 + swz_pair<F>(g, c), vg ? pack(acc[nb][0], acc[nb][1]) : 0u);
          sts32(smem, s_0 + swz_pair<F>(g + 8, c), vg8 ? pack(acc[nb][2], acc[nb][3]) : 0u);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float v[LB];
#pragma unroll
          for (int i = 0; i < LB; ++i) v[i] = acc[b0 + i][jj] + acc[b0 + i][2 + jj];
          colsum8_to(own + F, v, b0, jj, g, t);
        }
      }
      __syncwarp();
      store_slice<F>(ops.dx1c, s0, r_hi, smem, s_0, lane);
    }

    zero(acc);  // T(dx1) @ W2^T
    product<true>(acc, ring, sb + s_0, live, false, lane);
    if (live) {  // dfirst = . * (first > 0) -> T(dfirst) in s_0, out as dhs
      __syncwarp();  // T(dx1), in s_0, was the product's operand
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        const float2 r = unpack(lds32(smem, s_1 + swz_pair<F>(g, c)));
        const float2 r8 = unpack(lds32(smem, s_1 + swz_pair<F>(g + 8, c)));
        acc[nb][0] = r.x > 0.f ? acc[nb][0] : 0.f;
        acc[nb][1] = r.y > 0.f ? acc[nb][1] : 0.f;
        acc[nb][2] = r8.x > 0.f ? acc[nb][2] : 0.f;
        acc[nb][3] = r8.y > 0.f ? acc[nb][3] : 0.f;
        sts32(smem, s_0 + swz_pair<F>(g, c), pack(acc[nb][0], acc[nb][1]));
        sts32(smem, s_0 + swz_pair<F>(g + 8, c), pack(acc[nb][2], acc[nb][3]));
      }
#pragma unroll
      for (int b0 = 0; b0 < NB; b0 += 8)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = acc[b0 + k][jj] + acc[b0 + k][2 + jj];
          colsum8_to(own, v, b0, jj, g, t);
        }
      __syncwarp();
      store_slice<F>(dhs, s0, r_hi, smem, s_0, lane);
      // dhr: dfirst summed per receiver, in row order
      const int64_t first = s0 / K, last = ((s0 + SR < r_hi ? s0 + SR : r_hi) - 1) / K;
      for (int64_t i = first; i <= last; ++i) {
        if (i != cur) {
          flush();
          cur = i;
        }
        const bool in_g = vg && ig == i, in_g8 = vg8 && ig8 == i;
#pragma unroll
        for (int b0 = 0; b0 < NB; b0 += 8)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              v[k] = (in_g ? acc[b0 + k][jj] : 0.f) + (in_g8 ? acc[b0 + k][2 + jj] : 0.f);
            colsum8_to(dhr_row, v, b0, jj, g, t);
          }
      }
      __syncwarp();
      copy_slice<F>(sb + s_1, ge, s0, r_hi, lane);  // T(relu(first)) was read above
    }
    cp_commit();  // ge: waited for by the third slab of W_e

    zero(acc);  // T(dfirst) @ W_e^T
    product<true>(acc, ring, sb + s_0, live, false, lane);
    if (live) {
      __syncwarp();  // T(dfirst), in s_0, was the product's operand
      if (j + 1 < mine) copy_slice<F>(sb + s_0, e, s0 + SR, r_hi, lane);
      add_pairs(acc, smem, s_1, lane);  // de = T(ge + .), out through s_1
      __syncwarp();
      store_slice<F>(de, s0, r_hi, smem, s_1, lane);
      __syncwarp();
      if (j + 1 < mine) {
        copy_slice<F>(sb + s_1, hs, s0 + SR, r_hi, lane);
        m_next = mask_of(s0 + SR);
      }
    }
    cp_commit();  // the next slice's rows, waited for by its first slab
  }
  flush();
  block_vectors<F>(smem, a.partials + (int64_t)blockIdx.x * 4 * F);
}

// The five weight gradients of the stream design, G = X^T Y over each job's
// rows (X, Y row-major (rows, F) bf16). Block b takes output rows [F / 2 (b
// & 1), F / 2 (b & 1) + F / 2) of one row range of one job: the ranges of
// job 0, then job 1, ... (job q's rows split into `ranges` runs of whole
// 32-row chunks, range r the chunks [c r / ranges, c (r + 1) / ranges) of its
// c chunks). Its 8 warps (2 x 4) own F / 4 x F / 4 output tiles (64 x 64 at
// F = 256) in registers for the whole range, the chunks arriving through a
// 3-stage cp.async ring; each range writes its partial F x F once.
struct TnJob {
  const bf16* x;
  const bf16* y;
  int64_t rows;
  int ranges;
};
struct TnArgs {
  TnJob job[5];   // dW_e, dW2, dW_nh, dW_na, dW_n2
  float* partials;  // the ranges' F x F partials, job by job
};

constexpr int TN_STAGES = 3;
template <int F>
struct TnSmem {
  static constexpr int kStage = 2 * KS * Tile<F>::ROW_BYTES;  // X and Y chunks: 32 KB at F = 256
  static constexpr int kBytes = TN_STAGES * kStage;
  static_assert(kBytes <= kSmemMax, "TN kernel shared memory");
};

template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_bwd_tn(const TnArgs a) {
  constexpr int WT = F / 4, MT = WT / 16, NT = WT / 8;  // a warp's output tile
  constexpr int ROW_BYTES = Tile<F>::ROW_BYTES;
  using S = TnSmem<F>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  int range = blockIdx.x >> 1, jb = 0, before = 0;
  while (jb < 4 && range >= a.job[jb].ranges) {
    range -= a.job[jb].ranges;
    before += a.job[jb].ranges;
    ++jb;
  }
  const TnJob J = a.job[jb];
  const int64_t chunks = (J.rows + KS - 1) / KS;
  const int64_t c0 = chunks * range / J.ranges, c1 = chunks * (range + 1) / J.ranges;
  const int n = (int)(c1 - c0);
  const int i0 = (blockIdx.x & 1) * (F / 2) + (warp >> 2) * WT, j0 = (warp & 3) * WT;
  auto issue = [&](int q) {
    if (q < n) {
      const int64_t r = (c0 + q) * KS;
      const int valid = J.rows - r < KS ? (int)(J.rows - r) : KS;
      const u32 st = sb + (q % TN_STAGES) * S::kStage;
      stage_rows<F>(st, J.x + r * F, KS, valid);
      stage_rows<F>(st + KS * ROW_BYTES, J.y + r * F, KS, valid);
    }
    cp_commit();
  };
  for (int q = 0; q < TN_STAGES - 1; ++q) issue(q);
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) zero(acc[mt]);
  for (int q = 0; q < n; ++q) {
    cp_wait<TN_STAGES - 2>();
    __syncthreads();
    issue(q + TN_STAGES - 1);
    const u32 x = sb + (q % TN_STAGES) * S::kStage, y = x + KS * ROW_BYTES;
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      u32 af[MT][4];  // X^T: X's rows read transposed
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_t(af[mt], x + swz<F>(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  (i0 + mt * 16) / 8 + ((lane >> 3) & 1)));
      const int k = kk * 16 + (lane & 7) + (lane & 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        u32 b[4];
        ldsm_t(b, y + swz<F>(k, (j0 + np * 16) / 8 + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * np], af[mt], b[0], b[1]);
          mma(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
        }
      }
    }
  }
  float* out = a.partials + (int64_t)(before + range) * F * F;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
      const int row = i0 + mt * 16 + g, col = j0 + nb * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + row * F + col) = make_float2(acc[mt][nb][0], acc[mt][nb][1]);
      *reinterpret_cast<float2*>(out + (row + 8) * F + col) =
          make_float2(acc[mt][nb][2], acc[mt][nb][3]);
    }
}

// out[seg.out + j] = sum over blocks b, in order, of seg.src[b * seg.stride + j]
struct Seg {
  const float* src;
  int blocks, stride, len, out;
};
struct Segs {
  Seg s[7];
  int count;
};

__global__ void fused_mp_bwd_reduce(const Segs segs, float* out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  for (int i = 0; i < segs.count; ++i) {
    const Seg& sg = segs.s[i];
    if (j < sg.out || j >= sg.out + sg.len) continue;
    float s = 0.f;
    for (int b = 0; b < sg.blocks; ++b) s += sg.src[(int64_t)b * sg.stride + (j - sg.out)];
    out[j] = s;
  }
}

template <typename T, int F>
int launch(const Args& a, int grid, cudaStream_t stream) {
  constexpr int smem = Smem<T, F>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mp_bwd<T, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mp_bwd<T, F><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int node_blocks(int n) { return lbt::ceil_div(n, NB_ROWS); }

// the three partial buffers of the bf16 instance, in one allocation
template <int F>
void bf16_partials(float* base, int grid, int n, float** node, float** ea, float** eb) {
  *node = base;
  *ea = *node + (int64_t)node_blocks(n) * P_NODE<F>;
  *eb = *ea + (int64_t)grid * P_EA<F>;
}

template <int F>
int run_bf16(Args a, int grid, cudaStream_t stream) {
  float *p_node, *p_ea, *p_eb;
  bf16_partials<F>(a.partials, grid, a.n, &p_node, &p_ea, &p_eb);
  EdgeArgs f{};
  f.e = a.e;
  f.hs = static_cast<const bf16*>(a.hs);
  f.hr = static_cast<const bf16*>(a.hr);
  f.mask = a.mask;
  f.w_e = static_cast<const bf16*>(a.w[0]);
  f.w2 = static_cast<const bf16*>(a.w[1]);
  for (int i = 0; i < 4; ++i) f.vec[i] = a.vec[i];
  f.e_out = nullptr;
  f.agg = a.agg;
  f.n = a.n;
  f.k = a.k;
  f.nf = a.nf;
  int err = launch_kernel(fused_mp_bwd_agg<F>, grid, THREADS, EdgeSmem<F, false>::kBytes, f,
                          stream);
  if (err != 0) return err;
  a.partials = p_node;
  err = launch_kernel(fused_mp_bwd_node<F>, node_blocks(a.n), NB_WARPS * 32,
                      NodeBwdSmem<F>::kBytes, a, stream);
  if (err != 0) return err;
  a.partials = p_ea;
  err = launch_kernel(fused_mp_bwd_edge_a<F>, grid, THREADS, EdgeBwdASmem<F>::kBytes, a, stream);
  if (err != 0) return err;
  a.partials = p_eb;
  return launch_kernel(fused_mp_bwd_edge_b<F>, grid, THREADS, EdgeBwdBSmem<F>::kBytes, a, stream);
}

// The stream design's partials, in one allocation: the TN kernel's range
// partials (2 r_e + 3 r_n) x F^2, then the edge kernel's blocks x 4 F, then
// the node kernel's blocks x 4 F (plan: edge grid, node grid, r_e, r_n).
template <int F>
void stream_partials(float* base, const int* plan, float** tn, float** edge, float** node) {
  *tn = base;
  *edge = *tn + (int64_t)(2 * plan[2] + 3 * plan[3]) * F * F;
  *node = *edge + (int64_t)plan[0] * 4 * F;
}

template <int F>
int run_stream(Args a, const int* plan, cudaStream_t stream) {
  if (plan == nullptr || plan[0] < 1 || plan[1] < 1 || plan[2] < 1 || plan[3] < 1 ||
      a.ops == nullptr)
    return (int)cudaErrorInvalidValue;
  float *p_tn, *p_edge, *p_node;
  stream_partials<F>(a.partials, plan, &p_tn, &p_edge, &p_node);
  EdgeArgs f{};
  f.e = a.e;
  f.hs = static_cast<const bf16*>(a.hs);
  f.hr = static_cast<const bf16*>(a.hr);
  f.mask = a.mask;
  f.w_e = static_cast<const bf16*>(a.w[0]);
  f.w2 = static_cast<const bf16*>(a.w[1]);
  for (int i = 0; i < 4; ++i) f.vec[i] = a.vec[i];
  f.e_out = nullptr;
  f.agg = a.agg;
  f.n = a.n;
  f.k = a.k;
  f.nf = a.nf;
  int err = launch_kernel(fused_mp_bwd_agg_stream<F>, plan[0], THREADS,
                          EdgeStreamSmem<F, false>::kBytes, f, stream);
  if (err != 0) return err;
  a.partials = p_node;
  err = launch_kernel(fused_mp_bwd_node_stream<F>, plan[1], THREADS, BwdStreamSmem<F>::kBytes, a,
                      stream);
  if (err != 0) return err;
  a.partials = p_edge;
  err = launch_kernel(fused_mp_bwd_edge_stream<F>, plan[0], THREADS, BwdStreamSmem<F>::kBytes, a,
                      stream);
  if (err != 0) return err;
  const Ops ops(a.ops, a.n, a.k, F);
  const int64_t rows = (int64_t)a.n * a.k;
  TnArgs tn;
  tn.job[G_WE] = TnJob{static_cast<const bf16*>(a.e), static_cast<const bf16*>(a.dhs), rows, plan[2]};
  tn.job[G_W2] = TnJob{ops.r1c, ops.dx1c, rows, plan[2]};
  tn.job[G_WNH] = TnJob{static_cast<const bf16*>(a.h), ops.dnfc, a.n, plan[3]};
  tn.job[G_WNA] = TnJob{ops.aggc, ops.dnfc, a.n, plan[3]};
  tn.job[G_WN2] = TnJob{ops.r2c, ops.dy1c, a.n, plan[3]};
  tn.partials = p_tn;
  return launch_kernel(fused_mp_bwd_tn<F>, 2 * (2 * plan[2] + 3 * plan[3]), THREADS,
                       TnSmem<F>::kBytes, tn, stream);
}

}  // namespace

// ptrs (host array of device pointers), in order:
//   0 e, 1 hs_gath, 2 hr, 3 h, 4 mask, 5 ge, 6 gh, 7 de, 8 dhs, 9 dhr, 10 dh,
//   11 W_e, 12 W2, 13 W_nh, 14 W_na, 15 W_n2,
//   16 b1, 17 b2, 18 ln1_scale, 19 ln1_bias, 20 bn1, 21 bn2, 22 ln2_scale,
//   23 ln2_bias, 24 partials (float32 tile design: (grid, 5 F^2 + 8 F); bf16
//   warp design: ceil(n / 64) x (3 F^2 + 4 F) for the node kernel, then grid
//   x (F^2 + 4 F) for edge kernel a and grid x F^2 for edge kernel b; bf16
//   stream design: stream_partials), 25 scratch (bf16: (2 n, F) float32, agg
//   then dagg), 26 agg out (the float32 tile design: (n, F) float32 that
//   receives the step's agg as the kernel summed it, or null), 27 the stream
//   design's operands ((2 n k + 4 n, F) bf16, Ops); the wide path (nf >
//   256, mp_wide.cuh) takes partials in wide_partials' layout, the agg out
//   in either dtype, and its buffers at 28-37 (ops/fused_mp.py _wide_buffers):
//   28 T(relu(first)) (rows, F), 29 x1 (rows, F) float32, 30 T(agg) (n, F),
//   31 T(relu(node_first)) (n, F), 32 y1 (n, F) float32, 33 T(dy1) (n, F),
//   34 dnf (n, F) float32, 35 T(dnf) (n, F), 36 dagg (n, F) float32, 37
//   T(dx1) (rows, F), 38 the agg partials (tiles, slots, F) float32 of the
//   wgmma design (bf16 at nf <= 512), whose edge kernel rematerializes 28
//   and 30 and whose edge-backward kernel then sums dfirst there; the
//   wgmma design takes no x1 (29 null: it keeps x1 on chip) and takes 39
//   W_e^T and 40 W2^T (F, F) bf16.
// latent: the true width nf >= 1 (else cudaErrorInvalidValue); every
//   tensor and weight is F = 64 ceil(nf / 64) wide, zero past nf.
// grid: the float32 tile design's and the bf16 warp design's edge grid;
// plan: the stream design's (edge grid, node grid, r_e, r_n), the ranges of
//   the edge and the node weight gradients (ops/fused_mp.py bwd_stream_plan);
//   the wide path's (r_e, r_n, p_e, p_n), its weight gradients' ranges and
//   its row kernels' warps (ops/fused_mp.py wide_plan; the wgmma design's
//   r_e its TN kernel's ranges, p_e 4 vector rows per edge-kernel block).
LBT_EXPORT int lbt_fused_mp_bwd(const void* const* ptrs, int n, int k, int latent, int is_bf16,
                                int grid, const int* plan, cudaStream_t stream) {
  if (latent > kMaxLatent) {  // the wide path (mp_wide.cuh)
    if (n < 1 || k < 1 || plan == nullptr) return (int)cudaErrorInvalidValue;
    WideBwd w;
    w.e = ptrs[0];
    w.hs = ptrs[1];
    w.hr = ptrs[2];
    w.h = ptrs[3];
    w.mask = static_cast<const float*>(ptrs[4]);
    w.ge = ptrs[5];
    w.gh = ptrs[6];
    w.de = const_cast<void*>(ptrs[7]);
    w.dhs = const_cast<void*>(ptrs[8]);
    w.dhr = const_cast<void*>(ptrs[9]);
    w.dh = const_cast<void*>(ptrs[10]);
    for (int i = 0; i < 5; ++i) w.w[i] = ptrs[11 + i];
    for (int i = 0; i < 8; ++i) w.vec[i] = static_cast<const float*>(ptrs[16 + i]);
    w.partials = static_cast<float*>(const_cast<void*>(ptrs[24]));
    w.agg_out = static_cast<float*>(const_cast<void*>(ptrs[26]));
    w.n = n;
    w.k = k;
    w.nf = latent;
    w.F = (latent + 63) / 64 * 64;
    w.r_e = plan[0];
    w.r_n = plan[1];
    w.p_e = plan[2];
    w.p_n = plan[3];
    void* const* buf = const_cast<void* const*>(ptrs + 28);
    w.r1 = buf[0];
    w.x1 = static_cast<float*>(buf[1]);
    w.aggc = buf[2];
    w.r2 = buf[3];
    w.y1 = static_cast<float*>(buf[4]);
    w.dy1c = buf[5];
    w.dnf = static_cast<float*>(buf[6]);
    w.dnfc = buf[7];
    w.dagg = static_cast<float*>(buf[8]);
    w.dx1c = buf[9];
    w.part = static_cast<float*>(buf[10]);
    const bool wgmma = is_bf16 && w.F <= kWgmmaMax;
    for (int i = 0; i < (wgmma ? 11 : 10); ++i)  // the wgmma design keeps x1 on chip
      if (buf[i] == nullptr && !(wgmma && i == 1)) return (int)cudaErrorInvalidValue;
    if (wgmma) return wgmma_backward(w, buf[11], buf[12], stream);
    return is_bf16 ? wide_backward<bf16>(w, stream) : wide_backward<float>(w, stream);
  }
  const bool tile = !is_bf16;
  if (n < 1 || k < 1 || grid < 1 || (tile && grid > lbt::ceil_div(n, TR)))
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
  a.agg = static_cast<float*>(const_cast<void*>(ptrs[26]));
  a.dagg = nullptr;
  a.ops = const_cast<void*>(ptrs[27]);
  a.n = n;
  a.k = k;
  a.nf = latent;
  return latent_dispatch(latent, [&](auto width) {
    constexpr int F = decltype(width)::value;
    if (!is_bf16) return launch<float, F>(a, grid, stream);
    Args b = a;
    b.agg = static_cast<float*>(const_cast<void*>(ptrs[25]));
    b.dagg = b.agg + (int64_t)n * F;
    if constexpr (F > 128) return run_stream<F>(b, plan, stream);
    else return run_bf16<F>(b, grid, stream);
  });
}

// grads (5 F^2 + 8 F, the order of Args::w then Args::vec) from the
// partials of lbt_fused_mp_bwd, each summed over its blocks in block order
LBT_EXPORT int lbt_fused_mp_bwd_reduce(const float* partials, float* out, int n, int latent,
                                       int is_bf16, int grid, const int* plan,
                                       cudaStream_t stream) {
  if (latent > kMaxLatent) {  // the wide path's partials
    if (plan == nullptr) return (int)cudaErrorInvalidValue;
    return wide_reduce(partials, out, (latent + 63) / 64 * 64, plan, stream);
  }
  if (n < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  return latent_dispatch(latent, [&](auto width) {
    constexpr int F = decltype(width)::value;
    Segs segs{};
    if (!is_bf16) {
      segs.s[0] = Seg{partials, grid, GRADS<F>, GRADS<F>, 0};
      segs.count = 1;
    } else if (F > 128) {
      if (plan == nullptr) return (int)cudaErrorInvalidValue;
      float *p_tn, *p_edge, *p_node;
      stream_partials<F>(const_cast<float*>(partials), plan, &p_tn, &p_edge, &p_node);
      int before = 0;
      for (int q = 0; q < 5; ++q) {  // G_WE .. G_WN2
        const int ranges = q < 2 ? plan[2] : plan[3];
        segs.s[q] = Seg{p_tn + (int64_t)before * F * F, ranges, F * F, F * F, q * F * F};
        before += ranges;
      }
      segs.s[5] = Seg{p_edge, plan[0], 4 * F, 4 * F, 5 * F * F + V_B1 * F};
      segs.s[6] = Seg{p_node, plan[1], 4 * F, 4 * F, 5 * F * F + V_BN1 * F};
      segs.count = 7;
    } else {
      float *p_node, *p_ea, *p_eb;
      bf16_partials<F>(const_cast<float*>(partials), grid, n, &p_node, &p_ea, &p_eb);
      const int nb = node_blocks(n);
      segs.s[0] = Seg{p_eb, grid, P_EB<F>, F * F, G_WE * F * F};
      segs.s[1] = Seg{p_ea, grid, P_EA<F>, F * F, G_W2 * F * F};
      segs.s[2] = Seg{p_node, nb, P_NODE<F>, 3 * F * F, G_WNH * F * F};
      segs.s[3] = Seg{p_ea + F * F, grid, P_EA<F>, 4 * F, 5 * F * F + V_B1 * F};
      segs.s[4] = Seg{p_node + 3 * F * F, nb, P_NODE<F>, 4 * F, 5 * F * F + V_BN1 * F};
      segs.count = 5;
    }
    fused_mp_bwd_reduce<<<lbt::ceil_div(GRADS<F>, 256), 256, 0, stream>>>(segs, out);
    return (int)cudaGetLastError();
  });
}
