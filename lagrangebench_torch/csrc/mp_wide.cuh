// The wide path: K3/K8/E2 (forward, fused_mp.cu) and K4 (backward,
// fused_mp_bwd.cu) at latent widths nf above 256, where no instance of
// the warp, stream or tile designs fits a block (mp_stream.cuh keeps a 16-row
// slice's float32 accumulator for the whole width in registers, F / 2 per
// lane, and sits at 255 registers at F = 256; the float32 tile design's
// shared memory reaches 211 KB at F = 256).
//
// One code path serves every wide width, with no instance per width: the
// kernels are templated on a column-chunk width (the 128-column output tile
// of a product, the 64-column pair chunk of a row) and the chunk count F / 64
// is a runtime argument. Tensors and weights arrive zero-padded to F = 64
// ceil(nf / 64), as for the narrow instances (ops/fused_mp.py kernel_width),
// and every LayerNorm and its backward run over the first nf channels.
//
// bf16 at F <= 512 takes the wgmma design for the edge side of a step
// (mp_wgmma.cuh: one kernel per step, T(relu(first)) and the pre-LayerNorm x1
// kept on chip) and of K4's backward (mp_wgmma_bwd.cuh: one edge kernel and
// a wgmma product kernel for dW_e and dW2); the node side, float32 at every
// width and bf16 above 512 run the launches below.
//
// Design (the simpler of the two the port planned; see PERF.md): each
// product of the step is one hand-written GEMM launch, C = A @ B summed in
// float32, whose epilogue applies what follows the product in the TPU kernel
// (bias, sender and receiver terms, ReLU and the cast to the compute type,
// a ReLU mask, a residual) and writes a pre-LayerNorm or compute-type row to
// device memory; a LayerNorm / residual / K-sum kernel then reads those rows
// one warp per row or receiver. The TPU kernel's casts are kept: relu(first),
// T(agg), relu(node_first) and the backward's dy1, dnf, dx1 and dfirst are
// rounded to the compute type T before their products.
//   bf16 GEMM: 128 x 128 output tiles, 8 warps of 64 x 32, mma.sync m16n8k16
//     (bf16 in, float32 out) on ldmatrix fragments (.trans where an operand
//     lies transposed in memory), a 3-stage cp.async ring of 32-deep k-slabs
//     of A and B (padded rows: conflict-free ldmatrix), zero-filled past the
//     ragged row edge. Shared memory: 3 x (128 x 40 + 128 x 40) x 2 B = 60
//     KB at most (the A @ W^T layout), whatever F is.
//   float32 GEMM: 64 x 64 tiles, 256 threads of 4 x 4 outputs, CUDA-core
//     FMAs (no TF32: the JAX mirrors run at precision "highest"), 8.5 KB of
//     shared memory.
//   Row kernels: a warp owns a row (a receiver's K rows for the edge ones),
//     lane l holding channel pairs 2 (l + 32 j), j < F / 64, float32 in
//     registers (V = 16 values per lane up to F = 512, 32 up to 1024; past
//     1,024 a warp walks its row in 1,024-column chunks); row
//     statistics by warp shuffles in a fixed order.
// The backward's weight gradients are TN GEMMs (A^T B over rows) whose rows
// split into `ranges` runs of whole 32-row chunks (a fixed partition, the
// stream design's tn_rows rule), each run writing its own float32 F x F
// partial; its eight vector gradients are summed per warp of the row kernels
// (a fixed grid, fixed receivers per warp) into per-warp partials. The
// reduce sums both in order: no atomics, so two launches give the same bits.
//
// Bound on an H100: operations at these widths (K3's 2 x 2 F^2 FLOP per edge
// row against ~8 F bytes of e, hs and e' in bf16: 128 FLOP/B at F = 512,
// under the card's ~295 only because the bytes are counted once; the
// intermediates this design writes (T(relu(first)) and the pre-LayerNorm
// x1 in float32, 6 F bytes per edge row each way) make it bytes-heavy in
// practice). A fused design that keeps them on chip is ROADMAP work.
#pragma once

#include "mp_warp.cuh"
#include "mp_wgmma.cuh"

namespace {

constexpr int WBM = 128, WBN = 128, WBK = 32, WSTAGES = 3, WTHREADS = 256;
constexpr int WIDE_TN_CHUNK = 32;  // rows per chunk of a weight gradient's row ranges
constexpr int WROW_WARPS = 8;      // warps per block of the row kernels

// the bf16 GEMM's shared memory: a ring of WSTAGES slabs, each an A and a B
// tile in the layout the operand has in device memory, rows padded by 8
template <bool AT, bool BT>
struct WideSmem {
  static constexpr int A_ELEMS = AT ? WBK * (WBM + 8) : WBM * (WBK + 8);
  static constexpr int B_ELEMS = BT ? WBN * (WBK + 8) : WBK * (WBN + 8);
  static constexpr int STAGE_BYTES = (A_ELEMS + B_ELEMS) * 2;
  static constexpr int kBytes = WSTAGES * STAGE_BYTES;
  static_assert(kBytes <= kSmemMax, "the ring fits a block");
};

enum WideEpi : int {
  kStoreF32 = 0,  // out (float) = acc + bias
  kFirst,         // out (T) = T(relu(acc + hs + hr[m / k] + bias))
  kReluBias,      // out (T) = T(relu(acc + bias))
  kReluMask,      // out (float) = ref (T) > 0 ? acc : 0
  kAdd,           // out (T) = T(acc + ref (T))
};

struct GemmEpi {
  int mode;
  const float* bias;    // (N) or null
  const void* hs;       // kFirst: (M, N) gathered, or hs_ext rows through srow
  const int32_t* srow;  // kFirst: the sender row of each edge row (-1: padded), or null
  const void* hr;       // kFirst: (M / k, N)
  int k;                // kFirst: edge rows per receiver
  const void* ref;      // kReluMask, kAdd: (M, N) T
  void* out;            // (M, N) T or float32; kStoreF32 with ranges: (ranges, M, N)
};

// C (M x N) = sum over the pairs p of A_p @ B_p, each over kspan (rows
// [lo, hi) of range blockIdx.z when ranges > 1). A: (M, kspan) row-major, or
// (kspan, M) with AT; B: (kspan, N) row-major, or (N, kspan) with BT. Row
// strides lda, ldb. N and, without ranges, kspan are multiples of 8 (F).
struct GemmArgs {
  const void* a[2];
  const void* b[2];
  int pairs;
  int64_t M;
  int N;
  int64_t kspan;
  int lda, ldb;
  int ranges;
  GemmEpi epi;
};

template <typename T>
__device__ __forceinline__ float2 ld2(const T* p);
template <>
__device__ __forceinline__ float2 ld2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 ld2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the epilogue of output pair (m, n), (m, n + 1)
template <typename T>
__device__ __forceinline__ void epi_pair(const GemmEpi& e, int N, int64_t m, int n, float v0,
                                         float v1) {
  const int64_t at = m * N + n;
  if (e.bias != nullptr && e.mode != kFirst) {
    v0 += e.bias[n];
    v1 += e.bias[n + 1];
  }
  switch (e.mode) {
    case kStoreF32:
      st2(static_cast<float*>(e.out) + at, v0, v1);
      break;
    case kFirst: {
      const T* hs = static_cast<const T*>(e.hs);
      float2 s = make_float2(0.f, 0.f);
      if (e.srow == nullptr) {
        s = ld2(hs + at);
      } else {
        const int r = e.srow[m];
        if (r >= 0) s = ld2(hs + (int64_t)r * N + n);
      }
      // acc + hs + hr + b1 in the plain version's order (a ReLU input near 0
      // takes the same float32 roundings)
      const float2 h = ld2(static_cast<const T*>(e.hr) + (m / e.k) * N + n);
      st2(static_cast<T*>(e.out) + at, fmaxf(v0 + s.x + h.x + e.bias[n], 0.f),
          fmaxf(v1 + s.y + h.y + e.bias[n + 1], 0.f));
      break;
    }
    case kReluBias:
      st2(static_cast<T*>(e.out) + at, fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      break;
    case kReluMask: {
      const float2 r = ld2(static_cast<const T*>(e.ref) + at);
      st2(static_cast<float*>(e.out) + at, r.x > 0.f ? v0 : 0.f, r.y > 0.f ? v1 : 0.f);
      break;
    }
    default: {  // kAdd
      const float2 r = ld2(static_cast<const T*>(e.ref) + at);
      st2(static_cast<T*>(e.out) + at, v0 + r.x, v1 + r.y);
      break;
    }
  }
}

// rows [lo, hi) of range z (the fixed partition of whole 32-row chunks)
__device__ __forceinline__ void range_rows(int64_t rows, int ranges, int z, int64_t& lo,
                                           int64_t& hi) {
  if (ranges <= 1) {
    lo = 0;
    hi = rows;
    return;
  }
  const int64_t chunks = (rows + WIDE_TN_CHUNK - 1) / WIDE_TN_CHUNK;
  lo = chunks * z / ranges * WIDE_TN_CHUNK;
  hi = min(chunks * (z + 1) / ranges * WIDE_TN_CHUNK, rows);
}

template <bool AT, bool BT>
__global__ void __launch_bounds__(WTHREADS) fused_mp_wide_gemm(const GemmArgs g) {
  using L = WideSmem<AT, BT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int64_t m0 = (int64_t)blockIdx.x * WBM;
  const int n0 = blockIdx.y * WBN;
  int64_t klo, khi;
  range_rows(g.kspan, g.ranges, blockIdx.z, klo, khi);
  const int per = (int)((khi - klo + WBK - 1) / WBK);
  const int total = per * g.pairs;

  auto load = [&](int t, int stage) {
    const int p = t / per;
    const int64_t kb = klo + (int64_t)(t % per) * WBK;
    const bf16* A = static_cast<const bf16*>(g.a[p]);
    const bf16* B = static_cast<const bf16*>(g.b[p]);
    bf16* As = reinterpret_cast<bf16*>(smem + stage * L::STAGE_BYTES);
    bf16* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int it = 0; it < 2; ++it) {  // 512 chunks of 16 bytes per operand
      const int i = tid + it * WTHREADS;
      if constexpr (!AT) {
        const int r = i >> 2, c = (i & 3) * 8;
        const int64_t m = m0 + r, k = kb + c;
        const bool ok = m < g.M && k < khi;
        cp_async16(smem_addr(As + r * (WBK + 8) + c), ok ? A + m * g.lda + k : A, ok);
      } else {
        const int r = i >> 4, c = (i & 15) * 8;
        const int64_t k = kb + r, m = m0 + c;
        const bool ok = k < khi && m < g.M;
        cp_async16(smem_addr(As + r * (WBM + 8) + c), ok ? A + k * g.lda + m : A, ok);
      }
      if constexpr (!BT) {
        const int r = i >> 4, c = (i & 15) * 8;
        const int64_t k = kb + r;
        const int n = n0 + c;
        const bool ok = k < khi && n < g.N;
        cp_async16(smem_addr(Bs + r * (WBN + 8) + c), ok ? B + k * g.ldb + n : B, ok);
      } else {
        const int r = i >> 2, c = (i & 3) * 8;
        const int n = n0 + r;
        const int64_t k = kb + c;
        const bool ok = n < g.N && k < khi;
        cp_async16(smem_addr(Bs + r * (WBK + 8) + c), ok ? B + (int64_t)n * g.ldb + k : B, ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int s = 0; s < WSTAGES - 1; ++s) {
    if (s < total) load(s, s);
    cp_commit();
  }
  // with AT (a weight gradient, summing thousands of rows) each 32-row
  // slab's products accumulate in `part`, which is then added to `acc` in
  // float32: the tensor cores' own float32 sums over tens of thousands of
  // rows drifted ~1e-4 from float64 (K4's bf16 gradients at F = 768)
  float part[4][4][4];
  const int q8 = lane >> 3, r8 = lane & 7;
  for (int t = 0; t < total; ++t) {
    if constexpr (AT) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
    }
    cp_wait<WSTAGES - 2>();
    __syncthreads();
    if (t + WSTAGES - 1 < total) load(t + WSTAGES - 1, (t + WSTAGES - 1) % WSTAGES);
    cp_commit();
    const bf16* As = reinterpret_cast<const bf16*>(smem + (t % WSTAGES) * L::STAGE_BYTES);
    const bf16* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      u32 af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if constexpr (!AT) {
          const int row = wm * 64 + mi * 16 + (lane & 15), col = kk + (lane >> 4) * 8;
          ldsm(af[mi], smem_addr(As + row * (WBK + 8) + col));
        } else {
          const int k = kk + r8 + (q8 >> 1) * 8, m = wm * 64 + mi * 16 + (q8 & 1) * 8;
          ldsm_t(af[mi], smem_addr(As + k * (WBM + 8) + m));
        }
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        u32 t4[4];
        if constexpr (!BT) {
          const int k = kk + r8 + (q8 & 1) * 8, n = wn * 32 + nj * 16 + (q8 >> 1) * 8;
          ldsm_t(t4, smem_addr(Bs + k * (WBN + 8) + n));
        } else {
          const int n = wn * 32 + nj * 16 + r8 + (q8 >> 1) * 8, k = kk + (q8 & 1) * 8;
          ldsm(t4, smem_addr(Bs + n * (WBK + 8) + k));
        }
        bfr[2 * nj][0] = t4[0];
        bfr[2 * nj][1] = t4[1];
        bfr[2 * nj + 1][0] = t4[2];
        bfr[2 * nj + 1][1] = t4[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if constexpr (AT)
            mma(part[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
          else
            mma(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
        }
    }
    if constexpr (AT) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
    }
  }
  cp_wait<0>();

  GemmEpi e = g.epi;
  if (g.ranges > 1) e.out = static_cast<float*>(e.out) + blockIdx.z * g.M * g.N;
  const int gr = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int64_t m = m0 + wm * 64 + mi * 16 + gr;
      const int n = n0 + wn * 32 + ni * 8 + t2;
      if (n < g.N) {
        if (m < g.M) epi_pair<bf16>(e, g.N, m, n, acc[mi][ni][0], acc[mi][ni][1]);
        if (m + 8 < g.M) epi_pair<bf16>(e, g.N, m + 8, n, acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
}

// float32 sums on the CUDA cores, of float32 or (TI = bf16) bf16 operands:
// 64 x 64 tiles, 16-deep k-slabs, thread (ty, tx) owning rows 4 ty
// .. 4 ty + 3 and columns 4 tx .. 4 tx + 3. float32 operands: the sum over
// k in order (a running sum; with each slab summed apart and then added,
// the float32 GPU tests' K4 at F = 257 and 320 met relu ties the plain
// version, on cuBLAS, decided otherwise). bf16 operands (K4's node_first,
// whose ReLU the checks hold to float64 sums): each slab summed apart, then
// added, the rounding growing with ~sqrt(16) + sqrt(k / 16) steps, not
// sqrt(k) (a running sum over 2F = 1,536 products flipped enough ReLUs at F
// = 768 to move dW_nh 1.06e-4 from the float64 sums)
template <typename TI, bool AT, bool BT>
__global__ void __launch_bounds__(WTHREADS) fused_mp_wide_gemm_f32(const GemmArgs g) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  int64_t klo, khi;
  range_rows(g.kspan, g.ranges, blockIdx.z, klo, khi);
  const int per = (int)((khi - klo + BK - 1) / BK);
  const int total = per * g.pairs;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t = 0; t < total; ++t) {
    const int p = t / per;
    const int64_t kb = klo + (int64_t)(t % per) * BK;
    const TI* A = static_cast<const TI*>(g.a[p]);
    const TI* B = static_cast<const TI*>(g.b[p]);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + it * WTHREADS;
      if constexpr (!AT) {
        const int r = i >> 4, c = i & 15;
        const int64_t m = m0 + r, k = kb + c;
        As[c][r] = m < g.M && k < khi ? to_f(A[m * g.lda + k]) : 0.f;
      } else {
        const int r = i >> 6, c = i & 63;
        const int64_t k = kb + r, m = m0 + c;
        As[r][c] = m < g.M && k < khi ? to_f(A[k * g.lda + m]) : 0.f;
      }
      if constexpr (!BT) {
        const int r = i >> 6, c = i & 63;
        const int64_t k = kb + r;
        const int n = n0 + c;
        Bs[r][c] = n < g.N && k < khi ? to_f(B[k * g.ldb + n]) : 0.f;
      } else {
        const int r = i >> 4, c = i & 15;
        const int n = n0 + r;
        const int64_t k = kb + c;
        Bs[c][r] = n < g.N && k < khi ? to_f(B[(int64_t)n * g.ldb + k]) : 0.f;
      }
    }
    __syncthreads();
    constexpr bool SLABS = std::is_same<TI, bf16>::value;
    float part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (SLABS)
            part[i][j] = fmaf(av[i], bv[j], part[i][j]);
          else
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
    if constexpr (SLABS) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    }
    __syncthreads();
  }
  GemmEpi e = g.epi;
  if (g.ranges > 1) e.out = static_cast<float*>(e.out) + blockIdx.z * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int n = n0 + tx * 4 + j;
      if (m < g.M && n < g.N) epi_pair<TI>(e, g.N, m, n, acc[i][j], acc[i][j + 1]);
    }
  }
}

// one product launch; bf16 on the tensor cores, float32 on the CUDA cores
template <typename T, bool AT, bool BT>
int wide_gemm(const GemmArgs& g, cudaStream_t stream) {
  if (g.M < 1 || g.N < 1 || g.ranges < 1) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid((unsigned)((g.M + WBM - 1) / WBM), (g.N + WBN - 1) / WBN, g.ranges);
    constexpr int smem = WideSmem<AT, BT>::kBytes;
    cudaError_t err = cudaFuncSetAttribute(fused_mp_wide_gemm<AT, BT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_mp_wide_gemm<AT, BT><<<grid, WTHREADS, smem, stream>>>(g);
  } else {
    const dim3 grid((unsigned)((g.M + 63) / 64), (g.N + 63) / 64, g.ranges);
    fused_mp_wide_gemm_f32<T, AT, BT><<<grid, WTHREADS, 0, stream>>>(g);
  }
  return (int)cudaGetLastError();
}

GemmArgs gemm_args(const void* a, const void* b, int64_t M, int N, int64_t kspan, int lda,
                   int ldb, GemmEpi epi) {
  GemmArgs g;
  g.a[0] = g.a[1] = a;
  g.b[0] = g.b[1] = b;
  g.pairs = 1;
  g.M = M;
  g.N = N;
  g.kspan = kspan;
  g.lda = lda;
  g.ldb = ldb;
  g.ranges = 1;
  g.epi = epi;
  return g;
}

GemmEpi epi_of(int mode, void* out, const float* bias = nullptr, const void* ref = nullptr) {
  GemmEpi e;
  e.mode = mode;
  e.bias = bias;
  e.hs = nullptr;
  e.srow = nullptr;
  e.hr = nullptr;
  e.k = 1;
  e.ref = ref;
  e.out = out;
  return e;
}

// ---- row kernels: a warp per row (or receiver), lane pairs 2 (lane + 32 j)

// row `row` of a (rows, F) tensor into x (V values per lane, zero past F)
template <int V, typename T>
__device__ __forceinline__ void load_row(float (&x)[V], const T* src, int64_t row, int F,
                                         int lane) {
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const int c = 2 * (lane + 32 * j);
    float2 v = make_float2(0.f, 0.f);
    if (c < F) v = ld2(src + row * F + c);
    x[2 * j] = v.x;
    x[2 * j + 1] = v.y;
  }
}
template <int V, typename T>
__device__ __forceinline__ void store_row(T* dst, const float (&x)[V], int64_t row, int F,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    const int c = 2 * (lane + 32 * j);
    if (c < F) st2(dst + row * F + c, x[2 * j], x[2 * j + 1]);
  }
}
template <int V>
__device__ __forceinline__ int chan(int lane, int i) {
  return 2 * (lane + 32 * (i / 2)) + (i & 1);
}

// xhat over the first nf channels (0 past nf) and the inverse deviation
template <int V>
__device__ __forceinline__ float wide_normalize(float (&x)[V], int lane, int nf) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) s += chan<V>(lane, i) < nf ? x[i] : 0.f;
  const float mean = lbt::warp_sum(s) / nf;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float d = chan<V>(lane, i) < nf ? x[i] - mean : 0.f;
    v += d * d;
  }
  const float inv = rsqrtf(lbt::warp_sum(v) / nf + kEps);
#pragma unroll
  for (int i = 0; i < V; ++i) x[i] = chan<V>(lane, i) < nf ? (x[i] - mean) * inv : 0.f;
  return inv;
}

// LayerNorm's input gradient from dy and xhat (in place in dy), over nf
template <int V>
__device__ __forceinline__ void wide_ln_bwd(float (&dy)[V], const float (&xhat)[V], float inv,
                                            const float* scale, int lane, int nf) {
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = chan<V>(lane, i);
    dy[i] = c < nf ? dy[i] * scale[c] : 0.f;
    s1 += dy[i];
    s2 += dy[i] * xhat[i];
  }
  const float m1 = lbt::warp_sum(s1) / nf, m2 = lbt::warp_sum(s2) / nf;
#pragma unroll
  for (int i = 0; i < V; ++i)
    dy[i] = chan<V>(lane, i) < nf ? inv * (dy[i] - m1 - xhat[i] * m2) : 0.f;
}

struct RowArgs {
  const float* x;       // (rows, F) pre-LayerNorm rows
  const void* res;      // (rows, F) T residual, or null
  const void* res_e;    // edge kernels: e (rows, F) T
  const float* scale;   // LayerNorm
  const float* bias;
  void* out;            // (rows, F) T
  const float* mask;    // (rows) or null (then srow)
  const int32_t* srow;  // (rows): mask = srow >= 0
  void* aggc;           // (n, F) T
  float* agg;           // (n, F) float32, or null
  const void* g;        // backward: gh or ge (rows, F) T
  const float* dagg;    // backward: (n, F)
  float* partials;      // backward: (warps, 4, F)
  int slot;             // backward post: the vector slot
  void* rowsum;         // backward post: (n, F) T sum over K, or null
  int64_t n;            // rows (receivers for the edge kernels)
  int k, F, nf;
};

// out = T(res + LN(x)) (res optional): the encoder's LayerNorm, h'
template <int V, typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_wide_ln(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  for (int64_t row = gw; row < a.n; row += nw) {
    float x[V];
    load_row(x, a.x, row, a.F, lane);
    wide_normalize(x, lane, a.nf);
    float r[V];
    if (a.res != nullptr) load_row(r, static_cast<const T*>(a.res), row, a.F, lane);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = chan<V>(lane, i);
      x[i] = c < a.F ? x[i] * a.scale[c] + a.bias[c] + (a.res != nullptr ? r[i] : 0.f) : 0.f;
    }
    store_row(static_cast<T*>(a.out), x, row, a.F, lane);
  }
}

// per receiver: msg = LN1(x1) of its K rows, e' = T(e + msg) (with out),
// agg = sum_K msg * mask in row order -> T(agg) (and agg in float32)
template <int V, typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_wide_edge_ln(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  for (int64_t n = gw; n < a.n; n += nw) {
    float agg[V];
#pragma unroll
    for (int i = 0; i < V; ++i) agg[i] = 0.f;
    for (int kk = 0; kk < a.k; ++kk) {
      const int64_t row = n * a.k + kk;
      float x[V];
      load_row(x, a.x, row, a.F, lane);
      wide_normalize(x, lane, a.nf);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int c = chan<V>(lane, i);
        x[i] = c < a.F ? x[i] * a.scale[c] + a.bias[c] : 0.f;
      }
      const float m = a.mask != nullptr ? a.mask[row] : (a.srow[row] >= 0 ? 1.f : 0.f);
#pragma unroll
      for (int i = 0; i < V; ++i) agg[i] += x[i] * m;
      if (a.out != nullptr) {
        float e[V];
        load_row(e, static_cast<const T*>(a.res_e), row, a.F, lane);
#pragma unroll
        for (int i = 0; i < V; ++i) e[i] += x[i];
        store_row(static_cast<T*>(a.out), e, row, a.F, lane);
      }
    }
    store_row(static_cast<T*>(a.aggc), agg, n, a.F, lane);
    if (a.agg != nullptr) store_row(a.agg, agg, n, a.F, lane);
  }
}

// the warp's vector partials (V values per lane of `count` vectors from
// slot `first` on) into partials[warp][slot][F]
template <int V, int NV>
__device__ __forceinline__ void store_partials(float* partials, const float (&p)[NV][V],
                                               int64_t gw, int first, int F, int lane) {
#pragma unroll
  for (int q = 0; q < NV; ++q) store_row(partials + (gw * 4 + first + q) * F, p[q], 0, F, lane);
}

// K4, node side: dy1 = LN2 backward of gh -> T(dy1); partials bn2 (slot 1),
// ln2_scale (2), ln2_bias (3). x = y1, g = gh.
template <int V, typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_bwd_wide_node(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  float p[3][V];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) p[q][i] = 0.f;
  for (int64_t row = gw; row < a.n; row += nw) {
    float xh[V], dy[V];
    load_row(xh, a.x, row, a.F, lane);
    const float inv = wide_normalize(xh, lane, a.nf);
    load_row(dy, static_cast<const T*>(a.g), row, a.F, lane);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      p[1][i] += dy[i] * xh[i];
      p[2][i] += dy[i];
    }
    wide_ln_bwd(dy, xh, inv, a.scale, lane, a.nf);
#pragma unroll
    for (int i = 0; i < V; ++i) p[0][i] += dy[i];
    store_row(static_cast<T*>(a.out), dy, row, a.F, lane);
  }
  store_partials(a.partials, p, gw, 1, a.F, lane);
}

// K4, edge side: dm = ge + dagg * mask, dx1 = LN1 backward of dm -> T(dx1);
// partials b2 (slot 1), ln1_scale (2), ln1_bias (3). x = x1, g = ge.
template <int V, typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_bwd_wide_edge(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  float p[3][V];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < V; ++i) p[q][i] = 0.f;
  for (int64_t n = gw; n < a.n; n += nw) {
    for (int kk = 0; kk < a.k; ++kk) {
      const int64_t row = n * a.k + kk;
      float xh[V], dm[V];
      load_row(xh, a.x, row, a.F, lane);
      const float inv = wide_normalize(xh, lane, a.nf);
      load_row(dm, static_cast<const T*>(a.g), row, a.F, lane);
      const float m = a.mask[row];
#pragma unroll
      for (int j = 0; j < V / 2; ++j) {
        const int c = 2 * (lane + 32 * j);
        if (c < a.F) {
          const float2 d = *reinterpret_cast<const float2*>(a.dagg + n * a.F + c);
          dm[2 * j] += d.x * m;
          dm[2 * j + 1] += d.y * m;
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        p[1][i] += dm[i] * xh[i];
        p[2][i] += dm[i];
      }
      wide_ln_bwd(dm, xh, inv, a.scale, lane, a.nf);
#pragma unroll
      for (int i = 0; i < V; ++i) p[0][i] += dm[i];
      store_row(static_cast<T*>(a.out), dm, row, a.F, lane);
    }
  }
  store_partials(a.partials, p, gw, 1, a.F, lane);
}

// K4: a float32 gradient (dnf or dfirst) -> T, its column sums into the
// vector partial `slot` (bn1 or b1), and with rowsum its sum over each
// receiver's K rows (dhr) -> T
template <int V, typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_bwd_wide_post(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  float p[1][V];
#pragma unroll
  for (int i = 0; i < V; ++i) p[0][i] = 0.f;
  for (int64_t n = gw; n < a.n; n += nw) {
    float s[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = 0.f;
    for (int kk = 0; kk < a.k; ++kk) {
      const int64_t row = n * a.k + kk;
      float x[V];
      load_row(x, a.x, row, a.F, lane);
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] += x[i];
      store_row(static_cast<T*>(a.out), x, row, a.F, lane);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) p[0][i] += s[i];
    if (a.rowsum != nullptr) store_row(static_cast<T*>(a.rowsum), s, n, a.F, lane);
  }
  store_partials(a.partials, p, gw, a.slot, a.F, lane);
}

// ---- any width (F > 1,024): a warp walks its row in chunks of WCHUNK
// columns (VC values per lane, the V = 32 layout), a row's statistics (and
// LayerNorm's backward sums) gathered by passes over the whole row first,
// read again from device memory (L1/L2) for every chunk; each chunk keeps
// its own float32 sums (agg, the vector partials) in registers
constexpr int VC = 32, WCHUNK = 32 * VC;

// mean and inverse deviation of float32 row `row` over its first nf channels
__device__ __forceinline__ float2 row_moments_any(const float* x, int64_t row, int F, int nf,
                                                  int lane) {
  const float* r = x + row * F;
  float s = 0.f;
  for (int c = 2 * lane; c < nf; c += 64) {
    const float2 v = ld2(r + c);
    s += v.x + (c + 1 < nf ? v.y : 0.f);
  }
  const float mean = lbt::warp_sum(s) / nf;
  float q = 0.f;
  for (int c = 2 * lane; c < nf; c += 64) {
    const float2 v = ld2(r + c);
    const float d0 = v.x - mean, d1 = c + 1 < nf ? v.y - mean : 0.f;
    q += d0 * d0 + d1 * d1;
  }
  return make_float2(mean, rsqrtf(lbt::warp_sum(q) / nf + kEps));
}

// LayerNorm backward's row means (m1, m2) of dxhat = dy scale and dxhat xhat,
// dy = g (+ dagg * m with dagg): over the whole row
template <typename T>
__device__ __forceinline__ float2 ln_bwd_means_any(const float* x, const T* g, const float* dagg,
                                                   float m, const float* scale, int64_t row,
                                                   float2 st, int F, int nf, int lane) {
  float s1 = 0.f, s2 = 0.f;
  for (int c = 2 * lane; c < nf; c += 64) {
    const float2 v = ld2(x + row * F + c);
    float2 d = ld2(g + row * F + c);
    if (dagg != nullptr) {
      const float2 a = ld2(dagg + c);
      d.x += a.x * m;
      d.y += a.y * m;
    }
    const float h0 = d.x * scale[c], x0 = (v.x - st.x) * st.y;
    s1 += h0;
    s2 += h0 * x0;
    if (c + 1 < nf) {
      const float h1 = d.y * scale[c + 1], x1 = (v.y - st.x) * st.y;
      s1 += h1;
      s2 += h1 * x1;
    }
  }
  return make_float2(lbt::warp_sum(s1) / nf, lbt::warp_sum(s2) / nf);
}

// out = T(res + LN(x)) (res optional), any width
template <typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_wide_ln_any(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  for (int64_t row = gw; row < a.n; row += nw) {
    const float2 st = row_moments_any(a.x, row, a.F, a.nf, lane);
    for (int c = 2 * lane; c < a.F; c += 64) {
      const float2 v = ld2(a.x + row * a.F + c);
      float y0 = c < a.nf ? (v.x - st.x) * st.y : 0.f;
      float y1 = c + 1 < a.nf ? (v.y - st.x) * st.y : 0.f;
      y0 = y0 * a.scale[c] + a.bias[c];
      y1 = y1 * a.scale[c + 1] + a.bias[c + 1];
      if (a.res != nullptr) {
        const float2 r = ld2(static_cast<const T*>(a.res) + row * a.F + c);
        y0 += r.x;
        y1 += r.y;
      }
      st2(static_cast<T*>(a.out) + row * a.F + c, y0, y1);
    }
  }
}

// fused_mp_wide_edge_ln at any width: per receiver and chunk, each of its
// K rows' statistics, then the chunk's msg, e' and agg
template <typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_wide_edge_ln_any(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  for (int64_t n = gw; n < a.n; n += nw) {
    for (int c0 = 0; c0 < a.F; c0 += WCHUNK) {
      float agg[VC];
#pragma unroll
      for (int i = 0; i < VC; ++i) agg[i] = 0.f;
      for (int kk = 0; kk < a.k; ++kk) {
        const int64_t row = n * a.k + kk;
        const float2 st = row_moments_any(a.x, row, a.F, a.nf, lane);
        const float m = a.mask != nullptr ? a.mask[row] : (a.srow[row] >= 0 ? 1.f : 0.f);
#pragma unroll
        for (int j = 0; j < VC / 2; ++j) {
          const int c = c0 + 2 * (lane + 32 * j);
          if (c < a.F) {
            const float2 v = ld2(a.x + row * a.F + c);
            const float y0 = (c < a.nf ? (v.x - st.x) * st.y : 0.f) * a.scale[c] + a.bias[c];
            const float y1 =
                (c + 1 < a.nf ? (v.y - st.x) * st.y : 0.f) * a.scale[c + 1] + a.bias[c + 1];
            agg[2 * j] += y0 * m;
            agg[2 * j + 1] += y1 * m;
            if (a.out != nullptr) {
              const float2 e = ld2(static_cast<const T*>(a.res_e) + row * a.F + c);
              st2(static_cast<T*>(a.out) + row * a.F + c, e.x + y0, e.y + y1);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VC / 2; ++j) {
        const int c = c0 + 2 * (lane + 32 * j);
        if (c < a.F) {
          st2(static_cast<T*>(a.aggc) + n * a.F + c, agg[2 * j], agg[2 * j + 1]);
          if (a.agg != nullptr) st2(a.agg + n * a.F + c, agg[2 * j], agg[2 * j + 1]);
        }
      }
    }
  }
}

// K4's LayerNorm backward rows at any width (as fused_mp_bwd_wide_node, or
// with EDGE fused_mp_bwd_wide_edge, dm = ge + dagg * mask): per chunk, each
// row's statistics and backward means, then the chunk's T(dx) and its
// partials
template <typename T, bool EDGE>
__device__ __forceinline__ void bwd_ln_rows_any(const RowArgs& a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  const T* g = static_cast<const T*>(a.g);
  for (int c0 = 0; c0 < a.F; c0 += WCHUNK) {
    float p[3][VC];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < VC; ++i) p[q][i] = 0.f;
    for (int64_t n = gw; n < a.n; n += nw) {  // receivers (EDGE) or rows
      for (int kk = 0; kk < (EDGE ? a.k : 1); ++kk) {
        const int64_t row = EDGE ? n * a.k + kk : n;
        const float* dg = EDGE ? a.dagg + n * a.F : nullptr;
        const float m = EDGE ? a.mask[row] : 0.f;
        const float2 st = row_moments_any(a.x, row, a.F, a.nf, lane);
        const float2 mm = ln_bwd_means_any(a.x, g, dg, m, a.scale, row, st, a.F, a.nf, lane);
#pragma unroll
        for (int j = 0; j < VC / 2; ++j) {
          const int c = c0 + 2 * (lane + 32 * j);
          if (c < a.F) {
            const float2 v = ld2(a.x + row * a.F + c);
            float2 d = ld2(g + row * a.F + c);
            if (EDGE) {
              const float2 ad = ld2(dg + c);
              d.x += ad.x * m;
              d.y += ad.y * m;
            }
            const float dd[2] = {d.x, d.y}, vv[2] = {v.x, v.y};
            float o[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const bool in = c + i < a.nf;
              const float xh = in ? (vv[i] - st.x) * st.y : 0.f;
              p[1][2 * j + i] += dd[i] * xh;
              p[2][2 * j + i] += dd[i];
              o[i] = in ? st.y * (dd[i] * a.scale[c + i] - mm.x - xh * mm.y) : 0.f;
              p[0][2 * j + i] += o[i];
            }
            st2(static_cast<T*>(a.out) + row * a.F + c, o[0], o[1]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int j = 0; j < VC / 2; ++j) {
        const int c = c0 + 2 * (lane + 32 * j);
        if (c < a.F) st2(a.partials + (gw * 4 + 1 + q) * a.F + c, p[q][2 * j], p[q][2 * j + 1]);
      }
  }
}
template <typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_bwd_wide_node_any(const RowArgs a) {
  bwd_ln_rows_any<T, false>(a);
}
template <typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_bwd_wide_edge_any(const RowArgs a) {
  bwd_ln_rows_any<T, true>(a);
}

// fused_mp_bwd_wide_post at any width, a chunk at a time
template <typename T>
__global__ void __launch_bounds__(WROW_WARPS * 32) fused_mp_bwd_wide_post_any(const RowArgs a) {
  const int lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * WROW_WARPS + (threadIdx.x >> 5);
  const int64_t nw = (int64_t)gridDim.x * WROW_WARPS;
  for (int c0 = 0; c0 < a.F; c0 += WCHUNK) {
    float p[VC];
#pragma unroll
    for (int i = 0; i < VC; ++i) p[i] = 0.f;
    for (int64_t n = gw; n < a.n; n += nw) {
      float s[VC];
#pragma unroll
      for (int i = 0; i < VC; ++i) s[i] = 0.f;
      for (int kk = 0; kk < a.k; ++kk) {
        const int64_t row = n * a.k + kk;
#pragma unroll
        for (int j = 0; j < VC / 2; ++j) {
          const int c = c0 + 2 * (lane + 32 * j);
          if (c < a.F) {
            const float2 v = ld2(a.x + row * a.F + c);
            s[2 * j] += v.x;
            s[2 * j + 1] += v.y;
            st2(static_cast<T*>(a.out) + row * a.F + c, v.x, v.y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VC / 2; ++j) {
        const int c = c0 + 2 * (lane + 32 * j);
        p[2 * j] += s[2 * j];
        p[2 * j + 1] += s[2 * j + 1];
        if (c < a.F && a.rowsum != nullptr)
          st2(static_cast<T*>(a.rowsum) + n * a.F + c, s[2 * j], s[2 * j + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < VC / 2; ++j) {
      const int c = c0 + 2 * (lane + 32 * j);
      if (c < a.F) st2(a.partials + (gw * 4 + a.slot) * a.F + c, p[2 * j], p[2 * j + 1]);
    }
  }
}

// the encoder's first layer: out = T(relu(T(raw) @ enc_w1 + enc_b1)), raw
// (rows, fe) float32, one thread per output pair
template <typename T>
__global__ void fused_mp_wide_enc_first(const float* raw, const T* w1, const float* b1, T* out,
                                        int64_t rows, int fe, int F) {
  const int64_t pairs = rows * (F / 2);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / (F / 2);
    const int c = (int)(i % (F / 2)) * 2;
    float v0 = 0.f, v1 = 0.f;
    for (int j = 0; j < fe; ++j) {
      const float r = to_f(from_f<T>(raw[row * fe + j]));
      const float2 w = ld2(w1 + (int64_t)j * F + c);
      v0 = fmaf(r, w.x, v0);
      v1 = fmaf(r, w.y, v1);
    }
    st2(out + row * F + c, fmaxf(v0 + b1[c], 0.f), fmaxf(v1 + b1[c + 1], 0.f));
  }
}

// the sender row of every edge row of K8 (slot layout) and E2 (windows),
// -1 where the slot is padded (ops/fused_mp.py slot_sender_rows,
// window_sender_rows)
__global__ void fused_mp_wide_senders(const int32_t* cand, const int32_t* table, int32_t* srow,
                                      int64_t rows, int k, int slot, int C, int S, int T, int SUB,
                                      int WSUB) {
  for (int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; m < rows;
       m += (int64_t)gridDim.x * blockDim.x) {
    const int c = cand[m];
    const int64_t i = m / k;
    int32_t r = -1;
    if (slot) {
      if (c < S * C) r = table[(i / C) * S + c / C] * C + c % C;
    } else if (c < 3 * WSUB) {
      r = table[((i / T) * (T / SUB) + (i % T) / SUB) * 3 + c / WSUB] * 8 + c % WSUB;
    }
    srow[m] = r;
  }
}

template <typename K>
int row_launch(K kern, int64_t blocks, const RowArgs& a, cudaStream_t stream) {
  kern<<<(unsigned)blocks, WROW_WARPS * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
// one warp per row, at the row kernels' V for width F (their chunked form
// past 1,024)
#define WIDE_ROWS(KERN, T, blocks, a, stream)                                        \
  ((a).F <= 512    ? row_launch(KERN<16, T>, blocks, a, stream)                      \
   : (a).F <= 1024 ? row_launch(KERN<32, T>, blocks, a, stream)                      \
                   : row_launch(KERN##_any<T>, blocks, a, stream))

inline int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

int64_t row_blocks(int64_t rows) { return (rows + WROW_WARPS - 1) / WROW_WARPS; }

RowArgs row_args(int64_t n, int k, int F, int nf) {
  RowArgs a{};
  a.n = n;
  a.k = k;
  a.F = F;
  a.nf = nf;
  return a;
}

// ---- the forward (K3, K8, E2) -------------------------------------------

struct WideFwd {
  const void* e;        // (rows, F) T, or raw (rows, fe) float32 with enc
  const void* hs;       // K3: (rows, F) gathered; K8, E2: hs_ext (n_ext, F)
  const void* hr;       // (n, F)
  const void* h;        // (n, F)
  const float* mask;    // K3: (rows)
  void* e_out;          // (rows, F)
  void* h_out;          // (n, F)
  const void* w[5];     // W_e, W2, W_nh, W_na, W_n2
  const float* vec[8];  // b1, b2, ln1_scale, ln1_bias, bn1, bn2, ln2_scale, ln2_bias
  const void* enc_w1;
  const void* enc_w2;
  const float* enc_vec[4];  // enc_b1, enc_b2, enc_ln_scale, enc_ln_bias
  const int32_t* cand;      // K8, E2
  const int32_t* table;     // K8: bases_ext; E2: w0s
  int src;                  // 0 K3, 1 K8, 2 E2
  int C, S, T, SUB, WSUB;
  int n, k, fe, nf, F;
  bool enc;
  // device buffers of the wrapper (ops/fused_mp.py _wide_buffers)
  int32_t* srow;  // (rows) K8, E2
  void* e_enc;    // (rows, F) T, with enc
  float* x;       // (rows, F)
  void* r1;       // (rows, F) T
  void* aggc;     // (n, F) T
  float* agg;     // (n, F)
  void* r2;       // (n, F) T
  float* y;       // (n, F)
  float* part;    // the wgmma design's agg partials (tiles, slots, F)
};

// the node side: r2 = T(relu(h @ W_nh + T(agg) @ W_na + bn1)), y = r2 @ W_n2 +
// bn2, h' = T(h + LN2(y))
template <typename T>
int wide_node(const WideFwd& a, cudaStream_t stream) {
  const int F = a.F;
  int err;
  GemmArgs g = gemm_args(a.h, a.w[2], a.n, F, F, F, F, epi_of(kReluBias, a.r2, a.vec[4]));
  g.a[1] = a.aggc;
  g.b[1] = a.w[3];
  g.pairs = 2;
  if ((err = wide_gemm<T, false, false>(g, stream)) != 0) return err;
  err = wide_gemm<T, false, false>(
      gemm_args(a.r2, a.w[4], a.n, F, F, F, F, epi_of(kStoreF32, a.y, a.vec[5])), stream);
  if (err != 0) return err;
  RowArgs r = row_args(a.n, 1, F, a.nf);
  r.x = a.y;
  r.res = a.h;
  r.scale = a.vec[6];
  r.bias = a.vec[7];
  r.out = a.h_out;
  return WIDE_ROWS(fused_mp_wide_ln, T, row_blocks(a.n), r, stream);
}

// the arguments of the wgmma edge kernel for a forward
inline WgEdgeArgs edge_args(const WideFwd& a, const int32_t* srow) {
  WgEdgeArgs g{};
  g.e = a.e;
  g.raw = static_cast<const float*>(a.e);
  g.hs = a.hs;
  g.srow = srow;
  g.hr = a.hr;
  g.mask = a.mask;
  g.e_out = a.e_out;
  g.x1_out = nullptr;
  g.partials = a.part;
  for (int i = 0; i < 4; ++i) g.vec[i] = a.vec[i];
  g.enc_w1 = a.enc_w1;
  for (int i = 0; i < 4; ++i) g.enc_vec[i] = a.enc_vec[i];
  g.rows = (int64_t)a.n * a.k;
  g.k = a.k;
  g.nf = a.nf;
  g.fe = a.fe;
  g.tiles = wgmma_tiles(g.rows);
  g.slots = wgmma_slots(a.k);
  g.enc = a.enc;
  g.store_r1 = a.r1 != nullptr;
  return g;
}

template <typename T>
int wide_forward(WideFwd a, cudaStream_t stream) {
  const int F = a.F;
  const int64_t rows = (int64_t)a.n * a.k;
  int err;
  const int32_t* srow = nullptr;
  if (a.src != 0) {
    fused_mp_wide_senders<<<(unsigned)imin((rows + 255) / 256, 1 << 16), 256, 0,
                            stream>>>(a.cand, a.table, a.srow, rows, a.k, a.src == 1, a.C, a.S,
                                      a.T, a.SUB, a.WSUB);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    srow = a.srow;
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (F <= kWgmmaMax) {  // the wgmma design: the edge side in one kernel
      err = edge_wgmma<bf16>(edge_args(a, srow), F, a.enc_w2, a.w[0], a.w[1], a.r1,
                             static_cast<bf16*>(a.aggc), a.agg, a.n, stream);
      return err != 0 ? err : wide_node<T>(a, stream);
    }
  }
  const void* e = a.e;
  if (a.enc) {  // e = LN(relu(raw @ enc_w1 + enc_b1) @ enc_w2 + enc_b2), through r1 and x
    const int64_t pairs = rows * (F / 2);
    fused_mp_wide_enc_first<T><<<(unsigned)imin((pairs + 255) / 256, 1 << 16), 256, 0,
                                 stream>>>(static_cast<const float*>(a.e),
                                           static_cast<const T*>(a.enc_w1), a.enc_vec[0],
                                           static_cast<T*>(a.r1), rows, a.fe, F);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    err = wide_gemm<T, false, false>(
        gemm_args(a.r1, a.enc_w2, rows, F, F, F, F, epi_of(kStoreF32, a.x, a.enc_vec[1])), stream);
    if (err != 0) return err;
    RowArgs r = row_args(rows, 1, F, a.nf);
    r.x = a.x;
    r.scale = a.enc_vec[2];
    r.bias = a.enc_vec[3];
    r.out = a.e_enc;
    if ((err = WIDE_ROWS(fused_mp_wide_ln, T, row_blocks(rows), r, stream)) != 0) return err;
    e = a.e_enc;
  }
  // first = e @ W_e + hs + hr + b1 -> T(relu(first))
  GemmEpi first = epi_of(kFirst, a.r1, a.vec[0]);
  first.hs = a.hs;
  first.srow = srow;
  first.hr = a.hr;
  first.k = a.k;
  if ((err = wide_gemm<T, false, false>(gemm_args(e, a.w[0], rows, F, F, F, F, first), stream)))
    return err;
  // x1 = T(relu(first)) @ W2 + b2
  err = wide_gemm<T, false, false>(
      gemm_args(a.r1, a.w[1], rows, F, F, F, F, epi_of(kStoreF32, a.x, a.vec[1])), stream);
  if (err != 0) return err;
  // msg = LN1(x1), e' = T(e + msg), agg = sum_K msg * mask
  RowArgs r = row_args(a.n, a.k, F, a.nf);
  r.x = a.x;
  r.scale = a.vec[2];
  r.bias = a.vec[3];
  r.out = a.e_out;
  r.res_e = e;
  r.mask = a.src == 0 ? a.mask : nullptr;
  r.srow = srow;
  r.aggc = a.aggc;
  r.agg = a.agg;
  if ((err = WIDE_ROWS(fused_mp_wide_edge_ln, T, row_blocks(a.n), r, stream)) != 0) return err;
  return wide_node<T>(a, stream);
}

// ---- the backward (K4) ----------------------------------------------------

struct WideBwd {
  const void* e;       // (rows, F) T
  const void* hs;      // (rows, F) T gathered
  const void* hr;      // (n, F) T
  const void* h;       // (n, F) T
  const float* mask;   // (rows)
  const void* ge;      // (rows, F) T
  const void* gh;      // (n, F) T
  void* de;            // (rows, F) T
  void* dhs;           // (rows, F) T: T(dfirst)
  void* dhr;           // (n, F) T
  void* dh;            // (n, F) T
  const void* w[5];    // W_e, W2, W_nh, W_na, W_n2
  const float* vec[8];  // b1, b2, ln1_scale, ln1_bias, bn1, bn2, ln2_scale, ln2_bias
  float* partials;     // wide_partials layout
  float* agg_out;      // (n, F) float32 or null
  int n, k, nf, F;
  int r_e, r_n, p_e, p_n;  // the plan: weight-gradient ranges, row-kernel warps
  // device buffers of the wrapper (ops/fused_mp.py _wide_buffers)
  void* r1;    // (rows, F) T
  float* x1;   // (rows, F), then dfirst
  void* aggc;  // (n, F) T
  void* r2;    // (n, F) T
  float* y1;   // (n, F)
  void* dy1c;  // (n, F) T
  float* dnf;  // (n, F)
  void* dnfc;  // (n, F) T
  float* dagg;  // (n, F)
  void* dx1c;  // (rows, F) T
  float* part;  // the wgmma design's agg partials (tiles, slots, F)
};

// the partials of the wide backward: the five weight gradients' range
// partials (W_e and W2 r_e each, W_nh, W_na, W_n2 r_n each; F x F each),
// then the edge row kernels' warps (p_e x 4 vectors: b1, b2, ln1_scale,
// ln1_bias), then the node row kernels' (p_n x 4: bn1, bn2, ln2_scale,
// ln2_bias), F floats each (ops/fused_mp.py bwd_partials_floats)
void wide_partials(float* partials, int F, int r_e, int r_n, int p_e, float** p_tn,
                   float** p_edge, float** p_node) {
  *p_tn = partials;
  *p_edge = partials + (int64_t)(2 * r_e + 3 * r_n) * F * F;
  *p_node = *p_edge + (int64_t)p_e * 4 * F;
}

// a weight gradient A^T B over `rows` rows into `ranges` F x F partials
template <typename T>
int wide_tn(const void* A, const void* B, int64_t rows, int F, int ranges, float* out,
            cudaStream_t stream) {
  GemmArgs g = gemm_args(A, B, F, F, rows, F, F, epi_of(kStoreF32, out));
  g.ranges = ranges;
  return wide_gemm<T, true, false>(g, stream);
}

// K4's node side: node_first and y1 rematerialized as K3 computes them (the
// same launches on the same operands: the same bits, so that node_first's
// ReLU decides dnf as it decided the forward), then T(dy1); dnf = T(dy1) @
// W_n2^T * (r2 > 0) -> T(dnf); dh = gh + T(dnf) @ W_nh^T; dagg = T(dnf) @
// W_na^T (float32); the node vector partials into p_node
template <typename T>
int wide_node_bwd(const WideBwd& a, float* p_node, cudaStream_t stream) {
  const int F = a.F;
  GemmArgs g = gemm_args(a.h, a.w[2], a.n, F, F, F, F, epi_of(kReluBias, a.r2, a.vec[4]));
  g.a[1] = a.aggc;
  g.b[1] = a.w[3];
  g.pairs = 2;
  int err;
  if ((err = wide_gemm<T, false, false>(g, stream)) != 0) return err;
  err = wide_gemm<T, false, false>(
      gemm_args(a.r2, a.w[4], a.n, F, F, F, F, epi_of(kStoreF32, a.y1, a.vec[5])), stream);
  if (err != 0) return err;
  RowArgs r = row_args(a.n, 1, F, a.nf);
  r.x = a.y1;
  r.g = a.gh;
  r.scale = a.vec[6];
  r.out = a.dy1c;
  r.partials = p_node;
  if ((err = WIDE_ROWS(fused_mp_bwd_wide_node, T, a.p_n / WROW_WARPS, r, stream)) != 0) return err;
  err = wide_gemm<T, false, true>(
      gemm_args(a.dy1c, a.w[4], a.n, F, F, F, F, epi_of(kReluMask, a.dnf, nullptr, a.r2)), stream);
  if (err != 0) return err;
  r.x = a.dnf;
  r.out = a.dnfc;
  r.slot = 0;
  if ((err = WIDE_ROWS(fused_mp_bwd_wide_post, T, a.p_n / WROW_WARPS, r, stream)) != 0) return err;
  err = wide_gemm<T, false, true>(
      gemm_args(a.dnfc, a.w[2], a.n, F, F, F, F, epi_of(kAdd, a.dh, nullptr, a.gh)), stream);
  if (err != 0) return err;
  return wide_gemm<T, false, true>(
      gemm_args(a.dnfc, a.w[3], a.n, F, F, F, F, epi_of(kStoreF32, a.dagg)), stream);
}

// the node weight gradients dW_nh, dW_na, dW_n2, each over its r_n row
// ranges, into p_nodes
template <typename T>
int wide_node_tn(const WideBwd& a, float* p_nodes, cudaStream_t stream) {
  const int64_t FF = (int64_t)a.F * a.F;
  int err;
  if ((err = wide_tn<T>(a.h, a.dnfc, a.n, a.F, a.r_n, p_nodes, stream))) return err;
  if ((err = wide_tn<T>(a.aggc, a.dnfc, a.n, a.F, a.r_n, p_nodes + a.r_n * FF, stream))) return err;
  return wide_tn<T>(a.r2, a.dy1c, a.n, a.F, a.r_n, p_nodes + 2 * a.r_n * FF, stream);
}

template <typename T>
int wide_backward(WideBwd a, cudaStream_t stream) {
  const int F = a.F;
  const int64_t rows = (int64_t)a.n * a.k, FF = (int64_t)F * F;
  if (a.p_e % WROW_WARPS || a.p_n % WROW_WARPS || a.p_e < 1 || a.p_n < 1 || a.r_e < 1 ||
      a.r_n < 1)
    return (int)cudaErrorInvalidValue;
  int err;
  // the forward, rematerialized: r1 = T(relu(first)), x1, T(agg)
  GemmEpi first = epi_of(kFirst, a.r1, a.vec[0]);
  first.hs = a.hs;
  first.hr = a.hr;
  first.k = a.k;
  if ((err = wide_gemm<T, false, false>(gemm_args(a.e, a.w[0], rows, F, F, F, F, first), stream)))
    return err;
  err = wide_gemm<T, false, false>(
      gemm_args(a.r1, a.w[1], rows, F, F, F, F, epi_of(kStoreF32, a.x1, a.vec[1])), stream);
  if (err != 0) return err;
  RowArgs r = row_args(a.n, a.k, F, a.nf);
  r.x = a.x1;
  r.scale = a.vec[2];
  r.bias = a.vec[3];
  r.mask = a.mask;
  r.aggc = a.aggc;
  r.agg = a.agg_out;
  if ((err = WIDE_ROWS(fused_mp_wide_edge_ln, T, row_blocks(a.n), r, stream)) != 0) return err;

  float *p_tn, *p_edge, *p_node;
  wide_partials(a.partials, F, a.r_e, a.r_n, a.p_e, &p_tn, &p_edge, &p_node);
  if ((err = wide_node_bwd<T>(a, p_node, stream)) != 0) return err;

  // edge path: T(dx1); dfirst = T(dx1) @ W2^T * (r1 > 0) (into x1) ->
  // dhs = T(dfirst), dhr = T(sum_K dfirst); de = ge + dhs @ W_e^T
  r = row_args(a.n, a.k, F, a.nf);
  r.x = a.x1;
  r.g = a.ge;
  r.dagg = a.dagg;
  r.mask = a.mask;
  r.scale = a.vec[2];
  r.out = a.dx1c;
  r.partials = p_edge;
  if ((err = WIDE_ROWS(fused_mp_bwd_wide_edge, T, a.p_e / WROW_WARPS, r, stream)) != 0) return err;
  err = wide_gemm<T, false, true>(
      gemm_args(a.dx1c, a.w[1], rows, F, F, F, F, epi_of(kReluMask, a.x1, nullptr, a.r1)), stream);
  if (err != 0) return err;
  r.x = a.x1;
  r.out = a.dhs;
  r.rowsum = a.dhr;
  r.slot = 0;
  if ((err = WIDE_ROWS(fused_mp_bwd_wide_post, T, a.p_e / WROW_WARPS, r, stream)) != 0) return err;
  err = wide_gemm<T, false, true>(
      gemm_args(a.dhs, a.w[0], rows, F, F, F, F, epi_of(kAdd, a.de, nullptr, a.ge)), stream);
  if (err != 0) return err;

  // the weight gradients, each over its fixed row ranges
  if ((err = wide_tn<T>(a.e, a.dhs, rows, F, a.r_e, p_tn, stream))) return err;
  if ((err = wide_tn<T>(a.r1, a.dx1c, rows, F, a.r_e, p_tn + a.r_e * FF, stream))) return err;
  return wide_node_tn<T>(a, p_tn + 2 * a.r_e * FF, stream);
}

// grads (5 F^2 + 8 F: W_e, W2, W_nh, W_na, W_n2, then the eight vectors)
// from the wide partials, each summed over its ranges or warps in order
__global__ void fused_mp_bwd_wide_reduce(const float* partials, float* out, int F, int r_e,
                                         int r_n, int p_e, int p_n) {
  const int64_t FF = (int64_t)F * F, total = 5 * FF + 8 * (int64_t)F;
  const float *p_tn, *p_edge, *p_node;
  p_tn = partials;
  p_edge = partials + (2 * r_e + 3 * r_n) * FF;
  p_node = p_edge + (int64_t)p_e * 4 * F;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    if (j < 5 * FF) {
      const int q = (int)(j / FF);
      const int64_t idx = j % FF;
      const int ranges = q < 2 ? r_e : r_n;
      const int before = q < 2 ? q * r_e : 2 * r_e + (q - 2) * r_n;
      for (int rr = 0; rr < ranges; ++rr) s += p_tn[(before + rr) * FF + idx];
    } else {
      const int v = (int)((j - 5 * FF) / F), c = (int)((j - 5 * FF) % F);
      const float* base = v < 4 ? p_edge : p_node;
      const int warps = v < 4 ? p_e : p_n;
      for (int w = 0; w < warps; ++w) s += base[((int64_t)w * 4 + v % 4) * F + c];
    }
    out[j] = s;
  }
}

int wide_reduce(const float* partials, float* out, int F, const int* plan, cudaStream_t stream) {
  const int64_t total = 5 * (int64_t)F * F + 8 * (int64_t)F;
  fused_mp_bwd_wide_reduce<<<(unsigned)imin((total + 255) / 256, 1 << 14), 256, 0, stream>>>(
      partials, out, F, plan[0], plan[1], plan[2], plan[3]);
  return (int)cudaGetLastError();
}

}  // namespace
