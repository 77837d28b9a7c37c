// Warp-tile building blocks of the bf16 fused message-passing kernels on
// Hopper (K3/K8/E2 forward in fused_mp.cu, K4 backward in fused_mp_bwd.cu).
//
// A warp owns a slice of 16 rows through a whole chain of products. Its
// operands are mma.sync m16n8k16 fragments (bf16 in, float32 accumulators
// in registers); the B operands (the F x F weights, and the slices that
// weight gradients read) are 16-byte-chunk-swizzled tiles in shared memory
// read with ldmatrix (.trans for a row-major (in, out) weight). An
// accumulator maps onto the next product's A operand register for
// register, so a chain never goes back through shared memory, and a
// LayerNorm row is reduced by shuffles among the four lanes that hold it.
// Edge and node rows arrive by cp.async (16 bytes, zero-filled past the
// end) into per-warp rings.
//
// Everything is templated on the instance width F (64 or 128: a 16-row
// slice's chain keeps ~1.3 F registers per lane, so the wider instances run
// the tile design of mp_common.cuh), and LayerNorm runs over the true
// width nf <= F (the channels past nf are zero-padded and come out 0).
// Layouts (g = lane / 4, t = lane % 4):
//   accumulator acc[nb][0..3], nb = 0..F/8-1: rows g (0, 1) and g + 8 (2, 3),
//     columns nb * 8 + 2t (+1);
//   A operand a[kb][0..3], kb = 0..F/16-1: the same elements of n-blocks 2kb
//     (0: row g, 1: row g + 8) and 2kb + 1 (2: row g, 3: row g + 8), as
//     bf16 pairs (the lower column in the low half);
//   tile: rows of 2F bytes (F/8 chunks of 16 bytes), chunk c of row r at
//     r * 2F + (c ^ (r % 8)) * 16, so that ldmatrix's 8-row reads and the
//     pair stores of a warp hit distinct banks. A row needs at least 8
//     chunks for the XOR to stay inside it: F >= 64.
#pragma once

#include "mp_common.cuh"

namespace {

using u32 = uint32_t;

constexpr int SR = 16;            // rows of one warp slice
constexpr int kSmemMax = 232448;  // a block's shared memory on an H100

// The sizes of the bf16 tiles and fragments at latent width F.
template <int F>
struct Tile {
  static_assert(F % 64 == 0, "the swizzle needs rows of at least 8 chunks, whole quads");
  static constexpr int NB = F / 8;                    // 8-column n-blocks of an accumulator
  static constexpr int KB = F / 16;                   // 16-column k-blocks of an A operand
  static constexpr int NH = F / 64;                   // column-sum owner blocks per lane
  static constexpr int CH = F / 8;                    // 16-byte chunks of a row
  static constexpr int ROW_BYTES = F * 2;             // one bf16 row
  static constexpr int SLICE_BYTES = SR * ROW_BYTES;  // 4 KB at F = 128
  static constexpr int WEIGHT_BYTES = F * ROW_BYTES;  // 32 KB at F = 128
  static constexpr int CP_ITERS = SR * CH / 32;       // 16-byte copies per lane of a slice
};

__device__ __forceinline__ u32 smem_addr(const void* p) {
  return static_cast<u32>(__cvta_generic_to_shared(p));
}
template <int F>
__device__ __forceinline__ u32 swz(int r, int c) {
  return r * Tile<F>::ROW_BYTES + ((c ^ (r & 7)) << 4);
}
// byte offset of the bf16 pair (r, col), col even
template <int F>
__device__ __forceinline__ u32 swz_pair(int r, int col) {
  return swz<F>(r, col >> 3) + (col & 7) * 2;
}
// the (row, chunk) of a 16-row slice that lane copies in its i-th 16-byte
// copy (i < Tile<F>::CP_ITERS): copy i covers the slice's chunks [32 i, 32 i
// + 32) in row order, whole rows where a row's chunks divide 32 (F = 64, 128,
// 256) and 24-chunk rows at F = 192
template <int F>
__device__ __forceinline__ void slice_chunk(int lane, int i, int& r, int& c) {
  constexpr int CH = Tile<F>::CH;
  if constexpr (32 % CH == 0) {
    r = lane / CH + (32 / CH) * i;
    c = lane % CH;
  } else {
    r = (32 * i + lane) / CH;
    c = (32 * i + lane) % CH;
  }
}

__device__ __forceinline__ void cp_async16(u32 dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm(u32 (&r)[4], u32 addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_t(u32 (&r)[4], u32 addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a @ b for one 16x8 output block (k = 16)
__device__ __forceinline__ void mma(float (&d)[4], const u32 (&a)[4], u32 b0, u32 b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ u32 pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<u32*>(&v);
}
__device__ __forceinline__ float2 unpack(u32 v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ u32 lds32(const unsigned char* smem, u32 off) {
  return *reinterpret_cast<const u32*>(smem + off);
}
__device__ __forceinline__ void sts32(unsigned char* smem, u32 off, u32 v) {
  *reinterpret_cast<u32*>(smem + off) = v;
}
__device__ __forceinline__ u32 ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nb][i] = 0.f;
}

// acc += A @ W, W the swizzled (F, F) row-major (in, out) weight at shared
// address w, F = 8 NB
template <int NB, int KB>
__device__ __forceinline__ void gemm(float (&acc)[NB][4], const u32 (&a)[KB][4], u32 w,
                                     int lane) {
  static_assert(NB == 2 * KB, "a square weight");
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    const int k = kb * 16 + (lane & 7) + (lane & 8);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      u32 b[4];
      ldsm_t(b, w + swz<8 * NB>(k, np * 2 + (lane >> 4)));
      mma(acc[2 * np], a[kb], b[0], b[1]);
      mma(acc[2 * np + 1], a[kb], b[2], b[3]);
    }
  }
}

// acc += A @ W^T, W as in gemm
template <int NB, int KB>
__device__ __forceinline__ void gemm_t(float (&acc)[NB][4], const u32 (&a)[KB][4], u32 w,
                                       int lane) {
  static_assert(NB == 2 * KB, "a square weight");
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      u32 b[4];
      ldsm(b, w + swz<8 * NB>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                              kb * 2 + ((lane >> 3) & 1)));
      mma(acc[2 * np], a[kb], b[0], b[1]);
      mma(acc[2 * np + 1], a[kb], b[2], b[3]);
    }
  }
}

// g (rows i0 .. i0 + 15 of an F x F weight gradient, F = 8 NB) += X^T @ Y
// over the 16 rows of two swizzled slices at shared addresses x and y
template <int NB>
__device__ __forceinline__ void gemm_tn(float (&g)[NB][4], u32 x, u32 y, int i0, int lane) {
  constexpr int F = 8 * NB;
  u32 a[4];
  ldsm_t(a, x + swz<F>((lane & 7) + ((lane >> 4) << 3), (i0 >> 3) + ((lane >> 3) & 1)));
  const int k = (lane & 7) + (lane & 8);
#pragma unroll
  for (int np = 0; np < NB / 2; ++np) {
    u32 b[4];
    ldsm_t(b, y + swz<F>(k, np * 2 + (lane >> 4)));
    mma(g[2 * np], a, b[0], b[1]);
    mma(g[2 * np + 1], a, b[2], b[3]);
  }
}

// A operand of the 16-row swizzled slice at shared address s (F = 16 KB)
template <int KB>
__device__ __forceinline__ void load_a(u32 (&a)[KB][4], u32 s, int lane) {
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) ldsm(a[kb], s + swz<16 * KB>(lane & 15, kb * 2 + (lane >> 4)));
}

// the accumulator's bf16 pairs of n-block nb: row g (0) and row g + 8 (1)
template <int KB>
__device__ __forceinline__ u32 frag_pair(const u32 (&a)[KB][4], int nb, int row8) {
  return a[nb >> 1][(nb & 1) * 2 + row8];
}

// acc -> A operand, with f applied to each value first
template <int NB, typename Fn>
__device__ __forceinline__ void to_frag(u32 (&a)[NB / 2][4], const float (&acc)[NB][4], Fn f) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    a[nb >> 1][(nb & 1) * 2] = pack(f(acc[nb][0], nb, 0), f(acc[nb][1], nb, 1));
    a[nb >> 1][(nb & 1) * 2 + 1] = pack(f(acc[nb][2], nb, 0), f(acc[nb][3], nb, 1));
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(lbt::kFullMask, v, 1);
  return v + __shfl_xor_sync(lbt::kFullMask, v, 2);
}

// rows g and g + 8 of the accumulator normalized in place over their first
// nf columns: x = (x - mean) * inv, float32, eps kEps; returns the two
// rows' inv. The F - nf padded columns hold exact zeros (zero-padded weights
// and biases): they add nothing to the sums, each adds mean^2 to the sum of
// squares, which is taken back out, and they come out as -mean * inv, which
// the zero-padded LayerNorm scale and bias turn into 0. With nf = F this is
// the plain two-pass LayerNorm; no per-column mask costs registers.
template <int NB>
__device__ __forceinline__ void row_normalize(float (&x)[NB][4], float& inv0, float& inv1,
                                              int nf) {
  const float inv_n = 1.f / nf, pad = (float)(8 * NB - nf);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    s0 += x[nb][0] + x[nb][1];
    s1 += x[nb][2] + x[nb][3];
  }
  const float m0 = quad_sum(s0) * inv_n, m1 = quad_sum(s1) * inv_n;
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    x[nb][0] -= m0;
    x[nb][1] -= m0;
    x[nb][2] -= m1;
    x[nb][3] -= m1;
    v0 += x[nb][0] * x[nb][0] + x[nb][1] * x[nb][1];
    v1 += x[nb][2] * x[nb][2] + x[nb][3] * x[nb][3];
  }
  v0 = quad_sum(v0) - pad * m0 * m0;
  v1 = quad_sum(v1) - pad * m1 * m1;
  inv0 = rsqrtf(v0 * inv_n + kEps);
  inv1 = rsqrtf(v1 * inv_n + kEps);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    x[nb][0] *= inv0;
    x[nb][1] *= inv0;
    x[nb][2] *= inv1;
    x[nb][3] *= inv1;
  }
}

// x = x * scale + bias (float vectors in shared memory), per column
template <int NB>
__device__ __forceinline__ void scale_shift(float (&x)[NB][4], const float* scale,
                                            const float* bias, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = nb * 8 + 2 * t + j;
      x[nb][j] = x[nb][j] * scale[c] + bias[c];
      x[nb][2 + j] = x[nb][2 + j] * scale[c] + bias[c];
    }
}

// x += b (a float vector in shared memory), per column
template <int NB>
__device__ __forceinline__ void add_bias(float (&x)[NB][4], const float* b, int t) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      x[nb][j] += b[nb * 8 + 2 * t + j];
      x[nb][2 + j] += b[nb * 8 + 2 * t + j];
    }
}

// Column sums over a slice's 16 rows, kept by owner lanes: lane (g, t) owns
// columns (g + 8h) * 8 + 2t + j, h < NH = F / 64, j in {0, 1}. colsum_add
// adds the sum over the rows of v (this lane's rows g and g + 8 of column
// nb * 8 + 2t + j, already added) to the owner's own[h][j]; the order is
// fixed.
template <int NH>
__device__ __forceinline__ void colsum_add(float (&own)[NH][2], float v, int nb, int j, int g) {
  v += __shfl_xor_sync(lbt::kFullMask, v, 4);
  v += __shfl_xor_sync(lbt::kFullMask, v, 8);
  v += __shfl_xor_sync(lbt::kFullMask, v, 16);
  if ((nb & 7) == g) own[nb >> 3][j] += v;
}

template <int NH>
__device__ __forceinline__ void store_own(float* dst, const float (&own)[NH][2], int g, int t) {
#pragma unroll
  for (int h = 0; h < NH; ++h)
    *reinterpret_cast<float2*>(dst + (g + 8 * h) * 8 + 2 * t) = make_float2(own[h][0], own[h][1]);
}

// Stage `rows` rows of a row-major (rows, F) bf16 matrix into the swizzled
// tile at shared address dst by the whole block (zero rows past `valid`).
template <int F>
__device__ __forceinline__ void stage_rows(u32 dst, const bf16* src, int rows, int valid) {
  constexpr int CH = Tile<F>::CH;
  for (int i = threadIdx.x; i < rows * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    const bool v = r < valid;
    cp_async16(dst + swz<F>(r, c), v ? src + r * F + c * 8 : src, v);
  }
}

// Copy a warp's 16-row swizzled slice at shared offset off to global rows
// [row0, row0 + 16), 16 bytes per lane and store, rows >= row_end skipped.
template <int F>
__device__ __forceinline__ void store_slice(bf16* dst, int64_t row0, int64_t row_end,
                                            const unsigned char* smem, u32 off, int lane) {
#pragma unroll
  for (int i = 0; i < Tile<F>::CP_ITERS; ++i) {
    int r, c;
    slice_chunk<F>(lane, i, r, c);
    if (row0 + r < row_end)
      *reinterpret_cast<int4*>(dst + (row0 + r) * F + c * 8) =
          *reinterpret_cast<const int4*>(smem + off + swz<F>(r, c));
  }
}

// ---------------------------------------------------------------------------
// The edge half of one fused step, forward (K3, K8, E2; and K4's first
// rematerialization): for each edge row
//   [ENC] e = LN(relu(raw @ enc_w1 + enc_b1) @ enc_w2 + enc_b2)
//   first = e @ W_e + hs + hr + b1,  msg = LN1(relu(first) @ W2 + b2)
//   e' = T(e + msg),  agg[i] = sum over receiver i's rows of msg * mask
// agg goes to device memory (float32), for the node half.
//
// Persistent: one block of 8 warps per SM (the grid is planned by the
// caller); every warp owns a contiguous range of receivers, split evenly,
// and walks its rows in 16-row slices through a 2-stage cp.async ring, so
// each receiver's K-sum is one warp's, in row order, and no block-wide
// barrier follows the weight staging. The weights stay resident.
// ---------------------------------------------------------------------------

// Where a step's sender rows come from: a gathered (N, K, F) tensor (K3),
// the slot layout's stencil table (K8) or the sub-tile windows (E2).
enum class Src { kGathered, kSlot, kWindow };

struct EdgeArgs {
  const void* e;             // (rows, F) bf16, or raw (rows, fe) float32 with ENC
  const bf16* hs;            // K3: (rows, F) gathered; K8, E2: hs_ext (n_ext, F)
  const bf16* hr;            // (n, F)
  const float* mask;         // K3: (rows)
  const int32_t* cand;       // K8: (n, K) stencil ids; E2: (n, K) window ids
  const int32_t* bases_ext;  // K8: (n_cols + 1, S)
  const int32_t* w0s;        // E2: (n / T, T / SUB, 3)
  const bf16* w_e;
  const bf16* w2;
  const bf16* enc_w1;        // (fe, F)
  const bf16* enc_w2;
  const float* vec[4];       // b1, b2, ln1 scale, ln1 bias
  const float* enc_vec[4];   // enc_b1, enc_b2, enc LN scale, enc LN bias
  bf16* e_out;               // (rows, F), or null: agg only
  float* agg;                // (n, F)
  int n, k, fe;
  int nf;                    // the true latent width (LayerNorm), <= F
  int C, S;                  // K8
  int T, SUB, WSUB;          // E2
};

template <int F, bool ENC>
struct EdgeSmem {
  static constexpr int WEIGHT_BYTES = Tile<F>::WEIGHT_BYTES, SLICE_BYTES = Tile<F>::SLICE_BYTES;
  static constexpr int kWe = 0;
  static constexpr int kW2 = WEIGHT_BYTES;
  static constexpr int kEnc2 = 2 * WEIGHT_BYTES;
  static constexpr int kEnc1 = kEnc2 + (ENC ? WEIGHT_BYTES : 0);  // 16 rows, zero past fe
  static constexpr int kVec = kEnc1 + (ENC ? SLICE_BYTES : 0);    // 8 float vectors
  static constexpr int kRing = kVec + 8 * F * 4;
  static constexpr int kStage = (ENC ? 1 : 2) * SLICE_BYTES;      // (e), hs
  static constexpr int kBytes = kRing + WARPS * 2 * kStage;
  static_assert(kBytes <= kSmemMax, "edge kernel shared memory");
};

// a warp's receiver range [lo, hi) of n split over nw warps
__device__ __forceinline__ void warp_range(int n, int gw, int nw, int64_t& lo, int64_t& hi) {
  lo = (int64_t)n * gw / nw;
  hi = (int64_t)n * (gw + 1) / nw;
}

// The body of an edge kernel (a __global__ wrapper per translation unit
// gives each use its own name in traces): one block of THREADS threads with
// EdgeSmem<F, ENC>::kBytes of dynamic shared memory.
template <int F, bool ENC, Src SRC>
__device__ __forceinline__ void edge_fwd(const EdgeArgs& a) {
  using S = EdgeSmem<F, ENC>;
  using D = Tile<F>;
  constexpr int NB = D::NB, KB = D::KB, NH = D::NH, SLICE_BYTES = D::SLICE_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  const bf16* e = static_cast<const bf16*>(a.e);
  const float* raw = static_cast<const float*>(a.e);

  stage_rows<F>(sb + S::kWe, a.w_e, F, F);
  stage_rows<F>(sb + S::kW2, a.w2, F, F);
  if constexpr (ENC) {
    stage_rows<F>(sb + S::kEnc2, a.enc_w2, F, F);
    stage_rows<F>(sb + S::kEnc1, a.enc_w1, SR, a.fe);
  }
  cp_commit();
  float* vec = reinterpret_cast<float*>(smem + S::kVec);
  for (int i = threadIdx.x; i < 8 * F; i += THREADS)
    vec[i] = i < 4 * F ? a.vec[i / F][i % F] : (ENC ? a.enc_vec[i / F - 4][i % F] : 0.f);
  cp_wait<0>();
  __syncthreads();
  const float *b1 = vec, *b2 = vec + F, *ln_s = vec + 2 * F, *ln_b = vec + 3 * F;

  const int K = a.k;
  int64_t rc0, rc1;
  warp_range(a.n, blockIdx.x * WARPS + warp, gridDim.x * WARPS, rc0, rc1);
  const int64_t r_lo = rc0 * K, r_hi = rc1 * K;
  const int slices = (int)((r_hi - r_lo + SR - 1) / SR);
  const u32 ring = S::kRing + warp * 2 * S::kStage;  // offset of this warp's ring

  // next slice's per-row values: lane r (< 16) holds row r's mask
  float m_next = 0.f;
  float raw_next[8];
  auto issue = [&](int j) {
    const int64_t s0 = r_lo + (int64_t)j * SR;
    const u32 st = ring + (j & 1) * S::kStage;
    const u32 st_hs = st + (ENC ? 0 : SLICE_BYTES);
    const int64_t rr = s0 + (lane & 15);
    const bool rv = rr < r_hi;
    int src = -1;
    if constexpr (SRC == Src::kSlot) {
      if (rv) {
        const int c = a.cand[rr];
        const int col = (int)(rr / K) / a.C;
        src = c < a.S * a.C ? a.bases_ext[col * a.S + c / a.C] * a.C + c % a.C : -1;
      }
    } else if constexpr (SRC == Src::kWindow) {
      if (rv) {
        const int i = (int)(rr / K);
        const int64_t win = ((int64_t)(i / a.T) * (a.T / a.SUB) + (i % a.T) / a.SUB) * 3;
        const int c = a.cand[rr];
        src = c < 3 * a.WSUB ? a.w0s[win + c / a.WSUB] * 8 + c % a.WSUB : -1;
      }
    }
    if constexpr (SRC == Src::kGathered) m_next = rv ? a.mask[rr] : 0.f;
    else m_next = src >= 0 ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < D::CP_ITERS; ++i) {
      int r, c;
      slice_chunk<F>(lane, i, r, c);
      const int64_t row = s0 + r;
      const bool v = row < r_hi;
      if constexpr (!ENC) cp_async16(sb + st + swz<F>(r, c), v ? e + row * F + c * 8 : e, v);
      if constexpr (SRC == Src::kGathered) {
        cp_async16(sb + st_hs + swz<F>(r, c), v ? a.hs + row * F + c * 8 : a.hs, v);
      } else {
        const int sr = __shfl_sync(lbt::kFullMask, src, r);
        cp_async16(sb + st_hs + swz<F>(r, c), sr >= 0 ? a.hs + (int64_t)sr * F + c * 8 : a.hs,
                   sr >= 0);
      }
    }
    if constexpr (ENC) {  // the A operand's raw values: rows g, g + 8; k = 2t (+1), 8 + 2t (+1)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int64_t row = s0 + g + ((i >> 1) & 1) * 8;
        const int kk = (i >> 2) * 8 + 2 * t + (i & 1);
        raw_next[i] = row < r_hi && kk < a.fe ? raw[row * a.fe + kk] : 0.f;
      }
    }
    cp_commit();
  };

  int64_t cur = -1;  // the receiver whose agg `own` holds
  float own[NH][2] = {};
  auto flush = [&]() {
    if (cur >= 0) store_own(a.agg + cur * F, own, g, t);
  };
  if (slices > 0) issue(0);
  for (int j = 0; j < slices; ++j) {
    const float m_row = m_next;
    float raw_cur[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) raw_cur[i] = ENC ? raw_next[i] : 0.f;
    if (j + 1 < slices) {
      issue(j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();

    const int64_t s0 = r_lo + (int64_t)j * SR;
    const u32 st = ring + (j & 1) * S::kStage;
    const u32 st_hs = st + (ENC ? 0 : SLICE_BYTES);
    const bool vg = s0 + g < r_hi, vg8 = s0 + g + 8 < r_hi;
    const int64_t ig = vg ? (s0 + g) / K : 0, ig8 = vg8 ? (s0 + g + 8) / K : 0;
    u32 hrp[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + 2 * t;
      hrp[nb][0] = vg ? ldg32(a.hr + ig * F + c) : 0u;
      hrp[nb][1] = vg8 ? ldg32(a.hr + ig8 * F + c) : 0u;
    }

    u32 ea[KB][4];
    float acc[NB][4];
    if constexpr (ENC) {
      const u32 a1[4] = {pack(raw_cur[0], raw_cur[1]), pack(raw_cur[2], raw_cur[3]),
                         pack(raw_cur[4], raw_cur[5]), pack(raw_cur[6], raw_cur[7])};
      zero(acc);
      const int k = (lane & 7) + (lane & 8);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        u32 b[4];
        ldsm_t(b, sb + S::kEnc1 + swz<F>(k, np * 2 + (lane >> 4)));
        mma(acc[2 * np], a1, b[0], b[1]);
        mma(acc[2 * np + 1], a1, b[2], b[3]);
      }
      const float* eb1 = vec + 4 * F;
      u32 ha[KB][4];
      to_frag(ha, acc, [&](float x, int nb, int jj) {
        return fmaxf(x + eb1[nb * 8 + 2 * t + jj], 0.f);
      });
      zero(acc);
      gemm(acc, ha, sb + S::kEnc2, lane);
      add_bias(acc, vec + 5 * F, t);
      float i0, i1;
      row_normalize(acc, i0, i1, a.nf);
      scale_shift(acc, vec + 6 * F, vec + 7 * F, t);
      to_frag(ea, acc, [](float x, int, int) { return x; });
    } else {
      load_a(ea, sb + st, lane);
    }

    // first = e @ W_e + hs + hr + b1 -> T(relu(first))
    zero(acc);
    gemm(acc, ea, sb + S::kWe, lane);
    u32 ra[KB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      u32 h4[4];
      ldsm(h4, sb + st_hs + swz<F>(lane & 15, kb * 2 + (lane >> 4)));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int nb = 2 * kb + hf, c = nb * 8 + 2 * t;
        const float2 s_g = unpack(h4[2 * hf]), s_g8 = unpack(h4[2 * hf + 1]);
        const float2 r_g = unpack(hrp[nb][0]), r_g8 = unpack(hrp[nb][1]);
        ra[kb][2 * hf] = pack(fmaxf(acc[nb][0] + s_g.x + r_g.x + b1[c], 0.f),
                              fmaxf(acc[nb][1] + s_g.y + r_g.y + b1[c + 1], 0.f));
        ra[kb][2 * hf + 1] = pack(fmaxf(acc[nb][2] + s_g8.x + r_g8.x + b1[c], 0.f),
                                  fmaxf(acc[nb][3] + s_g8.y + r_g8.y + b1[c + 1], 0.f));
      }
    }

    // msg = LN1(relu(first) @ W2 + b2)
    zero(acc);
    gemm(acc, ra, sb + S::kW2, lane);
    add_bias(acc, b2, t);
    float inv0, inv1;
    row_normalize(acc, inv0, inv1, a.nf);
    scale_shift(acc, ln_s, ln_b, t);

    if (a.e_out != nullptr) {  // e' = T(e + msg), staged in the hs slot (consumed)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int c = nb * 8 + 2 * t;
        const float2 eg = unpack(frag_pair(ea, nb, 0)), eg8 = unpack(frag_pair(ea, nb, 1));
        sts32(smem, st_hs + swz_pair<F>(g, c), pack(eg.x + acc[nb][0], eg.y + acc[nb][1]));
        sts32(smem, st_hs + swz_pair<F>(g + 8, c),
              pack(eg8.x + acc[nb][2], eg8.y + acc[nb][3]));
      }
      __syncwarp();
      store_slice<F>(a.e_out, s0, r_hi, smem, st_hs, lane);
    }
    __syncwarp();  // the slot is refilled by the next issue

    // agg: the masked messages summed per receiver, in row order
    const float mg = __shfl_sync(lbt::kFullMask, m_row, g);
    const float mg8 = __shfl_sync(lbt::kFullMask, m_row, g + 8);
    const int64_t first = s0 / K, last = ((s0 + SR < r_hi ? s0 + SR : r_hi) - 1) / K;
    for (int64_t i = first; i <= last; ++i) {
      if (i != cur) {
        flush();
        cur = i;
#pragma unroll
        for (int h = 0; h < NH; ++h) own[h][0] = own[h][1] = 0.f;
      }
      const bool in_g = vg && ig == i, in_g8 = vg8 && ig8 == i;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          colsum_add(own, (in_g ? acc[nb][jj] * mg : 0.f) + (in_g8 ? acc[nb][2 + jj] * mg8 : 0.f),
                     nb, jj, g);
    }
  }
  flush();
}

// Launch `kern` with `smem` bytes of dynamic shared memory; returns the
// CUDA error code.
template <typename Kern, typename A>
int launch_kernel(Kern kern, int grid, int threads, int smem, const A& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
