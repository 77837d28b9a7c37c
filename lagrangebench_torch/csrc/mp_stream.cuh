// The stream design: the bf16 fused message-passing kernels at the wide
// instances F = 192 and 256 (K3/K8/E2 forward in fused_mp.cu, K4 backward in
// fused_mp_bwd.cu).
//
// At these widths the warp design (mp_warp.cuh) does not fit: its chain
// keeps each product's A operand in registers beside the accumulator (~F
// registers per lane together), and its two resident F x F weights take 4 F^2
// bytes (256 KB at F = 256, past a block's 227 KB of shared memory). The
// stream design keeps what makes the warp design fast and moves the rest:
// - a warp owns a 16-row slice through every product, its float32
//   accumulator for the whole width in registers (F / 2 per lane, 128 at F =
//   256), so each LayerNorm and its backward reduce inside the warp (quad
//   shuffles) and no row statistic crosses warps;
// - the A operand of each product is a swizzled bf16 slice in one of the
//   warp's two slots of shared memory (mp_warp.cuh's tile layout), read by
//   ldmatrix at each 16-deep step; each epilogue writes the next product's
//   operand into a slot in place, and edge and node rows arrive there by
//   cp.async;
// - the weights stream through a block-wide ring of STAGES slabs of KS = 32
//   weight rows (16 KB a stage at F = 256) by cp.async, issued STAGES - 1
//   slabs ahead with one __syncthreads per slab, and the block's 8 warps
//   (128 rows) share each slab. A @ W reads W's row blocks as k-slabs (slab
//   q: W[32 q : 32 q + 32, :]); A @ W^T reads W's column blocks as the
//   k-slabs of W^T (slab q: W[:, 32 q : 32 q + 32], F rows of 64 bytes), so
//   both read each A fragment once.
// The warps of a block walk the ring in step: a warp without a slice left
// still takes each slab's barrier. Every order of summation is fixed.
#pragma once

#include "mp_warp.cuh"

namespace {

constexpr int KS = 32;     // weight rows of one slab
constexpr int STAGES = 4;  // slabs of the ring

template <int F, int NS = STAGES>
struct Stream {
  static_assert(F % 64 == 0, "whole slabs and swizzle rows");
  static constexpr int SLAB_BYTES = KS * Tile<F>::ROW_BYTES;  // 16 KB at F = 256
  static constexpr int SLABS = F / KS;                        // slabs of one F x F weight
  static constexpr int RING_BYTES = NS * SLAB_BYTES;          // a ring of NS stages
  static constexpr int SLOTS_BYTES = WARPS * 2 * Tile<F>::SLICE_BYTES;  // two per warp
};

// byte offset of 16-byte chunk c (< 4) of row r in a column block (rows of KS
// bf16, 64 bytes), swizzled so that ldmatrix's 8-row reads hit distinct banks
__device__ __forceinline__ u32 swz_col(int r, int c) {
  return r * (KS * 2) + ((c ^ ((r >> 1) & 3)) << 4);
}

// Stage the column block W[:, 0 : KS] of an F x F row-major weight (src =
// W + the block's first column) by the whole block.
template <int F>
__device__ __forceinline__ void stage_cols(u32 dst, const bf16* src) {
  constexpr int CH = KS / 8;
  for (int i = threadIdx.x; i < F * CH; i += blockDim.x) {
    const int r = i / CH, c = i % CH;
    cp_async16(dst + swz_col(r, c), src + r * F + c * 8, true);
  }
}

// The block's weight ring of NS stages at shared address `base`: the weights
// seq[0..nseq) stream in that order, SLABS slabs each, once per iteration of
// the block's loop, as row blocks, or as column blocks where bit i of
// `cols` is set (the transposed products); slab s of `total` lies in stage
// s % NS.
template <int F, int NS = STAGES>
struct Ring {
  const bf16* seq[6];
  int nseq, cols, total, s;
  u32 base;

  __device__ __forceinline__ void issue(int i) const {  // by the whole block
    if (i >= total) return;
    const int r = i % (nseq * Stream<F>::SLABS), w = r / Stream<F>::SLABS;
    const int q = r % Stream<F>::SLABS;
    const u32 dst = base + (i % NS) * Stream<F>::SLAB_BYTES;
    if ((cols >> w) & 1) stage_cols<F>(dst, seq[w] + q * KS);
    else stage_rows<F>(dst, seq[w] + q * KS * F, KS, KS);
  }
  // the first NS - 1 slabs of `iters` iterations, a cp.async group each
  __device__ __forceinline__ void start(int iters) {
    s = 0;
    total = iters * nseq * Stream<F>::SLABS;
    for (int i = 0; i < NS - 1; ++i) {
      issue(i);
      cp_commit();
    }
  }
  // Waits for slab s (with `drain`, for every cp.async group of the thread:
  // an iteration's rows), brings the block in step, refills the stage that
  // slab s - 1 left, and returns slab s's shared address. Groups committed
  // between slabs only make the next waits stricter.
  __device__ __forceinline__ u32 next(bool drain) {
    if (drain) cp_wait<0>();
    else cp_wait<NS - 2>();
    __syncthreads();
    issue(s + NS - 1);
    cp_commit();
    return base + (s++ % NS) * Stream<F>::SLAB_BYTES;
  }
};

// acc += A @ W over k-slab q of W (rows [KS q, KS q + KS), shared address w);
// A the warp's swizzled slice at shared address a
template <int NB>
__device__ __forceinline__ void slab_mma(float (&acc)[NB][4], u32 a, u32 w, int q, int lane) {
  constexpr int F = 8 * NB;
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    u32 x[4];
    ldsm(x, a + swz<F>(lane & 15, (q * (KS / 16) + kk) * 2 + (lane >> 4)));
    const int k = kk * 16 + (lane & 7) + (lane & 8);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      u32 b[4];
      ldsm_t(b, w + swz<F>(k, np * 2 + (lane >> 4)));
      mma(acc[2 * np], x, b[0], b[1]);
      mma(acc[2 * np + 1], x, b[2], b[3]);
    }
  }
}

// acc += A @ W^T over k-slab q of W^T (the column block W[:, KS q : KS q +
// KS] at shared address w, stage_cols' layout)
template <int NB>
__device__ __forceinline__ void slab_mma_t(float (&acc)[NB][4], u32 a, u32 w, int q, int lane) {
  constexpr int F = 8 * NB;
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    u32 x[4];
    ldsm(x, a + swz<F>(lane & 15, (q * (KS / 16) + kk) * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      u32 b[4];
      ldsm(b, w + swz_col(np * 16 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)));
      mma(acc[2 * np], x, b[0], b[1]);
      mma(acc[2 * np + 1], x, b[2], b[3]);
    }
  }
}

// acc += A @ W (TRANS: A @ W^T) for the ring's next weight, A the warp's slice
// at shared address a; `live`: the warp has a slice this iteration (else it
// only keeps the block in step); `drain`: the first slab waits for every
// cp.async group (the rows of the iteration).
template <bool TRANS, int NB, int NS>
__device__ __forceinline__ void product(float (&acc)[NB][4], Ring<8 * NB, NS>& ring, u32 a,
                                        bool live, bool drain, int lane) {
#pragma unroll 1  // one slab's code: the slab index only moves the A operand
  for (int q = 0; q < Stream<8 * NB>::SLABS; ++q) {
    const u32 w = ring.next(drain && q == 0);
    if (live) {
      if constexpr (TRANS) slab_mma_t(acc, a, w, q, lane);
      else slab_mma(acc, a, w, q, lane);
    }
  }
}

// Column sums over a slice's 16 rows, eight n-blocks at a time: v[k] holds
// this lane's rows g and g + 8 of column (nb0 + k) * 8 + 2t + j, already
// added, for the n-blocks nb0 .. nb0 + 7 of one j. A reduce-scatter over the
// 8 lanes of each t (lane bits 4, 3, 2: 7 shuffles for the 8 sums, against
// colsum_add's 3 per sum) leaves in lane (g, t) the sum of column (nb0 + g) *
// 8 + 2t + j, the column it owns (as colsum_add's owner lanes). The order
// of the additions is fixed.
__device__ __forceinline__ float colsum8(const float (&v)[8], int g) {
  const bool b2 = (g >> 2) & 1, b1 = (g >> 1) & 1, b0 = g & 1;
  float w[4], u[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (b2 ? v[i + 4] : v[i]) + __shfl_xor_sync(lbt::kFullMask, b2 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    u[i] = (b1 ? w[i + 2] : w[i]) + __shfl_xor_sync(lbt::kFullMask, b1 ? w[i] : w[i + 2], 8);
  return (b0 ? u[1] : u[0]) + __shfl_xor_sync(lbt::kFullMask, b0 ? u[0] : u[1], 4);
}

// colsum8's sum added by its owner lane to row[(nb0 + g) * 8 + 2t + j] in
// shared memory
__device__ __forceinline__ void colsum8_to(float* row, const float (&v)[8], int nb0, int j, int g,
                                           int t) {
  const float sum = colsum8(v, g);
  row[(nb0 + g) * 8 + 2 * t + j] += sum;
}

// cp.async of rows [s0, s0 + 16) of a row-major (rows, F) bf16 tensor into
// the warp's slice at shared address dst, zero past r_hi
template <int F>
__device__ __forceinline__ void copy_slice(u32 dst, const bf16* src, int64_t s0, int64_t r_hi,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < Tile<F>::CP_ITERS; ++i) {
    int r, c;
    slice_chunk<F>(lane, i, r, c);
    const bool v = s0 + r < r_hi;
    cp_async16(dst + swz<F>(r, c), v ? src + (s0 + r) * F + c * 8 : src, v);
  }
}

// a warp's receiver range: the block's even share of n, split evenly
__device__ __forceinline__ void block_warp_range(int n, int blk, int blocks, int w, int64_t& lo,
                                                 int64_t& hi) {
  const int64_t b0 = (int64_t)n * blk / blocks, b1 = (int64_t)n * (blk + 1) / blocks;
  lo = b0 + (b1 - b0) * w / WARPS;
  hi = b0 + (b1 - b0) * (w + 1) / WARPS;
}

// the most 16-row slices of k edge rows per receiver that a warp of this
// block owns (block_warp_range)
__device__ __forceinline__ int block_iters(int n, int k) {
  int it = 0;
  for (int w = 0; w < WARPS; ++w) {
    int64_t lo, hi;
    block_warp_range(n, blockIdx.x, gridDim.x, w, lo, hi);
    it = max(it, (int)(((hi - lo) * k + SR - 1) / SR));
  }
  return it;
}

// cp.async of the sender rows of edge rows [s0, s0 + 16) into the slice at
// shared address dst (K3: rows of the gathered tensor; K8, E2: the rows of
// hs_ext that the stencil table or the windows select, zero where padded);
// returns, in lane r < 16, row r's mask (K3: the mask; K8, E2: 1 where the
// row has a sender)
template <int F, Src SRC>
__device__ __forceinline__ float copy_senders(const EdgeArgs& a, u32 dst, int64_t s0,
                                              int64_t r_hi, int lane) {
  const int64_t rr = s0 + (lane & 15);
  const bool rv = rr < r_hi;
  int src = -1;
  if constexpr (SRC == Src::kSlot) {
    if (rv) {
      const int c = a.cand[rr];
      const int col = (int)(rr / a.k) / a.C;
      src = c < a.S * a.C ? a.bases_ext[col * a.S + c / a.C] * a.C + c % a.C : -1;
    }
  } else if constexpr (SRC == Src::kWindow) {
    if (rv) {
      const int i = (int)(rr / a.k);
      const int64_t win = ((int64_t)(i / a.T) * (a.T / a.SUB) + (i % a.T) / a.SUB) * 3;
      const int c = a.cand[rr];
      src = c < 3 * a.WSUB ? a.w0s[win + c / a.WSUB] * 8 + c % a.WSUB : -1;
    }
  }
  if constexpr (SRC == Src::kGathered) {
    copy_slice<F>(dst, a.hs, s0, r_hi, lane);
    return rv ? a.mask[rr] : 0.f;
  } else {
#pragma unroll
    for (int i = 0; i < Tile<F>::CP_ITERS; ++i) {
      int r, c;
      slice_chunk<F>(lane, i, r, c);
      const int sr = __shfl_sync(lbt::kFullMask, src, r);
      cp_async16(dst + swz<F>(r, c), sr >= 0 ? a.hs + (int64_t)sr * F + c * 8 : a.hs, sr >= 0);
    }
    return src >= 0 ? 1.f : 0.f;
  }
}

// n-blocks that an epilogue takes at a time: their loads from device memory
// are issued together before their values are used, and colsum8 reduces
// their column sums together
constexpr int LB = 8;

// The first product's epilogue of an edge step, in place in the slice at
// offset `x`: x <- T(relu(acc + x + hr[receiver] + b1)), 0 on rows past r_hi
// (x holds the sender rows hs on entry)
template <int NB>
__device__ __forceinline__ void relu_first(const float (&acc)[NB][4], unsigned char* smem, u32 x,
                                           const bf16* hr, const float* b1, bool vg, bool vg8,
                                           int64_t ig, int64_t ig8, int lane) {
  constexpr int F = 8 * NB;
  static_assert(NB % LB == 0 && LB == 8, "whole batches of colsum8's eight n-blocks");
  const int g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
#pragma unroll
  for (int b0 = 0; b0 < NB; b0 += LB) {
    u32 hp[LB][2];  // hr's pairs of rows g, g + 8 in this batch
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int c = (b0 + i) * 8 + 2 * t;
      hp[i][0] = vg ? ldg32(hr + ig * F + c) : 0u;
      hp[i][1] = vg8 ? (ig8 == ig && vg ? hp[i][0] : ldg32(hr + ig8 * F + c)) : 0u;
    }
#pragma unroll
    for (int kb = b0 / 2; kb < (b0 + LB) / 2; ++kb) {
      u32 h4[4];
      ldsm(h4, sb + x + swz<F>(lane & 15, kb * 2 + (lane >> 4)));
      __syncwarp();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int nb = 2 * kb + hf, c = nb * 8 + 2 * t;
        const float2 s_g = unpack(h4[2 * hf]), s_g8 = unpack(h4[2 * hf + 1]);
        const float2 r_g = unpack(hp[nb - b0][0]), r_g8 = unpack(hp[nb - b0][1]);
        sts32(smem, x + swz_pair<F>(g, c),
              vg ? pack(fmaxf(acc[nb][0] + s_g.x + r_g.x + b1[c], 0.f),
                        fmaxf(acc[nb][1] + s_g.y + r_g.y + b1[c + 1], 0.f))
                 : 0u);
        sts32(smem, x + swz_pair<F>(g + 8, c),
              vg8 ? pack(fmaxf(acc[nb][2] + s_g8.x + r_g8.x + b1[c], 0.f),
                         fmaxf(acc[nb][3] + s_g8.y + r_g8.y + b1[c + 1], 0.f))
                  : 0u);
      }
    }
  }
  __syncwarp();
}

// the accumulator's rows, rounded to bf16, into the slice at offset x
template <int NB>
__device__ __forceinline__ void put_pairs(const float (&acc)[NB][4], unsigned char* smem, u32 x,
                                          int lane) {
  constexpr int F = 8 * NB;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    sts32(smem, x + swz_pair<F>(g, c), pack(acc[nb][0], acc[nb][1]));
    sts32(smem, x + swz_pair<F>(g + 8, c), pack(acc[nb][2], acc[nb][3]));
  }
}

// x <- T(x + acc) in place in the slice at offset x (a residual add)
template <int NB>
__device__ __forceinline__ void add_pairs(const float (&acc)[NB][4], unsigned char* smem, u32 x,
                                          int lane) {
  constexpr int F = 8 * NB;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    const int c = nb * 8 + 2 * t;
    const float2 q = unpack(lds32(smem, x + swz_pair<F>(g, c)));
    const float2 q8 = unpack(lds32(smem, x + swz_pair<F>(g + 8, c)));
    sts32(smem, x + swz_pair<F>(g, c), pack(q.x + acc[nb][0], q.y + acc[nb][1]));
    sts32(smem, x + swz_pair<F>(g + 8, c), pack(q8.x + acc[nb][2], q8.y + acc[nb][3]));
  }
}

template <int F, bool ENC>
struct EdgeStreamSmem {
  static constexpr int kSlots = Stream<F>::RING_BYTES;
  static constexpr int kEnc1 = kSlots + Stream<F>::SLOTS_BYTES;          // 16 rows of enc_w1
  static constexpr int kVec = kEnc1 + (ENC ? Tile<F>::SLICE_BYTES : 0);  // 8 float vectors
  static constexpr int kBytes = kVec + 8 * F * 4;
  static_assert(kBytes <= kSmemMax, "stream edge kernel shared memory");
};

// ---------------------------------------------------------------------------
// The edge half of one fused step, forward, in the stream design (K3, K8,
// E2; and K4's first rematerialization), computing what edge_fwd
// (mp_warp.cuh) computes: e' to device memory unless null, agg (float32,
// summed per receiver by the warp that owns it, in row order) for the node
// half. Persistent: a block per SM; each warp owns a contiguous range of
// receivers (block_warp_range) and takes one 16-row slice of it per
// iteration. Slots: s_e holds e (ENC: T(LN(...)), the encoder's output),
// s_x the sender rows, then T(relu(first)) (ENC: first T(h1)). The ring
// streams (enc_w2,) W_e, W2 per iteration.
// ---------------------------------------------------------------------------
template <int F, bool ENC, Src SRC>
__device__ __forceinline__ void edge_fwd_stream(const EdgeArgs& a) {
  using S = EdgeStreamSmem<F, ENC>;
  using D = Tile<F>;
  constexpr int NB = D::NB, NH = D::NH, SLICE = D::SLICE_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  const bf16* e = static_cast<const bf16*>(a.e);
  const float* raw = static_cast<const float*>(a.e);

  if constexpr (ENC) stage_rows<F>(sb + S::kEnc1, a.enc_w1, SR, a.fe);
  float* vec = reinterpret_cast<float*>(smem + S::kVec);
  for (int i = threadIdx.x; i < 8 * F; i += THREADS)
    vec[i] = i < 4 * F ? a.vec[i / F][i % F] : (ENC ? a.enc_vec[i / F - 4][i % F] : 0.f);
  const float *b1 = vec, *b2 = vec + F, *ln_s = vec + 2 * F, *ln_b = vec + 3 * F;

  const int K = a.k;
  int64_t rc0, rc1;
  block_warp_range(a.n, blockIdx.x, gridDim.x, warp, rc0, rc1);
  const int64_t r_lo = rc0 * K, r_hi = rc1 * K;
  const int mine = (int)((r_hi - r_lo + SR - 1) / SR);
  const u32 s_e = S::kSlots + warp * 2 * SLICE, s_x = s_e + SLICE;

  Ring<F> ring;
  ring.base = sb;
  ring.nseq = 0;
  ring.cols = 0;
  if constexpr (ENC) ring.seq[ring.nseq++] = a.enc_w2;
  ring.seq[ring.nseq++] = a.w_e;
  ring.seq[ring.nseq++] = a.w2;
  const int iters = block_iters(a.n, K);
  ring.start(iters);  // the enc_w1 copy rides in the first group
  cp_wait<0>();
  __syncthreads();  // enc_w1 and the vectors in place

  float m_next = 0.f, raw_next[8];
  auto load_raw = [&](int64_t s0) {  // rows g, g + 8; k = 2t (+1), 8 + 2t (+1)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t row = s0 + g + ((i >> 1) & 1) * 8;
      const int kk = (i >> 2) * 8 + 2 * t + (i & 1);
      raw_next[i] = row < r_hi && kk < a.fe ? raw[row * a.fe + kk] : 0.f;
    }
  };
  if (mine > 0) {
    if constexpr (ENC) {
      load_raw(r_lo);
    } else {
      copy_slice<F>(sb + s_e, e, r_lo, r_hi, lane);
      m_next = copy_senders<F, SRC>(a, sb + s_x, r_lo, r_hi, lane);
    }
  }
  cp_commit();

  int64_t cur = -1;  // the receiver whose agg `own` holds
  float own[NH][2] = {};
  auto flush = [&]() {
    if (cur >= 0) store_own(a.agg + cur * F, own, g, t);
  };
  float acc[NB][4];
  for (int j = 0; j < iters; ++j) {
    const bool live = j < mine;
    const int64_t s0 = r_lo + (int64_t)j * SR;
    const bool vg = s0 + g < r_hi, vg8 = s0 + g + 8 < r_hi;
    const int64_t ig = vg ? (s0 + g) / K : 0, ig8 = vg8 ? (s0 + g + 8) / K : 0;
    float m_row = m_next;
    if constexpr (ENC) {
      // e = T(LN(relu(raw @ enc_w1 + enc_b1) @ enc_w2 + enc_b2)) -> s_e
      if (live) {
        const u32 a1[4] = {pack(raw_next[0], raw_next[1]), pack(raw_next[2], raw_next[3]),
                           pack(raw_next[4], raw_next[5]), pack(raw_next[6], raw_next[7])};
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
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const int c = nb * 8 + 2 * t;
          sts32(smem, s_x + swz_pair<F>(g, c),
                pack(fmaxf(acc[nb][0] + eb1[c], 0.f), fmaxf(acc[nb][1] + eb1[c + 1], 0.f)));
          sts32(smem, s_x + swz_pair<F>(g + 8, c),
                pack(fmaxf(acc[nb][2] + eb1[c], 0.f), fmaxf(acc[nb][3] + eb1[c + 1], 0.f)));
        }
      }
      __syncwarp();
      zero(acc);
      product<false>(acc, ring, sb + s_x, live, true, lane);
      if (live) {
        add_bias(acc, vec + 5 * F, t);
        float i0, i1;
        row_normalize(acc, i0, i1, a.nf);
        scale_shift(acc, vec + 6 * F, vec + 7 * F, t);
        put_pairs(acc, smem, s_e, lane);
        __syncwarp();  // the enc_w2 product is done with T(h1): the senders go there
        m_row = copy_senders<F, SRC>(a, sb + s_x, s0, r_hi, lane);
      }
      cp_commit();  // waited for by the third slab of W_e
      __syncwarp();
    }

    // first = e @ W_e + hs + hr + b1 -> T(relu(first)), in s_x
    zero(acc);
    product<false>(acc, ring, sb + s_e, live, !ENC, lane);
    if (live) relu_first(acc, smem, s_x, a.hr, b1, vg, vg8, ig, ig8, lane);

    // msg = LN1(T(relu(first)) @ W2 + b2)
    zero(acc);
    product<false>(acc, ring, sb + s_x, live, false, lane);
    if (live) {
      add_bias(acc, b2, t);
      float inv0, inv1;
      row_normalize(acc, inv0, inv1, a.nf);
      scale_shift(acc, ln_s, ln_b, t);
      if (a.e_out != nullptr) {  // e' = T(e + msg), in place in s_e
        add_pairs(acc, smem, s_e, lane);
        __syncwarp();
        store_slice<F>(a.e_out, s0, r_hi, smem, s_e, lane);
      }
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
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              v[k] = (in_g ? acc[8 * h + k][jj] * mg : 0.f) +
                     (in_g8 ? acc[8 * h + k][2 + jj] * mg8 : 0.f);
            own[h][jj] += colsum8(v, g);
          }
      }
      __syncwarp();  // both slots are refilled below
      if (j + 1 < mine) {  // the next slice's rows, waited for by its first slab
        if constexpr (ENC) {
          load_raw(s0 + SR);
        } else {
          copy_slice<F>(sb + s_e, e, s0 + SR, r_hi, lane);
          m_next = copy_senders<F, SRC>(a, sb + s_x, s0 + SR, r_hi, lane);
        }
      }
    }
    cp_commit();
  }
  flush();
  cp_wait<0>();
}

}  // namespace
