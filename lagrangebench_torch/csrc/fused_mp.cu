// K3: one fused GNS message-passing step (forward), dense (N, K) layout;
// K8: the same step in column-slot order; E2: the same step with each
// edge's sender row selected from per-sub-tile windows.
//
// Replaces: lagrangebench_tpu/ops/fused_mp.py::_make_fused_kernel (math in
// _mp_math), launched by _launch_fused (K3), ::_make_slot_kernel, launched
// by _launch_fused_slot (K8), and scripts/experiments/window_select.py::
// make_window_kernel (E2). Per receiver, with F = 128:
//
//   [step 0]  e = LN(relu(raw @ enc_w1 + enc_b1) @ enc_w2 + enc_b2)  (ENC)
//   first = e @ W_e + hs_gath + hr + b1
//   msg   = LN(relu(first) @ W2 + b2)
//   e'    = e + msg
//   agg   = sum_K msg * mask
//   h'    = h + LN(relu(h @ W_nh + agg @ W_na + bn1) @ W_n2 + bn2)
//
// with the TPU kernel's casts: products of compute-type (bf16) operands
// accumulate in float32; relu(first) and agg are cast to the compute type
// before their products; e' = T(e + msg); h' = T(h + LN(y)); LayerNorm in
// float32 with eps 1e-5. A float32 instance (no tensor cores, CUDA-core
// FMAs) exists to check the arithmetic against the plain version with TF32
// off; the main path runs the bf16 instance.
//
// Bound on an H100: bytes. Per edge row it reads e and hs_gath (2 x 256 B
// in bf16) and writes e' (256 B) for 2 x 128 x 128 x 2 = 65.5 kFLOP, about
// 85 FLOP/B against the card's ~295 FLOP/B balance point for bf16.
//
// K8 (SLOT) computes the same step on the slot layout's n_ext rows, with
// the sender term of each edge read in-kernel instead of from a gathered
// (N, K, F) tensor: receiver row r lies in column t = r / C, and its
// candidate c = cand[r, k] is, when c < S*C, the sender in slot
// bases_ext[t, c / C] * C + c % C, whose row of hs_ext (the (n_ext, F)
// sender projection, ~3 MB in bf16 at 8k particles, resident in the 50 MB
// L2) is read from global memory; otherwise the term and the mask are 0.
// The TPU kernel selects these rows with a one-hot MXU contraction over the
// S*C stencil candidates (Mosaic has no row gather); a row read is the
// Hopper form of the same select.
//
// E2 (WINDOW) keeps compact, cell-sorted receiver rows and reads each
// sender row of hs_ext (the ghost-extended (n_ext, F) sender projection,
// ~2-3 MB in bf16 at 8k particles, L2-resident) the same way: for edge row
// r of receiver i = r / K, tile t = i / T and sub-tile u = (i % T) / SUB,
// its candidate c = cand[r] is, when c < 3*WSUB, the row
// w0s[t, u, c / WSUB] * 8 + c % WSUB; otherwise the term and the mask are
// 0. The TPU kernel DMAs the three windows of each sub-tile into VMEM and
// selects with a one-hot MXU contraction, exact in bf16 (one nonzero
// product per sum), so a row read computes the same values. Staging the
// windows in shared memory (3 * WSUB * F * 2 B per sub-tile, WSUB a few
// hundred rows) is left out: it would not fit beside the 177 KB of the bf16
// instance.
//
// Design: one block of 8 warps per tile of 16 receivers. Edge rows stream
// through shared memory 64 at a time, so the tile's e/hs/e' never hold more
// than one chunk; the products are bf16 nvcuda::wmma 16x16x16 tiles with
// float32 accumulators; LayerNorm takes one warp per row with shuffle
// reductions; the K-sum runs in float32, row by row in k order (so it is
// the same on every run). The edge-phase weights (W_e, W2, and enc_w2 on
// step 0) sit in shared memory during the edge phase and are replaced by
// the node-phase weights (W_nh, W_na, W_n2) afterwards: five 128x128 bf16
// matrices never need to be resident at once. Simple first: no TMA, no
// wgmma, one block per SM (177 KB of shared memory in the bf16 instance).
#include "mp_common.cuh"

namespace {

constexpr int TR = 16;       // receivers per block
constexpr int M = 64;        // edge rows per chunk

struct Args {
  const void* e;      // (N, K, F) T, or raw (N, K, fe) float32 with ENC
  const void* hs;     // (N, K, F) T: gathered sender projections
  const void* hr;     // (N, F) T: receiver projections
  const void* h;      // (N, F) T: node latents
  const float* mask;  // (N, K)
  void* e_out;        // (N, K, F) T
  void* h_out;        // (N, F) T
  const void* w[5];   // W_e, W2, W_nh, W_na, W_n2: (F, F) T, row-major (in, out)
  const float* vec[8];  // b1, b2, ln1 scale, ln1 bias, bn1, bn2, ln2 scale, ln2 bias
  const void* enc_w1;   // (fe, F) T
  const void* enc_w2;   // (F, F) T
  const float* enc_vec[4];  // enc_b1, enc_b2, enc LN scale, enc LN bias
  const int32_t* cand;       // K8: (n_ext, K) stencil-candidate ids, fill S*C;
                             // E2: (n_rows, K) window-candidate ids, fill 3*WSUB
  const int32_t* bases_ext;  // K8: (n_cols+1, S) stencil table (+ sentinel row)
  const int32_t* w0s;        // E2: (n_rows/T, T/SUB, 3) window starts, 8-row units
  int n, k, fe;
  int C, S;  // K8: column capacity, stencil columns
  int T, SUB, WSUB;  // E2: rows per tile and sub-tile, window rows
};

// Where a step's sender rows come from: a gathered (N, K, F) tensor (K3),
// the slot layout's stencil table (K8) or the sub-tile windows (E2).
enum class Src { kGathered, kSlot, kWindow };

template <typename T>
struct Smem {
  static constexpr int LDA = Layout<T>::LDA;
  static constexpr int kW = Layout<T>::kStageWeights ? F * LDA * (int)sizeof(T) : 0;
  static constexpr int kA = M * LDA * (int)sizeof(T);
  static constexpr int kF = M * LDF * 4;
  static constexpr int kAgg = TR * F * 4;
  static constexpr int kBytes = 3 * kW + 2 * kA + kF + kAgg;
};

template <typename T, bool ENC, Src SRC>
__global__ void __launch_bounds__(THREADS, 1) fused_mp(const Args a) {
  constexpr bool kSelect = SRC != Src::kGathered;  // sender rows read in-kernel
  constexpr int LDA = Layout<T>::LDA;
  constexpr bool kStage = Layout<T>::kStageWeights;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sW0 = reinterpret_cast<T*>(smem);
  T* sW1 = reinterpret_cast<T*>(smem + Smem<T>::kW);
  T* sW2 = reinterpret_cast<T*>(smem + 2 * Smem<T>::kW);
  T* sA = reinterpret_cast<T*>(smem + 3 * Smem<T>::kW);
  T* sB = reinterpret_cast<T*>(smem + 3 * Smem<T>::kW + Smem<T>::kA);
  float* sF = reinterpret_cast<float*>(smem + 3 * Smem<T>::kW + 2 * Smem<T>::kA);
  float* sAgg = reinterpret_cast<float*>(smem + 3 * Smem<T>::kW + 2 * Smem<T>::kA +
                                         Smem<T>::kF);
  __shared__ int sSrc[kSelect ? M : 1];  // K8, E2: the chunk's sender rows, -1 if padded

  const int K = a.k;
  const int node0 = blockIdx.x * TR;
  const int nodes = min(TR, a.n - node0);
  const int rows_tile = nodes * K;
  const int64_t row0 = (int64_t)node0 * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const T* hs = static_cast<const T*>(a.hs);
  const T* hr = static_cast<const T*>(a.hr);
  const T* h = static_cast<const T*>(a.h);
  T* e_out = static_cast<T*>(a.e_out);

  // edge-phase weights: W_e and W2 (+ enc_w2 on step 0)
  const T* wE = static_cast<const T*>(a.w[0]);
  const T* w2 = static_cast<const T*>(a.w[1]);
  const T* wEnc2 = static_cast<const T*>(a.enc_w2);
  if constexpr (kStage) {
    stage_weight<T>(sW0, a.w[0]);
    stage_weight<T>(sW1, a.w[1]);
    if (ENC) stage_weight<T>(sW2, a.enc_w2);
    wE = sW0;
    w2 = sW1;
    wEnc2 = sW2;
  }
  for (int i = threadIdx.x; i < TR * F; i += THREADS) sAgg[i] = 0.f;

  for (int c0 = 0; c0 < rows_tile; c0 += M) {
    const int rows = min(M, rows_tile - c0);
    const int rows_pad = (rows + 15) / 16 * 16;
    __syncthreads();  // previous chunk done with sA/sB/sF; weights staged
    if constexpr (SRC == Src::kSlot) {
      const int cw = a.S * a.C;
      for (int r = threadIdx.x; r < rows; r += THREADS) {
        const int64_t er = row0 + c0 + r;
        const int t = (node0 + (c0 + r) / K) / a.C;
        const int c = a.cand[er];
        sSrc[r] = c < cw ? a.bases_ext[t * a.S + c / a.C] * a.C + c % a.C : -1;
      }
    } else if constexpr (SRC == Src::kWindow) {
      const int cw = 3 * a.WSUB;
      for (int r = threadIdx.x; r < rows; r += THREADS) {
        const int64_t er = row0 + c0 + r;
        const int i = node0 + (c0 + r) / K;
        const int64_t win = ((int64_t)(i / a.T) * (a.T / a.SUB) + (i % a.T) / a.SUB) * 3;
        const int c = a.cand[er];
        sSrc[r] = c < cw ? a.w0s[win + c / a.WSUB] * 8 + c % a.WSUB : -1;
      }
    }  // read after the __syncthreads that ends (a)

    // (a) the chunk's edge latents e -> sA
    if constexpr (ENC) {
      const float* raw = static_cast<const float*>(a.e);
      const T* w1 = static_cast<const T*>(a.enc_w1);
      for (int i = threadIdx.x; i < rows_pad * F; i += THREADS) {
        const int r = i / F, c = i % F;
        float x = 0.f;
        if (r < rows) {
          const float* rr = raw + (row0 + c0 + r) * a.fe;
          for (int j = 0; j < a.fe; ++j) x += to_f(from_f<T>(rr[j])) * to_f(w1[j * F + c]);
          x = fmaxf(x + a.enc_vec[0][c], 0.f);
        }
        sB[r * LDA + c] = from_f<T>(x);
      }
      __syncthreads();
      block_gemm<T>(sB, wEnc2, sF, rows_pad, false);
      __syncthreads();
      for (int r = warp; r < rows_pad; r += WARPS) {
        float x[F / 32];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          const int c = lane + 32 * i;
          x[i] = sF[r * LDF + c] + a.enc_vec[1][c];
        }
        warp_layernorm(x, a.enc_vec[2], a.enc_vec[3], lane);
#pragma unroll
        for (int i = 0; i < F / 32; ++i) sA[r * LDA + lane + 32 * i] = from_f<T>(x[i]);
      }
    } else {
      const T* e = static_cast<const T*>(a.e);
      constexpr int V = 16 / sizeof(T);
      for (int i = threadIdx.x; i < rows_pad * (F / V); i += THREADS) {
        const int r = i / (F / V), c = (i % (F / V)) * V;
        int4 v = make_int4(0, 0, 0, 0);
        if (r < rows) v = *reinterpret_cast<const int4*>(e + (row0 + c0 + r) * F + c);
        *reinterpret_cast<int4*>(sA + r * LDA + c) = v;
      }
    }
    __syncthreads();

    // (b) first = e @ W_e -> sF
    block_gemm<T>(sA, wE, sF, rows_pad, false);
    __syncthreads();

    // (c) + hs + hr + b1, relu, cast -> sB
    for (int i = threadIdx.x; i < rows_pad * F; i += THREADS) {
      const int r = i / F, c = i % F;
      float x = 0.f;
      if (r < rows) {
        const int64_t er = row0 + c0 + r;
        const int64_t node = node0 + (c0 + r) / K;
        if constexpr (kSelect) {
          const int src = sSrc[r];
          x = sF[r * LDF + c] + (src >= 0 ? to_f(hs[(int64_t)src * F + c]) : 0.f);
        } else {
          x = sF[r * LDF + c] + to_f(hs[er * F + c]);
        }
        x = x + to_f(hr[node * F + c]) + a.vec[0][c];
        x = fmaxf(x, 0.f);
      }
      sB[r * LDA + c] = from_f<T>(x);
    }
    __syncthreads();

    // (d) relu(first) @ W2 -> sF
    block_gemm<T>(sB, w2, sF, rows_pad, false);
    __syncthreads();

    // (e) msg = LN(. + b2); e' = T(e + msg); sF <- msg * mask
    for (int r = warp; r < rows; r += WARPS) {
      const int64_t er = row0 + c0 + r;
      float x[F / 32];
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        const int c = lane + 32 * i;
        x[i] = sF[r * LDF + c] + a.vec[1][c];
      }
      warp_layernorm(x, a.vec[2], a.vec[3], lane);
      float m;
      if constexpr (kSelect) m = sSrc[r] >= 0 ? 1.f : 0.f;
      else m = a.mask[er];
#pragma unroll
      for (int i = 0; i < F / 32; ++i) {
        const int c = lane + 32 * i;
        e_out[er * F + c] = from_f<T>(to_f(sA[r * LDA + c]) + x[i]);
        sF[r * LDF + c] = x[i] * m;
      }
    }
    __syncthreads();

    // (f) agg += the chunk's masked messages, row by row in k order
    if (threadIdx.x < F) {
      const int c = threadIdx.x;
      for (int r = 0; r < rows; ++r) sAgg[((c0 + r) / K) * F + c] += sF[r * LDF + c];
    }
  }
  __syncthreads();

  // node phase: weights W_nh, W_na, W_n2
  const T* wNh = static_cast<const T*>(a.w[2]);
  const T* wNa = static_cast<const T*>(a.w[3]);
  const T* wN2 = static_cast<const T*>(a.w[4]);
  if constexpr (kStage) {
    stage_weight<T>(sW0, a.w[2]);
    stage_weight<T>(sW1, a.w[3]);
    stage_weight<T>(sW2, a.w[4]);
    wNh = sW0;
    wNa = sW1;
    wN2 = sW2;
  }
  for (int i = threadIdx.x; i < TR * F; i += THREADS) {
    const int r = i / F, c = i % F;
    sA[r * LDA + c] = r < nodes ? h[(int64_t)(node0 + r) * F + c] : from_f<T>(0.f);
    sB[r * LDA + c] = from_f<T>(sAgg[i]);
  }
  __syncthreads();
  block_gemm<T>(sA, wNh, sF, TR, false);
  __syncthreads();
  block_gemm<T>(sB, wNa, sF, TR, true);
  __syncthreads();
  for (int i = threadIdx.x; i < TR * F; i += THREADS) {
    const int r = i / F, c = i % F;
    sB[r * LDA + c] = from_f<T>(fmaxf(sF[r * LDF + c] + a.vec[4][c], 0.f));
  }
  __syncthreads();
  block_gemm<T>(sB, wN2, sF, TR, false);
  __syncthreads();
  T* h_out = static_cast<T*>(a.h_out);
  for (int r = warp; r < nodes; r += WARPS) {
    float x[F / 32];
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      const int c = lane + 32 * i;
      x[i] = sF[r * LDF + c] + a.vec[5][c];
    }
    warp_layernorm(x, a.vec[6], a.vec[7], lane);
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      const int c = lane + 32 * i;
      const int64_t at = (int64_t)(node0 + r) * F + c;
      h_out[at] = from_f<T>(to_f(sA[r * LDA + c]) + x[i]);
    }
  }
}

template <typename T, bool ENC, Src SRC>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Smem<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mp<T, ENC, SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mp<T, ENC, SRC><<<lbt::ceil_div(a.n, TR), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <Src SRC>
int dispatch(const Args& a, int is_bf16, int has_enc, cudaStream_t stream) {
  if (is_bf16)
    return has_enc ? launch<bf16, true, SRC>(a, stream) : launch<bf16, false, SRC>(a, stream);
  return has_enc ? launch<float, true, SRC>(a, stream) : launch<float, false, SRC>(a, stream);
}

Args make_args(const void* const* ptrs, int n, int k, int fe) {
  Args a;
  a.e = ptrs[0];
  a.hs = ptrs[1];
  a.hr = ptrs[2];
  a.h = ptrs[3];
  a.mask = static_cast<const float*>(ptrs[4]);
  a.e_out = const_cast<void*>(ptrs[5]);
  a.h_out = const_cast<void*>(ptrs[6]);
  for (int i = 0; i < 5; ++i) a.w[i] = ptrs[7 + i];
  for (int i = 0; i < 8; ++i) a.vec[i] = static_cast<const float*>(ptrs[12 + i]);
  a.enc_w1 = ptrs[20];
  a.enc_w2 = ptrs[21];
  for (int i = 0; i < 4; ++i) a.enc_vec[i] = static_cast<const float*>(ptrs[22 + i]);
  a.cand = nullptr;
  a.bases_ext = nullptr;
  a.w0s = nullptr;
  a.n = n;
  a.k = k;
  a.fe = fe;
  a.C = 0;
  a.S = 0;
  a.T = 0;
  a.SUB = 0;
  a.WSUB = 0;
  return a;
}

}  // namespace

// ptrs (host array of device pointers), in order:
//   0 e | raw, 1 hs_gath, 2 hr, 3 h, 4 mask, 5 e_out, 6 h_out,
//   7 W_e, 8 W2, 9 W_nh, 10 W_na, 11 W_n2,
//   12 b1, 13 b2, 14 ln1_scale, 15 ln1_bias, 16 bn1, 17 bn2, 18 ln2_scale,
//   19 ln2_bias,
//   20 enc_w1, 21 enc_w2, 22 enc_b1, 23 enc_b2, 24 enc_ln_scale,
//   25 enc_ln_bias (unused unless has_enc).
LBT_EXPORT int lbt_fused_mp(const void* const* ptrs, int n, int k, int fe, int latent,
                            int is_bf16, int has_enc, cudaStream_t stream) {
  if (latent != F || n < 1 || k < 1 || (has_enc && (fe < 1 || fe > 16)))
    return (int)cudaErrorInvalidValue;
  return dispatch<Src::kGathered>(make_args(ptrs, n, k, fe), is_bf16, has_enc, stream);
}

// K8: ptrs as lbt_fused_mp's, with 1 = hs_ext (n_ext, F), 4 unused, and
//   26 cand (n_ext, K) int32, 27 bases_ext (n_cols+1, S) int32;
// n = n_ext = (n_cols+1) * C.
LBT_EXPORT int lbt_fused_mp_slot(const void* const* ptrs, int n, int k, int fe, int latent,
                                 int is_bf16, int has_enc, int C, int S,
                                 cudaStream_t stream) {
  if (latent != F || n < 1 || k < 1 || C < 1 || S < 1 || n % C ||
      (has_enc && (fe < 1 || fe > 16)))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(ptrs, n, k, fe);
  a.cand = static_cast<const int32_t*>(ptrs[26]);
  a.bases_ext = static_cast<const int32_t*>(ptrs[27]);
  a.C = C;
  a.S = S;
  return dispatch<Src::kSlot>(a, is_bf16, has_enc, stream);
}

// E2: ptrs as lbt_fused_mp's (no encoder), with 1 = hs_ext (n_ext, F), 4
//   unused, 26 cand (n, K) int32, 27 w0s (n/T, T/SUB, 3) int32; n % T == 0.
LBT_EXPORT int lbt_fused_mp_window(const void* const* ptrs, int n, int k, int latent,
                                   int is_bf16, int T, int SUB, int WSUB,
                                   cudaStream_t stream) {
  if (latent != F || n < 1 || k < 1 || T < 1 || SUB < 1 || T % SUB || n % T || WSUB < 1)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(ptrs, n, k, 0);
  a.cand = static_cast<const int32_t*>(ptrs[26]);
  a.w0s = static_cast<const int32_t*>(ptrs[27]);
  a.T = T;
  a.SUB = SUB;
  a.WSUB = WSUB;
  return is_bf16 ? launch<bf16, false, Src::kWindow>(a, stream)
                 : launch<float, false, Src::kWindow>(a, stream);
}
