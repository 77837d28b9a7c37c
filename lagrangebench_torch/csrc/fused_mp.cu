// K3: one fused GNS message-passing step (forward), dense (N, K) layout;
// K8: the same step in column-slot order; E2: the same step with each
// edge's sender row selected from per-sub-tile windows.
//
// Replaces: lagrangebench_tpu/ops/fused_mp.py::_make_fused_kernel (math in
// _mp_math), launched by _launch_fused (K3), ::_make_slot_kernel, launched
// by _launch_fused_slot (K8), and scripts/experiments/window_select.py::
// make_window_kernel (E2). Per receiver, at latent width nf in [1, 256]
// (every kernel is a template on the instance width F = 64 ceil(nf / 64),
// chosen by the entry points from their `latent` argument nf; the wrapper
// pads the tensors and weights to F with zeros, and each LayerNorm runs
// over the first nf channels: mp_common.cuh):
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
// Bound on an H100: bytes. Per edge row it reads e and hs_gath (2 x 2F B
// in bf16) and writes e' (2F B) for 2 x F x F x 2 FLOP, F / 1.5 FLOP/B (85
// at F = 128, 43 at F = 64) against the card's ~295 FLOP/B balance point
// for bf16.
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
// hundred rows) is left out: it would not fit beside the edge kernel's
// resident weights and rings.
//
// Design, bf16 at F = 64 and 128 (the warp design; GNS-10-128, GNS-5-64
// and every width up to 128): two hand-written kernels per step.
//   fused_mp_edge (edge_fwd, mp_warp.cuh): a persistent grid of one 8-warp
//     block per SM; the block stages W_e and W2 (and enc_w1, enc_w2 on step
//     0) once per launch with cp.async into swizzled shared memory, where
//     they stay.
//     Each warp owns an even share of the receivers and walks its edge rows
//     in 16-row slices through a 2-stage cp.async ring (e and the sender
//     rows: contiguous for K3, indexed rows of hs_ext resolved per slice for
//     K8 and E2, zero-filled where the edge is padded). The whole chain runs
//     in registers on mma.sync m16n8k16 (bf16 in, float32 accumulators):
//     first's accumulators take hs, hr and b1, ReLU and the bf16 cast, and
//     become the A operand of @ W2 register for register; LayerNorm reduces
//     each row among the four lanes that hold it. e' goes out through the
//     consumed hs slot as 16-byte stores; agg is summed per receiver by
//     shuffles over the slice's rows, in row order, by the one warp that
//     owns the receiver, and written once as float32 to a scratch (N, F)
//     (8 MB at 16,000 receivers).
//   fused_mp_node (below): 8 warps per block, W_nh, W_na, W_n2 staged once
//     per block; each warp takes 16 nodes: h by cp.async, agg from the scratch,
//     the node MLP and LayerNorm in registers, h' out as 16-byte stores.
// Shared memory at F = 128: edge 196 KB (2 x 32 KB weights, 4 KB vectors,
// 8 warps x 2 stages x 8 KB), 168 KB on step 0 (+ enc_w2, enc_w1; the raw
// features are loaded into registers, so the ring holds hs only); node
// 130 KB; at F = 64 each about half, with the same grid and blocks. Why
// mma.sync and not wgmma: each warp owns whole rows through the chain
// (LayerNorm by quad shuffles, the register A operand), which is
// mma.sync's layout; the products are not the bound (the chain's two
// products take ~0.04 ms at the rollout shape at the bf16 peak, against
// 0.15 ms of bytes).
//
// Design, bf16 at F = 192 and 256 (the stream design, mp_stream.cuh; GNS-10-
// 256 and every width from 129 to 256): the same two kernels per step, with
// the warp design's row ownership and register accumulators, but no weight
// resident and no A operand in registers, which do not fit there (a 16-row
// chain would hold ~F registers per lane, and two resident F x F weights take
// 144 KB at F = 192 and 256 KB at F = 256 of the 227 KB of shared memory).
//   fused_mp_edge_stream: persistent, one 8-warp block per SM; each warp owns
//     an even share of the receivers and takes one 16-row slice per
//     iteration, its float32 accumulator for the whole width in registers
//     (128 per lane at F = 256). The slice's operands live in two slots of
//     shared memory per warp (e, then the sender rows overwritten in place by
//     T(relu(first))); the weights W_e and W2 (and enc_w2 on step 0) stream
//     through a block-wide 4-stage cp.async ring of 32-row slabs (16 KB at F =
//     256) that the block's 8 warps share, one block barrier per slab. Each
//     LayerNorm reduces in its warp by quad shuffles, e' goes out of its slot
//     in 16-byte stores, and agg is summed per receiver by its warp in row
//     order into the float32 scratch. Step 0's first layer (raw @ enc_w1)
//     is one mma.sync k-step from registers on the resident enc_w1 rows, and
//     enc_w2 is one more streamed product.
//   fused_mp_node_stream: 16 nodes per warp, 128 per block and iteration, h
//     and T(agg) in the warp's slots, W_nh, W_na, W_n2 streamed the same way.
// What bounds it (an H100 at F = 256, the rollout shape 16,000 x 40;
// experiments/stream_ablation.py): the products, not the card's bytes (0.30
// ms). The edge kernel takes 1.19 ms, 0.96 of it with relu_first and the agg
// sums taken out. Each warp reads every slab's B fragments for its 16 rows
// (17 ldmatrix per 32 mma.sync: ~0.38 ms of ldmatrix issue at the card's
// shared-memory rate); at 255 registers (128 of them the accumulator) the
// loop keeps few fragments in flight, and the 8 warps take each slab in
// step, so no warp's epilogue overlaps another's products. The slab loop
// is rolled: unrolled, K4's edge kernel took 3.55 ms for its products
// alone against 2.04, and the build 87 s against 63. Shared memory:
// 208 KB at F = 256 with the encoder (ring 64 KB, slots 128 KB, enc_w1 8
// KB, vectors 8 KB), 196 KB for the node kernel.
//
// Past F = 256 (latent widths from 257 on, float32 and bf16) the entry
// points run the wide path (mp_wide.cuh: a hand-written product launch per
// GEMM of the step, its epilogue writing rows to device memory, then
// LayerNorm / residual / K-sum row kernels), one code path for every such
// width, on buffers the wrapper allocates (ptrs 29-36 below).
//
// The tile design (fused_mp below) is the float32 instance at every F: one
// block of 8 warps per tile of 16 receivers, rows streamed through shared
// memory 64 at a time, weights read from global memory (L1/L2), CUDA-core
// FMAs, the K-sum row by row in k order; it checks the arithmetic against
// the plain version with TF32 off. Shared memory: 211 KB at F = 256.
#include "mp_stream.cuh"
#include "mp_wide.cuh"

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
  int nf;    // the true latent width, <= F
  int C, S;  // K8: column capacity, stencil columns
  int T, SUB, WSUB;  // E2: rows per tile and sub-tile, window rows
};

template <typename T, int F>
struct Smem {
  static constexpr int LDA = Layout<T, F>::LDA;
  static constexpr int kA = M * LDA * (int)sizeof(T);
  static constexpr int kF = M * kLdf<F> * 4;
  static constexpr int kAgg = TR * F * 4;
  static constexpr int kBytes = 2 * kA + kF + kAgg;
  static_assert(kBytes <= kSmemMax, "tile design shared memory");
};

template <typename T, int F, bool ENC, Src SRC>
__global__ void __launch_bounds__(THREADS, 1) fused_mp(const Args a) {
  using S = Smem<T, F>;
  constexpr bool kSelect = SRC != Src::kGathered;  // sender rows read in-kernel
  constexpr int LDA = S::LDA, LDF = kLdf<F>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + S::kA);
  float* sF = reinterpret_cast<float*>(smem + 2 * S::kA);
  float* sAgg = reinterpret_cast<float*>(smem + 2 * S::kA + S::kF);
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

  // edge-phase weights, read from global memory (L1/L2): W_e and W2 (+
  // enc_w2 on step 0)
  const T* wE = static_cast<const T*>(a.w[0]);
  const T* w2 = static_cast<const T*>(a.w[1]);
  const T* wEnc2 = static_cast<const T*>(a.enc_w2);
  for (int i = threadIdx.x; i < TR * F; i += THREADS) sAgg[i] = 0.f;

  for (int c0 = 0; c0 < rows_tile; c0 += M) {
    const int rows = min(M, rows_tile - c0);
    const int rows_pad = (rows + 15) / 16 * 16;
    __syncthreads();  // previous chunk done with sA/sB/sF
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
      block_gemm<F>(sB, wEnc2, sF, rows_pad, false);
      __syncthreads();
      for (int r = warp; r < rows_pad; r += WARPS) {
        float x[F / 32];
#pragma unroll
        for (int i = 0; i < F / 32; ++i) {
          const int c = lane + 32 * i;
          x[i] = sF[r * LDF + c] + a.enc_vec[1][c];
        }
        warp_layernorm(x, a.enc_vec[2], a.enc_vec[3], lane, a.nf);
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
    block_gemm<F>(sA, wE, sF, rows_pad, false);
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
    block_gemm<F>(sB, w2, sF, rows_pad, false);
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
      warp_layernorm(x, a.vec[2], a.vec[3], lane, a.nf);
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
  for (int i = threadIdx.x; i < TR * F; i += THREADS) {
    const int r = i / F, c = i % F;
    sA[r * LDA + c] = r < nodes ? h[(int64_t)(node0 + r) * F + c] : from_f<T>(0.f);
    sB[r * LDA + c] = from_f<T>(sAgg[i]);
  }
  __syncthreads();
  block_gemm<F>(sA, wNh, sF, TR, false);
  __syncthreads();
  block_gemm<F>(sB, wNa, sF, TR, true);
  __syncthreads();
  for (int i = threadIdx.x; i < TR * F; i += THREADS) {
    const int r = i / F, c = i % F;
    sB[r * LDA + c] = from_f<T>(fmaxf(sF[r * LDF + c] + a.vec[4][c], 0.f));
  }
  __syncthreads();
  block_gemm<F>(sB, wN2, sF, TR, false);
  __syncthreads();
  T* h_out = static_cast<T*>(a.h_out);
  for (int r = warp; r < nodes; r += WARPS) {
    float x[F / 32];
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      const int c = lane + 32 * i;
      x[i] = sF[r * LDF + c] + a.vec[5][c];
    }
    warp_layernorm(x, a.vec[6], a.vec[7], lane, a.nf);
#pragma unroll
    for (int i = 0; i < F / 32; ++i) {
      const int c = lane + 32 * i;
      const int64_t at = (int64_t)(node0 + r) * F + c;
      h_out[at] = from_f<T>(to_f(sA[r * LDA + c]) + x[i]);
    }
  }
}

template <typename T, int F, bool ENC, Src SRC>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Smem<T, F>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mp<T, F, ENC, SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mp<T, F, ENC, SRC><<<lbt::ceil_div(a.n, TR), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- bf16: fused_mp_edge (edge_fwd, mp_warp.cuh), then fused_mp_node -------

template <int F, bool ENC, Src SRC>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_edge(const EdgeArgs a) {
  edge_fwd<F, ENC, SRC>(a);
}

template <int F, bool ENC, Src SRC>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_edge_stream(const EdgeArgs a) {
  edge_fwd_stream<F, ENC, SRC>(a);
}

struct NodeArgs {
  const bf16* h;       // (n, F)
  const float* agg;    // (n, F)
  bf16* h_out;         // (n, F)
  const bf16* w[3];    // W_nh, W_na, W_n2
  const float* vec[4]; // bn1, bn2, ln2 scale, ln2 bias
  int n, nf;
};

template <int F>
struct NodeSmem {
  static constexpr int kVec = 3 * Tile<F>::WEIGHT_BYTES;
  static constexpr int kTiles = kVec + 4 * F * 4;
  static constexpr int kBytes = kTiles + WARPS * Tile<F>::SLICE_BYTES;
  static_assert(kBytes <= kSmemMax, "node kernel shared memory");
};

// h' = T(h + LN2(relu(h @ W_nh + T(agg) @ W_na + bn1) @ W_n2 + bn2)), 16
// nodes per warp, the weights staged once per block.
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_node(const NodeArgs a) {
  using D = Tile<F>;
  constexpr int NB = D::NB, KB = D::KB, WEIGHT_BYTES = D::WEIGHT_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  for (int i = 0; i < 3; ++i) stage_rows<F>(sb + i * WEIGHT_BYTES, a.w[i], F, F);
  cp_commit();
  float* vec = reinterpret_cast<float*>(smem + NodeSmem<F>::kVec);
  for (int i = threadIdx.x; i < 4 * F; i += THREADS) vec[i] = a.vec[i / F][i % F];
  cp_wait<0>();
  __syncthreads();
  const float* bn1 = vec;

  const u32 tile = NodeSmem<F>::kTiles + warp * D::SLICE_BYTES;
  const int slices = (a.n + SR - 1) / SR;
  for (int sl = blockIdx.x * WARPS + warp; sl < slices; sl += gridDim.x * WARPS) {
    const int64_t r0 = (int64_t)sl * SR;
#pragma unroll
    for (int i = 0; i < D::CP_ITERS; ++i) {
      int r, c;
      slice_chunk<F>(lane, i, r, c);
      const bool v = r0 + r < a.n;
      cp_async16(sb + tile + swz<F>(r, c), v ? a.h + (r0 + r) * F + c * 8 : a.h, v);
    }
    cp_commit();
    cp_wait<0>();
    __syncwarp();
    u32 ha[KB][4], ga[KB][4];
    load_a(ha, sb + tile, lane);
    const bool vg = r0 + g < a.n, vg8 = r0 + g + 8 < a.n;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + 2 * t;
      const float2 x = vg ? *reinterpret_cast<const float2*>(a.agg + (r0 + g) * F + c)
                          : make_float2(0.f, 0.f);
      const float2 x8 = vg8 ? *reinterpret_cast<const float2*>(a.agg + (r0 + g + 8) * F + c)
                            : make_float2(0.f, 0.f);
      ga[nb >> 1][(nb & 1) * 2] = pack(x.x, x.y);
      ga[nb >> 1][(nb & 1) * 2 + 1] = pack(x8.x, x8.y);
    }
    float acc[NB][4];
    zero(acc);
    gemm(acc, ha, sb, lane);
    gemm(acc, ga, sb + WEIGHT_BYTES, lane);
    u32 ra[KB][4];
    to_frag(ra, acc,
            [&](float x, int nb, int j) { return fmaxf(x + bn1[nb * 8 + 2 * t + j], 0.f); });
    zero(acc);
    gemm(acc, ra, sb + 2 * WEIGHT_BYTES, lane);
    add_bias(acc, vec + F, t);
    float inv0, inv1;
    row_normalize(acc, inv0, inv1, a.nf);
    scale_shift(acc, vec + 2 * F, vec + 3 * F, t);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int c = nb * 8 + 2 * t;
      const float2 hg = unpack(frag_pair(ha, nb, 0)), hg8 = unpack(frag_pair(ha, nb, 1));
      sts32(smem, tile + swz_pair<F>(g, c), pack(hg.x + acc[nb][0], hg.y + acc[nb][1]));
      sts32(smem, tile + swz_pair<F>(g + 8, c), pack(hg8.x + acc[nb][2], hg8.y + acc[nb][3]));
    }
    __syncwarp();
    store_slice<F>(a.h_out, r0, a.n, smem, tile, lane);
    __syncwarp();
  }
}

template <int F>
struct NodeStreamSmem {
  static constexpr int kSlots = Stream<F>::RING_BYTES;
  static constexpr int kVec = kSlots + Stream<F>::SLOTS_BYTES;  // bn1, bn2, ln2 scale, ln2 bias
  static constexpr int kBytes = kVec + 4 * F * 4;
  static_assert(kBytes <= kSmemMax, "stream node kernel shared memory");
};

// The node half in the stream design: 16 nodes per warp, 128 per block and
// iteration; slots s_h (h, then h') and s_a (T(agg), then T(r2)); the ring
// streams W_nh, W_na, W_n2 per iteration.
template <int F>
__global__ void __launch_bounds__(THREADS, 1) fused_mp_node_stream(const NodeArgs a) {
  using D = Tile<F>;
  using S = NodeStreamSmem<F>;
  constexpr int NB = D::NB, SLICE = D::SLICE_BYTES, ROWS = WARPS * SR;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const u32 sb = smem_addr(smem);
  float* vec = reinterpret_cast<float*>(smem + S::kVec);
  for (int i = threadIdx.x; i < 4 * F; i += THREADS) vec[i] = a.vec[i / F][i % F];
  const float* bn1 = vec;
  const int groups = (a.n + ROWS - 1) / ROWS;
  const int iters = (int)blockIdx.x < groups ? (groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  Ring<F> ring;
  ring.base = sb;
  ring.nseq = 3;
  ring.cols = 0;
  for (int i = 0; i < 3; ++i) ring.seq[i] = a.w[i];
  ring.start(iters);
  const u32 s_h = S::kSlots + warp * 2 * SLICE, s_a = s_h + SLICE;
  float acc[NB][4];
  for (int it = 0; it < iters; ++it) {
    const int64_t r0 = ((int64_t)(blockIdx.x + it * gridDim.x) * WARPS + warp) * SR;
    const bool live = r0 < a.n;
    if (live) {
      copy_slice<F>(sb + s_h, a.h, r0, a.n, lane);
      const bool vg = r0 + g < a.n, vg8 = r0 + g + 8 < a.n;
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
    zero(acc);  // h @ W_nh + T(agg) @ W_na, one sum
    product<false>(acc, ring, sb + s_h, live, true, lane);
    product<false>(acc, ring, sb + s_a, live, false, lane);
    if (live) {
      __syncwarp();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {  // T(relu(nf)) over T(agg)
        const int c = nb * 8 + 2 * t;
        sts32(smem, s_a + swz_pair<F>(g, c),
              pack(fmaxf(acc[nb][0] + bn1[c], 0.f), fmaxf(acc[nb][1] + bn1[c + 1], 0.f)));
        sts32(smem, s_a + swz_pair<F>(g + 8, c),
              pack(fmaxf(acc[nb][2] + bn1[c], 0.f), fmaxf(acc[nb][3] + bn1[c + 1], 0.f)));
      }
      __syncwarp();
    }
    zero(acc);
    product<false>(acc, ring, sb + s_a, live, false, lane);
    if (live) {  // h' = T(h + LN2(y1)), in place in s_h
      add_bias(acc, vec + F, t);
      float inv0, inv1;
      row_normalize(acc, inv0, inv1, a.nf);
      scale_shift(acc, vec + 2 * F, vec + 3 * F, t);
      add_pairs(acc, smem, s_h, lane);
      __syncwarp();
      store_slice<F>(static_cast<bf16*>(a.h_out), r0, a.n, smem, s_h, lane);
      __syncwarp();
    }
  }
  cp_wait<0>();
}

template <int F, Src SRC>
int run_bf16(const Args& a, bool has_enc, const int* grids, float* agg, cudaStream_t stream) {
  EdgeArgs ea;
  ea.e = a.e;
  ea.hs = static_cast<const bf16*>(a.hs);
  ea.hr = static_cast<const bf16*>(a.hr);
  ea.mask = a.mask;
  ea.cand = a.cand;
  ea.bases_ext = a.bases_ext;
  ea.w0s = a.w0s;
  ea.w_e = static_cast<const bf16*>(a.w[0]);
  ea.w2 = static_cast<const bf16*>(a.w[1]);
  ea.enc_w1 = static_cast<const bf16*>(a.enc_w1);
  ea.enc_w2 = static_cast<const bf16*>(a.enc_w2);
  for (int i = 0; i < 4; ++i) {
    ea.vec[i] = a.vec[i];
    ea.enc_vec[i] = a.enc_vec[i];
  }
  ea.e_out = static_cast<bf16*>(a.e_out);
  ea.agg = agg;
  ea.n = a.n;
  ea.k = a.k;
  ea.fe = a.fe;
  ea.nf = a.nf;
  ea.C = a.C;
  ea.S = a.S;
  ea.T = a.T;
  ea.SUB = a.SUB;
  ea.WSUB = a.WSUB;
  // the edge kernel of the instance's design: the warp design at F <= 128,
  // the stream design above
  const auto edge = [&](auto enc) {
    constexpr bool E = decltype(enc)::value;
    if constexpr (F <= 128)
      return launch_kernel(fused_mp_edge<F, E, SRC>, grids[0], THREADS, EdgeSmem<F, E>::kBytes, ea,
                           stream);
    else
      return launch_kernel(fused_mp_edge_stream<F, E, SRC>, grids[0], THREADS,
                           EdgeStreamSmem<F, E>::kBytes, ea, stream);
  };
  int err;
  if constexpr (SRC == Src::kWindow) {
    err = edge(std::false_type{});
  } else {
    err = has_enc ? edge(std::true_type{}) : edge(std::false_type{});
  }
  if (err != 0) return err;
  NodeArgs na;
  na.h = static_cast<const bf16*>(a.h);
  na.agg = agg;
  na.h_out = static_cast<bf16*>(a.h_out);
  for (int i = 0; i < 3; ++i) na.w[i] = static_cast<const bf16*>(a.w[2 + i]);
  for (int i = 0; i < 4; ++i) na.vec[i] = a.vec[4 + i];
  na.n = a.n;
  na.nf = a.nf;
  if constexpr (F <= 128)
    return launch_kernel(fused_mp_node<F>, grids[1], THREADS, NodeSmem<F>::kBytes, na, stream);
  else
    return launch_kernel(fused_mp_node_stream<F>, grids[1], THREADS, NodeStreamSmem<F>::kBytes, na,
                         stream);
}

// The float32 tile design's instance at width F.
template <int F, Src SRC>
int launch_tile(const Args& a, int has_enc, cudaStream_t stream) {
  if constexpr (SRC == Src::kWindow) return launch<float, F, false, SRC>(a, stream);
  else
    return has_enc ? launch<float, F, true, SRC>(a, stream) : launch<float, F, false, SRC>(a, stream);
}

// The wide path (mp_wide.cuh) at latent width a.nf > 256, on the
// wrapper's buffers at ptrs 29-36.
template <Src SRC>
int run_wide(const Args& a, int is_bf16, int has_enc, const void* const* ptrs,
             cudaStream_t stream) {
  WideFwd w;
  w.e = a.e;
  w.hs = a.hs;
  w.hr = a.hr;
  w.h = a.h;
  w.mask = a.mask;
  w.e_out = a.e_out;
  w.h_out = a.h_out;
  for (int i = 0; i < 5; ++i) w.w[i] = a.w[i];
  for (int i = 0; i < 8; ++i) w.vec[i] = a.vec[i];
  w.enc_w1 = a.enc_w1;
  w.enc_w2 = a.enc_w2;
  for (int i = 0; i < 4; ++i) w.enc_vec[i] = a.enc_vec[i];
  w.cand = a.cand;
  w.table = SRC == Src::kSlot ? a.bases_ext : a.w0s;
  w.src = SRC == Src::kGathered ? 0 : SRC == Src::kSlot ? 1 : 2;
  w.C = a.C;
  w.S = a.S;
  w.T = a.T;
  w.SUB = a.SUB;
  w.WSUB = a.WSUB;
  w.n = a.n;
  w.k = a.k;
  w.fe = a.fe;
  w.nf = a.nf;
  w.F = (a.nf + 63) / 64 * 64;
  w.enc = has_enc != 0;
  w.srow = static_cast<int32_t*>(const_cast<void*>(ptrs[29]));
  w.e_enc = const_cast<void*>(ptrs[30]);
  w.x = static_cast<float*>(const_cast<void*>(ptrs[31]));
  w.r1 = const_cast<void*>(ptrs[32]);
  w.aggc = const_cast<void*>(ptrs[33]);
  w.agg = static_cast<float*>(const_cast<void*>(ptrs[34]));
  w.r2 = const_cast<void*>(ptrs[35]);
  w.y = static_cast<float*>(const_cast<void*>(ptrs[36]));
  w.part = static_cast<float*>(const_cast<void*>(ptrs[37]));
  if (w.aggc == nullptr || w.r2 == nullptr || w.y == nullptr || (w.src != 0 && w.srow == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool wgmma = is_bf16 && w.F <= kWgmmaMax;  // r1 is then a check-only output
  if (wgmma ? w.part == nullptr
            : w.x == nullptr || w.r1 == nullptr || (w.enc && w.e_enc == nullptr))
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? wide_forward<bf16>(w, stream) : wide_forward<float>(w, stream);
}

// The instance for latent width a.nf (latent_dispatch): float32 the tile
// design; bf16 the warp design at F <= 128, else the stream design; the
// wide path above 256.
template <Src SRC>
int dispatch(const Args& a, int is_bf16, int has_enc, const void* const* ptrs,
             const int* grids, cudaStream_t stream) {
  if (a.nf > kMaxLatent) {
    return run_wide<SRC>(a, is_bf16, has_enc, ptrs, stream);
  }
  return latent_dispatch(a.nf, [&](auto width) {
    constexpr int F = decltype(width)::value;
    if (!is_bf16) return launch_tile<F, SRC>(a, has_enc, stream);
    if (grids[0] < 1 || grids[1] < 1 || ptrs[28] == nullptr) return (int)cudaErrorInvalidValue;
    return run_bf16<F, SRC>(a, has_enc, grids, static_cast<float*>(const_cast<void*>(ptrs[28])),
                            stream);
  });
}

Args make_args(const void* const* ptrs, int n, int k, int fe, int nf) {
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
  a.nf = nf;
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
//   25 enc_ln_bias (unused unless has_enc), 26, 27 (K8, E2 below),
//   28 agg scratch (n, F) float32 (bf16 only: the warp and stream designs),
//   29-36 the wide path's buffers (nf > 256; ops/fused_mp.py _wide_buffers):
//   29 sender rows (rows) int32 (K8, E2), 30 the encoded e (rows, F) T (with
//   the encoder), 31 x (rows, F) float32, 32 T(relu(first)) (rows, F),
//   33 T(agg) (n, F), 34 agg (n, F) float32, 35 T(relu(node_first)) (n, F),
//   36 y (n, F) float32, 37 the agg partials (tiles, slots, F) float32 of the
//   wgmma design (bf16 at nf <= 512: mp_wgmma.cuh), which takes no 30 and 31
//   and reads 32 (T(relu(first)), rows x F) and 34 as check-only outputs
//   (null: not written).
// latent: the true width nf >= 1 (else cudaErrorInvalidValue); every
//   tensor and weight is F = 64 ceil(nf / 64) wide, zero past nf.
// grids: the bf16 designs' edge and node grids (unused by the float32 tile design).
LBT_EXPORT int lbt_fused_mp(const void* const* ptrs, int n, int k, int fe, int latent,
                            int is_bf16, int has_enc, const int* grids, cudaStream_t stream) {
  if (n < 1 || k < 1 || (has_enc && (fe < 1 || fe > 16))) return (int)cudaErrorInvalidValue;
  return dispatch<Src::kGathered>(make_args(ptrs, n, k, fe, latent), is_bf16, has_enc, ptrs,
                                  grids, stream);
}

// K8: ptrs as lbt_fused_mp's, with 1 = hs_ext (n_ext, F), 4 unused, and
//   26 cand (n_ext, K) int32, 27 bases_ext (n_cols+1, S) int32;
// n = n_ext = (n_cols+1) * C.
LBT_EXPORT int lbt_fused_mp_slot(const void* const* ptrs, int n, int k, int fe, int latent,
                                 int is_bf16, int has_enc, int C, int S, const int* grids,
                                 cudaStream_t stream) {
  if (n < 1 || k < 1 || C < 1 || S < 1 || n % C || (has_enc && (fe < 1 || fe > 16)))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(ptrs, n, k, fe, latent);
  a.cand = static_cast<const int32_t*>(ptrs[26]);
  a.bases_ext = static_cast<const int32_t*>(ptrs[27]);
  a.C = C;
  a.S = S;
  return dispatch<Src::kSlot>(a, is_bf16, has_enc, ptrs, grids, stream);
}

// E2: ptrs as lbt_fused_mp's (no encoder), with 1 = hs_ext (n_ext, F), 4
//   unused, 26 cand (n, K) int32, 27 w0s (n/T, T/SUB, 3) int32; n % T == 0.
LBT_EXPORT int lbt_fused_mp_window(const void* const* ptrs, int n, int k, int latent,
                                   int is_bf16, int T, int SUB, int WSUB, const int* grids,
                                   cudaStream_t stream) {
  if (n < 1 || k < 1 || T < 1 || SUB < 1 || T % SUB || n % T || WSUB < 1)
    return (int)cudaErrorInvalidValue;
  Args a = make_args(ptrs, n, k, 0, latent);
  a.cand = static_cast<const int32_t*>(ptrs[26]);
  a.w0s = static_cast<const int32_t*>(ptrs[27]);
  a.T = T;
  a.SUB = SUB;
  a.WSUB = WSUB;
  return dispatch<Src::kWindow>(a, is_bf16, 0, ptrs, grids, stream);
}
