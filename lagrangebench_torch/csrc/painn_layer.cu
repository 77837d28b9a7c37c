// K5: one fused PaiNN layer (everything after the interaction context net),
// dense (N, K) layout, with the sender gather inside.
//
// Replaces: lagrangebench_tpu/ops/painn_msg.py::_layer_kernel, launched by
// _painn_layer_pallas, and the gather `packed[senders]` in front of it
// (lagrangebench_tpu/models/painn.py), which the TPU kernel takes outside
// because Mosaic has no row gather. Per receiver, with H <= 1024 channels
// (128 in the shipped configs), R <= 256 radial basis functions (20,
// build_painn), g_k = packed[sidx[k]] the k-th sender's row [x1, x2, u_d]
// and d over the dim axes:
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
// packed holds M >= N source rows: the N receivers' own rows on the dense
// path (M = N), the slab's rows and its two halo slabs under spatial
// sharding (M = 3 N_loc). Indices outside [0, M) are clamped, as a JAX
// gather clamps them.
//
// Bound on an H100: operations. With the gather inside, the bytes are one
// read of packed, phi, nd, sidx, s and v and one write of the outputs
// (~0.05 ms at the rollout shape, 16,000 x 40, float32), while the filter
// product alone is 2 R 3H FLOP per edge and the node products ~360 kFLOP
// per receiver: ~17.5 GFLOP, ~0.26 ms at the CUDA cores' 67 TFLOP/s.
//
// Design: the products stay on the CUDA cores in float32. The filter
// product is (K x 20) @ (20 x 3H) per receiver, too shallow for TF32
// tensor-core tiles to pay for the three passes a float32-accurate 3xTF32
// split needs, and plain TF32 would break the float32 gate; bf16 runs the
// same body on bf16 loads. One block per tile of 16 receivers, thread c
// owning channel c: 128 threads for H <= 128 (three blocks per SM), 256
// for H <= 256; threads past H stage and synchronize with the others and
// hold zeros. Rows in shared memory are HP = H rounded up to 4 floats
// wide, zero past H, for float4 reads.
// - Edge phase: each thread keeps its three filter columns (3 RC values) in
//   registers, RC = 20 for R <= 20 and 64 for R <= 64, zero past R, so
//   that the filter loop is unrolled over RC (at RC = 64 they spill to
//   local memory: a correct instance, not a fast one). A receiver's K
//   basis rows (RC values, zero past R, then the scale; padded to RP, a
//   multiple of 4, for float4 reads),
//   directions and sender indices are staged in shared memory, double
//   buffered: the next receiver's values are loaded into registers while
//   the current one computes, so there is one barrier per receiver. Each
//   edge reads its sender's five channel values straight from packed
//   (coalesced 128-byte rows per warp, through L1), issued one edge ahead.
//   K-sums run in registers in k order.
// - Node phase: the tile's v1_d rows (48 in 3D) and ts, z rows live in
//   shared memory as float32. Each product is the threads' own FMA loop,
//   thread c computing its channel's output columns for all 16 (or 48)
//   rows at once, so that each weight fetched from L1/L2 feeds 16-96 FMAs:
//   vmix_w, mix_w1 and mix_w2 (448 KB in float32) are read once per 16
//   receivers. vl_d and sum_d vr_d vl_d stay in registers from the vmix
//   product to the output, since thread c owns channel c in all of them.
// On an H100 (700 W) this takes ~0.73 ms at the rollout shape (H = 128,
// R = 20), ~2.8x its
// operations bound: the edge phase is ~0.6 ms of it, with 168 registers
// allowing 12 warps per SM and each float4 of basis values broadcast from
// shared memory feeding only 12 FMAs. Variants that loaded the gathered
// rows three edges ahead, prefetched the node weights a k-step ahead, or
// split the edge and node phases into two kernels to fit more warps per
// SM ran 0.77-0.98 ms (experiments/mp_times.py --tree on scratch copies):
// each spilled or lost more to registers than it gained.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TR = 16;      // receivers per block
constexpr int PF = 8;       // staged words a thread loads ahead (covers K <= 48 at 128 threads)
constexpr int kMaxHidden = 256, kMaxRbf = 64;  // the widest narrow instance (wide above)
// the basis row in shared memory at basis capacity RC: RC values, the
// scale at RC, padded to whole float4s
template <int RC>
constexpr int kRowP = (RC + 1 + 3) / 4 * 4;
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
  const void* packed;   // (M, (2 + dim) H) T: per source row [x1, x2, u_d]
  const int32_t* sidx;  // (N, K) sender rows
  const void* phi;      // (N, K, R + 1) T
  const void* nd;       // (N, K, dim) T
  const void* s;        // (N, H) T
  const void* v;        // (N, dim H) T
  const void* filt_w;   // (R, 3H) T
  const float* filt_b;  // (3H)
  const void* vmix_w;   // (H, 2H) T
  const void* mix_w1;   // (2H, H) T
  const float* mix_b1;  // (H)
  const void* mix_w2;   // (H, 3H) T
  const float* mix_b2;  // (3H)
  void* s_out;          // (N, H) T
  void* v_out;          // (N, dim H) T
  int n, k, m;  // receivers, slots per receiver, source rows of packed
  int h, r;     // hidden width, radial basis functions
};

// Shared memory (float32 words): the node phase's rows (hp = H rounded up
// to 4), then two receiver stages of K basis rows (RP), K directions (4)
// and K sender rows (1).
template <int RC, int DIM>
struct Smem {
  static constexpr int RP = kRowP<RC>;
  int hp, kV1, kTS, kZ, kStage;
  __host__ __device__ explicit Smem(int h) : hp((h + 3) / 4 * 4) {
    kV1 = 0;                      // (TR DIM, hp)  v1_d, row i * DIM + d
    kTS = kV1 + TR * DIM * hp;    // (TR, 2 hp)    ts = [s1, |vr|]
    kZ = kTS + TR * 2 * hp;       // (TR, hp)      z
    kStage = kZ + TR * hp;
  }
  // rounded up to whole float4s, so that both stages are 16-byte aligned
  __host__ __device__ static int stage_words(int k) { return (k * (RP + 4 + 1) + 3) / 4 * 4; }
  int bytes(int k) const { return (kStage + 2 * stage_words(k)) * 4; }
};

// Word e of a receiver's stage: its basis values, then its directions, then
// its sender rows, in the order they lie in device memory.
template <typename T, int RC, int DIM>
struct Stage {
  static constexpr int RP = kRowP<RC>;
  const T* phi;
  const T* nd;
  const int32_t* sidx;
  int k, r, words;

  __device__ float fetch(int64_t node, int e) const {
    const int np = k * (r + 1), nn = k * DIM;
    if (e < np) return to_f(phi[node * np + e]);
    if (e < np + nn) return to_f(nd[node * nn + e - np]);
    return __int_as_float(sidx[node * k + e - np - nn]);
  }

  __device__ void put(float* buf, int e, float val) const {
    const int np = k * (r + 1), nn = k * DIM;
    if (e < np) {
      const int q = e % (r + 1);  // basis value q < r, or the scale
      buf[(e / (r + 1)) * RP + (q < r ? q : RC)] = val;
    } else if (e < np + nn) {
      e -= np;
      buf[k * RP + (e / DIM) * 4 + e % DIM] = val;
    } else {
      buf[k * (RP + 4) + e - np - nn] = val;
    }
  }
};

// One sender's five (four in 2D) channel-c values: x1, x2, u_d.
template <typename T, int DIM>
__device__ __forceinline__ void load_sender(const T* __restrict__ packed, int row, int m, int c,
                                            int h, float (&g)[2 + DIM]) {
  row = min(max(row, 0), m - 1);
  const T* gr = packed + (int64_t)row * (2 + DIM) * h + c;
#pragma unroll
  for (int q = 0; q < 2 + DIM; ++q) g[q] = to_f(__ldg(gr + q * h));
}

// EXACT: H == HT and R == RC, both compile-time constants (the shipped
// PaiNN's H = 128, R = 20), so that no guard, runtime stride or division
// by R + 1 costs the main path anything.
template <typename T, int DIM, int HT, int RC, bool EXACT>
__global__ void __launch_bounds__(HT, HT == 128 ? 3 : 1) painn_layer(const Args a) {
  constexpr int ROWS = TR * DIM, RP = kRowP<RC>;
  static_assert(RC % 4 == 0, "the filter loop reads float4s of basis values");
  const int H = EXACT ? HT : a.h, R = EXACT ? RC : a.r;
  const Smem<RC, DIM> L(H);
  extern __shared__ __align__(16) float smem[];
  float* sV1 = smem + L.kV1;
  float* sTS = smem + L.kTS;
  float* sZ = smem + L.kZ;

  const int K = a.k, HP = L.hp;
  const int c = threadIdx.x;
  const bool active = EXACT || c < H;  // threads past H hold zeros
  const int node0 = blockIdx.x * TR;
  const int nodes = min(TR, a.n - node0);
  const T* packed = static_cast<const T*>(a.packed);
  const T* s = static_cast<const T*>(a.s);
  const T* v = static_cast<const T*>(a.v);
  const Stage<T, RC, DIM> stage{static_cast<const T*>(a.phi), static_cast<const T*>(a.nd),
                                a.sidx, K, R, K * (R + 1 + DIM + 1)};
  const int sw = L.stage_words(K);

  // the basis rows' values past R stay 0 in both stages (never written)
  for (int i = c; i < 2 * K * (RC - R); i += HT) {
    const int b = i / (K * (RC - R)), j = i % (K * (RC - R));
    smem[L.kStage + b * sw + (j / (RC - R)) * RP + R + j % (RC - R)] = 0.f;
  }

  // this channel's three filter columns (zero past R) and biases, for the
  // whole tile
  const T* fw = static_cast<const T*>(a.filt_w);
  float f0[RC], f1[RC], f2[RC];
#pragma unroll
  for (int q = 0; q < RC; ++q) {
    const bool in = EXACT || (active && q < R);
    f0[q] = in ? to_f(fw[q * 3 * H + c]) : 0.f;
    f1[q] = in ? to_f(fw[q * 3 * H + H + c]) : 0.f;
    f2[q] = in ? to_f(fw[q * 3 * H + 2 * H + c]) : 0.f;
  }
  const float b0 = active ? a.filt_b[c] : 0.f, b1 = active ? a.filt_b[H + c] : 0.f,
              b2 = active ? a.filt_b[2 * H + c] : 0.f;

  // ---- edge phase: gathers, filters, messages, K-sums, clipped residuals
  float pf[PF];  // the next receiver's stage words, loaded ahead
#pragma unroll
  for (int u = 0; u < PF; ++u) {
    const int e = c + u * HT;
    if (e < stage.words) pf[u] = stage.fetch(node0, e);
  }
  for (int i = 0; i < nodes; ++i) {  // uniform over the block
    const int64_t node = node0 + i;
    float* st = smem + L.kStage + (i & 1) * sw;
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int e = c + u * HT;
      if (e < stage.words) stage.put(st, e, pf[u]);
    }
    for (int e = c + PF * HT; e < stage.words; e += HT) stage.put(st, e, stage.fetch(node, e));
    // the stage is complete, and the buffer written next was last read
    // before the previous barrier
    __syncthreads();
    if (i + 1 < nodes) {
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int e = c + u * HT;
        if (e < stage.words) pf[u] = stage.fetch(node + 1, e);
      }
    }

    const float* sPhi = st;
    const float* sNd = st + K * RP;
    const int* sSid = reinterpret_cast<const int*>(st + K * (RP + 4));
    float ds = 0.f, dv[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dv[d] = 0.f;
    float gn[2 + DIM];
#pragma unroll
    for (int q = 0; q < 2 + DIM; ++q) gn[q] = 0.f;
    if (active) load_sender<T, DIM>(packed, sSid[0], a.m, c, H, gn);
#pragma unroll 2
    for (int j = 0; j < K; ++j) {
      float g[2 + DIM];
#pragma unroll
      for (int q = 0; q < 2 + DIM; ++q) g[q] = gn[q];
      if (active) load_sender<T, DIM>(packed, sSid[min(j + 1, K - 1)], a.m, c, H, gn);
      const float* ph = sPhi + j * RP;
      float w0 = 0.f, w1 = 0.f, w2 = 0.f;
#pragma unroll
      for (int q = 0; q < RC; q += 4) {
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
      const float scale = ph[RC];
      w0 = (w0 + b0) * scale;
      w1 = (w1 + b1) * scale;
      w2 = (w2 + b2) * scale;
      const float4 n4 = *reinterpret_cast<const float4*>(sNd + j * 4);
      const float ndj[3] = {n4.x, n4.y, n4.z};
      ds += w0 * g[0];
      const float m1 = w1 * g[1];
#pragma unroll
      for (int d = 0; d < DIM; ++d) dv[d] += ndj[d] * m1 + w2 * g[2 + d];
    }
    if (EXACT || c < HP) {
      sTS[i * 2 * HP + c] = active ? round_to<T>(to_f(s[node * H + c]) + clip(ds)) : 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        sV1[(i * DIM + d) * HP + c] =
            active ? round_to<T>(to_f(v[node * DIM * H + d * H + c]) + clip(dv[d])) : 0.f;
    }
  }
  // rows past the last receiver stay 0 through the node phase
  for (int i = nodes; i < TR; ++i) {
    if (c < HP) {
      sTS[i * 2 * HP + c] = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) sV1[(i * DIM + d) * HP + c] = 0.f;
    }
  }
  __syncthreads();

  // ---- node phase. vm = v1 @ vmix_w: thread c computes vl (column c) and
  // vr (column H + c) of every row; weights past row H read as 0
  float vl[ROWS], dot[TR];
  {
    const T* W = static_cast<const T*>(a.vmix_w);
    float vr[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) vl[r] = vr[r] = 0.f;
    for (int kk = 0; kk < HP; kk += 4) {
      float wl[4], wr[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = EXACT || (active && kk + q < H);
        wl[q] = in ? to_f(__ldg(W + (kk + q) * 2 * H + c)) : 0.f;
        wr[q] = in ? to_f(__ldg(W + (kk + q) * 2 * H + H + c)) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(sV1 + r * HP + kk);
        vl[r] = fmaf(x.x, wl[0], vl[r]);
        vr[r] = fmaf(x.x, wr[0], vr[r]);
        vl[r] = fmaf(x.y, wl[1], vl[r]);
        vr[r] = fmaf(x.y, wr[1], vr[r]);
        vl[r] = fmaf(x.z, wl[2], vl[r]);
        vr[r] = fmaf(x.z, wr[2], vr[r]);
        vl[r] = fmaf(x.w, wl[3], vl[r]);
        vr[r] = fmaf(x.w, wr[3], vr[r]);
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float nrm = 0.f, dt = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        nrm += vr[i * DIM + d] * vr[i * DIM + d];
        dt += vr[i * DIM + d] * vl[i * DIM + d];
      }
      dot[i] = dt;
      if (EXACT || c < HP)
        sTS[i * 2 * HP + HP + c] = active ? round_to<T>(sqrtf(nrm + kEps)) : 0.f;
    }
  }
  __syncthreads();

  // z = silu(ts @ mix_w1 + mix_b1), ts = [s1, |vr|]: weight rows kk of the
  // first half, H + kk of the second
  {
    const T* W = static_cast<const T*>(a.mix_w1);
    float z[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) z[i] = 0.f;
    for (int half = 0; half < 2; ++half) {
      for (int kk = 0; kk < HP; kk += 4) {
        float w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = EXACT || (active && kk + q < H) ? to_f(__ldg(W + (half * H + kk + q) * H + c))
                                                 : 0.f;
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 x = *reinterpret_cast<const float4*>(sTS + i * 2 * HP + half * HP + kk);
          z[i] = fmaf(x.x, w[0], z[i]);
          z[i] = fmaf(x.y, w[1], z[i]);
          z[i] = fmaf(x.z, w[2], z[i]);
          z[i] = fmaf(x.w, w[3], z[i]);
        }
      }
    }
    const float b = active ? a.mix_b1[c] : 0.f;
    if (EXACT || c < HP) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float zi = z[i] + b;
        sZ[i * HP + c] = active ? round_to<T>(zi * (1.f / (1.f + expf(-zi)))) : 0.f;
      }
    }
  }
  __syncthreads();

  // m = z @ mix_w2 + mix_b2: thread c computes columns c, H + c, 2H + c,
  // then the outputs of channel c
  if (!active) return;
  {
    const T* W = static_cast<const T*>(a.mix_w2);
    float m0[TR], m1[TR], m2[TR];
#pragma unroll
    for (int i = 0; i < TR; ++i) m0[i] = m1[i] = m2[i] = 0.f;
    for (int kk = 0; kk < HP; kk += 4) {
      float w0[4], w1[4], w2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = EXACT || kk + q < H;
        const T* wr = W + (kk + q) * 3 * H + c;
        w0[q] = in ? to_f(__ldg(wr)) : 0.f;
        w1[q] = in ? to_f(__ldg(wr + H)) : 0.f;
        w2[q] = in ? to_f(__ldg(wr + 2 * H)) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(sZ + i * HP + kk);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          m0[i] = fmaf(xs[q], w0[q], m0[i]);
          m1[i] = fmaf(xs[q], w1[q], m1[i]);
          m2[i] = fmaf(xs[q], w2[q], m2[i]);
        }
      }
    }
    const float bs = a.mix_b2[c], bv = a.mix_b2[H + c], bd = a.mix_b2[2 * H + c];
    T* s_out = static_cast<T*>(a.s_out);
    T* v_out = static_cast<T*>(a.v_out);
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      if (i < nodes) {
        const int64_t node = node0 + i;
        s_out[node * H + c] =
            from_f<T>(sTS[i * 2 * HP + c] + clip((m0[i] + bs) + (m2[i] + bd) * dot[i]));
        const float dv2 = m1[i] + bv;
#pragma unroll
        for (int d = 0; d < DIM; ++d)
          v_out[node * DIM * H + d * H + c] =
              from_f<T>(sV1[(i * DIM + d) * HP + c] + clip(vl[i * DIM + d] * dv2));
      }
    }
  }
}

// K5 past H = 256 or R = 64 (H <= 1024, R <= 256): painn_layer_wide, one
// code path for every such width. 256 threads; thread t owns the channels
// t, t + 256, ... in turn (so a thread's registers do not grow with H), and
// `tr` receivers per block (at most TRW; fewer where the tile's rows would
// not fit the 227 KB: ~40 KB per receiver at H = 1,024 in 3D).
// - Edge phase, per receiver: its K basis rows (R values, zero to RQ = 4
//   ceil(R / 4), then the scale), directions and sender indices are staged
//   in shared memory; for each owned channel the filters of EG = 8 edges at
//   a time are summed over the whole basis in float32, four basis values a
//   step (R any width: no filter columns held in registers; each filter
//   weight read from L1/L2 feeds 8 FMAs), then the edges' sender values are
//   read from packed and the K-sums taken in k order.
// - Node phase: the tile's v1_d, vl_d, ts, the vr.vl dots and z rows live
//   in shared memory, HP = 4 ceil(H / 4) wide and zero past H; each product
//   is the threads' own FMA loop over the weight rows, four rows a step
//   (float4 reads of the tile's rows, broadcast; the weights of two steps in
//   flight), channel by channel, summed in chunks of KC = 64 weight rows
//   whose sums are then added: float32 rounding grows with ~sqrt(KC) +
//   sqrt(H / KC) steps, not sqrt(H). With running sums, at H = 1,024 in 3D
//   the bf16 outputs read 1.6e-4 to 1.9e-4 from the plain version summed in
//   float64 in the relative 2-norm, farther than the float32 plain version's
//   1.4e-4 to 1.7e-4 (the roundings' ties of long sums). The casts are those
//   of painn_layer.
// The weights are read once per tile of tr receivers (7 H^2 T words).
constexpr int kWideHidden = 1024, kWideRbf = 256;  // ops/painn_msg.py MAX_HIDDEN, MAX_RBF
constexpr int WT = 256, EG = 8, TRW = 8, KC = 64;

__host__ __device__ inline int pad4(int x) { return (x + 3) / 4 * 4; }
// shared memory (float32 words) of a wide tile of tr receivers
__host__ __device__ inline int wide_tile_words(int tr, int h, int dim) {
  return tr * pad4(h) * (2 * dim + 4);
}
// a receiver's stage: K basis rows of RQ + 4 words, K directions of 4, K
// sender rows
__host__ __device__ inline int wide_stage_words(int k, int r, int dim) {
  return k * (pad4(r) + 4 + 4 + 1);
}

template <typename T, int DIM>
__global__ void __launch_bounds__(WT) painn_layer_wide(const Args a, int tr) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.h, R = a.r, K = a.k, HP = pad4(a.h), RQ = pad4(a.r), RS = RQ + 4;
  float* sV1 = smem;                 // (tr DIM, HP) v1_d, row i * DIM + d
  float* sVL = sV1 + tr * DIM * HP;  // (tr DIM, HP) vl_d
  float* sTS = sVL + tr * DIM * HP;  // (tr, 2 HP) ts = [s1, |vr|]
  float* sDot = sTS + tr * 2 * HP;   // (tr, HP) sum_d vr_d vl_d
  float* sZ = sDot + tr * HP;        // (tr, HP) z
  float* sPhi = sZ + tr * HP;        // (K, RS) basis rows, the scale at RQ
  float* sNd = sPhi + K * RS;        // (K, 4)
  int* sSid = reinterpret_cast<int*>(sNd + K * 4);  // (K)
  const int tid = threadIdx.x;
  const int node0 = blockIdx.x * tr;
  const int nodes = min(tr, a.n - node0);
  const T* packed = static_cast<const T*>(a.packed);
  const T* phi = static_cast<const T*>(a.phi);
  const T* nd = static_cast<const T*>(a.nd);
  const T* s = static_cast<const T*>(a.s);
  const T* v = static_cast<const T*>(a.v);
  const T* fw = static_cast<const T*>(a.filt_w);

  // zeros that no stage or channel overwrites: basis values R .. RQ - 1, the
  // tile's columns H .. HP - 1
  for (int i = tid; i < K * (RQ - R); i += WT) sPhi[(i / (RQ - R)) * RS + R + i % (RQ - R)] = 0.f;
  for (int i = tid; i < tr * (HP - H); i += WT) {
    const int row = i / (HP - H), c = H + i % (HP - H);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      sV1[(row * DIM + d) * HP + c] = 0.f;
      sVL[(row * DIM + d) * HP + c] = 0.f;
    }
    sTS[row * 2 * HP + c] = sTS[row * 2 * HP + HP + c] = 0.f;
    sDot[row * HP + c] = sZ[row * HP + c] = 0.f;
  }

  // ---- edge phase
  for (int i = 0; i < nodes; ++i) {
    const int64_t node = node0 + i;
    __syncthreads();  // the previous receiver's stage is consumed
    for (int e = tid; e < K * (R + 1); e += WT) {
      const int q = e % (R + 1);
      sPhi[(e / (R + 1)) * RS + (q < R ? q : RQ)] = to_f(phi[node * K * (R + 1) + e]);
    }
    for (int e = tid; e < K * DIM; e += WT) sNd[(e / DIM) * 4 + e % DIM] = to_f(nd[node * K * DIM + e]);
    for (int e = tid; e < K; e += WT) sSid[e] = a.sidx[node * K + e];
    __syncthreads();
    for (int c = tid; c < H; c += WT) {
      const float b0 = a.filt_b[c], b1 = a.filt_b[H + c], b2 = a.filt_b[2 * H + c];
      float ds = 0.f, dv[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) dv[d] = 0.f;
      for (int j0 = 0; j0 < K; j0 += EG) {
        float w[EG][3];
#pragma unroll
        for (int u = 0; u < EG; ++u) w[u][0] = w[u][1] = w[u][2] = 0.f;
        for (int q = 0; q < RQ; q += 4) {
          float f0[4], f1[4], f2[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const bool in = q + t < R;
            const T* col = fw + (int64_t)(q + t) * 3 * H + c;
            f0[t] = in ? to_f(__ldg(col)) : 0.f;
            f1[t] = in ? to_f(__ldg(col + H)) : 0.f;
            f2[t] = in ? to_f(__ldg(col + 2 * H)) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < EG; ++u) {
            if (j0 + u < K) {
              const float4 p4 = *reinterpret_cast<const float4*>(sPhi + (j0 + u) * RS + q);
              const float ps[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                w[u][0] = fmaf(ps[t], f0[t], w[u][0]);
                w[u][1] = fmaf(ps[t], f1[t], w[u][1]);
                w[u][2] = fmaf(ps[t], f2[t], w[u][2]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < EG; ++u) {
          const int j = j0 + u;
          if (j < K) {
            const float scale = sPhi[j * RS + RQ];
            const float w0 = (w[u][0] + b0) * scale, w1 = (w[u][1] + b1) * scale,
                        w2 = (w[u][2] + b2) * scale;
            float g[2 + DIM];
            load_sender<T, DIM>(packed, sSid[j], a.m, c, H, g);
            ds += w0 * g[0];
            const float m1 = w1 * g[1];
#pragma unroll
            for (int d = 0; d < DIM; ++d) dv[d] += sNd[j * 4 + d] * m1 + w2 * g[2 + d];
          }
        }
      }
      sTS[i * 2 * HP + c] = round_to<T>(to_f(s[node * H + c]) + clip(ds));
#pragma unroll
      for (int d = 0; d < DIM; ++d)
        sV1[(i * DIM + d) * HP + c] =
            round_to<T>(to_f(v[node * DIM * H + d * H + c]) + clip(dv[d]));
    }
  }
  for (int i = nodes; i < tr; ++i)  // rows past the last receiver stay 0
    for (int c = tid; c < H; c += WT) {
      sTS[i * 2 * HP + c] = 0.f;
#pragma unroll
      for (int d = 0; d < DIM; ++d) sV1[(i * DIM + d) * HP + c] = 0.f;
    }
  __syncthreads();

  // ---- node phase. vm = v1 @ vmix_w: vl (column c), vr (column H + c)
  {
    const T* W = static_cast<const T*>(a.vmix_w);
    for (int c = tid; c < H; c += WT) {
      float vl[TRW * DIM], vr[TRW * DIM];
#pragma unroll
      for (int r = 0; r < TRW * DIM; ++r) vl[r] = vr[r] = 0.f;
      for (int k0 = 0; k0 < HP; k0 += KC) {
        float cl[TRW * DIM], cr[TRW * DIM];  // this chunk's sums
#pragma unroll
        for (int r = 0; r < TRW * DIM; ++r) cl[r] = cr[r] = 0.f;
        const int k1 = min(k0 + KC, HP);
#pragma unroll 2
        for (int kk = k0; kk < k1; kk += 4) {
          float wl[4], wr[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const bool in = kk + t < H;
            wl[t] = in ? to_f(__ldg(W + (int64_t)(kk + t) * 2 * H + c)) : 0.f;
            wr[t] = in ? to_f(__ldg(W + (int64_t)(kk + t) * 2 * H + H + c)) : 0.f;
          }
#pragma unroll
          for (int r = 0; r < TRW * DIM; ++r) {
            if (r < tr * DIM) {
              const float4 x = *reinterpret_cast<const float4*>(sV1 + r * HP + kk);
              cl[r] = fmaf(x.x, wl[0], cl[r]);
              cr[r] = fmaf(x.x, wr[0], cr[r]);
              cl[r] = fmaf(x.y, wl[1], cl[r]);
              cr[r] = fmaf(x.y, wr[1], cr[r]);
              cl[r] = fmaf(x.z, wl[2], cl[r]);
              cr[r] = fmaf(x.z, wr[2], cr[r]);
              cl[r] = fmaf(x.w, wl[3], cl[r]);
              cr[r] = fmaf(x.w, wr[3], cr[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < TRW * DIM; ++r) {
          vl[r] += cl[r];
          vr[r] += cr[r];
        }
      }
#pragma unroll
      for (int i = 0; i < TRW; ++i) {
        if (i < tr) {
          float nrm = 0.f, dt = 0.f;
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            nrm += vr[i * DIM + d] * vr[i * DIM + d];
            dt += vr[i * DIM + d] * vl[i * DIM + d];
            sVL[(i * DIM + d) * HP + c] = vl[i * DIM + d];
          }
          sDot[i * HP + c] = dt;
          sTS[i * 2 * HP + HP + c] = round_to<T>(sqrtf(nrm + kEps));
        }
      }
    }
  }
  __syncthreads();

  // z = T(silu(ts @ mix_w1 + mix_b1)), ts = [s1, |vr|]: weight rows kk of
  // the first half, H + kk of the second
  {
    const T* W = static_cast<const T*>(a.mix_w1);
    for (int c = tid; c < H; c += WT) {
      float z[TRW];
#pragma unroll
      for (int i = 0; i < TRW; ++i) z[i] = 0.f;
      for (int half = 0; half < 2; ++half) {
        for (int k0 = 0; k0 < HP; k0 += KC) {
          float cz[TRW];  // this chunk's sums
#pragma unroll
          for (int i = 0; i < TRW; ++i) cz[i] = 0.f;
          const int k1 = min(k0 + KC, HP);
#pragma unroll 2
          for (int kk = k0; kk < k1; kk += 4) {
            float w[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              w[t] = kk + t < H ? to_f(__ldg(W + (int64_t)(half * H + kk + t) * H + c)) : 0.f;
#pragma unroll
            for (int i = 0; i < TRW; ++i) {
              if (i < tr) {
                const float4 x =
                    *reinterpret_cast<const float4*>(sTS + i * 2 * HP + half * HP + kk);
                cz[i] = fmaf(x.x, w[0], cz[i]);
                cz[i] = fmaf(x.y, w[1], cz[i]);
                cz[i] = fmaf(x.z, w[2], cz[i]);
                cz[i] = fmaf(x.w, w[3], cz[i]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < TRW; ++i) z[i] += cz[i];
        }
      }
      const float b = a.mix_b1[c];
#pragma unroll
      for (int i = 0; i < TRW; ++i) {
        if (i < tr) {
          const float zi = z[i] + b;
          sZ[i * HP + c] = round_to<T>(zi * (1.f / (1.f + expf(-zi))));
        }
      }
    }
  }
  __syncthreads();

  // m = z @ mix_w2 + mix_b2, then the outputs of channel c
  {
    const T* W = static_cast<const T*>(a.mix_w2);
    T* s_out = static_cast<T*>(a.s_out);
    T* v_out = static_cast<T*>(a.v_out);
    for (int c = tid; c < H; c += WT) {
      float m0[TRW], m1[TRW], m2[TRW];
#pragma unroll
      for (int i = 0; i < TRW; ++i) m0[i] = m1[i] = m2[i] = 0.f;
      for (int k0 = 0; k0 < HP; k0 += KC) {
        float c0[TRW], c1[TRW], c2[TRW];  // this chunk's sums
#pragma unroll
        for (int i = 0; i < TRW; ++i) c0[i] = c1[i] = c2[i] = 0.f;
        const int k1 = min(k0 + KC, HP);
#pragma unroll 2
        for (int kk = k0; kk < k1; kk += 4) {
          float w0[4], w1[4], w2[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const bool in = kk + t < H;
            const T* wr = W + (int64_t)(kk + t) * 3 * H + c;
            w0[t] = in ? to_f(__ldg(wr)) : 0.f;
            w1[t] = in ? to_f(__ldg(wr + H)) : 0.f;
            w2[t] = in ? to_f(__ldg(wr + 2 * H)) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < TRW; ++i) {
            if (i < tr) {
              const float4 x = *reinterpret_cast<const float4*>(sZ + i * HP + kk);
              const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                c0[i] = fmaf(xs[t], w0[t], c0[i]);
                c1[i] = fmaf(xs[t], w1[t], c1[i]);
                c2[i] = fmaf(xs[t], w2[t], c2[i]);
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TRW; ++i) {
          m0[i] += c0[i];
          m1[i] += c1[i];
          m2[i] += c2[i];
        }
      }
      const float bs = a.mix_b2[c], bv = a.mix_b2[H + c], bd = a.mix_b2[2 * H + c];
#pragma unroll
      for (int i = 0; i < TRW; ++i) {
        if (i < nodes) {
          const int64_t node = node0 + i;
          s_out[node * H + c] = from_f<T>(sTS[i * 2 * HP + c] +
                                          clip((m0[i] + bs) + (m2[i] + bd) * sDot[i * HP + c]));
          const float dv2 = m1[i] + bv;
#pragma unroll
          for (int d = 0; d < DIM; ++d)
            v_out[node * DIM * H + d * H + c] = from_f<T>(
                sV1[(i * DIM + d) * HP + c] + clip(sVL[(i * DIM + d) * HP + c] * dv2));
        }
      }
    }
  }
}

// receivers per block of the wide instance: TRW, fewer where the tile and
// a receiver's stage would not fit a block's shared memory; 0 if none fits
inline int wide_tile_rows(int h, int k, int r, int dim) {
  const int free = 232448 / 4 - wide_stage_words(k, r, dim);
  const int rows = free <= 0 ? 0 : free / (pad4(h) * (2 * dim + 4));
  return rows < TRW ? rows : TRW;
}

template <typename T, int DIM>
int launch_wide(const Args& a, cudaStream_t stream) {
  const int tr = wide_tile_rows(a.h, a.k, a.r, DIM);
  if (tr < 1) return (int)cudaErrorInvalidValue;  // K too large for one block
  const int smem = (wide_tile_words(tr, a.h, DIM) + wide_stage_words(a.k, a.r, DIM)) * 4;
  cudaError_t err = cudaFuncSetAttribute(painn_layer_wide<T, DIM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  painn_layer_wide<T, DIM><<<lbt::ceil_div(a.n, tr), WT, smem, stream>>>(a, tr);
  return (int)cudaGetLastError();
}

template <typename T, int DIM, int HT, int RC, bool EXACT = false>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = Smem<RC, DIM>(a.h).bytes(a.k);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // K too large for one block
  cudaError_t err = cudaFuncSetAttribute(painn_layer<T, DIM, HT, RC, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  painn_layer<T, DIM, HT, RC, EXACT><<<lbt::ceil_div(a.n, TR), HT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instance for (H, R): 128 or 256 threads, basis capacity 20 or 64;
// the shipped H = 128, R = 20 exactly; the wide instance past H = 256 or
// R = 64
template <typename T, int DIM>
int launch_width(const Args& a, cudaStream_t stream) {
  if (a.h > kMaxHidden || a.r > kMaxRbf) return launch_wide<T, DIM>(a, stream);
  if (a.h == 128 && a.r == 20) return launch<T, DIM, 128, 20, true>(a, stream);
  if (a.h <= 128)
    return a.r <= 20 ? launch<T, DIM, 128, 20>(a, stream) : launch<T, DIM, 128, 64>(a, stream);
  return a.r <= 20 ? launch<T, DIM, 256, 20>(a, stream) : launch<T, DIM, 256, 64>(a, stream);
}

}  // namespace

// ptrs (host array of device pointers), in order:
//   0 packed, 1 sidx (int32), 2 phi, 3 nd, 4 s, 5 v, 6 filt_w, 7 filt_b,
//   8 vmix_w, 9 mix_w1, 10 mix_b1, 11 mix_w2, 12 mix_b2, 13 s_out, 14 v_out.
// Matrices and activations in the compute type (is_bf16 ? bf16 : float32),
// biases float32. n receivers, k slots each, m >= n rows of packed; h in
// [1, 1024], r in [1, 256] (else cudaErrorInvalidValue).
LBT_EXPORT int lbt_painn_layer(const void* const* ptrs, int n, int k, int m, int h, int r,
                               int dim, int is_bf16, cudaStream_t stream) {
  if (h < 1 || h > kWideHidden || r < 1 || r > kWideRbf || n < 1 || k < 1 || m < n ||
      (dim != 2 && dim != 3))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.packed = ptrs[0];
  a.sidx = static_cast<const int32_t*>(ptrs[1]);
  a.phi = ptrs[2];
  a.nd = ptrs[3];
  a.s = ptrs[4];
  a.v = ptrs[5];
  a.filt_w = ptrs[6];
  a.filt_b = static_cast<const float*>(ptrs[7]);
  a.vmix_w = ptrs[8];
  a.mix_w1 = ptrs[9];
  a.mix_b1 = static_cast<const float*>(ptrs[10]);
  a.mix_w2 = ptrs[11];
  a.mix_b2 = static_cast<const float*>(ptrs[12]);
  a.s_out = const_cast<void*>(ptrs[13]);
  a.v_out = const_cast<void*>(ptrs[14]);
  a.n = n;
  a.k = k;
  a.m = m;
  a.h = h;
  a.r = r;
  if (is_bf16)
    return dim == 3 ? launch_width<bf16, 3>(a, stream) : launch_width<bf16, 2>(a, stream);
  return dim == 3 ? launch_width<float, 3>(a, stream) : launch_width<float, 2>(a, stream);
}
