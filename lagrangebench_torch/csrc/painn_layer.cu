// K5: one fused PaiNN layer (everything after the interaction context net),
// dense (N, K) layout, with the sender gather inside.
//
// Replaces: lagrangebench_tpu/ops/painn_msg.py::_layer_kernel, launched by
// _painn_layer_pallas, and the gather `packed[senders]` in front of it
// (lagrangebench_tpu/models/painn.py), which the TPU kernel takes outside
// because Mosaic has no row gather. Per receiver, with H channels (128 in
// the shipped configs), R radial basis functions (20, build_painn), g_k = packed[sidx[k]] the k-th sender's row [x1, x2, u_d]
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
// per receiver: ~17.5 GFLOP, ~0.26 ms at the CUDA cores' 67 TFLOP/s (~0.11
// ms as 3xTF32 on the tensor cores).
//
// Two designs. Past H = 256 or R = 64 the tensor-core design below
// (painn_edge_tc, painn_node_tc). Up to there, the narrow instances
// (painn_layer): the products stay on the CUDA cores in float32. The filter
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
constexpr int kMaxHidden = 256, kMaxRbf = 64;  // the widest narrow instance (tensor cores above)
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

// K5 past H = 256 or R = 64 (any H and R): the tensor-core design, one code
// path for every such width, in four launches whose intermediates go
// through device memory (each <= 0.2 GB at 16,000 x 3 x 1,024 float32):
//
//   painn_edge_tc         the filters on the tensor cores, the gathers, the
//                         messages and their K-sums:  s1 -> ts[:, 0], v1
//   painn_node_tc<kVmix>  vm_d = v1_d @ vmix_w:  vl_d, |vr| -> ts[:, 1],
//                         sum_d vr_d vl_d
//   painn_node_tc<kMix1>  z = T(silu(ts @ mix_w1 + mix_b1))
//   painn_node_tc<kOut>   m = z @ mix_w2 + mix_b2, then s_out and v_out
//
// Bound on an H100 (H = 512, R = 20, 16,000 x 40, float32): the products
// are ~139 GFLOP, 2.08 ms at the CUDA cores' 67 TFLOP/s; on the tensor
// cores ~0.80 ms as three TF32 products each (495 TFLOP/s) and ~0.13 ms in
// bf16. The bytes the layer must move are ~0.15 ms; beyond them the sender
// gather reads 16,000 x 40 rows of 5H values (6.55 GB in float32), mostly
// from device memory (the particles' order is the model's; random in the
// synthetic data). Measured (experiments/mp_times.py --only k5, H100): ~5.9
// ms in float32, 2.5 in bf16, against 19.1 and 23.0 for the thread-per-
// channel design it replaced; the edge kernel ~2.5 ms, the node products
// ~3.4 (float32) and ~0.9 (bf16).
//
// Products: mma.sync (m16n8k8 TF32, m16n8k16 bf16), operands K-major in
// shared memory (both TF32 operands must be; the wrapper stages every
// weight transposed and zero-padded once per call: filt_w as (3, HP, RK),
// vmix_w (2, HP, HP), mix_w1 (HP, 2 HP), mix_w2 (3, HP, HP), HP = 64
// ceil(H / 64), RK = R rounded up to a k-step), fragments read as 32-bit
// words, so that the two types share every address: a bf16 word holds two
// k values where a TF32 word holds one. float32 keeps float32 accuracy by
// 3xTF32: each operand splits into a TF32 part and the TF32 rounding of the
// rest (cvt.rna), and a product is lo x hi + hi x lo + hi x hi, each exact
// in float32; the three are summed by the tensor cores into a fresh
// accumulator per k-step, which is then added to the running sum in
// float32 (round to nearest; the tensor cores' own sums truncate). A single
// TF32 pass would miss the 1e-4 gate. bf16 takes one bf16 product with
// float32 sums; the roundings T() sit where painn_layer_plain puts them. No
// atomics: every output element is written by one thread, so two launches
// give the same bits.
// - Edge kernel: a block of 4 warps x 16 channels and 32 receivers; each
//   warp walks the receivers on its own (no block barrier). A warp
//   computes the filters of its 16 channels x 3 as the product filt_w^T
//   (channels on M, one m16 tile per filter set) x basis^T (a receiver's
//   edges on N, one n8 tile at a time, k = R), so that thread (g, t) holds
//   the three filters of its channel pair 2g, 2g + 1 at its edges 2t, 2t +
//   1: the messages are elementwise in registers, and a receiver's K-sum
//   runs along the thread's own edges and then across the quad (two
//   shuffles). The channel pair makes each sender value one 8-byte load
//   (4-byte in bf16) where H is even. The A fragments (filt_w^T) sit in
//   shared memory, pre-split for 3xTF32 once per block where R takes 2 or 3
//   k-steps (R <= 24 in float32, 48 in bf16), split at each use past that.
//   The basis words (B), scales, directions and sender rows are read
//   through L1 (the block's warps read the same receiver's rows). The
//   kernel is bound by the gather's latency from device memory: what hides
//   it is a tile's loads all in flight at once (raw bits, converted at use;
//   see Raw) and warps in flight (<= 128 registers, 16 warps per SM). A
//   block barrier per staged receiver (6.3 ms at H = 512), A fragments held
//   in registers (161 registers, 12 warps per SM: 3.4 ms) and a software
//   pipeline of the next tile's loads (200 registers, 8 warps: 6.1 ms) were
//   slower.
// - Node kernels: one generic GEMM, 64 receivers x CW columns of NS weight
//   sections for NA row groups (kVmix: the DIM axes' v1_d rows against the
//   vl and vr sections, so that |vr| and sum_d vr_d vl_d are elementwise in
//   the epilogue; kOut: the three sections of mix_w2, so that the outputs
//   are), 8 warps of 16 rows x CW / 2 columns, the k axis in stages of KC
//   = 64 through a two-stage cp.async ring (a ring of four 32-k stages ran
//   3-8% slower), the float32 weights staged as (hi, lo) TF32 pairs that
//   the wrapper split (tf32_pairs). Each stage's sums start at 0 and are
//   then added to the running sums: float32 rounding grows with ~sqrt(KC) +
//   sqrt(K / KC) steps, not sqrt(K) (at H = 1,024 in 3D the bf16 gate reads
//   1.3e-4 against its 2e-4). They run at ~100-150 TFLOP/s of tensor-core
//   products; wgmma is the next step there.
constexpr int kSmemLimit = 232448;
constexpr int TC_RG = 32;     // receivers per edge block
constexpr int TC_EDGE_WARPS = 4;  // warps per edge block (16 channels each)
constexpr int TC_KC = 64;     // k elements per stage and per sum chunk of the node products
constexpr int TC_ROWS = 64;   // receivers per node tile
constexpr int TC_THREADS = 256;  // node kernels; the edge kernel 32 TC_EDGE_WARPS

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of one k-step, read as 32-bit words from K-major rows of
// `stride` words: A's 16 rows at p = row g, word t of the tile (a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)), B's 8 rows (edges or
// columns) at p = row g, word t (b0 word t, b1 word t + 4).
template <typename T>
struct Tc;

template <>
struct Tc<float> {  // 3xTF32
  static constexpr int EPW = 1;  // k elements per word
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  __device__ static void split(uint32_t w, uint32_t& hi, uint32_t& lo) {
    const float x = __uint_as_float(w);
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  }
  __device__ static void make_a(A& f, uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
    split(w0, f.hi[0], f.lo[0]);
    split(w1, f.hi[1], f.lo[1]);
    split(w2, f.hi[2], f.lo[2]);
    split(w3, f.hi[3], f.lo[3]);
  }
  __device__ static void make_b(B& f, uint32_t w0, uint32_t w1) {
    split(w0, f.hi[0], f.lo[0]);
    split(w1, f.hi[1], f.lo[1]);
  }
  __device__ static void load_a(A& f, const uint32_t* p, int stride) {
    make_a(f, p[0], p[8 * stride], p[4], p[8 * stride + 4]);
  }
  // a word staged pre-split: (hi, lo), one 8-byte load
  using Word = uint2;
  __device__ static Word pre(uint32_t w) {
    Word r;
    split(w, r.x, r.y);
    return r;
  }
  __device__ static void load_b_pre(B& f, const Word* p) {
    const Word w0 = p[0], w1 = p[4];
    f.hi[0] = w0.x;
    f.lo[0] = w0.y;
    f.hi[1] = w1.x;
    f.lo[1] = w1.y;
  }
  __device__ static void load_pre(A& f, const Word* p, int stride) {
    const Word w[4] = {p[0], p[8 * stride], p[4], p[8 * stride + 4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f.hi[i] = w[i].x;
      f.lo[i] = w[i].y;
    }
  }
  // the k-step's three products into a fresh accumulator, then added to d
  // in float32 (round to nearest): with every product of a long sum chained
  // through the tensor cores' own (truncating) float32 sums, PaiNN-2-320's
  // card-vs-CPU forward read 1.17e-5 against its 1e-5 gate (8.3e-6 so)
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] += c[i];
  }
};

template <>
struct Tc<bf16> {
  static constexpr int EPW = 2;
  struct A {
    uint32_t w[4];
  };
  struct B {
    uint32_t w[2];
  };
  __device__ static void make_a(A& f, uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
    f.w[0] = w0;
    f.w[1] = w1;
    f.w[2] = w2;
    f.w[3] = w3;
  }
  __device__ static void make_b(B& f, uint32_t w0, uint32_t w1) {
    f.w[0] = w0;
    f.w[1] = w1;
  }
  __device__ static void load_a(A& f, const uint32_t* p, int stride) {
    make_a(f, p[0], p[8 * stride], p[4], p[8 * stride + 4]);
  }
  using Word = uint32_t;
  __device__ static Word pre(uint32_t w) { return w; }
  __device__ static void load_pre(A& f, const Word* p, int stride) { load_a(f, p, stride); }
  __device__ static void load_b_pre(B& f, const Word* p) { make_b(f, p[0], p[4]); }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) { mma_bf16(d, a.w, b.w); }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The layer's arguments and the design's staged weights and buffers (the
// wrapper's pointers 15-26, ops/painn_msg.py tc_buffers).
struct TcArgs {
  Args a;
  const void* filt_t;   // (3, HP, RK) T, filt_w transposed
  const float* filt_b;  // (3, HP)
  const void* vmix_t;   // (2, HP, HP) T: [section][column][k]; float32 as (hi, lo) TF32 pairs
  const void* mix1_t;   // (HP, 2 HP) T: [column][half][k]; the same
  const float* mix_b1;  // (HP)
  const void* mix2_t;   // (3, HP, HP) T; the same
  const float* mix_b2;  // (3, HP)
  void* v1;             // (N, DIM, HP) T
  void* ts;             // (N, 2, HP) T: [s1, |vr|]
  void* z;              // (N, HP) T
  float* vl;            // (N, DIM, HP)
  float* dot;           // (N, HP) sum_d vr_d vl_d
  int hp, rk, kp;       // HP and RK (the wrapper's padding), KP = 8 ceil(K / 8)
};

// The edge kernel's filter k-steps KS = RK / (8 EPW): at 2 or 3 (R <= 24 in
// float32, R <= 48 in bf16; PaiNN's R = 20) the block stages its filter
// rows pre-split (an (hi, lo) pair per float32 word) and the k loop is
// unrolled; otherwise the rows are staged raw and split at each use (any
// R; PERF.md section 6 times both forms at R = 20); where the raw rows do
// not fit a block (R past 298 in float32, 596 in bf16) the kernel streams
// them from device memory (through L1) at each k-step instead (KS = -1).
inline int edge_ksteps(int rk, bool is_bf16) {
  const int steps = rk / (is_bf16 ? 16 : 8);
  return steps == 2 || steps == 3 ? steps : 0;
}
inline int64_t edge_staged_bytes(int rk, bool is_bf16) {
  const int word = edge_ksteps(rk, is_bf16) && !is_bf16 ? 8 : 4;  // pre-split: (hi, lo)
  return (int64_t)TC_EDGE_WARPS * 3 * 16 * (rk / (is_bf16 ? 2 : 1) + 4) * word;
}
// the edge kernel's dynamic shared memory: its staged filter rows, or 0
// where they are streamed
inline int edge_smem(int rk, bool is_bf16) {
  const int64_t bytes = edge_staged_bytes(rk, is_bf16);
  return bytes <= kSmemLimit ? (int)bytes : 0;
}
static_assert(TC_EDGE_WARPS * 3 * 16 * (24 + 4) * 8 <= kSmemLimit,
              "the edge kernel's pre-split filter rows fit one block");

// A warp owns 16 channels, thread (g, t) the pair 2g, 2g + 1 (rows g and g
// + 8 of each of its three m16 tiles, one per filter set), so that a
// sender's two values are one 8-byte (bf16: 4-byte) load where H is even.
__device__ __forceinline__ int tc_row_channel(int row) { return row < 8 ? 2 * row : 2 * row - 15; }

template <typename T>
__device__ __forceinline__ uint32_t basis_word(const T* row, int w, int r);
template <>
__device__ __forceinline__ uint32_t basis_word<float>(const float* row, int w, int r) {
  return w < r ? __float_as_uint(__ldg(row + w)) : 0u;
}
template <>
__device__ __forceinline__ uint32_t basis_word<bf16>(const bf16* row, int w, int r) {
  const uint32_t lo = 2 * w < r ? __bfloat16_as_ushort(__ldg(row + 2 * w)) : 0u;
  const uint32_t hi = 2 * w + 1 < r ? __bfloat16_as_ushort(__ldg(row + 2 * w + 1)) : 0u;
  return lo | (hi << 16);
}

// Values loaded as raw bits and converted where they are used, so that a
// tile's loads are all in flight before the first use: bf16 loads
// converted at once (and the pair-or-scalar choice made per load) left
// each of the edge kernel's gathers waiting on device memory in turn (the
// bf16 edge kernel 4.1 ms at H = 512, float32's 2.7; 1.65 so). Two: a
// sender's values at the thread's channels c, c + 1 (c even), one 8-byte
// (bf16: 4-byte) load where H is even.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using One = float;
  using Two = float2;
  __device__ static One one(const float* p) { return __ldg(p); }
  __device__ static float f(One x) { return x; }
  __device__ static Two two(const float* p) { return __ldg(reinterpret_cast<const float2*>(p)); }
  __device__ static Two two(const float* p, bool live0, bool live1) {
    return make_float2(live0 ? __ldg(p) : 0.f, live1 ? __ldg(p + 1) : 0.f);
  }
  __device__ static float lo(Two x) { return x.x; }
  __device__ static float hi(Two x) { return x.y; }
};
template <>
struct Raw<bf16> {
  using One = uint32_t;
  using Two = uint32_t;
  __device__ static One one(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static float f(One x) { return __uint_as_float(x << 16); }
  __device__ static Two two(const bf16* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ static Two two(const bf16* p, bool live0, bool live1) {
    const unsigned short* b = reinterpret_cast<const unsigned short*>(p);
    return (live0 ? (uint32_t)__ldg(b) : 0u) | ((live1 ? (uint32_t)__ldg(b + 1) : 0u) << 16);
  }
  __device__ static float lo(Two x) { return __uint_as_float(x << 16); }
  __device__ static float hi(Two x) { return __uint_as_float(x & 0xffff0000u); }
};

// KS > 0: the filter product's KS k-steps with A staged pre-split in
// shared memory; KS == 0: any k-steps, A staged raw and split at each use;
// KS == -1: any k-steps, A read from filt_t in device memory at each use
template <typename T, int DIM, int KS>
__global__ void __launch_bounds__(32 * TC_EDGE_WARPS, 4) painn_edge_tc(const TcArgs p) {
  using F = Tc<T>;
  using W = typename F::Word;
  extern __shared__ __align__(16) uint32_t sm[];
  const int H = p.a.h, R = p.a.r, K = p.a.k, M = p.a.m, HP = p.hp;
  const int RKW = p.rk / F::EPW, FS = RKW + 4, ksteps = RKW / 8;
  constexpr int nw = TC_EDGE_WARPS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int cb = blockIdx.x * 16 * nw;
  const int c0 = cb + warp * 16 + 2 * g;  // the thread's channels c0, c0 + 1
  const bool live0 = c0 < H, live1 = c0 + 1 < H, pair = live1 && (H % 2 == 0);

  // the block's filter rows: row j 16 nw + 16 w + i holds channel
  // tc_row_channel(i) of warp w, pre-split (KS > 0) or raw
  const uint32_t* ft = static_cast<const uint32_t*>(p.filt_t);  // (3, HP, RKW) words
  if constexpr (KS >= 0) {
    for (int i = tid; i < 3 * 16 * nw * RKW; i += 32 * nw) {
      const int row = i / RKW, w = i % RKW, j = row / (16 * nw), rb = row % (16 * nw);
      const int c = cb + (rb / 16) * 16 + tc_row_channel(rb % 16);
      const uint32_t word = c < HP ? ft[((int64_t)j * HP + c) * RKW + w] : 0u;
      if constexpr (KS > 0)
        reinterpret_cast<W*>(sm)[row * FS + w] = F::pre(word);
      else
        sm[row * FS + w] = word;
    }
  }
  float bias[3][2];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    bias[j][0] = c0 < HP ? p.filt_b[j * HP + c0] : 0.f;
    bias[j][1] = c0 < HP ? p.filt_b[j * HP + c0 + 1] : 0.f;
  }
  __syncthreads();

  const T* phi = static_cast<const T*>(p.a.phi);
  const T* nd = static_cast<const T*>(p.a.nd);
  const T* packed = static_cast<const T*>(p.a.packed);
  const int node1 = min(p.a.n, (int)(blockIdx.y + 1) * TC_RG);
  const int ntiles = p.kp / 8;
  for (int64_t node = (int64_t)blockIdx.y * TC_RG; node < node1; ++node) {
    float ds[2] = {0.f, 0.f}, dv[2][DIM];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int d = 0; d < DIM; ++d) dv[h][d] = 0.f;
    for (int nt = 0; nt < ntiles; ++nt) {
      // this thread's two edges 8 nt + 2t + e2: sender rows, scales,
      // directions, the senders' values as raw bits; a padded edge reads
      // edge K - 1's and takes scale 0
      using RW = Raw<T>;
      bool in[2];
      typename RW::One scale_r[2], nd_r[2][DIM];
      typename RW::Two gv[2][2 + DIM];
      const T* gr[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int edge = nt * 8 + 2 * t + e2;
        in[e2] = edge < K;
        const int64_t e = node * K + min(edge, K - 1);
        const int row = min(max(__ldg(p.a.sidx + e), 0), M - 1);
        scale_r[e2] = RW::one(phi + e * (R + 1) + R);
#pragma unroll
        for (int d = 0; d < DIM; ++d) nd_r[e2][d] = RW::one(nd + e * DIM + d);
        gr[e2] = packed + (int64_t)row * (2 + DIM) * H + min(c0, H - 1);
      }
      if (pair) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int q = 0; q < 2 + DIM; ++q) gv[e2][q] = RW::two(gr[e2] + q * H);
      } else {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
#pragma unroll
          for (int q = 0; q < 2 + DIM; ++q) gv[e2][q] = RW::two(gr[e2] + q * H, live0, live1);
      }
      // the filters of the tile's 8 edges: B = basis rows (edge 8 nt + g)
      float acc[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      const int eb = nt * 8 + g;
      const T* prow = phi + (node * K + min(eb, K - 1)) * (R + 1);
      const int rb = eb < K ? R : 0;  // padded edges read as zero rows
      if constexpr (KS > 0) {
        const W* sA = reinterpret_cast<const W*>(sm);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          typename F::B fb;
          F::make_b(fb, basis_word<T>(prow, ks * 8 + t, rb),
                    basis_word<T>(prow, ks * 8 + t + 4, rb));
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            typename F::A a;
            F::load_pre(a, sA + (j * 16 * nw + warp * 16 + g) * FS + ks * 8 + t, FS);
            F::mma(acc[j], a, fb);
          }
        }
      } else if constexpr (KS == 0) {
        for (int ks = 0; ks < ksteps; ++ks) {
          typename F::B fb;
          F::make_b(fb, basis_word<T>(prow, ks * 8 + t, rb),
                    basis_word<T>(prow, ks * 8 + t + 4, rb));
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            typename F::A a;
            F::load_a(a, sm + (j * 16 * nw + warp * 16 + g) * FS + ks * 8 + t, FS);
            F::mma(acc[j], a, fb);
          }
        }
      } else {  // fragment rows g, g + 8: channels c0, c0 + 1 of filter set j
        for (int ks = 0; ks < ksteps; ++ks) {
          typename F::B fb;
          F::make_b(fb, basis_word<T>(prow, ks * 8 + t, rb),
                    basis_word<T>(prow, ks * 8 + t + 4, rb));
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const uint32_t* r0 = ft + ((int64_t)j * HP + c0) * RKW + ks * 8 + t;
            const uint32_t* r1 = r0 + RKW;
            typename F::A a;
            F::make_a(a, __ldg(r0), __ldg(r1), __ldg(r0 + 4), __ldg(r1 + 4));
            F::mma(acc[j], a, fb);
          }
        }
      }
      // messages and this thread's part of the K-sums; acc[j][2 h + e2]
      // is filter j of channel c0 + h at edge 8 nt + 2t + e2
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const float scale = in[e2] ? RW::f(scale_r[e2]) : 0.f;
        float ndj[DIM], x[2 + DIM][2];
#pragma unroll
        for (int d = 0; d < DIM; ++d) ndj[d] = RW::f(nd_r[e2][d]);
#pragma unroll
        for (int q = 0; q < 2 + DIM; ++q) {
          x[q][0] = RW::lo(gv[e2][q]);
          x[q][1] = RW::hi(gv[e2][q]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float w0 = (acc[0][2 * h + e2] + bias[0][h]) * scale;
          const float w1 = (acc[1][2 * h + e2] + bias[1][h]) * scale;
          const float w2 = (acc[2][2 * h + e2] + bias[2][h]) * scale;
          ds[h] += w0 * x[0][h];
          const float m1 = w1 * x[1][h];
#pragma unroll
          for (int d = 0; d < DIM; ++d) dv[h][d] += ndj[d] * m1 + w2 * x[2 + d][h];
        }
      }
    }
    // the K-sums across the quad's edges
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ds[h] += __shfl_xor_sync(0xffffffffu, ds[h], o);
#pragma unroll
        for (int d = 0; d < DIM; ++d) dv[h][d] += __shfl_xor_sync(0xffffffffu, dv[h][d], o);
      }
    if (t == 0 && c0 < HP) {  // zeros past H: the node products' padding
      const T* s = static_cast<const T*>(p.a.s);
      const T* v = static_cast<const T*>(p.a.v);
      T* ts = static_cast<T*>(p.ts);
      T* v1 = static_cast<T*>(p.v1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + h;
        const bool live = c < H;
        ts[node * 2 * HP + c] =
            live ? from_f<T>(to_f(s[node * H + c]) + clip(ds[h])) : from_f<T>(0.f);
#pragma unroll
        for (int d = 0; d < DIM; ++d)
          v1[(node * DIM + d) * HP + c] =
              live ? from_f<T>(to_f(v[(node * DIM + d) * H + c]) + clip(dv[h][d])) : from_f<T>(0.f);
      }
    }
  }
}

enum { kVmix, kMix1, kOut };

// one node product and its epilogue: NA row groups x NS weight sections of
// CW columns for a tile of 64 receivers. B rows in shared memory: LDB
// 32-bit words a row, a float32 weight staged as its (hi, lo) TF32 pair.
template <typename T, int DIM, int EPI>
struct NodeShape {
  static constexpr int NA = EPI == kVmix ? DIM : 1;
  static constexpr int NS = EPI == kVmix ? 2 : EPI == kMix1 ? 1 : 3;
  static constexpr int CW =
      EPI == kVmix ? 32 : EPI == kMix1 ? 128 : (Tc<T>::EPW == 1 ? 48 : 64);
  static constexpr int KCW = TC_KC / Tc<T>::EPW, LD = KCW + 4;  // a stage's words per A row
  static constexpr int WPB = sizeof(typename Tc<T>::Word) / 4;   // words per B word
  static constexpr int LDB = (KCW + 4) * WPB;  // = 4 mod 16 B words: no bank conflicts
  static constexpr int STAGE = NA * TC_ROWS * LD + NS * CW * LDB;
  static constexpr int smem() { return 2 * STAGE * 4; }
};

// two adjacent values of a row of T
template <typename T>
__device__ __forceinline__ void load2(const T* p, float& a, float& b);
template <>
__device__ __forceinline__ void load2<float>(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
template <>
__device__ __forceinline__ void load2<bf16>(const bf16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int DIM, int EPI>
__global__ void __launch_bounds__(TC_THREADS) painn_node_tc(const TcArgs p) {
  using F = Tc<T>;
  using W = typename F::Word;
  using S = NodeShape<T, DIM, EPI>;
  constexpr int NA = S::NA, NS = S::NS, CW = S::CW, NT = CW / 16;
  constexpr int KCW = S::KCW, LD = S::LD, LDB = S::LDB, WPB = S::WPB;
  constexpr int CPR = KCW / 4, CPRB = KCW * WPB / 4;  // 16-byte chunks of an A and a B row
  constexpr int AROWS = NA * TC_ROWS, BROWS = NS * CW, STAGE = S::STAGE;
  extern __shared__ __align__(16) uint32_t sm[];
  const int HP = p.hp, N = p.a.n;
  const int c0 = blockIdx.x * CW, n0 = blockIdx.y * TC_ROWS;
  // A rows (receivers, one row per axis for kVmix) and B rows (weight
  // columns), both K-major, KT long
  const T* A = static_cast<const T*>(EPI == kVmix ? p.v1 : EPI == kMix1 ? p.ts : p.z);
  const uint32_t* B = static_cast<const uint32_t*>(EPI == kVmix   ? p.vmix_t
                                                   : EPI == kMix1 ? p.mix1_t
                                                                  : p.mix2_t);
  const int a_row = EPI == kVmix ? DIM * HP : EPI == kMix1 ? 2 * HP : HP;
  const int KT = EPI == kMix1 ? 2 * HP : HP;
  const int64_t b_row = (int64_t)KT / F::EPW * WPB;  // words

  auto load_stage = [&](int buf, int kc) {
    uint32_t* sA = sm + buf * STAGE;
    uint32_t* sB = sA + AROWS * LD;
    for (int i = threadIdx.x; i < AROWS * CPR; i += TC_THREADS) {
      const int row = i / CPR, q = i % CPR, ax = row / TC_ROWS;
      const int n = min(n0 + row % TC_ROWS, N - 1);  // rows past N: loaded, not stored
      cp_async16(sA + row * LD + q * 4,
                 A + (int64_t)n * a_row + ax * HP + kc * TC_KC + q * 4 * F::EPW);
    }
    for (int i = threadIdx.x; i < BROWS * CPRB; i += TC_THREADS) {
      const int row = i / CPRB, q = i % CPRB, sec = row / CW;
      const int c = min(c0 + row % CW, HP - 1);  // columns past HP: loaded, not stored
      cp_async16(sB + row * LDB + q * 4,
                 B + ((int64_t)sec * HP + c) * b_row + kc * KCW * WPB + q * 4);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  float tot[NA][NS][NT][4];
#pragma unroll
  for (int x = 0; x < NA; ++x)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[x][s][nt][e] = 0.f;

  const int nk = KT / TC_KC;
  load_stage(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      load_stage((kc + 1) & 1, kc + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t* sA = sm + (kc & 1) * STAGE;
    const W* sB = reinterpret_cast<const W*>(sA + AROWS * LD);
    float acc[NA][NS][NT][4];  // this chunk's sums
#pragma unroll
    for (int x = 0; x < NA; ++x)
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[x][s][nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KCW / 8; ++ks) {
      typename F::A fa[NA];
#pragma unroll
      for (int x = 0; x < NA; ++x)
        F::load_a(fa[x], sA + (x * TC_ROWS + wm * 16 + g) * LD + ks * 8 + t, LD);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          typename F::B fb;
          F::load_b_pre(fb, sB + (s * CW + wn * (CW / 2) + nt * 8 + g) * (LDB / WPB) + ks * 8 + t);
#pragma unroll
          for (int x = 0; x < NA; ++x) F::mma(acc[x][s][nt], fa[x], fb);
        }
    }
#pragma unroll
    for (int x = 0; x < NA; ++x)
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[x][s][nt][e] += acc[x][s][nt][e];
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // epilogue: the thread holds rows wm 16 + g (+ 8), columns c, c + 1 (c =
  // 2t of each n8 tile; HP is even, so both or neither are < HP)
  T* ts = static_cast<T*>(p.ts);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int64_t n = n0 + wm * 16 + g + hv * 8;
      const int c = c0 + wn * (CW / 2) + nt * 8 + 2 * t;
      if (n >= N || c >= HP) continue;
      const int e0 = 2 * hv, e1 = 2 * hv + 1;
      if (EPI == kVmix) {
        float nrm0 = 0.f, nrm1 = 0.f, dt0 = 0.f, dt1 = 0.f;
#pragma unroll
        for (int x = 0; x < NA; ++x) {
          const float vl0 = tot[x][0][nt][e0], vl1 = tot[x][0][nt][e1];
          const float vr0 = tot[x][1][nt][e0], vr1 = tot[x][1][nt][e1];
          nrm0 += vr0 * vr0;
          nrm1 += vr1 * vr1;
          dt0 += vr0 * vl0;
          dt1 += vr1 * vl1;
          store2<float>(p.vl + (n * DIM + x) * HP + c, vl0, vl1);
        }
        store2<float>(p.dot + n * HP + c, dt0, dt1);
        store2<T>(ts + n * 2 * HP + HP + c, sqrtf(nrm0 + kEps), sqrtf(nrm1 + kEps));
      } else if (EPI == kMix1) {
        const float z0 = tot[0][0][nt][e0] + p.mix_b1[c], z1 = tot[0][0][nt][e1] + p.mix_b1[c + 1];
        store2<T>(static_cast<T*>(p.z) + n * HP + c, z0 * (1.f / (1.f + expf(-z0))),
                  z1 * (1.f / (1.f + expf(-z1))));
      } else {
        const int H = p.a.h;
        if (c >= H) continue;
        const bool both = c + 1 < H, paired = both && H % 2 == 0;
        float m[3][2];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          m[j][0] = tot[0][j][nt][e0] + p.mix_b2[j * HP + c];
          m[j][1] = tot[0][j][nt][e1] + p.mix_b2[j * HP + c + 1];
        }
        const T* v1 = static_cast<const T*>(p.v1);
        T* s_out = static_cast<T*>(p.a.s_out);
        T* v_out = static_cast<T*>(p.a.v_out);
        float s1[2], dt[2], o[2];
        load2<T>(ts + n * 2 * HP + c, s1[0], s1[1]);
        load2<float>(p.dot + n * HP + c, dt[0], dt[1]);
#pragma unroll
        for (int u = 0; u < 2; ++u) o[u] = s1[u] + clip(m[0][u] + m[2][u] * dt[u]);
        if (paired) {
          store2<T>(s_out + n * H + c, o[0], o[1]);
        } else {
          s_out[n * H + c] = from_f<T>(o[0]);
          if (both) s_out[n * H + c + 1] = from_f<T>(o[1]);
        }
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          float a1[2], l[2];
          load2<T>(v1 + (n * DIM + d) * HP + c, a1[0], a1[1]);
          load2<float>(p.vl + (n * DIM + d) * HP + c, l[0], l[1]);
#pragma unroll
          for (int u = 0; u < 2; ++u) o[u] = a1[u] + clip(l[u] * m[1][u]);
          if (paired) {
            store2<T>(v_out + (n * DIM + d) * H + c, o[0], o[1]);
          } else {
            v_out[(n * DIM + d) * H + c] = from_f<T>(o[0]);
            if (both) v_out[(n * DIM + d) * H + c + 1] = from_f<T>(o[1]);
          }
        }
      }
    }
}

// each kernel's grid and dynamic shared memory: what it is launched with
// and what lbt_painn_tc_shape reports
struct Shape {
  dim3 grid;
  int smem;
};
inline Shape edge_shape(int n, int hp, int rk, bool is_bf16) {
  return {dim3(lbt::ceil_div(hp, 16 * TC_EDGE_WARPS), lbt::ceil_div(n, TC_RG)),
          edge_smem(rk, is_bf16)};
}
template <typename T, int DIM, int EPI>
Shape node_shape(int n, int hp) {
  using S = NodeShape<T, DIM, EPI>;
  static_assert(S::smem() <= kSmemLimit, "a node tile's two stages fit one block");
  return {dim3(lbt::ceil_div(hp, S::CW), lbt::ceil_div(n, TC_ROWS)), S::smem()};
}

template <typename K>
int launch_shaped(K kernel, const Shape& s, int threads, const TcArgs& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<s.grid, threads, s.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DIM>
int launch_tc(const TcArgs& p, cudaStream_t stream) {
  const bool bf = sizeof(T) == 2;
  const Shape es = edge_shape(p.a.n, p.hp, p.rk, bf);
  const int ks = edge_ksteps(p.rk, bf), et = 32 * TC_EDGE_WARPS;
  int e = ks == 3    ? launch_shaped(painn_edge_tc<T, DIM, 3>, es, et, p, stream)
          : ks == 2  ? launch_shaped(painn_edge_tc<T, DIM, 2>, es, et, p, stream)
          : es.smem ? launch_shaped(painn_edge_tc<T, DIM, 0>, es, et, p, stream)
                     : launch_shaped(painn_edge_tc<T, DIM, -1>, es, et, p, stream);
  if (e) return e;
  if ((e = launch_shaped(painn_node_tc<T, DIM, kVmix>, node_shape<T, DIM, kVmix>(p.a.n, p.hp),
                         TC_THREADS, p, stream)))
    return e;
  if ((e = launch_shaped(painn_node_tc<T, DIM, kMix1>, node_shape<T, DIM, kMix1>(p.a.n, p.hp),
                         TC_THREADS, p, stream)))
    return e;
  return launch_shaped(painn_node_tc<T, DIM, kOut>, node_shape<T, DIM, kOut>(p.a.n, p.hp),
                       TC_THREADS, p, stream);
}

template <typename T, int DIM>
void tc_shapes(int n, int hp, int rk, Shape (&s)[4]) {
  s[0] = edge_shape(n, hp, rk, sizeof(T) == 2);
  s[1] = node_shape<T, DIM, kVmix>(n, hp);
  s[2] = node_shape<T, DIM, kMix1>(n, hp);
  s[3] = node_shape<T, DIM, kOut>(n, hp);
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

// the narrow instance for (H, R) (H <= 256, R <= 64): 128 or 256 threads,
// basis capacity 20 or 64; the shipped H = 128, R = 20 exactly
template <typename T, int DIM>
int launch_width(const Args& a, cudaStream_t stream) {
  if (a.h == 128 && a.r == 20) return launch<T, DIM, 128, 20, true>(a, stream);
  if (a.h <= 128)
    return a.r <= 20 ? launch<T, DIM, 128, 20>(a, stream) : launch<T, DIM, 128, 64>(a, stream);
  return a.r <= 20 ? launch<T, DIM, 256, 20>(a, stream) : launch<T, DIM, 256, 64>(a, stream);
}

}  // namespace

// ptrs (host array of device pointers), in order:
//   0 packed, 1 sidx (int32), 2 phi, 3 nd, 4 s, 5 v, 6 filt_w, 7 filt_b,
//   8 vmix_w, 9 mix_w1, 10 mix_b1, 11 mix_w2, 12 mix_b2, 13 s_out, 14 v_out,
// and with hp > 0 (the tensor-core design) the staged weights and buffers
// of TcArgs: 15 filt_t, 16 filt_b (3, HP), 17 vmix_t, 18 mix1_t, 19 mix_b1
// (HP), 20 mix2_t, 21 mix_b2 (3, HP), 22 v1, 23 ts, 24 z, 25 vl, 26 dot
// (ops/painn_msg.py tc_weights, tc_buffers).
// Matrices and activations in the compute type (is_bf16 ? bf16 : float32),
// biases float32. n receivers, k slots each, m >= n rows of packed; h and
// r from 1 on. hp = rk = 0: the narrow instances (h <= 256,
// r <= 64); else hp and rk, the widths the wrapper padded H and R to (hp =
// 64 ceil(h / 64), rk = r to a whole k-step: 8 ceil(r / 8) in float32, 16
// ceil(r / 16) in bf16). Any other argument: cudaErrorInvalidValue.
LBT_EXPORT int lbt_painn_layer(const void* const* ptrs, int n, int k, int m, int h, int r,
                               int dim, int is_bf16, int hp, int rk, cudaStream_t stream) {
  const int step = is_bf16 ? 16 : 8;
  const bool narrow = hp == 0 && rk == 0 && h <= kMaxHidden && r <= kMaxRbf;
  const bool tc = hp == (h + 63) / 64 * 64 && rk == (r + step - 1) / step * step;
  if (h < 1 || r < 1 || n < 1 || k < 1 || m < n ||
      (dim != 2 && dim != 3) || !(narrow || tc))
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
  if (narrow) {
    if (is_bf16)
      return dim == 3 ? launch_width<bf16, 3>(a, stream) : launch_width<bf16, 2>(a, stream);
    return dim == 3 ? launch_width<float, 3>(a, stream) : launch_width<float, 2>(a, stream);
  }
  TcArgs p;
  p.a = a;
  p.filt_t = ptrs[15];
  p.filt_b = static_cast<const float*>(ptrs[16]);
  p.vmix_t = ptrs[17];
  p.mix1_t = ptrs[18];
  p.mix_b1 = static_cast<const float*>(ptrs[19]);
  p.mix2_t = ptrs[20];
  p.mix_b2 = static_cast<const float*>(ptrs[21]);
  p.v1 = const_cast<void*>(ptrs[22]);
  p.ts = const_cast<void*>(ptrs[23]);
  p.z = const_cast<void*>(ptrs[24]);
  p.vl = static_cast<float*>(const_cast<void*>(ptrs[25]));
  p.dot = static_cast<float*>(const_cast<void*>(ptrs[26]));
  p.hp = hp;
  p.rk = rk;
  p.kp = (k + 7) / 8 * 8;
  if (is_bf16)
    return dim == 3 ? launch_tc<bf16, 3>(p, stream) : launch_tc<bf16, 2>(p, stream);
  return dim == 3 ? launch_tc<float, 3>(p, stream) : launch_tc<float, 2>(p, stream);
}

// The tensor-core design's launches at n receivers and the padded widths
// hp, rk (as lbt_painn_layer takes them): out[3 i .. 3 i + 2] = grid x,
// grid y and dynamic shared memory bytes of kernel i (0 painn_edge_tc, 1-3
// painn_node_tc kVmix, kMix1, kOut). For reports; nothing is launched.
LBT_EXPORT void lbt_painn_tc_shape(int n, int hp, int rk, int dim, int is_bf16, int* out) {
  Shape s[4];
  if (is_bf16)
    dim == 3 ? tc_shapes<bf16, 3>(n, hp, rk, s) : tc_shapes<bf16, 2>(n, hp, rk, s);
  else
    dim == 3 ? tc_shapes<float, 3>(n, hp, rk, s) : tc_shapes<float, 2>(n, hp, rk, s);
  for (int i = 0; i < 4; ++i) {
    out[3 * i] = (int)s[i].grid.x;
    out[3 * i + 1] = (int)s[i].grid.y;
    out[3 * i + 2] = s[i].smem;
  }
}
