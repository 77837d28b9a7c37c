// K2, K7, K9: column-stencil radius search, packed into K slots per receiver.
//
// Replaces: lagrangebench_tpu/ops/neighbors_pallas.py::_scan_kernel and
// ::_scan_kernel_streamed. One kernel covers both of their regimes, and
// each of the TPU kernel's payloads is a compile-time instance:
//   K2 (emit="senders", make_edges_fn): sender particle ids, fill n;
//   K9 (emit="geometry", make_edges_fn(emit_geometry=True)): K2 plus one
//      interleaved (K*(dim+1)) float32 plane per receiver of the
//      cutoff-normalized [rel_disp, rel_dist], zeros in unfilled slots;
//   K7 (emit="slot", make_slot_edges_fn): the stencil-candidate index
//      j*C + c in [0, S*C) (fill S*C) with rel_disp (dim planes) and
//      rel_dist written straight into the (n_ext, K) column-slot outputs,
//      the sentinel column's C rows included (fill, zero geometry).
//
// What it computes, per (sample, receiver column): every candidate of the
// 3^(dim-1) stencil columns (wrapped ids from the base table; a sentinel
// column of far positions and id n stands in on free axes) is tested
// against each receiver of the column. Periodic axes are min-imaged with
// d - box*floor(d/box + 0.5); a candidate is a hit when dist^2 <= cutoff^2
// and its id < n. Hits are packed into K slots per receiver in candidate
// order (stencil step first, then rank within the column), the rest
// filled; receivers holding the sentinel position (x >= 1e8) keep no hits.
// The largest row count of the column is written for the overflow flag.
// The geometry is the min-imaged per-axis difference of the distance test
// times 1/cutoff, and sqrt(dist^2)/cutoff, rounded as the plain version
// rounds them (__f*_rn: no FMA contraction).
//
// Bound on an H100: at these sizes a few microseconds either way. The
// distance tests (~20 float operations per candidate pair in 3D) run on the
// CUDA cores in float32, since the test must round exactly as the plain
// version does; the bytes are one read of the column table and one write
// of the (C, K) slots (and of the K (dim+1) geometry values).
//
// Design: a column's receivers are split over gridDim.y blocks of 16 warps,
// a warp per receiver at a time (receiver r to warp r % 16 of block
// (r / 16) % gridDim.y), so that the grid (B*n_cols columns x the split,
// sized to about four 512-thread blocks per SM) fills the card and a
// column's ~50 receivers run on several SMs at once. Each block stages its
// column's whole stencil; the largest row count is an atomicMax over the
// column's blocks. The stencil columns are staged in shared memory as one
// 16-byte record per live candidate (x, y, z, payload), where live means
// id < n: an empty slot or a sentinel id can never be a hit, so the stage
// holds only the candidates that can, compacted in candidate order by a
// warp ballot prefix per stencil column. The stage takes whole stencil
// columns, all S when they fit (the common case), else as many as fit, so
// there is no size limit beyond one column. The pack is a warp __ballot_sync / __popc prefix
// over 32 staged candidates at a time, which keeps candidate order and so
// gives the same slots as the TPU kernel's triangular-matmul prefix. Each
// receiver's running count lives in shared memory across chunks. A hit's
// lane writes its own payload and geometry.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// the packed payload (a template argument: one instance each)
enum Emit : int { kSenders = 0, kGeometry = 1, kSlot = 2 };

struct ScanArgs {
  const float* pos;      // (B*(n_cols+1), C, dim) column-table positions
  const int32_t* idx;    // (B*(n_cols+1), C) local particle ids, fill n
  const int32_t* bases;  // (B*n_cols, S) flat table row per stencil step
  int32_t* out;          // (blocks, C, K) packed sender ids / candidate ids
  int32_t* row_max;      // (blocks,) largest row count of the column, zeroed
  float* geom;           // kGeometry: (blocks, C, K*(dim+1)); kSlot: (n_ext, K, dim)
  float* dist;           // kSlot: (n_ext, K)
  int n_cols, C, S, K, n, chunk;  // chunk: stencil columns per stage
  float cutoff2, inv_cutoff;
  float box[3], inv_box[3];
  int pbc[3];
};

template <int EMIT, int DIM>
__global__ void __launch_bounds__(kThreads) neighbor_scan(const ScanArgs a) {
  extern __shared__ float4 smem[];
  const int C = a.C, K = a.K;
  float4* srec = smem;                                                // [chunk*C] live candidates
  int32_t* scount = reinterpret_cast<int32_t*>(srec + a.chunk * C);  // [C] hits per receiver
  int32_t* slive = scount + C;  // [chunk] live candidates per stencil column of the stage
  __shared__ int s_max;

  const int q = blockIdx.x;  // sample * n_cols + receiver column
  // K7 is single-sample, and its block n_cols is the sentinel column,
  // whose rows are only filled
  const int recv_row = EMIT == kSlot ? q : (q / a.n_cols) * (a.n_cols + 1) + q % a.n_cols;
  const int n_steps = (EMIT == kSlot && q >= a.n_cols) ? 0 : a.S;
  const int fill = EMIT == kSlot ? a.S * C : a.n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int r0 = warp + kWarps * blockIdx.y;  // this warp's first receiver
  const int r_step = kWarps * gridDim.y;

  for (int r = threadIdx.x; r < C; r += kThreads) scount[r] = 0;
  if (threadIdx.x == 0) s_max = 0;

  for (int j0 = 0; j0 < n_steps; j0 += a.chunk) {
    const int nj = min(a.chunk, n_steps - j0);
    __syncthreads();  // the previous stage is read; the counts are set
    // pass 1: live candidates per stencil column, one warp per column
    for (int j = warp; j < nj; j += kWarps) {
      const int32_t* ids = a.idx + (int64_t)a.bases[(int64_t)q * a.S + j0 + j] * C;
      int live = 0;
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + lane;
        live += __popc(__ballot_sync(lbt::kFullMask, c < C && ids[c] < a.n));
      }
      if (lane == 0) slive[j] = live;
    }
    __syncthreads();
    // pass 2: their records, compacted in candidate order
    int total = 0;
    for (int j = 0; j < nj; ++j) total += slive[j];
    for (int j = warp; j < nj; j += kWarps) {
      int at = 0;
      for (int i = 0; i < j; ++i) at += slive[i];
      const int64_t row0 = (int64_t)a.bases[(int64_t)q * a.S + j0 + j] * C;
      for (int c0 = 0; c0 < C; c0 += 32) {
        const int c = c0 + lane;
        const int32_t id = c < C ? a.idx[row0 + c] : a.n;
        const bool live = id < a.n;
        const unsigned b = __ballot_sync(lbt::kFullMask, live);
        if (live) {
          const float* p = a.pos + (row0 + c) * DIM;
          const int32_t payload = EMIT == kSlot ? (j0 + j) * C + c : id;
          srec[at + __popc(b & lt_mask)] =
              make_float4(p[0], p[1], DIM == 3 ? p[2] : 0.f, __int_as_float(payload));
        }
        at += __popc(b);
      }
    }
    __syncthreads();
    for (int r = r0; r < C; r += r_step) {
      const float* rp = a.pos + ((int64_t)recv_row * C + r) * DIM;
      float rx[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) rx[d] = rp[d];
      if (!(rx[0] < 1e8f)) continue;  // empty slot: sentinel position
      int cnt = scount[r];
      const int64_t orow_at = ((int64_t)q * C + r) * K;
      for (int base = 0; base < total; base += 32) {
        const int e = base + lane;
        bool hit = false;
        int32_t payload = 0;
        float df[DIM];
        float dist2 = 0.f;
        if (e < total) {
          const float4 rec = srec[e];
          const float cx[3] = {rec.x, rec.y, rec.z};
          payload = __float_as_int(rec.w);
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            float v = __fsub_rn(rx[d], cx[d]);
            if (a.pbc[d]) {
              const float w = floorf(__fadd_rn(__fmul_rn(v, a.inv_box[d]), 0.5f));
              v = __fsub_rn(v, __fmul_rn(a.box[d], w));
            }
            df[d] = v;
            const float sq = __fmul_rn(v, v);
            dist2 = d == 0 ? sq : __fadd_rn(dist2, sq);
          }
          hit = dist2 <= a.cutoff2;
        }
        const unsigned ballot = __ballot_sync(lbt::kFullMask, hit);
        if (hit) {
          const int p = cnt + __popc(ballot & lt_mask);
          if (p < K) {
            a.out[orow_at + p] = payload;
            if constexpr (EMIT != kSenders) {
              const float inv = a.inv_cutoff;
              const float rd = __fmul_rn(__fsqrt_rn(dist2), inv);
              if constexpr (EMIT == kGeometry) {
                float* g = a.geom + (orow_at + p) * (DIM + 1);
#pragma unroll
                for (int d = 0; d < DIM; ++d) g[d] = __fmul_rn(df[d], inv);
                g[DIM] = rd;
              } else {
                float* g = a.geom + (orow_at + p) * DIM;
#pragma unroll
                for (int d = 0; d < DIM; ++d) g[d] = __fmul_rn(df[d], inv);
                a.dist[orow_at + p] = rd;
              }
            }
          }
        }
        cnt += __popc(ballot);
      }
      if (lane == 0) scount[r] = cnt;
    }
  }
  __syncthreads();

  int wmax = 0;
  for (int r = r0; r < C; r += r_step) {
    const int cnt = scount[r];
    wmax = max(wmax, cnt);
    const int64_t orow_at = ((int64_t)q * C + r) * K;
    for (int k = min(cnt, K) + lane; k < K; k += 32) {
      a.out[orow_at + k] = fill;
      if constexpr (EMIT == kGeometry) {
        if constexpr (DIM == 3) {
          reinterpret_cast<float4*>(a.geom)[orow_at + k] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
#pragma unroll
          for (int c = 0; c <= DIM; ++c) a.geom[(orow_at + k) * (DIM + 1) + c] = 0.f;
        }
      } else if constexpr (EMIT == kSlot) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) a.geom[(orow_at + k) * DIM + d] = 0.f;
        a.dist[orow_at + k] = 0.f;
      }
    }
  }
  if (lane == 0) atomicMax(&s_max, wmax);
  __syncthreads();
  if (threadIdx.x == 0) atomicMax(a.row_max + q, s_max);
}

// Shared memory of one block for a stage of `chunk` stencil columns
// (ops/neighbors_cuda.py::scan_smem_bytes sizes the chunk by the same sum).
int scan_smem_bytes(int C, int chunk) { return 16 * chunk * C + 4 * C + 4 * chunk; }

template <int EMIT, int DIM>
int launch(const ScanArgs& a, int n_blocks, cudaStream_t stream) {
  const int smem = scan_smem_bytes(a.C, a.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      neighbor_scan<EMIT, DIM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  // about four blocks per SM, and no block without a receiver slot
  const int split = std::max(1, std::min(lbt::ceil_div(4 * sms, n_blocks),
                                         lbt::ceil_div(a.C, kWarps)));
  neighbor_scan<EMIT, DIM><<<dim3(n_blocks, split), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int EMIT>
int launch_dim(const ScanArgs& a, int dim, int n_blocks, cudaStream_t stream) {
  return dim == 3 ? launch<EMIT, 3>(a, n_blocks, stream) : launch<EMIT, 2>(a, n_blocks, stream);
}

ScanArgs make_args(const float* pos, const int32_t* idx, const int32_t* bases, int32_t* out,
                   int32_t* row_max, int n_cols, int C, int S, int dim, int K, int n,
                   int chunk, float cutoff2, const float* box, const float* inv_box,
                   const int32_t* pbc) {
  ScanArgs a;
  a.pos = pos;
  a.idx = idx;
  a.bases = bases;
  a.out = out;
  a.row_max = row_max;
  a.geom = nullptr;
  a.dist = nullptr;
  a.n_cols = n_cols;
  a.C = C;
  a.S = S;
  a.K = K;
  a.n = n;
  a.chunk = chunk;
  a.cutoff2 = cutoff2;
  a.inv_cutoff = 0.f;
  for (int d = 0; d < 3; ++d) {
    a.box[d] = d < dim ? box[d] : 1.f;
    a.inv_box[d] = d < dim ? inv_box[d] : 1.f;
    a.pbc[d] = d < dim ? pbc[d] : 0;
  }
  return a;
}

}  // namespace

// K2: sender ids only.
LBT_EXPORT int lbt_neighbor_scan(const float* pos, const int32_t* idx, const int32_t* bases,
                                 int32_t* out, int32_t* row_max, int n_blocks, int n_cols,
                                 int C, int S, int dim, int K, int n, int chunk,
                                 float cutoff2, const float* box, const float* inv_box,
                                 const int32_t* pbc, cudaStream_t stream) {
  if (dim < 2 || dim > 3 || chunk < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const ScanArgs a = make_args(pos, idx, bases, out, row_max, n_cols, C, S, dim, K, n, chunk,
                               cutoff2, box, inv_box, pbc);
  return launch_dim<kSenders>(a, dim, n_blocks, stream);
}

// K9 (emit == 1: geom is the interleaved (blocks, C, K*(dim+1)) plane, dist
// unused; n_blocks = B*n_cols) and K7 (emit == 2: geom is rel_disp (n_ext,
// K, dim), dist rel_dist (n_ext, K); n_blocks = n_cols + 1, one sample).
LBT_EXPORT int lbt_neighbor_scan_emit(int emit, const float* pos, const int32_t* idx,
                                      const int32_t* bases, int32_t* out, int32_t* row_max,
                                      float* geom, float* dist, int n_blocks, int n_cols,
                                      int C, int S, int dim, int K, int n, int chunk,
                                      float cutoff2, float inv_cutoff, const float* box,
                                      const float* inv_box, const int32_t* pbc,
                                      cudaStream_t stream) {
  if (dim < 2 || dim > 3 || chunk < 1 || n_blocks < 1 || geom == nullptr)
    return (int)cudaErrorInvalidValue;
  ScanArgs a = make_args(pos, idx, bases, out, row_max, n_cols, C, S, dim, K, n, chunk,
                         cutoff2, box, inv_box, pbc);
  a.geom = geom;
  a.dist = dist;
  a.inv_cutoff = inv_cutoff;
  if (emit == kGeometry) return launch_dim<kGeometry>(a, dim, n_blocks, stream);
  if (emit == kSlot && dist != nullptr && n_blocks == n_cols + 1)
    return launch_dim<kSlot>(a, dim, n_blocks, stream);
  return (int)cudaErrorInvalidValue;
}
