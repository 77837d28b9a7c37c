// K2: column-stencil radius search, packed into K sender slots per receiver.
//
// Replaces: lagrangebench_tpu/ops/neighbors_pallas.py::_scan_kernel
// (emit="senders") and ::_scan_kernel_streamed, both launched from
// make_edges_fn._edges_impl. One kernel covers both of their regimes.
//
// What it computes, per (sample, receiver column): every candidate of the
// 3^(dim-1) stencil columns (wrapped ids from the base table; a sentinel
// column of far positions and id n stands in on free axes) is tested
// against each receiver of the column. Periodic axes are min-imaged with
// d - box*floor(d/box + 0.5); a candidate is a hit when dist^2 <= cutoff^2
// and its id < n. Hits are packed into K slots per receiver in candidate
// order (stencil step first, then rank within the column), the rest filled
// with n; receivers holding the sentinel position (x >= 1e8) keep no hits.
// The largest row count of the column is written for the overflow flag.
//
// Bound on an H100: operations, at these sizes. Each receiver tests S*C
// candidates (~20 float operations each in 3D) while the bytes are one
// read of the column table and one write of the (C, K) slots; the distance
// tests are the work. They run on the CUDA cores in float32, since the
// test must round exactly as the plain version does (no FMA contraction:
// the __f*_rn intrinsics below), and a tensor-core form would not.
//
// Design: one block per (sample, receiver column), one warp per receiver
// at a time. The stencil columns' positions and ids are staged in shared
// memory in chunks of whole columns (all S when they fit, else as many as
// fit), so there is no size limit beyond one column. The pack is a warp
// __ballot_sync / __popc prefix over 32 candidates at a time, which keeps
// candidate order and so gives the same slots as the TPU kernel's
// triangular-matmul prefix. Each receiver's running count lives in shared
// memory across chunks.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct ScanArgs {
  const float* pos;      // (B*(n_cols+1), C, dim) column-table positions
  const int32_t* idx;    // (B*(n_cols+1), C) local particle ids, fill n
  const int32_t* bases;  // (B*n_cols, S) flat table row per stencil step
  int32_t* out;          // (B*n_cols, C, K) packed sender ids
  int32_t* row_max;      // (B*n_cols,) largest row count of the column
  int n_cols, C, S, dim, K, n, chunk;  // chunk: stencil columns per stage
  float cutoff2;
  float box[3], inv_box[3];
  int pbc[3];
};

__global__ void __launch_bounds__(kThreads) neighbor_scan(const ScanArgs a) {
  extern __shared__ float smem[];
  const int C = a.C, K = a.K, dim = a.dim;
  const int stage = a.chunk * C;
  float* spos = smem;                                       // [dim][stage]
  int32_t* sidx = reinterpret_cast<int32_t*>(spos + dim * stage);  // [stage]
  int32_t* scount = sidx + stage;                            // [C]
  __shared__ int s_max;

  const int q = blockIdx.x;  // sample * n_cols + receiver column
  const int recv_row = (q / a.n_cols) * (a.n_cols + 1) + q % a.n_cols;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt_mask = (1u << lane) - 1u;

  for (int r = threadIdx.x; r < C; r += kThreads) scount[r] = 0;
  if (threadIdx.x == 0) s_max = 0;

  for (int j0 = 0; j0 < a.S; j0 += a.chunk) {
    const int nj = min(a.chunk, a.S - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < nj * C; e += kThreads) {
      const int row = a.bases[(int64_t)q * a.S + j0 + e / C];
      const int64_t at = (int64_t)row * C + e % C;
      for (int d = 0; d < dim; ++d) spos[d * stage + e] = a.pos[at * dim + d];
      sidx[e] = a.idx[at];
    }
    __syncthreads();
    for (int r = warp; r < C; r += kWarps) {
      const float* rp = a.pos + ((int64_t)recv_row * C + r) * dim;
      float rx[3];
      for (int d = 0; d < dim; ++d) rx[d] = rp[d];
      if (!(rx[0] < 1e8f)) continue;  // empty slot: sentinel position
      int cnt = scount[r];
      int32_t* orow = a.out + ((int64_t)q * C + r) * K;
      for (int base = 0; base < nj * C; base += 32) {
        const int e = base + lane;
        bool hit = false;
        int32_t sid = 0;
        if (e < nj * C) {
          sid = sidx[e];
          float dist2 = 0.f;
          for (int d = 0; d < dim; ++d) {
            float df = __fsub_rn(rx[d], spos[d * stage + e]);
            if (a.pbc[d]) {
              const float w = floorf(__fadd_rn(__fmul_rn(df, a.inv_box[d]), 0.5f));
              df = __fsub_rn(df, __fmul_rn(a.box[d], w));
            }
            const float sq = __fmul_rn(df, df);
            dist2 = d == 0 ? sq : __fadd_rn(dist2, sq);
          }
          hit = (dist2 <= a.cutoff2) && (sid < a.n);
        }
        const unsigned ballot = __ballot_sync(lbt::kFullMask, hit);
        if (hit) {
          const int p = cnt + __popc(ballot & lt_mask);
          if (p < K) orow[p] = sid;
        }
        cnt += __popc(ballot);
      }
      if (lane == 0) scount[r] = cnt;
    }
  }
  __syncthreads();

  int wmax = 0;
  for (int r = warp; r < C; r += kWarps) {
    const int cnt = scount[r];
    wmax = max(wmax, cnt);
    int32_t* orow = a.out + ((int64_t)q * C + r) * K;
    for (int k = min(cnt, K) + lane; k < K; k += 32) orow[k] = a.n;
  }
  if (lane == 0) atomicMax(&s_max, wmax);
  __syncthreads();
  if (threadIdx.x == 0) a.row_max[q] = s_max;
}

// Shared memory of one block for a stage of `chunk` stencil columns
// (ops/neighbors_cuda.py::scan_smem_bytes sizes the chunk by the same sum).
int scan_smem_bytes(int C, int dim, int chunk) {
  return (dim * chunk * C + chunk * C + C) * 4;
}

}  // namespace

LBT_EXPORT int lbt_neighbor_scan(const float* pos, const int32_t* idx, const int32_t* bases,
                                 int32_t* out, int32_t* row_max, int n_blocks, int n_cols,
                                 int C, int S, int dim, int K, int n, int chunk,
                                 float cutoff2, const float* box, const float* inv_box,
                                 const int32_t* pbc, cudaStream_t stream) {
  if (dim < 2 || dim > 3 || chunk < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  ScanArgs a;
  a.pos = pos;
  a.idx = idx;
  a.bases = bases;
  a.out = out;
  a.row_max = row_max;
  a.n_cols = n_cols;
  a.C = C;
  a.S = S;
  a.dim = dim;
  a.K = K;
  a.n = n;
  a.chunk = chunk;
  a.cutoff2 = cutoff2;
  for (int d = 0; d < 3; ++d) {
    a.box[d] = d < dim ? box[d] : 1.f;
    a.inv_box[d] = d < dim ? inv_box[d] : 1.f;
    a.pbc[d] = d < dim ? pbc[d] : 0;
  }
  const int smem = scan_smem_bytes(C, dim, chunk);
  cudaError_t err = cudaFuncSetAttribute(
      neighbor_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  neighbor_scan<<<n_blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}
