// K1: the column table of a batch, in one launch: each particle's column,
// its stable rank in that column, its table slot, and the table itself
// (particle ids and float32 positions, the empty slots and every sample's
// sentinel column filled), with a column-overflow flag per sample.
//
// Replaces: lagrangebench_tpu/ops/neighbors_pallas.py::_binning_kernel
// (launched by _table_from_cid), together with what its callers do around
// it (build_column_table_pallas, make_edges_fn, make_slot_edges_fn): the
// column ids of the positions, the two table scatters and the sentinel
// column the scan reads past the grid's edge.
//
// Function, for sample b of B with N particles and num_particles[b] valid:
//   col(i)   = clamp(floor(p_x / cs_x)) [* ncy + clamp(floor(p_y / cs_y))],
//              in the position's dtype (IEEE division: no fast math);
//   rank(i)  = number of earlier valid particles of sample b in col(i);
//   slot(i)  = (b*n_cols + col)*cap + rank, or the sentinel B*n_cols*cap
//              for a padded particle or one past the column's capacity;
//   idx_f[b*(n_cols+1) + col, rank] = i,  pos_f[...] = float32(p(i)),
//   every other entry of idx_f N and of pos_f 1e9 (row b*(n_cols+1) +
//   n_cols is the sample's sentinel column);
//   flag[b]  = the largest column count of sample b > cap (the wrapper
//              ors the samples' flags into one for the batch).
//
// Bound on an H100: bytes. It reads the positions (and B counts) and writes
// the slots and the table: B*N*(dim*itemsize + 4) + B*(n_cols+1)*cap*(4 +
// 4*dim) bytes, ~0.75 MB at 16,000 particles in 3D with C = 88 and 2 x 169
// columns, ~0.22 us at 3.35 TB/s. Launch latency and the two cluster
// barriers dominate at these sizes.
//
// Design: the TPU kernel walked its grid of particle tiles in order and
// carried the per-column counters from tile to tile in VMEM; a first port
// made that carry three launches (count, scan over tiles, slot) with the
// table built by a dozen PyTorch ops around them. Here one thread-block cluster of
// up to 8 CTAs (portable size, 1024 threads each) takes one sample. Each
// CTA takes a contiguous chunk of the sample's particles in index order,
// 1024 at a time: lanes of a warp with the same column find each other with
// __match_any_sync and rank by the popcount of the lower lanes; the lowest
// such lane writes the warp's count to a [column][warp] table in shared
// memory; one warp per column turns the 32 warp counts into an exclusive
// prefix (shuffles) on top of the CTA's running count. After cluster.sync()
// each CTA reads the other CTAs' per-column counts over distributed shared
// memory, which gives both its exclusive prefix (the lower ranks) and the
// sample's column totals; then each CTA writes its own particles' slots,
// ids and positions and fills the empty slots of every G-th column. Ranks
// never depend on the order atomics land in (there are none), so the K
// slots the neighbor scan fills are the same on every run.
//
// Sizes: shared memory 4*(32 + 3)*n_cols bytes per CTA, so a sample may have
// at most 1,653 columns (227 KB); the grid choice in ops/neighbors.py admits
// no grid beyond that. Particles per sample are not limited: a CTA loops
// over its chunk 1024 at a time.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size

template <typename T, int DIM>
__device__ __forceinline__ int column_of(const T* p, int ncx, int ncy, T cs0, T cs1) {
  // torch.floor(p / cs).to(int32), then the clamp of ops/neighbors.py
  int c = min(max(static_cast<int>(floor(p[0] / cs0)), 0), ncx - 1);
  if (DIM == 3) c = c * ncy + min(max(static_cast<int>(floor(p[1] / cs1)), 0), ncy - 1);
  return c;
}

template <typename T, int DIM>
__global__ void __launch_bounds__(kThreads, 1)
bin_column_table(const T* __restrict__ pos, int64_t stride_b, int64_t stride_n,
                 const void* __restrict__ num_particles, int np_is_64, int np_stride, int bsz,
                 int n, int ncx, int ncy, T cs0, T cs1, int cap,
                 int32_t* __restrict__ slots, int32_t* __restrict__ idx_f,
                 float* __restrict__ pos_f, uint8_t* __restrict__ flag) {
  extern __shared__ int32_t smem[];
  const int n_cols = ncx * ncy;
  int32_t* warp_run = smem;                      // [n_cols][kWarps]
  int32_t* cta_cnt = warp_run + n_cols * kWarps;  // [n_cols] this CTA's counts
  int32_t* col_base = cta_cnt + n_cols;           // [n_cols] lower CTAs' counts
  int32_t* col_total = col_base + n_cols;         // [n_cols] the sample's counts
  __shared__ int s_max;

  cg::cluster_group cluster = cg::this_cluster();
  const int g_size = (int)cluster.num_blocks();
  const int g_rank = (int)cluster.block_rank();
  const int b = blockIdx.x / g_size;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t np_at = (int64_t)b * np_stride;
  const int64_t np_b = np_is_64 ? static_cast<const int64_t*>(num_particles)[np_at]
                                : static_cast<const int32_t*>(num_particles)[np_at];
  const int npart = (int)min(max(np_b, (int64_t)0), (int64_t)n);
  const int chunk = (n + g_size - 1) / g_size;
  const int lo = min(g_rank * chunk, n), hi = min(lo + chunk, n);
  const T* pos_b = pos + b * stride_b;
  const unsigned lower_lanes = (1u << lane) - 1u;

  for (int i = tid; i < n_cols * (kWarps + 1); i += kThreads) smem[i] = 0;
  if (tid == 0) s_max = 0;
  __syncthreads();

  // 1. ranks among this CTA's earlier particles, kept in slots[] meanwhile
  for (int start = lo; start < hi; start += kThreads) {
    const int i = start + tid;
    const int col = i < hi && i < npart ? column_of<T, DIM>(pos_b + i * stride_n, ncx, ncy,
                                                           cs0, cs1)
                                        : -1;
    const unsigned peers = __match_any_sync(lbt::kFullMask, col);
    const int in_warp = __popc(peers & lower_lanes);
    if (col >= 0 && in_warp == 0) warp_run[col * kWarps + warp] = __popc(peers);
    __syncthreads();
    for (int c = warp; c < n_cols; c += kWarps) {
      const int v = warp_run[c * kWarps + lane];
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(lbt::kFullMask, incl, o);
        if (lane >= o) incl += t;
      }
      const int run = cta_cnt[c];
      // entries of warps without this column stay 0 for the next round
      if (v) warp_run[c * kWarps + lane] = run + incl - v;
      __syncwarp();
      if (lane == 31) cta_cnt[c] = run + incl;
    }
    __syncthreads();
    if (col >= 0) {
      slots[(int64_t)b * n + i] = warp_run[col * kWarps + warp] + in_warp;
      __syncwarp(peers);
      if (in_warp == 0) warp_run[col * kWarps + warp] = 0;
    }
    __syncthreads();
  }

  // 2. the lower CTAs' counts (this CTA's prefix) and the sample's totals,
  // over distributed shared memory
  cluster.sync();
  int local_max = 0;
  for (int c = tid; c < n_cols; c += kThreads) {
    int base = 0, total = 0;
    for (int r = 0; r < g_size; ++r) {
      const int v = cluster.map_shared_rank(cta_cnt, r)[c];
      base += r < g_rank ? v : 0;
      total += v;
    }
    col_base[c] = base;
    col_total[c] = total;
    local_max = max(local_max, total);
  }
  local_max = lbt::warp_max(local_max);
  if (lane == 0 && local_max > 0) atomicMax(&s_max, local_max);
  cluster.sync();  // no CTA reads another's shared memory past this point

  // 3. this CTA's particles: slots, ids and positions
  const int sentinel = bsz * n_cols * cap;
  const int64_t row0 = (int64_t)b * (n_cols + 1);
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int64_t g = (int64_t)b * n + i;
    if (i >= npart) {
      slots[g] = sentinel;
      continue;
    }
    const T* p = pos_b + i * stride_n;
    const int col = column_of<T, DIM>(p, ncx, ncy, cs0, cs1);
    const int rank = col_base[col] + slots[g];
    if (rank >= cap) {
      slots[g] = sentinel;
      continue;
    }
    slots[g] = (b * n_cols + col) * cap + rank;
    const int64_t at = (row0 + col) * cap + rank;
    idx_f[at] = i;
#pragma unroll
    for (int d = 0; d < DIM; ++d) pos_f[at * DIM + d] = static_cast<float>(p[d]);
  }

  // 4. the empty slots of columns g_rank, g_rank + G, ... (n_cols: the
  // sentinel column, all empty)
  const int my_cols = (n_cols + 1 - g_rank + g_size - 1) / g_size;
  for (int e = tid; e < my_cols * cap; e += kThreads) {
    const int c = g_rank + (e / cap) * g_size;
    const int s = e % cap;
    const int filled = c < n_cols ? min(col_total[c], cap) : 0;
    if (s < filled) continue;
    const int64_t at = (row0 + c) * cap + s;
    idx_f[at] = n;
#pragma unroll
    for (int d = 0; d < DIM; ++d) pos_f[at * DIM + d] = 1e9f;
  }
  if (g_rank == 0 && tid == 0) flag[b] = s_max > cap;
}

__global__ void empty_kernel() {}

template <typename T, int DIM>
cudaError_t launch(const void* pos, int64_t stride_b, int64_t stride_n, const void* num_particles,
                   int np_is_64, int np_stride, int bsz, int n, int ncx, int ncy, double cs0,
                   double cs1, int cap, int32_t* slots, int32_t* idx_f, float* pos_f,
                   uint8_t* flag, cudaStream_t stream) {
  const int n_cols = ncx * ncy;
  const size_t smem = sizeof(int32_t) * (size_t)n_cols * (kWarps + 3);
  auto kern = bin_column_table<T, DIM>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int g = min(kMaxCluster, max(1, lbt::ceil_div(n, kThreads)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bsz * g);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(pos), stride_b, stride_n,
                            num_particles, np_is_64, np_stride, bsz, n, ncx, ncy,
                            static_cast<T>(cs0), static_cast<T>(cs1), cap, slots, idx_f, pos_f,
                            flag);
}

}  // namespace

// pos: (bsz, n, dim) float32 (is_double 0) or float64 (1), its last axis
// contiguous, strides stride_b and stride_n in elements. num_particles: bsz
// int32 (np_is_64 0) or int64 (1) counts at a stride of np_stride (0: one
// count for all). Columns: ncx (x ncy in 3D; ncy = 1 in 2D) of sizes cs0
// (, cs1), given as doubles and rounded to the position's dtype. Outputs:
// slots (bsz*n,) int32; idx_f (bsz*(ncx*ncy + 1), cap) int32; pos_f
// (bsz*(ncx*ncy + 1), cap, dim) float32; flag (bsz,) uint8. Every output
// element is written.
LBT_EXPORT int lbt_column_table(const void* pos, int is_double, int64_t stride_b,
                                int64_t stride_n, const void* num_particles, int np_is_64,
                                int np_stride, int bsz, int n, int dim, int ncx, int ncy,
                                double cs0, double cs1, int cap, int32_t* slots,
                                int32_t* idx_f, float* pos_f, uint8_t* flag,
                                cudaStream_t stream) {
  if (bsz <= 0 || n <= 0 || cap <= 0 || ncx <= 0 || ncy <= 0 || (dim != 2 && dim != 3) ||
      (dim == 2 && ncy != 1))
    return (int)cudaErrorInvalidValue;
#define LBT_LAUNCH(T, D)                                                                    \
  launch<T, D>(pos, stride_b, stride_n, num_particles, np_is_64, np_stride, bsz, n, ncx, ncy, \
               cs0, cs1, cap, slots, idx_f, pos_f, flag, stream)
  cudaError_t err = dim == 3 ? (is_double ? LBT_LAUNCH(double, 3) : LBT_LAUNCH(float, 3))
                             : (is_double ? LBT_LAUNCH(double, 2) : LBT_LAUNCH(float, 2));
#undef LBT_LAUNCH
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// An empty kernel of one 32-thread block: its device time is the launch
// floor against which K1's time is read.
LBT_EXPORT int lbt_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return (int)cudaGetLastError();
}
