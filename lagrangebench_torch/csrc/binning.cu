// K1: stable counting-sort binning of particles into column tables.
//
// Replaces: lagrangebench_tpu/ops/neighbors_pallas.py::_binning_kernel
// (launched by _table_from_cid). For every particle it gives the rank in
// its cell/column in particle-index order, the table slot cid*cap + rank
// (sentinel num_cells*cap past capacity or for invalid ids == num_cells),
// and the maximum cell occupancy for the overflow flag.
//
// Bound on an H100: bytes. It reads one int32 id and writes one int32 slot
// per particle (8 B/particle, ~0.13 MB at 16k particles, well under a
// microsecond at 3.35 TB/s); the rest is a few passes over a small
// (tiles x cells) count matrix, so at the main path's sizes launch latency
// dominates.
//
// Design: the TPU kernel walked its grid in order and carried the per-cell
// counters from tile to tile in VMEM. CUDA blocks run in no order, so the
// carry becomes three launches on one stream:
//   1. bin_count: per tile of 256 particles, each particle's rank among the
//      earlier particles of the tile with the same id (a scan of the tile in
//      shared memory), and the tile's count per id;
//   2. bin_scan: per id, an exclusive scan of the counts over tiles, in tile
//      order, and the total occupancy (atomicMax into the output);
//   3. bin_slot: rank = earlier tiles' count + in-tile rank; slot.
// Ranks never depend on the order atomics land in, so the K slots the
// neighbor scan fills are the same on every run.
#include "common.cuh"

namespace {

constexpr int kTile = 256;

__global__ void bin_count(const int32_t* __restrict__ cid, int m, int num_cells,
                          int32_t* __restrict__ in_rank,
                          int32_t* __restrict__ tile_counts) {
  __shared__ int32_t s_cid[kTile];
  const int tile = blockIdx.x;
  const int i = threadIdx.x;
  const int g = tile * kTile + i;
  s_cid[i] = g < m ? cid[g] : num_cells;
  __syncthreads();
  const int c = s_cid[i];
  if (g >= m || c < 0 || c >= num_cells) return;
  int before = 0, total = 0;
  for (int j = 0; j < kTile; ++j) {
    const int same = s_cid[j] == c;
    total += same;
    before += same & (j < i);
  }
  in_rank[g] = before;
  if (before == 0) tile_counts[(int64_t)tile * num_cells + c] = total;
}

__global__ void bin_scan(int n_tiles, int num_cells, int32_t* __restrict__ tile_counts,
                         int32_t* __restrict__ max_occ) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= num_cells) return;
  int running = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t at = (int64_t)t * num_cells + c;
    const int v = tile_counts[at];
    tile_counts[at] = running;
    running += v;
  }
  atomicMax(max_occ, running);
}

__global__ void bin_slot(const int32_t* __restrict__ cid, int m, int num_cells, int cap,
                         const int32_t* __restrict__ tile_counts,
                         int32_t* __restrict__ slots) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= m) return;
  const int c = cid[g];
  const int32_t sentinel = num_cells * cap;
  if (c < 0 || c >= num_cells) {
    slots[g] = sentinel;
    return;
  }
  const int rank = tile_counts[(int64_t)(g / kTile) * num_cells + c] + slots[g];
  slots[g] = rank < cap ? c * cap + rank : sentinel;
}

}  // namespace

// cid: (m,) int32 ids in [0, num_cells], num_cells meaning "not binned".
// slots: (m,) int32 output. tile_counts: (ceil(m/256), num_cells) int32
// scratch, zeroed by the caller. max_occ: (1,) int32, zeroed by the caller.
LBT_EXPORT int lbt_binning(const int32_t* cid, int m, int num_cells, int cap,
                           int32_t* slots, int32_t* tile_counts, int32_t* max_occ,
                           cudaStream_t stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const int n_tiles = lbt::ceil_div(m, kTile);
  // slots doubles as the in-tile rank buffer between passes 1 and 3
  bin_count<<<n_tiles, kTile, 0, stream>>>(cid, m, num_cells, slots, tile_counts);
  bin_scan<<<lbt::ceil_div(num_cells, 128), 128, 0, stream>>>(n_tiles, num_cells,
                                                              tile_counts, max_occ);
  bin_slot<<<lbt::ceil_div(m, 256), 256, 0, stream>>>(cid, m, num_cells, cap,
                                                      tile_counts, slots);
  return (int)cudaGetLastError();
}
