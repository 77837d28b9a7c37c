// The wgmma design of the wide path: the edge side of a bf16 fused GNS step
// (K3, K8, E2 and their encoder steps; K4's rematerialized forward) at latent
// widths F in (256, 512] in one kernel per step, fused_mp_edge_wgmma<F>,
// instanced at F = 320, 384, 448 and 512 (ops/fused_mp.py _design "wgmma").
// It replaces, at these widths, the product launches and the LayerNorm row
// kernel of mp_wide.cuh (which keeps float32 at every wide width and bf16
// above 512); the TPU kernel is lagrangebench_tpu/ops/fused_mp.py
// _make_fused_kernel (:177, launch :322) and its slot form (:708).
//
// Per 64-row tile of edge rows, with every intermediate on chip:
//   [enc]  r0 = T(relu(T(raw) @ enc_w1 + enc_b1)) into the R tile, then
//          e = T(LN(r0 @ enc_w2 + enc_b2)) into the E tile;
//   first = e @ W_e (the E tile, by TMA without the encoder); meanwhile the
//          sender rows (hs row m, or hs_ext row srow[m]) arrive in the R
//          tile; the epilogue adds them, hr of the row's receiver and b1 and
//          writes T(relu(first)) over them, in place;
//   x1    = T(relu(first)) @ W2 + b2, float32 in registers;
//   msg   = LN1(x1) over the first nf channels, its row sums crossing the two
//          consumer warpgroups (each owns half the columns) at a named
//          barrier; e' = T(e + msg) written over e in the E tile and stored
//          by TMA;
//   agg    : msg * mask goes through the R tile (free once the second product
//          is done) as float32, a column at a time in row order, into one
//          float32 partial per (tile, receiver it touches);
//          fused_mp_wide_agg then sums each receiver's partials in tile order
//          into T(agg). No atomics: two launches give the same bits.
// The TPU kernel's roundings are kept: T(relu(first)) before W2, T(agg)
// before W_na (the node side stays on mp_wide.cuh's launches).
//
// Block: 384 threads. Warpgroup 2 produces: warp 8 (one thread) keeps TMA
// loads of the 32-deep k-slabs of enc_w2, W_e and W2 in flight (32 x F bf16
// per stage, 64-byte swizzle, one 32-column panel per box) into a ring of
// `stages` slots with full and empty mbarriers; warp 9 loads the E tile by
// TMA (64 x F bf16, 128-byte swizzle, F / 64 boxes) once the last e' store
// has read it; warps 9-11 copy the tile's sender rows into the R tile with
// cp.async (16-byte chunks at their swizzled places, zeros for a padded slot)
// once the consumers release it, each lane waiting for its own copies before
// it arrives. Warpgroups 0 and 1 run wgmma m64nNk16 (N = F / 2, A from the E
// or R tile, K-major; B the weight slab, N-major), 128 float32 accumulators a
// thread at F = 512 (setmaxnreg: 232 registers for them, 40 for warpgroup
// 2). Blocks run in clusters of GCL = 2 on neighbouring SMs: each producer
// loads half of every weight slab and multicasts it to both, so the weights
// leave L2 once per two row tiles; each stage is released to the producers of
// both blocks. The grid is persistent (one block per SM, at most the SM count
// rounded down to the cluster), tile it * grid + block; a block past the last
// tile runs its cluster's slabs without products.
//
// Shared memory at F = 512: E 64 KB, R 64 KB, 3 stages of 32 KB, the LayerNorm
// exchange 1 KB, the barriers and 1 KB to align: 231,504 of 232,448 bytes
// (GSmem; 4, 5 and 6 stages at F = 448, 384 and 320).
// Bound on an H100: operations (2 x 2 F^2 FLOP per edge row against 6 F bytes
// of e, hs and e' in bf16); the weights' L2 traffic (W_e + W2, 4 F^2 bytes per
// 64-row tile) is what the clusters' multicast halves.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "mp_warp.cuh"

namespace {

constexpr int GBM = 64;         // edge rows per tile
constexpr int GBK = 32;         // k rows per weight slab
constexpr int GCL = 2;          // blocks per cluster sharing each weight slab
constexpr int GTHREADS = 384;   // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kWgmmaMax = 512;  // the widest F of this design
constexpr int GMAX_STAGES = 6;

template <int F>
struct GSmem {
  static constexpr int TILE = GBM * F * 2;   // the E and R tiles, bf16
  static constexpr int STAGE = GBK * F * 2;  // a weight slab
  static constexpr int RED = 2 * 2 * GBM * 4;  // LayerNorm row sums: 2 passes x 2 warpgroups
  // the block asks for 1,024 bytes more than it uses, to align the tiles
  static constexpr int STAGES_FIT =
      (kSmemMax - 1024 - 2 * TILE - RED - (2 * GMAX_STAGES + 4) * 8) / STAGE;
  static constexpr int STAGES = STAGES_FIT < GMAX_STAGES ? STAGES_FIT : GMAX_STAGES;
  static constexpr int OFF_E = 0, OFF_R = TILE, OFF_W = 2 * TILE;
  static constexpr int OFF_RED = OFF_W + STAGES * STAGE;
  // full[STAGES], empty[STAGES], e_full, e_empty, hs_full, r_empty
  static constexpr int OFF_BAR = OFF_RED + RED;
  static constexpr int kBytes = OFF_BAR + (2 * STAGES + 4) * 8 + 1024;
  static_assert(STAGES >= 3 && kBytes <= kSmemMax, "the wgmma edge kernel fits a block");
  static_assert(F % 64 == 0 && F > 256 && F <= kWgmmaMax, "an instance width of the design");
};

// ---- PTX: barriers, TMA, wgmma ----------------------------------------------

__device__ __forceinline__ void mbar_init(u32 bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(u32 bar, u32 bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(u32 bar, u32 parity) {
  u32 done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(u32 bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// arrive on the barrier at the same offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(u32 bar, u32 rank) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}
__device__ __forceinline__ u32 cluster_rank() {
  u32 r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;" ::
                   : "memory");
}
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
// generic-proxy shared-memory writes visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void tma_load(u32 dst, const CUtensorMap* map, int c0, int c1, u32 bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// the same box into every block of `mask`, each signalling its own barrier
__device__ __forceinline__ void tma_load_mc(u32 dst, const CUtensorMap* map, int c0, int c1,
                                           u32 bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, u32 src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
// 16 bytes from device memory into shared memory (zero-filled where `bytes`
// is 0)
__device__ __forceinline__ void cp_async_16(u32 dst, const void* src, u32 bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory matrix descriptor: start, leading and stride byte offsets,
// swizzle (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t gdesc(u32 addr, u32 lbo, u32 sbo, u32 swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}

// D (64 x N float32) (+)= A (64 x 16, K-major) @ B (16 x N, N-major), bf16
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<160>(float (&d)[80], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float (&d)[96], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<224>(float (&d)[112], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- the kernel -------------------------------------------------------------

struct WgEdgeArgs {
  const void* e;        // (rows, F) T, the residual without the encoder (TMA reads the tile)
  const float* raw;     // with the encoder: (rows, fe) float32
  const void* hs;       // src 0: (rows, F) gathered; else hs_ext (n_ext, F) through srow
  const int32_t* srow;  // (rows) sender row of every edge row, -1 on a padded slot, or null
  const void* hr;       // (n, F)
  const float* mask;    // src 0: (rows)
  void* e_out;          // (rows, F) T, or null (K4's rematerialization)
  float* x1_out;        // (rows, F) float32 pre-LayerNorm rows, or null
  float* partials;      // (tiles, slots, F) float32 agg partials
  const float* vec[4];  // b1, b2, ln1_scale, ln1_bias
  const void* enc_w1;   // (fe, F) T
  const float* enc_vec[4];  // enc_b1, enc_b2, enc_ln_scale, enc_ln_bias
  int64_t rows;
  int k, nf, fe, tiles, slots;
  int enc, store_r1;
};

// byte offset of element (r, c) of a 64 x F bf16 tile stored as F / 64 boxes of
// 64 rows x 128 bytes with the 128-byte swizzle (the TMA layout of the E tile)
__device__ __forceinline__ u32 swz128(int r, int c) {
  return (u32)((c >> 6) * (GBM * 128) + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2);
}
__device__ __forceinline__ u32 pack_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const u32*>(&v);
}
__device__ __forceinline__ float2 unpack_bf2(u32 v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// a bf16 pair of a row (0 without one), read-only for the kernel's lifetime
__device__ __forceinline__ u32 ldg_pair(const bf16* row, int c) {
  return row != nullptr ? __ldg(reinterpret_cast<const unsigned int*>(row + c)) : 0u;
}
// tile stores and loads without a memory clobber (the fences and named
// barriers around them order them), so that loads of device memory move past
__device__ __forceinline__ void sts32(u32 addr, u32 v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v));
}
__device__ __forceinline__ u32 lds32(u32 addr) {
  u32 v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}
// the epilogues read their rows' operands JB column blocks at a time (the
// last batch of a warpgroup's NJ blocks may be short), all loads of a batch
// issued before its arithmetic and stores
constexpr int JB = 4;

template <int F>
__global__ void __launch_bounds__(GTHREADS, 1)
    fused_mp_edge_wgmma(const __grid_constant__ CUtensorMap tm_e,
                        const __grid_constant__ CUtensorMap tm_w0,
                        const __grid_constant__ CUtensorMap tm_w1,
                        const __grid_constant__ CUtensorMap tm_w2,
                        const __grid_constant__ CUtensorMap tm_r1,
                        const __grid_constant__ CUtensorMap tm_eo, const WgEdgeArgs a) {
  using L = GSmem<F>;
  constexpr int N = F / 2;     // columns of a consumer warpgroup
  constexpr int NA = N / 2;    // its accumulators per thread
  constexpr int NJ = N / 8;    // its 8-column blocks
  constexpr int P = F / 32;    // 32-column panels of a weight slab
  constexpr int CW = F / 4;    // columns of a warpgroup's agg chunk (two per warpgroup)
  constexpr int G = CW / 8;    // 8-column groups of a chunk
  constexpr int S = L::STAGES;
  extern __shared__ __align__(128) unsigned char gsmem[];
  // the swizzled tiles start on a 1024-byte boundary
  unsigned char* smem = gsmem + ((1024 - (smem_addr(gsmem) & 1023)) & 1023);
  const u32 sb = smem_addr(smem);
  const u32 sE = sb + L::OFF_E, sR = sb + L::OFF_R, sW = sb + L::OFF_W;
  const u32 full0 = sb + L::OFF_BAR, empty0 = full0 + 8 * S, e_full = empty0 + 8 * S,
            e_empty = e_full + 8, hs_full = e_full + 16, r_empty = e_full + 24;
  constexpr int COPY_LANES = 96;  // warps 9-11 copy each tile's sender rows
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * GCL);
    }
    mbar_init(e_full, 1);
    mbar_init(e_empty, 1);
    mbar_init(hs_full, COPY_LANES);
    mbar_init(r_empty, 2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const int rounds = (a.tiles + (int)gridDim.x - 1) / (int)gridDim.x;
  const int first_w = a.enc ? 0 : 1;  // the weights of the step: [enc_w2,] W_e, W2

  if (tid >= 256) {  // ---- producer warpgroup
    setmaxnreg_dec<40>();
    if (tid >= 256 + 32) {
      // warps 9-11: each tile's E tile by TMA (warp 9, lane 0) and its sender
      // rows into the R tile by cp.async (16-byte chunks at their swizzled
      // places, zeros for a padded slot or a row past the last), while the
      // first product runs
      const int cl = tid - 256 - 32;
      u32 eph = 0, rph = 0;
      const bf16* hs = static_cast<const bf16*>(a.hs);
      for (int it = 0; it < rounds; ++it) {
        const int tile = it * (int)gridDim.x + (int)blockIdx.x;
        if (tile >= a.tiles) break;
        const int64_t m0 = (int64_t)tile * GBM;
        if (cl < 32 && !a.enc) {  // all of warp 9 waits (no lanes of a warp wait apart)
          mbar_wait(e_empty, eph ^ 1);
          if (cl == 0) {
            mbar_expect(e_full, L::TILE);
#pragma unroll 1
            for (int p = 0; p < F / 64; ++p)
              tma_load(sE + p * (GBM * 128), &tm_e, 64 * p, (int)m0, e_full);
          }
          __syncwarp();
          eph ^= 1;
        }
        mbar_wait(r_empty, rph);  // the consumers' release of the R tile for this tile
        rph ^= 1;
#pragma unroll 1
        for (int i = cl; i < GBM * (F / 8); i += COPY_LANES) {
          const int r = i / (F / 8), c = 8 * (i % (F / 8));
          const int64_t m = m0 + r;
          int64_t src = -1;
          if (m < a.rows) src = a.srow == nullptr ? m : (int64_t)__ldg(a.srow + m);
          cp_async_16(sR + swz128(r, c), src >= 0 ? hs + src * F + c : hs, src >= 0 ? 16u : 0u);
        }
        cp_async_wait_all();  // this lane's copies have landed
        mbar_arrive(hs_full);
      }
    } else if (tid == 256) {
      const u32 rank = cluster_rank();
      int stage = 0;
      u32 ph = 0;
      for (int it = 0; it < rounds; ++it) {
        for (int w = first_w; w < 3; ++w) {
          const CUtensorMap* tm = w == 0 ? &tm_w0 : w == 1 ? &tm_w1 : &tm_w2;
#pragma unroll 1
          for (int ks = 0; ks < F / GBK; ++ks) {
            mbar_wait(empty0 + 8 * stage, ph ^ 1);
            mbar_expect(full0 + 8 * stage, L::STAGE);
            const u32 dst = sW + stage * L::STAGE;
#pragma unroll 1
            for (int p = rank * (P / GCL); p < (int)(rank + 1) * (P / GCL); ++p) {
              if constexpr (GCL > 1)
                tma_load_mc(dst + p * (GBK * 64), tm, 32 * p, ks * GBK, full0 + 8 * stage,
                            (uint16_t)((1 << GCL) - 1));
              else
                tma_load(dst + p * (GBK * 64), tm, 32 * p, ks * GBK, full0 + 8 * stage);
            }
            if (++stage == S) {
              stage = 0;
              ph ^= 1;
            }
          }
        }
      }
      // stay until every stage is released by the consumers of the whole
      // cluster: no arrival or multicast may reach a block that has exited
      for (int s = 0; s < S; ++s) {
        mbar_wait(empty0 + 8 * stage, ph ^ 1);
        if (++stage == S) {
          stage = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups 0 and 1: columns [wg N, wg N + N)
  setmaxnreg_inc<232>();
  const int wg = tid >> 7, tw = tid & 127, lane = tid & 31, q4 = lane & 3;
  const int rA = 16 * (tw >> 5) + (lane >> 2);  // this thread's rows rA and rA + 8
  const int c0 = wg * N + 2 * q4;               // its columns c0 + 8 j, + 1
  float* red = reinterpret_cast<float*>(smem + L::OFF_RED);  // [pass][wg][row]
  float acc[NA];
  int stage = 0;
  u32 ph = 0, eph = 0, hph = 0;

  auto release = [&](int s) {
    if (tw == 0) {
#pragma unroll
      for (int r = 0; r < GCL; ++r) mbar_arrive_cluster(empty0 + 8 * s, (u32)r);
    }
  };
  // acc = A (the 64 x F tile at sA) @ the next F / GBK slabs of the ring
  auto product = [&](u32 sA, bool run) {
    int prev = -1;
#pragma unroll 1
    for (int ks = 0; ks < F / GBK; ++ks) {
      mbar_wait(full0 + 8 * stage, ph);
      if (run) {
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int qq = 0; qq < GBK / 16; ++qq) {
          const int kk = ks * GBK + qq * 16;
          const uint64_t da = gdesc(sA + (kk >> 6) * (GBM * 128) + (kk & 63) * 2, 16, 1024, 1);
          const uint64_t db =
              gdesc(sW + stage * L::STAGE + wg * (N / 32) * (GBK * 64) + qq * 1024, GBK * 64, 512, 2);
          wgmma_bf16<N>(acc, da, db, (ks | qq) != 0);
        }
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
      } else if (prev >= 0) {
        release(prev);
      }
      prev = stage;
      if (++stage == S) {
        stage = 0;
        ph ^= 1;
      }
    }
    if (run) {
      wgmma_wait<0>();
      fence_acc(acc);
    }
    release(prev);
  };
  // acc (+ bias) -> LayerNorm over the first nf channels, scale and bias, in
  // place; the row sums cross the two warpgroups through `red`
  auto layer_norm = [&](const float* bias, const float* scale, const float* shift) {
    float sA = 0.f, sB = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = c0 + 8 * j;
      const float2 b = *reinterpret_cast<const float2*>(bias + c);
      acc[4 * j] += b.x;
      acc[4 * j + 1] += b.y;
      acc[4 * j + 2] += b.x;
      acc[4 * j + 3] += b.y;
      if (c < a.nf) {
        sA += acc[4 * j];
        sB += acc[4 * j + 2];
      }
      if (c + 1 < a.nf) {
        sA += acc[4 * j + 1];
        sB += acc[4 * j + 3];
      }
    }
    sA += __shfl_xor_sync(lbt::kFullMask, sA, 1);
    sA += __shfl_xor_sync(lbt::kFullMask, sA, 2);
    sB += __shfl_xor_sync(lbt::kFullMask, sB, 1);
    sB += __shfl_xor_sync(lbt::kFullMask, sB, 2);
    if (q4 == 0) {
      red[wg * GBM + rA] = sA;
      red[wg * GBM + rA + 8] = sB;
    }
    named_bar(1, 256);
    const float meanA = (red[rA] + red[GBM + rA]) / a.nf;
    const float meanB = (red[rA + 8] + red[GBM + rA + 8]) / a.nf;
    float vA = 0.f, vB = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (c0 + 8 * j + i < a.nf) {
          const float dA = acc[4 * j + i] - meanA, dB = acc[4 * j + 2 + i] - meanB;
          vA += dA * dA;
          vB += dB * dB;
        }
      }
    }
    vA += __shfl_xor_sync(lbt::kFullMask, vA, 1);
    vA += __shfl_xor_sync(lbt::kFullMask, vA, 2);
    vB += __shfl_xor_sync(lbt::kFullMask, vB, 1);
    vB += __shfl_xor_sync(lbt::kFullMask, vB, 2);
    if (q4 == 0) {
      red[2 * GBM + wg * GBM + rA] = vA;
      red[2 * GBM + wg * GBM + rA + 8] = vB;
    }
    named_bar(1, 256);
    const float invA = rsqrtf((red[2 * GBM + rA] + red[3 * GBM + rA]) / a.nf + kEps);
    const float invB = rsqrtf((red[2 * GBM + rA + 8] + red[3 * GBM + rA + 8]) / a.nf + kEps);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = c0 + 8 * j + i;
        const bool in = c < a.nf;
        const float sc = scale[c], sh = shift[c];
        acc[4 * j + i] = in ? (acc[4 * j + i] - meanA) * invA * sc + sh : 0.f;
        acc[4 * j + 2 + i] = in ? (acc[4 * j + 2 + i] - meanB) * invB * sc + sh : 0.f;
      }
    }
  };

#pragma unroll 1
  for (int it = 0; it < rounds; ++it) {
    const int tile = it * (int)gridDim.x + (int)blockIdx.x;
    if (tile >= a.tiles) {  // keep the cluster's slabs moving
      for (int w = first_w; w < 3; ++w) product(sE, false);
      continue;
    }
    const int64_t m0 = (int64_t)tile * GBM;
    const int64_t mA = m0 + rA, mB = mA + 8;
    const bool okA = mA < a.rows, okB = mB < a.rows;
    if (a.enc) {
      // r0 = T(relu(T(raw) @ enc_w1 + enc_b1)) into the R tile: thread t < F / 2
      // owns the column pair 2 t, its enc_w1 pairs in registers (fe <= 16)
      if (tid < F / 2) {
        const int c = 2 * tid;
        const bf16* w1 = static_cast<const bf16*>(a.enc_w1);
        float2 w[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = unpack_bf2(j < a.fe ? ldg_pair(w1 + (int64_t)j * F, c) : 0u);
        const float2 b = __ldg(reinterpret_cast<const float2*>(a.enc_vec[0] + c));
#pragma unroll 4
        for (int r = 0; r < GBM; ++r) {
          const int64_t m = m0 + r;
          float v0 = 0.f, v1 = 0.f;
          if (m < a.rows) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              if (j < a.fe) {
                const float x = __bfloat162float(__float2bfloat16(__ldg(a.raw + m * a.fe + j)));
                v0 = fmaf(x, w[j].x, v0);
                v1 = fmaf(x, w[j].y, v1);
              }
            }
          }
          sts32(sR + swz128(r, c), pack_bf2(fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f)));
        }
      }
      fence_async_smem();
      named_bar(1, 256);
      product(sR, true);
      // e = T(LN(r0 @ enc_w2 + enc_b2)) into the E tile
      layer_norm(a.enc_vec[1], a.enc_vec[2], a.enc_vec[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + 8 * j;
        sts32(sE + swz128(rA, c), pack_bf2(acc[4 * j], acc[4 * j + 1]));
        sts32(sE + swz128(rA + 8, c), pack_bf2(acc[4 * j + 2], acc[4 * j + 3]));
      }
      fence_async_smem();
      named_bar(1, 256);
    } else {
      mbar_wait(e_full, eph);
      eph ^= 1;
    }
    if (tw == 0) mbar_arrive(r_empty);  // the copy warps may fill the R tile with hs

    // first = e @ W_e
    product(sE, true);
    // + hs (in the R tile) + hr + b1 -> T(relu(first)) into the R tile, in place
    mbar_wait(hs_full, hph);
    hph ^= 1;
    {
      const bf16* hr = static_cast<const bf16*>(a.hr);
      const bf16* hrA = okA ? hr + (mA / a.k) * F : nullptr;
      const bf16* hrB = okB ? hr + (mB / a.k) * F : nullptr;
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += JB) {
        u32 sA[JB], sB[JB], hA[JB], hB[JB];
        float2 b[JB];
#pragma unroll
        for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
          const int c = c0 + 8 * (j0 + jj);
          sA[jj] = lds32(sR + swz128(rA, c));
          sB[jj] = lds32(sR + swz128(rA + 8, c));
          hA[jj] = ldg_pair(hrA, c);
          hB[jj] = ldg_pair(hrB, c);
          b[jj] = __ldg(reinterpret_cast<const float2*>(a.vec[0] + c));
        }
#pragma unroll
        for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
          const int j = j0 + jj, c = c0 + 8 * j;
          const float2 sa = unpack_bf2(sA[jj]), sb = unpack_bf2(sB[jj]);
          const float2 ha = unpack_bf2(hA[jj]), hb = unpack_bf2(hB[jj]);
          // acc + hs + hr + b1 in the plain version's order
          sts32(sR + swz128(rA, c), pack_bf2(fmaxf(acc[4 * j] + sa.x + ha.x + b[jj].x, 0.f),
                                             fmaxf(acc[4 * j + 1] + sa.y + ha.y + b[jj].y, 0.f)));
          sts32(sR + swz128(rA + 8, c),
                pack_bf2(fmaxf(acc[4 * j + 2] + sb.x + hb.x + b[jj].x, 0.f),
                         fmaxf(acc[4 * j + 3] + sb.y + hb.y + b[jj].y, 0.f)));
        }
      }
    }
    fence_async_smem();
    named_bar(1, 256);
    if (a.store_r1 && tid == 0) {  // K4: T(relu(first)) to device memory too
#pragma unroll 1
      for (int p = 0; p < F / 64; ++p) tma_store(&tm_r1, sR + p * (GBM * 128), 64 * p, (int)m0);
      bulk_commit();
    }

    // x1 = T(relu(first)) @ W2 + b2 -> msg = LN1(x1)
    product(sR, true);
    if (a.x1_out != nullptr) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + 8 * j;
        const float2 b = *reinterpret_cast<const float2*>(a.vec[1] + c);
        if (okA)
          *reinterpret_cast<float2*>(a.x1_out + mA * F + c) =
              make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
        if (okB)
          *reinterpret_cast<float2*>(a.x1_out + mB * F + c) =
              make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
      }
    }
    if (a.store_r1 && tid == 0) bulk_wait_read();  // the R tile is scratch below
    layer_norm(a.vec[1], a.vec[2], a.vec[3]);
    // e' = T(e + msg) into the E tile, in place, then to device memory by TMA
    if (a.e_out != nullptr) {
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += JB) {
        u32 vA[JB], vB[JB];
#pragma unroll
        for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
          const int c = c0 + 8 * (j0 + jj);
          vA[jj] = lds32(sE + swz128(rA, c));
          vB[jj] = lds32(sE + swz128(rA + 8, c));
        }
#pragma unroll
        for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
          const int j = j0 + jj, c = c0 + 8 * j;
          const float2 ea = unpack_bf2(vA[jj]), eb = unpack_bf2(vB[jj]);
          sts32(sE + swz128(rA, c), pack_bf2(ea.x + acc[4 * j], ea.y + acc[4 * j + 1]));
          sts32(sE + swz128(rA + 8, c), pack_bf2(eb.x + acc[4 * j + 2], eb.y + acc[4 * j + 3]));
        }
      }
      fence_async_smem();
      named_bar(1, 256);
      if (tid == 0) {
#pragma unroll 1
        for (int p = 0; p < F / 64; ++p) tma_store(&tm_eo, sE + p * (GBM * 128), 64 * p, (int)m0);
        bulk_commit();
      }
    }
    // agg partials: msg * mask through the R tile, a chunk of CW columns of
    // this warpgroup at a time (rows rotated by 8-column groups), then each
    // column summed down its rows in order, one partial per receiver
    {
      float mkA = 0.f, mkB = 0.f;
      if (a.srow == nullptr) {
        if (okA) mkA = a.mask[mA];
        if (okB) mkB = a.mask[mB];
      } else {
        if (okA) mkA = a.srow[mA] >= 0 ? 1.f : 0.f;
        if (okB) mkB = a.srow[mB] >= 0 ? 1.f : 0.f;
      }
      float* scr = reinterpret_cast<float*>(smem + L::OFF_R + wg * (L::TILE / 2));
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const int j = ch * G + jj;
          *reinterpret_cast<float2*>(scr + rA * CW + 8 * ((jj + rA) % G) + 2 * q4) =
              make_float2(acc[4 * j] * mkA, acc[4 * j + 1] * mkA);
          *reinterpret_cast<float2*>(scr + (rA + 8) * CW + 8 * ((jj + rA + 8) % G) + 2 * q4) =
              make_float2(acc[4 * j + 2] * mkB, acc[4 * j + 3] * mkB);
        }
        named_bar(2 + wg, 128);
        if (tw < CW) {
          const int col = wg * N + ch * CW + tw, grp = tw >> 3, within = tw & 7;
          float* out = a.partials + (int64_t)tile * a.slots * F + col;
          const int last = (int)((a.rows - m0 < GBM ? a.rows - m0 : GBM) - 1);
          int rem = (int)(m0 % a.k), slot = 0;
          float s = 0.f;
#pragma unroll 1
          for (int r0 = 0; r0 <= last; r0 += 8) {
            float v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = scr[(r0 + i) * CW + 8 * ((grp + r0 + i) % G) + within];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int r = r0 + i;
              if (r <= last) {
                s += v[i];
                if (++rem == a.k || r == last) {
                  out[(int64_t)slot * F] = s;
                  s = 0.f;
                  if (rem == a.k) {
                    rem = 0;
                    ++slot;
                  }
                }
              }
            }
          }
        }
        named_bar(2 + wg, 128);
      }
    }
    // the E tile is free once the e' store has read it; the R tile once
    // both warpgroups are past their agg pass
    if (tid == 0 && a.e_out != nullptr) bulk_wait_read();
    named_bar(1, 256);
    if (!a.enc && tid == 0) mbar_arrive(e_empty);
  }
  if (tid == 0) bulk_wait();  // the e' and r1 stores have landed
}

// T(agg) (and agg in float32, for checks) of every receiver: its partials of
// the tiles that hold its rows, summed in tile order
template <typename T>
__global__ void fused_mp_wide_agg(const float* partials, int slots, int k, int64_t n, int F,
                                  T* aggc, float* agg) {
  const int64_t pairs = n * (F / 2);
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < pairs;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t i = idx / (F / 2);
    const int c = 2 * (int)(idx % (F / 2));
    const int64_t t0 = i * k / GBM, t1 = ((i + 1) * k - 1) / GBM;
    float s0 = 0.f, s1 = 0.f;
    for (int64_t t = t0; t <= t1; ++t) {
      const int64_t q = i - (GBM * t) / k;
      const float2 v = *reinterpret_cast<const float2*>(partials + (t * slots + q) * F + c);
      s0 += v.x;
      s1 += v.y;
    }
    if constexpr (std::is_same<T, bf16>::value)
      *reinterpret_cast<__nv_bfloat162*>(aggc + i * F + c) = __floats2bfloat162_rn(s0, s1);
    else
      *reinterpret_cast<float2*>(aggc + i * F + c) = make_float2(s0, s1);
    if (agg != nullptr) *reinterpret_cast<float2*>(agg + i * F + c) = make_float2(s0, s1);
  }
}

// ---- host side ----------------------------------------------------------------

// agg partial slots per tile: the receivers 64 rows can touch
inline int wgmma_slots(int k) {
  const int s = 63 / k + 2;
  return s < GBM ? s : GBM;
}
inline int wgmma_tiles(int64_t rows) { return (int)((rows + GBM - 1) / GBM); }

// cuTensorMapEncodeTiled from the driver, found through the runtime (no link
// against libcuda)
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a (outer, inner) row-major bf16 tensor in boxes of (box_out, box_in)
inline int tensor_map(CUtensorMap* m, const void* ptr, uint64_t inner, uint64_t outer,
                      uint32_t box_in, uint32_t box_out, CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 enc = tensor_map_encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_in, box_out};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the persistent grid: a block per SM, whole clusters, no more than the tiles
inline int wgmma_grid(int tiles) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const int clusters = (tiles + GCL - 1) / GCL, fit = sms / GCL;
  return (clusters < fit ? clusters : fit) * GCL;
}

template <int F>
int launch_edge_wgmma(const WgEdgeArgs& a, const void* enc_w2, const void* w_e, const void* w2,
                      void* r1_out, cudaStream_t stream) {
  CUtensorMap te{}, t0{}, t1{}, t2{}, tr{}, to{};
  int err = 0;
  if (!a.enc && (err = tensor_map(&te, a.e, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  if (a.enc && (err = tensor_map(&t0, enc_w2, F, F, 32, GBK, CU_TENSOR_MAP_SWIZZLE_64B)))
    return err;
  if ((err = tensor_map(&t1, w_e, F, F, 32, GBK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if ((err = tensor_map(&t2, w2, F, F, 32, GBK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if (a.store_r1 &&
      (err = tensor_map(&tr, r1_out, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  if (a.e_out != nullptr &&
      (err = tensor_map(&to, a.e_out, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B)))
    return err;
  const int grid = wgmma_grid(a.tiles);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  constexpr int smem = GSmem<F>::kBytes;
  cudaError_t e =
      cudaFuncSetAttribute(fused_mp_edge_wgmma<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(GTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = GCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fused_mp_edge_wgmma<F>, te, t0, t1, t2, tr, to, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the edge kernel at F (320, 384, 448 or 512), then T(agg) from its partials
template <typename T>
int edge_wgmma(const WgEdgeArgs& a, int F, const void* enc_w2, const void* w_e, const void* w2,
               void* r1_out, T* aggc, float* agg, int64_t n, cudaStream_t stream) {
  int err;
  switch (F) {
    case 320:
      err = launch_edge_wgmma<320>(a, enc_w2, w_e, w2, r1_out, stream);
      break;
    case 384:
      err = launch_edge_wgmma<384>(a, enc_w2, w_e, w2, r1_out, stream);
      break;
    case 448:
      err = launch_edge_wgmma<448>(a, enc_w2, w_e, w2, r1_out, stream);
      break;
    case 512:
      err = launch_edge_wgmma<512>(a, enc_w2, w_e, w2, r1_out, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int64_t pairs = n * (F / 2);
  fused_mp_wide_agg<T><<<(unsigned)((pairs + 255) / 256 < (1 << 16) ? (pairs + 255) / 256 : (1 << 16)),
                         256, 0, stream>>>(a.partials, a.slots, a.k, n, F, aggc, agg);
  return (int)cudaGetLastError();
}

}  // namespace
