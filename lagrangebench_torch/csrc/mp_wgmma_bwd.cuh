// The wgmma design of K4 (the backward of a bf16 fused GNS step) at latent
// widths F in (256, 512], instanced at F = 320, 384, 448 and 512 like the
// forward's edge kernel (mp_wgmma.cuh). The TPU kernel is
// lagrangebench_tpu/ops/fused_mp.py _fused_bwd_kernel (:443, launch :600).
// It replaces, at these widths, the thirteen product launches and the edge
// row kernels of mp_wide.cuh's wide_backward, which stays the backward for
// float32 and for bf16 above 512.
//
// A step's backward, in launches:
//   1. fused_mp_edge_wgmma (mp_wgmma.cuh), the forward's own edge kernel,
//      rematerializes T(relu(first)) (r1, bf16, to device memory) and T(agg)
//      through its partials: the bits K3 produced, so every ReLU decision
//      is the forward's;
//   2. the node side on the wide path's launches (node_first, y1, LN2's
//      backward, dnf, dh, dagg; wide_node_bwd in mp_wide.cuh);
//   3. fused_mp_bwd_edge_wgmma<F>: the edge side of the backward, per
//      64-row tile with the rows on chip (below);
//   4. fused_mp_wide_agg sums its dfirst partials into T(dhr);
//   5. fused_mp_bwd_tn_wgmma: the edge weight gradients dW_e = e^T T(dfirst)
//      and dW2 = r1^T T(dx1) as wgmma products with both operands MN-major;
//      the node weight gradients stay on mp_wide.cuh's TN launches;
//   6. fused_mp_bwd_wide_reduce sums every partial in order.
// No atomics: two launches give the same bits.
//
// fused_mp_bwd_edge_wgmma<F>, per tile (a persistent grid, clusters of 2
// multicasting each weight slab, 384 threads: consumer warpgroups 0 and 1
// own the column halves, producer warpgroup 2 as in the forward):
//   x1 = T(relu(first)) @ W2 + b2 (the R tile, r1 by TMA, against W2's
//     slabs): K3's product on K3's operands, so x1 and LN1's statistics
//     (the row sums crossing the warpgroups at a named barrier) are the
//     forward's bits, without x1 going through device memory;
//   ge arrives in the E tile by TMA during that product: dm = ge + dagg *
//     mask, LN1's backward (two passes over the row, its sums crossing the
//     warpgroups) -> T(dx1) written over ge in place, then stored by TMA
//     (dW2's operand);
//   dfirst = T(dx1) @ W2^T (the E tile against W2^T's slabs), masked where
//     T(relu(first)) (the R tile) is 0; T(dfirst) written over it in place
//     and stored by TMA as dhs (dW_e's operand too);
//   dfirst through the E tile as float32, a column per thread in row order:
//     one partial of sum_K dfirst per (tile, receiver it touches), and the
//     block's running b1 sums;
//   de = T(ge + T(dfirst) @ W_e^T) (the R tile against W_e^T's slabs; ge
//     loaded into the E tile again by TMA during the product) in place in
//     the E tile, stored by TMA.
// The wrapper passes W_e^T and W2^T (2 F^2 bytes each), so every product
// reads its weight slabs as the forward does. The vector gradients b2,
// ln1_scale and ln1_bias are summed over each warp's 16 rows of a tile in
// registers and shuffles (the 8 lanes of a column reduced and scattered,
// 4 column blocks at a time), then added to the warp's running sums in
// shared memory, one lane owning each; b1 by the dfirst pass's column
// threads. Each block writes its 4 x 4 vector partials once, at its end.
// Held in registers across a tile, the running sums made the kernel spill
// (ptxas caps the 384-thread kernel at 168 registers, setmaxnreg or not;
// 732 B of spill stores at F = 512).
// Shared memory (GBSmem<F>): the forward's layout (the E and R tiles, 64 x
// F bf16 each; the ring of weight slabs; the LayerNorm exchange; barriers)
// and the warps' running sums (24 F bytes): 223,296 of 232,448 bytes at F =
// 512 with 2 weight stages (3, 4 and 6 at 448, 384 and 320). Every
// intermediate reuses a tile in place: ge -> T(dx1) -> float32 dfirst
// scratch (each warpgroup half a tile, two 64 x F/4 column chunks) -> ge
// -> de in the E tile; T(relu(first)) -> T(dfirst) in the R tile. dagg goes
// from device memory (L1) to registers.
//
// fused_mp_bwd_tn_wgmma: C (F x F) = A^T B summed over a fixed range of
// edge rows, one float32 partial per range (ranges of whole 64-row chunks,
// wgmma_tn_rows). A block owns a 128 x 128 output tile of one range and
// one gradient: each consumer warpgroup 64 rows, m64n128k16 with A and B
// MN-major from 64-byte-swizzled TMA panels (64 edge rows x 32 columns);
// each 64-row stage's products go into a fresh accumulator that is then
// added in float32 (the tensor cores' own sums over tens of thousands of
// rows drift from float64, mp_wide.cuh).
//
// Bound on an H100: operations. Per edge row at F = 512 the backward needs
// six products of 2 F^2 FLOP (the forward's two again, dfirst, de, dW_e,
// dW2): 2.0 TFLOP at 16,000 x 40 rows, 2.0 ms at 989 TFLOP/s; this design
// runs seven (x1 twice) and moves ~6 GB of edge rows through device memory
// (e, hs, ge twice, r1 three times, T(dx1) and dhs twice, de), 1.8 ms at
// 3.35 TB/s.
#pragma once

#include "mp_wide.cuh"

namespace {

// D (64 x 128 float32) (+)= A (64 x 16) @ B (16 x 128), bf16, both operands
// MN-major in shared memory (A^T B over the edge rows of a weight gradient)
__device__ __forceinline__ void wgmma_tn128(float (&d)[64], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the sums over the 8 lanes of a warp that share lane % 4 (rows g = lane / 4
// of an accumulator) of 8 values v[2 jj + i] (8-column block jj < 4, column
// i of the pair), scattered: lane group g returns the sum of v[g]. Three
// halvings (xor 16, 8, 4), 7 shuffles, a fixed order of additions.
__device__ __forceinline__ float reduce_scatter4(const float (&v)[8], int lane) {
  float a[4], b[2];
  const bool h2 = lane & 16, h1 = lane & 8, h0 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h2 ? v[i] : v[4 + i];
    a[i] = (h2 ? v[4 + i] : v[i]) + __shfl_xor_sync(lbt::kFullMask, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h1 ? a[i] : a[2 + i];
    b[i] = (h1 ? a[2 + i] : a[i]) + __shfl_xor_sync(lbt::kFullMask, send, 8);
  }
  const float send = h0 ? b[0] : b[1];
  return (h0 ? b[1] : b[0]) + __shfl_xor_sync(lbt::kFullMask, send, 4);
}

// The edge-backward kernel's shared memory: the forward's layout (GSmem)
// plus each consumer warp's running column sums of b2, ln1_scale and
// ln1_bias (8 warps x 3 x F / 2 float32), as many weight stages as then fit
template <int F>
struct GBSmem {
  static constexpr int TILE = GBM * F * 2;
  static constexpr int STAGE = GBK * F * 2;
  static constexpr int RED = 2 * 2 * GBM * 4;
  static constexpr int VEC = 8 * 3 * (F / 2) * 4;
  static constexpr int STAGES_FIT =
      (kSmemMax - 1024 - 2 * TILE - RED - VEC - (2 * GMAX_STAGES + 4) * 8) / STAGE;
  static constexpr int STAGES = STAGES_FIT < GMAX_STAGES ? STAGES_FIT : GMAX_STAGES;
  static constexpr int OFF_E = 0, OFF_R = TILE, OFF_W = 2 * TILE;
  static constexpr int OFF_RED = OFF_W + STAGES * STAGE;
  static constexpr int OFF_VEC = OFF_RED + RED;
  static constexpr int OFF_BAR = OFF_VEC + VEC;
  static constexpr int kBytes = OFF_BAR + (2 * STAGES + 4) * 8 + 1024;
  static_assert(STAGES >= 2 && kBytes <= kSmemMax, "the edge-backward kernel fits a block");
};

struct WgBwdArgs {
  const float* b2;       // (F)
  const float* mask;     // (rows)
  const float* dagg;     // (n, F) float32
  const void* ge;        // (rows, F) T (the kernel reads it by TMA, tm_ge)
  const float* scale;    // ln1_scale (F)
  float* partials;       // (tiles, slots, F) float32 sums of dfirst per receiver
  float* vparts;         // (grid * 4, 4, F): b1, b2, ln1_scale, ln1_bias per block and warp
  int64_t rows;
  int k, nf, tiles, slots;
};

template <int F>
__global__ void __launch_bounds__(GTHREADS, 1)
    fused_mp_bwd_edge_wgmma(const __grid_constant__ CUtensorMap tm_ge,
                            const __grid_constant__ CUtensorMap tm_r1,
                            const __grid_constant__ CUtensorMap tm_w2,
                            const __grid_constant__ CUtensorMap tm_w2t,
                            const __grid_constant__ CUtensorMap tm_wet,
                            const __grid_constant__ CUtensorMap tm_dx1,
                            const __grid_constant__ CUtensorMap tm_dhs,
                            const __grid_constant__ CUtensorMap tm_de, const WgBwdArgs a) {
  using L = GBSmem<F>;
  constexpr int N = F / 2;    // columns of a consumer warpgroup
  constexpr int NA = N / 2;   // its accumulators per thread
  constexpr int NJ = N / 8;   // its 8-column blocks (a multiple of 4)
  constexpr int P = F / 32;   // 32-column panels of a weight slab
  constexpr int CW = F / 4;   // columns of a warpgroup's dfirst chunk (two per warpgroup)
  constexpr int G = CW / 8;   // 8-column groups of a chunk
  constexpr int S = L::STAGES;
  extern __shared__ __align__(128) unsigned char gsmem[];
  unsigned char* smem = gsmem + ((1024 - (smem_addr(gsmem) & 1023)) & 1023);
  const u32 sb = smem_addr(smem);
  const u32 sE = sb + L::OFF_E, sR = sb + L::OFF_R, sW = sb + L::OFF_W;
  const u32 full0 = sb + L::OFF_BAR, empty0 = full0 + 8 * S, e_full = empty0 + 8 * S,
            e_empty = e_full + 8, r_full = e_full + 16, r_empty = e_full + 24;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2 * GCL);
    }
    mbar_init(e_full, 1);
    mbar_init(e_empty, 1);
    mbar_init(r_full, 1);
    mbar_init(r_empty, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const int rounds = (a.tiles + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid >= 256) {  // ---- producer warpgroup
    setmaxnreg_dec<40>();
    if (tid >= 256 + 32 && tid < 256 + 64) {
      // warp 9: each tile's T(relu(first)) into the R tile and ge into the
      // E tile by TMA (lane 0), once the consumers release them; the whole
      // warp waits
      const int cl = tid - 256 - 32;
      u32 eph = 0, rph = 0;
      for (int it = 0; it < rounds; ++it) {
        const int tile = it * (int)gridDim.x + (int)blockIdx.x;
        if (tile >= a.tiles) break;
        const int m0 = tile * GBM;
        mbar_wait(r_empty, rph ^ 1);
        if (cl == 0) {
          mbar_expect(r_full, L::TILE);
#pragma unroll 1
          for (int p = 0; p < F / 64; ++p) tma_load(sR + p * (GBM * 128), &tm_r1, 64 * p, m0, r_full);
        }
        __syncwarp();
        rph ^= 1;
        for (int load = 0; load < 2; ++load) {  // ge for LN1's backward, then for de
          mbar_wait(e_empty, eph ^ 1);
          if (cl == 0) {
            mbar_expect(e_full, L::TILE);
#pragma unroll 1
            for (int p = 0; p < F / 64; ++p)
              tma_load(sE + p * (GBM * 128), &tm_ge, 64 * p, m0, e_full);
          }
          __syncwarp();
          eph ^= 1;
        }
      }
    } else if (tid == 256) {  // the weight slabs: W2^T, then W_e^T, per tile
      const u32 rank = cluster_rank();
      int stage = 0;
      u32 ph = 0;
      for (int it = 0; it < rounds; ++it) {
        for (int w = 0; w < 3; ++w) {
          const CUtensorMap* tm = w == 0 ? &tm_w2 : w == 1 ? &tm_w2t : &tm_wet;
#pragma unroll 1
          for (int ks = 0; ks < F / GBK; ++ks) {
            mbar_wait(empty0 + 8 * stage, ph ^ 1);
            mbar_expect(full0 + 8 * stage, L::STAGE);
            const u32 dst = sW + stage * L::STAGE;
#pragma unroll 1
            for (int p = rank * (P / GCL); p < (int)(rank + 1) * (P / GCL); ++p)
              tma_load_mc(dst + p * (GBK * 64), tm, 32 * p, ks * GBK, full0 + 8 * stage,
                          (uint16_t)((1 << GCL) - 1));
            if (++stage == S) {
              stage = 0;
              ph ^= 1;
            }
          }
        }
      }
      // stay until the whole cluster has released every stage
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
  // this warp's running column sums of b2, ln1_scale, ln1_bias ([3][N], its
  // warpgroup's columns; b1 by the column threads), one lane owning each
  float* vec = reinterpret_cast<float*>(smem + L::OFF_VEC) + (wg * 4 + (tw >> 5)) * 3 * N;
  for (int i = lane; i < 3 * N; i += 32) vec[i] = 0.f;
  // the lane's column of each 4-block batch of the vector sums
  const int vcol = 2 * q4 + 8 * (lane >> 3) + ((lane >> 2) & 1);
  float b1sum[2] = {0.f, 0.f};
  int stage = 0;
  u32 ph = 0, eph = 0, rph = 0;

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
  // the sums of (qa, qb) over this thread's 4-lane row group, exchanged
  // with the other warpgroup through red[pass]: the row totals
  auto row_totals = [&](float qa, float qb, int pass) {
    qa += __shfl_xor_sync(lbt::kFullMask, qa, 1);
    qa += __shfl_xor_sync(lbt::kFullMask, qa, 2);
    qb += __shfl_xor_sync(lbt::kFullMask, qb, 1);
    qb += __shfl_xor_sync(lbt::kFullMask, qb, 2);
    if (q4 == 0) {
      red[pass * 2 * GBM + wg * GBM + rA] = qa;
      red[pass * 2 * GBM + wg * GBM + rA + 8] = qb;
    }
  };
  auto read_totals = [&](int pass, float& ta, float& tb) {
    ta = red[pass * 2 * GBM + rA] + red[pass * 2 * GBM + GBM + rA];
    tb = red[pass * 2 * GBM + rA + 8] + red[pass * 2 * GBM + GBM + rA + 8];
  };

#pragma unroll 1
  for (int it = 0; it < rounds; ++it) {
    const int tile = it * (int)gridDim.x + (int)blockIdx.x;
    if (tile >= a.tiles) {  // keep the cluster's slabs moving
      product(sE, false);
      product(sE, false);
      product(sE, false);
      continue;
    }
    const int64_t m0 = (int64_t)tile * GBM;
    const int64_t mA = m0 + rA, mB = mA + 8;
    const bool okA = mA < a.rows, okB = mB < a.rows;

    // ---- x1 = T(relu(first)) @ W2 + b2, K3's product on K3's operands (the
    // R tile by TMA): the same bits -> xhat (LN1's statistics as K3's)
    mbar_wait(r_full, rph);
    rph ^= 1;
    product(sR, true);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(a.b2 + c0 + 8 * j);
      acc[4 * j] += b.x;
      acc[4 * j + 1] += b.y;
      acc[4 * j + 2] += b.x;
      acc[4 * j + 3] += b.y;
    }
    float invA, invB;
    {
      float sA = 0.f, sB = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + 8 * j;
        if (c < a.nf) {
          sA += acc[4 * j];
          sB += acc[4 * j + 2];
        }
        if (c + 1 < a.nf) {
          sA += acc[4 * j + 1];
          sB += acc[4 * j + 3];
        }
      }
      float ta, tb;
      row_totals(sA, sB, 0);
      named_bar(1, 256);
      read_totals(0, ta, tb);
      const float meanA = ta / a.nf, meanB = tb / a.nf;
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
      row_totals(vA, vB, 1);
      named_bar(1, 256);
      read_totals(1, ta, tb);
      invA = rsqrtf(ta / a.nf + kEps);
      invB = rsqrtf(tb / a.nf + kEps);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool in = c0 + 8 * j + i < a.nf;
          acc[4 * j + i] = in ? (acc[4 * j + i] - meanA) * invA : 0.f;
          acc[4 * j + 2 + i] = in ? (acc[4 * j + 2 + i] - meanB) * invB : 0.f;
        }
      }
    }

    // ---- LN1's backward: dm = ge + dagg * mask, dx1 = inv (dm s - m1 - xhat m2)
    const float* dgA = okA ? a.dagg + (mA / a.k) * F : nullptr;
    const float* dgB = okB ? a.dagg + (mB / a.k) * F : nullptr;
    const float mkA = okA ? a.mask[mA] : 0.f, mkB = okB ? a.mask[mB] : 0.f;
    // dm of this thread's pair at column c (i = 0, 1) of rows A and B
    auto dm_at = [&](int c, float2& dA, float2& dB) {
      const float2 gA = unpack_bf2(lds32(sE + swz128(rA, c)));
      const float2 gB = unpack_bf2(lds32(sE + swz128(rA + 8, c)));
      const float2 aA = dgA != nullptr ? __ldg(reinterpret_cast<const float2*>(dgA + c))
                                       : make_float2(0.f, 0.f);
      const float2 aB = dgB != nullptr ? __ldg(reinterpret_cast<const float2*>(dgB + c))
                                       : make_float2(0.f, 0.f);
      dA = make_float2(gA.x + aA.x * mkA, gA.y + aA.y * mkA);
      dB = make_float2(gB.x + aB.x * mkB, gB.y + aB.y * mkB);
    };
    mbar_wait(e_full, eph);
    eph ^= 1;
    float m1A, m1B, m2A, m2B;
    {
      float s1A = 0.f, s1B = 0.f, s2A = 0.f, s2B = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += 4) {
        float vs[8], vb[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj, c = c0 + 8 * j;
          float2 dA, dB;
          dm_at(c, dA, dB);
          const float dmA[2] = {dA.x, dA.y}, dmB[2] = {dB.x, dB.y};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float xa = acc[4 * j + i], xb = acc[4 * j + 2 + i];
            if (c + i < a.nf) {
              const float sc = a.scale[c + i];
              const float ha = dmA[i] * sc, hb = dmB[i] * sc;
              s1A += ha;
              s1B += hb;
              s2A += ha * xa;
              s2B += hb * xb;
            }
            vs[2 * jj + i] = dmA[i] * xa + dmB[i] * xb;
            vb[2 * jj + i] = dmA[i] + dmB[i];
          }
        }
        const float ps = reduce_scatter4(vs, lane), pb = reduce_scatter4(vb, lane);
        vec[N + 8 * j0 + vcol] += ps;
        vec[2 * N + 8 * j0 + vcol] += pb;
      }
      named_bar(1, 256);  // both warpgroups have read the statistics' exchange
      float ta, tb;
      row_totals(s1A, s1B, 0);
      row_totals(s2A, s2B, 1);
      named_bar(1, 256);
      read_totals(0, ta, tb);
      m1A = ta / a.nf;
      m1B = tb / a.nf;
      read_totals(1, ta, tb);
      m2A = ta / a.nf;
      m2B = tb / a.nf;
    }
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += 4) {
      float vd[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + jj, c = c0 + 8 * j;
        float2 dA, dB;
        dm_at(c, dA, dB);
        const float dmA[2] = {dA.x, dA.y}, dmB[2] = {dB.x, dB.y};
        float xa[2], xb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool in = c + i < a.nf;
          const float sc = in ? a.scale[c + i] : 0.f;
          xa[i] = in ? invA * (dmA[i] * sc - m1A - acc[4 * j + i] * m2A) : 0.f;
          xb[i] = in ? invB * (dmB[i] * sc - m1B - acc[4 * j + 2 + i] * m2B) : 0.f;
          vd[2 * jj + i] = xa[i] + xb[i];
        }
        sts32(sE + swz128(rA, c), pack_bf2(xa[0], xa[1]));
        sts32(sE + swz128(rA + 8, c), pack_bf2(xb[0], xb[1]));
      }
      vec[8 * j0 + vcol] += reduce_scatter4(vd, lane);
    }
    fence_async_smem();
    named_bar(1, 256);
    if (tid == 0) {  // T(dx1), the operand of dW2
#pragma unroll 1
      for (int p = 0; p < F / 64; ++p) tma_store(&tm_dx1, sE + p * (GBM * 128), 64 * p, (int)m0);
      bulk_commit();
    }

    // ---- dfirst = T(dx1) @ W2^T where T(relu(first)) > 0
    product(sE, true);
#pragma unroll
    for (int j0 = 0; j0 < NJ; j0 += JB) {
      u32 rAv[JB], rBv[JB];
#pragma unroll
      for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
        const int c = c0 + 8 * (j0 + jj);
        rAv[jj] = lds32(sR + swz128(rA, c));
        rBv[jj] = lds32(sR + swz128(rA + 8, c));
      }
#pragma unroll
      for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
        const int j = j0 + jj, c = c0 + 8 * j;
        const float2 ra = unpack_bf2(rAv[jj]), rb = unpack_bf2(rBv[jj]);
        acc[4 * j] = ra.x > 0.f ? acc[4 * j] : 0.f;
        acc[4 * j + 1] = ra.y > 0.f ? acc[4 * j + 1] : 0.f;
        acc[4 * j + 2] = rb.x > 0.f ? acc[4 * j + 2] : 0.f;
        acc[4 * j + 3] = rb.y > 0.f ? acc[4 * j + 3] : 0.f;
        sts32(sR + swz128(rA, c), pack_bf2(acc[4 * j], acc[4 * j + 1]));
        sts32(sR + swz128(rA + 8, c), pack_bf2(acc[4 * j + 2], acc[4 * j + 3]));
      }
    }
    if (tid == 0) bulk_wait_read();  // the T(dx1) store has read the E tile
    fence_async_smem();
    named_bar(1, 256);
    if (tid == 0) {  // dhs = T(dfirst), the operand of dW_e
#pragma unroll 1
      for (int p = 0; p < F / 64; ++p) tma_store(&tm_dhs, sR + p * (GBM * 128), 64 * p, (int)m0);
      bulk_commit();
    }
    // dhr partials and b1: dfirst through the E tile, a chunk of CW columns
    // of this warpgroup at a time (rows rotated by 8-column groups), each
    // column summed down its rows in order, one partial per receiver
    {
      float* scr = reinterpret_cast<float*>(smem + L::OFF_E + wg * (L::TILE / 2));
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
        for (int jj = 0; jj < G; ++jj) {
          const int j = ch * G + jj;
          *reinterpret_cast<float2*>(scr + rA * CW + 8 * ((jj + rA) % G) + 2 * q4) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(scr + (rA + 8) * CW + 8 * ((jj + rA + 8) % G) + 2 * q4) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
        named_bar(2 + wg, 128);
        if (tw < CW) {
          const int col = wg * N + ch * CW + tw, grp = tw >> 3, within = tw & 7;
          float* out = a.partials + (int64_t)tile * a.slots * F + col;
          const int last = (int)((a.rows - m0 < GBM ? a.rows - m0 : GBM) - 1);
          int rem = (int)(m0 % a.k), slot = 0;
          float s = 0.f, t = 0.f;
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
                t += v[i];
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
          b1sum[ch] += t;
        }
        named_bar(2 + wg, 128);
      }
    }
    named_bar(1, 256);  // both warpgroups are past the E tile's scratch
    if (tid == 0) mbar_arrive(e_empty);  // ge again, into the E tile, during the product

    // ---- de = T(ge + T(dfirst) @ W_e^T)
    product(sR, true);
    named_bar(1, 256);  // both warpgroups are past the R tile
    if (tid == 0) {
      bulk_wait_read();  // the dhs store has read the R tile
      mbar_arrive(r_empty);
    }
    mbar_wait(e_full, eph);
    eph ^= 1;
    {
#pragma unroll
      for (int j0 = 0; j0 < NJ; j0 += JB) {
        u32 hA[JB], hB[JB];
#pragma unroll
        for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
          const int c = c0 + 8 * (j0 + jj);
          hA[jj] = lds32(sE + swz128(rA, c));
          hB[jj] = lds32(sE + swz128(rA + 8, c));
        }
#pragma unroll
        for (int jj = 0; jj < JB && j0 + jj < NJ; ++jj) {
          const int j = j0 + jj, c = c0 + 8 * j;
          const float2 ga = unpack_bf2(hA[jj]), gb = unpack_bf2(hB[jj]);
          sts32(sE + swz128(rA, c), pack_bf2(ga.x + acc[4 * j], ga.y + acc[4 * j + 1]));
          sts32(sE + swz128(rA + 8, c), pack_bf2(gb.x + acc[4 * j + 2], gb.y + acc[4 * j + 3]));
        }
      }
    }
    fence_async_smem();
    named_bar(1, 256);
    if (tid == 0) {
#pragma unroll 1
      for (int p = 0; p < F / 64; ++p) tma_store(&tm_de, sE + p * (GBM * 128), 64 * p, (int)m0);
      bulk_commit();
      bulk_wait_read();  // the E tile is free for the next tile's ge
      mbar_arrive(e_empty);
    }
  }

  // ---- this block's vector partials: rows blockIdx.x * 4 + warp of vparts
  {
    const int64_t w = (int64_t)blockIdx.x * 4 + (tw >> 5);
    __syncwarp();
    for (int i = lane; i < 3 * N; i += 32)
      a.vparts[(w * 4 + 1 + i / N) * F + wg * N + i % N] = vec[i];
    if (tw < CW) {
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        const int col = wg * N + ch * CW + tw;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a.vparts[(((int64_t)blockIdx.x * 4 + r) * 4) * F + col] = r == 0 ? b1sum[ch] : 0.f;
      }
    }
  }
  if (tid == 0) bulk_wait();  // the stores have landed
}

// ---- the edge weight gradients ------------------------------------------

constexpr int WT_BM = 128, WT_BN = 128;  // a block's output tile
constexpr int WT_BK = 64;              // edge rows per stage, and per chunk of the row ranges
constexpr int WT_STAGES = 4;

struct TnWgSmem {
  static constexpr int PANEL = WT_BK * 64;       // 64 rows x 32 columns, bf16
  static constexpr int A_BYTES = WT_BM / 32 * PANEL;
  static constexpr int STAGE = A_BYTES + WT_BN / 32 * PANEL;
  static constexpr int OFF_BAR = WT_STAGES * STAGE;
  static constexpr int kBytes = OFF_BAR + 2 * WT_STAGES * 8 + 1024;
  static_assert(kBytes <= kSmemMax, "the TN kernel fits a block");
};

struct WgTnArgs {
  float* out;     // (2, ranges, F, F): dW_e's range partials, then dW2's
  int64_t rows;
  int F, ranges, tiles_n;
};

// rows [lo, hi) of range z: whole 64-row chunks (ops/fused_mp.py wgmma_tn_rows)
__device__ __forceinline__ void tn_range(int64_t rows, int ranges, int z, int64_t& lo,
                                         int64_t& hi) {
  const int64_t chunks = (rows + WT_BK - 1) / WT_BK;
  lo = chunks * z / ranges * WT_BK;
  hi = min(chunks * (z + 1) / ranges * WT_BK, rows);
}

__global__ void __launch_bounds__(GTHREADS, 1)
    fused_mp_bwd_tn_wgmma(const __grid_constant__ CUtensorMap tm_a0,
                          const __grid_constant__ CUtensorMap tm_b0,
                          const __grid_constant__ CUtensorMap tm_a1,
                          const __grid_constant__ CUtensorMap tm_b1, const WgTnArgs g) {
  using L = TnWgSmem;
  extern __shared__ __align__(128) unsigned char gsmem[];
  unsigned char* smem = gsmem + ((1024 - (smem_addr(gsmem) & 1023)) & 1023);
  const u32 sb = smem_addr(smem);
  const u32 full0 = sb + L::OFF_BAR, empty0 = full0 + 8 * WT_STAGES;
  const int tid = threadIdx.x;
  const int grad = blockIdx.z, range = blockIdx.y;
  const int m0 = (blockIdx.x / g.tiles_n) * WT_BM, n0 = (blockIdx.x % g.tiles_n) * WT_BN;
  int64_t lo, hi;
  tn_range(g.rows, g.ranges, range, lo, hi);
  const int slabs = (int)((hi - lo + WT_BK - 1) / WT_BK);
  if (tid == 0) {
    for (int s = 0; s < WT_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= 256) {  // ---- producer: one thread keeps the stages loaded
    setmaxnreg_dec<40>();
    if (tid == 256) {
      const CUtensorMap* ta = grad == 0 ? &tm_a0 : &tm_a1;
      const CUtensorMap* tb = grad == 0 ? &tm_b0 : &tm_b1;
      int stage = 0;
      u32 ph = 0;
#pragma unroll 1
      for (int t = 0; t < slabs; ++t) {
        const int r0 = (int)(lo + (int64_t)t * WT_BK);
        mbar_wait(empty0 + 8 * stage, ph ^ 1);
        mbar_expect(full0 + 8 * stage, L::STAGE);
        const u32 dst = sb + stage * L::STAGE;
#pragma unroll 1
        for (int p = 0; p < WT_BM / 32; ++p)
          tma_load(dst + p * L::PANEL, ta, m0 + 32 * p, r0, full0 + 8 * stage);
#pragma unroll 1
        for (int p = 0; p < WT_BN / 32; ++p)
          tma_load(dst + L::A_BYTES + p * L::PANEL, tb, n0 + 32 * p, r0, full0 + 8 * stage);
        if (++stage == WT_STAGES) {
          stage = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  // ---- consumers: warpgroup wg owns output rows m0 + 64 wg .. + 63
  setmaxnreg_inc<232>();
  const int wg = tid >> 7, tw = tid & 127, lane = tid & 31, q4 = lane & 3;
  const int rA = 16 * (tw >> 5) + (lane >> 2);
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0;
  u32 ph = 0;
#pragma unroll 1
  for (int t = 0; t < slabs; ++t) {
    mbar_wait(full0 + 8 * stage, ph);
    const u32 sA = sb + stage * L::STAGE, sB = sA + L::A_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int qq = 0; qq < WT_BK / 16; ++qq) {
      const uint64_t da = gdesc(sA + 2 * wg * L::PANEL + qq * 1024, L::PANEL, 512, 2);
      const uint64_t db = gdesc(sB + qq * 1024, L::PANEL, 512, 2);
      wgmma_tn128(part, da, db, qq != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    if (tw == 0) mbar_arrive(empty0 + 8 * stage);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    if (++stage == WT_STAGES) {
      stage = 0;
      ph ^= 1;
    }
  }
  float* out = g.out + ((int64_t)grad * g.ranges + range) * g.F * g.F;
  const int mA = m0 + 64 * wg + rA, mB = mA + 8;
#pragma unroll
  for (int j = 0; j < WT_BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * q4;
    if (n < g.F) {
      if (mA < g.F)
        *reinterpret_cast<float2*>(out + (int64_t)mA * g.F + n) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (mB < g.F)
        *reinterpret_cast<float2*>(out + (int64_t)mB * g.F + n) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ---- host side ----------------------------------------------------------------

// the edge-backward kernel's persistent grid (as the forward's) and its
// vector partials' rows (4 per block)
inline int wgmma_bwd_vrows(int64_t rows) { return 4 * wgmma_grid(wgmma_tiles(rows)); }

template <int F>
int launch_bwd_edge_wgmma(const WgBwdArgs& a, const void* ge, const void* r1, const void* w2,
                          const void* w2t, const void* wet, void* dx1, void* dhs, void* de,
                          cudaStream_t stream) {
  CUtensorMap tg{}, tr{}, tw{}, t2{}, te{}, tx{}, th{}, td{};
  int err = 0;
  if ((err = tensor_map(&tw, w2, F, F, 32, GBK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if ((err = tensor_map(&tg, ge, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B))) return err;
  if ((err = tensor_map(&tr, r1, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B))) return err;
  if ((err = tensor_map(&t2, w2t, F, F, 32, GBK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if ((err = tensor_map(&te, wet, F, F, 32, GBK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if ((err = tensor_map(&tx, dx1, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B))) return err;
  if ((err = tensor_map(&th, dhs, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B))) return err;
  if ((err = tensor_map(&td, de, F, a.rows, 64, GBM, CU_TENSOR_MAP_SWIZZLE_128B))) return err;
  const int grid = wgmma_grid(a.tiles);
  if (grid < 1) return (int)cudaErrorInvalidValue;
  constexpr int smem = GBSmem<F>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(fused_mp_bwd_edge_wgmma<F>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  e = cudaLaunchKernelEx(&cfg, fused_mp_bwd_edge_wgmma<F>, tg, tr, tw, t2, te, tx, th, td, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dW_e = e^T dhs and dW2 = r1^T dx1 over `ranges` row ranges each
inline int launch_tn_wgmma(const void* e, const void* dhs, const void* r1, const void* dx1,
                           int64_t rows, int F, int ranges, float* out, cudaStream_t stream) {
  CUtensorMap ta0{}, tb0{}, ta1{}, tb1{};
  int err = 0;
  if ((err = tensor_map(&ta0, e, F, rows, 32, WT_BK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if ((err = tensor_map(&tb0, dhs, F, rows, 32, WT_BK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if ((err = tensor_map(&ta1, r1, F, rows, 32, WT_BK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  if ((err = tensor_map(&tb1, dx1, F, rows, 32, WT_BK, CU_TENSOR_MAP_SWIZZLE_64B))) return err;
  WgTnArgs g;
  g.out = out;
  g.rows = rows;
  g.F = F;
  g.ranges = ranges;
  g.tiles_n = (F + WT_BN - 1) / WT_BN;
  constexpr int smem = TnWgSmem::kBytes;
  cudaError_t e2 = cudaFuncSetAttribute(fused_mp_bwd_tn_wgmma,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e2 != cudaSuccess) return (int)e2;
  const dim3 grid((unsigned)(((F + WT_BM - 1) / WT_BM) * g.tiles_n), (unsigned)ranges, 2);
  fused_mp_bwd_tn_wgmma<<<grid, GTHREADS, smem, stream>>>(ta0, tb0, ta1, tb1, g);
  return (int)cudaGetLastError();
}

// K4 in bf16 at F in (256, 512]: the launches listed at the top; a.r_e is
// the TN kernel's ranges and a.p_e the edge kernel's vector rows (4 per
// block of its grid)
inline int wgmma_backward(WideBwd a, const void* w_et, const void* w2t, cudaStream_t stream) {
  const int F = a.F;
  const int64_t rows = (int64_t)a.n * a.k;
  if (a.p_n % WROW_WARPS || a.p_n < 1 || a.r_e < 1 || a.r_n < 1 ||
      a.p_e != wgmma_bwd_vrows(rows) || w_et == nullptr || w2t == nullptr)
    return (int)cudaErrorInvalidValue;
  int err;
  // the forward's edge kernel, storing r1: the same bits as K3
  WgEdgeArgs g{};
  g.e = a.e;
  g.hs = a.hs;
  g.hr = a.hr;
  g.mask = a.mask;
  g.x1_out = nullptr;
  g.partials = a.part;
  for (int i = 0; i < 4; ++i) g.vec[i] = a.vec[i];
  g.rows = rows;
  g.k = a.k;
  g.nf = a.nf;
  g.tiles = wgmma_tiles(rows);
  g.slots = wgmma_slots(a.k);
  g.store_r1 = 1;
  if ((err = edge_wgmma<bf16>(g, F, nullptr, a.w[0], a.w[1], a.r1, static_cast<bf16*>(a.aggc),
                              a.agg_out, a.n, stream)))
    return err;
  float *p_tn, *p_edge, *p_node;
  wide_partials(a.partials, F, a.r_e, a.r_n, a.p_e, &p_tn, &p_edge, &p_node);
  if ((err = wide_node_bwd<bf16>(a, p_node, stream))) return err;

  WgBwdArgs b;
  b.b2 = a.vec[1];
  b.mask = a.mask;
  b.dagg = a.dagg;
  b.ge = a.ge;
  b.scale = a.vec[2];
  b.partials = a.part;
  b.vparts = p_edge;
  b.rows = rows;
  b.k = a.k;
  b.nf = a.nf;
  b.tiles = g.tiles;
  b.slots = g.slots;
  switch (F) {
    case 320:
      err = launch_bwd_edge_wgmma<320>(b, a.ge, a.r1, a.w[1], w2t, w_et, a.dx1c, a.dhs, a.de, stream);
      break;
    case 384:
      err = launch_bwd_edge_wgmma<384>(b, a.ge, a.r1, a.w[1], w2t, w_et, a.dx1c, a.dhs, a.de, stream);
      break;
    case 448:
      err = launch_bwd_edge_wgmma<448>(b, a.ge, a.r1, a.w[1], w2t, w_et, a.dx1c, a.dhs, a.de, stream);
      break;
    case 512:
      err = launch_bwd_edge_wgmma<512>(b, a.ge, a.r1, a.w[1], w2t, w_et, a.dx1c, a.dhs, a.de, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int64_t pairs = (int64_t)a.n * (F / 2);
  fused_mp_wide_agg<bf16><<<(unsigned)imin((pairs + 255) / 256, 1 << 16), 256, 0, stream>>>(
      a.part, b.slots, a.k, a.n, F, static_cast<bf16*>(a.dhr), nullptr);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_tn_wgmma(a.e, a.dhs, a.r1, a.dx1c, rows, F, a.r_e, p_tn, stream))) return err;
  return wide_node_tn<bf16>(a, p_tn + 2 * (int64_t)a.r_e * F * F, stream);
}

}  // namespace
