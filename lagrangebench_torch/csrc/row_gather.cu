// E1: the row gather out[r, k] = sum_{j < reps} h[idx[r, k]] (reps = 1: the
// gather h[idx] itself).
//
// Replaces the seven Pallas probes of scripts/experiments/gather_variants.py:
// gather_kernel_take (:69), gather_kernel_cols (:107), kernel_taa (:159),
// gather_k_kernel (:229), the transposed-index gather_kernel (:291), kern
// (:353) and the accumulating kern_loop (:375). They compute one function in
// the TPU's tilings (whole rows, one index column per step, a grid over K,
// 8 columns of a (K, R) index per step); this kernel computes that function
// and does not copy the tilings. Instances: bf16 and float32, an (R, K) or a
// transposed (K, R) index (an (R,) index is (R, 1)).
//
// Bound on an H100: bytes. The (R, K, F) output is written once, the index
// read once, and the table read at least once; the table is L2-resident
// (2 MB at 8192 x 128 bf16), so repeated rows come from the 50 MB L2. At the
// probe's shape (R = 8192, K = 24, F = 128, bf16) that is ~53 MB, ~16 us at
// 3.35 TB/s.
//
// Design, simple first: a warp per output row, or several rows per warp
// where a row is fewer than 32 vectors of 16 bytes (bf16 at F = 128: two
// rows of 16 lanes), each lane moving 16-byte vectors, neighbouring lanes on
// neighbouring addresses, so both the row read and the output write are
// coalesced. Output rows go in (r, k) order whatever the index layout. With
// reps > 1 each lane sums its elements in float32 in j order (the plain
// loop's order, so the sums agree to the bit) and rounds once; its loads
// are volatile, so each repetition reads the row again as the probe's loop
// gathers it again. Indices are not checked: the wrapper's callers keep
// them in [0, N).
#include <cuda_bf16.h>

#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// A 16-byte load the compiler may not merge with another of the same row.
__device__ __forceinline__ uint4 load_again(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void add(float (&acc)[kN], const uint4& v) {
    acc[0] += __uint_as_float(v.x);
    acc[1] += __uint_as_float(v.y);
    acc[2] += __uint_as_float(v.z);
    acc[3] += __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&acc)[kN]) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]),
                      __float_as_uint(acc[2]), __float_as_uint(acc[3]));
  }
};

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  __device__ static float lo(unsigned w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffffu)));
  }
  __device__ static float hi(unsigned w) {
    return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
  }
  __device__ static unsigned two(float a, float b) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  __device__ static void add(float (&acc)[kN], const uint4& v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] += lo(w[i]);
      acc[2 * i + 1] += hi(w[i]);
    }
  }
  __device__ static uint4 pack(const float (&acc)[kN]) {
    return make_uint4(two(acc[0], acc[1]), two(acc[2], acc[3]), two(acc[4], acc[5]),
                      two(acc[6], acc[7]));
  }
};

template <typename T, bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS) row_gather(const uint4* __restrict__ h,
                                                      const int32_t* __restrict__ idx,
                                                      uint4* __restrict__ out, int64_t r,
                                                      int k, int vpr, int lpr, int reps) {
  const int64_t rows = r * k;
  const int lane = threadIdx.x % 32;
  const int rpw = 32 / lpr;  // output rows per warp
  const int l = lane % lpr;
  const int64_t first = ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32) * rpw + lane / lpr;
  const int64_t stride = (int64_t)gridDim.x * WARPS * rpw;
  for (int64_t o = first; o < rows; o += stride) {
    int64_t src;
    if constexpr (TRANSPOSED) src = idx[(o % k) * r + o / k];
    else src = idx[o];
    const uint4* in = h + src * vpr;
    uint4* dst = out + o * vpr;
    if (reps == 1) {
      for (int v = l; v < vpr; v += lpr) dst[v] = in[v];
      continue;
    }
    for (int v = l; v < vpr; v += lpr) {
      float acc[Vec<T>::kN] = {};
      for (int j = 0; j < reps; ++j) Vec<T>::add(acc, load_again(in + v));
      dst[v] = Vec<T>::pack(acc);
    }
  }
}

template <typename T, bool TRANSPOSED>
int launch(const void* h, const int32_t* idx, void* out, int64_t r, int k, int f, int reps,
           cudaStream_t stream) {
  const int vpr = f * (int)sizeof(T) / 16;
  const int lpr = (vpr < 32 && 32 % vpr == 0) ? vpr : 32;
  const int64_t warps = (r * k + 32 / lpr - 1) / (32 / lpr);
  const int blocks = (int)std::min<int64_t>((warps + WARPS - 1) / WARPS, 1 << 20);
  row_gather<T, TRANSPOSED><<<blocks, THREADS, 0, stream>>>(
      static_cast<const uint4*>(h), idx, static_cast<uint4*>(out), r, k, vpr, lpr, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// h (n, f) bf16 or float32 with f * element size a multiple of 16 bytes;
// idx (r, k) int32, or (k, r) with transposed; out (r, k, f) in h's type.
LBT_EXPORT int lbt_row_gather(const void* h, const int32_t* idx, void* out, int64_t n,
                              int64_t r, int k, int f, int transposed, int reps, int is_bf16,
                              cudaStream_t stream) {
  const int es = is_bf16 ? 2 : 4;
  if (n < 1 || r < 1 || k < 1 || f < 1 || reps < 1 || (f * es) % 16)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return transposed ? launch<bf16, true>(h, idx, out, r, k, f, reps, stream)
                      : launch<bf16, false>(h, idx, out, r, k, f, reps, stream);
  return transposed ? launch<float, true>(h, idx, out, r, k, f, reps, stream)
                    : launch<float, false>(h, idx, out, r, k, f, reps, stream);
}
