// Runs of equal sorted ids, one warp each: the device code shared by the
// kernels of rowwise_adagrad.cu that aggregate per-slot gradients by table
// row (the fused f32 row-wise Adagrad and the dense aggregate).
// (quantized_adagrad.cu walks its runs its own way: a warp per 32 positions.)
//
// Contract of the ids: [M] int32, NON-DECREASING; ids outside [0, N) are
// sentinels (dead slots), never read and never written. Unsorted ids would
// give two warps the same row, and they would race.
//
// The design: warp j looks at position j. If that position starts a run
// (j == 0 or ids[j] != ids[j-1]) the warp owns the run's row; every other
// warp exits at once. The owner sums the run in sorted order, each lane
// holding four columns of the row per 128-column chunk in registers (16-byte
// loads of f32, 8-byte loads of bf16: a whole D = 128 row per warp load), so
// there are no atomics and the sum is deterministic. A very long run (a hot
// id under skew) is serial on its one warp.
//
// D % 4 == 0 and D <= 512 (kMaxChunks chunks of 128 columns); f32 gradients
// 16-byte aligned, bf16 gradients 8-byte aligned.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sorted_runs {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxChunks = 4;  // 128 columns per chunk: D <= 512
constexpr unsigned kFullWarp = 0xffffffffu;

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// four consecutive gradient elements, widened to f32
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&v)[4]) {
  // bf16 travels as its raw 16 bits: widening is a 16-bit shift, exact
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}

// The first column of this lane's four in chunk c.
__device__ __forceinline__ int64_t lane_col(int c) {
  return static_cast<int64_t>(c * 32 + (threadIdx.x & 31)) * 4;
}

// If this warp's position starts a run of a live id, sum the run's gradient
// rows into g (this lane's columns; src(k) = perm[k] when a permutation is
// given, else k) and return the row id. Else return -1. The result is
// uniform across the warp.
template <typename G>
__device__ __forceinline__ int32_t sum_owned_run(const int32_t* __restrict__ ids,
                                                 const G* __restrict__ grads,
                                                 const int32_t* __restrict__ perm,
                                                 int64_t n_rows, int64_t d, int64_t m,
                                                 float (&g)[kMaxChunks][4]) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= m) return -1;
  const int32_t r = __ldg(ids + j);
  if (r < 0 || r >= n_rows) return -1;            // sentinel: dead slot
  if (j > 0 && __ldg(ids + j - 1) == r) return -1;  // not the first of its run

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) g[c][i] = 0.f;

  // the run, in sorted order
  for (int64_t k = j; k < m && __ldg(ids + k) == r; ++k) {
    const int64_t src = perm != nullptr ? static_cast<int64_t>(__ldg(perm + k)) : k;
    const G* row = grads + src * d;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      const int64_t col = lane_col(c);
      if (col < d) {
        float v[4];
        load4(row + col, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) g[c][i] += v[i];
      }
    }
  }
  return r;
}

// The sum over the warp of each lane's sum of squares of g.
__device__ __forceinline__ float warp_sum_squares(const float (&g)[kMaxChunks][4], int64_t d) {
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (lane_col(c) < d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sq += g[c][i] * g[c][i];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFullWarp, sq, off);
  return sq;
}

// The launch shape of one warp per position, or false when M or D is outside
// what the kernels take.
inline bool launch_shape(int64_t d, int64_t m, dim3* grid) {
  if (d <= 0 || d % 4 != 0 || d > kMaxChunks * 128) return false;
  if (m > static_cast<int64_t>(0x7fffffff) * kWarpsPerBlock) return false;
  *grid = dim3(static_cast<unsigned>((m + kWarpsPerBlock - 1) / kWarpsPerBlock));
  return true;
}

}  // namespace sorted_runs
