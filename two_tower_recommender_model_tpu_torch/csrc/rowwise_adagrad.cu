// Two kernels over runs of equal sorted ids, for Hopper (sm_90a).
//
// 1. Fused row-wise Adagrad (ttrm_rowwise_adagrad):
//
//   for each distinct live id r in ids (ids[j] < N):
//     g_r       = sum of grads[src(j)] over j with ids[j] == r   (f32)
//     acc[r]   += mean(g_r * g_r)
//     table[r] -= lr * g_r / (sqrt(acc[r]) + eps)
//
// in place; src(j) = perm[j] when a permutation is given, else j.
//
// Replaces the Pallas TPU kernel `_fused_update_kernel` /
// `block_sorted_rowwise_adagrad_fused` in
// two_tower_recommender_model_tpu/ops/block_sorted.py (kernel #4), whose
// one-hot MXU contraction, bf16x3 split and block work plan were means for
// the TPU's matrix unit and are not carried over.
//
// Contract:
//   - ids: [M] int32, NON-DECREASING. Ids outside [0, N) are sentinels (dead
//     slots): never read, never written. Unsorted ids would give two warps
//     the same row, and they would race: only the host-sorted table may
//     skip the sort (train/step.py sorts every other table first);
//   - table: [N, D] f32 or bf16, acc: [N] f32, updated in place. A bf16 row
//     is widened exactly, updated with the same f32 math and rounded to
//     nearest even once on the store (`new_rows.astype(table.dtype)` in the
//     reference's plain updates, the only route a bf16 table takes there);
//     the accumulator stays f32;
//   - grads: [M, D] f32 or bf16 (bf16 values are widened exactly and summed
//     in f32); perm: [M] int32 or null. The device-sort front-end
//     (train/optimizer.py: device_sorted_fused_adagrad) passes its stable
//     sort's permutation here, so the kernel reads grads[perm[j]] in place
//     and no permuted [M, D] copy is ever written;
//   - D % 4 == 0 and D <= 512; an f32 table and f32 grads 16-byte aligned, a
//     bf16 table and bf16 grads 8-byte aligned (the wrapper checks all of it).
//   Rows that no live id names keep their exact bits.
//
// What bounds it: memory. Each id reads its D-wide gradient row (512 B f32,
// 256 B bf16 at D = 128) and each distinct row reads and writes its table row
// and accumulator once, against a few FLOPs per element. The design:
//   - one warp per run of equal sorted ids. The warp whose position starts a
//     run (j == 0 or ids[j] != ids[j-1]) owns that row; every other warp
//     exits at once. It sums the run in sorted order, each lane holding four
//     columns of the row per 128-column chunk in registers (16-byte loads of
//     f32, 8-byte loads of bf16: a whole D = 128 row per warp load), reduces
//     g^2 across the warp with shuffles, and writes the row and its
//     accumulator once;
//   - no atomics, so the result is deterministic, and nothing is allocated:
//     the update is in place, which the Pallas version needed
//     input_output_aliases to get.
//   A very long run (a hot id under skew) is serial on its one warp; at the
//   flagship's uniform ids runs are short. Splitting long runs is later work.
//
// 2. The dense aggregate (ttrm_sorted_aggregate):
//
//   out[r] = sum of grads[j] over j with ids[j] == r        (f32), [N, D]
//
// Replaces the Pallas TPU kernel `_aggregate_kernel` / `block_sorted_aggregate`
// of the same file (kernel #3). It shares the run detection and the sum with
// the kernel above (sorted_runs.cuh) and writes each run's sum to its row,
// once. Rows that no live id names are not written: the wrapper hands in a
// zeroed `out`, so they stay exact zeros. What bounds it: memory, the N x D
// f32 output above all (106 MB at the flagship's user table against 67 MB of
// bf16 gradients).
//
// Binding: a plain C interface loaded with ctypes. The launch goes to the
// caller's stream, does not synchronise, and the entry point returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// four consecutive table elements: an f32 row moves as one 16-byte word a
// lane, a bf16 row (raw 16 bits) as one 8-byte word, widened exactly on the
// load and rounded to nearest even on the store. Plain loads, not the
// read-only path: the kernel writes the table.
__device__ __forceinline__ void load_row4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load_row4(const uint16_t* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(r.x << 16);
  v[1] = __uint_as_float(r.x & 0xffff0000u);
  v[2] = __uint_as_float(r.y << 16);
  v[3] = __uint_as_float(r.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}
__device__ __forceinline__ void store4(uint16_t* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads)
rowwise_adagrad_kernel(T* __restrict__ table, float* __restrict__ acc,
                       const int32_t* __restrict__ ids, const G* __restrict__ grads,
                       const int32_t* __restrict__ perm, int64_t n_rows, int64_t d, int64_t m,
                       float lr, float eps) {
  float g[kMaxChunks][4];
  const int32_t r = sum_owned_run(ids, grads, perm, n_rows, d, m, g);
  if (r < 0) return;
  const float sq = warp_sum_squares(g, d);

  const float new_acc = acc[r] + sq / static_cast<float>(d);
  const float denom = sqrtf(new_acc) + eps;
  T* trow = table + static_cast<int64_t>(r) * d;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int64_t col = lane_col(c);
    if (col < d) {
      float t[4];
      load_row4(trow + col, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = t[i] - lr * g[c][i] / denom;
      store4(trow + col, t);
    }
  }
  if ((threadIdx.x & 31) == 0) acc[r] = new_acc;
}

template <typename T>
int launch_adagrad(dim3 grid, cudaStream_t s, void* table, float* acc, const int32_t* ids,
                   const void* grads, int grad_dtype, const int32_t* perm, int64_t n_rows,
                   int64_t d, int64_t m, float lr, float eps) {
  auto* t = static_cast<T*>(table);
  if (grad_dtype == kF32) {
    rowwise_adagrad_kernel<T, float><<<grid, kThreads, 0, s>>>(
        t, acc, ids, static_cast<const float*>(grads), perm, n_rows, d, m, lr, eps);
  } else if (grad_dtype == kBF16) {
    rowwise_adagrad_kernel<T, uint16_t><<<grid, kThreads, 0, s>>>(
        t, acc, ids, static_cast<const uint16_t*>(grads), perm, n_rows, d, m, lr, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
sorted_aggregate_kernel(float* __restrict__ out, const int32_t* __restrict__ ids,
                        const G* __restrict__ grads, int64_t n_rows, int64_t d, int64_t m) {
  float g[kMaxChunks][4];
  const int32_t r = sum_owned_run(ids, grads, static_cast<const int32_t*>(nullptr), n_rows, d, m,
                                  g);
  if (r < 0) return;
  float* orow = out + static_cast<int64_t>(r) * d;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int64_t col = lane_col(c);
    if (col < d)
      *reinterpret_cast<float4*>(orow + col) = make_float4(g[c][0], g[c][1], g[c][2], g[c][3]);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch.
int ttrm_rowwise_adagrad(void* table, int table_dtype, void* acc, const void* ids,
                         const void* grads, int grad_dtype, const void* perm, int64_t n_rows,
                         int64_t d, int64_t m, float lr, float eps, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (!launch_shape(d, m, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<float*>(acc);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* p = static_cast<const int32_t*>(perm);
  if (table_dtype == kF32)
    return launch_adagrad<float>(grid, s, table, a, i, grads, grad_dtype, p, n_rows, d, m, lr,
                                 eps);
  if (table_dtype == kBF16)
    return launch_adagrad<uint16_t>(grid, s, table, a, i, grads, grad_dtype, p, n_rows, d, m, lr,
                                    eps);
  return static_cast<int>(cudaErrorInvalidValue);
}

// `out` [N, D] f32 must arrive zeroed. Returns a cudaError_t code.
int ttrm_sorted_aggregate(void* out, const void* ids, const void* grads, int grad_dtype,
                          int64_t n_rows, int64_t d, int64_t m, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (!launch_shape(d, m, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  const auto* i = static_cast<const int32_t*>(ids);
  if (grad_dtype == kF32) {
    sorted_aggregate_kernel<float><<<grid, kThreads, 0, s>>>(
        o, i, static_cast<const float*>(grads), n_rows, d, m);
  } else if (grad_dtype == kBF16) {
    sorted_aggregate_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        o, i, static_cast<const uint16_t*>(grads), n_rows, d, m);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
