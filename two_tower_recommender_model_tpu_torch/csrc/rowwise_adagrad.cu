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
//   - table: [N, D] f32, acc: [N] f32, updated in place;
//   - grads: [M, D] f32 or bf16 (bf16 values are widened exactly and summed
//     in f32); perm: [M] int32 or null. The device-sort front-end
//     (train/optimizer.py: device_sorted_fused_adagrad) passes its stable
//     sort's permutation here, so the kernel reads grads[perm[j]] in place
//     and no permuted [M, D] copy is ever written;
//   - D % 4 == 0 and D <= 512; table and f32 grads 16-byte aligned, bf16
//     grads 8-byte aligned (the wrapper checks all of it).
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

template <typename G>
__global__ void __launch_bounds__(kThreads)
rowwise_adagrad_kernel(float* __restrict__ table, float* __restrict__ acc,
                       const int32_t* __restrict__ ids, const G* __restrict__ grads,
                       const int32_t* __restrict__ perm, int64_t n_rows, int64_t d, int64_t m,
                       float lr, float eps) {
  float g[kMaxChunks][4];
  const int32_t r = sum_owned_run(ids, grads, perm, n_rows, d, m, g);
  if (r < 0) return;
  const float sq = warp_sum_squares(g, d);

  const float new_acc = acc[r] + sq / static_cast<float>(d);
  const float denom = sqrtf(new_acc) + eps;
  float* trow = table + static_cast<int64_t>(r) * d;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int64_t col = lane_col(c);
    if (col < d) {
      float4 t = *reinterpret_cast<float4*>(trow + col);
      t.x = t.x - lr * g[c][0] / denom;
      t.y = t.y - lr * g[c][1] / denom;
      t.z = t.z - lr * g[c][2] / denom;
      t.w = t.w - lr * g[c][3] / denom;
      *reinterpret_cast<float4*>(trow + col) = t;
    }
  }
  if ((threadIdx.x & 31) == 0) acc[r] = new_acc;
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
int ttrm_rowwise_adagrad(void* table, void* acc, const void* ids, const void* grads,
                         int grad_dtype, const void* perm, int64_t n_rows, int64_t d, int64_t m,
                         float lr, float eps, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (!launch_shape(d, m, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<float*>(table);
  auto* a = static_cast<float*>(acc);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* p = static_cast<const int32_t*>(perm);
  if (grad_dtype == kF32) {
    rowwise_adagrad_kernel<float><<<grid, kThreads, 0, s>>>(
        t, a, i, static_cast<const float*>(grads), p, n_rows, d, m, lr, eps);
  } else if (grad_dtype == kBF16) {
    rowwise_adagrad_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        t, a, i, static_cast<const uint16_t*>(grads), p, n_rows, d, m, lr, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
