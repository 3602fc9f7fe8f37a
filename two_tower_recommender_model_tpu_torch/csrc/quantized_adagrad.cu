// Fused row-wise Adagrad on int8 rows over sorted ids, for Hopper (sm_90a):
//
//   for each distinct live id r in ids whose summed gradient g_r is not all 0:
//     g_r        = sum of grads[src(j)] over j with ids[j] == r      (f32)
//     row        = float(values[r]) * (scales[r] / 127)
//     acc[r]    += mean(g_r * g_r)
//     row       -= lr * g_r / (sqrt(acc[r]) + eps)
//     scales[r]  = max |row|
//     values[r]  = clip(round(row / (scales[r] > 0 ? scales[r] : 1) * 127), -127, 127)
//
// in place on values, scales and acc; src(j) = perm[j] when a permutation is
// given, else j.
//
// Replaces the Pallas TPU kernel `_fused_update_kernel_quantized` /
// `block_sorted_rowwise_adagrad_fused_quantized` in
// two_tower_recommender_model_tpu/ops/block_sorted.py (kernel #6), whose
// one-hot MXU aggregation, block work plan and lane/sublane transposes were
// means for the TPU and are not carried over.
//
// Contract:
//   - ids, grads, perm: as in sorted_runs.cuh (ids [M] int32 NON-DECREASING,
//     ids outside [0, N) dead; grads [*, D] f32 or bf16 summed in f32);
//   - values: [N, D] int8, scales: [N] f32 (the row's absmax), acc: [N] f32;
//   - D % 4 == 0 and D <= 512; values 4-byte aligned (the wrapper checks);
//   - a row that no live id names, or whose summed gradient is exactly zero
//     in every column, keeps its exact bytes, scale and accumulator:
//     requantizing is not idempotent, so such a row is not written at all;
//   - the rounding: the division by 127 (and by the new scale) is a true
//     division and the product a separate multiply, as the plain version
//     computes them; round-half-to-even (rintf), then the clamp.
//
// What bounds it: memory, almost all of it the gradients (256 B a bf16 id at
// D = 128 against 128 B read and 128 B written a touched row, plus its scale
// and accumulator). The design is the f32 kernel's (sorted_runs.cuh: one
// warp per run, the run summed in registers, no atomics). The epilogue keeps
// the new row in the same registers: a warp reduction of g^2, one of
// max|row| (shuffles), then each lane packs its four int8 of a 128-column
// chunk into one 4-byte store, so a D = 128 row is one 128-byte warp store.
//
// Binding: a plain C interface loaded with ctypes. The launch goes to the
// caller's stream, does not synchronise, allocates nothing, and the entry
// point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// byte i of a little-endian word, as a signed int8 widened to f32
__device__ __forceinline__ float int8_at(uint32_t word, int i) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}

__device__ __forceinline__ uint32_t quantize(float x, float denom) {
  const float q = rintf(__fmul_rn(__fdiv_rn(x, denom), 127.f));
  const int v = static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
  return static_cast<uint32_t>(v) & 0xffu;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
quantized_adagrad_kernel(int8_t* __restrict__ values, float* __restrict__ scales,
                         float* __restrict__ acc, const int32_t* __restrict__ ids,
                         const G* __restrict__ grads, const int32_t* __restrict__ perm,
                         int64_t n_rows, int64_t d, int64_t m, float lr, float eps) {
  float g[kMaxChunks][4];
  const int32_t r = sum_owned_run(ids, grads, perm, n_rows, d, m, g);
  if (r < 0) return;  // uniform across the warp

  bool nonzero = false;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    if (lane_col(c) < d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) nonzero = nonzero || g[c][i] != 0.f;
    }
  }
  if (!__any_sync(kFullWarp, nonzero)) return;  // an all-zero sum: the row keeps its bytes
  const float sq = warp_sum_squares(g, d);

  const float new_acc = acc[r] + sq / static_cast<float>(d);
  const float denom = sqrtf(new_acc) + eps;
  const float mult = __fdiv_rn(scales[r], 127.f);
  uint32_t* vrow = reinterpret_cast<uint32_t*>(values + static_cast<int64_t>(r) * d);

  // the new row, in g's registers
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int64_t col = lane_col(c);
    if (col < d) {
      const uint32_t word = vrow[col / 4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float row = __fmul_rn(int8_at(word, i), mult);
        const float step = __fdiv_rn(__fmul_rn(lr, g[c][i]), denom);
        g[c][i] = __fsub_rn(row, step);
        amax = fmaxf(amax, fabsf(g[c][i]));
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFullWarp, amax, off));
  const float qdenom = amax > 0.f ? amax : 1.f;

#pragma unroll
  for (int c = 0; c < kMaxChunks; ++c) {
    const int64_t col = lane_col(c);
    if (col < d) {
      vrow[col / 4] = quantize(g[c][0], qdenom) | (quantize(g[c][1], qdenom) << 8) |
                      (quantize(g[c][2], qdenom) << 16) | (quantize(g[c][3], qdenom) << 24);
    }
  }
  if ((threadIdx.x & 31) == 0) {
    scales[r] = amax;
    acc[r] = new_acc;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch.
int ttrm_quantized_adagrad(void* values, void* scales, void* acc, const void* ids,
                           const void* grads, int grad_dtype, const void* perm, int64_t n_rows,
                           int64_t d, int64_t m, float lr, float eps, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (!launch_shape(d, m, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* v = static_cast<int8_t*>(values);
  auto* sc = static_cast<float*>(scales);
  auto* a = static_cast<float*>(acc);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* p = static_cast<const int32_t*>(perm);
  if (grad_dtype == kF32) {
    quantized_adagrad_kernel<float><<<grid, kThreads, 0, s>>>(
        v, sc, a, i, static_cast<const float*>(grads), p, n_rows, d, m, lr, eps);
  } else if (grad_dtype == kBF16) {
    quantized_adagrad_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        v, sc, a, i, static_cast<const uint16_t*>(grads), p, n_rows, d, m, lr, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
