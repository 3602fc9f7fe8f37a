// Two kernels over runs of equal sorted ids, for Hopper (sm_90a), both on
// the span walk of sorted_runs.cuh (the run detection, the sums, hot ids).
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
//   - ids: [M] int32, NON-DECREASING, M < 2^31. Ids outside [0, N) are
//     sentinels (dead slots): never read, never written. Unsorted ids would
//     give two owners the same row, and they would race: only the
//     host-sorted table may skip the sort (train/step.py sorts every other
//     table first);
//   - table: [N, D] f32 or bf16, acc: [N] f32, updated in place. A bf16 row
//     is widened exactly, updated with the same f32 math and rounded to
//     nearest even once on the store (`new_rows.astype(table.dtype)` in the
//     reference's plain updates, the only route a bf16 table takes there);
//     the accumulator stays f32;
//   - grads: [*, D] f32 or bf16 (bf16 values are widened exactly and summed
//     in f32); perm: [M] int32 or null. The device-sort front-end
//     (train/optimizer.py: device_sorted_fused_adagrad) passes its stable
//     sort's permutation here, so the kernel reads grads[perm[j]] in place
//     and no permuted [M, D] copy is ever written;
//   - D % 4 == 0 and D <= 512; an f32 table and f32 grads 16-byte aligned, a
//     bf16 table and bf16 grads 8-byte aligned (the wrapper checks all of it);
//   - part [2 * ceil(M / 32), D] f32 and part_id [2 * ceil(M / 32)] int32:
//     the span walk's scratch, allocated by the wrapper on the caller's
//     stream (so a CUDA graph captures it).
//   Rows that no live id names keep their exact bits.
//
// What bounds it: memory. Each id reads its D-wide gradient row (512 B f32,
// 256 B bf16 at D = 128) and each distinct row reads and writes its table row
// and accumulator once, against a few FLOPs per element: 0.065 ms at the
// flagship's 262,144 bf16 ids into the f32 user table, at 3.35 TB/s. So the
// design keeps many independent rows in flight and no run on one warp:
//   - a warp per span of 32 sorted positions, a half-warp per complete run
//     (16-byte loads, two runs in step), the table row and accumulator
//     loaded with the run's first gradient rows (sorted_runs.cuh);
//   - a run longer than a warp's 64-position window (a hot id under skew:
//     21,842 of 262,144 positions on rank^-1 item ids) is summed in
//     32-position pieces by the warps of those spans, and a second pass adds
//     the pieces in order and updates the row;
//   - the update in this epilogue: sum(g^2) in the order of the one-warp walk
//     these kernels had before (half_sum_squares), then the row, each value
//     `t - lr * g / denom` (an IEEE division), written once with its
//     accumulator. A run that fits the window keeps that walk's bits;
//   - no atomics, so two launches agree bit for bit, and the update is in
//     place, which the Pallas version needed input_output_aliases to get.
//
// 2. The dense aggregate (ttrm_sorted_aggregate):
//
//   out[r] = sum of grads[j] over j with ids[j] == r        (f32), [N, D]
//
// Replaces the Pallas TPU kernel `_aggregate_kernel` / `block_sorted_aggregate`
// of the same file (kernel #3). The same walk, with an epilogue that writes
// each run's sum to its row, once. Rows that no live id names are not
// written: the wrapper hands in a zeroed `out`, so they stay exact zeros.
// What bounds it: memory, the N x D f32 output above all (106 MB at the
// flagship's user table against 67 MB of bf16 gradients).
//
// Binding: a plain C interface loaded with ctypes. The launches go to the
// caller's stream, do not synchronise, and the entry point returns
// cudaGetLastError() right after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// V consecutive table elements of one lane: f32 as 16-byte words, bf16 (raw
// 16 bits) as one 8- or 16-byte word, widened exactly on the read and
// rounded to nearest even on the store. Plain loads, not the read-only path:
// the kernel writes the table.
template <typename T, int V>
struct Chunk;
template <int V>
struct Chunk<float, V> {
  float x[V];
  __device__ __forceinline__ void load(const float* p) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      x[k] = v.x;
      x[k + 1] = v.y;
      x[k + 2] = v.z;
      x[k + 3] = v.w;
    }
  }
  __device__ __forceinline__ float at(int i) const { return x[i]; }
  static __device__ __forceinline__ void store(float* p, const float (&y)[V]) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(y[k], y[k + 1], y[k + 2], y[k + 3]);
  }
};
template <int V>
struct Chunk<uint16_t, V> {
  uint32_t w[V / 2];
  __device__ __forceinline__ void load(const uint16_t* p) {
    if constexpr (V == 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    }
  }
  __device__ __forceinline__ float at(int i) const {
    return i & 1 ? hi16(w[i / 2]) : lo16(w[i / 2]);
  }
  static __device__ __forceinline__ void store(uint16_t* p, const float (&y)[V]) {
    if constexpr (V == 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(y[0], y[1]), bf16_pair(y[2], y[3]),
                                                bf16_pair(y[4], y[5]), bf16_pair(y[6], y[7]));
    else
      *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(y[0], y[1]), bf16_pair(y[2], y[3]));
  }
};

// Kernel #4's epilogue: the row-wise Adagrad update of row r, in place.
template <typename T>
struct AdagradUpdate {
  T* table;
  float* acc;
  float lr, eps;

  template <int V, int NC>
  struct Row {
    Chunk<T, V> t[NC];
    float acc;
  };

  template <int V, int NC>
  __device__ __forceinline__ Row<V, NC> load(int32_t r, int hl, int64_t d) const {
    Row<V, NC> row{};
    if (r < 0) return row;  // a half-warp without a row
    const T* trow = table + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < d) row.t[c].load(trow + col_of<V>(c, hl));
    row.acc = acc[r];
    return row;
  }

  template <int V, int NC>
  __device__ __forceinline__ void apply(int32_t r, float (&g)[NC][V], const Row<V, NC>& row,
                                        int64_t d) const {
    const int hl = threadIdx.x & 15;
    const float sq = half_sum_squares<V, NC>(g, d, hl);  // every lane: it shuffles
    if (r < 0) return;
    const float new_acc = row.acc + sq / static_cast<float>(d);
    const float denom = sqrtf(new_acc) + eps;
    T* trow = table + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < d) {
        float y[V];
#pragma unroll
        for (int i = 0; i < V; ++i) y[i] = row.t[c].at(i) - lr * g[c][i] / denom;
        Chunk<T, V>::store(trow + col_of<V>(c, hl), y);
      }
    if (hl == 0) acc[r] = new_acc;
  }
};

// Kernel #3's epilogue: the run's sum written to its row of `out`.
struct AggregateStore {
  float* out;

  template <int V, int NC>
  struct Row {};

  template <int V, int NC>
  __device__ __forceinline__ Row<V, NC> load(int32_t, int, int64_t) const {
    return {};
  }

  template <int V, int NC>
  __device__ __forceinline__ void apply(int32_t r, float (&g)[NC][V], const Row<V, NC>&,
                                        int64_t d) const {
    if (r < 0) return;
    const int hl = threadIdx.x & 15;
    float* orow = out + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < d)
#pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<float4*>(orow + col_of<V>(c, hl) + i) =
              make_float4(g[c][i], g[c][i + 1], g[c][i + 2], g[c][i + 3]);
  }
};

// The walk for the gradients' dtype: bf16 rows as 16-byte loads where D and
// the alignment of the gradients (and of the rows the epilogue moves in V
// columns, `rows_align16`) allow them, else 8-byte loads.
template <typename E>
int launch_for_grads(const Walk& p, const E& epi, int grad_dtype, bool rows_align16,
                     cudaStream_t s) {
  if (grad_dtype == kF32) {
    if (!aligned(p.grads, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_walk<float, 4>(p, epi, s);
  }
  if (grad_dtype == kBF16) {
    if (!aligned(p.grads, 8)) return static_cast<int>(cudaErrorMisalignedAddress);
    if (p.d % 8 == 0 && aligned(p.grads, 16) && rows_align16)
      return launch_walk<uint16_t, 8>(p, epi, s);
    return launch_walk<uint16_t, 4>(p, epi, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. n_slots is the length
// of part_id (part holds n_slots rows of D): at least 2 * ceil(M / 32).
int ttrm_rowwise_adagrad(void* table, int table_dtype, void* acc, const void* ids,
                         const void* grads, int grad_dtype, const void* perm, void* part,
                         void* part_id, int64_t n_slots, int64_t n_rows, int64_t d, int64_t m,
                         float lr, float eps, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  Walk p;
  if (!make_walk(ids, grads, perm, part, part_id, n_slots, n_rows, d, m, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<float*>(acc);
  if (table_dtype == kF32) {
    if (!aligned(table, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_for_grads(p, AdagradUpdate<float>{static_cast<float*>(table), a, lr, eps},
                            grad_dtype, true, s);
  }
  if (table_dtype == kBF16) {
    if (!aligned(table, 8)) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_for_grads(p, AdagradUpdate<uint16_t>{static_cast<uint16_t*>(table), a, lr, eps},
                            grad_dtype, aligned(table, 16), s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// `out` [N, D] f32 must arrive zeroed and 16-byte aligned. Returns a
// cudaError_t code.
int ttrm_sorted_aggregate(void* out, const void* ids, const void* grads, int grad_dtype,
                          void* part, void* part_id, int64_t n_slots, int64_t n_rows, int64_t d,
                          int64_t m, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  Walk p;
  if (!make_walk(ids, grads, nullptr, part, part_id, n_slots, n_rows, d, m, &p) ||
      !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_for_grads(p, AggregateStore{static_cast<float*>(out)}, grad_dtype, true,
                          static_cast<cudaStream_t>(stream));
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
