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
//   - ids [M] int32 NON-DECREASING, M < 2^31; ids outside [0, N) are
//     sentinels (dead slots), never read and never written; unsorted ids
//     would give two owners one row, and they would race;
//   - grads [*, D] f32 or bf16, summed in f32; perm [M] int32 or null;
//   - values: [N, D] int8, scales: [N] f32 (the row's absmax), acc: [N] f32;
//   - any D >= 1 and any alignment: D % 4 == 0, D <= 512 with values 4-byte
//     aligned, f32 gradients 16-byte and bf16 gradients 8-byte aligned take
//     the half-warp walk; everything else the general walk of
//     sorted_runs.cuh (four-element accesses where D % 4 == 0 and the
//     pointers allow them, else scalar ones);
//   - part [2 * ceil(M / 32) (+ the general walk's rows), D] f32 and part_id
//     [2 * ceil(M / 32)] int32:
//     scratch that the wrapper allocates on the caller's stream (nothing
//     carries over between calls);
//   - a row that no live id names, or whose summed gradient is exactly zero
//     in every column, keeps its exact bytes, scale and accumulator:
//     requantizing is not idempotent, so such a row is not written at all;
//   - buffer_dtype kBF16 (`scatter_buffer_dtype="bfloat16"` on the sorted
//     table): g_r is the reference's bf16 buffer, each run summed in
//     position order with a rounding to bf16 after every add
//     (sorted_runs.cuh), and every named row is written, also one whose sum
//     is zero, as the reference's masked dense update does;
//   - the rounding: the division by 127 (and by the new scale) is a true
//     division and the product a separate multiply, as the plain version
//     computes them; round-half-to-even (rintf), then the clamp.
//
// What bounds it: memory, almost all of it the gradients (256 B a bf16 id at
// D = 128 against 128 B read and 128 B written a touched row, plus its scale
// and accumulator: 107 MB at the flagship's 262,144 ids, 0.032 ms at 3.35
// TB/s). So the design keeps many independent rows in flight and launches no
// thread that has nothing to do. No atomics: every sum has one fixed order.
//
// The walk is sorted_runs.cuh's: a warp per span of 32 sorted positions, a
// half-warp (16 lanes, 16-byte loads) per complete run, two runs in step,
// and a run longer than a warp's 64-position window summed in 32-position
// pieces by the warps of its spans and finished by a second pass. This file
// gives it the epilogue: the row's int8 values, scale and accumulator are
// read as soon as the id is known, with the run's first gradient rows, and
// the update applies with 16-lane reductions for mean(g^2) (in the order of
// the one-warp walk this kernel had before, so a complete run keeps those
// bits) and the new absmax; each lane packs its int8 into one 4- or 8-byte
// store. Each value takes two IEEE divisions (__fdiv_rn), a large share of
// the instructions.
//
// Binding: a plain C interface loaded with ctypes. Both passes go to the
// caller's stream, do not synchronise and allocate nothing; the entry point
// returns cudaGetLastError() right after them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_runs.cuh"

namespace {

using namespace sorted_runs;

// A lane's V int8 values of a row as one load.
template <int V>
struct Bytes;
template <>
struct Bytes<4> { using T = uint32_t; };
template <>
struct Bytes<8> { using T = uint2; };

// byte i of little-endian words, as a signed int8 widened to f32
__device__ __forceinline__ float int8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}
__device__ __forceinline__ float int8_at(uint2 w, int i) {
  return i < 4 ? int8_at(w.x, i) : int8_at(w.y, i - 4);
}

__device__ __forceinline__ uint32_t quantize(float x, float denom) {
  const float q = rintf(__fmul_rn(__fdiv_rn(x, denom), 127.f));
  const int v = static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
  return static_cast<uint32_t>(v) & 0xffu;
}
__device__ __forceinline__ uint32_t pack4(const float* x, float denom) {
  return quantize(x[0], denom) | (quantize(x[1], denom) << 8) | (quantize(x[2], denom) << 16) |
         (quantize(x[3], denom) << 24);
}
__device__ __forceinline__ void store_bytes(int8_t* p, const float (&x)[4], float denom) {
  *reinterpret_cast<uint32_t*>(p) = pack4(x, denom);
}
__device__ __forceinline__ void store_bytes(int8_t* p, const float (&x)[8], float denom) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack4(x, denom), pack4(x + 4, denom));
}

// The epilogue: the update of int8 row r, in place on its values, scale and
// accumulator.
struct QuantizedUpdate {
  int8_t* values;
  float* scales;
  float* acc;
  float lr, eps;
  bool named;  // write every named row, also one whose sum is zero (the bf16 buffer)

  // The table row r as this lane's chunks of int8 values, its scale and its
  // accumulator.
  template <int V, int NC>
  struct Row {
    typename Bytes<V>::T q[NC];
    float scale, acc;
  };

  template <int V, int NC>
  __device__ __forceinline__ Row<V, NC> load(int32_t r, int hl, int64_t d) const {
    Row<V, NC> t = {};
    if (r < 0) return t;  // a half-warp without a row
    const int8_t* vrow = values + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < d)
        t.q[c] = *reinterpret_cast<const typename Bytes<V>::T*>(vrow + col_of<V>(c, hl));
    t.scale = scales[r];
    t.acc = acc[r];
    return t;
  }

  // The update of row r from its summed gradient g and the row as it was. A
  // sum that is zero in every column writes nothing, unless `named`.
  template <int V, int NC>
  __device__ __forceinline__ void apply(int32_t r, float (&g)[NC][V], const Row<V, NC>& t,
                                        int64_t d) const {
    const int hl = threadIdx.x & 15, half = (threadIdx.x >> 4) & 1;
    bool nonzero = false;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < d) {
#pragma unroll
        for (int i = 0; i < V; ++i) nonzero = nonzero || g[c][i] != 0.f;
      }
    // an all-zero sum: the row keeps its bytes (every lane takes part in the ballot)
    const unsigned any = (__ballot_sync(kFullWarp, nonzero) >> (kLanes * half)) & 0xffffu;
    const bool write = r >= 0 && (named || any != 0);
    const float sum = half_sum_squares<V, NC>(g, d, hl);
    const float new_acc = t.acc + sum / static_cast<float>(d);
    const float denom = sqrtf(new_acc) + eps;
    const float mult = __fdiv_rn(t.scale, 127.f);

    // the new row, in g's registers
    float amax = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < d) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float row = __fmul_rn(int8_at(t.q[c], i), mult);
          const float step = __fdiv_rn(__fmul_rn(lr, g[c][i]), denom);
          g[c][i] = __fsub_rn(row, step);
          amax = fmaxf(amax, fabsf(g[c][i]));
        }
      }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(kFullWarp, amax, off));
    if (!write) return;
    const float qdenom = amax > 0.f ? amax : 1.f;
    int8_t* vrow = values + static_cast<int64_t>(r) * d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < d) store_bytes(vrow + col_of<V>(c, hl), g[c], qdenom);
    if (hl == 0) {
      scales[r] = amax;
      acc[r] = new_acc;
    }
  }

  // The general walk: a run is summed in the warp's stash row; the update
  // reads it back, writes the new f32 row over it while it finds the new
  // absmax, then reads that to quantize: V columns a lane, V int8 values a
  // load or store (one 4-byte word at V = 4).
  __device__ __forceinline__ float* sum_row(int32_t, float* stash, int64_t) const { return stash; }

  template <int V>
  __device__ __forceinline__ void apply_row(int32_t r, float* row, RowStats st, int64_t d) const {
    if (!named && !st.nonzero) return;  // an all-zero sum: the row keeps its bytes
    const int lane = threadIdx.x & 31;
    const float new_acc = acc[r] + st.sumsq / static_cast<float>(d);
    const float denom = sqrtf(new_acc) + eps;
    const float mult = __fdiv_rn(scales[r], 127.f);
    int8_t* vrow = values + static_cast<int64_t>(r) * d;
    float amax = 0.f;
    for (int64_t col = gcol<V>(0, lane); col < d; col += 32 * V) {
      float g[V];
      load_f32<V>(row + col, g);
      uint32_t q;
      if constexpr (V == 4)
        q = *reinterpret_cast<const uint32_t*>(vrow + col);
      else
        q = static_cast<uint8_t>(vrow[col]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float x = __fmul_rn(int8_at(q, i), mult);
        g[i] = __fsub_rn(x, __fdiv_rn(__fmul_rn(lr, g[i]), denom));
        amax = fmaxf(amax, fabsf(g[i]));
      }
      store_f32<V>(row + col, g);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFullWarp, amax, off));
    const float qdenom = amax > 0.f ? amax : 1.f;
    for (int64_t col = gcol<V>(0, lane); col < d; col += 32 * V) {
      float x[V];
      load_f32<V>(row + col, x);
      if constexpr (V == 4)
        *reinterpret_cast<uint32_t*>(vrow + col) = pack4(x, qdenom);
      else
        vrow[col] = static_cast<int8_t>(quantize(x[0], qdenom));
    }
    if (lane == 0) {
      scales[r] = amax;
      acc[r] = new_acc;
    }
  }
};

// The general walk for the gradients' dtype, V columns a lane's access.
template <int V>
int launch_general_for_grads(const Walk& p, const QuantizedUpdate& epi, int grad_dtype,
                             int buffer_dtype, cudaStream_t s) {
  if (grad_dtype == kF32) return launch_general<float, V>(p, epi, buffer_dtype, s);
  if (grad_dtype == kBF16) return launch_general<uint16_t, V>(p, epi, buffer_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. n_slots is the rows
// of D in part (part_id holds 2 * ceil(M / 32)): at least 2 * ceil(M / 32), and
// for the general walk (D % 4 != 0, D > 512, or values or gradients off the
// alignment of four-element accesses) n_spans * split more (sorted_runs.cuh:
// make_walk). buffer_dtype: kF32, or kBF16 for the bf16 buffer
// (sorted_runs.cuh), which also writes every named row.
int ttrm_quantized_adagrad(void* values, void* scales, void* acc, const void* ids,
                           const void* grads, int grad_dtype, const void* perm, void* part,
                           void* part_id, int64_t n_slots, int64_t n_rows, int64_t d, int64_t m,
                           float lr, float eps, int buffer_dtype, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (grad_dtype != kF32 && grad_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const bool four = d % 4 == 0 && aligned(values, 4) && aligned(grads, grad_dtype == kF32 ? 16 : 8);
  const bool general = !(four && half_warp_dim(d));
  Walk p;
  if (!make_walk(ids, grads, perm, part, part_id, n_slots, n_rows, d, m, general, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const QuantizedUpdate epi{static_cast<int8_t*>(values), static_cast<float*>(scales),
                            static_cast<float*>(acc), lr, eps, buffer_dtype == kBF16};
  const auto s = static_cast<cudaStream_t>(stream);
  if (general)
    return four ? launch_general_for_grads<4>(p, epi, grad_dtype, buffer_dtype, s)
                : launch_general_for_grads<1>(p, epi, grad_dtype, buffer_dtype, s);
  if (grad_dtype == kF32) return launch_walk<float, 4>(p, epi, buffer_dtype, s);
  // 16-byte loads (and 8-byte int8 chunks) where the rows' alignment allows them
  if (d % 8 == 0 && aligned(grads, 16) && aligned(values, 8))
    return launch_walk<uint16_t, 8>(p, epi, buffer_dtype, s);
  return launch_walk<uint16_t, 4>(p, epi, buffer_dtype, s);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
