// Pooled gather from an int8 table with per-row scales, for Hopper (sm_90a):
//
//   out[b, :] = sum_l w[b, l] * (float(values[ids[b, l], :]) * (scales[ids[b, l]] / 127))
//
// accumulated in f32. Replaces the Pallas TPU kernel
// `_gather_kernel_quantized` / `block_sorted_lookup_quantized` in
// two_tower_recommender_model_tpu/ops/block_sorted.py (kernel #5): at one
// slot and weight 1 it is that function (dequantized rows, zero rows for
// sentinel ids). At L slots it is `ops/quantized.py:quantized_pooled_lookup`,
// which the reference leaves to its compiler. The one-hot MXU contraction on
// the raw integers, the bf16x3 scale pick, the bf16 wire of the integer rows
// and the block work plan were means for the TPU and are not carried over.
//
// Contract:
//   - a slot whose id lies outside [0, N) or whose weight is 0 contributes
//     nothing, and neither its row nor its scale is read;
//   - values: [N, D] int8, row-major, contiguous, 4-byte aligned; scales: [N]
//     f32; ids: [B, L] int32 in any order; w: [B, L] f32 (mean pooling comes
//     pre-scaled); out: [B, D] f32 or bf16;
//   - D % 4 == 0 and D <= 512 (the wrapper raises for any other D);
//   - two paths, picked by the wrapper's plan (ops/gather_plan.py) from D and
//     the pointers: the wide path (the walks of csrc/gather_rows.cuh, picked
//     by B and L) for D % 16 == 0 with values and out 16-byte aligned; the
//     narrow path, one warp a bag and four int8 a lane, for every other D or
//     alignment;
//   - the rounding, the same on both paths: scale / 127 is one true
//     division of the slot's scale; the dequantized element and its weighting are
//     separate multiplies and the sum a separate add (no fused multiply-add),
//     slots added in slot order from 0, so at one slot the result equals the
//     plain version's bit for bit.
//
// What bounds it: memory at the train step's 262,144 bags (a live slot reads
// D bytes of row and 4 of scale, a bag writes 4 D (f32) or 2 D (bf16) bytes:
// the output is the larger part), the latency of id load -> row load ->
// store at serving's 1 to 8,192 bags. On the wide path (csrc/gather_rows.cuh)
// a D = 128 row is 8 lanes of 16 bytes, so one warp-wide load fetches 4 rows
// and, at serving sizes, one load of the ids serves the warp's 4 bags; at
// the train step a lane has 4 such loads out at once, and a warp writes
// its 32 items' 16 dequantized columns each through shared memory as 512
// contiguous bytes a store instruction. Row offsets are 64-bit (N x D passes
// 2^31 at 20 million rows).
//
// Binding: a plain C interface loaded with ctypes. The launch goes to the
// caller's stream, does not synchronise, allocates nothing, and the entry
// point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gather_rows.cuh"

namespace {

constexpr int kMaxDim = 512;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// byte i of a little-endian word, as a signed int8 widened to f32
__device__ __forceinline__ float int8_at(uint32_t word, int i) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}

// one element of a slot, in the contract's rounding
__device__ __forceinline__ float add_elem(float acc, float v, float mult, float wt) {
  return __fadd_rn(acc, __fmul_rn(__fmul_rn(v, mult), wt));
}

// The int8 rows of the wide path: 16 int8 a chunk; a slot's extra is its
// scale / 127, one true division by the slot's owner.
struct Int8Rows {
  static constexpr int VEC = 16;
  static constexpr bool kExtra = true;
  const int8_t* values;
  const float* scales;
  int64_t d;
  __device__ __forceinline__ uint4 load(int32_t id, int chunk) const {
    return __ldg(reinterpret_cast<const uint4*>(values + static_cast<int64_t>(id) * d) + chunk);
  }
  __device__ __forceinline__ float load_extra(int32_t id) const { return __ldg(scales + id); }
  __device__ __forceinline__ float extra(float scale) const { return __fdiv_rn(scale, 127.f); }
  __device__ __forceinline__ void add(float (&acc)[VEC], const uint4& raw, float wt,
                                      float mult) const {
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = add_elem(acc[i], int8_at(words[i / 4], i % 4), mult, wt);
  }
};

template <typename Tout, gather::Walk WALK>
__global__ void __launch_bounds__(gather::kMaxWarpsPerBlock * 32,
                                  (gather::kBlocksPerSm<WALK, Int8Rows, Tout>))
quantized_gather_wide(Int8Rows rows, const int32_t* __restrict__ ids, const float* __restrict__ w,
                      Tout* __restrict__ out, int64_t n_rows, int64_t d, int64_t batch,
                      int64_t bag_l, int64_t run_bags) {
  gather::gather_wide<WALK>(rows, ids, w, out, n_rows, d, batch, bag_l, run_bags);
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(uint16_t* p, float x) {
  *p = static_cast<uint16_t>(gather::bf16_bits(x));
}

// The narrow path: one warp a bag, four int8 (one 4-byte word) a lane,
// element stores (any output alignment).
template <typename Tout>
__global__ void __launch_bounds__(gather::kMaxWarpsPerBlock * 32)
quantized_gather_narrow(const int8_t* __restrict__ values, const float* __restrict__ scales,
                        const int32_t* __restrict__ ids, const float* __restrict__ w,
                        Tout* __restrict__ out, int64_t n_rows, int64_t d, int64_t batch,
                        int64_t bag_l) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (bag >= batch) return;
  const int32_t* bag_ids = ids + bag * bag_l;
  const float* bag_w = w + bag * bag_l;
  for (int64_t col = lane * 4; col < d; col += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t l = 0; l < bag_l; ++l) {
      const int32_t id = __ldg(bag_ids + l);
      const float wt = __ldg(bag_w + l);
      if (id < 0 || id >= n_rows || wt == 0.f) continue;  // dead slot: nothing read
      const float mult = __fdiv_rn(__ldg(scales + id), 127.f);
      const uint32_t word = __ldg(
          reinterpret_cast<const uint32_t*>(values + static_cast<int64_t>(id) * d + col));
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add_elem(acc[i], int8_at(word, i), mult, wt);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) store_elem(out + bag * d + col + i, acc[i]);
  }
}

// The wide walk's kernel, picked by the plan's walk code.
template <typename Tout>
auto wide_kernel(int walk) -> decltype(&quantized_gather_wide<Tout, gather::Walk::kOne>) {
  using gather::Walk;
  if (walk == static_cast<int>(Walk::kOne)) return &quantized_gather_wide<Tout, Walk::kOne>;
  if (walk == static_cast<int>(Walk::kRuns)) return &quantized_gather_wide<Tout, Walk::kRuns>;
  if (walk == static_cast<int>(Walk::kItems)) return &quantized_gather_wide<Tout, Walk::kItems>;
  return nullptr;
}

template <typename Tout>
int occupancy(int walk) {
  const auto kernel = wide_kernel<Tout>(walk);
  return kernel ? gather::blocks_per_sm(kernel) : -static_cast<int>(cudaErrorInvalidValue);
}

template <typename Tout>
int launch(const int8_t* values, const float* scales, const int32_t* ids, const float* w,
           Tout* out, int64_t n_rows, int64_t d, int64_t batch, int64_t bag_l, int walk,
           int64_t run_bags, int warps_per_block, int64_t blocks, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(blocks)), block(warps_per_block * 32);
  if (walk == static_cast<int>(gather::Walk::kNarrow)) {
    quantized_gather_narrow<Tout><<<grid, block, 0, s>>>(values, scales, ids, w, out, n_rows, d,
                                                         batch, bag_l);
  } else {
    const auto kernel = wide_kernel<Tout>(walk);
    kernel<<<grid, block, 0, s>>>(Int8Rows{values, scales, d}, ids, w, out, n_rows, d, batch,
                                  bag_l, run_bags);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. `walk`, `run_bags`,
// `warps_per_block` and `blocks` are the plan of ops/gather_plan.py (one run
// of `run_bags` bags a warp); a plan that does not fit the shape
// (`gather::plan_fits`) returns cudaErrorInvalidValue and launches nothing.
int ttrm_quantized_gather(const void* values, const void* scales, const void* ids, const void* w,
                          void* out, int out_dtype, int64_t n_rows, int64_t d, int64_t batch,
                          int64_t bag_l, int walk, int64_t run_bags, int warps_per_block,
                          int64_t blocks, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d % 4 != 0 || d > kMaxDim || bag_l < 0 ||
      reinterpret_cast<uintptr_t>(values) % 4 != 0 ||
      !gather::plan_fits(walk, batch, d, Int8Rows::VEC, bag_l, values, out, run_bags,
                         warps_per_block, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int8_t*>(values);
  const auto* sc = static_cast<const float*>(scales);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* wt = static_cast<const float*>(w);
  if (out_dtype == kF32)
    return launch(v, sc, i, wt, static_cast<float*>(out), n_rows, d, batch, bag_l, walk,
                  run_bags, warps_per_block, blocks, s);
  if (out_dtype == kBF16)
    return launch(v, sc, i, wt, static_cast<uint16_t*>(out), n_rows, d, batch, bag_l, walk,
                  run_bags, warps_per_block, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The 256-thread blocks an SM the wide walk `walk` reaches for this output
// dtype on the current card (the plan's capacity), or a negative cudaError_t.
int ttrm_quantized_gather_blocks_per_sm(int out_dtype, int walk) {
  if (out_dtype == kF32) return occupancy<float>(walk);
  if (out_dtype == kBF16) return occupancy<uint16_t>(walk);
  return -static_cast<int>(cudaErrorInvalidValue);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
