// Pooled embedding gather for Hopper (sm_90a):
//
//   out[b, :] = sum_l w[b, l] * table[ids[b, l], :]      (f32 accumulation)
//
// Replaces the Pallas TPU kernel `_pooled_kernel` /
// `pallas_pooled_lookup` in two_tower_recommender_model_tpu/ops/pallas_embedding.py.
// With one slot and weight 1 it also computes `block_sorted_lookup`
// (ops/block_sorted.py): table[ids] with zero rows for sentinel ids >= N.
//
// Contract:
//   - a slot whose id lies outside [0, N) or whose weight is 0 contributes
//     nothing, and its row is never read;
//   - table: [N, D] float32 or bfloat16, row-major, contiguous;
//   - ids:   [B, L] int32; w: [B, L] float32 (mean pooling comes pre-scaled);
//   - out:   [B, D] float32 or bfloat16;
//   - two paths, picked by the wrapper's plan (ops/gather_plan.py) from D and
//     the pointers: the wide path (the walks of csrc/gather_rows.cuh, picked
//     by B and L) for a row of whole 16-byte chunks (D % 4 == 0 in f32,
//     D % 8 == 0 in bf16) with table and out 16-byte aligned; the narrow
//     path, one warp a bag and one element a lane, for any other D or
//     alignment;
//   - the rounding, the same on both paths: acc = fmaf(w, x, acc) from 0 in
//     slot order, so at one slot the result is w * x rounded once, the plain
//     version's bit for bit;
//   - `round_rows` (f32 table, bf16 out): each row is first rounded to bf16,
//     acc = fmaf(w, bf16(x), acc), and the sum rounded once: the reference's
//     rounding of a bag under bf16 compute (ops/embedding_ops.py:67-75, each
//     row cast to bf16, the bag summed in f32 in slot order, rounded once).
//     For any other dtype pair a row already is in the output dtype, so the
//     flag changes nothing.
//
// What bounds it: memory at the train step's 262,144 bags (each live slot
// reads one D-wide row, 512 B at f32 and D = 128, each bag writes one row,
// against 2 FLOPs an element), and at serving's 1 to 8,192 bags the latency
// of the dependent id load -> row load -> store. On the wide path
// (csrc/gather_rows.cuh) a lane loads 16 bytes of a row (a float4 of f32, or
// eight bf16), so a D = 128 f32 row is one warp-wide load; at serving sizes
// a warp takes one bag (two in bf16), at the train step a run of 32 whose
// ids come in one coalesced load, and a lane has 4 row loads out at once.
//
// Binding: a plain C interface loaded with ctypes. The launch goes to the
// caller's stream, does not synchronise, allocates nothing, and the entry
// point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "gather_rows.cuh"

namespace {

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// bfloat16 values travel as their raw 16 bits (uint16_t): a bf16 -> f32
// widening is a 16-bit shift, exact.
__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_elem(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(uint16_t* p, float x) {
  *p = static_cast<uint16_t>(gather::bf16_bits(x));
}

// 16 bytes of a row, widened to f32
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4]) {
  v[0] = __uint_as_float(r.x);
  v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z);
  v[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8]) {
  const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);             // low half: element 2i
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);  // high half: element 2i+1
  }
}

// x rounded to the nearest bf16 (ties to even), widened back to f32
__device__ __forceinline__ float round_bf16(float x) {
  return __uint_as_float(gather::bf16_bits(x) << 16);
}

// The float rows of the wide path: 16 bytes a chunk, no extra a slot; ROUND
// rounds each element to bf16 before it is added.
template <typename Tin, bool ROUND = false>
struct FloatRows {
  static constexpr int VEC = 16 / sizeof(Tin);
  static constexpr bool kExtra = false;
  const Tin* table;
  int64_t d;
  __device__ __forceinline__ uint4 load(int32_t id, int chunk) const {
    return __ldg(reinterpret_cast<const uint4*>(table + static_cast<int64_t>(id) * d) + chunk);
  }
  __device__ __forceinline__ float load_extra(int32_t) const { return 0.f; }
  __device__ __forceinline__ float extra(float) const { return 0.f; }
  __device__ __forceinline__ void add(float (&acc)[VEC], const uint4& raw, float wt,
                                      float) const {
    float x[VEC];
    unpack(raw, x);
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wt, ROUND ? round_bf16(x[i]) : x[i], acc[i]);
  }
};

template <typename Tin, typename Tout, bool ROUND, gather::Walk WALK>
__global__ void __launch_bounds__(gather::kMaxWarpsPerBlock * 32,
                                  (gather::kBlocksPerSm<WALK, FloatRows<Tin, ROUND>, Tout>))
pooled_gather_wide(FloatRows<Tin, ROUND> rows, const int32_t* __restrict__ ids,
                   const float* __restrict__ w, Tout* __restrict__ out, int64_t n_rows, int64_t d,
                   int64_t batch, int64_t bag_l, int64_t run_bags) {
  gather::gather_wide<WALK>(rows, ids, w, out, n_rows, d, batch, bag_l, run_bags);
}

// The narrow path: one warp a bag, one element a lane; any D, any alignment.
template <typename Tin, typename Tout, bool ROUND>
__global__ void __launch_bounds__(gather::kMaxWarpsPerBlock * 32)
pooled_gather_narrow(const Tin* __restrict__ table, const int32_t* __restrict__ ids,
                     const float* __restrict__ w, Tout* __restrict__ out, int64_t n_rows,
                     int64_t d, int64_t batch, int64_t bag_l) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (bag >= batch) return;
  const int32_t* bag_ids = ids + bag * bag_l;
  const float* bag_w = w + bag * bag_l;
  for (int64_t c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (int64_t l = 0; l < bag_l; ++l) {
      const int32_t id = __ldg(bag_ids + l);
      const float wt = __ldg(bag_w + l);
      if (id < 0 || id >= n_rows || wt == 0.f) continue;
      const float x = load_elem(table + id * d + c);
      acc = fmaf(wt, ROUND ? round_bf16(x) : x, acc);
    }
    store_elem(out + bag * d + c, acc);
  }
}

// The wide walk's kernel, picked by the plan's walk code.
template <typename Tin, typename Tout, bool ROUND>
auto wide_kernel(int walk) -> decltype(&pooled_gather_wide<Tin, Tout, ROUND, gather::Walk::kOne>) {
  using gather::Walk;
  if (walk == static_cast<int>(Walk::kOne)) return &pooled_gather_wide<Tin, Tout, ROUND, Walk::kOne>;
  if (walk == static_cast<int>(Walk::kRuns))
    return &pooled_gather_wide<Tin, Tout, ROUND, Walk::kRuns>;
  if (walk == static_cast<int>(Walk::kItems))
    return &pooled_gather_wide<Tin, Tout, ROUND, Walk::kItems>;
  return nullptr;
}

template <typename Tin, typename Tout, bool ROUND = false>
int occupancy(int walk) {
  const auto kernel = wide_kernel<Tin, Tout, ROUND>(walk);
  return kernel ? gather::blocks_per_sm(kernel) : -static_cast<int>(cudaErrorInvalidValue);
}

template <typename Tin, typename Tout, bool ROUND = false>
int launch(const void* table, const void* ids, const void* w, void* out, int64_t n_rows,
           int64_t d, int64_t batch, int64_t bag_l, int walk, int64_t run_bags,
           int warps_per_block, int64_t blocks, cudaStream_t stream) {
  if (!gather::plan_fits(walk, batch, d, FloatRows<Tin, ROUND>::VEC, bag_l, table, out, run_bags,
                         warps_per_block, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* t = static_cast<const Tin*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* wt = static_cast<const float*>(w);
  auto* o = static_cast<Tout*>(out);
  const dim3 grid(static_cast<unsigned>(blocks)), block(warps_per_block * 32);
  if (walk == static_cast<int>(gather::Walk::kNarrow)) {
    pooled_gather_narrow<Tin, Tout, ROUND><<<grid, block, 0, stream>>>(t, i, wt, o, n_rows, d,
                                                                       batch, bag_l);
  } else {
    const auto kernel = wide_kernel<Tin, Tout, ROUND>(walk);
    kernel<<<grid, block, 0, stream>>>(FloatRows<Tin, ROUND>{t, d}, i, wt, o, n_rows, d, batch,
                                       bag_l, run_bags);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. `round_rows` nonzero
// rounds each f32 row to bf16 before it is added (f32 table, bf16 out; no
// effect on another pair). `walk`, `run_bags`,
// `warps_per_block` and `blocks` are the plan of ops/gather_plan.py (one run
// of `run_bags` bags a warp); a plan that does not fit the shape
// (`gather::plan_fits`) returns cudaErrorInvalidValue and launches nothing.
int ttrm_pooled_gather(const void* table, int table_dtype, const void* ids, const void* w,
                       void* out, int out_dtype, int round_rows, int64_t n_rows, int64_t d, int64_t batch,
                       int64_t bag_l, int walk, int64_t run_bags, int warps_per_block,
                       int64_t blocks, void* stream) {
  if (batch <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (bag_l < 0 || d > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (table_dtype == kF32 && out_dtype == kF32)
    return launch<float, float>(table, ids, w, out, n_rows, d, batch, bag_l, walk, run_bags,
                                warps_per_block, blocks, s);
  if (table_dtype == kF32 && out_dtype == kBF16 && round_rows)
    return launch<float, uint16_t, true>(table, ids, w, out, n_rows, d, batch, bag_l, walk,
                                         run_bags, warps_per_block, blocks, s);
  if (table_dtype == kF32 && out_dtype == kBF16)
    return launch<float, uint16_t>(table, ids, w, out, n_rows, d, batch, bag_l, walk, run_bags,
                                   warps_per_block, blocks, s);
  if (table_dtype == kBF16 && out_dtype == kF32)
    return launch<uint16_t, float>(table, ids, w, out, n_rows, d, batch, bag_l, walk, run_bags,
                                   warps_per_block, blocks, s);
  if (table_dtype == kBF16 && out_dtype == kBF16)
    return launch<uint16_t, uint16_t>(table, ids, w, out, n_rows, d, batch, bag_l, walk,
                                      run_bags, warps_per_block, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The 256-thread blocks an SM the wide walk `walk` reaches for these dtypes
// and `round_rows` on the current card (the plan's capacity), or a negative
// cudaError_t.
int ttrm_pooled_gather_blocks_per_sm(int table_dtype, int out_dtype, int round_rows, int walk) {
  if (table_dtype == kF32 && out_dtype == kBF16 && round_rows)
    return occupancy<float, uint16_t, true>(walk);
  if (table_dtype == kF32 && out_dtype == kF32) return occupancy<float, float>(walk);
  if (table_dtype == kF32 && out_dtype == kBF16) return occupancy<float, uint16_t>(walk);
  if (table_dtype == kBF16 && out_dtype == kF32) return occupancy<uint16_t, float>(walk);
  if (table_dtype == kBF16 && out_dtype == kBF16) return occupancy<uint16_t, uint16_t>(walk);
  return -static_cast<int>(cudaErrorInvalidValue);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
