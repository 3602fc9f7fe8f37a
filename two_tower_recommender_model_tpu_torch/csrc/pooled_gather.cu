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
//   - out:   [B, D] float32 or bfloat16.
//
// What bounds it: memory. Each live slot reads one D-wide row (512 B at f32,
// D = 128) and each bag writes one row, against 2 FLOPs per element, so the
// kernel sits far below the card's ridge point. The design therefore only
// aims at coalesced 16-byte accesses: one warp per bag, eight bags per
// 256-thread block; each lane loads 16 bytes of the row (a float4 of f32, or
// eight bf16), so at D = 128 f32 one warp reads a whole row in one
// coalesced load. Any D that is a multiple of the 16-byte vector loops over
// D in such chunks; any other D, or a pointer that is not 16-byte aligned,
// takes the scalar kernel (one element per lane per step). Keeping more rows
// in flight (TMA, cp.async, several bags per warp) is later work.
//
// Binding: a plain C interface loaded with ctypes. The launch goes to the
// caller's stream, does not synchronise, allocates nothing, and the entry
// point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

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
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
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

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// VEC accumulators -> VEC output elements, in 8- or 16-byte stores
template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&a)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j)
    reinterpret_cast<float4*>(dst)[j] =
        make_float4(a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]);
}
template <int VEC>
__device__ __forceinline__ void store_vec(uint16_t* dst, const float (&a)[VEC]) {
  uint32_t w[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) w[i] = bf16_bits(a[2 * i]) | (bf16_bits(a[2 * i + 1]) << 16);
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Vector path: D % VEC == 0, table and out 16-byte aligned.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
pooled_gather_vec(const Tin* __restrict__ table, const int32_t* __restrict__ ids,
                  const float* __restrict__ w, Tout* __restrict__ out,
                  int64_t n_rows, int64_t d, int64_t batch, int64_t bag_l) {
  constexpr int VEC = 16 / sizeof(Tin);
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= batch) return;
  const int32_t* bag_ids = ids + bag * bag_l;
  const float* bag_w = w + bag * bag_l;
  const int64_t nvec = d / VEC;
  for (int64_t v = lane; v < nvec; v += 32) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int64_t l = 0; l < bag_l; ++l) {
      const int32_t id = __ldg(bag_ids + l);
      const float wt = __ldg(bag_w + l);
      if (id < 0 || id >= n_rows || wt == 0.f) continue;  // dead slot: row not read
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(table + id * d) + v);
      float x[VEC];
      unpack(raw, x);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wt, x[i], acc[i]);
    }
    store_vec<VEC>(out + bag * d + v * VEC, acc);
  }
}

// Scalar path: any D, any alignment.
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
pooled_gather_scalar(const Tin* __restrict__ table, const int32_t* __restrict__ ids,
                     const float* __restrict__ w, Tout* __restrict__ out,
                     int64_t n_rows, int64_t d, int64_t batch, int64_t bag_l) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= batch) return;
  const int32_t* bag_ids = ids + bag * bag_l;
  const float* bag_w = w + bag * bag_l;
  for (int64_t c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (int64_t l = 0; l < bag_l; ++l) {
      const int32_t id = __ldg(bag_ids + l);
      const float wt = __ldg(bag_w + l);
      if (id < 0 || id >= n_rows || wt == 0.f) continue;
      acc = fmaf(wt, load_elem(table + id * d + c), acc);
    }
    store_elem(out + bag * d + c, acc);
  }
}

template <typename Tin, typename Tout>
void launch(const void* table, const void* ids, const void* w, void* out, int64_t n_rows,
            int64_t d, int64_t batch, int64_t bag_l, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(Tin);
  const dim3 grid(static_cast<unsigned>((batch + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const bool aligned = (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const auto* t = static_cast<const Tin*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* wt = static_cast<const float*>(w);
  auto* o = static_cast<Tout*>(out);
  if (aligned && d % VEC == 0) {
    pooled_gather_vec<Tin, Tout><<<grid, kThreads, 0, stream>>>(t, i, wt, o, n_rows, d, batch, bag_l);
  } else {
    pooled_gather_scalar<Tin, Tout><<<grid, kThreads, 0, stream>>>(t, i, wt, o, n_rows, d, batch, bag_l);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch.
int ttrm_pooled_gather(const void* table, int table_dtype, const void* ids, const void* w,
                       void* out, int out_dtype, int64_t n_rows, int64_t d, int64_t batch,
                       int64_t bag_l, void* stream) {
  if (batch <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (batch > static_cast<int64_t>(0x7fffffff) * kWarpsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (table_dtype == kF32 && out_dtype == kF32) {
    launch<float, float>(table, ids, w, out, n_rows, d, batch, bag_l, s);
  } else if (table_dtype == kF32 && out_dtype == kBF16) {
    launch<float, uint16_t>(table, ids, w, out, n_rows, d, batch, bag_l, s);
  } else if (table_dtype == kBF16 && out_dtype == kF32) {
    launch<uint16_t, float>(table, ids, w, out, n_rows, d, batch, bag_l, s);
  } else if (table_dtype == kBF16 && out_dtype == kBF16) {
    launch<uint16_t, uint16_t>(table, ids, w, out, n_rows, d, batch, bag_l, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
