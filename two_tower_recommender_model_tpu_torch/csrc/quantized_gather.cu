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
//   - the rounding: scale / 127 is a true division, the dequantized element
//     and its weighting are separate multiplies and the sum a separate add
//     (no fused multiply-add), so at one slot the result equals the plain
//     version's bit for bit.
//
// What bounds it: memory. A live slot reads D bytes of row and 4 of scale, a
// bag writes 4 D (f32) or 2 D (bf16) bytes: the output is the larger part.
// The design: one warp per bag, eight bags per 256-thread block; a lane loads
// four int8 as one 4-byte word, so at D = 128 one warp load covers a whole
// 128-byte row, and the scale is loaded once per slot. Row offsets are 64-bit
// (N x D passes 2^31 at 20 million rows). Keeping more rows in flight is
// later work.
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
constexpr int kMaxDim = 512;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// byte i of a little-endian word, as a signed int8 widened to f32
__device__ __forceinline__ float int8_at(uint32_t word, int i) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * i)) & 0xffu));
}

__device__ __forceinline__ void store4(float* dst, const float (&a)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}
__device__ __forceinline__ void store4(uint16_t* dst, const float (&a)[4]) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(bf16_bits(a[0]) | (bf16_bits(a[1]) << 16),
                                              bf16_bits(a[2]) | (bf16_bits(a[3]) << 16));
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
quantized_gather_kernel(const int8_t* __restrict__ values, const float* __restrict__ scales,
                        const int32_t* __restrict__ ids, const float* __restrict__ w,
                        Tout* __restrict__ out, int64_t n_rows, int64_t d, int64_t batch,
                        int64_t bag_l) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
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
      for (int i = 0; i < 4; ++i)
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(int8_at(word, i), mult), wt));
    }
    store4(out + bag * d + col, acc);
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch.
int ttrm_quantized_gather(const void* values, const void* scales, const void* ids, const void* w,
                          void* out, int out_dtype, int64_t n_rows, int64_t d, int64_t batch,
                          int64_t bag_l, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || d % 4 != 0 || d > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > static_cast<int64_t>(0x7fffffff) * kWarpsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((batch + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int8_t*>(values);
  const auto* sc = static_cast<const float*>(scales);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* wt = static_cast<const float*>(w);
  if (out_dtype == kF32) {
    quantized_gather_kernel<float><<<grid, kThreads, 0, s>>>(
        v, sc, i, wt, static_cast<float*>(out), n_rows, d, batch, bag_l);
  } else if (out_dtype == kBF16) {
    quantized_gather_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        v, sc, i, wt, static_cast<uint16_t*>(out), n_rows, d, batch, bag_l);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
