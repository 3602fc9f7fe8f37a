// Per-row-block sums of an [M, D] operand, for Hopper (sm_90a): the consumer
// kernels of the gather probe.
//
//   ttrm_probe_block_sums:   out[i] = sum(x[512 i : 512 (i + 1), :])            (f32)
//   ttrm_probe_block_sums2:  out[i] = sum(a[512 i : ...]) + sum(b[512 i : ...])  (f32)
//
// for i in [0, M / 512); rows from (M / 512) * 512 on are never read.
//
// Replaces the Pallas TPU kernels `pallas_sum` (`_sum_kernel`) and
// `pallas_sum2` of tools/probe_consumer.py (kernels #12 and #13). Their grid
// has M / 512 steps, each of which reads one [512, D] block and writes its
// sum to the same (1, 1) output block, so what they return is the LAST full
// block's sum; their use is to force every block of a gathered operand
// through a hand-written kernel. The TPU grid runs in order on one core;
// here the blocks run in parallel, so every step's write gets its own slot
// out[i], and the wrapper returns out[-1] where the TPU kernel's value is
// wanted.
//
// Contract:
//   - x (a, b): [M, D] contiguous, f32 or bf16 (bf16 is widened exactly and
//     summed in f32), 16-byte aligned; a and b share shape and dtype;
//   - out: [M / 512] f32, every element written;
//   - any D: a block of 512 rows is 512 D contiguous elements, a multiple of
//     the 4 (f32) or 8 (bf16) elements of a 16-byte load.
//
// What bounds it: memory. Each element is read once against one add. The
// design: one thread block per row block, 256 threads, 16-byte loads with
// neighbouring lanes on neighbouring addresses, four loads in flight a
// thread; f32 accumulation per thread, then warp shuffles, then eight
// partials through shared memory summed by one thread. The order is fixed
// and there are no atomics, so two runs agree bit for bit.
//
// Binding: a plain C interface loaded with ctypes. The launch goes to the
// caller's stream, does not synchronise, allocates nothing, and the entry
// point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kBlockRows = 512;
constexpr unsigned kFullWarp = 0xffffffffu;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// one 16-byte load, summed in f32
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ float load_sum(const float* p) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    return (v.x + v.y) + (v.z + v.w);
  }
};

template <>
struct Vec<uint16_t> {
  static constexpr int kElems = 8;
  // bf16 travels as its raw 16 bits: widening is a 16-bit shift, exact
  static __device__ __forceinline__ float pair(uint32_t w) {
    return __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
  }
  static __device__ __forceinline__ float load_sum(const uint16_t* p) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    return (pair(v.x) + pair(v.y)) + (pair(v.z) + pair(v.w));
  }
};

// The sum of `n_elems` contiguous elements from `base`, by the whole thread
// block; the result is valid in thread 0. `partials` is kWarps floats of
// shared memory, free for reuse on return.
template <typename T>
__device__ __forceinline__ float block_total(const T* __restrict__ base, int64_t n_elems,
                                             float* partials) {
  const int64_t n_vec = n_elems / Vec<T>::kElems;
  float acc = 0.f;
#pragma unroll 4
  for (int64_t v = threadIdx.x; v < n_vec; v += kThreads)
    acc += Vec<T>::load_sum(base + v * Vec<T>::kElems);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullWarp, acc, off);
  if ((threadIdx.x & 31) == 0) partials[threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += partials[w];
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_block_sums_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t d) {
  __shared__ float partials[kWarps];
  const int64_t n_elems = kBlockRows * d;
  const float total = block_total(x + static_cast<int64_t>(blockIdx.x) * n_elems, n_elems,
                                  partials);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_block_sums2_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         float* __restrict__ out, int64_t d) {
  __shared__ float partials[kWarps];
  const int64_t n_elems = kBlockRows * d;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * n_elems;
  const float total_a = block_total(a + first, n_elems, partials);
  const float total_b = block_total(b + first, n_elems, partials);
  if (threadIdx.x == 0) out[blockIdx.x] = total_a + total_b;
}

// The number of row blocks as a grid, or false when M or D is outside what
// the kernels take.
bool launch_grid(int64_t m, int64_t d, dim3* grid) {
  const int64_t blocks = m / kBlockRows;
  if (d <= 0 || blocks > static_cast<int64_t>(0x7fffffff)) return false;
  *grid = dim3(static_cast<unsigned>(blocks));
  return true;
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch.
int ttrm_probe_block_sums(const void* x, int dtype, void* out, int64_t m, int64_t d,
                          void* stream) {
  if (m < kBlockRows) return static_cast<int>(cudaSuccess);  // no full block: nothing to write
  dim3 grid;
  if (!launch_grid(m, d, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (dtype == kF32) {
    probe_block_sums_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), o, d);
  } else if (dtype == kBF16) {
    probe_block_sums_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), o, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Returns a cudaError_t code: 0 on a successful launch.
int ttrm_probe_block_sums2(const void* a, const void* b, int dtype, void* out, int64_t m,
                           int64_t d, void* stream) {
  if (m < kBlockRows) return static_cast<int>(cudaSuccess);
  dim3 grid;
  if (!launch_grid(m, d, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<float*>(out);
  if (dtype == kF32) {
    probe_block_sums2_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), o, d);
  } else if (dtype == kBF16) {
    probe_block_sums2_kernel<uint16_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b), o, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
