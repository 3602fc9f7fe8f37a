// Fused two-layer tower backward for Hopper (sm_90a): the whole backward of
//
//   out = relu(bf16(bf16(x @ W1) + b1) @ W2 + b2)      (the flagship tower)
//
// for x [B, 128], W1 [128, 128], W2 [128, H2] (H2 <= 128), given the
// cotangent dq [B, H2] and the SAVED forward output out [B, H2]:
//
//   d2  = out > 0 ? dq : 0                               (f32)
//   pre1 = bf16(bf16(bf16(x) @ bf16(W1)) + bf16(b1))     (add in bf16)
//   h1  = relu(pre1)
//   dh1 = bf16(d2) @ bf16(W2)^T                          (f32 accumulation)
//   d1  = pre1 > 0 ? dh1 : 0
//   dx  = bf16(d1) @ bf16(W1)^T                          (stored in x's dtype)
//   dW1 = bf16(x)^T @ bf16(d1),   db1 = sum_rows d1      (unrounded d1)
//   dW2 = h1^T @ bf16(d2),        db2 = sum_rows d2      (unrounded d2)
//
// Replaces the Pallas TPU kernel `_bwd_kernel` / `tower_backward_fused` in
// two_tower_recommender_model_tpu/ops/tower_bwd.py (kernel #8), with its
// rounding points: every product's operands are bf16 values, sums are f32,
// the layer-1 mask comes from the bf16 pre-activation and the final-ReLU mask
// from the saved output. The TPU's zero-padding of H2 to 128 lanes is not
// needed here.
//
// Contract: x, dq, out, dx all f32 or all bf16 (contiguous, row-major);
// W1 [128, 128], b1 [128], W2 [128, H2] f32 (rounded to bf16 on load);
// B a multiple of 32; the weight gradients are f32.
//
// What bounds it: arithmetic. Per row the four products and the forward
// recompute cost 2 * 128 * (3 * 128 + 2 * H2) FLOPs (~34 GFLOP per tower at
// B = 262,144, H2 = 64) against ~0.8 KB of HBM traffic per row. This first
// version does them on the CUDA cores (fmaf on bf16 values widened to f32),
// which keeps the rounding points exact and the code simple; moving the
// products to the tensor cores (mma.sync, then wgmma) is later work.
//   - One block per SM walks batch tiles of 32 rows (grid-stride). W1 and W2
//     sit in shared memory once per block as f32 with an odd row stride, so
//     both W and W^T reads are free of bank conflicts; the tile's x, pre1,
//     d2 and d1 live in shared memory, so the activations never touch HBM.
//   - Each thread owns fixed output columns, so it keeps an 8 x 8 block of
//     dW1 and of dW2, and one column of db1 and db2, in registers across all
//     the tiles it visits.
//   - Blocks cannot carry a sum across the grid the way the TPU's sequential
//     grid did, so each block writes its partial weight gradients to
//     `partials` and a second kernel sums them in block order: deterministic,
//     no atomics.
//
// Binding: a plain C interface loaded with ctypes. Both launches go to the
// caller's stream, do not synchronise and allocate nothing (the wrapper
// passes the partials buffer); the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;          // D_in == H1 == 128
constexpr int kT = 32;           // batch rows per tile
constexpr int kThreads = 256;
constexpr int kLd = kD + 1;      // padded row stride of W1 / W2 in shared memory
constexpr int kRowsPerThread = kT * kD / kThreads;  // 16 outputs of a [T, 128] product
constexpr size_t kSmemFloats = 2 * kD * kLd + 4 * kT * kD;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);  // 197,632 bytes

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float load_elem(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_elem(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(uint16_t* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
tower_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dq, const T* __restrict__ out,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, T* __restrict__ dx, float* __restrict__ partials,
                 int64_t n_tiles, int h2) {
  extern __shared__ float smem[];
  float* w1s = smem;                 // [128][kLd]: w1s[k * kLd + c] = W1[k][c]
  float* w2s = w1s + kD * kLd;       // [128][ld2]: w2s[c * ld2 + k] = W2[c][k]
  float* xs = w2s + kD * kLd;        // [T][128] bf16(x)
  float* p1s = xs + kT * kD;         // [T][128] pre1 (bf16 values)
  float* d2s = p1s + kT * kD;        // [T][128] d2 (first h2 columns)
  float* d1s = d2s + kT * kD;        // [T][128] d1
  const int t = threadIdx.x;
  const int ld2 = (h2 % 2 == 0) ? h2 + 1 : h2;  // odd stride: no bank conflicts

  for (int e = t; e < kD * kD; e += kThreads) w1s[(e / kD) * kLd + e % kD] = bf(__ldg(w1 + e));
  for (int e = t; e < kD * h2; e += kThreads) w2s[(e / h2) * ld2 + e % h2] = bf(__ldg(w2 + e));

  // [T, 128] products: this thread's column and rows
  const int c = t % kD;
  const int r0 = t / kD;  // rows r0, r0 + 2, ..., r0 + 30
  const float b1c = bf(__ldg(b1 + c));
  // weight-gradient blocks: rows i0..i0+7 of dW1 / dW2, columns jc + 16 q
  const int i0 = (t / 16) * 8;
  const int jc = t % 16;
  float gw1[8][8], gw2[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) gw1[m][q] = gw2[m][q] = 0.f;
  float gb1 = 0.f, gb2 = 0.f;
  __syncthreads();

  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t row0 = tile * kT;
    // a. the tile's inputs: bf16(x), and d2 with the saved final-ReLU mask
    for (int e = t; e < kT * kD; e += kThreads) xs[e] = bf(load_elem(x + row0 * kD + e));
    for (int e = t; e < kT * h2; e += kThreads) {
      const int64_t g = row0 * h2 + e;
      const float o = load_elem(out + g);
      d2s[(e / h2) * kD + e % h2] = o > 0.f ? load_elem(dq + g) : 0.f;
    }
    __syncthreads();

    // b. db2 from the unrounded d2; pre1 = bf16(bf16(x @ W1) + bf16(b1))
    if (t < h2) {
      for (int r = 0; r < kT; ++r) gb2 += d2s[r * kD + t];
    }
    {
      float acc[kRowsPerThread];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;
      for (int kk = 0; kk < kD; ++kk) {
        const float w = w1s[kk * kLd + c];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) acc[k] = fmaf(xs[(r0 + 2 * k) * kD + kk], w, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) p1s[(r0 + 2 * k) * kD + c] = bf(bf(acc[k]) + b1c);
    }
    __syncthreads();

    // c. round d2 in place: from here on it is only a product operand
    for (int e = t; e < kT * h2; e += kThreads) {
      float* p = d2s + (e / h2) * kD + e % h2;
      *p = bf(*p);
    }
    __syncthreads();

    // d. dh1 = bf16(d2) @ bf16(W2)^T, masked by the bf16 pre1
    {
      float acc[kRowsPerThread];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;
      for (int kk = 0; kk < h2; ++kk) {
        const float w = w2s[c * ld2 + kk];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) acc[k] = fmaf(d2s[(r0 + 2 * k) * kD + kk], w, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = r0 + 2 * k;
        d1s[r * kD + c] = p1s[r * kD + c] > 0.f ? acc[k] : 0.f;
      }
    }
    __syncthreads();

    // e. db1 from the unrounded d1, then round d1 in place
    if (t < kD) {
      for (int r = 0; r < kT; ++r) gb1 += d1s[r * kD + t];
    }
    __syncthreads();
    for (int e = t; e < kT * kD; e += kThreads) d1s[e] = bf(d1s[e]);
    __syncthreads();

    // f. dx = bf16(d1) @ bf16(W1)^T
    {
      float acc[kRowsPerThread];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;
      for (int kk = 0; kk < kD; ++kk) {
        const float w = w1s[c * kLd + kk];
#pragma unroll
        for (int k = 0; k < kRowsPerThread; ++k) acc[k] = fmaf(d1s[(r0 + 2 * k) * kD + kk], w, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k)
        store_elem(dx + (row0 + r0 + 2 * k) * kD + c, acc[k]);
    }

    // g. dW1 += bf16(x)^T @ bf16(d1);  dW2 += h1^T @ bf16(d2)
    for (int r = 0; r < kT; ++r) {
      float xv[8], hv[8], dv[8], ev[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        xv[m] = xs[r * kD + i0 + m];
        hv[m] = fmaxf(p1s[r * kD + i0 + m], 0.f);  // relu of a bf16 value: exact
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = jc + 16 * q;
        dv[q] = d1s[r * kD + j];
        ev[q] = j < h2 ? d2s[r * kD + j] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          gw1[m][q] = fmaf(xv[m], dv[q], gw1[m][q]);
          gw2[m][q] = fmaf(hv[m], ev[q], gw2[m][q]);
        }
    }
    __syncthreads();  // the next tile overwrites the shared tiles
  }

  // this block's partial gradients: [dW1 128x128 | db1 128 | dW2 128xH2 | db2 H2]
  const int64_t n_out = kD * kD + kD + static_cast<int64_t>(kD) * h2 + h2;
  float* part = partials + blockIdx.x * n_out;
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = jc + 16 * q;
      part[(i0 + m) * kD + j] = gw1[m][q];
      if (j < h2) part[kD * kD + kD + (i0 + m) * h2 + j] = gw2[m][q];
    }
  if (t < kD) part[kD * kD + t] = gb1;
  if (t < h2) part[kD * kD + kD + kD * h2 + t] = gb2;
}

// grads[e] = sum over blocks b, in order, of partials[b][e]
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partials, float* __restrict__ grads, int n_blocks,
                int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_out) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += __ldg(partials + b * n_out + e);
  grads[e] = s;
}

template <typename T>
int launch(const void* x, const void* dq, const void* out, const float* w1, const float* b1,
           const float* w2, void* dx, float* partials, float* grads, int64_t batch, int h2,
           int n_blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tower_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_bwd_kernel<T><<<n_blocks, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dq), static_cast<const T*>(out), w1, b1, w2,
      static_cast<T*>(dx), partials, batch / kT, h2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = kD * kD + kD + static_cast<int64_t>(kD) * h2 + h2;
  reduce_partials<<<static_cast<unsigned>((n_out + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(partials, grads, n_blocks, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when both launches succeeded.
// partials: [n_blocks, n_out] f32 scratch; grads: [n_out] f32, laid out
// [dW1 128x128 | db1 128 | dW2 128xH2 | db2 H2].
int ttrm_tower_bwd(const void* x, const void* dq, const void* out, int io_dtype, const void* w1,
                   const void* b1, const void* w2, void* dx, void* partials, void* grads,
                   int64_t batch, int64_t h2, int64_t n_blocks, void* stream) {
  if (batch <= 0 || batch % kT != 0 || h2 <= 0 || h2 > kD || n_blocks <= 0 ||
      n_blocks > batch / kT)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  auto* pf = static_cast<float*>(partials);
  auto* gf = static_cast<float*>(grads);
  const int h = static_cast<int>(h2);
  const int nb = static_cast<int>(n_blocks);
  if (io_dtype == kF32) return launch<float>(x, dq, out, w1f, b1f, w2f, dx, pf, gf, batch, h, nb, s);
  if (io_dtype == kBF16)
    return launch<uint16_t>(x, dq, out, w1f, b1f, w2f, dx, pf, gf, batch, h, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
