// Bias and ReLU of a tower layer's bf16 GEMM, with the ReLU decisions at
// bf16 rounding ties taken in k order, for Hopper (sm_90a):
//
//   r   = y[i, c]                                  (bf16: the GEMM's rounded sum)
//   tie = a bf16 neighbour of r decides the ReLU other than r does
//   r'  = tie ? bf16(sum_k a[i, k] * W[k, c], f32 fmaf in k order) : r
//   out = relu(bf16(r' + b[c]))
//
// for y [B, N], a [B, K] (the layer's input), W [K, N] (passed transposed,
// wt [N, K], so column c of W is one contiguous row) and b [N], all bf16.
//
// Why: the fused tower's forward (the reference's `_mlp2_fwd_impl` of
// two_tower_recommender_model_tpu/models/mlp.py), run as one bf16 cuBLAS
// GEMM a layer, sums in cuBLAS's own order on the tensor cores. Where a
// pre-activation's f32 sum lies within a few f32 ulps of a bf16 rounding
// midpoint, another order can round it to the other bf16 neighbour; where
// the two neighbours straddle -b, that moves a ReLU decision, and with it a
// whole row of the tower backward's dx (the backward, kernel #8 of
// csrc/tower_bwd.cu, recomputes such layer-1 sums in k order, an f32 GEMM's
// fmaf chain, as does the plain version of this
// kernel). Only the rounded r is left after the GEMM, so the test is taken on
// r: another order can only have moved r by one bf16 ulp, and r's decision
// can differ from a neighbour's only where r is -b or the bf16 value next
// above -b. Those values (a small share; chip_smoke.py's [kernel] line
// prints it) are summed again in k order, one fmaf a k, as #8's
// `ordered_dot` does, and rounded to bf16 as the plain route rounds; every
// other value keeps the GEMM's r.
// Then the bias add (f32 add, one rounding to bf16, as PyTorch's bf16 add)
// and the ReLU (positive zero for a non-positive pre-activation).
//
// What bounds it: memory. It reads y and writes out, 4 B an element, and
// replaces the two elementwise passes (add, relu) that read and wrote 8 B an
// element. A tie's recompute reads a row of a and of wt (2 K bf16), from L2.
// The design keeps the recompute off the elementwise pass, where a tie's
// 128-fmaf chain (and the registers it takes) would hold up the pass
// (measured: with the recompute inline, or a tie list filled by atomics in
// the pass, 3.6-4.3x the bound at the BCE step's shapes, whose ties are
// ~0.15-0.2% of the values):
//   - pass 1 takes 8 consecutive elements of a row a thread (one 16-byte
//     load and store) when N % 8 == 0 and the tensors are 16-byte aligned,
//     else one; the tie test is compares of bf16 bits; it writes every
//     output from the GEMM's r, and a byte of tie flags a thread;
//   - pass 2 reads the flags, 32 words of four bytes a warp, ranks the
//     flagged elements by a warp prefix sum and gives them out one a lane;
//     each is summed again (16-byte loads of both rows started ahead of the
//     fmaf chain) and its output overwritten. Each output is written once
//     a pass: no atomics, and the result does not depend on timing.
//
// `relu_tie`, `ordered_dot` and `finish` live in relu_ties.cuh, shared with
// the fused tower forward (tower_fwd.cu), which took this kernel's place on
// the main path.
//
// Binding: a plain C interface loaded with ctypes. Both launches go to the
// caller's stream, nothing synchronises, nothing is allocated (the wrapper
// passes the flags), and the entry point returns cudaGetLastError() after
// the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relu_ties.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

using relu_ties::finish;
using relu_ties::ordered_dot;
using relu_ties::relu_tie;
using relu_ties::rnd;

// Pass 1: V elements a thread (V = 8: 16-byte vectors, N % 8 == 0; or 1);
// threads up to `groups` (a multiple of 4) each write their flag byte.
template <int V>
__global__ void __launch_bounds__(kThreads)
relu_ties_pass1(const uint16_t* __restrict__ y, const uint16_t* __restrict__ bias,
                uint16_t* __restrict__ out, uint8_t* __restrict__ flags, int64_t numel,
                int64_t n, int64_t groups) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= groups) return;
  const int64_t e0 = t * V;
  if (e0 >= numel) {
    flags[t] = 0;
    return;
  }
  const int64_t c0 = e0 % n;
  uint4 raw, braw;  // V values and their V biases; 16-byte vectors when V = 8
  uint16_t* v = reinterpret_cast<uint16_t*>(&raw);
  uint16_t* b = reinterpret_cast<uint16_t*>(&braw);
  if constexpr (V == 8) {
    raw = *reinterpret_cast<const uint4*>(y + e0);
    braw = *reinterpret_cast<const uint4*>(bias + c0);
  } else {
    v[0] = y[e0];
    b[0] = bias[c0];
  }
  unsigned tie = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    tie |= unsigned(relu_tie(v[j], b[j])) << j;
    v[j] = finish(__bfloat162float(__ushort_as_bfloat16(v[j])),
                  __bfloat162float(__ushort_as_bfloat16(b[j])));
  }
  if constexpr (V == 8)
    *reinterpret_cast<uint4*>(out + e0) = raw;
  else
    out[e0] = v[0];
  flags[t] = static_cast<uint8_t>(tie);
}

// Pass 2: a warp reads 32 flag words (four bytes each), ranks their flagged
// elements by a prefix sum of the words' bit counts, and gives them out one
// a lane, so every lane of the warp sums one tie at a time; each is summed
// again in k order and its output overwritten.
template <int V>
__global__ void __launch_bounds__(kThreads)
relu_ties_pass2(const uint16_t* __restrict__ bias, const bf16* __restrict__ a,
                const bf16* __restrict__ wt, uint16_t* __restrict__ out,
                const uint32_t* __restrict__ flags, int64_t words, int64_t n, int64_t k) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / 32 * 32;
       base < words; base += warps * 32) {
    const uint32_t w = base + lane < words ? flags[base + lane] : 0u;
    const int cnt = __popc(w);
    int incl = cnt;  // the warp's inclusive prefix sum of flagged elements
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(full, incl, d);
      if (lane >= d) incl += x;
    }
    const int total = __shfl_sync(full, incl, 31);
    for (int r = 0; r < total; r += 32) {
      const int idx = r + lane;
      int owner = 0;  // the first lane whose prefix passes idx
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(full, incl, owner + step - 1) <= idx) owner += step;
      const uint32_t ow = __shfl_sync(full, w, owner);
      const int before = __shfl_sync(full, incl - cnt, owner);
      if (idx < total) {
        uint32_t m = ow;  // drop the owner's flags ranked below this one
        for (int d = idx - before; d > 0; --d) m &= m - 1;
        const int bit = __ffs(m) - 1;
        const int64_t e = ((base + owner) * 4 + bit / 8) * V + bit % 8, i = e / n, c = e % n;
        out[e] = finish(rnd(ordered_dot(a + i * k, wt + c * k, k)),
                        __bfloat162float(__ushort_as_bfloat16(bias[c])));
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on successful launches. vec8 != 0 takes 8
// elements a thread (the caller checks N % 8 == 0 and 16-byte alignment).
// flags: scratch of a byte for each group of V elements, rounded up to a
// multiple of 4, 4-byte aligned.
int ttrm_relu_ties(const void* y, const void* bias, const void* a, const void* wt, void* out,
                   int64_t rows, int64_t n, int64_t k, int vec8, void* flags, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int v = vec8 ? 8 : 1;
  const int64_t numel = rows * n;
  const int64_t groups = ((numel + v - 1) / v + 3) / 4 * 4;  // flag bytes, a multiple of 4
  const int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words = groups / 4;
  const int64_t need = (words + kThreads - 1) / kThreads;  // 32 words a warp, kThreads a block
  const unsigned blocks2 = static_cast<unsigned>(need < 2048 ? need : 2048);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* yy = static_cast<const uint16_t*>(y);
  const auto* bb = static_cast<const uint16_t*>(bias);
  const auto* aa = static_cast<const bf16*>(a);
  const auto* ww = static_cast<const bf16*>(wt);
  auto* oo = static_cast<uint16_t*>(out);
  auto* ff = static_cast<uint8_t*>(flags);
  const auto* fw = static_cast<const uint32_t*>(flags);
  if (vec8) {
    relu_ties_pass1<8><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(yy, bb, oo, ff, numel,
                                                                          n, groups);
    relu_ties_pass2<8><<<blocks2, kThreads, 0, s>>>(bb, aa, ww, oo, fw, words, n, k);
  } else {
    relu_ties_pass1<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(yy, bb, oo, ff, numel,
                                                                          n, groups);
    relu_ties_pass2<1><<<blocks2, kThreads, 0, s>>>(bb, aa, ww, oo, fw, words, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
