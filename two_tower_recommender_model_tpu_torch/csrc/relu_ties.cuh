// The ReLU of a tower layer at bf16 rounding ties, shared by relu_ties.cu
// (the bias-and-ReLU pass after a bf16 GEMM), tower_fwd.cu (the fused tower
// forward) and tower_bwd.cu (its backward, #8, which recomputes layer 1):
//
//   r   = the layer's f32 sum, rounded to bf16    (the GEMM's, in its own order)
//   tie = a bf16 neighbour of r decides the ReLU other than r does
//   r'  = tie ? bf16(sum_k a[k] * w[k], f32 fmaf in k order) : r
//   out = relu(bf16(r' + b))
//
// The decision is bf16(r + b) > 0, i.e. r > -b (an f32 add of two bf16 values
// keeps the sign of the exact sum, and bf16 rounding keeps it too, a nonzero
// sum of bf16 values being at least the smallest subnormal). Another
// summation order moves r by at most one bf16 ulp, so the ties are t = -b and
// the value next above it, a zero standing for both zeros. Those are summed
// again in k order, as an f32 GEMM (and the host) sums them: the forward and
// the backward take the same decisions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace relu_ties {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the bf16 value next above t (bits) in value order; above a zero, the
// smallest positive subnormal
__device__ __forceinline__ uint16_t next_above(uint16_t t) {
  return (t & 0x7fffu) == 0 ? 0x0001u : (t & 0x8000u) ? t - 1 : t + 1;
}

// Whether r (bf16 bits u) is a tie against the bias b (bf16 bits bb): t = -b
// or the value next above it, a zero standing for both zeros. (The plain
// version's `tie_mask` is this test; its CPU test holds it to the
// neighbours' decisions over every bf16 value.)
__device__ __forceinline__ bool relu_tie(uint16_t u, uint16_t bb) {
  const uint16_t t = bb ^ 0x8000u;  // -b
  const uint16_t above = next_above(t);
  const bool zero = (u & 0x7fffu) == 0;
  return u == t || u == above || (zero && ((t & 0x7fffu) == 0 || (above & 0x7fffu) == 0));
}

// The k-order sum over rows kept as 16-byte chunks of 8 values: load_a(j)
// and load_w(j) give chunk j (k = 8j .. 8j + 7) of each operand. Four chunks of
// each are loaded before their 32 fmaf; the order stays k's. A compact loop:
// a rare path where the fused forward inlines it.
template <typename LoadA, typename LoadW>
__device__ __forceinline__ float ordered_dot_chunks(int64_t n_chunks, LoadA load_a, LoadW load_w) {
  float s = 0.f;
#pragma unroll 1
  for (int64_t j0 = 0; j0 < n_chunks; j0 += 4) {
    uint4 ab[4], wb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + u < n_chunks) {
        ab[u] = load_a(j0 + u);
        wb[u] = load_w(j0 + u);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (j0 + u < n_chunks) {
        const bf16* x = reinterpret_cast<const bf16*>(&ab[u]);
        const bf16* y = reinterpret_cast<const bf16*>(&wb[u]);
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(__bfloat162float(x[e]), __bfloat162float(y[e]), s);
      }
    }
  }
  return s;
}

// a_row . w_row as an f32 GEMM sums it, one fmaf a k in k order. Rows of a
// multiple of 8 values on 16-byte boundaries are read 16 bytes at a time
// through the read-only cache.
__device__ __forceinline__ float ordered_dot(const bf16* __restrict__ a_row,
                                          const bf16* __restrict__ w_row, int64_t k) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a_row) | reinterpret_cast<uintptr_t>(w_row);
  if ((k & 7) == 0 && (addr & 15) == 0) {
    const uint4* av = reinterpret_cast<const uint4*>(a_row);
    const uint4* wv = reinterpret_cast<const uint4*>(w_row);
    return ordered_dot_chunks(k >> 3, [&](int64_t j) { return __ldg(av + j); },
                              [&](int64_t j) { return __ldg(wv + j); });
  }
  float s = 0.f;
  for (int64_t j = 0; j < k; ++j)
    s = fmaf(__bfloat162float(a_row[j]), __bfloat162float(w_row[j]), s);
  return s;
}

// relu(bf16(r + b)) as bf16 bits, positive zero below
__device__ __forceinline__ uint16_t finish(float r, float b) {
  const float pre = rnd(r + b);
  return __bfloat16_as_ushort(__float2bfloat16_rn(pre > 0.f ? pre : 0.f));
}

// --- two values of a row at once (bf16x2, the lower column in the low half) ---------------
//
// pre = bf16(r + b) as one bf16x2 add, which rounds the exact sum once; the
// f32 add and its rounding to bf16 (`finish`) give the same bits, since f32
// carries more than twice bf16's 8 significant bits (a double rounding is
// then innocuous for a sum).
//
// On pre, relu_tie(r, b) is 0 <= pre <= d, with d = bf16(next_above(-b) + b):
// pre(-b) is a zero of either sign and pre(next_above(-b)) is d; an r below
// -b gives pre < 0 (a nonzero sum of bf16 values does not round to zero), and
// an r above next_above(-b) gives pre >= 1.5 d (d is the spacing of bf16 at
// -b, a power of two, and the spacing next to it is at least d / 2). A zero
// standing for both zeros: -0 >= 0 as floats. The plain version's CPU test
// holds this form to `tie_mask` over every bf16 value.

// d of a bias b (bf16 bits)
__device__ __forceinline__ bf16 tie_ceiling(uint16_t bb) {
  const uint16_t above = next_above(bb ^ 0x8000u);
  return __float2bfloat16_rn(__bfloat162float(__ushort_as_bfloat16(above)) +
                             __bfloat162float(__ushort_as_bfloat16(bb)));
}

// pre = bf16(r + b) of two values
__device__ __forceinline__ __nv_bfloat162 pre_bias2(__nv_bfloat162 r, __nv_bfloat162 b) {
  return __hadd2(r, b);
}

// nonzero in each half whose value is a tie (0 <= pre <= d)
__device__ __forceinline__ uint32_t ties2(__nv_bfloat162 pre, __nv_bfloat162 d) {
  const __nv_bfloat162 ge = __hge2(pre, __float2bfloat162_rn(0.f));
  const __nv_bfloat162 le = __hle2(pre, d);
  return *reinterpret_cast<const uint32_t*>(&ge) & *reinterpret_cast<const uint32_t*>(&le);
}

// relu(pre) of two values that are not ties: pre is nonzero there (or NaN), so
// the max with +0 gives positive zero below, as `finish` does
__device__ __forceinline__ __nv_bfloat162 relu2(__nv_bfloat162 pre) {
  return __hmax2(pre, __float2bfloat162_rn(0.f));
}

}  // namespace relu_ties
