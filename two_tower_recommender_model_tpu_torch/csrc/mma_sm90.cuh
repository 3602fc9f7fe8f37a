// PTX helpers for the tensor-core kernels of this package (sm_90a): 16-byte
// asynchronous copies into shared memory, ldmatrix fragment loads and the
// m16n8k16 bf16 x bf16 -> f32 mma.sync. Shared by tower_bwd.cu (kernel #8)
// and softmax_lse.cu (kernels #10 and #11).
//
// Fragments of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4), from the PTX
// ISA's tables:
//   A (16 x 16, row): a[0] = rows g, columns 2t, 2t + 1; a[1] = rows g + 8,
//     the same columns; a[2], a[3] = the same rows at columns 2t + 8, 2t + 9.
//     Each register holds two bf16 values, the lower column in the low half.
//   B (16 x 8, col): b0 = rows (k) 2t, 2t + 1 of column g; b1 = rows 2t + 8,
//     2t + 9 of column g.
//   C, D (16 x 8, f32): d[0], d[1] = row g, columns 2t, 2t + 1; d[2], d[3] =
//     row g + 8, the same columns.
// So the accumulators of two neighbouring n8 blocks (columns 16k .. 16k + 15),
// each pair rounded to bf16 and packed, are the A fragment of a product that
// contracts over those 16 columns: (d0 d1 | d2 d3) of the first block are
// a[0] | a[1], those of the second a[2] | a[3].

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, not through L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 and packed: lo in the low half, as an A fragment wants it
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma_sm90
