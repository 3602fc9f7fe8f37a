// Tensor maps for the TMA, shared by softmax_lse.cu (kernels #9-#11 at a
// wide D), tower_fwd.cu (the fused tower's forward) and tower_bwd.cu (its
// backward, #8): cuTensorMapEncodeTiled, fetched through the runtime's
// entry-point query (no -lcuda), and the map of a row-major bf16 or f32
// matrix in boxes 128 bytes wide (64 bf16 or 32 f32 values) with the
// 128-byte swizzle, the layout that wgmma_sm90.cuh's swizzled descriptors
// read and that a TMA store writes back from.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma_map {

constexpr int kBoxCols = 64;  // a box's inner extent: one 128-byte swizzled row of bf16

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A tensor map of a row-major matrix [outer, inner] of `elem_bytes`-byte
// values in boxes of [box_outer, 128 / elem_bytes] with the 128-byte
// swizzle; false if it cannot be encoded
inline bool swizzled_map(CUtensorMap* m, CUtensorMapDataType type, int elem_bytes,
                         const void* base, int64_t inner, int64_t outer, int box_outer) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem_bytes),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(m, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map of a row-major bf16 matrix [outer, inner] in boxes of
// [box_outer, 64] with the 128-byte swizzle; false if it cannot be encoded
inline bool bf16_map(CUtensorMap* m, const void* base, int64_t inner, int64_t outer,
                     int box_outer) {
  return swizzled_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, inner, outer, box_outer);
}

}  // namespace tma_map
