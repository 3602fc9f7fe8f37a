// In-place row subtract, for Hopper (sm_90a):
//
//   table[ids[j], :] -= updates[j, :]      for every j with 0 <= ids[j] < N
//
// Replaces the Pallas TPU kernel `_apply_kernel` / `pallas_row_subtract` in
// two_tower_recommender_model_tpu/ops/pallas_update.py (kernel #7), the row
// apply of the sparse row-wise Adagrad: its ring of row DMAs between HBM and
// VMEM was the TPU's way to a read-modify-write of scattered rows and is not
// carried over.
//
// Contract:
//   - table: [N, D] f32, updated in place; ids: [M] int32 in any order, ids
//     outside [0, N) skipped (neither read nor written); updates: [M, D] f32;
//   - the LIVE IDS MUST BE DISTINCT. Each position's warp reads, subtracts
//     and writes its row without atomics, so two positions naming one row
//     would race. The one caller (train/optimizer.py:
//     pallas_sparse_rowwise_adagrad) passes one id per segment of equal ids,
//     which are distinct by construction. With distinct ids the result is
//     deterministic and equals one f32 subtraction per element;
//   - any D >= 1: 16-byte loads and stores where D % 4 == 0 and table and
//     updates are 16-byte aligned, else one element a lane.
//
// What bounds it: memory: a live position reads its update row and reads and
// writes its table row, 12 D bytes against D subtractions. The design: one
// warp per position, 16-byte loads and stores, a whole D = 128 row per warp
// access.
//
// Binding: a plain C interface loaded with ctypes. The launch goes to the
// caller's stream, does not synchronise, allocates nothing, and the entry
// point returns cudaGetLastError() right after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// V = 4: a float4 a lane; V = 1: one element a lane (any D, any alignment).
template <int V>
__global__ void __launch_bounds__(kThreads)
row_subtract_kernel(float* __restrict__ table, const int32_t* __restrict__ ids,
                    const float* __restrict__ updates, int64_t n_rows, int64_t d, int64_t m) {
  const int lane = threadIdx.x & 31;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= m) return;
  const int32_t r = __ldg(ids + j);
  if (r < 0 || r >= n_rows) return;  // sentinel: skipped
  float* trow = table + static_cast<int64_t>(r) * d;
  const float* urow = updates + j * d;
  for (int64_t col = lane * V; col < d; col += 32 * V) {
    if constexpr (V == 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(urow + col));
      float4 t = *reinterpret_cast<float4*>(trow + col);
      t.x -= u.x;
      t.y -= u.y;
      t.z -= u.z;
      t.w -= u.w;
      *reinterpret_cast<float4*>(trow + col) = t;
    } else {
      trow[col] -= __ldg(urow + col);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch.
int ttrm_row_subtract(void* table, const void* ids, const void* updates, int64_t n_rows,
                      int64_t d, int64_t m, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (d <= 0 || m > static_cast<int64_t>(0x7fffffff) * kWarpsPerBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((m + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const auto s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* u = static_cast<const float*>(updates);
  const bool four = d % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(updates) % 16 == 0;
  if (four)
    row_subtract_kernel<4><<<grid, kThreads, 0, s>>>(t, i, u, n_rows, d, m);
  else
    row_subtract_kernel<1><<<grid, kThreads, 0, s>>>(t, i, u, n_rows, d, m);
  return static_cast<int>(cudaGetLastError());
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
