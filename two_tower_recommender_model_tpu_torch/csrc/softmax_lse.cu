// Fused in-batch sampled-softmax kernels for Hopper (sm_90a): the per-row
// logsumexp of the adjusted score matrix and its two gradients, without the
// [BQ, BK] scores ever reaching device memory.
//
//   s_ij  = (q_i . c_j) * (1/T) - adj_j         q, c bf16 values, f32 sums
//   s_ij  = -1e9  where row_ids_i == col_ids_j and (row_offset + i) != j
//   lse_i = log sum_j exp(s_ij)                  online: running max from -1e9
//   p_ij  = bf16(exp(s_ij - lse_i) * g_i)        rounded before the 2nd product
//   dq_i  = (1/T) * sum_j p_ij c_j               f32 sums
//   dc_j  = (1/T) * sum_i p_ij q_i
//
// Replaces three Pallas TPU kernels of
// two_tower_recommender_model_tpu/ops/softmax_kernel.py: `_fwd_kernel`
// (kernel #9, called from `_lse_fwd_impl`), `_dq_kernel` (#10) and
// `_dc_kernel` (#11, both called from `_lse_bwd`), with their rounding
// points: q and c arrive rounded to bf16 once, every product of a score is
// bf16 x bf16 summed in f32, the score is multiplied by 1/T and then `adj`
// (logQ plus 1e9 on padded columns, merged by the wrapper) is subtracted,
// then the duplicate mask sets -1e9; p is rounded to bf16 before the second
// product, whose f32 sum is multiplied by 1/T once at the end. The positive
// score s_i,pos stays outside, in the wrapper's plain PyTorch.
//
// Not carried over from the TPU: the 128-lane padding of D, the [B, 128]
// broadcast of per-row scalars, ids compared as f32, the preloaded column
// index row, the (1024, 512) blocks, the pre-transposed c and the sequential
// grid axis that carried the running max / sum / accumulator in VMEM.
//
// Contract: q [BQ, DP] and c [BK, DP] bf16, row-major, DP 64 or 128 (the
// wrapper zero-pads D); BQ and BK multiples of 128; adj [BK] f32 or null;
// row_ids [BQ] and col_ids [BK] int32, both or neither; lse, g [BQ] f32;
// outputs f32. q row i has global row index row_offset + i, the column of its
// positive, so one stripe of a data-parallel split runs the same kernel.
//
// What bounds it: arithmetic. The forward does 2*BQ*BK*D FLOPs and one exp
// per score, each backward 4*BQ*BK*D, against BQ*D + BK*D bf16 values read
// (8.6 / 17 / 17 GFLOP against 2 MB at B = 8,192, D = 64). This first version
// does the products on the CUDA cores (fmaf on bf16 values widened to f32),
// which keeps the rounding points exact and the code simple; the tensor cores
// (mma.sync, then wgmma with TMA loads) are later work.
//   - A block owns a tile of TO rows of one operand (q rows for the forward
//     and dq, c rows for dc), holds it in shared memory as f32 for the whole
//     kernel, and itself loops over the other operand in tiles of 128 rows:
//     the loop takes the place of the TPU's sequential grid axis. The running
//     max and sum (forward) or the [TO, D] accumulator (backward) stay in
//     registers, so blocks share nothing: no atomics, no second pass, and the
//     result does not depend on the order blocks run in.
//   - 256 threads as 16 x 16: a thread computes TO/16 x 8 scores from float4
//     reads of the two shared-memory operands (a broadcast for the own rows,
//     contiguous for the streamed columns), applies the adjustments, and for
//     the backward writes its p values to shared memory as bf16, from where
//     the second product reads them.
//   - dq and dc are one kernel with the operands' roles swapped: the score is
//     symmetric in them, and both second products contract over the streamed
//     rows.
//   - Occupancy: the grid has N_own / TO blocks. At B = 8,192 a tile of 128
//     rows gives 64 blocks for 132 SMs, so the wrapper asks for TO = 64 (128
//     blocks) until N_own / 128 reaches the SM count; at B = 65,536 it is 512
//     blocks of 128 rows.
//   - exp(-1e9 - lse) is exactly 0 in f32, and a tile whose every score is
//     -1e9 leaves the running max at -1e9 (exp(m_old - m_new) = 1), so a fully
//     masked row gives the finite lse the reference gives.
//
// Binding: a plain C interface loaded with ctypes. Each launch goes to the
// caller's stream, does not synchronise and allocates nothing; each entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 (ty: own rows) x 16 (tx: streamed columns, D columns)
constexpr int kTile = 128;      // streamed rows per tile
constexpr int kChunk = 32;      // depth (scores) or rows (second product) per shared-memory chunk
constexpr int kBufFloats = kChunk * 128;  // the streamed chunk's buffer: 16 KB
constexpr float kNeg = -1e9f;

struct Args {
  const uint16_t* q;    // [BQ, DP] bf16
  const uint16_t* c;    // [BK, DP] bf16
  const float* adj;     // [BK] or null
  const int* row_ids;   // [BQ] or null
  const int* col_ids;   // [BK] or null
  const float* lse;     // [BQ], backward only
  const float* g;       // [BQ], backward only
  float* out;           // forward: lse [BQ]; backward: dq [BQ, DP] or dc [BK, DP]
  int bq, bk, row_offset;
  float inv_t;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// column of the 128-wide streamed tile that a thread's j-th score belongs to:
// two groups of four, 64 apart, so neighbouring threads read neighbouring float4s
__device__ __forceinline__ int col_of(int tx, int j) { return (j >> 2) * 64 + tx * 4 + (j & 3); }

// The block's own tile [TO, DP] bf16 -> shared memory As[k][r] f32 (depth-major).
template <int DP, int TO>
__device__ __forceinline__ void load_own(const uint16_t* __restrict__ tile, float* As) {
  for (int idx = threadIdx.x; idx < TO * DP / 8; idx += kThreads) {
    const int r = idx % TO, kg = idx / TO;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(tile + static_cast<size_t>(r) * DP + kg * 8));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      As[(kg * 8 + 2 * e) * TO + r] = bf16_lo(w[e]);
      As[(kg * 8 + 2 * e + 1) * TO + r] = bf16_hi(w[e]);
    }
  }
}

// Depths [k0, k0 + 32) of a streamed tile [128, DP] bf16 -> Bs[k][col] f32.
template <int DP>
__device__ __forceinline__ void load_chunk_transposed(const uint16_t* __restrict__ tile, int k0,
                                                      float* Bs) {
  const int col = threadIdx.x & 127, half = threadIdx.x >> 7;
  const uint4* p =
      reinterpret_cast<const uint4*>(tile + static_cast<size_t>(col) * DP + k0 + half * 16);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 v = __ldg(p + h);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      Bs[(half * 16 + h * 8 + 2 * e) * kTile + col] = bf16_lo(w[e]);
      Bs[(half * 16 + h * 8 + 2 * e + 1) * kTile + col] = bf16_hi(w[e]);
    }
  }
}

// Rows [j0, j0 + 32) of a streamed tile [128, DP] bf16 -> Bs[j][d] f32 (a
// contiguous block of memory, copied in order).
template <int DP>
__device__ __forceinline__ void load_rows(const uint16_t* __restrict__ tile, int j0, float* Bs) {
  const uint4* p = reinterpret_cast<const uint4*>(tile + static_cast<size_t>(j0) * DP);
  for (int v = threadIdx.x; v < kChunk * DP / 8; v += kThreads) {
    const uint4 u = __ldg(p + v);
    float4* dst = reinterpret_cast<float4*>(Bs + v * 8);
    dst[0] = make_float4(bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y), bf16_hi(u.y));
    dst[1] = make_float4(bf16_lo(u.z), bf16_hi(u.z), bf16_lo(u.w), bf16_hi(u.w));
  }
}

// acc[i][j] = sum_k own[ty * RI + i][k] * tile[col_of(tx, j)][k], k in order.
template <int DP, int TO>
__device__ __forceinline__ void dot_tile(const float* As, float* Bs,
                                         const uint16_t* __restrict__ tile,
                                         float (&acc)[TO / 16][8]) {
  constexpr int RI = TO / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < DP; k0 += kChunk) {
    __syncthreads();  // the buffer's last readers are done (and the own tile is loaded)
    load_chunk_transposed<DP>(tile, k0, Bs);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float a[RI], b[8];
#pragma unroll
      for (int v = 0; v < RI / 4; ++v) {
        const float4 t = *reinterpret_cast<const float4*>(As + (k0 + k) * TO + ty * RI + v * 4);
        a[v * 4] = t.x, a[v * 4 + 1] = t.y, a[v * 4 + 2] = t.z, a[v * 4 + 3] = t.w;
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float4 t = *reinterpret_cast<const float4*>(Bs + k * kTile + v * 64 + tx * 4);
        b[v * 4] = t.x, b[v * 4 + 1] = t.y, b[v * 4 + 2] = t.z, b[v * 4 + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// The adjusted score from the raw dot product: times 1/T, minus adj, then the
// duplicate mask. Separate roundings, as the reference's three steps.
__device__ __forceinline__ float adjust(float dot, float inv_t, float adj, bool use_ids, int id_a,
                                        int id_b, int pos_a, int pos_b) {
  float s = __fsub_rn(__fmul_rn(dot, inv_t), adj);
  if (use_ids && id_a == id_b && pos_a != pos_b) s = kNeg;
  return s;
}

// Kernel #9: lse[i] for the block's TO q rows, streaming c.
template <int DP, int TO>
__global__ void __launch_bounds__(kThreads) lse_fwd_kernel(const Args a) {
  constexpr int RI = TO / 16;
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + DP * TO;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int own0 = blockIdx.x * TO;
  const bool use_ids = a.row_ids != nullptr;
  load_own<DP, TO>(a.q + static_cast<size_t>(own0) * DP, As);

  int rid[RI], rpos[RI];
  float m[RI], l[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = own0 + ty * RI + i;
    rid[i] = use_ids ? __ldg(a.row_ids + r) : 0;
    rpos[i] = a.row_offset + r;
    m[i] = kNeg;
    l[i] = 0.f;
  }

  for (int t0 = 0; t0 < a.bk; t0 += kTile) {
    float acc[RI][8];
    dot_tile<DP, TO>(As, Bs, a.c + static_cast<size_t>(t0) * DP, acc);
    float cadj[8];
    int cid[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = t0 + col_of(tx, j);
      cadj[j] = a.adj != nullptr ? __ldg(a.adj + k) : 0.f;
      cid[j] = use_ids ? __ldg(a.col_ids + k) : 0;
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float s[8];
      float mt = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = adjust(acc[i][j], a.inv_t, cadj[j], use_ids, rid[i], cid[j], rpos[i],
                      t0 + col_of(tx, j));
        mt = fmaxf(mt, s[j]);
      }
      // the 16 threads of one ty are 16 neighbouring lanes of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += expf(s[j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum;  // this thread's share of the row's sum
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0) a.out[own0 + ty * RI + i] = m[i] + logf(sum);
  }
}

// Kernels #10 (OWN_Q: dq for the block's q rows, streaming c) and #11 (dc for
// the block's c rows, streaming q).
template <int DP, int TO, bool OWN_Q>
__global__ void __launch_bounds__(kThreads) lse_bwd_kernel(const Args a) {
  constexpr int RI = TO / 16;
  constexpr int W = DP / 16;     // D columns per thread in the second product
  constexpr int PSB = TO + 8;    // row stride of Ps, in bf16 values
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);
  float* Bs = As + DP * TO;
  uint16_t* Ps = reinterpret_cast<uint16_t*>(Bs + kBufFloats);  // [128][PSB]: p by streamed row
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int own0 = blockIdx.x * TO;
  const bool use_ids = a.row_ids != nullptr;
  const uint16_t* own = OWN_Q ? a.q : a.c;
  const uint16_t* other = OWN_Q ? a.c : a.q;
  const int n_other = OWN_Q ? a.bk : a.bq;
  load_own<DP, TO>(own + static_cast<size_t>(own0) * DP, As);

  // per own row: its id and global position, and lse and g (a q row) or adj (a c row)
  int own_id[RI], own_pos[RI];
  float own_x[RI], own_g[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = own0 + ty * RI + i;
    if (OWN_Q) {
      own_id[i] = use_ids ? __ldg(a.row_ids + r) : 0;
      own_pos[i] = a.row_offset + r;
      own_x[i] = __ldg(a.lse + r);
      own_g[i] = __ldg(a.g + r);
    } else {
      own_id[i] = use_ids ? __ldg(a.col_ids + r) : 0;
      own_pos[i] = r;
      own_x[i] = a.adj != nullptr ? __ldg(a.adj + r) : 0.f;
      own_g[i] = 1.f;
    }
  }
  float acc2[RI][W];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int w = 0; w < W; ++w) acc2[i][w] = 0.f;

  for (int t0 = 0; t0 < n_other; t0 += kTile) {
    const uint16_t* tile = other + static_cast<size_t>(t0) * DP;
    float acc[RI][8];
    dot_tile<DP, TO>(As, Bs, tile, acc);
    // every thread is past the last tile's second product here (dot_tile synchronises)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = t0 + col_of(tx, j);
      int oth_id, oth_pos;
      float oth_x, oth_g;
      if (OWN_Q) {
        oth_id = use_ids ? __ldg(a.col_ids + o) : 0;
        oth_pos = o;
        oth_x = a.adj != nullptr ? __ldg(a.adj + o) : 0.f;
        oth_g = 1.f;
      } else {
        oth_id = use_ids ? __ldg(a.row_ids + o) : 0;
        oth_pos = a.row_offset + o;
        oth_x = __ldg(a.lse + o);
        oth_g = __ldg(a.g + o);
      }
      uint32_t pb[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float s = adjust(acc[i][j], a.inv_t, OWN_Q ? oth_x : own_x[i], use_ids, own_id[i],
                               oth_id, own_pos[i], oth_pos);
        const float lse = OWN_Q ? own_x[i] : oth_x;
        const float g = OWN_Q ? own_g[i] : oth_g;
        pb[i] = bf16_bits(__fmul_rn(expf(s - lse), g));
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(Ps + col_of(tx, j) * PSB + ty * RI);
#pragma unroll
      for (int v = 0; v < RI / 2; ++v) dst[v] = pb[2 * v] | (pb[2 * v + 1] << 16);
    }
    for (int j0 = 0; j0 < kTile; j0 += kChunk) {
      __syncthreads();  // Ps is whole, and the buffer's last readers are done
      load_rows<DP>(tile, j0, Bs);
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kChunk; ++jj) {
        const uint32_t* src =
            reinterpret_cast<const uint32_t*>(Ps + (j0 + jj) * PSB + ty * RI);
        float p[RI];
#pragma unroll
        for (int v = 0; v < RI / 2; ++v) {
          const uint32_t u = src[v];
          p[2 * v] = bf16_lo(u);
          p[2 * v + 1] = bf16_hi(u);
        }
#pragma unroll
        for (int v = 0; v < W / 4; ++v) {
          const float4 t = *reinterpret_cast<const float4*>(Bs + jj * DP + v * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc2[i][v * 4] = fmaf(p[i], t.x, acc2[i][v * 4]);
            acc2[i][v * 4 + 1] = fmaf(p[i], t.y, acc2[i][v * 4 + 1]);
            acc2[i][v * 4 + 2] = fmaf(p[i], t.z, acc2[i][v * 4 + 2]);
            acc2[i][v * 4 + 3] = fmaf(p[i], t.w, acc2[i][v * 4 + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    float* row = a.out + static_cast<size_t>(own0 + ty * RI + i) * DP;
#pragma unroll
    for (int v = 0; v < W / 4; ++v)
      *reinterpret_cast<float4*>(row + v * 64 + tx * 4) =
          make_float4(acc2[i][v * 4] * a.inv_t, acc2[i][v * 4 + 1] * a.inv_t,
                      acc2[i][v * 4 + 2] * a.inv_t, acc2[i][v * 4 + 3] * a.inv_t);
  }
}

template <typename K>
int launch(K kernel, const Args& a, int n_own, int tile_own, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_own / tile_own, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

constexpr size_t fwd_smem(int dp, int to) { return (static_cast<size_t>(dp) * to + kBufFloats) * 4; }
constexpr size_t bwd_smem(int dp, int to) { return fwd_smem(dp, to) + kTile * (to + 8) * 2; }

bool shapes_ok(int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, int64_t tile_own) {
  return bq > 0 && bk > 0 && bq % kTile == 0 && bk % kTile == 0 && bk < (1LL << 30) &&
         (dp == 64 || dp == 128) && row_offset >= 0 && row_offset + bq <= bk &&
         (tile_own == 64 || tile_own == 128);
}

Args make_args(const void* q, const void* c, const void* adj, const void* row_ids,
               const void* col_ids, const void* lse, const void* g, void* out, int64_t bq,
               int64_t bk, int64_t row_offset, float inv_t) {
  Args a;
  a.q = static_cast<const uint16_t*>(q);
  a.c = static_cast<const uint16_t*>(c);
  a.adj = static_cast<const float*>(adj);
  a.row_ids = static_cast<const int*>(row_ids);
  a.col_ids = static_cast<const int*>(col_ids);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.out = static_cast<float*>(out);
  a.bq = static_cast<int>(bq);
  a.bk = static_cast<int>(bk);
  a.row_offset = static_cast<int>(row_offset);
  a.inv_t = inv_t;
  return a;
}

template <bool OWN_Q>
int launch_bwd(const Args& a, int64_t dp, int64_t tile_own, cudaStream_t s) {
  const int n_own = OWN_Q ? a.bq : a.bk;
  if (dp == 64 && tile_own == 64)
    return launch(lse_bwd_kernel<64, 64, OWN_Q>, a, n_own, 64, bwd_smem(64, 64), s);
  if (dp == 64)
    return launch(lse_bwd_kernel<64, 128, OWN_Q>, a, n_own, 128, bwd_smem(64, 128), s);
  if (tile_own == 64)
    return launch(lse_bwd_kernel<128, 64, OWN_Q>, a, n_own, 64, bwd_smem(128, 64), s);
  return launch(lse_bwd_kernel<128, 128, OWN_Q>, a, n_own, 128, bwd_smem(128, 128), s);
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code: 0 when the launch succeeded.
// adj may be null; row_ids and col_ids are both null or both set. tile_own is
// the rows of the own operand per block, 64 or 128.

int ttrm_softmax_lse_fwd(const void* q, const void* c, const void* adj, const void* row_ids,
                         const void* col_ids, void* lse_out, int64_t bq, int64_t bk, int64_t dp,
                         int64_t row_offset, float inv_t, int64_t tile_own, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, tile_own) || (row_ids == nullptr) != (col_ids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, nullptr, nullptr, lse_out, bq, bk,
                           row_offset, inv_t);
  const auto s = static_cast<cudaStream_t>(stream);
  if (dp == 64 && tile_own == 64)
    return launch(lse_fwd_kernel<64, 64>, a, a.bq, 64, fwd_smem(64, 64), s);
  if (dp == 64) return launch(lse_fwd_kernel<64, 128>, a, a.bq, 128, fwd_smem(64, 128), s);
  if (tile_own == 64) return launch(lse_fwd_kernel<128, 64>, a, a.bq, 64, fwd_smem(128, 64), s);
  return launch(lse_fwd_kernel<128, 128>, a, a.bq, 128, fwd_smem(128, 128), s);
}

int ttrm_softmax_lse_dq(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dq_out,
                        int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, float inv_t,
                        int64_t tile_own, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, tile_own) || (row_ids == nullptr) != (col_ids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dq_out, bq, bk, row_offset, inv_t);
  return launch_bwd<true>(a, dp, tile_own, static_cast<cudaStream_t>(stream));
}

int ttrm_softmax_lse_dc(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dc_out,
                        int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, float inv_t,
                        int64_t tile_own, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, tile_own) || (row_ids == nullptr) != (col_ids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dc_out, bq, bk, row_offset, inv_t);
  return launch_bwd<false>(a, dp, tile_own, static_cast<cudaStream_t>(stream));
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
