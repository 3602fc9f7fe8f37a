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
// outputs f32; every pointer 16-byte aligned. q row i has global row index
// row_offset + i, the column of its positive, so one stripe of a
// data-parallel split runs the same kernel.
//
// What bounds them: the forward does 2*BQ*BK*D FLOPs, each backward
// 4*BQ*BK*D, against BQ*D + BK*D bf16 values read (8.6 / 17 / 17 GFLOP
// against 2 MB at B = 8,192, D = 64: 0.0087 / 0.0174 / 0.0174 ms at the
// tensor cores' 989 TFLOP/s). Each takes one exp per score besides, at the
// special-function units' 16 a clock per SM (about 0.016 ms for the 67M
// scores at 8,192^2), and ~10 (forward) to ~15 (backward) instructions a
// score of the adjustment and the epilogue at 128 a clock per SM (~0.02 to
// 0.04 ms): they, not the products, set the time.
//
// The three kernels share one skeleton (`stream_tiles`) and one score
// product (`score_tile`, then `adjust_tile`), on the tensor cores
// (mma.sync.m16n8k16, bf16 x bf16 -> f32, mma_sm90.cuh):
//   - A block owns 64 rows of one operand (q rows for #9 and #10, c rows for
//     #11) and streams the other in tiles of 64 rows. Its warps form NG
//     groups of 4; group k takes the tiles k, k + NG, k + 2 NG, ..., and each
//     warp of a group owns 16 own rows, which it holds as mma A fragments in
//     registers, loaded once with ldmatrix from a bf16 copy in shared memory.
//   - Each group double-buffers its tiles (bf16 rows and the per-row scalars
//     the epilogue needs: adj and ids of c rows; lse, g and ids of q rows)
//     with cp.async: the next tile is in flight while the current one is
//     computed, and a group waits only on its own named barrier. Rows are
//     padded by 8 bf16 values (144 or 272 bytes), so the 8 row addresses of
//     an ldmatrix fall on 8 different 16-byte bank groups.
//   - The score product: a warp's 16 x 64 scores of a tile are 8 n8 blocks
//     of accumulators (32 registers a thread); the tile's rows are the B
//     operand, read with ldmatrix (a row-major [rows, D] tile is B^T in the
//     .col layout). Each mma sums 16 products of the depth; the DP / 16
//     chunks are added in order.
//   - The adjustment works on the accumulator fragment in registers: 1/T and
//     adj with separate roundings (__fmul_rn, __fsub_rn), then the duplicate
//     mask on the fragment's global row and column.
//   - No atomics and no order between blocks: two launches agree bit for
//     bit. The split of the streamed range follows the tile index alone, so
//     a row's result is the same in a stripe (any BQ, row_offset) as in the
//     square case.
//   - Occupancy: 64 own rows give 128 blocks at B = 8,192 (one per SM) and
//     1,024 at 65,536; the groups and the 8 independent n8 chains of each
//     product hide ldmatrix, mma and exp latency.
//
// Kernel #9 (lse_fwd_kernel): the online max and sum on the score fragments.
//   - A thread holds 2 own rows x 16 columns of each tile. The tile's row max
//     is the max of the thread's 16 scores, then of its quad's (the 4 lanes
//     of a row, shfl_xor 1, 2); the running max m starts at -1e9 and l is
//     rescaled by exp(m_old - m_new) before the tile's 16 exps are added in
//     column order. The exp is ex2.approx of the prescaled argument, as in
//     the backward's p.
//   - At the end the quad's four l are added (shfl_xor 1, 2), the groups'
//     (m, l) are merged through shared memory in group order (M = max m_k,
//     L = sum_k l_k exp(m_k - M)), and lse = M + log(L).
//   - exp(-1e9 - m) is exactly 0 in f32, and a tile whose every score is
//     -1e9 leaves the running max at -1e9 (exp(m_old - m_new) = 1), so a
//     fully masked row gives the finite lse the reference gives.
//   - 4 groups (16 warps) at both DP: the forward keeps no [16, DP]
//     accumulator beside the scores, so a thread's registers fit 128.
//   - No tie repair: lse is not rounded to bf16, and it sits a few f32 ulps
//     from the plain version's, far inside the backward's tie window.
//
// Kernels #10 and #11 (lse_bwd_kernel<DP, OWN_Q>): dq and dc are one kernel
// with the operands' roles swapped (the score is symmetric in them, and both
// second products contract over the streamed rows). 4 groups at DP = 64, 2 at
// DP = 128 (each warp also holds its [16, DP] of dq or dc in registers).
//   - The epilogue: exp(s - lse) * g on the adjusted fragment, then the bf16
//     rounding, two values packed per register. Those registers ARE the
//     second product's A fragments (mma_sm90.cuh), so p never goes through
//     memory.
//   - Ties: the tensor cores sum a score in another order than an f32 GEMM,
//     and a p whose f32 value lies near a bf16 rounding midpoint then rounds
//     to the other neighbour, which moves a row's gradient by up to 2^-7 of
//     its largest p. The epilogue marks such p of weight in a bit mask (a
//     small share of the scores) and computes them again as the plain
//     version does: the score summed in k order on the CUDA cores, and expf
//     (`near_tie`, `ordered_dot`). The window (1/8 of a bf16 ulp) is far
//     wider than what either the order or ex2.approx moves p by, so every p
//     of weight rounds as the plain version's and the host's.
//   - The second product reads the same shared-memory tile with
//     ldmatrix.trans as its B operand (c rows for dq, q rows for dc) and
//     accumulates a warp's [16, DP] of dq or dc in f32 registers across the
//     group's whole range.
//   - At the end groups 1 .. NG-1 write their partial sums to shared memory
//     and group 0 adds them to its own in group order, times 1/T once. Four
//     groups instead of two took #10 from 0.150 to 0.123 ms at 8,192^2 on an
//     H100, and ex2.approx instead of expf to 0.107.
// Left for later: wgmma with TMA loads (warp-specialised producers), warps
// that own 32 rows (half the ldmatrix traffic: each tile is read twice by
// each warp of a group, 8 MB per SM at 8,192^2), fewer instructions in the
// epilogue (the mask per 8 columns), and one barrier a tile instead of two.
//
// Binding: a plain C interface loaded with ctypes. Each launch goes to the
// caller's stream, does not synchronise and allocates nothing; each entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e9f;
constexpr float kLog2e = 1.44269504088896341f;
constexpr int kRowMultiple = 128;   // BQ and BK are multiples of it (the reference's rule)
constexpr int kOwn = 64;            // own rows per block: 4 warps x 16
constexpr int kSub = 64;            // streamed rows per tile
constexpr int kGroupThreads = 128;  // a warp group: 4 warps, 64 own rows
constexpr int kFwdGroups = 4;       // the forward's warp groups (16 warps)

// The backward's warp groups: 4 (16 warps) where a thread's registers fit 128
// (DP = 64), else 2.
template <int DP>
__host__ __device__ constexpr int bwd_groups() { return DP == 64 ? 4 : 2; }

// The bf16 row stride of a tile in shared memory: rows padded by 8 values.
template <int DP>
__host__ __device__ constexpr int tile_ld() { return DP + 8; }

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

// exp(x) as ex2.approx of x * log2(e): two instructions where expf takes about
// eight, and within a few f32 ulps of expf
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

// Shared-memory layout (byte offsets) of a kernel with NG warp groups.
template <int DP, int NG>
struct Layout {
  static constexpr int LD = tile_ld<DP>();
  static constexpr int RLD = DP + 8;  // f32 row stride of the backward's partial sums
  static constexpr int tile_elems = kSub * LD;
  static constexpr int scal_floats = 3 * kSub;  // adj or lse, g, ids of one tile
  static constexpr size_t own = 0;                                        // [64][LD] bf16
  static constexpr size_t stream = own + size_t(kOwn) * LD * 2;           // [group][stage] tiles
  static constexpr size_t scal = stream + size_t(NG) * 2 * tile_elems * 2;
  static constexpr size_t bytes = scal + size_t(NG) * 2 * scal_floats * 4;
};

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kGroupThreads) : "memory");
}

// The adjusted score from the raw dot product: times 1/T, minus adj (the
// reference's separate roundings), then the duplicate mask.
__device__ __forceinline__ float adjusted_score(float dot, float inv_t, float adj, bool masked) {
  return masked ? kNeg : __fsub_rn(__fmul_rn(dot, inv_t), adj);
}

// The own rows of a thread's fragment (rows g and g + 8 of its warp's 16):
// id and global position; lse and g of a q row (backward), adj of a c row.
struct OwnRows {
  int id[2], pos[2];
  float x[2], g[2];
};

template <bool OWN_Q, bool BWD>
__device__ __forceinline__ OwnRows load_own_rows(const Args& a, int r0, bool use_ids) {
  OwnRows o;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (OWN_Q) {
      o.id[h] = use_ids ? __ldg(a.row_ids + r) : 0;
      o.pos[h] = a.row_offset + r;
      o.x[h] = BWD ? __ldg(a.lse + r) : 0.f;
      o.g[h] = BWD ? __ldg(a.g + r) : 1.f;
    } else {
      o.id[h] = use_ids ? __ldg(a.col_ids + r) : 0;
      o.pos[h] = r;
      o.x[h] = a.adj != nullptr ? __ldg(a.adj + r) : 0.f;
      o.g[h] = 1.f;
    }
  }
  return o;
}

// One tile of the streamed operand (rows o0 .. o0 + 63) and its scalars into
// a stage: cp.async by the group's 128 threads (gt), not waited for here.
template <int DP, bool OWN_Q>
__device__ __forceinline__ void load_tile(const Args& a, const uint16_t* __restrict__ other,
                                          int o0, bf16* dst, float* sc, int gt, bool use_ids) {
  constexpr int LD = tile_ld<DP>(), V = DP / 8;  // 16-byte pieces of a row
#pragma unroll
  for (int idx = gt; idx < kSub * V; idx += kGroupThreads)
    cp_async16(dst + (idx / V) * LD + (idx % V) * 8,
               other + static_cast<size_t>(o0 + idx / V) * DP + (idx % V) * 8);
  // 16 pieces of 4 scalars per array: threads 0-15 the first, 16-31 the second, 32-47 ids
  const int part = gt >> 4, i4 = (gt & 15) * 4;
  const float* first = OWN_Q ? a.adj : a.lse;
  if (part == 0 && first != nullptr) cp_async16(sc + i4, first + o0 + i4);
  if (part == 1 && !OWN_Q) cp_async16(sc + kSub + i4, a.g + o0 + i4);
  if (part == 2 && use_ids)
    cp_async16(sc + 2 * kSub + i4, (OWN_Q ? a.col_ids : a.row_ids) + o0 + i4);
}

// The skeleton of the three kernels. Copies the block's 64 own rows to
// shared memory and the warp's 16 of them into the A fragments `af`, then
// walks the group's tiles (group, group + NG, ...) double-buffered by
// cp.async and calls body(tile, sc, o0) on each while the tile is whole in
// shared memory for every thread of the group: `tile` its bf16 rows, `sc`
// its scalars, `o0` its first streamed row. The tile buffers stay in use
// until every group is past its loop (the caller's __syncthreads()).
template <int DP, bool OWN_Q, int NG, typename Body>
__device__ __forceinline__ void stream_tiles(const Args& a, unsigned char* smem,
                                             uint32_t (&af)[DP / 16][4], Body&& body) {
  using L = Layout<DP, NG>;
  constexpr int LD = L::LD, KS = DP / 16, V = DP / 8;
  bf16* own_s = reinterpret_cast<bf16*>(smem + L::own);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2, wr = (warp & 3) * 16;  // the warp's first own row in the block
  const int gt = threadIdx.x & (kGroupThreads - 1);
  const int r8 = lane & 7, mat = lane >> 3;  // ldmatrix: row within a matrix, matrix
  const bool use_ids = a.row_ids != nullptr;
  const uint16_t* own = OWN_Q ? a.q : a.c;
  const uint16_t* other = OWN_Q ? a.c : a.q;
  const int own0 = blockIdx.x * kOwn;
  const int n_tiles = (OWN_Q ? a.bk : a.bq) / kSub;
  const int n_mine = (n_tiles - group + NG - 1) / NG;  // tiles of this group (may be 0)
  bf16* tiles = reinterpret_cast<bf16*>(smem + L::stream) + group * 2 * L::tile_elems;
  float* scal = reinterpret_cast<float*>(smem + L::scal) + group * 2 * L::scal_floats;

  for (int idx = threadIdx.x; idx < kOwn * V; idx += NG * kGroupThreads)
    cp_async16(own_s + (idx / V) * LD + (idx % V) * 8,
               own + static_cast<size_t>(own0 + idx / V) * DP + (idx % V) * 8);
  cp_async_commit();
  if (n_mine > 0) load_tile<DP, OWN_Q>(a, other, group * kSub, tiles, scal, gt, use_ids);
  cp_async_commit();  // (empty for a group without tiles: the wait below still counts it)
  if (OWN_Q && a.adj == nullptr)  // no adjustment: adj reads as 0 in both stages
    for (int i = gt; i < kSub; i += kGroupThreads) scal[i] = scal[L::scal_floats + i] = 0.f;
  cp_async_wait_one();  // the own tile has landed
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(af[ks], own_s + (wr + r8 + (mat & 1) * 8) * LD + ks * 16 + (mat >> 1) * 8);

  for (int it = 0; it < n_mine; ++it) {
    const int stage = it & 1;
    const int o0 = (group + NG * it) * kSub;  // the tile's first streamed row
    if (it + 1 < n_mine) {
      load_tile<DP, OWN_Q>(a, other, o0 + NG * kSub, tiles + (stage ^ 1) * L::tile_elems,
                           scal + (stage ^ 1) * L::scal_floats, gt, use_ids);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    group_sync(group);  // the tile is whole for every thread of the group
    body(static_cast<const bf16*>(tiles + stage * L::tile_elems),
         static_cast<const float*>(scal + stage * L::scal_floats), o0);
    group_sync(group);  // every thread of the group is done with this stage
  }
}

// The raw dot products of the warp's 16 own rows (A fragments af) with a
// tile's 64 streamed rows: s[n] is the 16 x 8 block of streamed rows 8n ..
// 8n + 7 (the accumulator layout of mma_sm90.cuh), each score the DP / 16
// 16-deep chunks added in order.
template <int DP>
__device__ __forceinline__ void score_tile(float (&s)[8][4], const uint32_t (&af)[DP / 16][4],
                                           const bf16* tile) {
  constexpr int LD = tile_ld<DP>();
  const int lane = threadIdx.x & 31, r8 = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];  // matrices (rows 8n, k), (8n, k + 8), (8n + 8, k), (8n + 8, k + 8)
      ldsm_x4(b, tile + (n * 8 + r8 + (mat >> 1) * 8) * LD + ks * 16 + (mat & 1) * 8);
      mma_bf16(s[n], af[ks], b[0], b[1]);
      mma_bf16(s[n + 1], af[ks], b[2], b[3]);
    }
}

// The raw dot products of score_tile -> the adjusted scores, in place:
// s[n][e] is own row g + 8 (e / 2) against streamed row 8n + 2t + (e % 2) of
// the tile at o0. adj comes from the tile's scalars where the streamed rows
// are c rows (OWN_Q), else from the own row; the streamed ids from `sc`.
template <bool OWN_Q>
__device__ __forceinline__ void adjust_tile(float (&s)[8][4], const float* sc, const OwnRows& own,
                                            int o0, const Args& a, bool use_ids) {
  const int t = threadIdx.x & 3;
  const int opos = (OWN_Q ? 0 : a.row_offset) + o0;  // global position of streamed row 0
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + 2 * t;
    const float2 adj = OWN_Q ? *reinterpret_cast<const float2*>(sc + c) : make_float2(0.f, 0.f);
    const int2 oid = use_ids ? *reinterpret_cast<const int2*>(sc + 2 * kSub + c) : make_int2(0, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, j = e & 1;
      const bool masked = use_ids && own.id[h] == (j ? oid.y : oid.x) && own.pos[h] != opos + c + j;
      s[n][e] = adjusted_score(s[n][e], a.inv_t, OWN_Q ? (j ? adj.y : adj.x) : own.x[h], masked);
    }
  }
}

// Kernel #9: lse for the block's 64 q rows, streaming c.
template <int DP>
__global__ void __launch_bounds__(kFwdGroups * kGroupThreads) lse_fwd_kernel(const Args a) {
  using L = Layout<DP, kFwdGroups>;
  static_assert(size_t(kFwdGroups) * kOwn * 2 * 4 <= L::scal - L::stream,
                "the groups' (m, l) fit the tile buffers");
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  const bool use_ids = a.row_ids != nullptr;
  const int own0 = blockIdx.x * kOwn;
  const OwnRows own = load_own_rows<true, false>(a, own0 + wr + g, use_ids);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8: running max, sum

  uint32_t af[DP / 16][4];
  stream_tiles<DP, true, kFwdGroups>(a, smem, af, [&](const bf16* tile, const float* sc, int o0) {
    float s[8][4];
    score_tile<DP>(s, af, tile);
    adjust_tile<true>(s, sc, own, o0, a, use_ids);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = kNeg;
#pragma unroll
      for (int n = 0; n < 8; ++n) mt = fmaxf(mt, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));  // the quad: the row's 64 columns
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h], mt);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sum += exp_approx(s[n][2 * h] - m_new);
        sum += exp_approx(s[n][2 * h + 1] - m_new);
      }
      l[h] = l[h] * exp_approx(m[h] - m_new) + sum;
      m[h] = m_new;
    }
  });

  // the quad's four sums of a row, then the groups' (m, l) merged in group order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // every group is past its tiles: the buffers are free
  float2* ml = reinterpret_cast<float2*>(smem + L::stream);  // [NG][64] (m, l)
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) ml[group * kOwn + wr + g + 8 * h] = make_float2(m[h], l[h]);
  }
  __syncthreads();
  if (threadIdx.x < kOwn) {
    float mx = kNeg;
#pragma unroll
    for (int k = 0; k < kFwdGroups; ++k) mx = fmaxf(mx, ml[k * kOwn + threadIdx.x].x);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kFwdGroups; ++k) {
      const float2 v = ml[k * kOwn + threadIdx.x];
      sum += v.y * expf(v.x - mx);
    }
    a.out[own0 + threadIdx.x] = mx + logf(sum);
  }
}

// ---- kernels #10 and #11 ------------------------------------------------------

// p before its bf16 rounding, from the adjusted score: exp(s - lse) (also
// returned in `ex`; ex2.approx of the prescaled argument, or expf as the
// plain version takes it), times g.
template <bool APPROX_EXP>
__device__ __forceinline__ float p_value(float s, float lse, float g, float& ex) {
  ex = APPROX_EXP ? exp_approx(s - lse) : expf(s - lse);
  return __fmul_rn(ex, g);
}

// Ties. The tensor cores sum a score in another order than an f32 GEMM (one
// fmaf per k, in k order, as the plain version's cuBLAS GEMM on the card
// does), a few f32 ulps apart. Where p's f32 value lies near the midpoint between two bf16
// values, the two orders round it to different neighbours: one bf16 ulp,
// 2^-8 to 2^-7 of p, and a row's largest p can carry most of its gradient.
// So a p of weight whose low 16 bits lie within kTieWindow f32 ulps of the
// midpoint (1/8 of a bf16 ulp; a few f32 ulps of a score near 30 move p by
// about a hundred, ex2.approx by a few) is computed again as the plain
// version computes it: its score summed in k order on the CUDA cores, expf.
// Below kTieFloor (exp(s - lse) < 2^-10) a flip moves a row of dq or dc by
// less than 2^-17 g x the streamed row, and is left as it falls.
constexpr uint32_t kTieWindow = 0x2000;
constexpr float kTieFloor = 0x1p-10f;

__device__ __forceinline__ bool near_tie(float p) {
  return ((__float_as_uint(p) - (0x8000u - kTieWindow)) & 0xffffu) <= 2 * kTieWindow;
}

// a . b over DP bf16 values in shared memory, one fmaf per k in k order
template <int DP>
__device__ float ordered_dot(const bf16* a, const bf16* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < DP; k += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(a + k);
    const uint4 w = *reinterpret_cast<const uint4*>(b + k);
    const uint32_t au[4] = {u.x, u.y, u.z, u.w}, bu[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s = fmaf(bf16_lo(au[m]), bf16_lo(bu[m]), s);
      s = fmaf(bf16_hi(au[m]), bf16_hi(bu[m]), s);
    }
  }
  return s;
}

// Kernels #10 (OWN_Q: dq for the block's 64 q rows, streaming c) and #11 (dc
// for the block's 64 c rows, streaming q).
template <int DP, bool OWN_Q>
__global__ void __launch_bounds__(bwd_groups<DP>() * kGroupThreads) lse_bwd_kernel(const Args a) {
  constexpr int NG = bwd_groups<DP>();
  using L = Layout<DP, NG>;
  static_assert(size_t(NG - 1) * kOwn * L::RLD * 4 <= L::scal - L::stream,
                "the partial sums fit the tile buffers");
  constexpr int LD = L::LD, ND = DP / 8;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const bf16* own_s = reinterpret_cast<const bf16*>(smem + L::own);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2, wr = (warp & 3) * 16;  // the warp's first own row in the block
  const int g = lane >> 2, t = lane & 3;       // fragment row and column pair
  const int r8 = lane & 7, mat = lane >> 3;    // ldmatrix: row within a matrix, matrix
  const int own0 = blockIdx.x * kOwn;
  const bool use_ids = a.row_ids != nullptr;
  const OwnRows own = load_own_rows<OWN_Q, true>(a, own0 + wr + g, use_ids);
  float acc[ND][4];  // the warp's [16, DP] of dq or dc
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  uint32_t af[DP / 16][4];
  stream_tiles<DP, OWN_Q, NG>(a, smem, af, [&](const bf16* tile, const float* sc, int o0) {
    float s[8][4];
    score_tile<DP>(s, af, tile);
    adjust_tile<OWN_Q>(s, sc, own, o0, a, use_ids);

    // the epilogue, in place: s[n][e] becomes p for own row g + 8 (e / 2) and
    // streamed row 8n + 2t + (e % 2); bit 4n + e of `ties` marks a p to recompute
    uint32_t ties = 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 x0 = OWN_Q ? make_float2(0.f, 0.f)
                              : *reinterpret_cast<const float2*>(sc + c);  // lse (dc)
      const float2 x1 = OWN_Q ? make_float2(1.f, 1.f)
                              : *reinterpret_cast<const float2*>(sc + kSub + c);  // g (dc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, j = e & 1;
        float ex;
        s[n][e] = p_value<true>(s[n][e], OWN_Q ? own.x[h] : (j ? x0.y : x0.x),
                                OWN_Q ? own.g[h] : (j ? x1.y : x1.x), ex);
        if (ex >= kTieFloor && near_tie(s[n][e])) ties |= 1u << (4 * n + e);
      }
    }
    // a p of weight (exp(s - lse) >= 2^-10) whose f32 value lies near a bf16
    // rounding tie: again as the plain version computes it (k-order score, expf)
    while (__any_sync(0xffffffffu, ties != 0)) {
      const bool mine = ties != 0;
      const int i = mine ? __ffs(ties) - 1 : 0;
      ties &= ties - 1;
      const int h = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1);
      float p = 0.f;
      if (mine) {
        const float dot = ordered_dot<DP>(own_s + (wr + g + 8 * h) * LD, tile + c * LD);
        const int oid = use_ids ? reinterpret_cast<const int*>(sc)[2 * kSub + c] : 0;
        const bool masked = use_ids && (h ? own.id[1] : own.id[0]) == oid &&
                            (h ? own.pos[1] : own.pos[0]) != (OWN_Q ? 0 : a.row_offset) + o0 + c;
        const float ox = h ? own.x[1] : own.x[0];
        float ex;
        p = p_value<false>(adjusted_score(dot, a.inv_t, OWN_Q ? sc[c] : ox, masked),
                           OWN_Q ? ox : sc[c], OWN_Q ? (h ? own.g[1] : own.g[0]) : sc[kSub + c],
                           ex);
      }
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (mine && k == i) s[k >> 2][k & 3] = p;
    }

    // the second product: p (16 x 64, from the registers) @ tile (64 x DP)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b[4];  // matrices (16kk, 8n), (16kk + 8, 8n), (16kk, 8n + 8), (16kk + 8, 8n + 8)
        ldsm_x4_trans(b, tile + (kk * 16 + r8 + (mat & 1) * 8) * LD + n * 8 + (mat >> 1) * 8);
        mma_bf16(acc[n], pa, b[0], b[1]);
        mma_bf16(acc[n + 1], pa, b[2], b[3]);
      }
    }
  });

  // groups 1 .. NG-1 write their partial sums to shared memory (the tile
  // buffers); group 0 adds them to its own in group order, times 1/T once
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem + L::stream);  // [NG - 1][64][RLD]
  if (group > 0) {
    float* mine = part + (group - 1) * kOwn * L::RLD;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(mine + (wr + g + 8 * h) * L::RLD + n * 8 + 2 * t) =
            make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
  __syncthreads();
  if (group == 0) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + g + 8 * h;
        float2 v = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
#pragma unroll
        for (int k = 0; k < NG - 1; ++k) {
          const float2 o =
              *reinterpret_cast<const float2*>(part + (k * kOwn + r) * L::RLD + n * 8 + 2 * t);
          v.x += o.x;
          v.y += o.y;
        }
        *reinterpret_cast<float2*>(a.out + static_cast<size_t>(own0 + r) * DP + n * 8 + 2 * t) =
            make_float2(v.x * a.inv_t, v.y * a.inv_t);
      }
  }
}

template <typename K>
int launch(K kernel, const Args& a, int n_own, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_own / kOwn, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The shapes the kernels take (the contract above).
bool shapes_ok(int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, const void* row_ids,
               const void* col_ids) {
  return bq > 0 && bk > 0 && bq % kRowMultiple == 0 && bk % kRowMultiple == 0 &&
         bk < (1LL << 30) && (dp == 64 || dp == 128) && row_offset >= 0 && row_offset + bq <= bk &&
         (row_ids == nullptr) == (col_ids == nullptr);
}

bool all_aligned(const Args& a) {
  return aligned16(a.q) && aligned16(a.c) && aligned16(a.adj) && aligned16(a.row_ids) &&
         aligned16(a.col_ids) && aligned16(a.lse) && aligned16(a.g) && aligned16(a.out);
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
int launch_bwd(const Args& a, int64_t dp, cudaStream_t s) {
  const int n_own = OWN_Q ? a.bq : a.bk;
  if (dp == 64)
    return launch(lse_bwd_kernel<64, OWN_Q>, a, n_own, bwd_groups<64>() * kGroupThreads,
                  Layout<64, bwd_groups<64>()>::bytes, s);
  return launch(lse_bwd_kernel<128, OWN_Q>, a, n_own, bwd_groups<128>() * kGroupThreads,
                Layout<128, bwd_groups<128>()>::bytes, s);
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code: 0 when the launch succeeded.
// adj may be null; row_ids and col_ids are both null or both set.

int ttrm_softmax_lse_fwd(const void* q, const void* c, const void* adj, const void* row_ids,
                         const void* col_ids, void* lse_out, int64_t bq, int64_t bk, int64_t dp,
                         int64_t row_offset, float inv_t, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, nullptr, nullptr, lse_out, bq, bk,
                           row_offset, inv_t);
  if (!all_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int threads = kFwdGroups * kGroupThreads;
  if (dp == 64) return launch(lse_fwd_kernel<64>, a, a.bq, threads, Layout<64, kFwdGroups>::bytes, s);
  return launch(lse_fwd_kernel<128>, a, a.bq, threads, Layout<128, kFwdGroups>::bytes, s);
}

int ttrm_softmax_lse_dq(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dq_out,
                        int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, float inv_t,
                        void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dq_out, bq, bk, row_offset, inv_t);
  if (!all_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_bwd<true>(a, dp, static_cast<cudaStream_t>(stream));
}

int ttrm_softmax_lse_dc(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dc_out,
                        int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, float inv_t,
                        void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dc_out, bq, bk, row_offset, inv_t);
  if (!all_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_bwd<false>(a, dp, static_cast<cudaStream_t>(stream));
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
