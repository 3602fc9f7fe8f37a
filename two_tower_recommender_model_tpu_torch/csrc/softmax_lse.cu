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
// Contract: q [BQ, DP] and c [BK, DP] bf16, row-major, DP 64, 128 or a
// multiple of 128 up to 2,048 (the wrapper zero-pads D, as the reference
// pads it to 128 lanes, to the reference's cap); BQ and BK multiples of 128; adj [BK] f32 or null;
// row_ids [BQ] and col_ids [BK] int32, both or neither; lse, g [BQ] f32;
// outputs f32 (and at a wide D the caller's workspaces: #9's chunk partials
// [n_chunks, BQ] f32 pairs, the backward's P [rows, BK] bf16, rows a
// multiple of 128); every pointer 16-byte aligned. q row i has global row index
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
// 0.04 ms): they, not the products, set the time. At a wide D the products
// do: 0.0347 ms for #9 and 0.0695 ms for #10 or #11 at 8,192^2, D = 256;
// 0.278 and 0.556 ms at D = 2,048 (the kernels at 128 < D <= 2,048 are at
// "wide D" below: one TMA + wgmma skeleton, #9 over column chunks with a
// merge, #10 and #11 as a p kernel that writes p once and two wgmma products
// that read it).
//
// At D <= 128 the three kernels share one skeleton (`stream_tiles`) and one score
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
// Left for later at D <= 128: wgmma with TMA loads (the wide backward's
// ring, below), warps that own 32 rows (half the ldmatrix traffic: each tile
// is read twice by each warp of a group, 8 MB per SM at 8,192^2), fewer
// instructions in the epilogue (the mask per 8 columns), and one barrier a
// tile instead of two.
//
// Binding: a plain C interface loaded with ctypes. Each launch goes to the
// caller's stream, does not synchronise and allocates nothing; each entry
// point returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "tma_map.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace mma_sm90;
using namespace wgmma_sm90;
using tma_map::bf16_map;
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
  int bq, bk, dp, row_offset;  // dp: the padded depth, the row stride of q, c and out
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

// The scalars of a tile of streamed rows o0 .. o0 + 63 into `sc` (adj of c
// rows, or lse and g of q rows; the ids): cp.async by the group's 128
// threads (gt), 16 pieces of 4 scalars per array: threads 0-15 the first,
// 16-31 the second, 32-47 the ids. Not waited for here.
template <bool OWN_Q>
__device__ __forceinline__ void load_scalars(const Args& a, int o0, float* sc, int gt,
                                             bool use_ids) {
  const int part = gt >> 4, i4 = (gt & 15) * 4;
  const float* first = OWN_Q ? a.adj : a.lse;
  if (part == 0 && first != nullptr) cp_async16(sc + i4, first + o0 + i4);
  if (part == 1 && !OWN_Q) cp_async16(sc + kSub + i4, a.g + o0 + i4);
  if (part == 2 && use_ids)
    cp_async16(sc + 2 * kSub + i4, (OWN_Q ? a.col_ids : a.row_ids) + o0 + i4);
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
  load_scalars<OWN_Q>(a, o0, sc, gt, use_ids);
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

__device__ __forceinline__ void zero_scores(float (&s)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
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
  zero_scores(s);
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

// The online max and sum of kernel #9 over one tile's adjusted scores: a
// thread holds 2 own rows x 16 columns; the tile's row max is the max of the
// thread's 16 scores, then of its quad's; l is rescaled by exp(m_old - m_new)
// before the tile's 16 exps are added in column order.
__device__ __forceinline__ void online_tile(const float (&s)[8][4], float (&m)[2], float (&l)[2]) {
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
}

// The end of kernel #9: the quad's four sums of a row, then the NG groups'
// (m, l) merged in group order through `ml` ([NG][64] in shared memory that
// no group reads any more), lse = M + log(L) for the block's 64 rows.
template <int NG>
__device__ __forceinline__ void finish_lse(float2* ml, float (&m)[2], float (&l)[2], float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // every group is past its tiles: the buffers are free
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) ml[group * kOwn + wr + g + 8 * h] = make_float2(m[h], l[h]);
  }
  __syncthreads();
  if (threadIdx.x < kOwn) {
    float mx = kNeg;
#pragma unroll
    for (int k = 0; k < NG; ++k) mx = fmaxf(mx, ml[k * kOwn + threadIdx.x].x);
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < NG; ++k) {
      const float2 v = ml[k * kOwn + threadIdx.x];
      sum += v.y * expf(v.x - mx);
    }
    out[threadIdx.x] = mx + logf(sum);
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
  const int wr = (warp & 3) * 16, g = lane >> 2;  // the warp's first own row; fragment row
  const bool use_ids = a.row_ids != nullptr;
  const int own0 = blockIdx.x * kOwn;
  const OwnRows own = load_own_rows<true, false>(a, own0 + wr + g, use_ids);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows g and g + 8: running max, sum

  uint32_t af[DP / 16][4];
  stream_tiles<DP, true, kFwdGroups>(a, smem, af, [&](const bf16* tile, const float* sc, int o0) {
    float s[8][4];
    score_tile<DP>(s, af, tile);
    adjust_tile<true>(s, sc, own, o0, a, use_ids);
    online_tile(s, m, l);
  });
  finish_lse<kFwdGroups>(reinterpret_cast<float2*>(smem + L::stream), m, l, a.out + own0);
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

// The wide backward's tie score: a . b over dp bf16 values of two rows in
// device memory (no whole row is in shared memory), the products summed in
// f64 and rounded to f32 once, as the plain version takes a score at a wide
// D. An f32 sum of 2,048 products depends on its order by tens of ulps, and
// the order of the library's f32 GEMM there is its own choice: on an H100 a
// [1,024, 4,096] stripe took another than the [4,096, 4,096] square. The
// products of bf16 values are exact, and an f64 sum of them rounds to the
// same f32 in any order. So `lanes` lanes (a power of 2, aligned) sum one
// score together, every lane of the group called with the same rows: lane l
// of the group takes the 8-value chunks l, l + lanes, ..., in two running
// sums, and the group's sums meet in a butterfly (every lane of the group
// ends with the same value). A thread alone took one L2 round trip a chunk:
// ~70 us a tie at D = 2,048; the whole warp on one tie, ~1 us at D = 256,
// left a warp whose rows hold dozens of ties (a trained step's) waiting on
// them in turn. `tie_lanes`: 8 at D = 256 (4 ties a round), 32 from D =
// 1,024 (on an H100, 8 and 32 lanes against 4 and 32 at D = 256 and 2,048).
__device__ __forceinline__ int tie_lanes(int dp) { return min(32, max(8, dp / 32)); }

__device__ float rounded_dot_group(const uint16_t* a, const uint16_t* b, int dp, int lanes) {
  double s[2] = {0.0, 0.0};
#pragma unroll 4
  for (int k = (threadIdx.x & (lanes - 1)) * 8; k < dp; k += 8 * lanes) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(a + k));
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(b + k));
    const uint32_t au[4] = {u.x, u.y, u.z, u.w}, bu[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s[0] = fma(static_cast<double>(bf16_lo(au[m])), static_cast<double>(bf16_lo(bu[m])), s[0]);
      s[1] = fma(static_cast<double>(bf16_hi(au[m])), static_cast<double>(bf16_hi(bu[m])), s[1]);
    }
  }
  double t = s[0] + s[1];
  for (int o = 1; o < lanes; o <<= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return __double2float_rn(t);
}

// The backward's work on one tile after adjust_tile: the epilogue turns the
// warp's adjusted scores `s` into p in place (exp(s - lse) * g), computes
// again each p of weight that lies near a bf16 rounding tie from its score
// summed in k order (`tie_dot(h, c)`: own row g + 8h against streamed row c
// of the tile), then adds the second product p (16 x 64, rounded to bf16 in
// the registers) @ `tile` (64 x 8 ND, row stride LD) to `acc`.
template <bool OWN_Q, int ND, int LD, typename TieDot>
__device__ __forceinline__ void bwd_tile(float (&s)[8][4], const float* sc, const OwnRows& own,
                                         int o0, const Args& a, bool use_ids, float (&acc)[ND][4],
                                         const bf16* tile, TieDot&& tie_dot) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r8 = lane & 7, mat = lane >> 3;  // ldmatrix: row within a matrix, matrix
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
      const float dot = tie_dot(h, c);
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

  // the second product: p (16 x 64, from the registers) @ tile (64 x 8 ND)
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
}

// The end of kernels #10 and #11: groups 1 .. NG-1 write their partial sums
// to `part` ([NG - 1][64][RLD] f32 in shared memory that no group reads any
// more); group 0 adds them to its own in group order, times 1/T once, and
// writes the block's 64 rows x 8 ND columns at out + row * ld.
template <int NG, int ND, int RLD>
__device__ __forceinline__ void finish_grad(const float (&acc)[ND][4], float* part, float* out,
                                            size_t ld, float inv_t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2, wr = (warp & 3) * 16;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
  if (group > 0) {
    float* mine = part + (group - 1) * kOwn * RLD;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(mine + (wr + g + 8 * h) * RLD + n * 8 + 2 * t) =
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
              *reinterpret_cast<const float2*>(part + (k * kOwn + r) * RLD + n * 8 + 2 * t);
          v.x += o.x;
          v.y += o.y;
        }
        *reinterpret_cast<float2*>(out + r * ld + n * 8 + 2 * t) =
            make_float2(v.x * inv_t, v.y * inv_t);
      }
  }
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
  const int wr = (warp & 3) * 16, g = lane >> 2;  // the warp's first own row; fragment row
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
    bwd_tile<OWN_Q, ND, LD>(s, sc, own, o0, a, use_ids, acc, tile, [&](int h, int c) {
      return ordered_dot<DP>(own_s + (wr + g + 8 * h) * LD, tile + c * LD);
    });
  });
  finish_grad<NG, ND, L::RLD>(acc, reinterpret_cast<float*>(smem + L::stream),
                              a.out + static_cast<size_t>(own0) * DP, DP, a.inv_t);
}

// ---- wide D: 128 < D <= 2,048 --------------------------------------------------
//
// A [64, D] bf16 tile of 2,048 columns is 256 KB, past the 227 KB a block may
// hold, and a warp's [16, D] f32 slice of dq or dc would be 128 KB of
// registers. So at a padded D of 256 to 2,048 (a multiple of 128) all three
// kernels run on one skeleton, the ring: persistent blocks (at most one an
// SM) of a producer warpgroup, whose one thread keeps kStages shared-memory
// stages filled by TMA (a q box and a c box of [128, 64] with the 128-byte
// swizzle, or the products' operands), and two consumer warpgroups on wgmma
// m64n128k16, each 64 rows x 128 columns of a 128 x 128 output tile. The
// scores of a tile (`ring_scores`): each 64-deep slice summed from zero
// (scale-d = 0 on its first k step) and added to the running f32 score with
// __fadd_rn, slices in order: a wgmma adds to its accumulator by
// truncation, as mma.sync does, and 128 chunks in one accumulator drifted
// ~1e-3 from a k-order sum of a score near 160 at D = 2,048 (an H100), p by
// ~2^-10, past the tie window. #9 and the p kernel take a score the same
// way, so it has the same bits in both.
//
// Kernel #9 (lse_fwd_wide_kernel, then lse_merge_kernel). The score matrix's
// columns are cut in n_chunks chunks of whole 128-column tiles (the wrapper's
// `fwd_chunks`: a function of BK alone, so a stripe's rows meet the same
// chunks as the square's), and a block walks (row tile, chunk) items, so the
// grid fills the card whatever BQ is: a [1,024 x 4,096] stripe is 8 row
// tiles x 32 chunks. For each of the chunk's tiles a consumer warpgroup
// adjusts its 64 x 128 scores in registers (`adjusted_score`: 1/T, adj,
// the duplicate mask; the column scalars arrive by cp.async during the
// products) and carries the online (m, l) of each of its thread's two rows
// (`online_ring_tile`: the tile's max of the thread's 32 scores, then of its
// quad's; l rescaled by exp(m_old - m_new) before the tile's 32 exps are
// added in column order). At the chunk's end the quad's four l are added
// and the row's (m, l) goes to the workspace `part` [n_chunks, BQ] f32 x 2.
// A second launch merges each row's chunks in chunk order (M = max m_k, L =
// sum_k l_k exp(m_k - M), lse = M + log(L)), as the narrow kernel merges its
// groups. No atomics, no order between blocks: two launches agree bit for
// bit; the workspace is the wrapper's, on the current stream, and nothing
// syncs with the host, so it runs inside a CUDA graph. No P, no ties: lse is
// not rounded to bf16.
//
// Kernels #10 and #11: p once, then two products. A backward is three
// launches per panel of q rows [lo, hi) (the wrapper's workspace holds the
// panel's P, [hi - lo, BK] bf16, at most 256 MB):
//   1. lse_p_kernel writes P = p for the panel's rows against all BK columns.
//      Scores on the ring (`ring_scores`), a 128 x 128 output tile a block
//      at a time. The epilogue is the narrow kernels': `adjusted_score`,
//      `p_value` with ex2.approx, and each p of weight near a bf16 tie summed
//      again from the two rows in device memory in f64 by a group of lanes
//      together (8 at D = 256, 32 from 1,024: `tie_lanes`), rounded once
//      (`rounded_dot_group`, as the plain version takes a score at a wide
//      D); a warpgroup pools its tile's ties in shared memory and its four
//      warps share them. Every p of weight gets the plain version's bf16 bits.
//      A warpgroup's [64, 128] of P is staged in shared memory (the ties
//      written over it there) and stored in rows of 256 bytes.
//   2. lse_product_kernel<false>: dq[lo:hi] = (1/T) P C (P K-major, C [BK,
//      D] row-major read MN-major), and
//   3. lse_product_kernel<true>: dc += P^T Q[lo:hi] (P^T read MN-major), f32,
//      times 1/T once after the last panel, as the plain version does.
//   Both products are one GEMM skeleton: TMA into the same ring, two
//   consumer warpgroups of 64 output rows x 128 columns, wgmma m64n128k16
//   with one k-block in flight. The f32 sum over the contracted axis runs in
//   k order in one accumulator (no split, no atomics), so two launches agree
//   bit for bit and a stripe's dq rows are the square's: the same P rows
//   meet the same k order.
// What bounds them: #9 does 2 BQ BK D FLOPs (0.0347 ms at 8,192^2, D = 256;
// 0.0695 ms at 4,096^2, D = 2,048, at 989 TFLOP/s). A score is computed once
// a backward (a grid that cut dq and dc in 128-column slices summed it 2 x D
// / 128 times), so the three launches do 3 x 2 BQ BK D FLOPs and move P
// three times (written once, read by each product): 0.104 ms of products
// and 0.115 ms of P at 8,192^2, D = 256 on an H100; 0.208 ms of products at
// 4,096^2, D = 2,048. Measured there (700 W): p 0.18 ms, the products 0.064
// and 0.066 ms at 8,192^2, D = 256; p 0.17, the products 0.12 and 0.13 ms
// at 4,096^2, D = 2,048. In the p kernel and #9 the epilogue does not
// overlap its warpgroup's products (each tile's products, then its
// epilogue), and ties cost more as a model trains and its p concentrate
// (`chip_smoke.py` `[train-softmax-wide]` counts them on its trained state).
// Left for later: the epilogue of one tile under the next tile's products,
// 128 x 256 product tiles at D >= 512 (less operand traffic from L2), #9's
// q box kept in shared memory across a chunk's tiles where D allows.

constexpr int kMaxDim = 2048;

// ---- #10 and #11 at a wide D: the ring, the p kernel, the products ------------------

constexpr int kTileM = 128;                       // output rows of a tile: 2 warpgroups x 64
constexpr int kTileN = 128;                       // output columns: one m64n128k16 a warpgroup
constexpr int kTileK = 64;                        // depth of a stage: a 128-byte swizzled row
static_assert(kTileK == tma_map::kBoxCols, "a stage's depth is one TMA box wide");
constexpr int kStages = 5;                        // the shared-memory ring
constexpr int kHalfBytes = 64 * kTileK * 2;       // one [64, 64] bf16 TMA box: 8 KB
constexpr int kStageBytes = 4 * kHalfBytes;       // A [128, 64] and B [128, 64]: 32 KB
constexpr int kConsumerWarps = 8;                 // two consumer warpgroups
constexpr int kWideThreads = 3 * kGroupThreads;   // a producer warpgroup and two consumers
constexpr size_t kRingBytes = size_t(kStages) * kStageBytes;
constexpr size_t kWideSmem = kRingBytes + 2 * kStages * 8 + 1024;  // barriers; alignment
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 x 40 + 256 x 232 <= 65,536
constexpr int kStagedLd = kTileN + 8;  // the p kernel's staged P rows: padded, no bank conflict
constexpr size_t kStagedAt = kRingBytes + 1024;  // past the ring's barriers: two [64, 136]
constexpr size_t kColsAt = kStagedAt + size_t(2) * 64 * kStagedLd * 2;  // two x [2][128] scalars
constexpr int kTieList = 2048;  // ties a warpgroup's tile pools (row << 7 | column, 2 bytes each)
constexpr size_t kTiesAt = kColsAt + size_t(2) * 2 * kTileN * 4;  // two lists, then two counts
constexpr size_t kPSmem = kTiesAt + size_t(2) * kTieList * 2 + 2 * 4 + 1024;
// #9 at a wide D: past the ring's barriers, each consumer's column scalars [2][128]
constexpr size_t kFwdColsAt = kRingBytes + 1024;
constexpr size_t kFwdSmem = kFwdColsAt + size_t(2) * 2 * kTileN * 4 + 1024;

// The ring: kStages stages of [A 16 KB | B 16 KB] on 1,024-byte boundaries (the
// 128-byte swizzle's atoms), a `full` barrier a stage (one arrival, the
// producer's, and the TMA bytes) and an `empty` one (an arrival from each
// consumer warp).
struct Ring {
  unsigned char* tiles;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Ring ring_init(unsigned char* smem_raw) {
  Ring r;
  r.tiles = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  r.full = reinterpret_cast<uint64_t*>(r.tiles + kRingBytes);
  r.empty = r.full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(r.full + s, 1);
      mbar_init(r.empty + s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// A position in the ring: the stage and the parity of its current round.
struct Slot {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The producer's step: the next free stage gets the TMA boxes of load(stage,
// bar), kStageBytes in all.
template <typename Load>
__device__ __forceinline__ void produce_stage(const Ring& r, Slot& s, Load&& load) {
  mbar_wait(r.empty + s.stage, s.phase ^ 1);
  mbar_arrive_expect_tx(r.full + s.stage, kStageBytes);
  load(r.tiles + size_t(s.stage) * kStageBytes, r.full + s.stage);
  s.next();
}

// The producer (one thread): for each of the block's tiles (blockIdx.x,
// + gridDim.x, ...) its n_kb k-blocks, each into the next free stage:
// load(tile, kb, stage, bar) issues the TMA boxes.
template <typename Load>
__device__ __forceinline__ void produce(const Ring& r, int n_tiles, int n_kb, Load&& load) {
  Slot s;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
    for (int kb = 0; kb < n_kb; ++kb)
      produce_stage(r, s, [&](unsigned char* st, uint64_t* bar) { load(t, kb, st, bar); });
}

// K-major and MN-major descriptors of the 128-byte-swizzled boxes of a stage,
// at k step ks (16 deep) of the k-block
__device__ __forceinline__ uint64_t kmajor_sw128(const unsigned char* tile, int ks) {
  return smem_desc(tile + 32 * ks, 16, 1024, wgmma_sm90::kSwizzle128);
}
__device__ __forceinline__ uint64_t mnmajor_sw128(const unsigned char* tile, int ks) {
  return smem_desc(tile + 2048 * ks, kHalfBytes, 1024, wgmma_sm90::kSwizzle128);
}

// The raw scores of consumer warpgroup cw's 64 rows x 128 columns of a tile
// whose n_kb k-blocks come through the ring from `s` on (a stage: the q box
// at A, the c box at B), in the accumulator layout: each 64-deep k-block
// summed from zero on the tensor cores, then added to sc with __fadd_rn,
// k-blocks in order. The p kernel and #9 both take their scores here.
__device__ __forceinline__ void ring_scores(const Ring& r, Slot& s, int cw, int n_kb,
                                            float (&sc)[64]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  for (int kb = 0; kb < n_kb; ++kb) {
    mbar_wait(r.full + s.stage, s.phase);
    const unsigned char* st = r.tiles + size_t(s.stage) * kStageBytes;
    float part[64];  // the slice's 64-deep sums, from zero
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 16; ++ks)
      wgmma_bf16<128, 0, 0>(part, kmajor_sw128(st + cw * kHalfBytes, ks),
                            kmajor_sw128(st + 2 * kHalfBytes, ks), ks);
    wgmma_commit_wait();
    fence_operands(part);
    if (lane == 0) mbar_arrive(r.empty + s.stage);
    s.next();
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = __fadd_rn(sc[i], part[i]);
  }
}

// The column scalars of the tile at column c0 into a consumer's [2][128]:
// adj (0 without one) and ids (-1 without ids; the rows' are then -2), by
// cp.async from the warpgroup's threads ct < 64; not waited for here.
__device__ __forceinline__ void load_col_scalars(const Args& a, int c0, float* col_adj,
                                                 int* col_id, int ct) {
  if (ct < kTileN / 4) {
    if (a.adj != nullptr)
      cp_async16(col_adj + 4 * ct, a.adj + c0 + 4 * ct);
    else
      *reinterpret_cast<float4*>(col_adj + 4 * ct) = make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (ct < kTileN / 2) {
    const int i = 4 * (ct - kTileN / 4);
    if (a.row_ids != nullptr)
      cp_async16(col_id + i, a.col_ids + c0 + i);
    else
      *reinterpret_cast<int4*>(col_id + i) = make_int4(-1, -1, -1, -1);
  }
  cp_async_commit();
}

// The p kernel: P[r, j] = bf16(exp(s - lse) * g) for q rows lo + r (r < rows)
// against every column j, into p ([rows, bk] bf16). mq: q [bq, dp], mc: c
// [bk, dp], both in boxes of [128 rows, 64].
__global__ void __launch_bounds__(kWideThreads, 1)
    lse_p_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mc,
                 const Args a, uint16_t* __restrict__ p, int lo, int rows) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int n_tn = a.bk / kTileN, n_tiles = (rows / kTileM) * n_tn, n_kb = a.dp / kTileK;
  const int wg = threadIdx.x / kGroupThreads;
  if (wg == 0) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&mq);
      tma_prefetch_map(&mc);
      produce(r, n_tiles, n_kb, [&](int t, int kb, unsigned char* st, uint64_t* bar) {
        const int tm = t / n_tn, tn = t - tm * n_tn;
        tma_load_2d(st, &mq, bar, kb * kTileK, lo + tm * kTileM);
        tma_load_2d(st + 2 * kHalfBytes, &mc, bar, kb * kTileK, tn * kTileN);
      });
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of each tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ct = threadIdx.x & (kGroupThreads - 1);
  const bool use_ids = a.row_ids != nullptr;
  // this warpgroup's staged P [64, 136] and its tile's column scalars: adj
  // [128] (0 without one), ids [128] (-1 without ids; the rows' are then -2)
  uint16_t* staged = reinterpret_cast<uint16_t*>(r.tiles + kStagedAt) + cw * 64 * kStagedLd;
  float* col_adj = reinterpret_cast<float*>(r.tiles + kColsAt) + cw * 2 * kTileN;
  int* col_id = reinterpret_cast<int*>(col_adj + kTileN);
  uint16_t* tie_list = reinterpret_cast<uint16_t*>(r.tiles + kTiesAt) + cw * kTieList;
  int* tie_count = reinterpret_cast<int*>(r.tiles + kTiesAt + size_t(2) * kTieList * 2) + cw;
  Slot s;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tm = tile / n_tn, tn = tile - tm * n_tn;
    const int c0 = tn * kTileN;
    // the scalars of the tile's columns and of the thread's two rows, on their
    // way while the scores are summed (the last tile's readers are past the
    // barrier that closed it)
    if (ct == 0) *tie_count = 0;  // published by the barrier before the epilogue
    load_col_scalars(a, c0, col_adj, col_id, ct);
    const int pr = tm * kTileM + cw * 64 + warp * 16 + g;  // panel row of the fragment's row 0
    float lse_r[2], g_r[2];
    int id_r[2], pos_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = lo + pr + 8 * h;
      lse_r[h] = __ldg(a.lse + qr);
      g_r[h] = __ldg(a.g + qr);
      id_r[h] = use_ids ? __ldg(a.row_ids + qr) : -2;
      pos_r[h] = a.row_offset + qr;
    }

    float sc[64];  // the running scores, in the accumulator layout
    ring_scores(r, s, cw, n_kb, sc);
    cp_async_wait_all();
    group_sync(cw);  // the column scalars are whole for the warpgroup

    // the epilogue: adjusted score, p, its bf16 rounding into the staging; ties flagged
    uint64_t ties = 0;  // bit i: accumulator i is a p of weight near a bf16 tie
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const int cl = 8 * j + 2 * t;  // the pair's first column in the tile
      const float2 adj = *reinterpret_cast<const float2*>(col_adj + cl);
      const int2 cid = *reinterpret_cast<const int2*>(col_id + cl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const bool masked = id_r[h] == (e ? cid.y : cid.x) && pos_r[h] != c0 + cl + e;
          float ex;
          pv[e] = p_value<true>(adjusted_score(sc[i], a.inv_t, e ? adj.y : adj.x, masked),
                                lse_r[h], g_r[h], ex);
          if (ex >= kTieFloor && near_tie(pv[e])) ties |= 1ull << i;
        }
        *reinterpret_cast<uint32_t*>(staged + (warp * 16 + g + 8 * h) * kStagedLd + cl) =
            pack_bf16x2(pv[0], pv[1]);
      }
    }
    // a p of weight near a bf16 rounding tie: again as the plain version takes
    // it (the score in f64, rounded once; expf), over its staged value. The
    // warpgroup pools its ties (a row's weighty p sit in few warps) and its
    // 4 warps share them: a round of a warp takes 32 / tl of them, each
    // summed by a group of tl lanes, whose first lane computes and stages
    // its p. Ties past the pool's room stay with their lanes (`rest`).
    const int tl = tie_lanes(a.dp);
    {
      const int n = __popcll(static_cast<long long>(ties));
      const int at = n ? atomicAdd(tie_count, n) : 0;
      for (int k = 0; k < n && at + k < kTieList; ++k) {
        const int i = __ffsll(static_cast<long long>(ties)) - 1;
        ties &= ties - 1;
        tie_list[at + k] = static_cast<uint16_t>(
            (warp * 16 + g + 8 * ((i >> 1) & 1)) << 7 | (2 * t + 8 * (i >> 2) + (i & 1)));
      }
    }
    group_sync(cw);  // the pool is whole
    const int pooled = min(*tie_count, kTieList);
    for (int base = 0; base < pooled; base += 4 * (32 / tl)) {
      const int e = base + warp * (32 / tl) + lane / tl;
      const int ent = e < pooled ? tie_list[e] : 0;
      const int wr = ent >> 7, cl = ent & (kTileN - 1);  // row in the warpgroup's 64, column
      const int qr = lo + tm * kTileM + cw * 64 + wr;
      // every lane in the call (its shuffles); a group without a tie sums nothing
      const float dot = rounded_dot_group(a.q + static_cast<size_t>(qr) * a.dp,
                                          a.c + static_cast<size_t>(c0 + cl) * a.dp,
                                          e < pooled ? a.dp : 0, tl);
      if (e < pooled && (lane & (tl - 1)) == 0) {
        const bool masked = (use_ids ? __ldg(a.row_ids + qr) : -2) == col_id[cl] &&
                            a.row_offset + qr != c0 + cl;
        float ex;
        const float pv = p_value<false>(adjusted_score(dot, a.inv_t, col_adj[cl], masked),
                                        __ldg(a.lse + qr), __ldg(a.g + qr), ex);
        staged[wr * kStagedLd + cl] = __bfloat16_as_ushort(__float2bfloat16_rn(pv));
      }
    }
    // `rest`: a round takes the lowest tie of each of the first 32 / tl
    // lanes of the warp that still hold one
    while (__any_sync(0xffffffffu, ties != 0)) {
      const unsigned have = __ballot_sync(0xffffffffu, ties != 0);
      const int rank = __popc(have & ((1u << lane) - 1));  // among the lanes with a tie
      const int mine = ties != 0 ? __ffsll(static_cast<long long>(ties)) - 1 : 0;
      unsigned left = have;  // the group's lane: the (lane / tl)-th of `have`
      for (int k = 0; k < lane / tl; ++k) left &= left - 1;
      const int src = left != 0 ? __ffs(left) - 1 : 0;
      const int i = __shfl_sync(0xffffffffu, mine, src);
      const int h = (i >> 1) & 1, cl = 2 * (src & 3) + 8 * (i >> 2) + (i & 1);
      const int wr = warp * 16 + (src >> 2) + 8 * h;  // the tie's row in the warpgroup's 64
      float dot = rounded_dot_group(
          a.q + static_cast<size_t>(lo + tm * kTileM + cw * 64 + wr) * a.dp,
          a.c + static_cast<size_t>(c0 + cl) * a.dp, left != 0 ? a.dp : 0, tl);
      dot = __shfl_sync(0xffffffffu, dot, (rank % (32 / tl)) * tl);
      if (ties != 0 && rank < 32 / tl) {
        const int mh = (mine >> 1) & 1, mcl = 2 * t + 8 * (mine >> 2) + (mine & 1);
        const bool masked =
            (mh ? id_r[1] : id_r[0]) == col_id[mcl] && (mh ? pos_r[1] : pos_r[0]) != c0 + mcl;
        float ex;
        const float pv = p_value<false>(adjusted_score(dot, a.inv_t, col_adj[mcl], masked),
                                        mh ? lse_r[1] : lse_r[0], mh ? g_r[1] : g_r[0], ex);
        staged[(warp * 16 + g + 8 * mh) * kStagedLd + mcl] =
            __bfloat16_as_ushort(__float2bfloat16_rn(pv));
        ties &= ties - 1;
      }
    }
    group_sync(cw);  // the staged rows are whole
    // the warpgroup's 64 rows of 256 bytes, 16 threads a row
    const size_t row0 = static_cast<size_t>(tm) * kTileM + cw * 64;
#pragma unroll
    for (int e = ct; e < 64 * (kTileN / 8); e += kGroupThreads) {
      const int rr = e >> 4, ch = e & 15;
      *reinterpret_cast<uint4*>(p + (row0 + rr) * a.bk + c0 + ch * 8) =
          *reinterpret_cast<const uint4*>(staged + rr * kStagedLd + ch * 8);
    }
    group_sync(cw);  // the staging and the column scalars are free for the next tile
  }
}

// The online max and sum of #9 at a wide D over one tile's adjusted scores
// (the accumulator layout: a thread holds 2 rows x 32 columns): the tile's
// row max is the max of the thread's 32 scores, then of its quad's (the 4
// lanes of a row); l is rescaled by exp(m_old - m_new) before the tile's 32
// exps are added in column order.
__device__ __forceinline__ void online_ring_tile(const float (&sc)[64], float (&m)[2],
                                                 float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mt = kNeg;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) mt = fmaxf(mt, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));  // the quad: the row's 128 columns
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[h], mt);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      sum += exp_approx(sc[4 * j + 2 * h] - m_new);
      sum += exp_approx(sc[4 * j + 2 * h + 1] - m_new);
    }
    l[h] = l[h] * exp_approx(m[h] - m_new) + sum;
    m[h] = m_new;
  }
}

// The first column tile of chunk k of n_chunks over n_tn tiles.
__device__ __forceinline__ int chunk_first(int k, int n_tn, int n_chunks) {
  return static_cast<int>(static_cast<int64_t>(k) * n_tn / n_chunks);
}

// Kernel #9 at a wide D: the (m, l) of each q row over each chunk of columns
// into part ([n_chunks, bq] of (m, l)); items (row tile tm, chunk k) =
// tm * n_chunks + k, a block's blockIdx.x, + gridDim.x, ... mq: q [bq, dp],
// mc: c [bk, dp], both in boxes of [128 rows, 64].
__global__ void __launch_bounds__(kWideThreads, 1)
    lse_fwd_wide_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mc, const Args a,
                        float2* __restrict__ part, int n_chunks) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int n_tn = a.bk / kTileN, n_items = (a.bq / kTileM) * n_chunks, n_kb = a.dp / kTileK;
  const int wg = threadIdx.x / kGroupThreads;
  if (wg == 0) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&mq);
      tma_prefetch_map(&mc);
      Slot s;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int tm = item / n_chunks, k = item - tm * n_chunks;
        const int tn1 = chunk_first(k + 1, n_tn, n_chunks);
        for (int tn = chunk_first(k, n_tn, n_chunks); tn < tn1; ++tn)
          for (int kb = 0; kb < n_kb; ++kb)
            produce_stage(r, s, [&](unsigned char* st, uint64_t* bar) {
              tma_load_2d(st, &mq, bar, kb * kTileK, tm * kTileM);
              tma_load_2d(st + 2 * kHalfBytes, &mc, bar, kb * kTileK, tn * kTileN);
            });
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  const int cw = wg - 1;  // rows 64 cw .. 64 cw + 63 of each tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ct = threadIdx.x & (kGroupThreads - 1);
  const bool use_ids = a.row_ids != nullptr;
  float* col_adj = reinterpret_cast<float*>(r.tiles + kFwdColsAt) + cw * 2 * kTileN;
  int* col_id = reinterpret_cast<int*>(col_adj + kTileN);
  Slot s;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tm = item / n_chunks, k = item - tm * n_chunks;
    const int qr = tm * kTileM + cw * 64 + warp * 16 + g;  // the fragment's row 0
    int id_r[2], pos_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      id_r[h] = use_ids ? __ldg(a.row_ids + qr + 8 * h) : -2;
      pos_r[h] = a.row_offset + qr + 8 * h;
    }
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // rows qr and qr + 8: running max, sum
    const int tn1 = chunk_first(k + 1, n_tn, n_chunks);
    for (int tn = chunk_first(k, n_tn, n_chunks); tn < tn1; ++tn) {
      const int c0 = tn * kTileN;
      // the tile's column scalars, on their way while the scores are summed
      // (the last tile's readers are past the barrier that closed it)
      load_col_scalars(a, c0, col_adj, col_id, ct);
      float sc[64];
      ring_scores(r, s, cw, n_kb, sc);
      cp_async_wait_all();
      group_sync(cw);  // the column scalars are whole for the warpgroup
#pragma unroll
      for (int j = 0; j < kTileN / 8; ++j) {
        const int cl = 8 * j + 2 * t;  // the pair's first column in the tile
        const float2 adj = *reinterpret_cast<const float2*>(col_adj + cl);
        const int2 cid = *reinterpret_cast<const int2*>(col_id + cl);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const bool masked = id_r[h] == (e ? cid.y : cid.x) && pos_r[h] != c0 + cl + e;
            sc[i] = adjusted_score(sc[i], a.inv_t, e ? adj.y : adj.x, masked);
          }
      }
      online_ring_tile(sc, m, l);
      group_sync(cw);  // the column scalars are free for the next tile
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the quad's four sums of a row
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (t == 0) part[static_cast<size_t>(k) * a.bq + qr + 8 * h] = make_float2(m[h], l[h]);
    }
  }
}

// The end of #9 at a wide D: each row's chunks merged in chunk order, M =
// max m_k, L = sum_k l_k exp(m_k - M), lse = M + log(L).
__global__ void __launch_bounds__(256)
    lse_merge_kernel(const float2* __restrict__ part, int n_chunks, int bq, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bq) return;
  float mx = kNeg;
  for (int k = 0; k < n_chunks; ++k) mx = fmaxf(mx, part[static_cast<size_t>(k) * bq + i].x);
  float sum = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const float2 v = part[static_cast<size_t>(k) * bq + i];
    sum += v.y * expf(v.x - mx);
  }
  out[i] = mx + logf(sum);
}

// The products: out (n_tm 128-row x n_tn 128-column tiles, row stride ld) =
// the contraction over n_kb k-blocks of 64 of A and B. DC = false (#10's dq):
// A = P [rows, bk] K-major (ma: boxes [128, 64]), B = c [bk, dp] (mb: boxes
// [64, 64] read MN-major), out = dq[lo:hi], times 1/T. DC = true (#11's dc):
// A = P^T (ma: P in boxes [64 rows, 64 columns] read MN-major), B = q[lo:hi]
// (mb: boxes [64, 64] read MN-major), out = dc: the panel's sum added to dc
// unless `first`, times 1/T if `last`.
template <bool DC>
__global__ void __launch_bounds__(kWideThreads, 1)
    lse_product_kernel(const __grid_constant__ CUtensorMap ma,
                       const __grid_constant__ CUtensorMap mb, float* __restrict__ out, int n_tm,
                       int n_tn, int n_kb, int ld, float inv_t, int first, int last) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int n_tiles = n_tm * n_tn;
  const int wg = threadIdx.x / kGroupThreads;
  if (wg == 0) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&ma);
      tma_prefetch_map(&mb);
      produce(r, n_tiles, n_kb, [&](int t, int kb, unsigned char* st, uint64_t* bar) {
        const int tm = t / n_tn, tn = t - tm * n_tn;
        if (DC) {  // P^T: the tile's 128 columns of P, 64 rows of P (the k-block)
          tma_load_2d(st, &ma, bar, tm * kTileM, kb * kTileK);
          tma_load_2d(st + kHalfBytes, &ma, bar, tm * kTileM + 64, kb * kTileK);
        } else {  // P: the tile's 128 rows, 64 columns (the k-block)
          tma_load_2d(st, &ma, bar, kb * kTileK, tm * kTileM);
        }
        tma_load_2d(st + 2 * kHalfBytes, &mb, bar, tn * kTileN, kb * kTileK);
        tma_load_2d(st + 3 * kHalfBytes, &mb, bar, tn * kTileN + 64, kb * kTileK);
      });
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  const int cw = wg - 1;  // output rows 64 cw .. 64 cw + 63 of each tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Slot s;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tm = tile / n_tn, tn = tile - tm * n_tn;
    float acc[64];
    int held = -1;  // the stage whose products are still in flight
    for (int kb = 0; kb < n_kb; ++kb) {
      mbar_wait(r.full + s.stage, s.phase);
      const unsigned char* st = r.tiles + size_t(s.stage) * kStageBytes;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTileK / 16; ++ks)
        wgmma_bf16<128, DC ? 1 : 0, 1>(
            acc, DC ? mnmajor_sw128(st + cw * kHalfBytes, ks) : kmajor_sw128(st + cw * kHalfBytes, ks),
            mnmajor_sw128(st + 2 * kHalfBytes, ks), kb | ks);
      wgmma_commit();
      wgmma_wait<1>();  // the k-block before is done: its stage is free
      fence_operands(acc);
      if (held >= 0 && lane == 0) mbar_arrive(r.empty + held);
      held = s.stage;
      s.next();
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(r.empty + held);

    const int row = tm * kTileM + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < kTileN / 8; ++j) {
      const int col = tn * kTileN + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* o = reinterpret_cast<float2*>(out + static_cast<size_t>(row + 8 * h) * ld + col);
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (DC) {
          if (!first) {
            const float2 before = *o;
            v = make_float2(__fadd_rn(before.x, v.x), __fadd_rn(before.y, v.y));
          }
          if (last) v = make_float2(__fmul_rn(v.x, inv_t), __fmul_rn(v.y, inv_t));
        } else {
          v = make_float2(__fmul_rn(v.x, inv_t), __fmul_rn(v.y, inv_t));
        }
        *o = v;
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <typename K>
int launch(K kernel, const Args& a, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The wide backward's kernels: persistent blocks, at most one an SM.
template <typename K, typename... P>
int launch_ring(K kernel, int n_tiles, size_t smem, cudaStream_t stream, const P&... params) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_tiles < sms ? n_tiles : sms, kWideThreads, smem, stream>>>(params...);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The padded depths the kernels take: 64, 128, or a multiple of 128 up to 2,048.
bool depth_ok(int64_t dp) {
  return dp == 64 || (dp % kTileN == 0 && dp >= kTileN && dp <= kMaxDim);
}
bool wide(int64_t dp) { return dp > kTileN && depth_ok(dp); }

// The shapes the kernels take (the contract above).
bool shapes_ok(int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, const void* row_ids,
               const void* col_ids) {
  return bq > 0 && bk > 0 && bq % kRowMultiple == 0 && bk % kRowMultiple == 0 &&
         bk < (1LL << 30) && depth_ok(dp) && row_offset >= 0 && row_offset + bq <= bk &&
         (row_ids == nullptr) == (col_ids == nullptr);
}

// A panel of P: `rows` rows of bk columns
bool panel_ok(int64_t rows, int64_t bk, int64_t dp) {
  return rows > 0 && rows % kTileM == 0 && bk > 0 && bk % kTileM == 0 && bk < (1LL << 30) &&
         rows * bk < (1LL << 31) && wide(dp);
}

bool all_aligned(const Args& a) {
  return aligned16(a.q) && aligned16(a.c) && aligned16(a.adj) && aligned16(a.row_ids) &&
         aligned16(a.col_ids) && aligned16(a.lse) && aligned16(a.g) && aligned16(a.out);
}

Args make_args(const void* q, const void* c, const void* adj, const void* row_ids,
               const void* col_ids, const void* lse, const void* g, void* out, int64_t bq,
               int64_t bk, int64_t dp, int64_t row_offset, float inv_t) {
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
  a.dp = static_cast<int>(dp);
  a.row_offset = static_cast<int>(row_offset);
  a.inv_t = inv_t;
  return a;
}

template <bool OWN_Q>
int launch_bwd(const Args& a, cudaStream_t s) {
  const int n_own = OWN_Q ? a.bq : a.bk;
  if (a.dp == 64)
    return launch(lse_bwd_kernel<64, OWN_Q>, a, dim3(n_own / kOwn), bwd_groups<64>() * kGroupThreads,
                  Layout<64, bwd_groups<64>()>::bytes, s);
  if (a.dp == 128)
    return launch(lse_bwd_kernel<128, OWN_Q>, a, dim3(n_own / kOwn),
                  bwd_groups<128>() * kGroupThreads, Layout<128, bwd_groups<128>()>::bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);  // a wide D: the p kernel and the products
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
  const Args a = make_args(q, c, adj, row_ids, col_ids, nullptr, nullptr, lse_out, bq, bk, dp,
                           row_offset, inv_t);
  if (!all_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int threads = kFwdGroups * kGroupThreads;
  const dim3 grid(a.bq / kOwn);
  if (dp == 64) return launch(lse_fwd_kernel<64>, a, grid, threads, Layout<64, kFwdGroups>::bytes, s);
  if (dp == 128)
    return launch(lse_fwd_kernel<128>, a, grid, threads, Layout<128, kFwdGroups>::bytes, s);
  return static_cast<int>(cudaErrorInvalidValue);  // a wide D: ttrm_softmax_lse_fwd_wide
}

// #9 at a wide D: lse_out [bq] through the caller's workspace part ([n_chunks,
// bq] f32 pairs, 16-byte aligned), n_chunks from 1 to bk / 128 (the column
// chunks: a function of bk alone, so a stripe's lse is the square's rows).
// Two launches: the chunks' (m, l), then their merge.
int ttrm_softmax_lse_fwd_wide(const void* q, const void* c, const void* adj, const void* row_ids,
                              const void* col_ids, void* lse_out, void* part, int64_t n_chunks,
                              int64_t bq, int64_t bk, int64_t dp, int64_t row_offset,
                              float inv_t, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids) || !wide(dp) || n_chunks < 1 ||
      n_chunks > bk / kTileN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, nullptr, nullptr, lse_out, bq, bk, dp,
                           row_offset, inv_t);
  if (!all_aligned(a) || !aligned16(part)) return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mc;
  if (!bf16_map(&mq, q, dp, bq, kTileM) || !bf16_map(&mc, c, dp, bk, kTileN))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pr = static_cast<float2*>(part);
  const int chunks = static_cast<int>(n_chunks);
  const int err = launch_ring(lse_fwd_wide_kernel, static_cast<int>(bq / kTileM) * chunks,
                              kFwdSmem, s, mq, mc, a, pr, chunks);
  if (err != 0) return err;
  lse_merge_kernel<<<static_cast<unsigned>((bq + 255) / 256), 256, 0, s>>>(
      pr, chunks, static_cast<int>(bq), static_cast<float*>(lse_out));
  return static_cast<int>(cudaGetLastError());
}

// #10 and #11 at D <= 128 (a padded depth of 64 or 128)
int ttrm_softmax_lse_dq(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dq_out,
                        int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, float inv_t,
                        void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dq_out, bq, bk, dp, row_offset,
                           inv_t);
  if (!all_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_bwd<true>(a, static_cast<cudaStream_t>(stream));
}

int ttrm_softmax_lse_dc(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dc_out,
                        int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, float inv_t,
                        void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dc_out, bq, bk, dp, row_offset,
                           inv_t);
  if (!all_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_bwd<false>(a, static_cast<cudaStream_t>(stream));
}

// The p kernel at a wide D: P of q rows [lo, lo + rows) into p_out ([rows, bk]
// bf16, contiguous); lo and rows multiples of 128.
int ttrm_softmax_lse_p(const void* q, const void* c, const void* adj, const void* row_ids,
                       const void* col_ids, const void* lse, const void* g, void* p_out,
                       int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, int64_t lo,
                       int64_t rows, float inv_t, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids) || !panel_ok(rows, bk, dp) ||
      lo < 0 || lo % kTileM != 0 || lo + rows > bq)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, p_out, bq, bk, dp, row_offset,
                           inv_t);
  if (!all_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mc;
  if (!bf16_map(&mq, q, dp, bq, kTileM) || !bf16_map(&mc, c, dp, bk, kTileN))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = static_cast<int>(rows / kTileM * (bk / kTileN));
  return launch_ring(lse_p_kernel, n_tiles, kPSmem, static_cast<cudaStream_t>(stream), mq, mc, a,
                     static_cast<uint16_t*>(p_out), static_cast<int>(lo), static_cast<int>(rows));
}

// #10's product at a wide D: dq_out ([rows, dp] f32) = (1/T) p ([rows, bk]
// bf16) @ c ([bk, dp] bf16).
int ttrm_softmax_lse_dq_product(const void* p, const void* c, void* dq_out, int64_t rows,
                                int64_t bk, int64_t dp, float inv_t, void* stream) {
  if (!panel_ok(rows, bk, dp)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(p) || !aligned16(c) || !aligned16(dq_out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap ma, mb;
  if (!bf16_map(&ma, p, bk, rows, kTileM) || !bf16_map(&mb, c, dp, bk, kTileK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tm = static_cast<int>(rows / kTileM), n_tn = static_cast<int>(dp / kTileN);
  return launch_ring(lse_product_kernel<false>, n_tm * n_tn, kWideSmem,
                     static_cast<cudaStream_t>(stream),
                     ma, mb, static_cast<float*>(dq_out), n_tm, n_tn,
                     static_cast<int>(bk / kTileK), static_cast<int>(dp), inv_t, 1, 1);
}

// #11's product at a wide D: dc ([bk, dp] f32) = (first ? 0 : dc) + p^T
// ([rows, bk] bf16) @ q_rows ([rows, dp] bf16), then times 1/T if `last`.
int ttrm_softmax_lse_dc_product(const void* p, const void* q_rows, void* dc, int64_t rows,
                                int64_t bk, int64_t dp, float inv_t, int64_t first, int64_t last,
                                void* stream) {
  if (!panel_ok(rows, bk, dp)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(p) || !aligned16(q_rows) || !aligned16(dc))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap ma, mb;
  if (!bf16_map(&ma, p, bk, rows, kTileK) || !bf16_map(&mb, q_rows, dp, rows, kTileK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tm = static_cast<int>(bk / kTileM), n_tn = static_cast<int>(dp / kTileN);
  return launch_ring(lse_product_kernel<true>, n_tm * n_tn, kWideSmem,
                     static_cast<cudaStream_t>(stream),
                     ma, mb, static_cast<float*>(dc), n_tm, n_tn, static_cast<int>(rows / kTileK),
                     static_cast<int>(dp), inv_t, first != 0 ? 1 : 0, last != 0 ? 1 : 0);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
