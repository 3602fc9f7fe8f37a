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
// Kernel #9 at D <= 128 (lse_fwd_kernel<DP>, DP 64 or 128, then
// lse_merge_kernel), on Hopper's warpgroup products and TMA (wgmma_sm90.cuh):
//   - The score matrix's columns are cut in chunks of whole 128-column tiles
//     (the wrapper's `fwd_chunks`: at D <= 128 BK / 1,024 from 1 to 8, a
//     function of BK alone), and a block walks (own tile of 128 q rows,
//     chunk) items, so the grid fills the card on a stripe too: 512 items at
//     8,192^2, 128 on a [2,048 x 8,192] stripe.
//   - Persistent blocks, one an SM, of a producer warpgroup and two consumer
//     warpgroups. The producer's one thread brings each item's own q rows
//     (TMA, 64-column boxes with the 128-byte swizzle) and their ids (a bulk
//     copy) into one of two slots, and the chunk's c tiles [128, DP] with
//     their scalars (adj and ids, bulk copies) into a ring of stages (6 at
//     DP = 64, 4 at 128), each freed by an arrival of every consumer warp.
//     Consumer warpgroup w takes own rows 64 w .. 64 w + 63 against every
//     tile: the block reads each c tile once for 128 q rows.
//   - The score: wgmma m64n128k16 over DP / 16 k steps in one f32
//     accumulator, A the own rows, B the streamed tile, both K-major in
//     shared memory, issued before the tile's mask test so that the test
//     runs under it. (Two tiles' scores in flight, the next one's product
//     under this one's epilogue, were tried: ptxas serialized the products,
//     C7514 / C7518, and the kernel ran slower.)
//   - The mask: each warpgroup sorts its 64 own ids once an item, and each
//     thread looks one column's id up (a binary search); the warpgroup's
//     barrier ORs the answers. A tile with no id of an own row takes an
//     epilogue without the mask.
//   - The epilogue on the accumulator fragment in registers, with the plain
//     version's rounding points (`adjusted_score`: 1/T and adj with separate
//     roundings, then the mask), and the online max and sum of a thread's 2
//     rows x 32 columns (`online_ring_tile`, as #9 at a wide D: the tile's
//     max of the thread's scores, then of its quad's; the running max from
//     -1e9; l rescaled by exp(m_old - m_new) before the tile's exps are added
//     in column order; ex2.approx of the prescaled argument). At the item's
//     end the quad's four l are added and each row's (m, l) goes to the
//     workspace; `lse_merge_kernel` merges a row's chunks in chunk order.
//   - exp(-1e9 - m) is exactly 0 in f32, and a tile whose every score is
//     -1e9 leaves the running max at -1e9 (exp(m_old - m_new) = 1), so a
//     fully masked row gives the finite lse the reference gives.
//   - No atomics and no order between blocks: two launches agree bit for
//     bit, and a stripe's rows meet the same chunks and tiles in the same
//     order as the square's, so its lse is the square's rows bit for bit.
//   - No tie repair: lse is not rounded to bf16, and it sits a few f32 ulps
//     from the plain version's, far inside the backward's tie window.
//
// Kernels #10 and #11 at D <= 128 (lse_bwd_kernel<DP, OWN_Q>, DP 64 or 128):
// dq and dc are one kernel with the operands' roles swapped (the score is
// symmetric in them, and both second products contract over the streamed
// rows), on Hopper's warpgroup products and TMA (wgmma_sm90.cuh):
//   - A block owns 64 rows of one operand (q rows for #10, c rows for #11),
//     loaded once by TMA, and NW warpgroups of 4 warps (3 at DP = 64, 2 at
//     128: `bwd_warpgroups`) take the streamed tiles of 128 rows of its range
//     in turn: warpgroup w the tiles t0 + w, t0 + w + NW, ... Each keeps a
//     ring of 3 stages of its own: its first thread refills a stage by TMA
//     (the rows, in 64-column boxes with the 128-byte swizzle) and bulk
//     copies (the tile's scalars: adj and ids of c rows, or lse, g and ids
//     of q rows) once the warpgroup's barrier says that every warp is done
//     with it.
//   - The score: wgmma m64n128k16 over DP / 16 k steps in one f32
//     accumulator, A the own tile, B the streamed tile, both K-major in
//     shared memory: 64 accumulators a thread. It is issued before the
//     tile's mask test and barrier and waited for after them.
//   - The mask: the own rows' ids are sorted once a block, and each thread
//     looks one column's id up (a binary search); the warpgroup's barrier
//     ORs the answers. A tile with no id of an own row (most tiles) takes
//     an epilogue without the mask, the others the one with it (an own
//     row's own column holds its id too: the mask spares it).
//   - The epilogue on the accumulator fragment in registers, with the plain
//     version's rounding points: `adjusted_score` (1/T, adj, the mask), then
//     exp(s - lse) (ex2.approx of the prescaled argument) times g, rounded
//     to bf16 and packed in pairs, which are the second product's A
//     fragments (the score's accumulator layout is the A-register layout:
//     p never goes through memory).
//   - Ties: the tensor cores sum a score in another order than an f32 GEMM,
//     and a p whose f32 value lies near a bf16 rounding midpoint then rounds
//     to the other neighbour, which moves a row's gradient by up to 2^-7 of
//     its largest p. The epilogue marks a p of weight (exp(s - lse) >=
//     kTieFloor) whose low bits lie within kTieWindow of the midpoint
//     (`near_tie`'s window, tested as `weight_of` and `near_tie_fast`: an
//     FMA-pipe weight and one integer multiply-add, no branch) by its pair
//     (a row's two columns of one packed register), and the thread computes
//     the pair's two p again as the plain version does: the scores summed in
//     k order on the CUDA cores from the swizzled streamed tile and, at DP =
//     64, an f32 copy of the own rows (`ordered_dot2`, two chains side by
//     side), expf. The window (1/8 of a bf16 ulp) is far wider than what
//     either the order or ex2.approx moves p by, so every p of weight
//     rounds as the plain version's.
//   - The second product: wgmma m64nDPk16 over the tile's 8 k steps, A = p
//     from registers, B = the same streamed tile read MN-major. It is
//     waited for one tile later, so it runs under the next tile's score
//     issue and mask test; the [64, DP] f32 sum stays in registers across
//     the warpgroup's tiles.
//   - Filling the card: the streamed range is cut into `bwd_chunks`
//     (n_str / 2,048, 1 to 4) chunks of whole tiles, a function of its
//     length alone, each a block of its own (512 blocks at 8,192^2, 128 on
//     a [2,048 x 8,192] stripe, where one block an own tile gave 32). At
//     the end the warpgroups' sums are added in warpgroup order; with one
//     chunk the block writes its rows times 1/T, with several it writes its
//     chunk's sums to the caller's workspace and a second launch
//     (`lse_bwd_merge_kernel`) adds them in chunk order, times 1/T once. No
//     atomics: two launches agree bit for bit, and a stripe's dq rows meet
//     the same chunks and tiles in the same order as the square's, so they
//     are the square's bit for bit. Thread-block clusters of an own tile's
//     chunks, merged through distributed shared memory, were tried first:
//     a cluster of 4 at this shared memory held 120 of the 132 SMs (30
//     clusters), so the square took 5 waves and the stripe's 128 blocks 2,
//     and a cluster's blocks waited for each other at the merge (an H100).
//   - One block an SM (its shared memory: 188 KiB at DP = 64, 222 KiB at
//     128); a thread holds 64 scores, 32 or 64 sums and 32 packed p (155
//     and 190 registers on an H100's ptxas, no spill).
// Left for later: the ties outside the warpgroup's critical path (a tile's
// tied pairs delay all four warps at the next warpgroup product), the next
// tile's scores in flight during the epilogue (tried: ptxas then serialized
// the products, C7515), chunks that split evenly over 3 warpgroups (16
// tiles a chunk at 8,192 give 6, 5 and 5).
//
// Binding: a plain C interface loaded with ctypes. Each launch goes to the
// caller's stream, does not synchronise and allocates nothing; each entry
// point returns cudaGetLastError().

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "tma_map.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;
using tma_map::bf16_map;
using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e9f;
constexpr float kLog2e = 1.44269504088896341f;
constexpr int kRowMultiple = 128;   // BQ and BK are multiples of it (the reference's rule)
constexpr int kOwn = 64;            // own rows of a warpgroup: 4 warps x 16
constexpr int kGroupThreads = 128;  // a warpgroup: 4 warps, 64 own rows

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

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kGroupThreads) : "memory");
}

// Whether v holds on any thread of warp group `group` (its named barrier, ORed).
__device__ __forceinline__ bool group_any(int group, bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.or.pred q, %2, 128, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"(static_cast<uint32_t>(v)), "r"(group + 1)
      : "memory");
  return r != 0;
}

// The adjusted score from the raw dot product: times 1/T, minus adj (the
// reference's separate roundings), then the duplicate mask.
__device__ __forceinline__ float adjusted_score(float dot, float inv_t, float adj, bool masked) {
  return masked ? kNeg : __fsub_rn(__fmul_rn(dot, inv_t), adj);
}

// ---- p and its ties: kernels #10 and #11 at every D --------------------------------

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
// truncation, as the warp-level products do, and 128 chunks in one accumulator drifted
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

// ---- kernel #9 at D <= 128 -------------------------------------------------------

// Shared memory of #9 at a padded depth DP of 64 or 128 (byte offsets from a
// 1,024-byte boundary): two slots of an item's own q rows [128, DP] (64-column
// TMA boxes with the 128-byte swizzle) and their ids [128]; the ring of
// streamed c tiles [128, DP] in boxes, each stage followed by its scalars
// (adj [128], ids [128]); each consumer warpgroup's own ids sorted [64]; the
// barriers (own full / empty a slot, then full / empty a stage).
template <int DP>
struct FwdLayout {
  static constexpr int boxes = DP / tma_map::kBoxCols;
  static constexpr int box = kTileM * 128;  // [128 rows, 64] bf16: 16 KB
  static constexpr int own_bytes = boxes * box;
  static constexpr int tile_bytes = boxes * box;
  static constexpr int stage_bytes = tile_bytes + 1024;
  static constexpr int stages = DP == 64 ? 8 : 4;
  static constexpr size_t own = 0;
  static constexpr size_t own_ids = own + 2 * size_t(own_bytes);  // [2][128] int
  static constexpr size_t ring = own_ids + 2 * kTileM * 4;        // a multiple of 1,024
  static constexpr size_t sorted = ring + size_t(stages) * stage_bytes;  // [2][64] int
  static constexpr size_t bars = sorted + 2 * kOwn * 4;
  static constexpr size_t bytes = bars + (4 + 2 * stages) * 8 + 1024;  // the base's alignment
};
static_assert(FwdLayout<64>::bytes <= 232448 && FwdLayout<128>::bytes <= 232448,
              "#9 fits a block's shared memory");
static_assert(FwdLayout<64>::ring % 1024 == 0 && FwdLayout<128>::ring % 1024 == 0,
              "the ring's boxes start on 1,024-byte boundaries");

// Kernel #9 at D <= 128: the (m, l) of each q row over each chunk of columns
// into part ([n_chunks, bq] of (m, l)). Items (own tile tm of 128 q rows,
// chunk k) = tm * n_chunks + k, a block's blockIdx.x, + gridDim.x, ...; a
// producer warpgroup (one thread) brings each item's own rows and ids into a
// slot and its chunk's c tiles with their scalars into the ring; consumer
// warpgroup cw takes own rows 64 cw .. 64 cw + 63 against every tile of the
// chunk. m_q: q [bq, DP] in boxes [128, 64]; m_c: c [bk, DP] in boxes [128, 64].
template <int DP>
__global__ void __launch_bounds__(kWideThreads, 1)
    lse_fwd_kernel(const __grid_constant__ CUtensorMap m_q, const __grid_constant__ CUtensorMap m_c,
                   const Args a, float2* __restrict__ part, int n_chunks) {
  using L = FwdLayout<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_tn = a.bk / kTileN, n_items = (a.bq / kTileM) * n_chunks;
  const bool use_ids = a.row_ids != nullptr;
  const int wg = threadIdx.x / kGroupThreads;
  int* own_ids = reinterpret_cast<int*>(smem + L::own_ids);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* own_empty = own_full + 2;
  uint64_t* full = own_full + 4;
  uint64_t* empty = full + L::stages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(own_full + i, 1);
      mbar_init(own_empty + i, kConsumerWarps);
    }
    for (int i = 0; i < L::stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumerWarps);
    }
    mbar_init_fence();
  }
  // scalars no copy brings: adj 0 without one
  if (a.adj == nullptr)
    for (int i = threadIdx.x; i < L::stages * kTileN; i += kWideThreads)
      reinterpret_cast<float*>(smem + L::ring + size_t(i / kTileN) * L::stage_bytes +
                               L::tile_bytes)[i % kTileN] = 0.f;
  __syncthreads();

  if (wg == 0) {  // the producer
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&m_q);
      tma_prefetch_map(&m_c);
      const uint32_t scal_tx = (a.adj != nullptr ? kTileN * 4 : 0) + (use_ids ? kTileN * 4 : 0);
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, ii = 0; item < n_items; item += gridDim.x, ++ii) {
        const int tm = item / n_chunks, k = item - tm * n_chunks, os = ii & 1;
        mbar_wait(own_empty + os, ((ii >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(own_full + os, L::own_bytes + (use_ids ? kTileM * 4 : 0));
#pragma unroll
        for (int b = 0; b < L::boxes; ++b)
          tma_load_2d(smem + L::own + size_t(os) * L::own_bytes + b * L::box, &m_q, own_full + os,
                      b * tma_map::kBoxCols, tm * kTileM);
        if (use_ids)
          bulk_load(own_ids + os * kTileM, a.row_ids + tm * kTileM, kTileM * 4, own_full + os);
        const int tn1 = chunk_first(k + 1, n_tn, n_chunks);
        for (int tn = chunk_first(k, n_tn, n_chunks); tn < tn1; ++tn) {
          unsigned char* st = smem + L::ring + size_t(stage) * L::stage_bytes;
          float* sc = reinterpret_cast<float*>(st + L::tile_bytes);
          mbar_wait(empty + stage, phase ^ 1);
          mbar_arrive_expect_tx(full + stage, L::tile_bytes + scal_tx);
#pragma unroll
          for (int b = 0; b < L::boxes; ++b)
            tma_load_2d(st + b * L::box, &m_c, full + stage, b * tma_map::kBoxCols, tn * kTileN);
          if (a.adj != nullptr) bulk_load(sc, a.adj + tn * kTileN, kTileN * 4, full + stage);
          if (use_ids)
            bulk_load(sc + kTileN, a.col_ids + tn * kTileN, kTileN * 4, full + stage);
          if (++stage == L::stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  regs_inc<kConsumerRegs>();
  const int cw = wg - 1;  // own rows 64 cw .. 64 cw + 63 of each item
  const int gt = threadIdx.x & (kGroupThreads - 1);
  const int warp = gt >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int* sorted = reinterpret_cast<int*>(smem + L::sorted) + cw * kOwn;
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x, ii = 0; item < n_items; item += gridDim.x, ++ii) {
    const int tm = item / n_chunks, k = item - tm * n_chunks, os = ii & 1;
    const unsigned char* own = smem + L::own + size_t(os) * L::own_bytes + cw * (L::box / 2);
    const int* ids = own_ids + os * kTileM + cw * kOwn;  // this warpgroup's 64
    const int row0 = tm * kTileM + cw * kOwn;            // its first q row
    mbar_wait(own_full + os, (ii >> 1) & 1);
    // the thread's two rows (16 warp + g + 8 h): id (-2 without ids), global position
    int id_r[2], pos_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + g + 8 * h;
      id_r[h] = use_ids ? ids[r] : -2;
      pos_r[h] = a.row_offset + row0 + r;
    }
    if (use_ids) {
      if (gt < kOwn) {  // the warpgroup's ids sorted (a rank each; equal ids by row)
        const int my_id = ids[gt];
        int rank = 0;
#pragma unroll 16
        for (int j = 0; j < kOwn; ++j) {
          const int o = ids[j];
          rank += (o < my_id || (o == my_id && j < gt)) ? 1 : 0;
        }
        sorted[rank] = my_id;
      }
      group_sync(cw);  // the sorted ids
    }
    const int tn0 = chunk_first(k, n_tn, n_chunks), n_mine = chunk_first(k + 1, n_tn, n_chunks) - tn0;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // the two rows' running max, sum

    // the raw scores [64 own, 128 streamed] of the tile in stage st_idx, issued
    // and committed: the DP / 16 k steps in order in one accumulator
    auto issue = [&](float (&s)[64], int st_idx) {
      const unsigned char* st = smem + L::ring + size_t(st_idx) * L::stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)
        wgmma_bf16<128, 0, 0>(s, kmajor_sw128(own + (ks >> 2) * L::box, ks & 3),
                              kmajor_sw128(st + (ks >> 2) * L::box, ks & 3), ks);
      wgmma_commit();
    };
    // tile it, whose product is in flight into s: the mask test (does column gt hold an id of an own row? a binary search
    // of the sorted ids; an own row's own column holds its id too, and the
    // mask spares it; the warpgroup's barrier ORs the answers), the adjusted
    // scores, the stage freed, the online max and sum
    auto finish = [&](float (&s)[64], int it, int st_idx) {
      const float* sc = reinterpret_cast<const float*>(smem + L::ring + size_t(st_idx) * L::stage_bytes +
                                                       L::tile_bytes);
      const int* sid = reinterpret_cast<const int*>(sc) + kTileN;
      bool mask = false;
      if (use_ids) {
        const int cid = sid[gt];
        int at = 0;
#pragma unroll
        for (int w = kOwn / 2; w >= 1; w >>= 1) at += sorted[at + w - 1] < cid ? w : 0;
        mask = group_any(cw, sorted[at] == cid);
      }
      wgmma_wait<0>();
      fence_operands(s);
      const int c0 = (tn0 + it) * kTileN;
      auto adjust = [&](auto masked_tile) {
        constexpr bool kMask = decltype(masked_tile)::value;
#pragma unroll
        for (int j = 0; j < kTileN / 8; ++j) {
          const int cl = 8 * j + 2 * t;  // the pair's first column in the tile
          const float2 adj = *reinterpret_cast<const float2*>(sc + cl);
          const int2 cid = kMask ? *reinterpret_cast<const int2*>(sid + cl) : make_int2(0, 0);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              const bool masked =
                  kMask && id_r[h] == (e ? cid.y : cid.x) && pos_r[h] != c0 + cl + e;
              s[i] = adjusted_score(s[i], a.inv_t, e ? adj.y : adj.x, masked);
            }
        }
      };
      if (mask)
        adjust(std::true_type());
      else
        adjust(std::false_type());
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st_idx);  // the stage is read
      online_ring_tile(s, m, l);
    };

    // the chunk's tiles in turn: the product issued, the mask test under it
    for (int it = 0; it < n_mine; ++it) {
      float sc[64];
      mbar_wait(full + stage, phase);
      issue(sc, stage);
      finish(sc, it, stage);
      if (++stage == L::stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    // the item's (m, l): the quad's four sums of a row; the slot is free
    // (every thread is past the sorted ids: the last tile's mask test was a
    // barrier)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (t == 0)
        part[static_cast<size_t>(k) * a.bq + row0 + 16 * warp + g + 8 * h] = make_float2(m[h], l[h]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(own_empty + os);
  }
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

// ---- kernels #10 and #11 at D <= 128 -------------------------------------------

constexpr int kBwdTile = 128;                   // streamed rows a tile: the score's N, the
                                                // second product's K
constexpr int kBwdMaxChunks = 4;                // the most chunks of a streamed range
constexpr int kBwdChunkRows = 2048;             // streamed rows a chunk at least, where several

// The warpgroups of #10 / #11 at a padded depth DP: 3 where a thread's
// registers fit 168 (DP = 64: 32 sums), else 2.
template <int DP>
__host__ __device__ constexpr int bwd_warpgroups() { return DP == 64 ? 3 : 2; }

// Shared memory of #10 / #11 at a padded depth DP of 64 or 128 (byte offsets
// from a 1,024-byte boundary): the own tile [64, DP] in 64-column boxes, each
// warpgroup's ring of 3 stages (a streamed tile [128, DP] in boxes, then its
// scalars: adj or lse [128], g [128], ids [128]), the own rows' scalars (x,
// g, ids, the ids sorted), at DP = 64 the own rows widened to f32 [64][DP]
// for the ties' k-order sums (at 128 there is no room: they are widened as
// they are read), the barriers (the own tile's, then [warpgroup][stage] full
// ones). Every box is a TMA box with the 128-byte swizzle.
template <int DP>
struct BwdLayout {
  static constexpr int nw = bwd_warpgroups<DP>();
  static constexpr int boxes = DP / tma_map::kBoxCols;
  static constexpr int own_box = kOwn * 128;         // [64 rows, 64] bf16: 8 KB
  static constexpr int tile_box = kBwdTile * 128;    // [128 rows, 64]: 16 KB
  static constexpr int tile_bytes = boxes * tile_box;
  static constexpr int stage_bytes = tile_bytes + 2048;
  static constexpr int stages = 3;
  static constexpr bool own_f32 = DP == 64;
  static constexpr size_t own = 0;
  static constexpr size_t ring = own + size_t(boxes) * own_box;
  static constexpr size_t own_scal = ring + size_t(nw) * stages * stage_bytes;  // [4][64]
  static constexpr size_t own_wide = own_scal + 4 * kOwn * 4;
  static constexpr size_t bars = own_wide + (own_f32 ? size_t(kOwn) * DP * 4 : 0);
  static constexpr size_t bytes = bars + (1 + nw * stages) * 8 + 1024;  // the base's alignment
};
static_assert(BwdLayout<64>::bytes <= 232448 && BwdLayout<128>::bytes <= 232448,
              "#10 / #11 fit a block's shared memory");
static_assert(3 * kBwdTile * 4 <= 2048, "a tile's scalars fit its stage");

// Byte offset of 16-byte chunk j (values 8 j .. 8 j + 7) of row r in a tile
// of 64-column boxes of `box` bytes, where the TMA's 128-byte swizzle put it.
__device__ __forceinline__ int swizzled_chunk(int r, int j, int box) {
  return (j >> 3) * box + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// The scores of own row r against streamed rows c0, c1 of a stage's tile over
// DP bf16 values, d[e] = own r . streamed c_e: each one fmaf a k in k order
// (the plain version's order; a bf16 value widened by a shift of its bits,
// exactly), the two chains side by side, each chunk loaded one chunk ahead of
// its fmafs. The own row comes from its f32 copy `own_w` where the layout has
// one (BwdLayout::own_f32), else from the swizzled bf16 tile `own`.
template <int DP>
__device__ __forceinline__ void ordered_dot2(const unsigned char* own, const float* own_w, int r,
                                             const unsigned char* tile, int c0, int c1,
                                             float (&d)[2]) {
  using L = BwdLayout<DP>;
  constexpr int kChunks = DP / 8;
  struct Chunk {
    float x[8];  // the own row's 8 values
    uint4 y[2];  // the streamed rows' 8 bf16 values
  };
  auto load = [&](int j, Chunk& v) {
    if constexpr (L::own_f32) {
      const float4 lo = *reinterpret_cast<const float4*>(own_w + r * DP + 8 * j);
      const float4 hi = *reinterpret_cast<const float4*>(own_w + r * DP + 8 * j + 4);
      const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) v.x[k] = w[k];
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(own + swizzled_chunk(r, j, L::own_box));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        v.x[2 * m] = bf16_lo(w[m]);
        v.x[2 * m + 1] = bf16_hi(w[m]);
      }
    }
    v.y[0] = *reinterpret_cast<const uint4*>(tile + swizzled_chunk(c0, j, L::tile_box));
    v.y[1] = *reinterpret_cast<const uint4*>(tile + swizzled_chunk(c1, j, L::tile_box));
  };
  Chunk v[2];
  load(0, v[0]);
  d[0] = d[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (j + 1 < kChunks) load(j + 1, v[(j + 1) & 1]);
    const Chunk& c = v[j & 1];
    const uint32_t y[2][4] = {{c.y[0].x, c.y[0].y, c.y[0].z, c.y[0].w},
                              {c.y[1].x, c.y[1].y, c.y[1].z, c.y[1].w}};
#pragma unroll
    for (int m = 0; m < 4; ++m)  // the lower k in the low half
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        d[e] = fmaf(c.x[2 * m], bf16_lo(y[e][m]), d[e]);
        d[e] = fmaf(c.x[2 * m + 1], bf16_hi(y[e][m]), d[e]);
      }
  }
}

// pa[k / 4][k % 4] = v for a runtime k: the packed p of the thread's row
// 16 warp + g + 8 (k % 2) at columns 8 (k / 2) + 2 t, + 1 (the A fragment of
// the second product's k step k / 4; it stays in registers)
__device__ __forceinline__ void set_pair(uint32_t (&pa)[8][4], int k, uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < 32; ++kk)
    if (kk == k) pa[kk >> 2][kk & 3] = v;
}

// 1 for a p of weight (exp(s - lse) >= kTieFloor = 2^-10), 0 below, from x =
// (s - lse) log2(e): one saturated fma on the FMA pipe (between -10 and -10 +
// 2^-20 it ramps within one f32 ulp of x).
__device__ __forceinline__ float weight_of(float x) {
  return __saturatef(fmaf(x, 0x1p20f, 0x1.4p23f));  // (x + 10) 2^20, clamped to [0, 1]
}

// `near_tie` in two instructions: (low 16 bits + 0x2000) << 16, one integer
// multiply-add, lies in [0x80000000, 0xc0000000] (at most -2^30 as a signed
// int) exactly where the low bits lie within kTieWindow of 0x8000.
__device__ __forceinline__ bool near_tie_fast(float p) {
  int u;
  asm("mad.lo.s32 %0, %1, 65536, 536870912;\n" : "=r"(u) : "r"(__float_as_int(p)));
  return u <= static_cast<int>(0xc0000000u);
}
static_assert(kTieWindow == 0x2000, "near_tie_fast's constants");

// Kernels #10 (OWN_Q: dq of the block's 64 q rows, streaming c) and #11 (dc
// of its 64 c rows, streaming q). Block b is chunk b % n_chunks of own tile
// b / n_chunks. m_own: the own operand [n_own, DP] in boxes [64, 64]; m_str:
// the streamed one [n_str, DP] in boxes [128, 64]. With one chunk the block
// writes its rows of a.out, times 1/T; with several, its chunk's sums into
// part ([n_chunks, n_own, DP] f32), which `lse_bwd_merge_kernel` adds.
template <int DP, bool OWN_Q>
__global__ void __launch_bounds__(bwd_warpgroups<DP>() * kGroupThreads, 1)
    lse_bwd_kernel(const __grid_constant__ CUtensorMap m_own,
                   const __grid_constant__ CUtensorMap m_str, const Args a, int n_chunks,
                   float* __restrict__ part) {
  using L = BwdLayout<DP>;
  constexpr int NW = L::nw, ND = DP / 2;  // warpgroups; a thread's share of the [64, DP] sum
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / kGroupThreads, gt = threadIdx.x & (kGroupThreads - 1);
  const int warp = gt >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunk = static_cast<int>(blockIdx.x % n_chunks);
  const int own0 = static_cast<int>(blockIdx.x / n_chunks) * kOwn;
  const int n_t = (OWN_Q ? a.bk : a.bq) / kBwdTile;
  const int t0 = chunk_first(chunk, n_t, n_chunks), t1 = chunk_first(chunk + 1, n_t, n_chunks);
  const int n_mine = (t1 - t0 - wg + NW - 1) / NW;  // this warpgroup's: t0 + wg, t0 + wg + NW, ...
  const bool use_ids = a.row_ids != nullptr;
  const float* first = OWN_Q ? a.adj : a.lse;  // the tile's first scalars: adj (or none) or lse
  const uint32_t stage_tx = L::tile_bytes + kBwdTile * 4 * ((first != nullptr ? 1 : 0) +
                                                           (OWN_Q ? 0 : 1) + (use_ids ? 1 : 0));
  const int own_pos0 = (OWN_Q ? a.row_offset : 0) + own0;  // global position of own row 0
  unsigned char* ring = smem + L::ring + size_t(wg) * L::stages * L::stage_bytes;
  const unsigned char* own_s = smem + L::own;
  uint64_t* own_bar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = own_bar + 1 + wg * L::stages;
  // the own rows' scalars: lse, g of q rows, or adj (0 without one), 1 of c
  // rows; ids (-2 without ids) and the ids sorted
  float* own_x = reinterpret_cast<float*>(smem + L::own_scal);
  float* own_g = own_x + kOwn;
  int* own_id = reinterpret_cast<int*>(own_g + kOwn);
  int* sorted_id = own_id + kOwn;

  if (threadIdx.x == 0) {
    mbar_init(own_bar, 1);
    for (int s = 0; s < NW * L::stages; ++s) mbar_init(own_bar + 1 + s, 1);
    mbar_init_fence();
  }
  int my_id = 0;
  if (threadIdx.x < kOwn) {
    const int r = own0 + threadIdx.x;
    own_x[threadIdx.x] = OWN_Q ? __ldg(a.lse + r) : (a.adj != nullptr ? __ldg(a.adj + r) : 0.f);
    own_g[threadIdx.x] = OWN_Q ? __ldg(a.g + r) : 1.f;
    my_id = use_ids ? __ldg((OWN_Q ? a.row_ids : a.col_ids) + r) : -2;
    own_id[threadIdx.x] = my_id;
  }
  // scalars no copy brings: adj 0 without one; ids -1 without ids (the own rows' are then -2)
  for (int s = 0; s < L::stages; ++s) {
    float* sc = reinterpret_cast<float*>(ring + s * L::stage_bytes + L::tile_bytes);
    if (first == nullptr) sc[gt] = 0.f;
    if (!use_ids) reinterpret_cast<int*>(sc)[2 * kBwdTile + gt] = -1;
  }
  __syncthreads();
  // tile `it` of this warpgroup into its stage: the rows by TMA, the scalars by bulk copies
  auto load = [&](int it) {
    const int s = it % L::stages, o0 = (t0 + wg + NW * it) * kBwdTile;
    unsigned char* st = ring + s * L::stage_bytes;
    float* sc = reinterpret_cast<float*>(st + L::tile_bytes);
    mbar_arrive_expect_tx(full + s, stage_tx);
#pragma unroll
    for (int b = 0; b < L::boxes; ++b)
      tma_load_2d(st + b * L::tile_box, &m_str, full + s, b * tma_map::kBoxCols, o0);
    if (first != nullptr) bulk_load(sc, first + o0, kBwdTile * 4, full + s);
    if (!OWN_Q) bulk_load(sc + kBwdTile, a.g + o0, kBwdTile * 4, full + s);
    if (use_ids)
      bulk_load(sc + 2 * kBwdTile, (OWN_Q ? a.col_ids : a.row_ids) + o0, kBwdTile * 4, full + s);
  };
  if (threadIdx.x == 0) {
    tma_prefetch_map(&m_own);
    tma_prefetch_map(&m_str);
    mbar_arrive_expect_tx(own_bar, L::boxes * L::own_box);
#pragma unroll
    for (int b = 0; b < L::boxes; ++b)
      tma_load_2d(smem + L::own + b * L::own_box, &m_own, own_bar, b * tma_map::kBoxCols, own0);
  }
  if (gt == 0)
    for (int it = 0; it < n_mine && it < L::stages; ++it) load(it);

  if (threadIdx.x < kOwn) {  // the ids sorted (a rank each; equal ids by row)
    int rank = 0;
    for (int k = 0; k < kOwn; ++k) {
      const int o = own_id[k];
      rank += (o < my_id || (o == my_id && k < static_cast<int>(threadIdx.x))) ? 1 : 0;
    }
    sorted_id[rank] = my_id;
  }
  __syncthreads();  // the sorted ids

  // the thread's two own rows (16 warp + g + 8 h): lse, g of a q row or adj of
  // a c row; id (-2 without ids), global position
  float x_r[2], g_r[2];
  int id_r[2], pos_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    x_r[h] = own_x[r];
    g_r[h] = own_g[r];
    id_r[h] = own_id[r];
    pos_r[h] = own_pos0 + r;
  }
  float acc[ND];  // the warpgroup's [64, DP] of dq or dc, f32, in the accumulator layout
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;
  mbar_wait(own_bar, 0);
  float* own_w = reinterpret_cast<float*>(smem + L::own_wide);  // (DP = 64)
  if constexpr (L::own_f32) {  // the own rows in f32, unswizzled: [64][DP]
    for (int e = threadIdx.x; e < kOwn * DP / 8; e += NW * kGroupThreads) {
      const int r = e / (DP / 8), j = e % (DP / 8);
      const uint4 u = *reinterpret_cast<const uint4*>(own_s + swizzled_chunk(r, j, L::own_box));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<float2*>(own_w + r * DP + 8 * j + 2 * m) =
            make_float2(bf16_lo(w[m]), bf16_hi(w[m]));
    }
    __syncthreads();
  }

  // the raw scores of tile `it` [64 own, 128 streamed] into s, issued and
  // committed: the DP / 16 k steps in order in one accumulator
  auto score = [&](float (&s)[64], int it) {
    const int si = it % L::stages;
    const unsigned char* st = ring + si * L::stage_bytes;
    mbar_wait(full + si, (it / L::stages) & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      wgmma_bf16<128, 0, 0>(s, kmajor_sw128(own_s + (ks >> 2) * L::own_box, ks & 3),
                            kmajor_sw128(st + (ks >> 2) * L::tile_box, ks & 3), ks);
    wgmma_commit();
  };

  // The epilogue of a tile: the scores s[i] (own row 16 warp + g + 8 h,
  // streamed row 8 j + 2 t + e of the tile, i = 4 j + 2 h + e) become p =
  // exp(s - lse) g from the adjusted score (`adjusted_score`; MASK: the tile
  // holds an id of an own row, so the mask is taken score by score), rounded
  // to bf16 and packed in pairs into pa, the A fragments of the second
  // product. Bit 2 j + h of the result: the pair of row h at columns 8 j +
  // 2 t, + 1 holds a p of weight near a bf16 rounding tie (`weight_of`,
  // `near_tie_fast`).
  auto epilogue = [&](auto mask, const float (&s)[64], uint32_t (&pa)[8][4], const float* sc,
                      const int* sid, int o0) {
    constexpr bool kMask = decltype(mask)::value;
    uint32_t pairs = 0;
    const int spos = (OWN_Q ? 0 : a.row_offset) + o0 + 2 * t;  // position of column 2 t
    const int dpos[2] = {pos_r[0] - spos, pos_r[1] - spos};
#pragma unroll
    for (int j = 0; j < kBwdTile / 8; ++j) {
      const int cl = 8 * j + 2 * t;
      const float2 x2 = *reinterpret_cast<const float2*>(sc + cl);  // adj (dq) or lse (dc)
      const float2 g2 = OWN_Q ? make_float2(1.f, 1.f)
                              : *reinterpret_cast<const float2*>(sc + kBwdTile + cl);
      const int2 id2 = kMask ? *reinterpret_cast<const int2*>(sid + cl) : make_int2(0, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bool tie = false;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool masked = kMask && id_r[h] == (e ? id2.y : id2.x) && dpos[h] != 8 * j + e;
          const float xs = e ? x2.y : x2.x;
          const float sa = adjusted_score(s[4 * j + 2 * h + e], a.inv_t, OWN_Q ? xs : x_r[h],
                                          masked);
          const float x = __fmul_rn(__fsub_rn(sa, OWN_Q ? x_r[h] : xs), kLog2e);
          float ex;
          asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(ex) : "f"(x));
          p[e] = __fmul_rn(ex, OWN_Q ? g_r[h] : (e ? g2.y : g2.x));
          tie = tie | near_tie_fast(p[e] * weight_of(x));
        }
        pa[j >> 1][2 * (j & 1) + h] = pack_bf16x2(p[0], p[1]);
        pairs |= tie ? 1u << (2 * j + h) : 0u;
      }
    }
    return pairs;
  };

  // The warpgroup's tiles in turn: the tile's scores are issued; the
  // warpgroup's barrier says which epilogue the tile needs and that the stage
  // of two tiles back is free (its second product was waited for one tile
  // ago: it is refilled); the scores and the last tile's second product are
  // waited for; the epilogue and the ties turn the scores into p, and the
  // tile's second product is issued.
  for (int it = 0; it < n_mine; ++it) {
    const int si = it % L::stages, o0 = (t0 + wg + NW * it) * kBwdTile;
    const unsigned char* st = ring + si * L::stage_bytes;
    const float* sc = reinterpret_cast<const float*>(st + L::tile_bytes);
    const int* sid = reinterpret_cast<const int*>(sc) + 2 * kBwdTile;
    const int spos0 = (OWN_Q ? 0 : a.row_offset) + o0;  // global position of column 0
    float s[64];
    score(s, it);
    // does column gt of the tile hold an id of an own row? (a binary search of
    // the sorted ids; an own row's own column holds its id too, and the mask
    // spares it)
    const int cid = sid[gt];
    int at = 0;
#pragma unroll
    for (int w = kOwn / 2; w >= 1; w >>= 1) at += sorted_id[at + w - 1] < cid ? w : 0;
    const bool mask = group_any(wg, sorted_id[at] == cid);
    if (gt == 0 && it >= 2 && it - 2 + L::stages < n_mine) load(it - 2 + L::stages);
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(acc);

    uint32_t pa[8][4];  // p rounded to bf16, packed: the second product's A fragments
    uint32_t pairs = mask ? epilogue(std::true_type(), s, pa, sc, sid, o0)
                          : epilogue(std::false_type(), s, pa, sc, sid, o0);
    // a pair with a p of weight near a bf16 rounding tie: its two p again as
    // the plain version takes them (the scores in k order, expf)
    while (pairs != 0) {
      const int k = __ffs(pairs) - 1;
      pairs &= pairs - 1;
      const int r = 16 * warp + g + 8 * (k & 1), c0 = 8 * (k >> 1) + 2 * t;
      float dot[2], v[2];
      ordered_dot2<DP>(own_s, own_w, r, st, c0, c0 + 1, dot);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + e;
        const bool masked = own_id[r] == sid[c] && own_pos0 + r != spos0 + c;
        float ex;
        v[e] = p_value<false>(adjusted_score(dot[e], a.inv_t, OWN_Q ? sc[c] : own_x[r], masked),
                              OWN_Q ? own_x[r] : sc[c], OWN_Q ? own_g[r] : sc[kBwdTile + c], ex);
      }
      set_pair(pa, k, pack_bf16x2(v[0], v[1]));
    }

    // the second product: p (64 x 128 bf16, the A operand from registers) @
    // the tile (128 x DP, MN-major), 8 k steps into acc
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_bf16_rs<DP, 1>(acc, pa[kk], smem_desc(st + 2048 * kk, L::tile_box, 1024, kSwizzle128),
                           1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // the block's sums: warpgroups 1 .. NW - 1's added to warpgroup 0's in order
  __syncthreads();  // every warpgroup is past its tiles: the ring is free
  float4* sums = reinterpret_cast<float4*>(smem + L::ring);  // [NW][ND / 4][128], fragment order
  if (wg > 0)
#pragma unroll
    for (int i = 0; i < ND / 4; ++i)
      sums[(wg * (ND / 4) + i) * kGroupThreads + gt] =
          make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  __syncthreads();
  if (wg == 0) {
    const bool whole = n_chunks == 1;  // else the chunk's sums, added by the merge launch
    float* out = (whole ? a.out : part + static_cast<size_t>(chunk) * (OWN_Q ? a.bq : a.bk) * DP) +
                 static_cast<size_t>(own0) * DP;
    for (int w = 1; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < ND / 4; ++i) {
        const float4 v = sums[(w * (ND / 4) + i) * kGroupThreads + gt];
        acc[4 * i] = __fadd_rn(acc[4 * i], v.x);
        acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], v.y);
        acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], v.z);
        acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], v.w);
      }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (whole) v = make_float2(__fmul_rn(v.x, a.inv_t), __fmul_rn(v.y, a.inv_t));
        *reinterpret_cast<float2*>(out + (16 * warp + g + 8 * h) * DP + 8 * j + 2 * t) = v;
      }
  }
}

// The end of #10 / #11 over several chunks: out[i] = (1/T) (part[0][i] +
// part[1][i] + ...), the chunks added in chunk order, four values a thread.
__global__ void __launch_bounds__(256)
    lse_bwd_merge_kernel(const float4* __restrict__ part, int n_chunks, int64_t n4, float inv_t,
                         float4* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 v = part[i];
  for (int k = 1; k < n_chunks; ++k) {
    const float4 w = part[static_cast<size_t>(k) * n4 + i];
    v = make_float4(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y), __fadd_rn(v.z, w.z),
                    __fadd_rn(v.w, w.w));
  }
  out[i] = make_float4(__fmul_rn(v.x, inv_t), __fmul_rn(v.y, inv_t), __fmul_rn(v.z, inv_t),
                       __fmul_rn(v.w, inv_t));
}

// ---- host side ---------------------------------------------------------------

// The ring's kernels: persistent blocks, at most one an SM. A runtime call
// first (it makes the device's context current on this thread, which the
// tensor maps' encoding, a driver call, needs), then `encode()` fills the
// maps among `params`.
template <typename K, typename Encode, typename... P>
int launch_ring(K kernel, int n_tiles, size_t smem, cudaStream_t stream, Encode&& encode,
                const P&... params) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!encode()) return static_cast<int>(cudaErrorInvalidValue);
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

// #9's (m, l) launch at a padded depth DP of 64 or 128 (TMA + wgmma, the
// own rows kept across a chunk), or at a wide D (the ring of k-blocks).
template <int DP>
int launch_fwd_at(const Args& a, float2* part, int chunks, cudaStream_t s) {
  CUtensorMap mq, mc;
  return launch_ring(
      lse_fwd_kernel<DP>, (a.bq / kTileM) * chunks, FwdLayout<DP>::bytes, s,
      [&] { return bf16_map(&mq, a.q, DP, a.bq, kTileM) && bf16_map(&mc, a.c, DP, a.bk, kTileN); },
      mq, mc, a, part, chunks);
}

int launch_fwd_wide(const Args& a, float2* part, int chunks, cudaStream_t s) {
  if (!wide(a.dp)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mc;
  return launch_ring(
      lse_fwd_wide_kernel, (a.bq / kTileM) * chunks, kFwdSmem, s,
      [&] {
        return bf16_map(&mq, a.q, a.dp, a.bq, kTileM) && bf16_map(&mc, a.c, a.dp, a.bk, kTileN);
      },
      mq, mc, a, part, chunks);
}

// The chunks of a backward's streamed range of n_str rows (a block each an
// own tile): a function of the length alone, whole 128-row tiles (16 at least
// each where there are several), at most kBwdMaxChunks; `bwd_chunks` in
// ops/softmax_kernel.py is the same rule.
int bwd_chunks(int64_t n_str) {
  const int64_t k = n_str / kBwdChunkRows;
  return static_cast<int>(k < 1 ? 1 : (k > kBwdMaxChunks ? kBwdMaxChunks : k));
}

// #10 (OWN_Q) or #11 at a padded depth DP of 64 or 128: a runtime call first
// (it makes the device's context current on this thread, which the tensor
// maps' encoding, a driver call, needs), the maps, the launch over n_own / 64
// own tiles x the chunks, then the chunks' merge where there are several.
template <int DP, bool OWN_Q>
int launch_bwd_at(const Args& a, float* part, cudaStream_t stream) {
  auto kernel = lse_bwd_kernel<DP, OWN_Q>;
  constexpr size_t smem = BwdLayout<DP>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_own = OWN_Q ? a.bq : a.bk, n_str = OWN_Q ? a.bk : a.bq;
  const int chunks = bwd_chunks(n_str);
  if (chunks > 1 && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap m_own, m_str;
  if (!bf16_map(&m_own, OWN_Q ? a.q : a.c, DP, n_own, kOwn) ||
      !bf16_map(&m_str, OWN_Q ? a.c : a.q, DP, n_str, kBwdTile))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(n_own / kOwn * chunks), bwd_warpgroups<DP>() * kGroupThreads, smem,
           stream>>>(
      m_own, m_str, a, chunks, part);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int64_t n4 = int64_t(n_own) * DP / 4;
  lse_bwd_merge_kernel<<<static_cast<unsigned>((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), chunks, n4, a.inv_t, reinterpret_cast<float4*>(a.out));
  return static_cast<int>(cudaGetLastError());
}

template <bool OWN_Q>
int launch_bwd(const Args& a, void* part, cudaStream_t s) {
  auto* pr = static_cast<float*>(part);
  if (a.dp == 64) return launch_bwd_at<64, OWN_Q>(a, pr, s);
  if (a.dp == 128) return launch_bwd_at<128, OWN_Q>(a, pr, s);
  return static_cast<int>(cudaErrorInvalidValue);  // a wide D: the p kernel and the products
}

template <int DP, bool OWN_Q>
int bwd_plan_at(int64_t n_str, int64_t* out) {
  auto kernel = lse_bwd_kernel<DP, OWN_Q>;
  constexpr size_t smem = BwdLayout<DP>::bytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        bwd_warpgroups<DP>() * kGroupThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = bwd_chunks(n_str);
  out[1] = blocks;
  out[2] = static_cast<int64_t>(smem);
  return 0;
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t code: 0 when the launch succeeded.
// adj may be null; row_ids and col_ids are both null or both set.

// #9: lse_out [bq] through the caller's workspace part ([n_chunks, bq] f32
// pairs, 16-byte aligned), n_chunks from 1 to bk / 128 (the column chunks: a
// function of bk alone, so a stripe's lse is the square's rows). Two
// launches: the chunks' (m, l), then their merge.
int ttrm_softmax_lse_fwd(const void* q, const void* c, const void* adj, const void* row_ids,
                         const void* col_ids, void* lse_out, void* part, int64_t n_chunks,
                         int64_t bq, int64_t bk, int64_t dp, int64_t row_offset, float inv_t,
                         void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids) || n_chunks < 1 ||
      n_chunks > bk / kTileN)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, nullptr, nullptr, lse_out, bq, bk, dp,
                           row_offset, inv_t);
  if (!all_aligned(a) || !aligned16(part)) return static_cast<int>(cudaErrorMisalignedAddress);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pr = static_cast<float2*>(part);
  const int chunks = static_cast<int>(n_chunks);
  const int err = dp == 64    ? launch_fwd_at<64>(a, pr, chunks, s)
                  : dp == 128 ? launch_fwd_at<128>(a, pr, chunks, s)
                              : launch_fwd_wide(a, pr, chunks, s);
  if (err != 0) return err;
  lse_merge_kernel<<<static_cast<unsigned>((bq + 255) / 256), 256, 0, s>>>(
      pr, chunks, static_cast<int>(bq), static_cast<float*>(lse_out));
  return static_cast<int>(cudaGetLastError());
}

// #10 and #11 at D <= 128 (a padded depth of 64 or 128). part: the caller's
// workspace of the chunks' sums, [bwd_chunks(n_str), n_own, dp] f32 (n_str =
// bk, n_own = bq for dq; the other way round for dc), 16-byte aligned; null
// where there is one chunk (n_str < 4,096). Two launches where there are
// several: the chunks' sums, then their merge in chunk order.
int ttrm_softmax_lse_dq(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dq_out,
                        void* part, int64_t bq, int64_t bk, int64_t dp, int64_t row_offset,
                        float inv_t, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dq_out, bq, bk, dp, row_offset,
                           inv_t);
  if (!all_aligned(a) || !aligned16(part)) return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_bwd<true>(a, part, static_cast<cudaStream_t>(stream));
}

int ttrm_softmax_lse_dc(const void* q, const void* c, const void* adj, const void* row_ids,
                        const void* col_ids, const void* lse, const void* g, void* dc_out,
                        void* part, int64_t bq, int64_t bk, int64_t dp, int64_t row_offset,
                        float inv_t, void* stream) {
  if (!shapes_ok(bq, bk, dp, row_offset, row_ids, col_ids))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(q, c, adj, row_ids, col_ids, lse, g, dc_out, bq, bk, dp, row_offset,
                           inv_t);
  if (!all_aligned(a) || !aligned16(part)) return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_bwd<false>(a, part, static_cast<cudaStream_t>(stream));
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
  const int n_tiles = static_cast<int>(rows / kTileM * (bk / kTileN));
  CUtensorMap mq, mc;
  return launch_ring(
      lse_p_kernel, n_tiles, kPSmem, static_cast<cudaStream_t>(stream),
      [&] { return bf16_map(&mq, q, dp, bq, kTileM) && bf16_map(&mc, c, dp, bk, kTileN); }, mq, mc,
      a, static_cast<uint16_t*>(p_out), static_cast<int>(lo), static_cast<int>(rows));
}

// #10's product at a wide D: dq_out ([rows, dp] f32) = (1/T) p ([rows, bk]
// bf16) @ c ([bk, dp] bf16).
int ttrm_softmax_lse_dq_product(const void* p, const void* c, void* dq_out, int64_t rows,
                                int64_t bk, int64_t dp, float inv_t, void* stream) {
  if (!panel_ok(rows, bk, dp)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(p) || !aligned16(c) || !aligned16(dq_out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_tm = static_cast<int>(rows / kTileM), n_tn = static_cast<int>(dp / kTileN);
  CUtensorMap ma, mb;
  return launch_ring(
      lse_product_kernel<false>, n_tm * n_tn, kWideSmem, static_cast<cudaStream_t>(stream),
      [&] { return bf16_map(&ma, p, bk, rows, kTileM) && bf16_map(&mb, c, dp, bk, kTileK); }, ma,
      mb, static_cast<float*>(dq_out), n_tm, n_tn, static_cast<int>(bk / kTileK),
      static_cast<int>(dp), inv_t, 1, 1);
}

// #11's product at a wide D: dc ([bk, dp] f32) = (first ? 0 : dc) + p^T
// ([rows, bk] bf16) @ q_rows ([rows, dp] bf16), then times 1/T if `last`.
int ttrm_softmax_lse_dc_product(const void* p, const void* q_rows, void* dc, int64_t rows,
                                int64_t bk, int64_t dp, float inv_t, int64_t first, int64_t last,
                                void* stream) {
  if (!panel_ok(rows, bk, dp)) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(p) || !aligned16(q_rows) || !aligned16(dc))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int n_tm = static_cast<int>(bk / kTileM), n_tn = static_cast<int>(dp / kTileN);
  CUtensorMap ma, mb;
  return launch_ring(
      lse_product_kernel<true>, n_tm * n_tn, kWideSmem, static_cast<cudaStream_t>(stream),
      [&] { return bf16_map(&ma, p, bk, rows, kTileK) && bf16_map(&mb, q_rows, dp, rows, kTileK); },
      ma, mb, static_cast<float*>(dc), n_tm, n_tn, static_cast<int>(rows / kTileK),
      static_cast<int>(dp), inv_t, first != 0 ? 1 : 0, last != 0 ? 1 : 0);
}

// The launch plan of #10 (own_q) or #11 at a padded depth dp of 64 or 128
// over a streamed range of n_str rows, into out[3]: the range's chunks (a
// block each an own tile; a merge launch where there are several), the
// blocks an SM holds at once, a block's shared memory in bytes. Launches
// nothing.
int ttrm_softmax_lse_bwd_plan(int64_t n_str, int64_t dp, int64_t own_q, int64_t* out,
                              void* /*stream*/) {
  if (n_str <= 0 || n_str % kRowMultiple != 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dp == 64) return own_q ? bwd_plan_at<64, true>(n_str, out) : bwd_plan_at<64, false>(n_str, out);
  if (dp == 128)
    return own_q ? bwd_plan_at<128, true>(n_str, out) : bwd_plan_at<128, false>(n_str, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
