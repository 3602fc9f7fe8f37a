// Fused two-layer tower forward for Hopper (sm_90a), bf16 in and out:
//
//   r1  = bf16(x @ W1)                       (f32 sums, one rounding)
//   h1  = relu(bf16(r1' + b1))               (r1' = r1, or at a tie the k-order sum)
//   r2  = bf16(h1 @ W2)
//   out = relu(bf16(r2' + b2))
//
// for x [B, 128], W1 [128, 128], b1 [128], W2 [128, H2] (0 < H2 <= 128), b2
// [H2], the weights in the reference's [in, out] layout with any strides (an
// `nn.Linear` weight's transpose is read as it lies), B a multiple of 64.
// The ties and their k-order recompute are relu_ties's (relu_ties.cuh): a
// value r whose bf16 neighbour decides the ReLU other than r does (r = -b or
// the bf16 value above it) is summed again as an f32 GEMM sums it, one fmaf
// a k in k order, so the forward makes the ReLU decisions the tower backward
// (#8), the plain version and the host make. Every rounding point is the
// two-GEMM route's (`_mm` then relu_ties, each layer); only the order of the
// tensor cores' sums may differ from cuBLAS's.
//
// Replaces no TPU kernel: the reference's `_mlp2_fwd_impl`
// (two_tower_recommender_model_tpu/models/mlp.py:89) is two dots that XLA
// fuses with their bias and ReLU. On the card it replaces the route of
// two cuBLAS GEMMs, each followed by relu_ties (csrc/relu_ties.cu).
//
// What bounds it: bytes. At B = 262,144, H2 = 64 it reads x (67.1 MB) and
// writes out (33.6 MB), 0.030 ms at 3.35 TB/s; its 12.9 GFLOP take 0.013 ms
// at the tensor cores' 989 TFLOP/s (128 FLOP a byte, under the card's ~295).
// h1 never reaches device memory: a tile's h1 is written to shared memory
// by layer 1's epilogue and read from there by layer 2's products and by
// layer 2's tie recompute, which needs whole h1 rows.
//
// A tile is 64 rows. Measured on an H100 (chip_smoke.py's tile split at
// [262,144, 128 -> 128 -> 64]), the previous design (x by cp.async one tile
// ahead, each product waited for at once, a warpgroup's tie rounds behind
// named barriers, the output staged in x's stage) spent its 0.086 ms on the
// x loads (0.046 alone) and the tie rounds (+0.034), not on the products.
// So:
//   - Persistent blocks, one an SM: consumer warpgroups (four at H2P = 64,
//     three at 128: as many as shared memory holds), each walking its own
//     tiles, the block's tiles dealt to them in turn, and a producer warp,
//     one thread of which keeps x tiles in flight by TMA into a ring of 4
//     stages a block, each tile two [64, 64] boxes with the 128-byte swizzle
//     that the wgmma descriptors read; full / empty mbarriers hand a stage to
//     its consumer and back. (Measured and dropped: a producer warpgroup
//     handing registers to the consumers by setmaxnreg, for which ptxas
//     kept the consumers within the launch's share and spilled; a ring
//     deeper than 4 stages; consumers that load their stage's next tile
//     themselves, no faster at H2 = 64 and slower at 128.) W1 and W2 (W2
//     zero-padded to H2P = 64 or 128 columns), b1, b2 and the tie bounds d
//     are loaded into shared memory once a block, under the first loads.
//   - Products: wgmma (m64n128k16 and m64nH2Pk16, bf16 x bf16 -> f32, k in
//     order), both operands read by the tensor cores from shared memory: the
//     x stage and W1, then the h1 tile and W2 (these two interleaved K-major
//     in 8 x 16-byte core matrices, 2,048 bytes an 8-row block of 128 k).
//     A tile's layer-1 product is issued as soon as its stage is full and
//     waited for only when its sums are needed.
//   - Epilogues in registers, two values of a row at once (an instance for
//     H2 == H2P, the towers' widths, whose layer-2 epilogue takes no branch
//     on H2): the f32 sums rounded to bf16 (cvt.rn.bf16x2), pre = bf16(r +
//     b) in one bf16x2 add, the tie test 0 <= pre <= d on pre (relu_ties.cuh
//     holds it equal to relu_tie), ReLU to positive zero, a 4-byte store to
//     shared memory; b and d come in a layout that a thread loads at once.
//   - Ties (~0.15% of the values on the towers' draws: some 13 a tile in
//     layer 1, 7 in layer 2) are pooled by the warpgroup and summed again
//     by the lanes of one warp (`settle_ties`; on inputs dense with ties,
//     by the threads that hold them): a tile's ties cost one 128-fmaf chain
//     of latency, whose operands are loaded ahead of it, and two barriers
//     (one without ties). Layer 1's ties are settled before layer 2's
//     products, which read h1; layer 2's ties gate only the output, so they
//     are settled in the next tile's turn, under its layer-1 product. Each
//     output is written by its epilogue, then once more if it ties, before
//     its tile's store: two launches on the same inputs give the same bits.
//   - The output is staged in a stage of its own (a consumer's, not x's: x's
//     stage is released as soon as layer 1's ties are done) and written by
//     one TMA store a 64-column box (H2 of 64 or 128), else by one bulk copy
//     of the tile's 128 H2 bytes; a store is waited for only before its stage
//     is written again.
//
// Binding: a plain C interface loaded with ctypes. One launch on the caller's
// stream; it allocates nothing and synchronises nothing, and its grid depends
// only on B and the SM count (the wrapper passes the SM count), so it can be
// captured in a CUDA graph. The entry point returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cannot be encoded.
//
// `ttrm_tower_fwd_split` runs the kernel at H2 = 64 up to one stage (the
// loads alone; and the products; and the epilogues, ties taken as none; and
// the tie rounds): chip_smoke.py times a tile's parts with it. Its output is
// not the function's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "relu_ties.cuh"
#include "tma_map.cuh"
#include "wgmma_sm90.cuh"

namespace {

using relu_ties::finish;
using relu_ties::pre_bias2;
using relu_ties::relu2;
using relu_ties::rnd;
using relu_ties::tie_ceiling;
using relu_ties::ties2;
using namespace wgmma_sm90;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kD = 128;            // d_in == h1
constexpr int kT = 64;             // rows a tile: one wgmma's M
constexpr int kGroupThreads = 128;
constexpr int kPool = 128;         // tie entries a warpgroup's list holds
constexpr int kMaxSmem = 232448;
constexpr int kBlockBytes = 2048;  // an 8-row block of an interleaved tile: 16 core matrices
constexpr int kBoxCols = tma_map::kBoxCols;
constexpr int kBoxBytes = kT * kBoxCols * 2;  // a [64, 64] bf16 TMA box: 8 KB
constexpr int kTileBytes = kT * kD * 2;       // [64, 128] bf16

// What a launch runs: the whole kernel, or (to time a tile's parts) the
// kernel up to a stage, the later stages left out
enum Split : int { kWhole = 0, kLoads = 1, kProducts = 2, kEpilogues = 3, kTies = 4 };

// Element offset of (r, k) in an interleaved K-major tile of 128 k: 8 x 8
// core matrices of 128 contiguous bytes, 16 of them along k (128 bytes
// apart), then the next 8 rows (2,048 bytes on).
__device__ __forceinline__ int ilv(int r, int k) {
  return (r >> 3) * (kBlockBytes / 2) + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
}

// Byte offset of chunk j (k = 8 j .. 8 j + 7) of row r in an x stage: two
// TMA boxes [64 rows, 64 k], the 16-byte chunks of a row XOR-ed with r % 8
__device__ __forceinline__ int x_chunk(int r, int j) {
  return (j >> 3) * kBoxBytes + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

// Element offset of output (r, c) in the output stage: for H2 of 64 or 128,
// [64, 64] boxes with the 128-byte swizzle, as the TMA store reads them;
// else row-major [64][h2], the tile's run of device memory as it lies.
__device__ __forceinline__ int out_off(int r, int c, int h2, bool boxes) {
  return boxes ? (c >> 6) * (kT * kBoxCols) + r * kBoxCols + ((((c & 63) >> 3) ^ (r & 7)) << 3) +
                     (c & 7)
               : r * h2 + c;
}

// Shared-memory layout (byte offsets) for H2P = 64 or 128: barriers, biases
// and tie lists, then from the next 1,024-byte boundary (the 128-byte
// swizzle's atoms) the weights, the x ring and each consumer's h1 tile and
// output stage.
template <int H2P>
struct Layout {
  // consumer warpgroups a block, each walking its own tiles: as many as
  // shared memory holds (four at H2P = 64; three at 128)
  static constexpr int consumers = H2P == 64 ? 4 : 3;
  static constexpr int threads = consumers * kGroupThreads + 32;  // and the producer warp
  static constexpr int stages = 4;                            // x tiles in the ring
  static constexpr size_t full = 0;                           // [stages] mbarriers
  static constexpr size_t empty = full + stages * 8;          // [stages]
  // b and the tie bounds d of each layer in `by_lane` order
  static constexpr size_t b1 = empty + stages * 8;            // [128] bf16
  static constexpr size_t d1 = b1 + kD * 2;                   // [128] bf16
  static constexpr size_t b2 = d1 + kD * 2;                   // [H2P] bf16, 0 past h2
  static constexpr size_t d2 = b2 + H2P * 2;                  // [H2P] bf16, -1 past h2
  static constexpr size_t counts = d2 + H2P * 2;              // [consumers][4] int: the layers'
                                                              // tie counts
  static constexpr size_t ties = counts + consumers * 16;     // [consumers][kPool] uint16
  static constexpr size_t small = ties + consumers * kPool * 2;
  // from the aligned base
  static constexpr size_t w1 = 0;                             // [128 n][128 k], interleaved
  static constexpr size_t w2 = w1 + size_t(kD) * kD * 2;      // [H2P n][128 k], 0 past h2
  static constexpr size_t ring = w2 + size_t(H2P) * kD * 2;   // [stages] x tiles, two boxes each
  static constexpr size_t groups = ring + size_t(stages) * kTileBytes;
  static constexpr size_t g_h1 = 0;                           // a consumer's h1 tile, interleaved
  static constexpr size_t g_out = g_h1 + kTileBytes;          // its output stage [64, H2P]
  static constexpr size_t group_bytes = g_out + size_t(kT) * H2P * 2;
  // the aligned base is at most 1,008 bytes past `small` (shared memory is on 16-byte boundaries)
  static constexpr size_t bytes = small + 1008 + groups + consumers * group_bytes;
  static_assert(small % 16 == 0 && bytes <= kMaxSmem, "shared memory");
  static_assert(group_bytes % 1024 == 0 && groups % 1024 == 0, "1,024-byte alignment");
};

__device__ __forceinline__ void group_sync(int group) {  // a consumer warpgroup's barrier
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kGroupThreads) : "memory");
}

// this thread's shared-memory writes made visible to the tensor cores' and the TMA's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma matrix descriptor of an interleaved K-major tile at p, no swizzle:
// 16-byte core matrix rows, 128 bytes between core matrices along k, 2,048
// along m / n.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return smem_desc(p, 128, kBlockBytes, kNoSwizzle);
}

// k step ks (16 deep) of an x stage: box ks / 4, 32 bytes a step within it
__device__ __forceinline__ uint64_t x_desc(const unsigned char* xs, int ks) {
  return smem_desc(xs + (ks >> 2) * kBoxBytes + 32 * (ks & 3), 16, 1024, kSwizzle128);
}

// Stores from shared memory to device memory, tracked in this thread's bulk
// groups: a 2-D TMA box of `map` at (c0, c1) from src, or `bytes` (a
// multiple of 16) copied as they lie from src to dst (both on 16-byte
// boundaries). The writes of src are made visible to the async proxy first
// (fence.proxy.async, then a barrier where other threads wrote them).
__device__ __forceinline__ void tma_store_2d(const void* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of this thread's bulk groups still read their shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until at most N of this thread's bulk groups are still in flight (their writes done)
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where column c of a layer of width n keeps its bias and tie bound: the
// pairs (8 j + 2 t, + 1) that lane t % 4 of an accumulator fragment holds
// are contiguous, j in order, so a thread loads all of its pairs at once.
__device__ __forceinline__ int by_lane(int c, int n) {
  return ((c >> 1) & 3) * (n / 4) + (c >> 3) * 2 + (c & 1);
}

// a shared-memory load that the compiler issues where it is written: the
// operands of a dependent chain, fetched ahead of their use
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

// This thread's n / 8 pairs of a layer's values kept in `by_lane` order
template <int N>
__device__ __forceinline__ void lane_pairs(uint32_t (&v)[N / 8], const uint16_t* s, int tq) {
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const uint4 q = lds128(s + tq * (N / 4) + 8 * i);
    v[4 * i] = q.x, v[4 * i + 1] = q.y, v[4 * i + 2] = q.z, v[4 * i + 3] = q.w;
  }
}

__device__ __forceinline__ bf162 as_pair(uint32_t v) { return *reinterpret_cast<bf162*>(&v); }

// W [128 (k), n] with element strides (sk, sn) into ws, K-major [n_rows][128]
// (a column of W is a row), rows from n_valid on zero. Where k has unit
// stride (an `nn.Linear` weight's transpose: the towers' layout) by 16-byte
// loads, all of a thread's started before its stores; else one value a
// load, neighbouring threads on neighbouring n where n has unit stride.
template <int kThreads>
__device__ __forceinline__ void load_weight(uint16_t* ws, const uint16_t* __restrict__ w,
                                            int64_t sk, int64_t sn, int n_valid, int n_rows,
                                            int tid) {
  constexpr int kPer = (kD * kD / 8 + kThreads - 1) / kThreads;  // 16-byte chunks a thread
  if (sk == 1 && sn % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {  // chunk (n, 8 k)
    uint4 v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads, n = e >> 4;
      v[u] = n < n_valid && e < n_rows * 16
                 ? __ldg(reinterpret_cast<const uint4*>(w + n * sn + (e & 15) * 8))
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      if (e < n_rows * 16) *reinterpret_cast<uint4*>(ws + ilv(e >> 4, (e & 15) * 8)) = v[u];
    }
  } else if (sn == 1) {
#pragma unroll 8
    for (int e = tid; e < kD * n_rows; e += kThreads) {
      const int n = e % n_rows, k = e / n_rows;
      ws[ilv(n, k)] = n < n_valid ? w[k * sk + n] : 0;
    }
  } else {
#pragma unroll 8
    for (int e = tid; e < kD * n_rows; e += kThreads) {
      const int k = e % kD, n = e / kD;
      ws[ilv(n, k)] = n < n_valid ? w[k * sk + n * sn] : 0;
    }
  }
}

// A lane's tie flags of one layer: pair p (= 2 j + h: columns 8 j + 2 t,
// + 1 of row r0 + 8 h) in word p / 16, its low value at bit p % 16 and its
// high value at bit 16 + p % 16. `flag_pair` takes them from ties2's t
// (bf16 1.0, 0x3f80, in each half that ties: bits 7 and 23) in one shift
// and one and-or; p is constant once unrolled.
__device__ __forceinline__ void flag_pair(uint32_t (&m)[2], uint32_t t, int p) {
  const int q = p & 15;
  m[p >> 4] |= (q <= 7 ? t >> (7 - q) : t << (q - 7)) & (0x00010001u << q);
}

// (row << 7 | col) of bit b of a lane's 64 tie flags (word b / 32, as `flag_pair`)
__device__ __forceinline__ uint32_t tie_at(int b, int r0, int tq) {
  const int p = 16 * (b >> 5) + (b & 15), i = (b >> 4) & 1;
  return static_cast<uint32_t>((r0 + 8 * (p & 1)) << 7 | (8 * (p >> 1) + 2 * tq + i));
}

// A warpgroup's tied values of one layer summed again (every thread of the
// warpgroup calls it). A lane with flagged values (`mask`, bits as
// `tie_at`) reserves a run of the warpgroup's list with one shared-memory
// atomic on `count` (the runs' order may vary from launch to launch; each
// entry is a value of its own, so the output does not) and writes the
// entries that fit. After the warpgroup's barrier, if all fit (kPool: the
// towers' tiles hold some 13 ties in layer 1, 7 in layer 2), they go to the
// lanes of as few warps as they fill, from warp `rot` on (the warpgroups'
// chains then fall on different schedulers), `redo(row, col)` each: one
// chain of latency and the instructions of one warp, not of each warp that
// holds a tie. Else (inputs dense with ties) each thread sums its own
// flagged values again, in bit order. Each barrier is fenced: the caller's
// shared-memory writes and the recomputed values are visible to the async
// proxy too after it. With no tie in the warpgroup, the first barrier is
// the only one. Each output is written by its epilogue, then once more if it
// ties, before the last barrier: two launches give the same bits.
template <typename Redo>
__device__ __forceinline__ void settle_ties(uint64_t mask, int group, int gw, int lane, int rot,
                                            int r0, int tq, uint16_t* list, int* count,
                                            Redo redo) {
  const int cnt = __popcll(mask);
  int idx = cnt ? atomicAdd(count, cnt) : 0;  // the list index of this lane's first entry
  for (uint64_t m = mask; m && idx < kPool; m &= m - 1, ++idx)
    list[idx] = tie_at(__ffsll(static_cast<long long>(m)) - 1, r0, tq);
  fence_async_shared();
  group_sync(group);  // the caller's writes, the count and the list
  const int total = *count;
  if (total == 0) return;
  if (total > kPool) {
    for (uint64_t m = mask; m; m &= m - 1) {
      const uint32_t e = tie_at(__ffsll(static_cast<long long>(m)) - 1, r0, tq);
      redo(static_cast<int>(e >> 7), static_cast<int>(e & 127u));
    }
  } else {
    const int mine = ((gw - rot) & 3) * 32 + lane;  // this thread's entry, if any
    if (mine < total) {
      const uint32_t e = list[mine];
      redo(static_cast<int>(e >> 7), static_cast<int>(e & 127u));
    }
  }
  fence_async_shared();
  group_sync(group);  // the recomputed values; the list is free again
  if (gw == 0 && lane == 0) *count = 0;  // every thread has read it; the next use is after
                                         // the other layer's barriers
}

// The k-order sum of two rows of 128 bf16 values, chunk j (k = 8 j .. 8 j +
// 7) of each at at_a(j) and at_w(j) in shared memory: one fmaf a k in k
// order, as relu_ties's ordered_dot_chunks sums it. Each chunk is loaded two
// chunks ahead of its fmaf, so the chain does not wait for shared memory,
// and a bf16 value is widened to f32 by a shift of its bits (exact, as the
// conversion instruction): a tie costs one dependent chain of 128 fmaf.
template <typename AtA, typename AtW>
__device__ __forceinline__ float row_dot(AtA at_a, AtW at_w) {
  constexpr int kAhead = 2, kChunks = kD / 8;
  uint4 a[kAhead + 1], w[kAhead + 1];
#pragma unroll
  for (int j = 0; j < kAhead; ++j) {
    a[j] = lds128(at_a(j));
    w[j] = lds128(at_w(j));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    if (j + kAhead < kChunks) {
      a[(j + kAhead) % (kAhead + 1)] = lds128(at_a(j + kAhead));
      w[(j + kAhead) % (kAhead + 1)] = lds128(at_w(j + kAhead));
    }
    const uint4 ac = a[j % (kAhead + 1)], wc = w[j % (kAhead + 1)];
    const uint32_t av[4] = {ac.x, ac.y, ac.z, ac.w}, wv[4] = {wc.x, wc.y, wc.z, wc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // the lower k in the low half
      s = fmaf(__uint_as_float(av[e] << 16), __uint_as_float(wv[e] << 16), s);
      s = fmaf(__uint_as_float(av[e] & 0xffff0000u), __uint_as_float(wv[e] & 0xffff0000u), s);
    }
  }
  return s;
}

// The k-order sum of row r of an x stage and row c of the interleaved W1
__device__ __forceinline__ float x_dot(const unsigned char* xs, int r, const bf16* w, int c) {
  const bf16* wr = w + ilv(c, 0);
  return row_dot([&](int j) { return xs + x_chunk(r, j); },
                 [&](int j) { return wr + j * 64; });  // 128 bytes a chunk
}

// The k-order sum of row r of tile a and row c of tile w (both interleaved)
__device__ __forceinline__ float tile_dot(const bf16* a, int r, const bf16* w, int c) {
  const bf16* ar = a + ilv(r, 0);
  const bf16* wr = w + ilv(c, 0);
  return row_dot([&](int j) { return ar + j * 64; }, [&](int j) { return wr + j * 64; });
}

// EXACT: h2 == H2P (the towers' widths): the layer-2 epilogue takes no
// branch on h2 and the output goes out by TMA boxes through `mo`.
template <int H2P, bool EXACT, int SPLIT>
__global__ void __launch_bounds__(Layout<H2P>::threads, 1)
tower_fwd_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mo,
                 bf16* __restrict__ out, const uint16_t* __restrict__ w1, int64_t w1_sk,
                 int64_t w1_sn, const uint16_t* __restrict__ b1, const uint16_t* __restrict__ w2,
                 int64_t w2_sk, int64_t w2_sn, const uint16_t* __restrict__ b2, int64_t n_tiles,
                 int h2_arg) {
  using L = Layout<H2P>;
  constexpr int S = L::stages;
  constexpr bool kProduct = SPLIT != kLoads, kEpilogue = SPLIT == kWhole || SPLIT >= kEpilogues;
  constexpr bool kSettle = SPLIT == kWhole || SPLIT == kTies, kStore = SPLIT == kWhole;
  const int h2 = EXACT ? H2P : h2_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L::empty);
  uint16_t* b1s = reinterpret_cast<uint16_t*>(smem + L::b1);
  uint16_t* d1s = reinterpret_cast<uint16_t*>(smem + L::d1);
  uint16_t* b2s = reinterpret_cast<uint16_t*>(smem + L::b2);
  uint16_t* d2s = reinterpret_cast<uint16_t*>(smem + L::d2);
  unsigned char* base = smem + L::small;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  uint16_t* w1s = reinterpret_cast<uint16_t*>(base + L::w1);
  uint16_t* w2s = reinterpret_cast<uint16_t*>(base + L::w2);
  unsigned char* ring = base + L::ring;

  const int tid = threadIdx.x;
  constexpr int kConsumers = L::consumers, kThreads = L::threads;
  // the thread of the producer warp (after the consumers' warps) that issues the loads
  constexpr int kProducer = kConsumers * kGroupThreads;
  // the block's tiles: blockIdx.x + q gridDim.x for q = 0, 1, ...; tile q in stage q % S
  auto tile_of = [&](int64_t q) { return static_cast<int64_t>(blockIdx.x) + q * gridDim.x; };
  auto produce = [&](int64_t q) {
    const int s = static_cast<int>(q % S);
    if (q >= S) mbar_wait(empty + s, static_cast<uint32_t>((q / S - 1) & 1));
    mbar_arrive_expect_tx(full + s, kTileBytes);
    unsigned char* st = ring + size_t(s) * kTileBytes;
    const int row = static_cast<int>(tile_of(q) * kT);
    tma_load_2d(st, &mx, full + s, 0, row);
    tma_load_2d(st + kBoxBytes, &mx, full + s, kBoxCols, row);
  };

  if (tid == kProducer) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 1);  // the consuming warpgroup's release
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == kProducer) {  // the ring's first tiles, on their way while the weights load
    tma_prefetch_map(&mx);
    for (int64_t q = 0; q < S && tile_of(q) < n_tiles; ++q) produce(q);
  }

  // the weights, K-major (a column of W is a row); biases, and the tie bounds
  // d = bf16(next_above(-b) + b)
  load_weight<kThreads>(w1s, w1, w1_sk, w1_sn, kD, kD, tid);
  load_weight<kThreads>(w2s, w2, w2_sk, w2_sn, h2, H2P, tid);
  for (int c = tid; c < kD; c += kThreads) {
    b1s[by_lane(c, kD)] = b1[c];
    d1s[by_lane(c, kD)] = __bfloat16_as_ushort(tie_ceiling(b1[c]));
  }
  for (int c = tid; c < H2P; c += kThreads) {  // padded columns: pre = 0 > d = -1, no tie
    b2s[by_lane(c, H2P)] = c < h2 ? b2[c] : 0;
    d2s[by_lane(c, H2P)] = c < h2 ? __bfloat16_as_ushort(tie_ceiling(b2[c])) : 0xbf80u;
  }
  if (tid < 4 * kConsumers) reinterpret_cast<int*>(smem + L::counts)[tid] = 0;
  fence_async_shared();
  __syncthreads();

  if (tid >= kProducer) {  // the producer warp: one thread keeps the ring full
    if (tid == kProducer)
      for (int64_t q = S; tile_of(q) < n_tiles; ++q) produce(q);
    return;
  }

  const int cw = tid / kGroupThreads, gt = tid % kGroupThreads;
  const int lane = tid & 31, gw = gt >> 5, g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * gw + g;  // this thread's rows of a tile: r0 and r0 + 8
  unsigned char* gbase = base + L::groups + cw * L::group_bytes;
  bf16* h1s = reinterpret_cast<bf16*>(gbase + L::g_h1);
  uint16_t* os = reinterpret_cast<uint16_t*>(gbase + L::g_out);
  // this warpgroup's tie list, for both layers in turn, and each layer's
  // count (each is reset after its last use, two barriers before the next)
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + L::ties) + cw * kPool;
  int* count1 = reinterpret_cast<int*>(smem + L::counts) + cw * 4;
  int* count2 = count1 + 1;

  // A tile's output, once its layer-2 epilogue has staged it: its ties
  // (this thread's in m2) summed again into the stage (ending with the
  // warpgroup's barrier: the output whole, h1 free for the next tile), then
  // one thread's store.
  uint64_t m2 = 0;
  auto settle_out = [&]() {
    settle_ties(kSettle ? m2 : 0, cw, gw, lane, cw + 2, r0, tq, list, count2,
                [&](int row, int col) {
                  const float r = rnd(tile_dot(h1s, row, reinterpret_cast<const bf16*>(w2s), col));
                  os[out_off(row, col, h2, EXACT)] =
                      finish(r, __bfloat162float(__ushort_as_bfloat16(b2s[by_lane(col, H2P)])));
                });
  };
  auto store_out = [&](int64_t tile) {
    if (kStore && gt == 0) {
      if (EXACT) {
#pragma unroll
        for (int b = 0; b < H2P / kBoxCols; ++b)
          tma_store_2d(&mo, os + b * kT * kBoxCols, b * kBoxCols, static_cast<int>(tile * kT));
      } else {
        bulk_store(out + tile * kT * h2, os, static_cast<uint32_t>(kT * h2 * 2));
      }
      bulk_commit();
    }
  };

  int64_t prev = -1;  // the tile whose output waits for its layer-2 ties and its store
  for (int64_t q = cw; tile_of(q) < n_tiles; q += kConsumers) {
    const int64_t tile = tile_of(q);
    const int s = static_cast<int>(q % S);
    const unsigned char* xs = ring + size_t(s) * kTileBytes;
    mbar_wait(full + s, static_cast<uint32_t>((q / S) & 1));

    // ---- layer 1: h1 = relu(bf16(x W1 + b1)) into shared memory ----------------------------
    float acc[64];
    if (kProduct) {  // issued now, waited for after the last tile's layer-2 ties
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        wgmma_bf16<128, 0, 0>(acc, x_desc(xs, ks),
                              kmajor_desc(reinterpret_cast<const bf16*>(w1s) + ks * 128), ks > 0);
      wgmma_commit();
    }
    if (prev >= 0) settle_out();
    if (kProduct) {
      wgmma_wait<0>();
      fence_operands(acc);
    }
    if (prev >= 0) store_out(prev);
    uint64_t m1 = 0;
    if (kEpilogue) {
      uint32_t bv[kD / 8], dv[kD / 8];
      lane_pairs<kD>(bv, b1s, tq);
      lane_pairs<kD>(dv, d1s, tq);
      uint32_t m[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * tq;
        const bf162 b = as_pair(bv[j]), d = as_pair(dv[j]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf162 pre = pre_bias2(__floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                            acc[4 * j + 2 * h + 1]), b);
          const int p = 2 * j + h;
          flag_pair(m, ties2(pre, d), p);
          *reinterpret_cast<bf162*>(h1s + ilv(r0 + 8 * h, c)) = relu2(pre);
        }
      }
      m1 = uint64_t(m[1]) << 32 | m[0];
    }
    if (kStore && gt == 0) bulk_wait_read<0>();  // the last store has read the output stage
    // then, after the warpgroup's barrier(s): h1 whole, for the tensor cores; the output
    // stage free
    settle_ties(kSettle ? m1 : 0, cw, gw, lane, cw, r0, tq, list, count1,
                [&](int row, int col) {
                  const float r = rnd(x_dot(xs, row, reinterpret_cast<const bf16*>(w1s), col));
                  reinterpret_cast<uint16_t*>(h1s)[ilv(row, col)] =
                      finish(r, __bfloat162float(__ushort_as_bfloat16(b1s[by_lane(col, kD)])));
                });
    if (gt == 0) mbar_arrive(empty + s);  // the warpgroup is done with the x stage

    // ---- layer 2: h1 W2 -> the output stage; its ties wait for the next turn --------------
    float acc2[H2P / 2];
    if (kProduct) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        wgmma_bf16<H2P, 0, 0>(acc2, kmajor_desc(h1s + ks * 128),
                              kmajor_desc(reinterpret_cast<const bf16*>(w2s) + ks * 128), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(acc2);
    }
    m2 = 0;
    if (kEpilogue) {
      uint32_t bv[H2P / 8], dv[H2P / 8];
      lane_pairs<H2P>(bv, b2s, tq);
      lane_pairs<H2P>(dv, d2s, tq);
      uint32_t m[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < H2P / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const bf162 b = as_pair(bv[j]), d = as_pair(dv[j]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf162 pre = pre_bias2(__floats2bfloat162_rn(acc2[4 * j + 2 * h],
                                                            acc2[4 * j + 2 * h + 1]), b);
          const int p = 2 * j + h;
          flag_pair(m, ties2(pre, d), p);
          const bf162 v = relu2(pre);
          const int r = r0 + 8 * h;
          if (EXACT || (c + 1 < h2 && (h2 & 1) == 0)) {
            *reinterpret_cast<bf162*>(os + out_off(r, c, h2, EXACT)) = v;
          } else {
            if (c < h2) os[out_off(r, c, h2, EXACT)] = __bfloat16_as_ushort(v.x);
            if (c + 1 < h2) os[out_off(r, c + 1, h2, EXACT)] = __bfloat16_as_ushort(v.y);
          }
        }
      }
      m2 = uint64_t(m[1]) << 32 | m[0];
    }
    prev = tile;
  }
  if (prev >= 0) {  // the last tile's layer-2 ties and store
    settle_out();
    store_out(prev);
  }
  if (kStore && gt == 0) bulk_wait<0>();  // the block's stores are done before it ends
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shapes the kernel takes.
bool shapes_ok(const void* x, const void* out, int64_t batch, int64_t h2, int64_t sms) {
  return batch > 0 && batch % kT == 0 && batch < (int64_t(1) << 31) && h2 > 0 && h2 <= kD &&
         sms > 0 && sms <= (1 << 16) && aligned16(x) && aligned16(out);
}

// The kernel's tensor maps: x's, and the output's where it goes out in boxes
// (h2 of 64 or 128; else mo is x's, unused).
bool encode_maps(const void* x, void* out, int64_t batch, int64_t h2, CUtensorMap* mx,
                 CUtensorMap* mo) {
  if (!tma_map::bf16_map(mx, x, kD, batch, kT)) return false;
  if (h2 % kBoxCols != 0) {
    *mo = *mx;
    return true;
  }
  return tma_map::bf16_map(mo, out, h2, batch, kT);
}

template <int H2P, bool EXACT, int SPLIT = kWhole>
int launch(const void* x, void* out, const void* w1, int64_t w1_sk, int64_t w1_sn,
           const void* b1, const void* w2, int64_t w2_sk, int64_t w2_sn, const void* b2,
           int64_t batch, int h2, int sms, cudaStream_t stream) {
  using L = Layout<H2P>;
  const int64_t n_tiles = batch / kT;  // a block an SM, or fewer: one a tile a consumer at least
  const int n_blocks = static_cast<int>(std::min<int64_t>(sms, (n_tiles + L::consumers - 1) /
                                                                    L::consumers));
  // a runtime call first: it makes the device's context current on this
  // thread, which the tensor maps' encoding (a driver call) needs
  cudaError_t err = cudaFuncSetAttribute(tower_fwd_kernel<H2P, EXACT, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mx, mo;
  if (!encode_maps(x, out, batch, h2, &mx, &mo)) return static_cast<int>(cudaErrorInvalidValue);
  tower_fwd_kernel<H2P, EXACT, SPLIT><<<n_blocks, L::threads, L::bytes, stream>>>(
      mx, mo, static_cast<bf16*>(out), static_cast<const uint16_t*>(w1), w1_sk, w1_sn,
      static_cast<const uint16_t*>(b1), static_cast<const uint16_t*>(w2), w2_sk, w2_sn,
      static_cast<const uint16_t*>(b2), n_tiles, h2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. x [batch, 128] and
// out [batch, h2] contiguous bf16 on 16-byte boundaries, batch a multiple of
// 64 below 2^31; w1 [128, 128] and w2 [128, h2] bf16 with element strides
// (sk, sn) for (in, out); b1 [128] and b2 [h2] contiguous bf16; sms the
// card's SM count (the grid: a block an SM, or one a tile for each consumer
// warpgroup if there are fewer).
int ttrm_tower_fwd(const void* x, const void* w1, int64_t w1_sk, int64_t w1_sn, const void* b1,
                   const void* w2, int64_t w2_sk, int64_t w2_sn, const void* b2, void* out,
                   int64_t batch, int64_t h2, int64_t sms, void* stream) {
  if (!shapes_ok(x, out, batch, h2, sms)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(h2), nb = static_cast<int>(sms);
  if (h2 == 64)
    return launch<64, true>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, batch, h, nb,
                            s);
  if (h2 == 128)
    return launch<128, true>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, batch, h, nb,
                             s);
  if (h2 < 64)
    return launch<64, false>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, batch, h, nb,
                             s);
  return launch<128, false>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, batch, h, nb,
                            s);
}

// The kernel at h2 = 64 up to stage `split` (a Split: 1 the loads, 2 the
// products, 3 the epilogues, 4 the tie rounds; 0 the whole kernel), the
// arguments as ttrm_tower_fwd's. For timing a tile's parts: below 0 the
// output is not the function's.
int ttrm_tower_fwd_split(const void* x, const void* w1, int64_t w1_sk, int64_t w1_sn,
                         const void* b1, const void* w2, int64_t w2_sk, int64_t w2_sn,
                         const void* b2, void* out, int64_t batch, int64_t h2, int64_t sms,
                         int64_t split, void* stream) {
  if (h2 != 64 || !shapes_ok(x, out, batch, h2, sms))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(sms);
  switch (split) {
    case kWhole:
      return launch<64, true, kWhole>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2,
                                      batch, 64, nb, s);
    case kLoads:
      return launch<64, true, kLoads>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2,
                                      batch, 64, nb, s);
    case kProducts:
      return launch<64, true, kProducts>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2,
                                         batch, 64, nb, s);
    case kEpilogues:
      return launch<64, true, kEpilogues>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2,
                                          batch, 64, nb, s);
    case kTies:
      return launch<64, true, kTies>(x, out, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2,
                                     batch, 64, nb, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
