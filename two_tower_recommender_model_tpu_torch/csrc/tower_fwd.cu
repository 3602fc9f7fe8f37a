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
// The two-GEMM route also wrote and read back y1, h1 and y2: ~436 MB a
// tower. Here h1 stays on chip: a tile's h1 is written to shared memory by
// layer 1's epilogue and read from there by layer 2's products and by
// layer 2's tie recompute, which needs whole h1 rows; it never reaches
// device memory.
//   - Persistent blocks, one an SM, each of three warpgroups that walk their
//     own 64-row tiles (named barriers, one a warpgroup), so one's tie
//     recompute or barrier overlaps the others' products. W1 and W2 (W2
//     zero-padded to H2P = 64 or 128 columns), b1, b2 and the tie bounds d
//     are loaded into shared memory once a block.
//   - x tiles come in a ring of 2 stages a warpgroup by cp.async, one tile
//     ahead of the math (three warpgroups keep 48 KB of x in flight an SM);
//     a tile's stage, once layer 1 is done with it, holds its output for
//     the 16-byte stores.
//   - Products: wgmma (m64n128k16 and m64nH2Pk16, bf16 x bf16 -> f32), both
//     operands read by the tensor cores from shared memory through matrix
//     descriptors: the x tile and W1, then the h1 tile and W2. Tiles are
//     kept K-major in 8 x 16-byte core matrices (2,048 bytes an 8-row block
//     of 128 k). With mma.sync and ldmatrix fragments (as #8 does) each warp
//     reads the operands it multiplies: some 2.7 KB of shared memory a row,
//     seven times x's 256 bytes; wgmma reads each operand tile once a
//     warpgroup.
//   - Epilogues in registers, two values of a row at once (an instance for
//     H2 == H2P, the towers' widths, whose layer-2 epilogue and stores take
//     no branch on H2): the f32 sums rounded to bf16 (cvt.rn.bf16x2), pre =
//     bf16(r + b) in one bf16x2 add, the tie test 0 <= pre <= d on pre
//     (relu_ties.cuh holds it equal to relu_tie), ReLU to positive zero, a
//     4-byte store to shared memory.
//   - Ties (~0.1% of the values on the towers' draws) are summed again after
//     the epilogue: a thread flags its tied values in a 64-bit mask, each
//     warp ranks its ties by a prefix sum and writes them to a region of 32
//     entries of its own, and after the warpgroup's barrier its threads take
//     the concatenated list, one tie a thread, so a round of up to 128 ties
//     costs one 128-fmaf chain of latency (inputs whose every value ties
//     take rounds of 128). Each output is written by the epilogue, then once
//     more if it ties, in barrier order: no atomics, and two launches on the
//     same inputs give the same bits.
//
// Binding: a plain C interface loaded with ctypes. One launch on the caller's
// stream; it allocates nothing and synchronises nothing, and its grid depends
// only on B and the SM count (the wrapper passes n_blocks), so it can be
// captured in a CUDA graph. The entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "relu_ties.cuh"
#include "wgmma_sm90.cuh"

namespace {

using mma_sm90::cp_async16;
using mma_sm90::cp_async_commit;
using mma_sm90::smem_addr;
using relu_ties::finish;
using relu_ties::ordered_dot_chunks;
using relu_ties::pre_bias2;
using relu_ties::relu2;
using relu_ties::rnd;
using relu_ties::tie_ceiling;
using relu_ties::ties2;
using wgmma_sm90::smem_desc;
using wgmma_sm90::wgmma_bf16;
using wgmma_sm90::wgmma_commit_wait;
using wgmma_sm90::wgmma_fence;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kD = 128;            // d_in == h1
constexpr int kT = 64;             // rows a tile: one wgmma's M
constexpr int kStages = 2;         // x tiles in the ring
constexpr int kGroups = 3;         // warpgroups a block, each walking its own tiles
constexpr int kGroupThreads = 128;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kRegion = 32;        // tie entries a warp hands out a round
constexpr int kMaxSmem = 232448;
constexpr int kBlockBytes = 2048;  // an 8-row block of a K-major tile: 16 core matrices

// Element offset of (r, k) in a K-major tile of 128 k: 8 x 8 core matrices of
// 128 contiguous bytes, 16 of them along k (128 bytes apart), then the next 8
// rows (2,048 bytes on).
__device__ __forceinline__ int ilv(int r, int k) {
  return (r >> 3) * (kBlockBytes / 2) + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
}

// Shared-memory layout (byte offsets) for H2P = 64 or 128.
template <int H2P>
struct Layout {
  static constexpr size_t tile_bytes = size_t(kT) * kD * 2;      // [64][128] bf16, K-major
  static constexpr size_t w1 = 0;                                 // [128 n][128 k]
  static constexpr size_t w2 = w1 + size_t(kD) * kD * 2;          // [H2P n][128 k], 0 past h2
  static constexpr size_t b1 = w2 + size_t(H2P) * kD * 2;         // [128] bf16
  static constexpr size_t d1 = b1 + kD * 2;                       // [128] bf16: tie bounds
  static constexpr size_t b2 = d1 + kD * 2;                       // [H2P] bf16, 0 past h2
  static constexpr size_t d2 = b2 + H2P * 2;                      // [H2P] bf16, -1 past h2
  static constexpr size_t groups = d2 + H2P * 2;
  // per warpgroup: h1 tile, the x ring, tie regions and counts of both layers
  static constexpr size_t g_h1 = 0;
  static constexpr size_t g_x = g_h1 + tile_bytes;
  static constexpr size_t g_ties = g_x + kStages * tile_bytes;     // [2][4][kRegion] uint32
  static constexpr size_t g_counts = g_ties + 2 * 4 * kRegion * 4; // [2][4] int
  static constexpr size_t group_bytes = g_counts + 2 * 4 * 4 + 96; // padded to 128 bytes
  static constexpr size_t bytes = groups + kGroups * group_bytes;
  static_assert(bytes <= kMaxSmem, "shared memory");
  static_assert(groups % 128 == 0 && group_bytes % 128 == 0, "128-byte alignment");
};

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kGroupThreads) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes made visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma matrix descriptor of a K-major tile at p, no swizzle: 16-byte core
// matrix rows, 128 bytes between core matrices along k, 2,048 along m / n.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return smem_desc(p, 128, kBlockBytes, wgmma_sm90::kNoSwizzle);
}

// acc (64 x N) = A tile (64 x 128) . B tile (N x 128)^T, both K-major in shared memory
template <int N>
__device__ __forceinline__ void tile_product(float (&acc)[N / 2], const bf16* a, const bf16* b) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks)  // a 16-wide k step is two core matrices: 128 elements
    wgmma_bf16<N, 0, 0>(acc, kmajor_desc(a + ks * 128), kmajor_desc(b + ks * 128), ks > 0);
  wgmma_commit_wait();
}

__device__ __forceinline__ bf162 pair(const uint16_t* p) {  // two bf16 at p (4-byte aligned)
  return *reinterpret_cast<const bf162*>(p);
}

// Where a tile's output value (r, c) is staged: row-major [64][h2]; when h2 is
// 64 or 128, 16-byte chunks of a row are XOR-swizzled by r % 8, so the 8 rows
// of an epilogue store fall on 8 bank groups.
__device__ __forceinline__ int stage_off(int r, int c, int h2, bool swz) {
  return r * h2 + (swz ? ((((c >> 3) ^ (r & 7)) << 3) | (c & 7)) : c);
}

// W [128 (k), n] with element strides (sk, sn) into ws, K-major [n_rows][128]
// (a column of W is a row), rows from n_valid on zero. Where k has unit
// stride (an `nn.Linear` weight's transpose: the towers' layout) by 16-byte
// loads, all of a thread's started before its stores; else one value a load.
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
  } else {
#pragma unroll 8
    for (int e = tid; e < kD * n_rows; e += kThreads) {
      const int k = e % kD, n = e / kD;
      ws[ilv(n, k)] = n < n_valid ? w[k * sk + n * sn] : 0;
    }
  }
}

// Bit p of the result from bit 7 of t (ties2's low half: bf16 1.0 is 0x3f80)
// and bit p + 1 from bit 23 (its high half); p even and constant once unrolled.
__device__ __forceinline__ uint32_t place_ties(uint32_t t, int p) {
  const uint32_t lo = p >= 7 ? t << (p - 7) : t >> (7 - p);
  const uint32_t hi = p + 1 >= 23 ? t << (p + 1 - 23) : t >> (23 - p - 1);
  return (lo & (1u << p)) | (hi & (2u << p));
}

// The tie machinery of one layer for one warp. `mask` flags this lane's tied
// values (bit b of the fragment order); `where(b)` gives (row << 8 | col) of
// bit b. Round `round` writes this lane's ties of local index [32 * round,
// 32 * round + 32) into the warp's region.
template <typename Where>
__device__ __forceinline__ void write_round(uint64_t mask, int first, int round, uint32_t* region,
                                            Where where) {
  int idx = first;
  while (mask) {
    const int bit = __ffsll(static_cast<long long>(mask)) - 1;
    mask &= mask - 1;
    const int slot = idx++ - round * kRegion;
    if (slot >= kRegion) break;
    if (slot >= 0) region[slot] = where(bit);
  }
}

// Rank this lane's ties in its warp, hand them to the warpgroup a round at a
// time, and have `redo(row, col)` sum each again; ends with the warpgroup's
// barrier after the last round (or after the counts, when no value ties).
// Every thread of the warpgroup calls it (named barriers); each barrier
// publishes the shared-memory writes before it to the tensor cores too.
template <typename Where, typename Redo>
__device__ __forceinline__ void settle_ties(uint64_t mask, int group, int gw, int lane, int gt,
                                            uint32_t* ties, int* counts, Where where, Redo redo) {
  const unsigned full = 0xffffffffu;
  const int cnt = __popcll(mask);
  int incl = cnt;  // the warp's inclusive prefix sum of tied values
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(full, incl, 31);
  if (lane == 0) counts[gw] = total;
  uint32_t* region = ties + gw * kRegion;
  if (cnt) write_round(mask, incl - cnt, 0, region, where);
  fence_async_shared();
  group_sync(group);  // the epilogue's stores, the counts and round 0's entries
  int c[4], most = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    c[w] = counts[w];
    most = max(most, c[w]);
  }
  for (int round = 0; round * kRegion < most; ++round) {
    if (round > 0) {
      if (cnt) write_round(mask, incl - cnt, round, region, where);
      group_sync(group);
    }
    // thread gt takes entry gt of the 4 regions' entries of this round, in warp order
    int w = -1, j = 0, before = 0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = min(max(c[v] - round * kRegion, 0), kRegion);
      if (w < 0 && gt - before < n) {
        w = v;
        j = gt - before;
      }
      before += n;
    }
    if (w >= 0) {
      const uint32_t e = ties[w * kRegion + j];
      redo(static_cast<int>(e >> 8), static_cast<int>(e & 0xffu));
    }
    fence_async_shared();
    group_sync(group);  // the recomputed values; the regions are free again
  }
}

// The k-order sum of row r of tile a and row c of tile w (both K-major)
__device__ __forceinline__ float tile_dot(const bf16* a, int r, const bf16* w, int c) {
  const uint4* ar = reinterpret_cast<const uint4*>(a + ilv(r, 0));
  const uint4* wr = reinterpret_cast<const uint4*>(w + ilv(c, 0));
  return ordered_dot_chunks(kD / 8, [&](int64_t j) { return ar[j * 8]; },  // 128 bytes a chunk
                            [&](int64_t j) { return wr[j * 8]; });
}

// EXACT: h2 == H2P (the towers' widths), so the layer-2 epilogue and the
// stores take no branch on h2.
template <int H2P, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
tower_fwd_kernel(const bf16* __restrict__ x, const uint16_t* __restrict__ w1, int64_t w1_sk,
                 int64_t w1_sn, const uint16_t* __restrict__ b1, const uint16_t* __restrict__ w2,
                 int64_t w2_sk, int64_t w2_sn, const uint16_t* __restrict__ b2,
                 bf16* __restrict__ out, int64_t n_tiles, int h2_arg) {
  using L = Layout<H2P>;
  const int h2 = EXACT ? H2P : h2_arg;
  extern __shared__ __align__(128) char smem[];
  uint16_t* w1s = reinterpret_cast<uint16_t*>(smem + L::w1);
  uint16_t* w2s = reinterpret_cast<uint16_t*>(smem + L::w2);
  uint16_t* b1s = reinterpret_cast<uint16_t*>(smem + L::b1);
  uint16_t* d1s = reinterpret_cast<uint16_t*>(smem + L::d1);
  uint16_t* b2s = reinterpret_cast<uint16_t*>(smem + L::b2);
  uint16_t* d2s = reinterpret_cast<uint16_t*>(smem + L::d2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp / 4, gw = warp % 4, gt = tid % kGroupThreads;
  const int g = lane >> 2, tq = lane & 3;
  char* gbase = smem + L::groups + group * L::group_bytes;
  bf16* h1s = reinterpret_cast<bf16*>(gbase + L::g_h1);
  uint32_t* ties = reinterpret_cast<uint32_t*>(gbase + L::g_ties);
  int* counts = reinterpret_cast<int*>(gbase + L::g_counts);
  const bool swz = EXACT || h2 == 64 || h2 == 128;

  auto stage = [&](int s) { return reinterpret_cast<bf16*>(gbase + L::g_x + s * L::tile_bytes); };
  auto load_tile = [&](int64_t tile, int s) {  // 64 rows x 16 chunks, 8 a thread
    const bf16* src = x + tile * kT * kD;
    bf16* dst = stage(s);
#pragma unroll
    for (int i = 0; i < kT * kD / 8 / kGroupThreads; ++i) {
      const int e = gt + i * kGroupThreads, r = e >> 4, c = (e & 15) * 8;
      cp_async16(dst + ilv(r, c), src + r * kD + c);
    }
  };

  const int64_t step = static_cast<int64_t>(gridDim.x) * kGroups;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kGroups + group;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (first + s * step < n_tiles) load_tile(first + s * step, s);
    cp_async_commit();
  }

  // the weights, K-major (a column of W is a row); biases, and the tie bounds
  // d = bf16(next_above(-b) + b)
  load_weight(w1s, w1, w1_sk, w1_sn, kD, kD, tid);
  load_weight(w2s, w2, w2_sk, w2_sn, h2, H2P, tid);
  for (int c = tid; c < kD; c += kThreads) {
    b1s[c] = b1[c];
    d1s[c] = __bfloat16_as_ushort(tie_ceiling(b1[c]));
  }
  for (int c = tid; c < H2P; c += kThreads) {  // padded columns: pre = 0 > d = -1, no tie
    b2s[c] = c < h2 ? b2[c] : 0;
    d2s[c] = c < h2 ? __bfloat16_as_ushort(tie_ceiling(b2[c])) : 0xbf80u;
  }
  fence_async_shared();
  __syncthreads();

  // this thread's rows of a tile (as the products' fragments hold them)
  const int r0 = 16 * gw + g;
  bf162 b1p[16], d1p[16];  // b1 and d at this thread's columns of layer 1
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    b1p[j] = pair(b1s + 8 * j + 2 * tq);
    d1p[j] = pair(d1s + 8 * j + 2 * tq);
  }

  int it = 0;
  for (int64_t tile = first; tile < n_tiles; tile += step, ++it) {
    cp_async_wait<kStages - 2>();  // this tile's group has landed
    fence_async_shared();
    group_sync(group);             // for every thread; and the last tile's stores are done
    if (tile + (kStages - 1) * step < n_tiles)
      load_tile(tile + (kStages - 1) * step, (it + kStages - 1) % kStages);
    cp_async_commit();
    bf16* xs = stage(it % kStages);

    // ---- layer 1: [64, 128] @ W1 -> h1 in shared memory ---------------------------------
    {
      float acc[64];
      tile_product<128>(acc, xs, reinterpret_cast<const bf16*>(w1s));
      uint32_t m[2] = {0, 0};  // bit 2 (2 j + h) + i: value i of pair (j, h) ties
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf162 pre = pre_bias2(__floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                            acc[4 * j + 2 * h + 1]), b1p[j]);
          const int p = 2 * j + h;
          m[p >> 4] |= place_ties(ties2(pre, d1p[j]), (p & 15) * 2);
          *reinterpret_cast<bf162*>(h1s + ilv(r0 + 8 * h, 8 * j + 2 * tq)) = relu2(pre);
        }
      settle_ties(
          uint64_t(m[1]) << 32 | m[0], group, gw, lane, gt, ties, counts,
          [&](int bit) {
            const int p = bit >> 1;
            return static_cast<uint32_t>((r0 + 8 * (p & 1)) << 8 |
                                         (8 * (p >> 1) + 2 * tq + (bit & 1)));
          },
          [&](int row, int col) {
            const float r = rnd(tile_dot(xs, row, reinterpret_cast<const bf16*>(w1s), col));
            reinterpret_cast<uint16_t*>(h1s)[ilv(row, col)] =
                finish(r, __bfloat162float(__ushort_as_bfloat16(b1s[col])));
          });
    }

    // ---- layer 2: h1 @ W2 -> out, staged in this tile's x stage ---------------------------
    {
      float acc[H2P / 2];
      tile_product<H2P>(acc, h1s, reinterpret_cast<const bf16*>(w2s));
      uint16_t* os = reinterpret_cast<uint16_t*>(xs);
      uint32_t m[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < H2P / 8; ++j) {
        const int c = 8 * j + 2 * tq;
        const bf162 b = pair(b2s + c), d = pair(d2s + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf162 pre = pre_bias2(__floats2bfloat162_rn(acc[4 * j + 2 * h],
                                                            acc[4 * j + 2 * h + 1]), b);
          const int p = 2 * j + h;
          m[p >> 4] |= place_ties(ties2(pre, d), (p & 15) * 2);
          const bf162 v = relu2(pre);
          const int r = r0 + 8 * h;
          if (c + 1 < h2 && (h2 & 1) == 0) {
            *reinterpret_cast<bf162*>(os + stage_off(r, c, h2, swz)) = v;
          } else {
            if (c < h2) os[stage_off(r, c, h2, swz)] = __bfloat16_as_ushort(v.x);
            if (c + 1 < h2) os[stage_off(r, c + 1, h2, swz)] = __bfloat16_as_ushort(v.y);
          }
        }
      }
      settle_ties(
          uint64_t(m[1]) << 32 | m[0], group, gw, lane, gt, ties + 4 * kRegion, counts + 4,
          [&](int bit) {
            const int p = bit >> 1;
            return static_cast<uint32_t>((r0 + 8 * (p & 1)) << 8 |
                                         (8 * (p >> 1) + 2 * tq + (bit & 1)));
          },
          [&](int row, int col) {
            const float r = rnd(tile_dot(h1s, row, reinterpret_cast<const bf16*>(w2s), col));
            os[stage_off(row, col, h2, swz)] =
                finish(r, __bfloat162float(__ushort_as_bfloat16(b2s[col])));
          });

      // the tile's [64, h2] output is one run of 128 h2 bytes: 16-byte stores
      uint4* dst = reinterpret_cast<uint4*>(out + tile * kT * h2);
      const int chunks_per_row = h2 / 8;
      for (int e = gt; e < kT * h2 / 8; e += kGroupThreads) {
        int off = e * 8;
        if (swz) {
          const int r = e / chunks_per_row, ch = e % chunks_per_row;
          off = r * h2 + ((ch ^ (r & 7)) << 3);
        }
        dst[e] = *reinterpret_cast<const uint4*>(os + off);
      }
    }
  }
  cp_async_wait<0>();
}

template <int H2P, bool EXACT>
int launch(const void* x, const void* w1, int64_t w1_sk, int64_t w1_sn, const void* b1,
           const void* w2, int64_t w2_sk, int64_t w2_sn, const void* b2, void* out,
           int64_t batch, int h2, int n_blocks, cudaStream_t stream) {
  using L = Layout<H2P>;
  cudaError_t err = cudaFuncSetAttribute(tower_fwd_kernel<H2P, EXACT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_fwd_kernel<H2P, EXACT><<<n_blocks, kThreads, L::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint16_t*>(w1), w1_sk, w1_sn,
      static_cast<const uint16_t*>(b1), static_cast<const uint16_t*>(w2), w2_sk, w2_sn,
      static_cast<const uint16_t*>(b2), static_cast<bf16*>(out), batch / kT, h2);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. x [batch, 128] and
// out [batch, h2] contiguous bf16 on 16-byte boundaries, batch a multiple of
// 64; w1 [128, 128] and w2 [128, h2] bf16 with element strides (sk, sn) for
// (in, out); b1 [128] and b2 [h2] contiguous bf16.
int ttrm_tower_fwd(const void* x, const void* w1, int64_t w1_sk, int64_t w1_sn, const void* b1,
                   const void* w2, int64_t w2_sk, int64_t w2_sn, const void* b2, void* out,
                   int64_t batch, int64_t h2, int64_t n_blocks, void* stream) {
  if (batch <= 0 || batch % kT != 0 || h2 <= 0 || h2 > kD || n_blocks <= 0 ||
      n_blocks > (batch / kT + kGroups - 1) / kGroups || !aligned16(x) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(h2), nb = static_cast<int>(n_blocks);
  if (h2 == 64)
    return launch<64, true>(x, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, out, batch, h, nb, s);
  if (h2 == 128)
    return launch<128, true>(x, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, out, batch, h, nb, s);
  if (h2 < 64)
    return launch<64, false>(x, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, out, batch, h, nb, s);
  return launch<128, false>(x, w1, w1_sk, w1_sn, b1, w2, w2_sk, w2_sn, b2, out, batch, h, nb, s);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
