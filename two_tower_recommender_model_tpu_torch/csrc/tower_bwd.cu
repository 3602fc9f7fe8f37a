// Fused two-layer tower backward for Hopper (sm_90a): the whole backward of
//
//   out = relu(bf16(bf16(x @ W1) + b1) @ W2 + b2)      (the flagship tower)
//
// for x [B, 128], W1 [128, 128], W2 [128, H2] (H2 <= 128), given the
// cotangent dq [B, H2] and the SAVED forward output out [B, H2]:
//
//   d2  = out > 0 ? dq : 0                               (f32)
//   pre1 = bf16(bf16(bf16(x) @ bf16(W1)) + bf16(b1))     (add in bf16)
//   h1  = relu(pre1)
//   dh1 = bf16(d2) @ bf16(W2)^T                          (f32 accumulation)
//   d1  = pre1 > 0 ? dh1 : 0
//   dx  = bf16(d1) @ bf16(W1)^T                          (stored in x's dtype)
//   dW1 = bf16(x)^T @ bf16(d1),   db1 = sum_rows d1      (unrounded d1)
//   dW2 = h1^T @ bf16(d2),        db2 = sum_rows d2      (unrounded d2)
//
// Replaces the Pallas TPU kernel `_bwd_kernel` / `tower_backward_fused` in
// two_tower_recommender_model_tpu/ops/tower_bwd.py (kernel #8), with its
// rounding points: every product's operands are bf16 values, sums are f32,
// the layer-1 mask comes from the bf16 pre-activation and the final-ReLU mask
// from the saved output. Not carried over: the TPU's 2,048-row grid that
// carried the weight-gradient sums from step to step, and its padding of H2
// to 128 lanes.
//
// Contract: x, dq, out, dx all f32 or all bf16 (contiguous, row-major, 16-byte
// aligned); W1 [128, 128], b1 [128], W2 [128, H2] all f32 or all bf16, the
// weights with any element strides (rounded to bf16 on load); B a multiple
// of 64 rows for bf16 io, of 32 for f32 io; the weight gradients are f32.
//
// What bounds it: bytes. At B = 262,144, H2 = 64 it reads x, dq and out and
// writes dx, 201 MB of bf16: 0.060 ms at 3.35 TB/s; the five products (the
// layer-1 recompute and four gradients) are 2 * 128 * (3 * 128 + 2 * H2)
// FLOPs a row, 34.4 GFLOP, 0.035 ms at the tensor cores' 989 TFLOP/s. A
// 64-row tile moves 48 KB (1.9 us of an SM's share of the bandwidth) and
// takes 8.4 MFLOP (1.1 us of its tensor cores), so a tile's loads, products,
// epilogues and stores have to run under each other. The design:
//   - Persistent blocks, one an SM, of two row warpgroups and, at bf16 io
//     and H2P = 64 (the towers' step), two gradient warpgroups; a block walks
//     the tiles blockIdx.x, + gridDim.x, ... x comes by TMA (boxes [64, 64]
//     with the 128-byte swizzle that the wgmma descriptors read) into a ring
//     of tiles in flight (4 at bf16 io and H2P = 64), guarded by full /
//     empty mbarriers; when a tile's x is issued, its dq and out (rows h2
//     values apart: each tile's flat run) are prefetched into L2 by a bulk
//     copy, and the rows read them from there. The first thread of a
//     warpgroup that takes gradients claims and issues the next loads at the
//     start of each of its steps. (Measured on an H100 and dropped: a
//     producer warp of its own, which caps every thread at 168 registers, as
//     9 warps put 3 on one of the SM's four register files, and spilled; dq
//     and out staged in the ring beside x, which left room for 3 tiles at
//     H2P = 64 and 2 at 128.) W1^T and W2 (zero-padded to H2P = 64 or 128
//     columns) are rounded to bf16 into shared memory once a block,
//     row-major in swizzled boxes [128, 64]; the products read them K-major
//     or MN-major as they need, and a column of W1 is a row of W1^T for the
//     ties.
//   - Row work: the tiles are dealt to the two row warpgroups in turn. For its
//     tile a warpgroup issues pre1 = x W1 (wgmma m64n128k16, both operands
//     K-major) and, under it, forms d2 from dq and out (db2 from the f32
//     values, bf16(d2) into a hand-over buffer); the epilogue rounds, adds
//     the bias, writes h1 and keeps the mask pre1 > 0 as bits; ties are
//     settled (below), dh1 = d2 W2^T (d2 and W2 K-major) running under them;
//     d1 = mask ? dh1 : 0 (db1 from the f32 values) is packed to bf16 in
//     registers as the A operand of dx = d1 W1^T (a wgmma accumulator's
//     fragment is a k16 A fragment: nothing is repacked; W1^T MN-major) and,
//     under dx's products, written to the hand-over buffer. dx goes to the
//     warpgroup's dx stage and leaves by TMA stores, waited for before the
//     stage is written again.
//   - Weight gradients: dW1 [128, 128] and dW2 [128, H2P] in f32 stay in
//     registers across the block's tiles, two warpgroups owning 64 rows of
//     both (64 + H2P / 2 floats a thread). For every tile, in tile order,
//     they take x, h1, d1 and d2 from shared memory: dW1 += x^T d1 and dW2 +=
//     h1^T d2 (K = the tile's 64 rows; x and h1 MN-major as they lie, so x is
//     never copied). Hand-over mbarriers tell them that a tile's buffers are
//     full, and the row warpgroup that every warp of theirs is done with
//     them. At bf16 io and H2P = 64 two gradient warpgroups of their own do
//     this (512 threads: 128 registers a thread, a few hundred bytes
//     spilled), and a row warpgroup waits only for the gradients of its own
//     last tile. Elsewhere the two row warpgroups take the gradients
//     themselves (at H2P = 128 the gradient rows alone, 64 + 64 floats, fill
//     that share; f32 io holds one hand-over buffer, so its rows would wait
//     for the gradients at every tile): with two hand-over buffers they run
//     their rows at once, then both tiles' gradients; at f32 io shared
//     memory holds one, and a tile's rows wait for the gradients of the tile
//     before. (On an H100 at the BCE shape the gradient warpgroups took
//     1-2% off the two-warpgroup kernel's time, with the same outputs.)
//   - db1 is summed in registers, a warp's 16 rows folded into 4 columns a
//     lane by shuffles each tile; db2 by the threads that form its column.
//   - Ties: the tensor cores sum pre1 in another order than an f32 GEMM. A
//     sum whose bf16 value r is -b1 or the value next above it decides the
//     ReLU differently in some order within one bf16 ulp; relu_ties.cuh's
//     test (in its two-value form, as the forward, tower_fwd.cu, takes it)
//     flags those, a warpgroup pools them and the lanes of one warp sum them
//     again in k order (`ordered_dot_chunks`), so the kernel decides as the
//     forward, the plain version and the host do.
//   - Blocks cannot carry a sum across the grid the way the TPU's sequential
//     grid did, so each block writes its partial gradients to `partials` and
//     a second kernel sums them in block order: no atomics, and two launches
//     on the same inputs agree bit for bit.
//   - f32 io: x comes by TMA in f32 boxes [64, 32] and a warpgroup rounds it
//     to the bf16 operand tile in place; dq, out and dx in f32. A last tile of
//     32 rows takes the TMA's zero fill for x: its dq and out rows are taken as
//     zero, so d2 = d1 = 0 there, every sum adds exact zeros, and the TMA store
//     clips its dx rows.
//
// Binding: a plain C interface loaded with ctypes. Both launches go to the
// caller's stream, do not synchronise and allocate nothing (the wrapper
// passes the partials buffer); the entry point returns cudaGetLastError(), or
// cudaErrorInvalidValue for what it does not take or a tensor map that
// cannot be encoded.
//
// `ttrm_tower_bwd_split` runs the kernel at bf16 io and H2 = 64 up to one
// stage (the loads alone; and the row products; and their epilogues and
// ties; and the gradient products; and the dx stores: the whole kernel):
// chip_smoke.py times a tile's parts with it. Before the last, its outputs
// are not the function's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "relu_ties.cuh"
#include "tma_map.cuh"
#include "wgmma_sm90.cuh"

namespace {

using relu_ties::finish;
using relu_ties::ordered_dot_chunks;
using relu_ties::pre_bias2;
using relu_ties::relu2;
using relu_ties::rnd;
using relu_ties::tie_ceiling;
using relu_ties::ties2;
using namespace wgmma_sm90;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kD = 128;            // D_in == H1 == 128
constexpr int kT = 64;             // rows a tile: one wgmma's M
constexpr int kGroupThreads = 128;
constexpr int kConsumers = 2;      // row warpgroups a block
constexpr int kPool = 128;         // tie entries a warpgroup's list holds
constexpr int kMaxSmem = 232448;
constexpr int kBox = 8192;         // a [64, 64] bf16 (or [64, 32] f32) box, 128-byte swizzle
constexpr int kTileBytes = 2 * kBox;  // a [64, 128] bf16 tile: two boxes
constexpr int kWBox = 16384;       // a [128, 64] bf16 box of a weight
constexpr int kMaxStages = 4;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// What a launch runs: the whole kernel, or (to time a tile's parts) the
// kernel up to a stage, the later stages left out
enum Split : int { kWhole = 0, kLoads = 1, kRowProducts = 2, kEpilogues = 3, kGradients = 4 };

// Shared-memory layout (byte offsets) of one instantiation: barriers, b1 and
// the tie lists, then from the next 1,024-byte boundary (the swizzle's
// atoms) the weights, the hand-over buffers, the warpgroups' dx stages and
// the ring of x tiles (as many as fit, at most kMaxStages).
template <typename IO, int H2P>
struct Layout {
  static constexpr bool kIoF32 = sizeof(IO) == 4;
  static constexpr int x_boxes = kD * int(sizeof(IO)) / 128;           // 2 bf16, 4 f32
  static constexpr size_t x_bytes = size_t(kT) * kD * sizeof(IO);      // a staged x or dx tile
  // hand-over buffers: two at bf16 io (where shared memory holds them beside
  // a ring of at least two x tiles), one at f32 io
  static constexpr int hands = kIoF32 ? 1 : 2;
  // gradient warpgroups of their own (at bf16 io and H2P = 64, where their
  // dW1 / dW2 rows fit the 128 registers a thread of four warpgroups), else
  // none: the row warpgroups also take the gradients
  static constexpr int grads = !kIoF32 && H2P == 64 ? 2 : 0;
  static constexpr int threads = (kConsumers + grads) * kGroupThreads;
  static constexpr size_t h_h1 = 0, h_d1 = kTileBytes, h_d2 = 2 * kTileBytes;  // [64, 128],
  static constexpr size_t hand_bytes = h_d2 + size_t(kT) * H2P * 2;           // .., [64, H2P]
  static constexpr size_t full = 0;                            // [kMaxStages] mbarriers
  static constexpr size_t empty = full + 8 * kMaxStages;       // [kMaxStages]
  static constexpr size_t hfull = empty + 8 * kMaxStages;      // [2]
  static constexpr size_t hfree = hfull + 16;                  // [2]
  static constexpr size_t b1 = hfree + 16;                     // [128] bf16 in `by_lane` order
  static constexpr size_t d1 = b1 + kD * 2;                    // [128] bf16, the tie bounds
  static constexpr size_t counts = d1 + kD * 2;                // [kConsumers] int: ties;
                                                               // then the tiles loaded
  static constexpr size_t ties = counts + 16;                  // [kConsumers][kPool] uint16
  static constexpr size_t small = ties + kConsumers * kPool * 2;
  // from the aligned base
  static constexpr size_t w1 = 0;                              // W1^T: 2 boxes [128 out, 64 in]
  static constexpr size_t w2 = w1 + size_t(kD) * kD * 2;       // W2: H2P / 64 boxes [128 in, 64]
  static constexpr size_t hand = w2 + size_t(kD) * H2P * 2;    // [hands] hand-over buffers
  static constexpr size_t dxs = hand + hands * hand_bytes;     // [kConsumers] dx stages
  static constexpr size_t ring = dxs + kConsumers * x_bytes;   // [stages] x tiles
  // the aligned base is at most 1,008 bytes past `small` (shared memory is on 16-byte boundaries)
  static constexpr int fit = int((kMaxSmem - small - 1008 - ring) / x_bytes);
  static constexpr int stages = fit < kMaxStages ? fit : kMaxStages;
  static constexpr size_t bytes = small + 1008 + ring + stages * x_bytes;
  static_assert(small % 16 == 0 && stages >= hands && bytes <= kMaxSmem, "shared memory");
  static_assert(hand_bytes % 1024 == 0 && hand % 1024 == 0 && x_bytes % 1024 == 0,
                "1,024-byte alignment");
};

__device__ __forceinline__ void group_sync(int group) {  // a consumer warpgroup's barrier
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kGroupThreads) : "memory");
}
// every thread of the block, from any of the places that call it
__device__ __forceinline__ void all_sync(int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kConsumers), "r"(threads) : "memory");
}

// this thread's shared-memory writes made visible to the tensor cores' and the TMA's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global src (on a 16-byte boundary) into
// the L2 cache, ahead of the loads that read it
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}
// A 2-D TMA box of `map` at (c0, c1) stored from src, tracked in this
// thread's bulk groups
__device__ __forceinline__ void tma_store_2d(const void* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
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

// d (64 x 64, f32; scale_d = 0 overwrites it) += A (64 x 16, bf16 from
// registers: a wgmma accumulator fragment's layout, two values a register)
// . B (16 x 64, bf16 from shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(scale_d));
}

// whether the phase of parity `parity` of `bar` has completed (no wait)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Keeps registers that an issued wgmma still reads alive until its wait
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Element offset of (r, c) in a tile of bf16 boxes [rows, 64] with the
// 128-byte swizzle (box c / 64 after box_elems elements each): the layout a
// TMA box of a row-major matrix takes, read K-major along c or MN-major
// along c as a wgmma needs.
template <int kRows>
__device__ __forceinline__ int box_off(int r, int c) {
  return (c >> 6) * (kRows * 64) + r * 64 + ((((c & 63) >> 3) ^ (r & 7)) << 3) + (c & 7);
}
// The same in f32 boxes [64, 32] (dx at f32 io)
__device__ __forceinline__ int box_off_f32(int r, int c) {
  return (c >> 5) * (kT * 32) + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3);
}

// wgmma descriptors of the swizzled boxes. K-major: k step ks (16 deep) is
// box ks / 4 (box_bytes apart), 32 bytes a step within it. MN-major: 16 rows
// of 128 bytes a k step, two 64-wide atoms along m / n box_bytes apart.
__device__ __forceinline__ uint64_t kmajor(const void* tile, int ks, int box_bytes) {
  return smem_desc(static_cast<const unsigned char*>(tile) + (ks >> 2) * box_bytes + 32 * (ks & 3),
                   16, 1024, kSwizzle128);
}
__device__ __forceinline__ uint64_t mnmajor(const void* tile, int ks, int box_bytes) {
  return smem_desc(static_cast<const unsigned char*>(tile) + 2048 * ks, box_bytes, 1024,
                   kSwizzle128);
}

// Where column c of b1 and its tie bound are kept: the pairs (8 j + 2 t, + 1)
// that lane t % 4 of an accumulator fragment holds are contiguous, j in
// order, so a thread loads four of its pairs at once.
__device__ __forceinline__ int by_lane(int c) {
  return ((c >> 1) & 3) * (kD / 4) + (c >> 3) * 2 + (c & 1);
}

// a shared-memory load that the compiler issues where it is written
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ bf162 as_pair(uint32_t v) { return *reinterpret_cast<bf162*>(&v); }
__device__ __forceinline__ uint32_t as_bits(bf162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// A lane's flags of the [64, 128] layer-1 fragment: pair p (= 2 j + h:
// columns 8 j + 2 t, + 1 of row r0 + 8 h) in word p / 16, its low value at
// bit p % 16 and its high value at bit 16 + p % 16. `flag_pair` takes them
// from a bf16x2 comparison's t (bf16 1.0, 0x3f80, in each half that holds:
// bits 7 and 23) in one shift and one and-or; p is constant once unrolled.
__device__ __forceinline__ void flag_pair(uint32_t (&m)[2], uint32_t t, int p) {
  const int q = p & 15;
  m[p >> 4] |= (q <= 7 ? t >> (7 - q) : t << (q - 7)) & (0x00010001u << q);
}
__device__ __forceinline__ bool flag_of(const uint32_t (&m)[2], int p, int e) {
  return (m[p >> 4] >> ((e ? 16 : 0) + (p & 15))) & 1u;
}

// (row << 7 | col) of bit b of a lane's 64 flags (word b / 32, as `flag_pair`)
__device__ __forceinline__ uint32_t tie_at(int b, int r0, int tq) {
  const int p = 16 * (b >> 5) + (b & 15), i = (b >> 4) & 1;
  return static_cast<uint32_t>((r0 + 8 * (p & 1)) << 7 | (8 * (p >> 1) + 2 * tq + i));
}

// A warpgroup's tied values summed again (every thread of the warpgroup
// calls it), as tower_fwd.cu settles its layers: a lane with flagged values
// (`mask`, bits as `tie_at`) reserves a run of the warpgroup's list with one
// shared-memory atomic on `count` (the runs' order may vary from launch to
// launch; each entry is a value of its own, so the output does not) and
// writes the entries that fit. After the warpgroup's barrier, if all fit,
// they go to the lanes of as few warps as they fill, from warp `rot` on,
// `redo(row, col)` each: one chain of latency. Else (inputs dense with ties)
// each thread sums its own flagged values again. Each barrier is fenced: the
// caller's shared-memory writes and the recomputed values are visible to the
// async proxy too after it. With no tie in the warpgroup, the first barrier
// is the only one. `between()` runs on every thread right after the first
// barrier: work that needs the caller's writes whole but not the ties.
template <typename Between, typename Redo>
__device__ __forceinline__ void settle_ties(uint64_t mask, int group, int gw, int lane, int rot,
                                            int r0, int tq, uint16_t* list, int* count,
                                            Between between, Redo redo) {
  const int cnt = __popcll(mask);
  int idx = cnt ? atomicAdd(count, cnt) : 0;  // the list index of this lane's first entry
  for (uint64_t m = mask; m && idx < kPool; m &= m - 1, ++idx)
    list[idx] = tie_at(__ffsll(static_cast<long long>(m)) - 1, r0, tq);
  fence_async_shared();
  group_sync(group);  // the caller's writes, the count and the list
  const int total = *count;
  between();
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
  if (gw == 0 && lane == 0) *count = 0;  // every thread has read it; the next use is
                                         // after the tile's last barrier
}

// x (f32 io): the staged f32 boxes [64, 32] rounded in place to the bf16
// boxes [64, 64] that the products read. The bf16 tile takes the bytes of
// the f32 columns 0 .. 63, so those are read into registers before the
// warpgroup's barrier; columns 64 .. 127 are read after it. Ends fenced
// behind the warpgroup's barrier.
__device__ __forceinline__ void x_to_bf16(unsigned char* st, int gt, int group) {
  const float* xf = reinterpret_cast<const float*>(st);
  uint16_t* xb = reinterpret_cast<uint16_t*>(st);
  auto chunk = [&](int r, int c) {  // 4 f32 values at (r, c .. c + 3)
    return *reinterpret_cast<const float4*>(xf + box_off_f32(r, c));
  };
  auto put = [&](int r, int c, float4 v) {  // 4 bf16 values at (r, c .. c + 3)
    const uint2 u = make_uint2(as_bits(__floats2bfloat162_rn(v.x, v.y)),
                               as_bits(__floats2bfloat162_rn(v.z, v.w)));
    *reinterpret_cast<uint2*>(xb + box_off<kT>(r, c)) = u;
  };
  float4 low[8];  // chunk e = gt + 128 i: row e / 16, columns 4 (e % 16) ..
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = gt + kGroupThreads * i;
    low[i] = chunk(e >> 4, 4 * (e & 15));
  }
  group_sync(group);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int e = gt + kGroupThreads * i, r = e >> 4, c = 4 * (e & 15);
    put(r, c, low[i]);
    put(r, 64 + c, chunk(r, 64 + c));
  }
  fence_async_shared();
  group_sync(group);
}

// A weight as a matrix [128 rows, n_valid columns] (bf16 or f32, element
// (r, c) at w[r sr + c sc]) rounded to bf16 into the swizzled boxes [128,
// 64] of ws, columns from n_valid to n_cols zero. A bf16 weight with unit
// stride along a row or a column (the towers' layouts) is read 8 values a
// load.
__device__ __noinline__ void load_weight(uint16_t* ws, const void* w, bool w_bf16, int64_t sr,
                                         int64_t sc, int n_valid, int n_cols, int tid, int nt) {
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  const bool vec = w_bf16 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (vec && sc == 1 && sr % 8 == 0 && n_valid % 8 == 0) {  // 8 columns of a row a load
    for (int e = tid; e < kD * (n_cols / 8); e += nt) {
      const int r = e / (n_cols / 8), c0 = 8 * (e % (n_cols / 8));
      *reinterpret_cast<uint4*>(ws + box_off<kD>(r, c0)) =
          c0 < n_valid ? __ldg(reinterpret_cast<const uint4*>(wb + r * sr + c0))
                       : make_uint4(0, 0, 0, 0);
    }
    return;
  }
  if (vec && sr == 1 && sc % 8 == 0) {  // 8 rows of a column a load
    for (int e = tid; e < n_cols * (kD / 8); e += nt) {
      const int c = e / (kD / 8), r0 = 8 * (e % (kD / 8));
      const uint4 v = c < n_valid ? __ldg(reinterpret_cast<const uint4*>(wb + c * sc + r0))
                                  : make_uint4(0, 0, 0, 0);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
        ws[box_off<kD>(r0 + k, c)] = static_cast<uint16_t>(u[k >> 1] >> (16 * (k & 1)));
    }
    return;
  }
  const float* wf = static_cast<const float*>(w);
#pragma unroll 8
  for (int e = tid; e < kD * n_cols; e += nt) {  // the unit-stride index fastest
    const int r = sr == 1 ? e % kD : e / n_cols, c = sr == 1 ? e / kD : e % n_cols;
    const int64_t at = r * sr + c * sc;
    const float v = c >= n_valid ? 0.f : w_bf16 ? __bfloat162float(__ushort_as_bfloat16(wb[at]))
                                                : wf[at];
    ws[box_off<kD>(r, c)] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
}

// Row r of the bf16 x tile . column c of W1 (row c of the stored W1^T), one
// fmaf a k in k order (relu_ties's ordered_dot_chunks); out of line: a tie's
// rare path
__device__ __noinline__ float x_dot_w1(const unsigned char* xs, const uint16_t* w1s, int r, int c) {
  const unsigned char* xr = xs + r * 128;
  const unsigned char* wr = reinterpret_cast<const unsigned char*>(w1s) + c * 128;
  return ordered_dot_chunks(
      kD / 8,
      [&](int64_t j) { return lds128(xr + (j >> 3) * kBox + ((((int)j & 7) ^ (r & 7)) << 4)); },
      [&](int64_t j) { return lds128(wr + (j >> 3) * kWBox + ((((int)j & 7) ^ (c & 7)) << 4)); });
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// The weights as the caller holds them: bf16 or f32, W1 and W2 with element
// strides (s0 along the 128 inputs, s1 along the outputs), b1 contiguous
struct Weights {
  const void* w1;
  int64_t w1_s0, w1_s1;
  const void* b1;
  const void* w2;
  int64_t w2_s0, w2_s1;
  int bf16;
};

template <typename IO, int H2P, int SPLIT>
__global__ void __launch_bounds__(Layout<IO, H2P>::threads, 1)
tower_bwd_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mdx,
                 const IO* __restrict__ dq, const IO* __restrict__ out, const Weights wt,
                 float* __restrict__ partials, int64_t batch, int h2) {
  using L = Layout<IO, H2P>;
  constexpr int S = L::stages, H = L::hands;
  constexpr bool kProducts = SPLIT != kLoads;
  constexpr bool kEpilogue = SPLIT == kWhole || SPLIT >= kEpilogues;
  constexpr bool kGrads = SPLIT == kWhole || SPLIT >= kGradients;
  constexpr bool kStore = SPLIT == kWhole;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L::empty);
  uint64_t* hfull = reinterpret_cast<uint64_t*>(smem + L::hfull);
  uint64_t* hfree = reinterpret_cast<uint64_t*>(smem + L::hfree);
  uint16_t* b1s = reinterpret_cast<uint16_t*>(smem + L::b1);
  uint16_t* d1s = reinterpret_cast<uint16_t*>(smem + L::d1);
  unsigned char* base = smem + L::small;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;
  uint16_t* w1s = reinterpret_cast<uint16_t*>(base + L::w1);
  uint16_t* w2s = reinterpret_cast<uint16_t*>(base + L::w2);
  unsigned char* hand = base + L::hand;
  unsigned char* ring = base + L::ring;

  const int tid = threadIdx.x;
  const int64_t n_tiles = (batch + kT - 1) / kT;
  // the block's tiles: tile_of(q) for q < nq; tile q in stage q % S and hand-over q % H
  auto tile_of = [&](int64_t q) { return static_cast<int64_t>(blockIdx.x) + q * gridDim.x; };
  auto rows_of = [&](int64_t row0) { return batch - row0 < kT ? batch - row0 : int64_t(kT); };
  const int64_t nq = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  int* loaded = reinterpret_cast<int*>(smem + L::counts) + kConsumers;  // tiles issued
  // tile q's x by TMA into its stage (free: the caller has seen its empty
  // phase), and its dq and out runs into the L2 cache for the rows' loads
  auto produce = [&](int64_t q) {
    const int s = static_cast<int>(q % S);
    const int64_t row0 = tile_of(q) * kT;
    const uint32_t vbytes = static_cast<uint32_t>(rows_of(row0) * h2 * int64_t(sizeof(IO)));
    unsigned char* st = ring + size_t(s) * L::x_bytes;
    mbar_arrive_expect_tx(full + s, static_cast<uint32_t>(L::x_bytes));
#pragma unroll
    for (int b = 0; b < L::x_boxes; ++b)
      tma_load_2d(st + b * kBox, &mx, full + s, b * (128 / int(sizeof(IO))),
                  static_cast<int>(row0));
    prefetch_l2(dq + row0 * h2, vbytes);
    prefetch_l2(out + row0 * h2, vbytes);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * kConsumers);  // each warp's release
    }
    for (int h = 0; h < H; ++h) {
      mbar_init(hfull + h, 1);               // the row warpgroup's
      mbar_init(hfree + h, 4 * kConsumers);  // each warp's
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {  // the ring's first tiles, on their way while the weights load
    tma_prefetch_map(&mx);
    for (int64_t q = 0; q < S && q < nq; ++q) produce(q);
    *loaded = static_cast<int>(S < nq ? S : nq);
  }

  // the weights rounded to bf16, row-major in swizzled boxes [128, 64]; b1 and
  // its tie bounds d = bf16(next_above(-b) + b)
  load_weight(w1s, wt.w1, wt.bf16, wt.w1_s1, wt.w1_s0, kD, kD, tid, L::threads);  // W1^T
  load_weight(w2s, wt.w2, wt.bf16, wt.w2_s0, wt.w2_s1, h2, H2P, tid, L::threads);  // W2
  for (int c = tid; c < kD; c += L::threads) {
    const uint16_t bb =
        wt.bf16 ? static_cast<const uint16_t*>(wt.b1)[c]
                : __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<const float*>(wt.b1)[c]));
    b1s[by_lane(c)] = bb;
    d1s[by_lane(c)] = __bfloat16_as_ushort(tie_ceiling(bb));
  }
  if (tid < kConsumers) reinterpret_cast<int*>(smem + L::counts)[tid] = 0;
  fence_async_shared();
  __syncthreads();

  const int cw = tid / kGroupThreads, gt = tid % kGroupThreads;
  const int lane = tid & 31, gw = gt >> 5, g = lane >> 2, tq = lane & 3;
  const int r0 = 16 * gw + g;  // this thread's rows of a fragment: r0 and r0 + 8
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + L::ties) + cw * kPool;
  int* count = reinterpret_cast<int*>(smem + L::counts) + cw;

  // The loads from tile S on, in tile order: at the start of each of its
  // steps (before any wait, so off the products' path), a warpgroup's first
  // thread claims the next tiles whose stages it sees free (`loaded`, by
  // compare-and-swap: one issuer a tile). It tests only stages whose last
  // tile its warpgroup is done with, so the empty barrier is in that tile's
  // phase or past it, never two phases behind; a stage freed by the other
  // warpgroup is claimed at its next step.
  int64_t next = 0;  // this warpgroup's gradient steps done
  auto ready = [&]() {
    for (;;) {
      const int q = *reinterpret_cast<volatile int*>(loaded);
      if (q >= nq || q - S >= next ||
          !mbar_test(empty + q % S, static_cast<uint32_t>((q / S - 1) & 1)))
        return;
      if (atomicCAS(loaded, q, q + 1) == q) produce(q);
    }
  };

  // The sums a warpgroup carries across its tiles: of a gradient
  // warpgroup gg, its rows of dW1 and dW2 (64 gg + r, fragment layout); of a
  // row warpgroup, its lanes' db1 columns (`db1_col`) and its threads' db2
  // columns (8 at the towers' widths, else 1).
  const bool wide_d2 = h2 == H2P;  // the towers' widths: d2 formed 8 columns at a time
  // db1: after the fold, value k of this lane is column db1_col(k)
  const int fold = (lane & 16 ? 16 : 0) + (lane & 8 ? 8 : 0) + (lane & 4 ? 4 : 0);
  auto db1_col = [&](int k) { const int i = fold + k; return 8 * (i >> 1) + 2 * tq + (i & 1); };

  // ---- row work: the tile's products and epilogues, dx out -------------------------------
  auto row = [&](int64_t q, float (&db1p)[4], float (&db2p)[8]) {
    const int s = static_cast<int>(q % S), h = static_cast<int>(q % H);
    unsigned char* st = ring + size_t(s) * L::x_bytes;
    unsigned char* hb = hand + size_t(h) * L::hand_bytes;
    unsigned char* dxst = base + L::dxs + cw * L::x_bytes;  // this warpgroup's dx stage
    uint16_t* h1u = reinterpret_cast<uint16_t*>(hb + L::h_h1);
    uint16_t* d1u = reinterpret_cast<uint16_t*>(hb + L::h_d1);
    uint16_t* d2u = reinterpret_cast<uint16_t*>(hb + L::h_d2);
    const int64_t row0 = tile_of(q) * kT;
    const int rows = static_cast<int>(rows_of(row0));
    if (gt == 0) {
      if (L::grads == 0) ready();
      if (kStore) bulk_wait_read<0>();  // the last tile's dx stores have read the dx stage
    }
    mbar_wait(full + s, static_cast<uint32_t>((q / S) & 1));
    if constexpr (L::kIoF32) {
      if (kEpilogue) x_to_bf16(st, gt, cw);
    }

    // pre1 = x W1, issued now and waited for after d2 is formed
    float acc[64];
    if (kProducts) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kD / 16; ++ks)
        wgmma_bf16<128, 0, 0>(acc, kmajor(st, ks, kBox), kmajor(w1s, ks, kWBox), ks > 0);
      wgmma_commit();
    }
    // the hand-over buffer free (the gradients of its last tile done)
    if (q >= H) mbar_wait(hfree + h, static_cast<uint32_t>((q / H - 1) & 1));
    // d2 = out > 0 ? dq : 0 from the tile's flat runs of dq and out (rows h2
    // values apart; in the L2 cache since the tile's load was issued), under
    // the product; zero past h2 and past the batch. At h2 = H2P a thread
    // takes 8 columns, 8 (gt % (H2P / 8)) .., every 128 / (H2P / 8) rows, a
    // few rows' loads in flight at once; else one column, gt % H2P, every
    // 128 / H2P rows.
    if (kEpilogue) {
      const IO* dqt = dq + row0 * h2;
      const IO* ot = out + row0 * h2;
      if (wide_d2) {
        constexpr int kPer = H2P / 8;                    // chunks of 8 values a row
        constexpr int kStep = kGroupThreads / kPer;      // rows between a thread's chunks
        constexpr int kWords = int(sizeof(IO)) / 2;      // 16-byte words a chunk
        constexpr int kBatch = 4 / kWords;               // chunks loaded before their use
        const int c = 8 * (gt % kPer);
#pragma unroll
        for (int i0 = 0; i0 < kT / kStep; i0 += kBatch) {
          uint4 dw[kBatch][kWords], ow[kBatch][kWords];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int r = gt / kPer + (i0 + b) * kStep;
#pragma unroll
            for (int u = 0; u < kWords; ++u) {
              const bool in = r < rows;
              dw[b][u] = in ? __ldg(reinterpret_cast<const uint4*>(dqt + r * H2P + c) + u)
                            : make_uint4(0, 0, 0, 0);
              ow[b][u] = in ? __ldg(reinterpret_cast<const uint4*>(ot + r * H2P + c) + u)
                            : make_uint4(0, 0, 0, 0);
            }
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const int r = gt / kPer + (i0 + b) * kStep;
            float dv[8], ov[8];
#pragma unroll
            for (int u = 0; u < kWords; ++u) {
              const uint32_t du[4] = {dw[b][u].x, dw[b][u].y, dw[b][u].z, dw[b][u].w};
              const uint32_t ou[4] = {ow[b][u].x, ow[b][u].y, ow[b][u].z, ow[b][u].w};
#pragma unroll
              for (int k = 0; k < 8 / kWords; ++k) {
                const int e = u * (8 / kWords) + k;  // the value's column in the chunk
                if constexpr (L::kIoF32) {
                  dv[e] = __uint_as_float(du[k]);
                  ov[e] = __uint_as_float(ou[k]);
                } else {
                  dv[e] = __uint_as_float(k & 1 ? du[k >> 1] & 0xffff0000u : du[k >> 1] << 16);
                  ov[e] = __uint_as_float(k & 1 ? ou[k >> 1] & 0xffff0000u : ou[k >> 1] << 16);
                }
              }
            }
            uint32_t packed[4];
#pragma unroll
            for (int k = 0; k < 8; k += 2) {
              const float a0 = ov[k] > 0.f ? dv[k] : 0.f;
              const float a1 = ov[k + 1] > 0.f ? dv[k + 1] : 0.f;
              db2p[k] += a0;
              db2p[k + 1] += a1;
              packed[k >> 1] = as_bits(__floats2bfloat162_rn(a0, a1));
            }
            *reinterpret_cast<uint4*>(d2u + box_off<kT>(r, c)) =
                make_uint4(packed[0], packed[1], packed[2], packed[3]);
          }
        }
      } else {
        const int c = gt % H2P;
        const bool live = c < h2;
#pragma unroll 8
        for (int r = gt / H2P; r < kT; r += kGroupThreads / H2P) {
          float d = 0.f;
          if (live && r < rows) {
            const int64_t i = int64_t(r) * h2 + c;
            d = to_f32(__ldg(ot + i)) > 0.f ? to_f32(__ldg(dqt + i)) : 0.f;
          }
          db2p[0] += d;
          d2u[box_off<kT>(r, c)] = __bfloat16_as_ushort(__float2bfloat16_rn(d));
        }
      }
    }
    if (kProducts) {
      wgmma_wait<0>();
      fence_operands(acc);
    }

    // the layer-1 epilogue: h1 = relu(pre1) into the hand-over buffer, the
    // mask pre1 > 0 and the ties as bits
    uint32_t pos[2] = {0, 0}, tie[2] = {0, 0};
    if (kEpilogue) {
      const bf162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // pairs j = 4 i .. 4 i + 3
        const uint4 bq = lds128(b1s + tq * (kD / 4) + 8 * i);
        const uint4 dd = lds128(d1s + tq * (kD / 4) + 8 * i);
        const uint32_t bv[4] = {bq.x, bq.y, bq.z, bq.w}, dv[4] = {dd.x, dd.y, dd.z, dd.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * i + u, c = 8 * j + 2 * tq;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const bf162 r = __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
            const bf162 pre = pre_bias2(r, as_pair(bv[u]));
            const int p = 2 * j + hh;
            flag_pair(tie, ties2(pre, as_pair(dv[u])), p);
            const bf162 gt0 = __hgt2(pre, zero);
            flag_pair(pos, as_bits(gt0), p);
            *reinterpret_cast<bf162*>(h1u + box_off<kT>(r0 + 8 * hh, c)) = relu2(pre);
          }
        }
      }
    }
    // the ties summed again in k order (behind the warpgroup's barrier, which
    // also makes d2 and h1 whole for the tensor cores); the mask of a tied
    // value then read back from h1 by the thread that holds it
    const uint64_t tmask = uint64_t(tie[1]) << 32 | tie[0];
    const unsigned char* xs = st;
    settle_ties(kEpilogue ? tmask : 0, cw, gw, lane, cw, r0, tq, list, count,
                [&]() {  // dh1 = d2 W2^T, under the ties' recompute
                  if (kProducts) {
                    wgmma_fence();
#pragma unroll
                    for (int ks = 0; ks < H2P / 16; ++ks)
                      wgmma_bf16<128, 0, 0>(acc, kmajor(d2u, ks, kBox), kmajor(w2s, ks, kWBox),
                                            ks > 0);
                    wgmma_commit();
                  }
                },
                [&](int r, int c) {
                  const float sum = x_dot_w1(xs, w1s, r, c);
                  h1u[box_off<kT>(r, c)] = finish(
                      rnd(sum), __bfloat162float(__ushort_as_bfloat16(b1s[by_lane(c)])));
                });
    if (kEpilogue) {
      for (uint64_t m = tmask; m; m &= m - 1) {
        const int b = __ffsll(static_cast<long long>(m)) - 1;
        const uint32_t e = tie_at(b, r0, tq);
        const bool on =
            __bfloat162float(__ushort_as_bfloat16(h1u[box_off<kT>(e >> 7, e & 127u)])) > 0.f;
        pos[b >> 5] = (pos[b >> 5] & ~(1u << (b & 31))) | (uint32_t(on) << (b & 31));
      }
    }

    // d1 = mask ? dh1 : 0: db1 from the f32 values, bf16(d1) packed in
    // registers as dx's A operand, then (under dx's products) into the
    // hand-over buffer
    if (kProducts) {
      wgmma_wait<0>();
      fence_operands(acc);
    }
    uint32_t a[32];  // a[p]: bf16(d1) of pair p; a[4 ks .. 4 ks + 3] is dx's A at k step ks
    float col[32];   // column 8 (i / 2) + 2 t + i % 2 summed over this thread's two rows
    if (kEpilogue) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = 2 * j + hh;
          const float v0 = flag_of(pos, p, 0) ? acc[4 * j + 2 * hh] : 0.f;
          const float v1 = flag_of(pos, p, 1) ? acc[4 * j + 2 * hh + 1] : 0.f;
          if (hh == 0) {
            col[2 * j] = v0;
            col[2 * j + 1] = v1;
          } else {
            col[2 * j] += v0;
            col[2 * j + 1] += v1;
          }
          a[p] = as_bits(__floats2bfloat162_rn(v0, v1));
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < 32; ++p) a[p] = 0;
    }

    // dx = d1 W1^T in two halves of 64 columns, the second's product under the
    // first's epilogue, into the tile's dq / out stage (free: every thread
    // formed its d2 before the ties' barrier)
    float ax[2][32];
    if (kProducts) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kD / 16; ++ks)
          wgmma_rs64(ax[half], a[4 * ks], a[4 * ks + 1], a[4 * ks + 2], a[4 * ks + 3],
                        mnmajor(w1s + half * (kWBox / 2), ks, kWBox), ks > 0);
        wgmma_commit();
      }
    }
    if (kEpilogue) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(d1u + box_off<kT>(r0 + 8 * hh, 8 * j + 2 * tq)) =
              a[2 * j + hh];
      // the warp's 16 rows folded over the 8 lanes of a column group (lane
      // bits 4, 3, 2): each lane keeps 4 columns' sums
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const bool hi = lane & 16;
        const float send = hi ? col[k] : col[k + 16], keep = hi ? col[k + 16] : col[k];
        col[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool hi = lane & 8;
        const float send = hi ? col[k] : col[k + 8], keep = hi ? col[k + 8] : col[k];
        col[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool hi = lane & 4;
        const float send = hi ? col[k] : col[k + 4], keep = hi ? col[k + 4] : col[k];
        db1p[k] += keep + __shfl_xor_sync(0xffffffffu, send, 4);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (kProducts) {
        if (half == 0)
          wgmma_wait<1>();
        else
          wgmma_wait<0>();
        fence_operands(ax[half]);
      }
      if (kEpilogue) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 64 * half + 8 * j + 2 * tq;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = r0 + 8 * hh;
            const float v0 = ax[half][4 * j + 2 * hh], v1 = ax[half][4 * j + 2 * hh + 1];
            if constexpr (L::kIoF32) {
              *reinterpret_cast<float2*>(reinterpret_cast<float*>(dxst) +
                                         box_off_f32(r, c)) = make_float2(v0, v1);
            } else {
              *reinterpret_cast<bf162*>(reinterpret_cast<bf16*>(dxst) +
                                        box_off<kT>(r, c)) = __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
    }
    if (kProducts) fence_regs(a);
    fence_async_shared();
    group_sync(cw);  // dx staged, d1 whole
    if (gt == 0) {
      if (kStore) {
#pragma unroll
        for (int b = 0; b < L::x_boxes; ++b)
          tma_store_2d(&mdx, dxst + b * kBox, b * (128 / int(sizeof(IO))),
                       static_cast<int>(row0));
        bulk_commit();
      }
      mbar_arrive(hfull + h);
    }
  };

  // ---- gradient work: rows 64 gg .. of dW1 and dW2 from tile q ---------------------------
  auto grad = [&](int64_t q, int gg, float (&gw1)[64], float (&gw2)[H2P / 2]) {
    const int s = static_cast<int>(q % S), h = static_cast<int>(q % H);
    const unsigned char* st = ring + size_t(s) * L::x_bytes;
    const unsigned char* hb = hand + size_t(h) * L::hand_bytes;
    const bool own = L::grads == 0 && q % kConsumers == cw;
    if (gt == 0) ready();
    if (!own) mbar_wait(hfull + h, static_cast<uint32_t>((q / H) & 1));
    if (kGrads) {
      fence_operands(gw1);
      fence_operands(gw2);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks)
        wgmma_bf16<128, 1, 1>(gw1, mnmajor(st + gg * kBox, ks, kBox),
                              mnmajor(hb + L::h_d1, ks, kBox), 1);
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks)
        wgmma_bf16<H2P, 1, 1>(gw2, mnmajor(hb + L::h_h1 + gg * kBox, ks, kBox),
                              mnmajor(hb + L::h_d2, ks, kBox), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(gw1);
      fence_operands(gw2);
    }
    // each warp's release of the tile once its products have read it
    ++next;
    if (lane == 0) {
      mbar_arrive(hfree + h);
      mbar_arrive(empty + s);
    }
  };

  // this block's partial gradients: [dW1 128x128 | db1 128 | dW2 128xH2 | db2 H2]
  const int64_t n_out = kD * kD + kD + int64_t(kD) * h2 + h2;
  float* part = partials + blockIdx.x * n_out;
  float* pw2 = part + kD * kD + kD;
  auto zero = [](auto& a) {
#pragma unroll
    for (int i = 0; i < int(sizeof(a) / sizeof(a[0])); ++i) a[i] = 0.f;
  };
  auto put_weights = [&](int gg, const float (&gw1)[64], const float (&gw2)[H2P / 2]) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e)  // one value a store: a block's run starts anywhere
          part[(64 * gg + r0 + 8 * hh) * kD + 8 * j + 2 * tq + e] = gw1[4 * j + 2 * hh + e];
#pragma unroll
    for (int j = 0; j < H2P / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 64 * gg + r0 + 8 * hh, c = 8 * j + 2 * tq + e;
          if (c < h2) pw2[r * h2 + c] = gw2[4 * j + 2 * hh + e];
        }
  };
  // db1 and db2 through shared memory (the first hand-over buffer, free once
  // every warpgroup is past its last gradients), summed in a fixed order
  float* red1 = reinterpret_cast<float*>(hand);  // [2 x 4 warps][128]
  float* red2 = red1 + kConsumers * 4 * kD;       // [2 x 128 threads][8]
  auto put_biases = [&](const float (&db1p)[4], const float (&db2p)[8]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) red1[(cw * 4 + gw) * kD + db1_col(k)] = db1p[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) red2[tid * 8 + k] = db2p[k];
  };

  if constexpr (L::grads == 0) {
    // Rows of tile q wait for the gradients of the tile that last held its
    // hand-over buffer; gradients go in tile order (the sums' order is fixed).
    float gw1[64], gw2[H2P / 2], db1p[4], db2p[8];
    zero(gw1), zero(gw2), zero(db1p), zero(db2p);
    for (int64_t q = cw; q < nq || next < nq;) {
      if (q < nq && next >= H * (q / H)) {
        row(q, db1p, db2p);
        q += kConsumers;
      } else {
        grad(next, cw, gw1, gw2);
      }
    }
    if (kStore && gt == 0) bulk_wait<0>();  // this warpgroup's stores are done before it ends
    put_weights(cw, gw1, gw2);
    all_sync(L::threads);
    put_biases(db1p, db2p);
  } else if (cw < kConsumers) {  // a row warpgroup: tiles cw, cw + 2, ...
    float db1p[4], db2p[8];
    zero(db1p), zero(db2p);
    for (int64_t q = cw; q < nq; q += kConsumers) row(q, db1p, db2p);
    if (kStore && gt == 0) bulk_wait<0>();
    all_sync(L::threads);
    put_biases(db1p, db2p);
  } else {  // a gradient warpgroup: every tile, in tile order
    float gw1[64], gw2[H2P / 2];
    zero(gw1), zero(gw2);
    while (next < nq) grad(next, cw - kConsumers, gw1, gw2);
    put_weights(cw - kConsumers, gw1, gw2);
    all_sync(L::threads);
  }
  all_sync(L::threads);
  if (tid < kD) {
    float v = 0.f;
    for (int i = 0; i < kConsumers * 4; ++i) v += red1[i * kD + tid];
    part[kD * kD + tid] = v;
  }
  if (tid < h2) {  // the row threads that formed column tid, in thread order
    constexpr int kRowThreads = kConsumers * kGroupThreads;
    float v = 0.f;
    if (wide_d2) {
      for (int t = (tid >> 3) % (H2P / 8); t < kRowThreads; t += H2P / 8)
        v += red2[t * 8 + (tid & 7)];
    } else {
      for (int t = tid; t < kRowThreads; t += H2P) v += red2[t * 8];
    }
    pw2[kD * h2 + tid] = v;
  }
}

// grads[e] = sum over blocks b, in order, of partials[b][e]
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ partials, float* __restrict__ grads, int n_blocks,
                int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (e >= n_out) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += __ldg(partials + b * n_out + e);
  grads[e] = s;
}

// What a call passes: the activations, the weights, the outputs
struct Call {
  const void* x;
  const void* dq;
  const void* out;
  Weights wt;
  void* dx;
  float* partials;
  float* grads;
  int64_t batch;
  int h2;
  int n_blocks;
};

// A tensor map of x or dx: boxes [64 rows, 128 bytes] with the 128-byte swizzle
template <typename IO>
bool io_map(CUtensorMap* m, const void* base, int64_t batch) {
  return tma_map::swizzled_map(
      m, sizeof(IO) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      int(sizeof(IO)), base, kD, batch, kT);
}

template <typename IO, int H2P, int SPLIT = kWhole>
int launch(const Call& c, cudaStream_t stream) {
  using L = Layout<IO, H2P>;
  auto kernel = tower_bwd_kernel<IO, H2P, SPLIT>;
  // a runtime call first: it makes the device's context current on this
  // thread, which the tensor maps' encoding (a driver call) needs
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mx, mdx;
  if (!io_map<IO>(&mx, c.x, c.batch) || !io_map<IO>(&mdx, c.dx, c.batch))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<c.n_blocks, L::threads, L::bytes, stream>>>(mx, mdx, static_cast<const IO*>(c.dq),
                                                     static_cast<const IO*>(c.out), c.wt,
                                                     c.partials, c.batch, c.h2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = kD * kD + kD + static_cast<int64_t>(kD) * c.h2 + c.h2;
  reduce_partials<<<static_cast<unsigned>((n_out + 255) / 256), 256, 0, stream>>>(
      c.partials, c.grads, c.n_blocks, n_out);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The shapes and dtypes the kernel takes
bool takes(const Call& c, int io_dtype, int w_dtype) {
  if ((io_dtype != kF32 && io_dtype != kBF16) || (w_dtype != kF32 && w_dtype != kBF16))
    return false;
  const int64_t tile = io_dtype == kBF16 ? kT : kT / 2;
  return c.batch > 0 && c.batch % tile == 0 && c.batch < (int64_t(1) << 31) && c.h2 > 0 &&
         c.h2 <= kD && c.n_blocks > 0 && c.n_blocks <= (c.batch + kT - 1) / kT &&
         aligned16(c.x) && aligned16(c.dq) && aligned16(c.out) && aligned16(c.dx) &&
         c.wt.w1 != nullptr && c.wt.b1 != nullptr && c.wt.w2 != nullptr;
}

template <typename IO>
int launch_h2(const Call& c, cudaStream_t stream) {
  return c.h2 <= 64 ? launch<IO, 64>(c, stream) : launch<IO, 128>(c, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when both launches succeeded. x, dq, out and
// dx [batch, 128 or h2] contiguous, f32 (io_dtype 0) or bf16 (1), on 16-byte
// boundaries, batch a multiple of 64 (bf16) or 32 (f32) below 2^31; w1 [128,
// 128] and w2 [128, h2] with element strides (s0 along the inputs, s1 along
// the outputs) and b1 [128] contiguous, all f32 (w_dtype 0) or all bf16 (1).
// partials: [n_blocks, n_out] f32 scratch (n_blocks at most the 64-row tiles
// of the batch: one block an SM); grads: [n_out] f32, laid out
// [dW1 128x128 | db1 128 | dW2 128xH2 | db2 H2].
int ttrm_tower_bwd(const void* x, const void* dq, const void* out, int io_dtype, const void* w1,
                   int64_t w1_s0, int64_t w1_s1, const void* b1, const void* w2, int64_t w2_s0,
                   int64_t w2_s1, int w_dtype, void* dx, void* partials, void* grads,
                   int64_t batch, int64_t h2, int64_t n_blocks, void* stream) {
  const Call c{x, dq, out, {w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, w_dtype == kBF16 ? 1 : 0},
               dx, static_cast<float*>(partials), static_cast<float*>(grads), batch,
               static_cast<int>(h2), static_cast<int>(n_blocks)};
  if (h2 > kD || n_blocks > (int64_t(1) << 30) || !takes(c, io_dtype, w_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return io_dtype == kF32 ? launch_h2<float>(c, s) : launch_h2<bf16>(c, s);
}

// The kernel at bf16 io and h2 = 64 up to stage `split` (a Split: 1 the
// loads, 2 the row products, 3 their epilogues and ties, 4 the gradient
// products; 0 the whole kernel), the arguments as ttrm_tower_bwd's. For
// timing a tile's parts: below 0 the outputs are not the function's.
int ttrm_tower_bwd_split(const void* x, const void* dq, const void* out, int io_dtype,
                         const void* w1, int64_t w1_s0, int64_t w1_s1, const void* b1,
                         const void* w2, int64_t w2_s0, int64_t w2_s1, int w_dtype, void* dx,
                         void* partials, void* grads, int64_t batch, int64_t h2,
                         int64_t n_blocks, int64_t split, void* stream) {
  const Call c{x, dq, out, {w1, w1_s0, w1_s1, b1, w2, w2_s0, w2_s1, w_dtype == kBF16 ? 1 : 0},
               dx, static_cast<float*>(partials), static_cast<float*>(grads), batch,
               static_cast<int>(h2), static_cast<int>(n_blocks)};
  if (io_dtype != kBF16 || h2 != 64 || n_blocks > (int64_t(1) << 30) ||
      !takes(c, io_dtype, w_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (split) {
    case kWhole: return launch<bf16, 64, kWhole>(c, s);
    case kLoads: return launch<bf16, 64, kLoads>(c, s);
    case kRowProducts: return launch<bf16, 64, kRowProducts>(c, s);
    case kEpilogues: return launch<bf16, 64, kEpilogues>(c, s);
    case kGradients: return launch<bf16, 64, kGradients>(c, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
