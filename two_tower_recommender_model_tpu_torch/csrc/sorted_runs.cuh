// Runs of equal sorted ids, walked in spans of 32 positions: the device code
// shared by the kernels that sum per-slot gradient rows by table row, the
// fused row-wise Adagrad (#4) and the dense aggregate (#3) of
// rowwise_adagrad.cu and the fused int8 row-wise Adagrad (#6) of
// quantized_adagrad.cu. Each kernel gives an epilogue: what it does with a
// row's summed gradient. No atomics: every sum has one fixed order.
//
// Contract of the ids: [M] int32, NON-DECREASING, M < 2^31; ids outside
// [0, N) are sentinels (dead slots), never read and never written. Unsorted
// ids would give two owners one row, and they would race. Gradient rows
// src(j) = perm[j] when a permutation is given, else j; f32 or bf16 (widened
// exactly), summed in f32. Any D >= 1: the half-warp walk below takes D % 4
// == 0, D <= 512 with the caller's alignment; every other D or alignment
// takes the general walk (at the end of this header).
//
// Pass 1 (span_runs_kernel): warp w takes the 32 sorted positions of its
// span [32 w, 32 w + 32) and reads their ids, the next 32 and one more (and
// their source rows) in coalesced loads into shared memory. One ballot marks
// where the id changes, another the live ids; the runs that START in the
// span are the warp's. A run may reach into the next span: the warp sums it
// to its end if that lies within the 64 positions it read, and the run is
// then complete. A half-warp (16 lanes, 16-byte loads: a D = 128 bf16 row a
// load) owns a complete run: the epilogue loads what it needs of the table
// row as soon as the id is known, with the run's first gradient rows (the
// ballot gave the run's end, so no load waits on an id compare), the rows
// are summed in position order and the epilogue applied. The two half-warps
// take the complete runs two at a time, in step (the warp stays converged).
// Where M is small (fewer than 2,048 spans) a span's pairs of runs are dealt
// out to `split` warps (up to 16) that each read the span, so that a call
// still has thousands of rows in flight; which warp sums a run does not
// change its bits.
//
// Hot ids. A run that reaches past the 64 positions its owner read is long.
// Its owner sums the run's first piece (to the end of the next span) and
// each later span w whose first position continues a run that started at
// least 33 positions before it (ids[32 w - 33] == ids[32 w]) sums the piece
// in its own span: the segments of a long run are the spans, each summed by
// its own warp. Such a piece is summed by the whole warp (the half-warps
// take its first and second half, then add in that order) and written as an
// f32 row to the scratch `part`, its id to `part_id` (slot 2 w: a long run's
// first piece; 2 w + 1: a later piece; -1 where a span has none).
// Pass 2 (long_runs_kernel): block b reads the first-piece slots of spans
// [32 b, 32 b + 32); for each long run found it counts the run's later
// pieces (the consecutive slots 2 (w0 + j) + 1, j >= 2, that name it) and
// adds the T = 1 + count pieces in segment order: one warp adds them in
// order when T <= 64; for a longer run the block's 8 warps each add a
// contiguous eighth in order and the eighths are added in order. Then one
// half-warp applies the epilogue. A hot id of 21,842 rows is so summed by
// ~680 warps at once and 8 more, not by one warp in 21,842 steps.
//
// The sum orders. A complete run: each column in position order, from 0.
// mean(g^2), where an epilogue takes it (half_sum_squares): in the order of a
// walk of one warp a row, four columns a lane, which is how these kernels
// summed runs before they walked spans, so a complete run keeps those bits.
// A long run: the pieces' order above, fixed, so two launches agree bit for
// bit.
//
// An epilogue E holds its own pointers and gives
//   template <int V, int NC> struct Row;  what it reads of table row r
//   template <int V, int NC> Row<V, NC> load(int32_t r, int hl, int64_t d) const;
//   template <int V, int NC> void apply(int32_t r, float (&g)[NC][V],
//                                       const Row<V, NC>& t, int64_t d) const;
// g holds this lane's chunks of the row (lane hl of the half-warp: V columns
// from col_of<V>(c, hl) for each chunk c). `apply` is called by the whole
// warp, each half-warp with its own row and r < 0 for a half-warp without
// one, which must still take part in any shuffle or ballot.
//
// The bf16 buffer (template flag B16: `scatter_buffer_dtype="bfloat16"` on
// the sorted table). The reference sums a run into a bf16 buffer, which XLA
// does in position order with a rounding after every add:
//   acc = bf16(f32(acc) + f32(bf16(g_j))),  acc from 0.
// Such a sum cannot be cut into pieces summed apart: every piecewise or tree
// order gives other bits. So in this mode a complete run is summed as above
// (sum_rows rounds after each add), pass 1 sums no piece of a long run (it
// only names the run's first span, part_id[2 w]), and pass 2
// (long_runs_b16_kernel) walks each long run from its first position to its
// last, one dependent add a row: 7 producer warps stream the run's gradient
// rows, rounded to bf16, through a ring of 3 chunks of shared memory (of
// up to 160 rows of D = 128, each chunk one round trip of loads; named
// barriers FULL and EMPTY a chunk) while warp 0 adds them in order, lane l
// holding the four columns 4 (l + 32 c) as two bf16x2 sums (__hadd2). A
// correctly rounded bf16 add is the reference's f32 add rounded to bf16: the
// f32 sum of two bf16 values is exact unless their exponents lie 16 or more
// apart, and then both roundings give the larger; one instruction a pair of
// columns in place of an f32 add, a rounding and a widening a column. A hot
// id of 21,842 positions is so 21,842 dependent steps of one warp; the
// producers keep two chunks ahead of it. The epilogue is the f32 mode's.
//
// Scratch: part [2 * ceil(M / 32), D] f32 and part_id [2 * ceil(M / 32)]
// int32, allocated by the caller on its stream; nothing carries over between
// calls (the bf16 buffer's walk uses part_id alone). The general walk needs
// one more row of D f32 for each warp of its pass 1 (`general_slots`). Both
// passes go to the caller's stream and allocate nothing.
//
// The general walk (any D, any alignment). A half-warp holds its row in
// registers, V x NC floats a lane, so the walk above stops at D = 512; and
// its loads are 8 or 16 bytes wide, so it needs D % 4 == 0. Every other D
// or alignment takes this walk: the same spans, runs and pieces, with
//   - one warp a run, its lane l holding the columns of chunks (l + 32 k) V
//     .. + V - 1 (V = 4 where D % 4 == 0 and the pointers allow 8- or
//     16-byte accesses, else 1: scalar loads and stores);
//   - the run summed a column slice at a time (32 V x kSliceChunks columns:
//     in registers, in position order, each column from 0) and each slice
//     written as f32 to the run's "sum row": the warp's own row of the
//     scratch (`stash`), or where the epilogue keeps its result (#3's output
//     row). The row's whole-row figures an epilogue needs, sum(g^2) and
//     whether any g is nonzero (`RowStats`), are taken on the way, lane l
//     in chunk order then the warp's xor tree, the order `row_stats` reads
//     them back in; then the epilogue reads the row again (`apply_row`): a
//     sum outlives its slice, and the slicing orders no sum;
//   - a long run's pieces summed by the whole warp in position order and
//     written to `part` as above; pass 2 (`long_runs_general_kernel`) adds
//     a run's T pieces in segment order, thread t the columns (t + 256 k) V,
//     into the first piece's row, which the epilogue then reads; in the bf16
//     buffer's mode (`long_runs_b16_general_kernel`) thread t walks the run
//     from its first position to its last for its columns, the positions'
//     source rows staged 256 at a time in shared memory, one rounding after
//     every add, and writes the sum to the run's `part` row (which that
//     mode leaves free).
// The sum orders: each column in position order (pieces in segment order);
// sum(g^2) as `row_stats`. Fixed, so two launches agree bit for bit; they
// are not the half-warp walk's, which keeps its own bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sorted_runs {

constexpr int kSpan = 32;            // sorted positions per warp: one id a lane
constexpr int kWindow = 2 * kSpan;   // positions a warp sums at most: its span and the next
constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kLanes = 16;           // lanes that hold one row: a half-warp
constexpr int kMaxD = 512;
constexpr int kWarpRows = 64;        // pass 2: a run of at most this many pieces is one warp's
constexpr unsigned kFullWarp = 0xffffffffu;
// the bf16 buffer's pass 2: a ring of kRing chunks of at most kRingRows rows
// and kRingElems bf16 values each (dynamic shared memory), filled by the
// block's warps but the first, each producer lane copying up to kCopies
// words of four values a chunk at D = 128
constexpr int kRing = 3;
constexpr int kRingElems = 20480;
constexpr int kRingBytes = kRing * kRingElems * 2;
constexpr int kRingRows = 192;
constexpr int kProducers = kThreads - 32;
constexpr int kCopies = (kRingElems / 128 + kProducers / 32 - 1) / (kProducers / 32);

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Whether an epilogue takes f32 sums. One that takes only the bf16 buffer's
// specializes this to false, and its f32 walks are not instantiated.
template <typename E>
struct TakesF32Sums {
  static constexpr bool value = true;
};

// Whether the walk folds a run's gradient rows into its registers' bits in
// place of summing them (a tile split's first stage: the rows read and
// discarded). An epilogue of such a split specializes this to true.
template <typename E>
struct FoldsReads {
  static constexpr bool value = false;
};

// The sorted ids, their gradients and the scratch of long runs.
struct Walk {
  const int32_t* ids;
  const void* grads;
  const int32_t* perm;  // or null
  float* part;          // [2 * n_spans, d] f32: pieces of long runs
  int32_t* part_id;     // [2 * n_spans]: each piece's row, or -1
  float* stash;         // the general walk: [n_spans * split, d] f32, a row a warp of pass 1
  int64_t n_rows, d, m, n_spans;
  int split;            // warps a span in pass 1 (a power of two): each takes every split-th pair
};

// A lane's V consecutive gradient elements as one load: 16 bytes of f32 or
// bf16, or 8 bytes of bf16 (D % 8 == 4, or grads only 8-byte aligned).
template <typename G, int V>
struct Vec;
template <>
struct Vec<float, 4> { using T = float4; };
template <>
struct Vec<uint16_t, 8> { using T = uint4; };
template <>
struct Vec<uint16_t, 4> { using T = uint2; };

// bf16 travels as its raw 16 bits: widening is a 16-bit shift, exact
__device__ __forceinline__ float lo16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void add_to(float (&g)[4], const float4& v) {
  g[0] += v.x;
  g[1] += v.y;
  g[2] += v.z;
  g[3] += v.w;
}
__device__ __forceinline__ void add_to(float (&g)[4], const uint2& v) {
  g[0] += lo16(v.x);
  g[1] += hi16(v.x);
  g[2] += lo16(v.y);
  g[3] += hi16(v.y);
}
__device__ __forceinline__ void add_to(float (&g)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[2 * i] += lo16(w[i]);
    g[2 * i + 1] += hi16(w[i]);
  }
}

// the raw words xor-ed into g's bits: reads that feed no float arithmetic
__device__ __forceinline__ void fold(float& g, uint32_t w) {
  g = __uint_as_float(__float_as_uint(g) ^ w);
}
__device__ __forceinline__ void fold_into(float (&g)[4], const float4& v) {
  fold(g[0], __float_as_uint(v.x) ^ __float_as_uint(v.y) ^ __float_as_uint(v.z) ^
                 __float_as_uint(v.w));
}
__device__ __forceinline__ void fold_into(float (&g)[4], const uint2& v) { fold(g[0], v.x ^ v.y); }
__device__ __forceinline__ void fold_into(float (&g)[8], const uint4& v) {
  fold(g[0], v.x ^ v.y ^ v.z ^ v.w);
}

// x rounded to bf16 (nearest even), as an f32
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bf16 buffer's adds: acc = bf16(acc + bf16(x)); bf16 gradients are
// exact bf16 already.
__device__ __forceinline__ void add_round(float (&g)[4], const float4& v) {
  g[0] = bf16r(g[0] + bf16r(v.x));
  g[1] = bf16r(g[1] + bf16r(v.y));
  g[2] = bf16r(g[2] + bf16r(v.z));
  g[3] = bf16r(g[3] + bf16r(v.w));
}
__device__ __forceinline__ void add_round(float (&g)[4], const uint2& v) {
  g[0] = bf16r(g[0] + lo16(v.x));
  g[1] = bf16r(g[1] + hi16(v.x));
  g[2] = bf16r(g[2] + lo16(v.y));
  g[3] = bf16r(g[3] + hi16(v.y));
}
__device__ __forceinline__ void add_round(float (&g)[8], const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[2 * i] = bf16r(g[2 * i] + lo16(w[i]));
    g[2 * i + 1] = bf16r(g[2 * i + 1] + hi16(w[i]));
  }
}

// The first column of chunk c of lane hl of a 16-lane row: V columns each,
// the 16 lanes' chunks side by side.
template <int V>
__device__ __forceinline__ int64_t col_of(int c, int hl) {
  return static_cast<int64_t>(c * kLanes + hl) * V;
}

// sum(g^2) of the row a half-warp holds, in a fixed order: that of a warp
// whose lane l holds the four columns 4 (l + 32 c) of each 128-column chunk
// c, sums their squares in chunk order and is reduced by shfl_xor 16, 8, 4,
// 2, 1. Such a lane's sum is sq[0] or sq[1] of one of the half-warp's lanes.
// Called by the whole warp; each half-warp gets its own row's sum.
template <int V, int NC>
__device__ __forceinline__ float half_sum_squares(const float (&g)[NC][V], int64_t d, int hl) {
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (col_of<V>(c, hl) < d) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float& part = sq[V == 8 ? i / 4 : c & 1];
        part = fmaf(g[c][i], g[c][i], part);
      }
    }
  // the xor offsets below 16 keep each reduction inside its half-warp
  if (V == 8) {  // sq[0], sq[1]: the four-column lanes 2 hl and 2 hl + 1
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      sq[0] += __shfl_xor_sync(kFullWarp, sq[0], off);
      sq[1] += __shfl_xor_sync(kFullWarp, sq[1], off);
    }
    return sq[0] + sq[1];
  }
  float sum = sq[0] + sq[1];  // the four-column lanes hl and hl + 16
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFullWarp, sum, off);
  return sum;
}

// g = the gradient rows of window positions [b, e) added in position order
// (src: their source rows), this lane's chunks: groups of U rows whose loads
// are all issued before the first add, so a short run is one round trip.
// B16: each add rounded to bf16 (the bf16 buffer); FOLD: the rows folded
// (`fold_into`), not summed.
template <typename G, int V, int NC, bool B16 = false, bool FOLD = false>
__device__ __forceinline__ void sum_rows(const Walk& p, const int* src, int b, int e, int hl,
                                         float (&g)[NC][V]) {
  using VT = typename Vec<G, V>::T;
  constexpr int U = NC >= 4 ? 2 : 8 / NC;
  const G* grads = static_cast<const G*>(p.grads);
  const int64_t d = p.d;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) g[c][i] = 0.f;
  for (int k = b; k < e; k += U) {
    VT raw[U][NC];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k + u < e) {
        const G* row = grads + static_cast<int64_t>(src[k + u]) * d;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (col_of<V>(c, hl) < d)
            raw[u][c] = __ldg(reinterpret_cast<const VT*>(row + col_of<V>(c, hl)));
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (k + u < e) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          if (col_of<V>(c, hl) < d) {
            if constexpr (FOLD)
              fold_into(g[c], raw[u][c]);
            else if constexpr (B16)
              add_round(g[c], raw[u][c]);
            else
              add_to(g[c], raw[u][c]);
          }
      }
  }
}

// A piece of a long run, positions [b, e) of the window, summed by the whole
// warp: half-warp 0 adds [b, mid), half-warp 1 [mid, e), then half 1's sum
// is added to half 0's; half-warp 0 writes the f32 row to slot `slot`.
template <typename G, int V, int NC>
__device__ __forceinline__ void store_piece(const Walk& p, const int* src, int b, int e,
                                            int64_t slot, int32_t r) {
  const int lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int mid = b + ((e - b + 1) >> 1);
  float g[NC][V];
  sum_rows<G, V, NC>(p, src, half ? mid : b, half ? e : mid, hl, g);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float other = __shfl_down_sync(kFullWarp, g[c][i], kLanes);
      g[c][i] += other;
    }
  if (half == 0) {
    float* out = p.part + slot * p.d;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if (col_of<V>(c, hl) < p.d)
#pragma unroll
        for (int i = 0; i < V; i += 4)
          *reinterpret_cast<float4*>(out + col_of<V>(c, hl) + i) =
              make_float4(g[c][i], g[c][i + 1], g[c][i + 2], g[c][i + 3]);
    if (hl == 0) p.part_id[slot] = r;
  }
}

// What a warp finds in its span w: the window's ids (positions 32 w .. 32 w
// + 64) and source rows, read into shared memory, and the runs.
struct Span {
  uint64_t change;   // bit i: ids[i] != ids[i - 1]
  unsigned lo;       // its bits of the span's 32 positions
  unsigned starts;   // the runs this warp owns: they start in the span, live ids
  int last;          // the last of them, or -1
  bool long_run;     // the last one reaches past the window
  bool later_piece;  // position 0 continues a run that started 33 or more positions before
};

// Reads span w's window into ids ([65]) and src ([64]) and finds its runs;
// called by the whole warp.
__device__ __forceinline__ Span read_span(const Walk& p, int64_t w, int* ids, int* src) {
  const int lane = threadIdx.x & 31;
  const int64_t s0 = w * kSpan;
  for (int i = lane; i <= kWindow; i += 32) {
    const int64_t pos = s0 + i;
    ids[i] = pos < p.m ? __ldg(p.ids + pos) : -1;  // past M: a dead id, unlike any live one
    if (i < kWindow)
      src[i] = pos >= p.m ? 0 : p.perm != nullptr ? __ldg(p.perm + pos) : static_cast<int>(pos);
  }
  int prev = -1, back = -1;  // ids[s0 - 1], and ids[s0 - 33] for the later-piece test
  if (lane == 0) {
    if (w >= 1) prev = __ldg(p.ids + s0 - 1);
    if (w >= 2) back = __ldg(p.ids + s0 - kSpan - 1);
  }
  prev = __shfl_sync(kFullWarp, prev, 0);
  back = __shfl_sync(kFullWarp, back, 0);
  __syncwarp();

  const int id = ids[lane];
  const unsigned lo = __ballot_sync(kFullWarp, id != (lane ? ids[lane - 1] : prev));
  const unsigned hi = __ballot_sync(kFullWarp, ids[kSpan + lane] != ids[kSpan + lane - 1]);
  const unsigned live = __ballot_sync(kFullWarp, id >= 0 && id < p.n_rows);
  const uint64_t change = lo | (static_cast<uint64_t>(hi) << 32);  // bit i: ids[i] != ids[i - 1]
  const bool change_at_end = ids[kWindow] != ids[kWindow - 1];
  const unsigned starts = lo & live;  // the runs this warp owns
  const int last = starts ? 31 - __clz(starts) : -1;
  // the last run is long when no change follows it up to and including position 64
  const bool long_run = last >= 0 && (change >> (last + 1)) == 0 && !change_at_end;
  const bool later_piece = w >= 2 && !(lo & 1u) && (live & 1u) && back == ids[0];
  return Span{change, lo, starts, last, long_run, later_piece};
}

// Pass 1: each warp's span of sorted positions (see the header).
template <typename G, int V, int NC, bool B16, typename E>
__global__ void __launch_bounds__(kThreads) span_runs_kernel(const Walk p, const E epi) {
  __shared__ int s_ids[kWarps][kWindow + 1];  // ids of window positions 0 .. 64
  __shared__ int s_src[kWarps][kWindow];      // their gradient rows
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + wib;
  const int64_t w = gw / p.split;      // the span
  const int share = gw & (p.split - 1);  // the pairs of complete runs this warp takes
  if (w >= p.n_spans) return;  // uniform across the warp
  int* ids = s_ids[wib];
  int* src = s_src[wib];
  const Span sp = read_span(p, w, ids, src);
  const uint64_t change = sp.change;
  const unsigned lo = sp.lo, starts = sp.starts;
  const int last = sp.last;
  const bool long_run = sp.long_run, later_piece = sp.later_piece;
  if (B16) {  // a long run is named for pass 2, which sums it whole
    if (share == 0 && lane == 0) p.part_id[2 * w] = long_run ? ids[last] : -1;
  } else if (share == 0) {  // the pieces of long runs: the span's first warp
    if (lane == 0) {
      if (!long_run) p.part_id[2 * w] = -1;
      if (!later_piece) p.part_id[2 * w + 1] = -1;
    }
    if (later_piece) {  // positions [0, the first change) of a long run that started earlier
      const unsigned rest = lo & ~1u;
      store_piece<G, V, NC>(p, src, 0, rest ? __ffs(rest) - 1 : kSpan, 2 * w + 1, ids[0]);
    }
    if (long_run) store_piece<G, V, NC>(p, src, last, kWindow, 2 * w, ids[last]);
  }

  unsigned todo = long_run ? starts & ~(1u << last) : starts;
  if (p.split > 1) {  // this warp's pairs: set bits 2 i and 2 i + 1 with i % split == share
    unsigned keep = 0;
    int k = 0;
    for (unsigned rest = todo; rest; rest &= rest - 1, ++k)
      if (((k >> 1) & (p.split - 1)) == share) keep |= rest & (0u - rest);
    todo = keep;
  }
  // the complete runs, two at a time: the lowest to half-warp 0, the next to 1
  for (unsigned rest = todo; rest;) {
    const unsigned rest2 = rest & (rest - 1);
    const unsigned mine = half ? rest2 & (0u - rest2) : rest & (0u - rest);
    rest = rest2 & (rest2 - 1);
    int b = 0, e = 0;
    int32_t r = -1;
    if (mine) {
      b = __ffs(mine) - 1;
      const uint64_t after = change >> (b + 1);
      e = after ? b + __ffsll(static_cast<long long>(after)) : kWindow;
      r = ids[b];
    }
    const auto t = epi.template load<V, NC>(r, hl, p.d);
    float g[NC][V];
    sum_rows<G, V, NC, B16, FoldsReads<E>::value>(p, src, b, e, hl, g);
    epi.template apply<V, NC>(r, g, t, p.d);
  }
}

// Piece j of the long run whose first piece is slot 2 w0: j = 0 that one,
// then the later pieces of spans w0 + 2, w0 + 3, ...
__device__ __forceinline__ const float* piece(const Walk& p, int64_t w0, int64_t j) {
  return p.part + (j == 0 ? 2 * w0 : 2 * (w0 + 1 + j) + 1) * p.d;
}

// Pieces [j0, j1) added in order by one warp into out (shared memory, [d]):
// lane l holds the float4 at columns 4 (l + 32 c); U rows in flight.
template <int NC4>
__device__ __forceinline__ void add_pieces(const Walk& p, int64_t w0, int64_t j0, int64_t j1,
                                           float* out) {
  constexpr int U = 8 / NC4;
  const int lane = threadIdx.x & 31;
  const int64_t d = p.d;
  float4 s[NC4];
#pragma unroll
  for (int c = 0; c < NC4; ++c) s[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t j = j0;
  for (; j + U <= j1; j += U) {
    float4 v[U][NC4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* row = piece(p, w0, j + u);
#pragma unroll
      for (int c = 0; c < NC4; ++c)
        if ((c * 32 + lane) * 4 < d) v[u][c] = *reinterpret_cast<const float4*>(row + (c * 32 + lane) * 4);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < NC4; ++c)
        if ((c * 32 + lane) * 4 < d) {
          s[c].x += v[u][c].x;
          s[c].y += v[u][c].y;
          s[c].z += v[u][c].z;
          s[c].w += v[u][c].w;
        }
  }
  for (; j < j1; ++j) {
    const float* row = piece(p, w0, j);
#pragma unroll
    for (int c = 0; c < NC4; ++c)
      if ((c * 32 + lane) * 4 < d) {
        const float4 v = *reinterpret_cast<const float4*>(row + (c * 32 + lane) * 4);
        s[c].x += v.x;
        s[c].y += v.y;
        s[c].z += v.z;
        s[c].w += v.w;
      }
  }
#pragma unroll
  for (int c = 0; c < NC4; ++c)
    if ((c * 32 + lane) * 4 < d) *reinterpret_cast<float4*>(out + (c * 32 + lane) * 4) = s[c];
}

// The long runs whose first piece lies in spans [32 b, 32 b + 32), as a
// bit mask of those spans (the block's first warp reads them).
__device__ __forceinline__ unsigned block_heads(const Walk& p, unsigned* s_heads) {
  if ((threadIdx.x >> 5) == 0) {
    const int64_t w = static_cast<int64_t>(blockIdx.x) * 32 + (threadIdx.x & 31);
    const unsigned heads = __ballot_sync(kFullWarp, w < p.n_spans && p.part_id[2 * w] >= 0);
    if ((threadIdx.x & 31) == 0) *s_heads = heads;
  }
  __syncthreads();
  return *s_heads;
}

// Pass 2: the long runs whose first piece lies in the block's 32 spans.
template <int V, int NC, typename E>
__global__ void __launch_bounds__(kThreads) long_runs_kernel(const Walk p, const E epi) {
  constexpr int NC4 = (NC * kLanes * V + 127) / 128;  // float4 chunks of 32 lanes a row
  __shared__ __align__(16) float s_sum[kWarps][kMaxD];
  __shared__ unsigned s_heads, s_big[kWarps];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int64_t w_base = static_cast<int64_t>(blockIdx.x) * 32;
  const unsigned heads = block_heads(p, &s_heads);
  if (heads == 0) return;  // uniform across the block

  // a run of at most kWarpRows pieces: one warp adds them in order (warp k
  // takes the block's long runs k, k + 8, ...); longer ones wait for the block
  unsigned big = 0;
  int idx = 0;
  for (unsigned rest = heads; rest; rest &= rest - 1, ++idx) {
    if (idx % kWarps != wib) continue;
    const int bit = __ffs(rest) - 1;
    const int64_t w0 = w_base + bit;
    const int32_t r = p.part_id[2 * w0];
    int later = 0;  // the later pieces name r in consecutive spans from w0 + 2
    for (bool full = true; full && later < kWarpRows;) {
      const int64_t w = w0 + 2 + later + lane;
      const unsigned b = __ballot_sync(kFullWarp, w < p.n_spans && p.part_id[2 * w + 1] == r);
      later += __popc(b);
      full = b == kFullWarp;
    }
    if (later >= kWarpRows) {
      big |= 1u << bit;
      continue;
    }
    add_pieces<NC4>(p, w0, 0, 1 + later, s_sum[wib]);
    __syncwarp();
    {  // half-warp 0 applies the epilogue
      const int32_t mine = half == 0 ? r : -1;
      const auto t = epi.template load<V, NC>(mine, hl, p.d);
      float g[NC][V];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i)
          g[c][i] = col_of<V>(c, hl) < p.d ? s_sum[wib][col_of<V>(c, hl) + i] : 0.f;
      epi.template apply<V, NC>(mine, g, t, p.d);
    }
    __syncwarp();
  }
  if (lane == 0) s_big[wib] = big;
  __syncthreads();
  big = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) big |= s_big[k];

  // the longer runs, one at a time: each warp adds a contiguous eighth of the
  // pieces in order, then the eighths are added in order
  for (unsigned rest = big; rest; rest &= rest - 1) {
    const int64_t w0 = w_base + __ffs(rest) - 1;
    const int32_t r = p.part_id[2 * w0];
    int64_t later = 0;
    for (;;) {
      const int64_t w = w0 + 2 + later + threadIdx.x;
      const int n = __syncthreads_count(w < p.n_spans && p.part_id[2 * w + 1] == r);
      later += n;
      if (n < kThreads) break;
    }
    const int64_t n_pieces = 1 + later, share = (n_pieces + kWarps - 1) / kWarps;
    const int64_t j0 = wib * share, j1 = j0 + share < n_pieces ? j0 + share : n_pieces;
    if (j0 < j1) add_pieces<NC4>(p, w0, j0, j1, s_sum[wib]);
    __syncthreads();
    if (wib == 0) {  // half-warp 0 of warp 0 applies the epilogue
      const int32_t mine = half == 0 ? r : -1;
      const auto t = epi.template load<V, NC>(mine, hl, p.d);
      float g[NC][V];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int64_t col = col_of<V>(c, hl) + i;
          g[c][i] = 0.f;
          if (col_of<V>(c, hl) < p.d) {
            g[c][i] = s_sum[0][col];
            for (int k = 1; k < kWarps && k * share < n_pieces; ++k) g[c][i] += s_sum[k][col];
          }
        }
      epi.template apply<V, NC>(mine, g, t, p.d);
    }
    __syncthreads();  // s_sum is free for the next run
  }
}

// acc += four bf16 values (a word of two bf16x2 pairs), as two correctly
// rounded bf16x2 adds
__device__ __forceinline__ void add_pair(__nv_bfloat162 (&acc)[2], const uint2& w) {
  acc[0] = __hadd2(acc[0], *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  acc[1] = __hadd2(acc[1], *reinterpret_cast<const __nv_bfloat162*>(&w.y));
}

// Named barriers of the bf16 buffer's pass 2 (0 is __syncthreads'): chunk
// b of the ring is full (the producers arrive, warp 0 waits) and empty (warp
// 0 arrives, the producers wait); the producers' own.
__device__ __forceinline__ int bar_full(int b) { return 1 + b; }
__device__ __forceinline__ int bar_empty(int b) { return 1 + kRing + b; }
constexpr int kBarProducers = 1 + 2 * kRing;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Four gradient values of a source row, rounded to bf16, as raw bf16 pairs.
__device__ __forceinline__ uint32_t bf16_pair_bits(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // one packed conversion
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint2 four_bf16(const float* row) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(row));
  return make_uint2(bf16_pair_bits(v.x, v.y), bf16_pair_bits(v.z, v.w));
}
__device__ __forceinline__ uint2 four_bf16(const uint16_t* row) {
  return __ldg(reinterpret_cast<const uint2*>(row));
}

// Pass 2 of the bf16 buffer: the long runs whose first span lies in the
// block's 32 spans, one at a time, each summed in position order with a
// rounding after every add (see the header). Warp 0 adds; warps 1-7 fill the
// ring: for chunk k of a run, positions [start + k R, start + (k + 1) R),
// producer t < R reads position t's id and source row (one chunk ahead), a
// row of the run gets src >= 0 in s_src, the others -1 (the ids are sorted,
// so the run's rows are a prefix of the chunk); then the producers copy the
// run's rows, four values a thread, rounded to bf16, into the chunk. A
// chunk whose last row is not the run's is the run's last. Every chunk warp
// 0 empties is waited for once by the producers: before they refill it, or
// after the run's last chunk.
template <typename G, int V, int NC, typename E>
__global__ void __launch_bounds__(kThreads) long_runs_b16_kernel(const Walk p, const E epi) {
  constexpr int NC4 = (NC * kLanes * V + 127) / 128;  // float4 chunks of 32 lanes a row
  extern __shared__ __align__(16) uint16_t s_ring[];  // kRing chunks of kRingElems
  uint16_t(*s_g)[kRingElems] = reinterpret_cast<uint16_t(*)[kRingElems]>(s_ring);
  __shared__ int s_src[kRing][kRingRows];
  __shared__ __align__(16) float s_sum[kMaxD];
  __shared__ unsigned s_heads;
  __shared__ int64_t s_start;
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int64_t w_base = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t d = p.d;
  const unsigned heads = block_heads(p, &s_heads);
  if (heads == 0) return;  // uniform across the block
  const int rows = static_cast<int>(kRingElems / d < kRingRows ? kRingElems / d : kRingRows);

  for (unsigned rest = heads; rest; rest &= rest - 1) {
    const int64_t w0 = w_base + __ffs(rest) - 1;
    const int32_t r = p.part_id[2 * w0];
    if (wib == 0) {  // the run starts at its first position in span w0
      const int64_t pos = w0 * kSpan + lane;
      const unsigned in_run = __ballot_sync(kFullWarp, pos < p.m && __ldg(p.ids + pos) == r);
      if (lane == 0) s_start = w0 * kSpan + __ffs(in_run) - 1;
    }
    __syncthreads();
    const int64_t start = s_start;

    if (wib == 0) {  // the adds, one row at a time, two columns an instruction
      constexpr int kAhead = 8;  // rows whose shared-memory loads go out before their adds
      const int stride = static_cast<int>(d / 4);  // a row's 8-byte words
      bool on[NC4];
      __nv_bfloat162 s[NC4][2];
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        on[c] = (c * 32 + lane) * 4 < d;
        s[c][0] = s[c][1] = __float2bfloat162_rn(0.f);
      }
      for (int k = 0;; ++k) {
        const int b = k % kRing;
        bar_sync(bar_full(b), kThreads);
        int n = 0;  // the run's rows in the chunk: a prefix
        for (int j0 = 0; j0 < rows; j0 += 32) {
          const bool in_run = j0 + lane < rows && s_src[b][j0 + lane] >= 0;
          const int c = __popc(__ballot_sync(kFullWarp, in_run));
          n += c;
          if (c < 32) break;
        }
        // lane's four columns of row j of the chunk: words[j * stride + 32 c]
        const uint2* words = reinterpret_cast<const uint2*>(s_g[b]) + lane;
        int j = 0;
        for (; j + kAhead <= n; j += kAhead) {  // kAhead rows' loads, then their adds
          uint2 v[kAhead][NC4];
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
#pragma unroll
            for (int c = 0; c < NC4; ++c)
              if (on[c]) v[u][c] = words[(j + u) * stride + 32 * c];
#pragma unroll
          for (int u = 0; u < kAhead; ++u)
#pragma unroll
            for (int c = 0; c < NC4; ++c)
              if (on[c]) add_pair(s[c], v[u][c]);
        }
        for (; j < n; ++j)
#pragma unroll
          for (int c = 0; c < NC4; ++c)
            if (on[c]) add_pair(s[c], words[j * stride + 32 * c]);
        bar_arrive(bar_empty(b), kThreads);
        if (n < rows) break;
      }
#pragma unroll
      for (int c = 0; c < NC4; ++c) {
        const int col = (c * 32 + lane) * 4;
        if (col < d)
          *reinterpret_cast<float4*>(s_sum + col) =
              make_float4(__low2float(s[c][0]), __high2float(s[c][0]), __low2float(s[c][1]),
                          __high2float(s[c][1]));
      }
      __syncwarp();
      const int32_t mine = half == 0 ? r : -1;  // half-warp 0 applies the epilogue
      const auto t = epi.template load<V, NC>(mine, hl, d);
      float g[NC][V];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i)
          g[c][i] = col_of<V>(c, hl) < d ? s_sum[col_of<V>(c, hl) + i] : 0.f;
      epi.template apply<V, NC>(mine, g, t, d);
    } else {  // the producers
      const int t = threadIdx.x - 32;
      // position t of chunk k: its id and source row, loaded with no wait on them
      auto load = [&](int k, int& id, int& sr) {
        const int64_t pos = start + static_cast<int64_t>(k) * rows + t;
        id = -1;
        sr = 0;
        if (t < rows && pos < p.m) {
          id = __ldg(p.ids + pos);
          sr = p.perm != nullptr ? __ldg(p.perm + pos) : static_cast<int>(pos);
        }
      };
      constexpr int kPW = kProducers / 32, kU = kCopies;  // producer warps; rows a batch
      const int pw = wib - 1;
      const G* grads = static_cast<const G*>(p.grads);
      int id, sr;
      load(0, id, sr);
      int k = 0;
      for (;; ++k) {
        const int b = k % kRing;
        int next_id, next_sr;
        load(k + 1, next_id, next_sr);  // in flight while this chunk fills
        if (k >= kRing) bar_sync(bar_empty(b), kThreads);
        if (t < rows) s_src[b][t] = id == r ? sr : -1;
        bar_sync(kBarProducers, kProducers);
        // producer warp pw copies rows pw, pw + 7, ...: a lane the units lane,
        // lane + 32, ... of each; kU rows' addresses first, then their loads with no
        // branch between them (a row outside the run loads row 0 and stores
        // nothing), then the stores
        for (int row0 = pw; row0 < rows; row0 += kU * kPW)
          for (int col = lane * 4; col < d; col += 128) {
            const G* from[kU];
            int off[kU];
#pragma unroll
            for (int i = 0; i < kU; ++i) {
              const int row = row0 + i * kPW;
              const int src = row < rows ? s_src[b][row] : -1;
              off[i] = src >= 0 ? row * static_cast<int>(d) + col : -1;
              from[i] = grads + static_cast<int64_t>(src >= 0 ? src : 0) * d + col;
            }
            uint2 v[kU];
#pragma unroll
            for (int i = 0; i < kU; ++i) v[i] = four_bf16(from[i]);
#pragma unroll
            for (int i = 0; i < kU; ++i)
              if (off[i] >= 0) *reinterpret_cast<uint2*>(s_g[b] + off[i]) = v[i];
          }
        const bool last = s_src[b][rows - 1] < 0;
        __threadfence_block();
        bar_arrive(bar_full(b), kThreads);
        if (last) break;
        id = next_id;
        sr = next_sr;
      }
      // the chunks warp 0 empties that no refill waited for: the last kRing
      for (int j = k - kRing + 1 > 0 ? k - kRing + 1 : 0; j <= k; ++j)
        bar_sync(bar_empty(j % kRing), kThreads);
    }
    __syncthreads();  // s_src, s_g and s_sum are free for the next run
  }
}

// ---- the general walk: any D, any alignment (see the header) ---------------------

template <>
struct Vec<float, 1> { using T = float; };
template <>
struct Vec<uint16_t, 1> { using T = uint16_t; };

__device__ __forceinline__ void add_to(float (&g)[1], float v) { g[0] += v; }
__device__ __forceinline__ void add_to(float (&g)[1], uint16_t v) { g[0] += lo16(v); }
__device__ __forceinline__ void add_round(float (&g)[1], float v) {
  g[0] = bf16r(g[0] + bf16r(v));
}
__device__ __forceinline__ void add_round(float (&g)[1], uint16_t v) {
  g[0] = bf16r(g[0] + lo16(v));
}

// Chunks of V columns a lane sums at once: a column slice of 32 V x this.
template <int V>
constexpr int kSliceChunks = V == 1 ? 8 : 4;

// The first column of chunk k of lane l: V columns each, the 32 lanes' chunks
// side by side.
template <int V>
__device__ __forceinline__ int64_t gcol(int64_t k, int lane) {
  return (k * 32 + lane) * V;
}

// V f32 values at p, 16-byte aligned when V = 4.
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
    x[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

// The whole-row figures of a run's sum that an epilogue needs.
struct RowStats {
  float sumsq;   // sum(g^2): lane l over its chunks in order, then the xor tree
  bool nonzero;  // some g != 0
};

template <int V>
__device__ __forceinline__ void stats_add(float& sq, bool& nz, const float (&x)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sq = fmaf(x[i], x[i], sq);
    nz = nz || x[i] != 0.f;
  }
}

__device__ __forceinline__ RowStats stats_reduce(float sq, bool nz) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(kFullWarp, sq, off);
  return RowStats{sq, __any_sync(kFullWarp, nz) != 0};
}

// The stats of a sum row of D f32, read by the whole warp in the order
// sum_run takes them.
template <int V>
__device__ __forceinline__ RowStats row_stats(const float* row, int64_t d) {
  float sq = 0.f;
  bool nz = false;
  for (int64_t col = gcol<V>(0, threadIdx.x & 31); col < d; col += 32 * V) {
    float x[V];
    load_f32<V>(row + col, x);
    stats_add<V>(sq, nz, x);
  }
  return stats_reduce(sq, nz);
}

// The gradient rows of window positions [b, e) (source rows src) added in
// position order by the whole warp, a column slice at a time, each slice
// written as f32 to out ([D]); B16: each add rounded to bf16. Returns the
// row's stats. U rows' loads go out before their adds.
template <typename G, int V, bool B16>
__device__ RowStats sum_run(const Walk& p, const int* src, int b, int e, float* out) {
  using VT = typename Vec<G, V>::T;
  constexpr int KS = kSliceChunks<V>, U = V == 1 ? 4 : 2;
  const int lane = threadIdx.x & 31;
  const G* grads = static_cast<const G*>(p.grads);
  const int64_t d = p.d;
  float sq = 0.f;
  bool nz = false;
  for (int64_t k0 = 0; gcol<V>(k0, 0) < d; k0 += KS) {
    float g[KS][V];
#pragma unroll
    for (int c = 0; c < KS; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) g[c][i] = 0.f;
    for (int k = b; k < e; k += U) {
      VT raw[U][KS];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u < e) {
          const G* row = grads + static_cast<int64_t>(src[k + u]) * d;
#pragma unroll
          for (int c = 0; c < KS; ++c)
            if (gcol<V>(k0 + c, lane) < d)
              raw[u][c] = __ldg(reinterpret_cast<const VT*>(row + gcol<V>(k0 + c, lane)));
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u < e) {
#pragma unroll
          for (int c = 0; c < KS; ++c)
            if (gcol<V>(k0 + c, lane) < d) {
              if constexpr (B16)
                add_round(g[c], raw[u][c]);
              else
                add_to(g[c], raw[u][c]);
            }
        }
    }
#pragma unroll
    for (int c = 0; c < KS; ++c)
      if (gcol<V>(k0 + c, lane) < d) {
        store_f32<V>(out + gcol<V>(k0 + c, lane), g[c]);
        stats_add<V>(sq, nz, g[c]);
      }
  }
  return stats_reduce(sq, nz);
}

// An epilogue E of the general walk gives
//   float* sum_row(int32_t r, float* stash, int64_t d) const;  where run r is summed
//   template <int V> void apply_row(int32_t r, float* row, RowStats st, int64_t d) const;
// apply_row is called by one whole warp for one row r >= 0, its summed
// gradient in `row` (lane l reads the columns of its chunks, which it wrote
// itself in pass 1; pass 2 synchronises its block first); it may write over
// `row`.

// Pass 1 of the general walk: the warp's span; its complete runs one at a
// time (with `split`, every split-th of them).
template <typename G, int V, bool B16, typename E>
__global__ void __launch_bounds__(kThreads) span_runs_general_kernel(const Walk p, const E epi) {
  __shared__ int s_ids[kWarps][kWindow + 1];
  __shared__ int s_src[kWarps][kWindow];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + wib;
  const int64_t w = gw / p.split;
  const int share = gw & (p.split - 1);
  if (w >= p.n_spans) return;  // uniform across the warp
  int* ids = s_ids[wib];
  int* src = s_src[wib];
  const Span sp = read_span(p, w, ids, src);
  const int64_t d = p.d;
  if (B16) {  // a long run is named for pass 2, which sums it whole
    if (share == 0 && lane == 0) p.part_id[2 * w] = sp.long_run ? ids[sp.last] : -1;
  } else if (share == 0) {  // the pieces of long runs: the span's first warp
    if (lane == 0) {
      p.part_id[2 * w] = sp.long_run ? ids[sp.last] : -1;
      p.part_id[2 * w + 1] = sp.later_piece ? ids[0] : -1;
    }
    if (sp.later_piece) {
      const unsigned rest = sp.lo & ~1u;
      sum_run<G, V, false>(p, src, 0, rest ? __ffs(rest) - 1 : kSpan, p.part + (2 * w + 1) * d);
    }
    if (sp.long_run) sum_run<G, V, false>(p, src, sp.last, kWindow, p.part + 2 * w * d);
  }
  unsigned todo = sp.long_run ? sp.starts & ~(1u << sp.last) : sp.starts;
  if (p.split > 1) {  // this warp's runs: set bits i with i % split == share
    unsigned keep = 0;
    int k = 0;
    for (unsigned rest = todo; rest; rest &= rest - 1, ++k)
      if ((k & (p.split - 1)) == share) keep |= rest & (0u - rest);
    todo = keep;
  }
  float* stash = p.stash + gw * d;
  for (unsigned rest = todo; rest; rest &= rest - 1) {
    const int b = __ffs(rest) - 1;
    const uint64_t after = sp.change >> (b + 1);
    const int e = after ? b + __ffsll(static_cast<long long>(after)) : kWindow;
    const int32_t r = ids[b];
    float* row = epi.sum_row(r, stash, d);
    const RowStats st = sum_run<G, V, B16>(p, src, b, e, row);
    epi.template apply_row<V>(r, row, st, d);
  }
}

// Pass 2 of the general walk: each long run of the block's spans in turn,
// the whole block; thread t adds the T pieces in segment order for the
// columns (t + 256 k) V, over the first piece's row; then warp 0 applies
// the epilogue to that row.
template <int V, typename E>
__global__ void __launch_bounds__(kThreads) long_runs_general_kernel(const Walk p, const E epi) {
  __shared__ unsigned s_heads;
  const unsigned heads = block_heads(p, &s_heads);
  if (heads == 0) return;  // uniform across the block
  const int64_t d = p.d;
  for (unsigned rest = heads; rest; rest &= rest - 1) {
    const int64_t w0 = static_cast<int64_t>(blockIdx.x) * 32 + __ffs(rest) - 1;
    const int32_t r = p.part_id[2 * w0];
    int64_t later = 0;  // the later pieces name r in consecutive spans from w0 + 2
    for (;;) {
      const int64_t w = w0 + 2 + later + threadIdx.x;
      const int n = __syncthreads_count(w < p.n_spans && p.part_id[2 * w + 1] == r);
      later += n;
      if (n < kThreads) break;
    }
    const int64_t n_pieces = 1 + later;
    float* row = p.part + 2 * w0 * d;  // piece 0: each thread reads its columns, then writes them
    for (int64_t col = static_cast<int64_t>(threadIdx.x) * V; col < d; col += kThreads * V) {
      float s[V];
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = 0.f;
      int64_t j = 0;
      for (; j + 4 <= n_pieces; j += 4) {
        float x[4][V];
#pragma unroll
        for (int u = 0; u < 4; ++u) load_f32<V>(piece(p, w0, j + u) + col, x[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) s[i] += x[u][i];
      }
      for (; j < n_pieces; ++j) {
        float x[V];
        load_f32<V>(piece(p, w0, j) + col, x);
#pragma unroll
        for (int i = 0; i < V; ++i) s[i] += x[i];
      }
      store_f32<V>(row + col, s);
    }
    __syncthreads();  // the row is whole
    if (threadIdx.x < 32) epi.template apply_row<V>(r, row, row_stats<V>(row, d), d);
  }
}

// Pass 2 of the general walk in the bf16 buffer's mode: each long run of the
// block's spans in turn, the whole block; for each group of columns (thread
// t: (t + 256 c) V for c < kC, from the group's first), the run's positions
// 256 at a time, their source rows staged in shared memory (the run's rows
// are a prefix of each stage: the ids are sorted), and thread t adds its
// columns of each row in position order, rounding to bf16 after every add,
// from 0; the sum goes to the run's part row, then warp 0 applies the
// epilogue to it. The adds are one dependent chain a column, so a thread
// keeps kU rows' loads in flight ahead of them.
template <typename G, int V, typename E>
__global__ void __launch_bounds__(kThreads) long_runs_b16_general_kernel(const Walk p, const E epi) {
  using VT = typename Vec<G, V>::T;
  constexpr int kC = 1, kU = 16;  // chunks a thread holds; rows whose loads go out together
  __shared__ int s_src[kThreads];
  __shared__ unsigned s_heads;
  __shared__ int64_t s_start;
  const unsigned heads = block_heads(p, &s_heads);
  if (heads == 0) return;  // uniform across the block
  const int lane = threadIdx.x & 31;
  const int64_t d = p.d;
  const G* grads = static_cast<const G*>(p.grads);
  for (unsigned rest = heads; rest; rest &= rest - 1) {
    const int64_t w0 = static_cast<int64_t>(blockIdx.x) * 32 + __ffs(rest) - 1;
    const int32_t r = p.part_id[2 * w0];
    if (threadIdx.x < 32) {  // the run starts at its first position in span w0
      const int64_t pos = w0 * kSpan + lane;
      const unsigned in_run = __ballot_sync(kFullWarp, pos < p.m && __ldg(p.ids + pos) == r);
      if (lane == 0) s_start = w0 * kSpan + __ffs(in_run) - 1;
    }
    __syncthreads();
    const int64_t start = s_start;
    float* row = p.part + 2 * w0 * d;  // not used by this mode's pass 1
    for (int64_t c0 = 0; c0 < d; c0 += static_cast<int64_t>(kThreads) * V * kC) {
      int64_t col[kC];
      float acc[kC][V];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        col[c] = c0 + (static_cast<int64_t>(c) * kThreads + threadIdx.x) * V;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[c][i] = 0.f;
      }
      for (int64_t pos0 = start;; pos0 += kThreads) {
        const int64_t pos = pos0 + threadIdx.x;
        const bool in_run = pos < p.m && __ldg(p.ids + pos) == r;
        const int sr = in_run ? (p.perm != nullptr ? __ldg(p.perm + pos) : static_cast<int>(pos)) : 0;
        __syncthreads();  // the stage before is read
        s_src[threadIdx.x] = sr;
        const int n = __syncthreads_count(in_run);
        int j = 0;
        for (; j + kU <= n; j += kU) {
          VT v[kU][kC];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const G* g = grads + static_cast<int64_t>(s_src[j + u]) * d;
#pragma unroll
            for (int c = 0; c < kC; ++c)
              if (col[c] < d) v[u][c] = __ldg(reinterpret_cast<const VT*>(g + col[c]));
          }
#pragma unroll
          for (int u = 0; u < kU; ++u)
#pragma unroll
            for (int c = 0; c < kC; ++c)
              if (col[c] < d) add_round(acc[c], v[u][c]);
        }
        for (; j < n; ++j) {
          const G* g = grads + static_cast<int64_t>(s_src[j]) * d;
#pragma unroll
          for (int c = 0; c < kC; ++c)
            if (col[c] < d) add_round(acc[c], __ldg(reinterpret_cast<const VT*>(g + col[c])));
        }
        if (n < kThreads) break;
      }
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (col[c] < d) store_f32<V>(row + col[c], acc[c]);
    }
    __syncthreads();  // the row is whole
    if (threadIdx.x < 32) epi.template apply_row<V>(r, row, row_stats<V>(row, d), d);
    __syncthreads();  // s_start and s_src are free for the next run
  }
}

// Both passes of the general walk; B16 for the bf16 buffer. Returns a
// cudaError_t code.
template <typename G, int V, bool B16, typename E>
int launch_general(const Walk& p, const E& epi, cudaStream_t s) {
  const unsigned blocks1 = static_cast<unsigned>((p.n_spans * p.split + kWarps - 1) / kWarps);
  span_runs_general_kernel<G, V, B16, E><<<blocks1, kThreads, 0, s>>>(p, epi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks2 = static_cast<unsigned>((p.n_spans + 31) / 32);
  if constexpr (B16)
    long_runs_b16_general_kernel<G, V, E><<<blocks2, kThreads, 0, s>>>(p, epi);
  else
    long_runs_general_kernel<V, E><<<blocks2, kThreads, 0, s>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

// launch_general with the buffer's dtype code (kF32 or kBF16) as the flag.
template <typename G, int V, typename E>
int launch_general(const Walk& p, const E& epi, int buffer_dtype, cudaStream_t s) {
  if constexpr (TakesF32Sums<E>::value)
    if (buffer_dtype == kF32) return launch_general<G, V, false>(p, epi, s);
  if (buffer_dtype == kBF16) return launch_general<G, V, true>(p, epi, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename G, int V, int NC, bool B16, typename E>
int launch_passes(const Walk& p, const E& epi, cudaStream_t s) {
  const unsigned blocks1 = static_cast<unsigned>((p.n_spans * p.split + kWarps - 1) / kWarps);
  span_runs_kernel<G, V, NC, B16, E><<<blocks1, kThreads, 0, s>>>(p, epi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks2 = static_cast<unsigned>((p.n_spans + 31) / 32);
  if constexpr (B16) {
    static bool ring_set = false;  // the ring's shared memory, allowed once an instantiation
    if (!ring_set) {
      const cudaError_t set = cudaFuncSetAttribute(
          long_runs_b16_kernel<G, V, NC, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kRingBytes);
      if (set != cudaSuccess) return static_cast<int>(set);
      ring_set = true;
    }
    long_runs_b16_kernel<G, V, NC, E><<<blocks2, kThreads, kRingBytes, s>>>(p, epi);
  } else
    long_runs_kernel<V, NC, E><<<blocks2, kThreads, 0, s>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

// Both passes at the instantiation for D: NC chunks of 16 lanes x V columns
// cover the row; B16 for the bf16 buffer. Returns a cudaError_t code.
template <typename G, int V, bool B16, typename E>
int launch_walk(const Walk& p, const E& epi, cudaStream_t s) {
  const int64_t nc = (p.d + kLanes * V - 1) / (kLanes * V);
  if (nc <= 1) return launch_passes<G, V, 1, B16>(p, epi, s);
  if (nc <= 2) return launch_passes<G, V, 2, B16>(p, epi, s);
  if (nc <= 4) return launch_passes<G, V, 4, B16>(p, epi, s);
  if constexpr (V == 4) return launch_passes<G, V, 8, B16>(p, epi, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// launch_walk with the buffer's dtype code (kF32 or kBF16) as the flag.
template <typename G, int V, typename E>
int launch_walk(const Walk& p, const E& epi, int buffer_dtype, cudaStream_t s) {
  if constexpr (TakesF32Sums<E>::value)
    if (buffer_dtype == kF32) return launch_walk<G, V, false>(p, epi, s);
  if (buffer_dtype == kBF16) return launch_walk<G, V, true>(p, epi, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// Whether the half-warp walk takes D when the caller's pointers allow its
// loads; every other D takes the general walk.
inline bool half_warp_dim(int64_t d) { return d % 4 == 0 && d <= kMaxD; }

// The walk over M sorted ids, or false when M, D or the scratch (n_slots
// rows of D f32, 16-byte aligned: 2 * n_spans, and for the general walk one
// more a warp of its pass 1, n_spans * split) is outside what the kernels
// take.
inline bool make_walk(const void* ids, const void* grads, const void* perm, void* part,
                      void* part_id, int64_t n_slots, int64_t n_rows, int64_t d, int64_t m,
                      bool general, Walk* p) {
  const int64_t n_spans = (m + kSpan - 1) / kSpan;
  int split = 1;
  while (split < 16 && n_spans * split < 2048) split *= 2;
  const int64_t rows = 2 * n_spans + (general ? n_spans * split : 0);
  if (d <= 0 || (!general && !half_warp_dim(d)) || m > 0x7fffffffLL || n_slots < rows ||
      !aligned(part, 16))
    return false;
  p->ids = static_cast<const int32_t*>(ids);
  p->grads = grads;
  p->perm = static_cast<const int32_t*>(perm);
  p->part = static_cast<float*>(part);
  p->part_id = static_cast<int32_t*>(part_id);
  p->stash = general ? p->part + 2 * n_spans * d : nullptr;
  p->n_rows = n_rows;
  p->d = d;
  p->m = m;
  p->n_spans = n_spans;
  p->split = split;
  return true;
}

}  // namespace sorted_runs
