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
// exactly), summed in f32. D % 4 == 0 and D <= 512.
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
// Scratch: part [2 * ceil(M / 32), D] f32 and part_id [2 * ceil(M / 32)]
// int32, allocated by the caller on its stream; nothing carries over between
// calls. Both passes go to the caller's stream and allocate nothing.

#pragma once

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

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// The sorted ids, their gradients and the scratch of long runs.
struct Walk {
  const int32_t* ids;
  const void* grads;
  const int32_t* perm;  // or null
  float* part;          // [2 * n_spans, d] f32: pieces of long runs
  int32_t* part_id;     // [2 * n_spans]: each piece's row, or -1
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
template <typename G, int V, int NC>
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
          if (col_of<V>(c, hl) < d) add_to(g[c], raw[u][c]);
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

// Pass 1: each warp's span of sorted positions (see the header).
template <typename G, int V, int NC, typename E>
__global__ void __launch_bounds__(kThreads) span_runs_kernel(const Walk p, const E epi) {
  __shared__ int s_ids[kWarps][kWindow + 1];  // ids of window positions 0 .. 64
  __shared__ int s_src[kWarps][kWindow];      // their gradient rows
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kWarps + wib;
  const int64_t w = gw / p.split;      // the span
  const int share = gw & (p.split - 1);  // the pairs of complete runs this warp takes
  if (w >= p.n_spans) return;  // uniform across the warp
  const int64_t s0 = w * kSpan;
  int* ids = s_ids[wib];
  int* src = s_src[wib];
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
  if (share == 0) {  // the pieces of long runs: the span's first warp
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
    sum_rows<G, V, NC>(p, src, b, e, hl, g);
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

// Pass 2: the long runs whose first piece lies in the block's 32 spans.
template <int V, int NC, typename E>
__global__ void __launch_bounds__(kThreads) long_runs_kernel(const Walk p, const E epi) {
  constexpr int NC4 = (NC * kLanes * V + 127) / 128;  // float4 chunks of 32 lanes a row
  __shared__ __align__(16) float s_sum[kWarps][kMaxD];
  __shared__ unsigned s_heads, s_big[kWarps];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int64_t w_base = static_cast<int64_t>(blockIdx.x) * 32;
  if (wib == 0) {
    const int64_t w = w_base + lane;
    const unsigned heads = __ballot_sync(kFullWarp, w < p.n_spans && p.part_id[2 * w] >= 0);
    if (lane == 0) s_heads = heads;
  }
  __syncthreads();
  const unsigned heads = s_heads;
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

template <typename G, int V, int NC, typename E>
int launch_passes(const Walk& p, const E& epi, cudaStream_t s) {
  const unsigned blocks1 = static_cast<unsigned>((p.n_spans * p.split + kWarps - 1) / kWarps);
  span_runs_kernel<G, V, NC, E><<<blocks1, kThreads, 0, s>>>(p, epi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks2 = static_cast<unsigned>((p.n_spans + 31) / 32);
  long_runs_kernel<V, NC, E><<<blocks2, kThreads, 0, s>>>(p, epi);
  return static_cast<int>(cudaGetLastError());
}

// Both passes at the instantiation for D: NC chunks of 16 lanes x V columns
// cover the row. Returns a cudaError_t code.
template <typename G, int V, typename E>
int launch_walk(const Walk& p, const E& epi, cudaStream_t s) {
  const int64_t nc = (p.d + kLanes * V - 1) / (kLanes * V);
  if (nc <= 1) return launch_passes<G, V, 1>(p, epi, s);
  if (nc <= 2) return launch_passes<G, V, 2>(p, epi, s);
  if (nc <= 4) return launch_passes<G, V, 4>(p, epi, s);
  if constexpr (V == 4) return launch_passes<G, V, 8>(p, epi, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// The walk over M sorted ids, or false when M, D or the scratch (n_slots
// rows of D f32, 16-byte aligned) is outside what the kernels take.
inline bool make_walk(const void* ids, const void* grads, const void* perm, void* part,
                      void* part_id, int64_t n_slots, int64_t n_rows, int64_t d, int64_t m,
                      Walk* p) {
  const int64_t n_spans = (m + kSpan - 1) / kSpan;
  if (d <= 0 || d % 4 != 0 || d > kMaxD || m > 0x7fffffffLL || n_slots < 2 * n_spans ||
      !aligned(part, 16))
    return false;
  p->ids = static_cast<const int32_t*>(ids);
  p->grads = grads;
  p->perm = static_cast<const int32_t*>(perm);
  p->part = static_cast<float*>(part);
  p->part_id = static_cast<int32_t*>(part_id);
  p->n_rows = n_rows;
  p->d = d;
  p->m = m;
  p->n_spans = n_spans;
  p->split = 1;
  while (p->split < 16 && n_spans * p->split < 2048) p->split *= 2;
  return true;
}

}  // namespace sorted_runs
