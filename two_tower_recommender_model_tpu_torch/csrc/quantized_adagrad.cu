// Fused row-wise Adagrad on int8 rows over sorted ids, for Hopper (sm_90a):
//
//   for each distinct live id r in ids whose summed gradient g_r is not all 0:
//     g_r        = sum of grads[src(j)] over j with ids[j] == r      (f32)
//     row        = float(values[r]) * (scales[r] / 127)
//     acc[r]    += mean(g_r * g_r)
//     row       -= lr * g_r / (sqrt(acc[r]) + eps)
//     scales[r]  = max |row|
//     values[r]  = clip(round(row / (scales[r] > 0 ? scales[r] : 1) * 127), -127, 127)
//
// in place on values, scales and acc; src(j) = perm[j] when a permutation is
// given, else j.
//
// Replaces the Pallas TPU kernel `_fused_update_kernel_quantized` /
// `block_sorted_rowwise_adagrad_fused_quantized` in
// two_tower_recommender_model_tpu/ops/block_sorted.py (kernel #6), whose
// one-hot MXU aggregation, block work plan and lane/sublane transposes were
// means for the TPU and are not carried over.
//
// Contract:
//   - ids [M] int32 NON-DECREASING, M < 2^31; ids outside [0, N) are
//     sentinels (dead slots), never read and never written; unsorted ids
//     would give two owners one row, and they would race;
//   - grads [*, D] f32 or bf16, summed in f32; perm [M] int32 or null;
//   - values: [N, D] int8, scales: [N] f32 (the row's absmax), acc: [N] f32;
//   - D % 4 == 0 and D <= 512; values 4-byte aligned, f32 gradients 16-byte
//     and bf16 gradients 8-byte aligned (the wrapper checks);
//   - part [2 * ceil(M / 32), D] f32 and part_id [2 * ceil(M / 32)] int32:
//     scratch that the wrapper allocates on the caller's stream (nothing
//     carries over between calls);
//   - a row that no live id names, or whose summed gradient is exactly zero
//     in every column, keeps its exact bytes, scale and accumulator:
//     requantizing is not idempotent, so such a row is not written at all;
//   - the rounding: the division by 127 (and by the new scale) is a true
//     division and the product a separate multiply, as the plain version
//     computes them; round-half-to-even (rintf), then the clamp.
//
// What bounds it: memory, almost all of it the gradients (256 B a bf16 id at
// D = 128 against 128 B read and 128 B written a touched row, plus its scale
// and accumulator: 107 MB at the flagship's 262,144 ids, 0.032 ms at 3.35
// TB/s). So the design keeps many independent rows in flight and launches no
// thread that has nothing to do. No atomics: every sum has one fixed order.
//
// Pass 1 (adagrad_runs_kernel): warp w takes the 32 sorted positions of its
// span [32 w, 32 w + 32) and reads their ids, the next 32 and one more (and
// their source rows) in coalesced loads into shared memory. One ballot marks
// where the id changes, another the live ids; the runs that START in the
// span are the warp's. A run may reach into the next span: the warp sums it
// to its end if that lies within the 64 positions it read, and the run is
// then complete. A half-warp (16 lanes, 16-byte loads: a D = 128 bf16 row a
// load) owns a complete run: it reads the row's int8 values, scale and
// accumulator as soon as the id is known, with the run's first gradient rows
// (the ballot gave the run's end, so no load waits on an id compare), sums
// them in position order, and applies the update with 16-lane reductions for
// mean(g^2) and the new absmax; each lane packs its int8 into one 4- or
// 8-byte store. The two half-warps take the complete runs two at a time, in
// step (the warp stays converged). mean(g^2) is summed in the order of a walk
// of one warp a row, four columns a lane (sorted_runs.cuh, kernel #4's), the
// order this kernel had as such a walk: a complete run gets the same bits.
// Each value takes two IEEE divisions (__fdiv_rn), a large share of the
// instructions.
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
// Pass 2 (finish_long_runs_kernel): block b reads the first-piece slots of
// spans [32 b, 32 b + 32); for each long run found it counts the run's later
// pieces (the consecutive slots 2 (w0 + j) + 1, j >= 2, that name it) and
// adds the T = 1 + count pieces in segment order: one warp adds them in
// order when T <= 64; for a longer run the block's 8 warps each add a
// contiguous eighth in order and the eighths are added in order. Then one
// half-warp applies the update. A hot id of 23,000 rows is so summed by 720
// warps at once and 8 more, not by one warp in 23,000 steps.
//
// Binding: a plain C interface loaded with ctypes. Both passes go to the
// caller's stream, do not synchronise and allocate nothing; the entry point
// returns cudaGetLastError() right after them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSpan = 32;            // sorted positions per warp: one id a lane
constexpr int kWindow = 2 * kSpan;   // positions a warp sums at most: its span and the next
constexpr int kWarps = 8;            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kLanes = 16;           // lanes that hold one row: a half-warp
constexpr int kMaxD = 512;
constexpr int kWarpRows = 64;        // pass 2: a run of at most this many pieces is one warp's
constexpr unsigned kFullWarp = 0xffffffffu;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

struct Params {
  int8_t* values;
  float* scales;
  float* acc;
  const int32_t* ids;
  const void* grads;
  const int32_t* perm;
  float* part;       // [2 * n_spans, d] f32: pieces of long runs
  int32_t* part_id;  // [2 * n_spans]: each piece's row, or -1
  int64_t n_rows, d, m, n_spans;
  float lr, eps;
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

// A lane's V int8 values of a row as one load.
template <int V>
struct Bytes;
template <>
struct Bytes<4> { using T = uint32_t; };
template <>
struct Bytes<8> { using T = uint2; };

// byte i of little-endian words, as a signed int8 widened to f32
__device__ __forceinline__ float int8_at(uint32_t w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xffu));
}
__device__ __forceinline__ float int8_at(uint2 w, int i) {
  return i < 4 ? int8_at(w.x, i) : int8_at(w.y, i - 4);
}

__device__ __forceinline__ uint32_t quantize(float x, float denom) {
  const float q = rintf(__fmul_rn(__fdiv_rn(x, denom), 127.f));
  const int v = static_cast<int>(fminf(fmaxf(q, -127.f), 127.f));
  return static_cast<uint32_t>(v) & 0xffu;
}
__device__ __forceinline__ uint32_t pack4(const float* x, float denom) {
  return quantize(x[0], denom) | (quantize(x[1], denom) << 8) | (quantize(x[2], denom) << 16) |
         (quantize(x[3], denom) << 24);
}
__device__ __forceinline__ void store_bytes(int8_t* p, const float (&x)[4], float denom) {
  *reinterpret_cast<uint32_t*>(p) = pack4(x, denom);
}
__device__ __forceinline__ void store_bytes(int8_t* p, const float (&x)[8], float denom) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack4(x, denom), pack4(x + 4, denom));
}

// The first column of chunk c of lane hl of a 16-lane row: V columns each,
// the 16 lanes' chunks side by side.
template <int V>
__device__ __forceinline__ int64_t col_of(int c, int hl) {
  return static_cast<int64_t>(c * kLanes + hl) * V;
}

// The table row r as this lane's chunks of int8 values, its scale and its
// accumulator.
template <int V, int NC>
struct TableRow {
  typename Bytes<V>::T q[NC];
  float scale, acc;
};

template <int V, int NC>
__device__ __forceinline__ TableRow<V, NC> load_row(const Params& p, int32_t r, int hl) {
  TableRow<V, NC> t = {};
  if (r < 0) return t;  // a half-warp without a row
  const int8_t* vrow = p.values + static_cast<int64_t>(r) * p.d;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (col_of<V>(c, hl) < p.d)
      t.q[c] = *reinterpret_cast<const typename Bytes<V>::T*>(vrow + col_of<V>(c, hl));
  t.scale = p.scales[r];
  t.acc = p.acc[r];
  return t;
}

// The update of row r from its summed gradient g (this lane's chunks of its
// half-warp) and the row as it was. Called by the whole warp, each half-warp
// with its own row; r < 0 for a half-warp without one. A sum that is zero in
// every column writes nothing.
template <int V, int NC>
__device__ __forceinline__ void update_row(const Params& p, int32_t r, float (&g)[NC][V],
                                           const TableRow<V, NC>& t) {
  const int64_t d = p.d;
  const int hl = threadIdx.x & 15, half = (threadIdx.x >> 4) & 1;
  // sum(g^2) in a fixed order: that of a warp whose lane l holds the four
  // columns 4 (l + 32 c) of each 128-column chunk c, sums their squares in
  // chunk order and is reduced by shfl_xor 16, 8, 4, 2, 1 (the order of the
  // f32 kernel #4's walk, sorted_runs.cuh). Such a lane's sum is sq[0] or
  // sq[1] of one of this group's lanes.
  bool nonzero = false;
  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (col_of<V>(c, hl) < d) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        nonzero = nonzero || g[c][i] != 0.f;
        float& part = sq[V == 8 ? i / 4 : c & 1];
        part = fmaf(g[c][i], g[c][i], part);
      }
    }
  // an all-zero sum: the row keeps its bytes (every lane takes part in the ballot)
  const unsigned any = (__ballot_sync(kFullWarp, nonzero) >> (kLanes * half)) & 0xffffu;
  const bool write = r >= 0 && any != 0;
  float sum;  // the xor offsets below 16 keep each reduction inside its half-warp
  if (V == 8) {  // sq[0], sq[1]: the four-column lanes 2 hl and 2 hl + 1
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      sq[0] += __shfl_xor_sync(kFullWarp, sq[0], off);
      sq[1] += __shfl_xor_sync(kFullWarp, sq[1], off);
    }
    sum = sq[0] + sq[1];
  } else {  // sq[0], sq[1]: the four-column lanes hl and hl + 16
    sum = sq[0] + sq[1];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kFullWarp, sum, off);
  }
  const float new_acc = t.acc + sum / static_cast<float>(d);
  const float denom = sqrtf(new_acc) + p.eps;
  const float mult = __fdiv_rn(t.scale, 127.f);

  // the new row, in g's registers
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (col_of<V>(c, hl) < d) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float row = __fmul_rn(int8_at(t.q[c], i), mult);
        const float step = __fdiv_rn(__fmul_rn(p.lr, g[c][i]), denom);
        g[c][i] = __fsub_rn(row, step);
        amax = fmaxf(amax, fabsf(g[c][i]));
      }
    }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFullWarp, amax, off));
  if (!write) return;
  const float qdenom = amax > 0.f ? amax : 1.f;
  int8_t* vrow = p.values + static_cast<int64_t>(r) * d;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    if (col_of<V>(c, hl) < d) store_bytes(vrow + col_of<V>(c, hl), g[c], qdenom);
  if (hl == 0) {
    p.scales[r] = amax;
    p.acc[r] = new_acc;
  }
}

// g = the gradient rows of window positions [b, e) added in position order
// (src: their source rows), this lane's chunks: groups of U rows whose loads
// are all issued before the first add, so a short run is one round trip.
template <typename G, int V, int NC>
__device__ __forceinline__ void sum_rows(const Params& p, const int* src, int b, int e, int hl,
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
__device__ __forceinline__ void store_piece(const Params& p, const int* src, int b, int e,
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
template <typename G, int V, int NC>
__global__ void __launch_bounds__(kThreads) adagrad_runs_kernel(const Params p) {
  __shared__ int s_ids[kWarps][kWindow + 1];  // ids of window positions 0 .. 64
  __shared__ int s_src[kWarps][kWindow];      // their gradient rows
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31, half = lane >> 4, hl = lane & 15;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps + wib;
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
  if (lane == 0) {
    if (!long_run) p.part_id[2 * w] = -1;
    if (!later_piece) p.part_id[2 * w + 1] = -1;
  }
  if (later_piece) {  // positions [0, the first change) of a long run that started earlier
    const unsigned rest = lo & ~1u;
    store_piece<G, V, NC>(p, src, 0, rest ? __ffs(rest) - 1 : kSpan, 2 * w + 1, ids[0]);
  }
  if (long_run) store_piece<G, V, NC>(p, src, last, kWindow, 2 * w, ids[last]);

  // the complete runs, two at a time: the lowest to half-warp 0, the next to 1
  for (unsigned rest = long_run ? starts & ~(1u << last) : starts; rest;) {
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
    const TableRow<V, NC> t = load_row<V, NC>(p, r, hl);
    float g[NC][V];
    sum_rows<G, V, NC>(p, src, b, e, hl, g);
    update_row<V, NC>(p, r, g, t);
  }
}

// Piece j of the long run whose first piece is slot 2 w0: j = 0 that one,
// then the later pieces of spans w0 + 2, w0 + 3, ...
__device__ __forceinline__ const float* piece(const Params& p, int64_t w0, int64_t j) {
  return p.part + (j == 0 ? 2 * w0 : 2 * (w0 + 1 + j) + 1) * p.d;
}

// Pieces [j0, j1) added in order by one warp into out (shared memory, [d]):
// lane l holds the float4 at columns 4 (l + 32 c); U rows in flight.
template <int NC4>
__device__ __forceinline__ void add_pieces(const Params& p, int64_t w0, int64_t j0, int64_t j1,
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
template <int V, int NC>
__global__ void __launch_bounds__(kThreads) finish_long_runs_kernel(const Params p) {
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
    {  // half-warp 0 updates the row
      const int32_t mine = half == 0 ? r : -1;
      const TableRow<V, NC> t = load_row<V, NC>(p, mine, hl);
      float g[NC][V];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i)
          g[c][i] = col_of<V>(c, hl) < p.d ? s_sum[wib][col_of<V>(c, hl) + i] : 0.f;
      update_row<V, NC>(p, mine, g, t);
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
    if (wib == 0) {  // half-warp 0 of warp 0 updates the row
      const int32_t mine = half == 0 ? r : -1;
      const TableRow<V, NC> t = load_row<V, NC>(p, mine, hl);
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
      update_row<V, NC>(p, mine, g, t);
    }
    __syncthreads();  // s_sum is free for the next run
  }
}

template <typename G, int V, int NC>
int launch_passes(const Params& p, cudaStream_t s) {
  const unsigned blocks1 = static_cast<unsigned>((p.n_spans + kWarps - 1) / kWarps);
  adagrad_runs_kernel<G, V, NC><<<blocks1, kThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks2 = static_cast<unsigned>((p.n_spans + 31) / 32);
  finish_long_runs_kernel<V, NC><<<blocks2, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for D: NC chunks of 16 lanes x V columns cover the row.
template <typename G, int V>
int launch_for_dim(const Params& p, cudaStream_t s) {
  const int64_t nc = (p.d + kLanes * V - 1) / (kLanes * V);
  if (nc <= 1) return launch_passes<G, V, 1>(p, s);
  if (nc <= 2) return launch_passes<G, V, 2>(p, s);
  if (nc <= 4) return launch_passes<G, V, 4>(p, s);
  if constexpr (V == 4) return launch_passes<G, V, 8>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned(const void* p, uintptr_t bytes) { return (reinterpret_cast<uintptr_t>(p) % bytes) == 0; }

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch. n_slots is the length
// of part_id (part holds n_slots rows of D): at least 2 * ceil(M / 32).
int ttrm_quantized_adagrad(void* values, void* scales, void* acc, const void* ids,
                           const void* grads, int grad_dtype, const void* perm, void* part,
                           void* part_id, int64_t n_slots, int64_t n_rows, int64_t d, int64_t m,
                           float lr, float eps, void* stream) {
  if (m <= 0 || n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int64_t n_spans = (m + kSpan - 1) / kSpan;
  if (d <= 0 || d % 4 != 0 || d > kMaxD || m > 0x7fffffffLL || n_slots < 2 * n_spans ||
      !aligned(values, 4) || !aligned(part, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.values = static_cast<int8_t*>(values);
  p.scales = static_cast<float*>(scales);
  p.acc = static_cast<float*>(acc);
  p.ids = static_cast<const int32_t*>(ids);
  p.grads = grads;
  p.perm = static_cast<const int32_t*>(perm);
  p.part = static_cast<float*>(part);
  p.part_id = static_cast<int32_t*>(part_id);
  p.n_rows = n_rows;
  p.d = d;
  p.m = m;
  p.n_spans = n_spans;
  p.lr = lr;
  p.eps = eps;
  const auto s = static_cast<cudaStream_t>(stream);
  if (grad_dtype == kF32) {
    if (!aligned(grads, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
    return launch_for_dim<float, 4>(p, s);
  }
  if (grad_dtype == kBF16) {
    if (!aligned(grads, 8)) return static_cast<int>(cudaErrorMisalignedAddress);
    // 16-byte loads (and 8-byte int8 chunks) where the rows' alignment allows them
    if (d % 8 == 0 && aligned(grads, 16) && aligned(values, 8))
      return launch_for_dim<uint16_t, 8>(p, s);
    return launch_for_dim<uint16_t, 4>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
