// The wide path shared by the two pooled gathers, #1 (csrc/pooled_gather.cu:
// f32 and bf16 tables) and #5 (csrc/quantized_gather.cu: int8 rows with a
// per-row scale):
//
//   out[b, :] = sum_l w[b, l] * row(ids[b, l])        (f32 accumulation)
//
// What bounds them: at the train step's 262,144 bags, memory; at serving's 1
// to 8,192 bags, the latency of the chain id load -> row load -> store. The
// design:
//   - a row is cut in 16-byte chunks. A warp takes a run of R consecutive
//     bags, and its lanes take the run's (bag, chunk) items t = lane, lane +
//     32, ...; item t's output lies at out + (b0 * D + t * VEC), so 32 items
//     are one stretch of output;
//   - the walk, R, the block and the grid come from the wrapper's plan
//     (ops/gather_plan.py), one run a warp; `plan_fits` checks the plan
//     against the shape and the pointers;
//   - one slot a bag at one item a lane (`gather_one`, serving sizes): lane
//     t loads the id and weight of its own item's bag, so the warp's id
//     loads are one coalesced load of the run's ids, and nothing stands
//     between them and the row load;
//   - one slot a bag past that (`gather_runs`, the train step's sizes): the
//     run's ids and weights come in one coalesced load, lane s holding bag
//     s's, __shfl_sync hands them to the lanes that load its rows, and a
//     lane has kInFlight row loads out before it uses one;
//   - L slots a bag (`gather_items`): a lane loads its own bag's slot ids
//     (a warp's lanes read one stretch of ids, which the card serves as one
//     request), kInFlight slots at a time, the next group's while this
//     group's rows are in flight;
//   - the int8 scale of a live slot is fetched by the lane that holds the
//     slot as soon as it has the id, and divided (one true division) only
//     once the row loads are out, so it adds no step to the chain;
//   - slots are added in slot order from 0, in the kernel's own rounding
//     (`Rows::add`), so every walk gives the same bits;
//   - where an item's output is wider than 16 bytes (int8 rows; bf16 rows
//     into f32) the warp stages its 32 items in shared memory and writes the stretch back in 16-byte pieces, each store
//     instruction 512 contiguous bytes; else each lane stores its own.
// A slot whose id lies outside [0, N) or whose weight is 0 loads nothing and
// adds nothing. Row offsets are 64-bit.
//
// A `Rows` policy gives: VEC (elements in 16 bytes), `load(id, chunk)` (the
// 16 bytes), `kExtra` with `load_extra(id)` (the raw per-row value beside
// the row) and `extra(raw)` (what `add` takes), and `add(acc, raw, w,
// extra)` (one slot into the accumulators).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace gather {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWindow = 32;  // slots of one id load
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kInFlight = 4;  // row loads a lane issues at once on the walks that have several

// The walks, and the codes ops/gather_plan.py:Walk passes for them: the
// narrow path (one warp a bag, each kernel's own), and the wide path's one
// slot a bag at one item a lane (kOne) or more (kRuns), and L slots a bag
// (kItems).
enum class Walk : int { kNarrow = 0, kOne = 1, kRuns = 2, kItems = 3 };

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// VEC accumulators -> VEC consecutive output elements, in 16-byte stores (8
// bytes for four bf16)
template <int VEC>
__device__ __forceinline__ void store_vec(float* dst, const float (&a)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC / 4; ++j)
    reinterpret_cast<float4*>(dst)[j] =
        make_float4(a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3]);
}
template <int VEC>
__device__ __forceinline__ void store_vec(uint16_t* dst, const float (&a)[VEC]) {
  uint32_t w[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) w[i] = bf16_bits(a[2 * i]) | (bf16_bits(a[2 * i + 1]) << 16);
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC / 8; ++j)
      reinterpret_cast<uint4*>(dst)[j] =
          make_uint4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
  }
}

// A slot as a lane holds it: dead slots carry id -1. `extra` is the raw
// value `Rows::load_extra` fetched (0 without one).
struct Slot {
  int32_t id;
  float w;
  float extra;
};

// Lane s < count of a window: the raw id and weight of slot first + s.
__device__ __forceinline__ void fetch_window(const int32_t* __restrict__ ids,
                                             const float* __restrict__ w, int64_t first,
                                             int count, int lane, int32_t& id, float& wt) {
  id = -1;
  wt = 0.f;
  if (lane < count) {
    id = __ldg(ids + first + lane);
    wt = __ldg(w + first + lane);
  }
}

// The slot a lane holds, from its raw id and weight; for a live slot the
// lane issues the load of its extra, which nothing waits on yet.
template <class Rows>
__device__ __forceinline__ Slot make_slot(const Rows& rows, int32_t id, float wt,
                                          int64_t n_rows) {
  Slot s{-1, 0.f, 0.f};
  if (id >= 0 && id < n_rows && wt != 0.f) {
    s.id = id;
    s.w = wt;
    if constexpr (Rows::kExtra) s.extra = rows.load_extra(id);
  }
  return s;
}

// Slot `src`'s weight and extra (its value, `extra` computed by its owner),
// handed to this lane.
template <class Rows>
__device__ __forceinline__ void hand_out(const Slot& s, float extra, int src, float& wt,
                                         float& slot_extra) {
  wt = __shfl_sync(kFullMask, s.w, src & 31);
  slot_extra = Rows::kExtra ? __shfl_sync(kFullMask, extra, src & 31) : 0.f;
}

// (bag, chunk) of a lane's item t = lane + 32 k, stepped by 32 without a
// division: `stride` is (32 / cpr, 32 % cpr).
struct Item {
  int bag;
  int chunk;
  __device__ __forceinline__ void step(const Item& stride, int cpr) {
    bag += stride.bag;
    chunk += stride.chunk;
    if (chunk >= cpr) {
      chunk -= cpr;
      ++bag;
    }
  }
};

// (t / cpr, t % cpr), by shifts when cpr is a power of two (a division
// would stand before a lane's first load).
__device__ __forceinline__ Item split(int t, int cpr) {
  if ((cpr & (cpr - 1)) == 0) {
    const int shift = __ffs(cpr) - 1;
    return Item{t >> shift, t & (cpr - 1)};
  }
  return Item{t / cpr, t % cpr};
}

// Stores the outputs of 32 consecutive items, one a lane, at `dst` (item
// `lane` at dst + lane * VEC); lanes from `n_valid` on have none. Called by
// the whole warp.
template <int VEC, typename Tout>
__device__ __forceinline__ void store_items(Tout* dst, int n_valid, int lane,
                                            const float (&acc)[VEC]) {
  constexpr int kPieces = VEC * static_cast<int>(sizeof(Tout)) / 16;  // 16-byte pieces an item
  if constexpr (kPieces <= 1) {
    if (lane < n_valid) store_vec<VEC>(dst + lane * VEC, acc);
  } else {
    __shared__ uint4 stage[kMaxWarpsPerBlock][kWindow * kPieces];
    uint4* mine = stage[threadIdx.x >> 5];
    __syncwarp();  // the warp's last reads of its stage are done
    store_vec<VEC>(reinterpret_cast<Tout*>(mine + lane * kPieces), acc);
    __syncwarp();
    uint4* out = reinterpret_cast<uint4*>(dst);
    for (int p = lane; p < n_valid * kPieces; p += kWindow) out[p] = mine[p];
  }
}

// One slot a bag, one item a lane (a run of at most 32 chunks): lane t
// takes item t and loads its bag's id and weight (the warp's loads are one
// coalesced load of the run's ids), then the row; the warp stores its items
// as one stretch (`store_items`).
template <class Rows, typename Tout>
__device__ __forceinline__ void gather_one(const Rows& rows, const int32_t* __restrict__ ids,
                                           const float* __restrict__ w, Tout* __restrict__ out,
                                           int64_t n_rows, int64_t d, int64_t batch,
                                           int64_t run_bags) {
  constexpr int VEC = Rows::VEC;
  const int lane = threadIdx.x & 31;
  const int cpr = static_cast<int>(d / VEC);  // 16-byte chunks a row
  const int64_t b0 = ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * run_bags;
  if (b0 >= batch) return;  // a warp of the last block without a run
  const int items = static_cast<int>(min(run_bags, batch - b0)) * cpr;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (lane < items) {
    const Item it = split(lane, cpr);
    const int32_t id = __ldg(ids + b0 + it.bag);
    const float wt = __ldg(w + b0 + it.bag);
    if (id >= 0 && id < n_rows && wt != 0.f) {
      const float raw_extra = Rows::kExtra ? rows.load_extra(id) : 0.f;
      const uint4 raw = rows.load(id, it.chunk);
      rows.add(acc, raw, wt, rows.extra(raw_extra));
    }
  }
  store_items<VEC>(out + b0 * d, items, lane, acc);
}

// One slot a bag, runs of up to 32 bags: the run's ids and weights come in
// one window, shuffles hand them out, and a lane has kInFlight row loads out
// before it uses one.
template <class Rows, typename Tout>
__device__ __forceinline__ void gather_runs(const Rows& rows, const int32_t* __restrict__ ids,
                                            const float* __restrict__ w, Tout* __restrict__ out,
                                            int64_t n_rows, int64_t d, int64_t batch,
                                            int64_t run_bags) {
  constexpr int VEC = Rows::VEC;
  const int lane = threadIdx.x & 31;
  const int cpr = static_cast<int>(d / VEC);  // 16-byte chunks a row
  const Item stride = split(kWindow, cpr);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t b0 = warp * run_bags;  // the warp's run
  if (b0 >= batch) return;  // a warp of the last block without a run
  const int nb = static_cast<int>(min(run_bags, batch - b0));
  int32_t bag_id;
  float bag_w;
  fetch_window(ids, w, b0, nb, lane, bag_id, bag_w);
  const Slot s = make_slot(rows, bag_id, bag_w, n_rows);
  const int items = nb * cpr;  // (bag, chunk) items of the run
  Tout* run_out = out + b0 * d;  // item t's output at run_out + t * VEC
  Item it = split(lane, cpr);
  for (int t0 = 0; t0 < items; t0 += kWindow * kInFlight) {
    const Item it0 = it;
    uint4 raw[kInFlight];
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int32_t id = __shfl_sync(kFullMask, s.id, it.bag & 31);
      if (t0 + kWindow * j + lane < items && id >= 0) {
        raw[j] = rows.load(id, it.chunk);
        live |= 1u << j;
      }
      it.step(stride, cpr);
    }
    const float extra = rows.extra(s.extra);
    it = it0;
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int first = t0 + kWindow * j;  // the item of lane 0
      float wt, slot_extra;
      hand_out<Rows>(s, extra, it.bag, wt, slot_extra);
      if (first < items) {
        float acc[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
        if (live >> j & 1u) rows.add(acc, raw[j], wt, slot_extra);
        store_items<VEC>(run_out + static_cast<int64_t>(first) * VEC,
                         min(kWindow, items - first), lane, acc);
      }
      it.step(stride, cpr);
    }
  }
}

// Loads slots [l, l + IN_FLIGHT) of the bag whose slots start at `slot0`:
// the raw ids and weights, -1 and 0 past the bag's end or for a lane without
// an item.
template <int IN_FLIGHT>
__device__ __forceinline__ void load_group(const int32_t* __restrict__ ids,
                                           const float* __restrict__ w, int64_t slot0, int64_t l,
                                           int64_t bag_l, bool valid, int32_t (&id)[IN_FLIGHT],
                                           float (&wt)[IN_FLIGHT]) {
#pragma unroll
  for (int j = 0; j < IN_FLIGHT; ++j) {
    id[j] = -1;
    wt[j] = 0.f;
    if (valid && l + j < bag_l) {
      id[j] = __ldg(ids + slot0 + l + j);
      wt[j] = __ldg(w + slot0 + l + j);
    }
  }
}

// L slots a bag: a lane takes its items one at a time and loads its own
// bag's slot ids and weights, IN_FLIGHT slots at a time, the next group's
// while this group's rows are in flight.
template <class Rows, int IN_FLIGHT, typename Tout>
__device__ __forceinline__ void gather_items(const Rows& rows, const int32_t* __restrict__ ids,
                                             const float* __restrict__ w, Tout* __restrict__ out,
                                             int64_t n_rows, int64_t d, int64_t batch,
                                             int64_t bag_l, int64_t run_bags) {
  constexpr int VEC = Rows::VEC;
  const int lane = threadIdx.x & 31;
  const int cpr = static_cast<int>(d / VEC);
  const Item stride = split(kWindow, cpr);
  const int groups = static_cast<int>(max(int64_t{1}, (bag_l + IN_FLIGHT - 1) / IN_FLIGHT));
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t b0 = warp * run_bags;  // the warp's run
  if (b0 >= batch) return;  // a warp of the last block without a run
  const int items = static_cast<int>(min(run_bags, batch - b0)) * cpr;
  Tout* run_out = out + b0 * d;
  // the group loaded next: its item (`first` is the item of lane 0) and first slot
  Item next = split(lane, cpr);
  int next_first = 0;
  int64_t next_l = 0;
  int32_t id[IN_FLIGHT];
  float wt[IN_FLIGHT];
  load_group<IN_FLIGHT>(ids, w, (b0 + next.bag) * bag_l, 0, bag_l, lane < items, id, wt);
  Item at = next;  // the item summed
  int at_first = 0;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  const int n_groups = (items + kWindow - 1) / kWindow * groups;
  for (int g = 0; g < n_groups; ++g) {
    Slot s[IN_FLIGHT];
    uint4 raw[IN_FLIGHT];
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j) {
      s[j] = make_slot(rows, id[j], wt[j], n_rows);
      if (s[j].id >= 0) raw[j] = rows.load(s[j].id, at.chunk);
    }
    next_l += IN_FLIGHT;
    if (next_l >= bag_l) {
      next_l = 0;
      next.step(stride, cpr);
      next_first += kWindow;
    }
    if (g + 1 < n_groups)
      load_group<IN_FLIGHT>(ids, w, (b0 + next.bag) * bag_l, next_l, bag_l,
                            next_first + lane < items, id, wt);
#pragma unroll
    for (int j = 0; j < IN_FLIGHT; ++j)
      if (s[j].id >= 0) rows.add(acc, raw[j], s[j].w, rows.extra(s[j].extra));
    if ((g + 1) % groups == 0) {  // the item's last group
      store_items<VEC>(run_out + static_cast<int64_t>(at_first) * VEC,
                       min(kWindow, items - at_first), lane, acc);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      at = next;
      at_first = next_first;
    }
  }
}

// 256-thread blocks an SM a walk's kernel is compiled to fit (its register
// cap; ops/gather_plan.py reads what each kernel reaches through the
// occupancy calculator, `blocks_per_sm`). kRuns carries the train step's
// sizes, where warps in flight are what count: 4 blocks (64 registers) where
// a lane stores its own items, 3 (85) where the store is staged, whose
// registers 64 would spill. The other walks: 2 (up to 128 registers).
template <Walk WALK, class Rows, typename Tout>
constexpr int kBlocksPerSm =
    WALK != Walk::kRuns ? 2 : (Rows::VEC * sizeof(Tout) > 16 ? 3 : 4);

template <Walk WALK, class Rows, typename Tout>
__device__ __forceinline__ void gather_wide(const Rows& rows, const int32_t* __restrict__ ids,
                                            const float* __restrict__ w, Tout* __restrict__ out,
                                            int64_t n_rows, int64_t d, int64_t batch,
                                            int64_t bag_l, int64_t run_bags) {
  if constexpr (WALK == Walk::kOne) {
    gather_one(rows, ids, w, out, n_rows, d, batch, run_bags);
  } else if constexpr (WALK == Walk::kRuns) {
    gather_runs(rows, ids, w, out, n_rows, d, batch, run_bags);
  } else {
    gather_items<Rows, kInFlight>(rows, ids, w, out, n_rows, d, batch, bag_l, run_bags);
  }
}

// Whether a plan of ops/gather_plan.py fits the shape: a block of 1 to 8
// warps, runs of 1 to 32 bags, one run a warp covering the batch; the
// narrow path one bag a run; the wide walks whole 16-byte chunks (`vec`
// elements) with `table` and `out` 16-byte aligned, kOne and kRuns one slot
// a bag, kOne at most one item a lane, kItems at most 32 slots a run.
inline bool plan_fits(int walk, int64_t batch, int64_t d, int vec, int64_t bag_l,
                      const void* table, const void* out, int64_t run_bags,
                      int warps_per_block, int64_t blocks) {
  if (run_bags < 1 || run_bags > kWindow || warps_per_block < 1 ||
      warps_per_block > kMaxWarpsPerBlock || blocks < 1 || blocks > 0x7fffffff ||
      blocks * warps_per_block * run_bags < batch)
    return false;
  if (walk == static_cast<int>(Walk::kNarrow)) return run_bags == 1;
  if (d % vec != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return false;
  if (walk == static_cast<int>(Walk::kOne)) return bag_l == 1 && run_bags * (d / vec) <= kWindow;
  if (walk == static_cast<int>(Walk::kRuns)) return bag_l == 1;
  if (walk == static_cast<int>(Walk::kItems)) return run_bags == 1 || run_bags * bag_l <= kWindow;
  return false;
}

// The 256-thread blocks of `kernel` an SM holds on the current card, or a
// negative cudaError_t.
template <typename Kernel>
int blocks_per_sm(Kernel kernel) {
  int n = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kMaxWarpsPerBlock * 32, 0);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace gather
