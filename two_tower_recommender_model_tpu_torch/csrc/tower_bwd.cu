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
// aligned); W1 [128, 128], b1 [128], W2 [128, H2] f32 (rounded to bf16 on
// load); B a multiple of the tile (64 rows for bf16 io, 32 for f32 io); the
// weight gradients are f32.
//
// What bounds it: at B = 262,144, H2 = 64 the five products (the layer-1
// recompute and four gradients) are 2 * 128 * (3 * 128 + 2 * H2) FLOPs a row,
// 34.4 GFLOP, against 201 MB of bf16 traffic: 0.035 ms at the tensor cores'
// 989 TFLOP/s, 0.060 ms at 3.35 TB/s. Both are far below what the CUDA cores
// could do (0.51 ms at their f32 peak), so every product runs on the tensor
// cores, and the tile's activations never leave the SM.
//   - Products: mma.sync.m16n8k16 (bf16 x bf16 -> f32) through inline PTX
//     (mma_sm90.cuh), fragments from shared memory with ldmatrix; the transposed operands
//     (W^T in dh1 and dx, x^T and h1^T in dW1 and dW2) come from the same
//     buffers through ldmatrix.trans, so nothing is transposed in memory.
//   - Shared memory holds bf16 operands: W1 and W2 once per block, the
//     tile's x, bf16(d2), relu(pre1) and bf16(d1). Rows are padded by 8
//     elements (272 bytes for a 128-wide row), so the 8 row addresses of an
//     ldmatrix fall on 8 different 16-byte bank groups. H2 is zero-padded to
//     H2P = 32, 64 or 128 (a template parameter) in shared memory only:
//     zeros add exact zeros to every sum.
//   - A persistent grid: one block of 8 warps per SM walks the tiles
//     (64 rows for bf16 io, 32 for f32 io, so the staged tile bytes are the
//     same). cp.async loads the next tile's x, dq and out into the other of
//     two stages while the current tile's products run; bf16 x is an mma
//     operand as it lands, f32 x is rounded into a bf16 tile first.
//   - The layer-1 ReLU decisions are an f32 GEMM's. The tensor cores sum in
//     another order than an f32 GEMM (cuBLAS's, or the CPU's, which sum in k
//     order), and where a pre-activation's f32 sum lies on a bf16 rounding
//     midpoint against -b1 the two orders decide the ReLU differently: about
//     once in 3e7 values, but each such decision moves a whole row of dx by a
//     tenth of its largest value. `relu_tie` marks the sums within reach of
//     such a flip (a few values a tile) in a bit mask, and
//     after the tile's decisions `ordered_dot` recomputes just those in k
//     order on the CUDA cores (128 fmaf), so the kernel decides as the plain
//     version and the host do.
//   - The [T, 128] products (pre1, dh1, dx) split the tile over the warps as
//     2 x 4 blocks of T/2 x 32. pre1 and dh1 land in the same fragment
//     positions, so the layer-1 mask is kept as one bit per value in a
//     register and never goes through memory; d1's unrounded f32 values feed
//     db1 from the same registers. dx is stored from the fragments.
//   - Weight gradients stay in registers across all the tiles a block
//     visits: dW1 [128, 128] as 4 x 2 warp blocks of 32 x 64 (64 floats a
//     thread), dW2 [128, H2P] as 32 x H2P/2 (16-64 floats). db1 and db2 are
//     per-thread running sums over fixed rows and columns, reduced at the end
//     by shuffles and shared memory in a fixed order.
//   - Blocks cannot carry a sum across the grid the way the TPU's sequential
//     grid did, so each block writes its partial gradients to `partials` and
//     a second kernel sums them in block order: no atomics, and two launches
//     on the same inputs agree bit for bit.
//
// Binding: a plain C interface loaded with ctypes. Both launches go to the
// caller's stream, do not synchronise and allocate nothing (the wrapper
// passes the partials buffer); the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

using bf16 = __nv_bfloat16;

constexpr int kD = 128;          // D_in == H1 == 128
constexpr int kThreads = 256;    // 8 warps
constexpr int kLd = kD + 8;      // bf16 row stride of a 128-wide tile in shared memory
constexpr int kMaxSmem = 232448;

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

// Shared-memory layout (byte offsets) of one instantiation.
template <typename IO, int H2P>
struct Layout {
  static constexpr int T = sizeof(IO) == 2 ? 64 : 32;  // rows per tile
  static constexpr int LD2 = H2P + 8;                  // bf16 row stride of an H2P-wide tile
  static constexpr bool kXDirect = sizeof(IO) == 2;    // staged bf16 x is the mma operand
  static constexpr int kXStageLd = kXDirect ? kLd : kD;
  static constexpr size_t w1 = 0;                                     // [128][kLd] bf16
  static constexpr size_t w2 = w1 + size_t(kD) * kLd * 2;            // [128][LD2] bf16
  static constexpr size_t xst_bytes = size_t(T) * kXStageLd * sizeof(IO);
  static constexpr size_t xst = w2 + size_t(kD) * LD2 * 2;           // 2 stages of x
  static constexpr size_t vst_bytes = size_t(T) * H2P * sizeof(IO);  // flat [T * h2] dq or out
  static constexpr size_t dqst = xst + 2 * xst_bytes;                // 2 stages
  static constexpr size_t outst = dqst + 2 * vst_bytes;              // 2 stages
  static constexpr size_t xs = outst + 2 * vst_bytes;                // [T][kLd] bf16 (f32 io)
  static constexpr size_t h1 = xs + (kXDirect ? 0 : size_t(T) * kLd * 2);  // [T][kLd]
  static constexpr size_t d1 = h1 + size_t(T) * kLd * 2;                   // [T][kLd]
  static constexpr size_t d2 = d1 + size_t(T) * kLd * 2;                   // [T][LD2]
  static constexpr size_t bytes = d2 + size_t(T) * LD2 * 2;
  static_assert(bytes <= kMaxSmem, "shared memory");
  static_assert(size_t(T) * LD2 * 2 >= 512 * sizeof(float), "the epilogue's scratch");
};

__device__ __forceinline__ float bf(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Whether the ReLU decision bf16(bf16(a) + b) > 0 of the f32 sum a could go
// the other way under another f32 summation order: a lies within 1/16 of a
// bf16 ulp (0x1000 in its low 16 bits) of the midpoint between its two bf16
// neighbours, while two orders differ by a few f32 ulps, and rounding to
// either neighbour decides differently. Integer and compare work only: it
// runs on every pre-activation.
__device__ __forceinline__ bool relu_tie(float a, float b) {
  const uint32_t u = __float_as_uint(a);
  const int off_mid = static_cast<int>(u & 0xffffu) - 0x8000;
  const float lo = __uint_as_float(u & 0xffff0000u);             // neighbour toward zero
  const float hi = __uint_as_float((u & 0xffff0000u) + 0x10000u);  // and away from zero
  return abs(off_mid) <= 0x1000 && ((lo + b > 0.f) != (hi + b > 0.f));
}

// x_row . W1[:, c] as an f32 GEMM sums it, one fmaf per k in k order
__device__ float ordered_dot(const bf16* x_row, const bf16* w1s, int c) {
  float s = 0.f;
#pragma unroll 16
  for (int k = 0; k < kD; ++k)
    s = fmaf(__bfloat162float(x_row[k]), __bfloat162float(w1s[k * kLd + c]), s);
  return s;
}

// One warp: acc[MT][NT] (16 x 8 blocks from row m0, column n0) += A [.., K] @ B [K, ..].
// A_KM: A is stored transposed, S[k][m] (ldmatrix.trans), else S[m][k].
// B_KN: B is stored as S[k][n] (ldmatrix.trans), else as S[n][k].
// Fragment of acc[mi][ni]: values 0, 1 at row g, columns 2t, 2t + 1; values
// 2, 3 at row g + 8 (g = lane / 4, t = lane % 4).
template <int MT, int NT, bool A_KM, bool B_KN, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const bf16* a, int lda,
                                         const bf16* b, int ldb, int m0, int n0, int lane) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "shapes");
  const int r8 = lane & 7, q = lane >> 3;  // ldmatrix: row within a matrix, matrix
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const int m = m0 + mi * 16;
      if constexpr (A_KM)  // matrices (k0, m), (k0, m + 8), (k0 + 8, m), (k0 + 8, m + 8)
        ldsm_x4_trans(af[mi], a + (k0 + r8 + (q >> 1) * 8) * lda + m + (q & 1) * 8);
      else       // matrices (m, k0), (m + 8, k0), (m, k0 + 8), (m + 8, k0 + 8)
        ldsm_x4(af[mi], a + (m + r8 + (q & 1) * 8) * lda + k0 + (q >> 1) * 8);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ni += 2) {
      const int n = n0 + ni * 8;
      uint32_t bfr[4];  // b0, b1 of column block n, then of n + 8
      if constexpr (B_KN)  // matrices (k0, n), (k0 + 8, n), (k0, n + 8), (k0 + 8, n + 8)
        ldsm_x4_trans(bfr, b + (k0 + r8 + (q & 1) * 8) * ldb + n + (q >> 1) * 8);
      else       // matrices (n, k0), (n, k0 + 8), (n + 8, k0), (n + 8, k0 + 8)
        ldsm_x4(bfr, b + (n + r8 + (q >> 1) * 8) * ldb + k0 + (q & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][ni], af[mi], bfr[0], bfr[1]);
        mma_bf16(acc[mi][ni + 1], af[mi], bfr[2], bfr[3]);
      }
    }
  }
}

template <typename IO, int H2P>
__global__ void __launch_bounds__(kThreads, 1)
tower_bwd_kernel(const IO* __restrict__ x, const IO* __restrict__ dq, const IO* __restrict__ out,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, IO* __restrict__ dx, float* __restrict__ partials,
                 int64_t n_tiles, int h2) {
  using L = Layout<IO, H2P>;
  constexpr int T = L::T;
  constexpr int LD2 = L::LD2;
  constexpr int PMT = T / 32;      // 16-row blocks a warp owns in a [T, 128] product
  constexpr int NT2 = H2P / 16;    // 8-column blocks a warp owns in dW2
  extern __shared__ __align__(16) char smem[];
  bf16* w1s = reinterpret_cast<bf16*>(smem + L::w1);  // w1s[i * kLd + j] = W1[i][j]
  bf16* w2s = reinterpret_cast<bf16*>(smem + L::w2);  // w2s[j * LD2 + k] = W2[j][k], 0 past h2
  bf16* h1s = reinterpret_cast<bf16*>(smem + L::h1);
  bf16* d1s = reinterpret_cast<bf16*>(smem + L::d1);
  bf16* d2s = reinterpret_cast<bf16*>(smem + L::d2);
  bf16* xs = reinterpret_cast<bf16*>(smem + L::xs);   // f32 io: the tile's x rounded to bf16

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int pm0 = (warp >> 2) * (T / 2), pn0 = (warp & 3) * 32;  // [T, 128] products
  const int gm0 = (warp >> 1) * 32;                                // weight gradients
  const int gn1 = (warp & 1) * 64, gn2 = (warp & 1) * (H2P / 2);

  auto load_tile = [&](int64_t tile, int stage) {
    const int64_t row0 = tile * T;
    constexpr int kChunks = kD * int(sizeof(IO)) / 16;  // 16-byte chunks of an x row
    const char* xg = reinterpret_cast<const char*>(x + row0 * kD);
    char* xd = smem + L::xst + stage * L::xst_bytes;
    for (int e = tid; e < T * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      cp_async16(xd + r * L::kXStageLd * int(sizeof(IO)) + c * 16,
                 xg + r * kD * int(sizeof(IO)) + c * 16);
    }
    // dq and out of the tile are one flat run of T * h2 values each (T * h2 *
    // sizeof(IO) is a multiple of 128 bytes)
    const int chunks = T * h2 * int(sizeof(IO)) / 16;
    const char* dqg = reinterpret_cast<const char*>(dq + row0 * h2);
    const char* og = reinterpret_cast<const char*>(out + row0 * h2);
    char* dqd = smem + L::dqst + stage * L::vst_bytes;
    char* od = smem + L::outst + stage * L::vst_bytes;
    for (int e = tid; e < chunks; e += kThreads) {
      cp_async16(dqd + e * 16, dqg + e * 16);
      cp_async16(od + e * 16, og + e * 16);
    }
  };

  int64_t tile = blockIdx.x;
  if (tile < n_tiles) load_tile(tile, 0);
  cp_async_commit();

  for (int e = tid; e < kD * kD; e += kThreads)
    w1s[(e / kD) * kLd + e % kD] = __float2bfloat16_rn(__ldg(w1 + e));
  for (int e = tid; e < kD * H2P; e += kThreads) {
    const int j = e / H2P, k = e % H2P;
    w2s[j * LD2 + k] = __float2bfloat16_rn(k < h2 ? __ldg(w2 + j * h2 + k) : 0.f);
  }
  float b1c[4][2];  // bf16(b1) at this thread's columns of the [T, 128] products
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) b1c[ni][j] = bf(__ldg(b1 + pn0 + ni * 8 + 2 * tq + j));

  float gw1[2][8][4], gw2[2][NT2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) gw1[mi][ni][v] = 0.f;
#pragma unroll
    for (int ni = 0; ni < NT2; ++ni)
#pragma unroll
      for (int v = 0; v < 4; ++v) gw2[mi][ni][v] = 0.f;
  }
  float gb1[4][2] = {};  // db1 over this thread's rows, at its columns
  float gb2 = 0.f;       // db2 at column tid % H2P over rows tid / H2P + k * (256 / H2P)

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int stage = it & 1;
    const int64_t row0 = tile * T;
    if (tile + gridDim.x < n_tiles) load_tile(tile + gridDim.x, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this tile's group has landed
    __syncthreads();

    // a. d2 with the saved final-ReLU mask: db2 from the f32 values, bf16(d2) to
    //    shared memory, zero past h2; f32 x rounded to a bf16 tile
    {
      const IO* dqv = reinterpret_cast<const IO*>(smem + L::dqst + stage * L::vst_bytes);
      const IO* ov = reinterpret_cast<const IO*>(smem + L::outst + stage * L::vst_bytes);
#pragma unroll 4
      for (int e = tid; e < T * H2P; e += kThreads) {
        const int r = e / H2P, c = e % H2P;
        float d = 0.f;
        if (c < h2) {
          const int s = r * h2 + c;
          d = to_f32(ov[s]) > 0.f ? to_f32(dqv[s]) : 0.f;
        }
        gb2 += d;
        d2s[r * LD2 + c] = __float2bfloat16_rn(d);
      }
      if constexpr (!L::kXDirect) {
        const float* xf = reinterpret_cast<const float*>(smem + L::xst + stage * L::xst_bytes);
        for (int e = tid; e < T * kD / 4; e += kThreads) {
          const int r = e / (kD / 4), c = (e % (kD / 4)) * 4;
          const float4 v = *reinterpret_cast<const float4*>(xf + r * kD + c);
          store2(xs + r * kLd + c, v.x, v.y);
          store2(xs + r * kLd + c + 2, v.z, v.w);
        }
      }
    }
    __syncthreads();
    const bf16* xa = L::kXDirect
                         ? reinterpret_cast<const bf16*>(smem + L::xst + stage * L::xst_bytes)
                         : xs;

    // b. pre1 = bf16(bf16(x @ W1) + bf16(b1)): h1 = relu(pre1) to shared memory,
    //    the mask pre1 > 0 as bits; then d1 = mask ? bf16(d2) @ W2^T : 0, db1 from
    //    the f32 values, bf16(d1) to shared memory
    uint32_t pos = 0;  // bit (mi * 4 + ni) * 4 + v: pre1 > 0
    {
      uint32_t ties = 0;  // the same bits: a ReLU decision that needs the k-ordered sum
      float acc[PMT][4][4] = {};
      warp_mma<PMT, 4, false, true, kD>(acc, xa, kLd, w1s, kLd, pm0, pn0, lane);
#pragma unroll
      for (int mi = 0; mi < PMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float a0 = acc[mi][ni][2 * h], a1 = acc[mi][ni][2 * h + 1];
            const float p0 = bf(bf(a0) + b1c[ni][0]);
            const float p1 = bf(bf(a1) + b1c[ni][1]);
            const int bit = (mi * 4 + ni) * 4 + 2 * h;
            pos |= (p0 > 0.f ? 1u : 0u) << bit;
            pos |= (p1 > 0.f ? 1u : 0u) << (bit + 1);
            ties |= (relu_tie(a0, b1c[ni][0]) ? 1u : 0u) << bit;
            ties |= (relu_tie(a1, b1c[ni][1]) ? 1u : 0u) << (bit + 1);
            store2(h1s + (pm0 + mi * 16 + g + 8 * h) * kLd + pn0 + ni * 8 + 2 * tq,
                   fmaxf(p0, 0.f), fmaxf(p1, 0.f));
          }
      // rare (a few values a tile): redo those decisions from the k-ordered sum
      while (ties) {
        const int bit = __ffs(ties) - 1;
        ties &= ties - 1;
        const int r = pm0 + (bit >> 4) * 16 + g + 8 * ((bit >> 1) & 1);
        const int c = pn0 + ((bit >> 2) & 3) * 8 + 2 * tq + (bit & 1);
        const float p = bf(bf(ordered_dot(xa + r * kLd, w1s, c)) + bf(__ldg(b1 + c)));
        pos = (pos & ~(1u << bit)) | ((p > 0.f ? 1u : 0u) << bit);
        h1s[r * kLd + c] = __float2bfloat16_rn(fmaxf(p, 0.f));
      }
    }
    {
      float acc[PMT][4][4] = {};
      warp_mma<PMT, 4, false, false, H2P>(acc, d2s, LD2, w2s, LD2, pm0, pn0, lane);
#pragma unroll
      for (int mi = 0; mi < PMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int bit = (mi * 4 + ni) * 4 + 2 * h;
            const float v0 = (pos >> bit) & 1u ? acc[mi][ni][2 * h] : 0.f;
            const float v1 = (pos >> (bit + 1)) & 1u ? acc[mi][ni][2 * h + 1] : 0.f;
            gb1[ni][0] += v0;
            gb1[ni][1] += v1;
            store2(d1s + (pm0 + mi * 16 + g + 8 * h) * kLd + pn0 + ni * 8 + 2 * tq, v0, v1);
          }
    }
    __syncthreads();

    // c. dx = bf16(d1) @ W1^T, stored from the fragments; dW1 += x^T @ bf16(d1);
    //    dW2 += h1^T @ bf16(d2)
    {
      float acc[PMT][4][4] = {};
      warp_mma<PMT, 4, false, false, kD>(acc, d1s, kLd, w1s, kLd, pm0, pn0, lane);
#pragma unroll
      for (int mi = 0; mi < PMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            store2(dx + (row0 + pm0 + mi * 16 + g + 8 * h) * kD + pn0 + ni * 8 + 2 * tq,
                   acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
    warp_mma<2, 8, true, true, T>(gw1, xa, kLd, d1s, kLd, gm0, gn1, lane);
    warp_mma<2, NT2, true, true, T>(gw2, h1s, kLd, d2s, LD2, gm0, gn2, lane);
    __syncthreads();  // the next tile overwrites the stage and the shared tiles
  }
  cp_async_wait_all();

  // this block's partial gradients: [dW1 128x128 | db1 128 | dW2 128xH2 | db2 H2]
  const int64_t n_out = kD * kD + kD + static_cast<int64_t>(kD) * h2 + h2;
  float* part = partials + blockIdx.x * n_out;
  float* red = reinterpret_cast<float*>(smem + L::d2);  // free after the loop's last barrier
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = gb1[ni][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[(warp >> 2) * kD + pn0 + ni * 8 + 2 * tq + j] = v;
    }
  red[2 * kD + tid] = gb2;
  __syncthreads();
  if (tid < kD) part[kD * kD + tid] = red[tid] + red[kD + tid];
  if (tid < h2) {
    float s = 0.f;
    for (int q = 0; q < kThreads / H2P; ++q) s += red[2 * kD + q * H2P + tid];
    part[kD * kD + kD + kD * h2 + tid] = s;
  }
  float* pw2 = part + kD * kD + kD;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = gm0 + mi * 16 + g + 8 * (v >> 1);
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) part[r * kD + gn1 + ni * 8 + 2 * tq + (v & 1)] = gw1[mi][ni][v];
#pragma unroll
      for (int ni = 0; ni < NT2; ++ni) {
        const int c = gn2 + ni * 8 + 2 * tq + (v & 1);
        if (c < h2) pw2[r * h2 + c] = gw2[mi][ni][v];
      }
    }
}

// grads[e] = sum over blocks b, in order, of partials[b][e]
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partials, float* __restrict__ grads, int n_blocks,
                int64_t n_out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_out) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += __ldg(partials + b * n_out + e);
  grads[e] = s;
}

template <typename IO, int H2P>
int launch(const void* x, const void* dq, const void* out, const float* w1, const float* b1,
           const float* w2, void* dx, float* partials, float* grads, int64_t batch, int h2,
           int n_blocks, cudaStream_t stream) {
  using L = Layout<IO, H2P>;
  cudaError_t err = cudaFuncSetAttribute(tower_bwd_kernel<IO, H2P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(L::bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  tower_bwd_kernel<IO, H2P><<<n_blocks, kThreads, L::bytes, stream>>>(
      static_cast<const IO*>(x), static_cast<const IO*>(dq), static_cast<const IO*>(out), w1, b1,
      w2, static_cast<IO*>(dx), partials, batch / L::T, h2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_out = kD * kD + kD + static_cast<int64_t>(kD) * h2 + h2;
  reduce_partials<<<static_cast<unsigned>((n_out + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(partials, grads, n_blocks, n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int launch_h2(const void* x, const void* dq, const void* out, const float* w1, const float* b1,
              const float* w2, void* dx, float* partials, float* grads, int64_t batch, int h2,
              int n_blocks, cudaStream_t stream) {
  if (h2 <= 32)
    return launch<IO, 32>(x, dq, out, w1, b1, w2, dx, partials, grads, batch, h2, n_blocks, stream);
  if (h2 <= 64)
    return launch<IO, 64>(x, dq, out, w1, b1, w2, dx, partials, grads, batch, h2, n_blocks, stream);
  return launch<IO, 128>(x, dq, out, w1, b1, w2, dx, partials, grads, batch, h2, n_blocks, stream);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Returns a cudaError_t code: 0 when both launches succeeded.
// partials: [n_blocks, n_out] f32 scratch; grads: [n_out] f32, laid out
// [dW1 128x128 | db1 128 | dW2 128xH2 | db2 H2].
int ttrm_tower_bwd(const void* x, const void* dq, const void* out, int io_dtype, const void* w1,
                   const void* b1, const void* w2, void* dx, void* partials, void* grads,
                   int64_t batch, int64_t h2, int64_t n_blocks, void* stream) {
  if (io_dtype != kF32 && io_dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tile = io_dtype == kBF16 ? Layout<bf16, 32>::T : Layout<float, 32>::T;
  if (batch <= 0 || batch % tile != 0 || h2 <= 0 || h2 > kD || n_blocks <= 0 ||
      n_blocks > batch / tile || !aligned16(x) || !aligned16(dq) || !aligned16(out) ||
      !aligned16(dx))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w1f = static_cast<const float*>(w1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* w2f = static_cast<const float*>(w2);
  auto* pf = static_cast<float*>(partials);
  auto* gf = static_cast<float*>(grads);
  const int h = static_cast<int>(h2);
  const int nb = static_cast<int>(n_blocks);
  if (io_dtype == kF32) return launch_h2<float>(x, dq, out, w1f, b1f, w2f, dx, pf, gf, batch, h, nb, s);
  return launch_h2<bf16>(x, dq, out, w1f, b1f, w2f, dx, pf, gf, batch, h, nb, s);
}

const char* ttrm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
