// Dropless grouped expert FFN (fused dispatch -> FFN -> combine) for Hopper
// (sm_90a), plain C interface (loaded with ctypes).
//
// Replaces: src/repro/kernels/expert_ffn_grouped.py::expert_ffn_grouped
// (_fused_kernel), the Pallas TPU single-device megakernel: gather each
// expert's routed token rows, run act(x @ w1) [* (x @ w3)] @ w2 in f32, and
// return the gate-weighted sum of each token's k expert outputs, with the
// optional bf16 wire round-trip at the two pool boundaries.
//
// What bounds it on an H100.  The op reads every hit expert's weights once
// (n_mat * M * F elements each) and does 2 * n_mat * routed * M * F flops:
// about rows_per_expert / 2 flop per f32 byte.  At decode (8 tokens x
// top-8, ~1 row per hit expert) that is far below the f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20 flop/byte): bytes bound it.  At the training steps
// (qwen3: ~128 rows per expert, gpt2-moe: ~2048) it is far above: the f32
// FMA rate bounds it.  No tensor cores: the reference is f32 and TF32 keeps
// 10 mantissa bits, which the stated tolerances do not allow.
//
// Design:
//   * The routed-row metadata (slot -> token row, routed rows per expert) is
//     built on the device in torch by the wrapper.  Slots of an expert are
//     contiguous from 0 (GShard slot priority), so `counts` are ragged group
//     sizes.
//   * up and down run on one register-blocked mainloop (fma_tile.cuh): a
//     block of 256 threads owns BM routed rows x 128 B columns and streams
//     32-deep slabs of A and B through a ring of cp.async stages.
//       up:   A = the expert's routed x rows, gathered by id straight into
//             shared memory (pad and unrouted rows are zero-filled, never
//             read, so NaN rows cannot leak); B = 64 columns of w1 beside
//             the same 64 of w3 under GLU (a thread holds 4 x 4 of each of
//             h1 and h3), else 128 columns of w1.  Epilogue: act(h1) [* h3]
//             into an f32 (E*cap, F) scratch.  With the bf16 wire, each x
//             slab is rounded through bf16 in shared memory once it lands.
//       down: A = the expert's contiguous rows of that scratch, B = 128
//             columns of w2; the wire round-trip in the epilogue, into an
//             f32 (E*cap, M) scratch.
//     A block whose row tile lies past the expert's routed count returns
//     before touching memory, so unrouted experts' weights are never read.
//   * BM follows the rows per expert, chosen by the launcher from the
//     capacity: 16 rows (a 4-stage ring of 16 KB weight slabs, three
//     blocks per SM: the bytes-bound decode), 64 (qwen3's training cap
//     160: tiles of 64 + 64 + 32) or 128 (gpt2-moe's 2464: 20 passes over
//     an expert's weights instead of 154 at 16 rows).  A tile multiplies
//     only its 16-row groups that hold live rows, and a warp whose rows are
//     all dead only copies: at decode (1-2 live rows of 16) one warp of
//     eight multiplies, so the weight stream, not the FMAs, sets the time
//     (multiplying all 16 rows made decode bound by FMAs, not bytes).  Mixed
//     x / weight dtypes take the 64-row instance.  Every instance runs the
//     same k-order FMA chains, so the choice never changes a bit of the
//     output.
//   * combine: one block row per token sums its k choices in choice order
//     (as moe_combine_ref) and casts to x's dtype.  Dropped choices are
//     skipped.
// Every output element is one fmaf chain over k in ascending order from
// 0.f over its own row (no split-K, no atomics): the result is
// deterministic, independent of which other tokens share a tile (the
// serving engine's batch independence rests on this), and equal bit for
// bit to dispatch -> expert_ffn -> combine (csrc/expert_ffn.cu computes
// the same chains).  x rows, weight rows and the scratch rows must be
// 16-byte aligned (the wrapper checks; cp.async copies 16 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fma_tile.cuh"

namespace {

using repro::bf16_round;
using repro::FmaTile;
using repro::kSegs;
using repro::kTileThreads;
using repro::store;

constexpr int kCombineThreads = 256;

// act: 0 = silu, 1 = gelu in its tanh form (jax.nn.gelu's default).
__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return v / (1.f + expf(-v));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

template <int BM>
struct Inst {  // each row-tile instance's ring depth and blocks per SM
  static constexpr int kStages = BM == 128 ? 3 : 4;
  static constexpr int kMinBlocks = BM == 16 ? 3 : BM == 64 ? 2 : 1;
  template <typename TA, typename TB>
  using Tile = FmaTile<TA, TB, BM, kStages>;
};

// The mainloop over the 16-row groups of a tile that hold its nrows live
// rows (a power of two of them at BM 128): dead groups' accumulators stay
// 0 and are not stored.  qwen3's last tile of an expert holds 1-32 rows.
template <typename TA, typename TB, int BM>
__device__ __forceinline__ void run_mainloop(
    char* smem,
    const TA* const (&a_row)[Inst<BM>::template Tile<TA, TB>::kAPer],
    const TA* a_any, const TB* const (&b_src)[2], int b_split, int ldb,
    const int (&b_cols)[2], int K, bool round_a, int nrows,
    float (&acc)[BM / 16][4 * kSegs]) {
  constexpr int kS = Inst<BM>::kStages;
  const int live = (nrows + 15) / 16;
#define REPRO_MAINLOOP(L)                                                  \
  repro::fma_mainloop<TA, TB, BM, kS, L>(smem, a_row, a_any, b_src,        \
                                             b_split, ldb, b_cols, K,      \
                                             round_a, nrows, acc)
  if constexpr (BM == 64) {
    if (live <= 1) REPRO_MAINLOOP(1);
    else if (live == 2) REPRO_MAINLOOP(2);
    else if (live == 3) REPRO_MAINLOOP(3);
    else REPRO_MAINLOOP(4);
  } else if constexpr (BM == 128) {
    if (live <= 1) REPRO_MAINLOOP(1);
    else if (live == 2) REPRO_MAINLOOP(2);
    else if (live <= 4) REPRO_MAINLOOP(4);
    else REPRO_MAINLOOP(8);
  } else {
    REPRO_MAINLOOP(BM / 16);
  }
#undef REPRO_MAINLOOP
}

template <typename TX, typename TW, int BM, bool kGlu>
__global__ void __launch_bounds__(kTileThreads, Inst<BM>::kMinBlocks)
grouped_up_kernel(const TX* __restrict__ x, const int* __restrict__ rid,
                  const int* __restrict__ counts, const TW* __restrict__ w1,
                  const TW* __restrict__ w3, float* __restrict__ mid, int S,
                  int M, int F, int cap, int act, int wire) {
  using T = typename Inst<BM>::template Tile<TX, TW>;
  constexpr int kOut = kGlu ? 1 : kSegs;  // 64-column groups of mid
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int cnt = min(counts[e], cap);
  if (r0 >= cnt) return;  // ragged: empty (expert, row tile) pairs skipped
  const int nrows = min(BM, cnt - r0);
  const int n0 = blockIdx.x * 64 * kOut;
  extern __shared__ float4 smem4[];

  const TX* a_row[T::kAPer];
#pragma unroll
  for (int p = 0; p < T::kAPer; ++p) {
    const int row = T::chunk_row(p);
    const TX* src = nullptr;
    if (row < nrows) {
      const int id = rid[static_cast<size_t>(e) * cap + r0 + row];
      if (id >= 0 && id < S) src = x + static_cast<size_t>(id) * M;
    }
    a_row[p] = src;
  }
  // B: w1's columns n0.., then (GLU) w3's same columns
  const size_t woff = static_cast<size_t>(e) * M * F + n0;
  const TW* b_src[2] = {w1 + woff, kGlu ? w3 + woff : w1 + woff};
  const int b_cols[2] = {F - n0, kGlu ? F - n0 : 0};
  float acc[T::kTM][4 * kSegs];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kSegs; ++j) acc[i][j] = 0.f;
  run_mainloop<TX, TW, BM>(reinterpret_cast<char*>(smem4), a_row, x, b_src,
                           kOut, F, b_cols, M, wire != 0, nrows, acc);

  const int ty = threadIdx.x >> 4;
  const int f0 = n0 + (threadIdx.x & 15) * 4;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    float* out = mid + (static_cast<size_t>(e) * cap + r0 + r) * F;
#pragma unroll
    for (int g = 0; g < kOut; ++g) {
      const int f = f0 + 64 * g;
      if (f >= F) continue;
      float h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = act_fn(acc[i][4 * g + j], act);
        if constexpr (kGlu) h[j] *= acc[i][4 * (g + kOut) + j];
      }
      *reinterpret_cast<float4*>(out + f) = make_float4(h[0], h[1], h[2],
                                                        h[3]);
    }
  }
}

template <typename TW, int BM>
__global__ void __launch_bounds__(kTileThreads, Inst<BM>::kMinBlocks)
grouped_down_kernel(const float* __restrict__ mid,
                    const int* __restrict__ counts, const TW* __restrict__ w2,
                    float* __restrict__ hbuf, int M, int F, int cap,
                    int wire) {
  using T = typename Inst<BM>::template Tile<float, TW>;
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int cnt = min(counts[e], cap);
  if (r0 >= cnt) return;
  const int nrows = min(BM, cnt - r0);
  const int m0 = blockIdx.x * 64 * kSegs;
  extern __shared__ float4 smem4[];
  const size_t row0 = static_cast<size_t>(e) * cap + r0;

  const float* a_row[T::kAPer];
#pragma unroll
  for (int p = 0; p < T::kAPer; ++p) {
    const int row = T::chunk_row(p);
    a_row[p] = row < nrows ? mid + (row0 + row) * F : nullptr;
  }
  const TW* wb = w2 + static_cast<size_t>(e) * F * M + m0;
  const TW* b_src[2] = {wb, wb};
  const int b_cols[2] = {M - m0, 0};
  float acc[T::kTM][4 * kSegs];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kSegs; ++j) acc[i][j] = 0.f;
  run_mainloop<float, TW, BM>(reinterpret_cast<char*>(smem4), a_row, mid,
                              b_src, kSegs, M, b_cols, F, false, nrows, acc);

  const int ty = threadIdx.x >> 4;
  const int mc = m0 + (threadIdx.x & 15) * 4;
#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    float* out = hbuf + (row0 + r) * M;
#pragma unroll
    for (int g = 0; g < kSegs; ++g) {
      const int m = mc + 64 * g;
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = wire ? bf16_round(acc[i][4 * g + j]) : acc[i][4 * g + j];
      *reinterpret_cast<float4*>(out + m) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
    }
  }
}

template <typename TY>
__global__ void __launch_bounds__(kCombineThreads)
grouped_combine_kernel(const float* __restrict__ hbuf,
                       const int* __restrict__ flat,
                       const float* __restrict__ weights,
                       const int* __restrict__ counts, TY* __restrict__ y,
                       int k, int M, int E, int cap) {
  const int s = blockIdx.x;
  const int m = blockIdx.y * kCombineThreads + threadIdx.x;
  if (m >= M) return;
  const long long n_slots = static_cast<long long>(E) * cap;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const int f = flat[static_cast<size_t>(s) * k + j];
    if (f < 0 || f >= n_slots) continue;  // dropped choice: skipped
    const int e = f / cap;
    if (f - e * cap >= min(counts[e], cap)) continue;  // never computed
    acc = fmaf(weights[static_cast<size_t>(s) * k + j],
               hbuf[static_cast<size_t>(f) * M + m], acc);
  }
  store(y + static_cast<size_t>(s) * M + m, acc);
}

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename TX, typename TW, int BM, bool kGlu>
cudaError_t launch_up(const void* x, const int* rid, const int* counts,
                      const void* w1, const void* w3, float* mid, int S, int M,
                      int F, int E, int cap, int act, int wire,
                      cudaStream_t st) {
  constexpr int kBytes = Inst<BM>::template Tile<TX, TW>::kSmemBytes;
  constexpr int kBN = kGlu ? 64 : 128;  // F columns per block
  auto kern = grouped_up_kernel<TX, TW, BM, kGlu>;
  cudaError_t err = set_smem(kern, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kBN - 1) / kBN, (cap + BM - 1) / BM, E);
  kern<<<grid, kTileThreads, kBytes, st>>>(
      static_cast<const TX*>(x), rid, counts, static_cast<const TW*>(w1),
      static_cast<const TW*>(w3), mid, S, M, F, cap, act, wire);
  return cudaGetLastError();
}

template <typename TW, int BM>
cudaError_t launch_down(const float* mid, const int* counts, const void* w2,
                        float* hbuf, int M, int F, int E, int cap, int wire,
                        cudaStream_t st) {
  constexpr int kBytes = Inst<BM>::template Tile<float, TW>::kSmemBytes;
  constexpr int kBN = 64 * kSegs;
  auto kern = grouped_down_kernel<TW, BM>;
  cudaError_t err = set_smem(kern, kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBN - 1) / kBN, (cap + BM - 1) / BM, E);
  kern<<<grid, kTileThreads, kBytes, st>>>(
      mid, counts, static_cast<const TW*>(w2), hbuf, M, F, cap, wire);
  return cudaGetLastError();
}

template <typename TX, typename TW, int BM>
cudaError_t launch_ffn(const void* x, const int* rid, const int* counts,
                       const void* w1, const void* w3, const void* w2,
                       float* mid, float* hbuf, int S, int M, int F, int E,
                       int cap, int act, int wire, cudaStream_t st) {
  cudaError_t err =
      w3 != nullptr
          ? launch_up<TX, TW, BM, true>(x, rid, counts, w1, w3, mid, S, M, F,
                                        E, cap, act, wire, st)
          : launch_up<TX, TW, BM, false>(x, rid, counts, w1, w3, mid, S, M,
                                         F, E, cap, act, wire, st);
  if (err != cudaSuccess) return err;
  return launch_down<TW, BM>(mid, counts, w2, hbuf, M, F, E, cap, wire, st);
}

// The row-tile instance for a capacity (rows per expert): see the note at
// the top.  Any choice gives the same bits.
template <typename TX, typename TW>
cudaError_t launch_by_rows(const void* x, const int* rid, const int* counts,
                           const void* w1, const void* w3, const void* w2,
                           float* mid, float* hbuf, int S, int M, int F,
                           int E, int cap, int act, int wire,
                           cudaStream_t st) {
  if (cap <= 48)
    return launch_ffn<TX, TW, 16>(x, rid, counts, w1, w3, w2, mid, hbuf, S,
                                  M, F, E, cap, act, wire, st);
  if (cap <= 320)
    return launch_ffn<TX, TW, 64>(x, rid, counts, w1, w3, w2, mid, hbuf, S,
                                  M, F, E, cap, act, wire, st);
  return launch_ffn<TX, TW, 128>(x, rid, counts, w1, w3, w2, mid, hbuf, S, M,
                                 F, E, cap, act, wire, st);
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; y has x's dtype.  w3 may be
// null (2-layer experts).  act: 0 = silu, 1 = gelu (tanh).  wire: 0 = f32,
// 1 = bf16 round trip.  rid (E*cap) and counts (E) come from the wrapper's
// slot metadata; mid (E*cap, F) and hbuf (E*cap, M) are f32 scratch.  Rows
// of x, w1/w3, w2 and mid must be 16-byte aligned.  Returns the first
// cudaError_t of the three launches (0 on success).
extern "C" int repro_expert_ffn_grouped(
    const void* x, int x_dtype, const int* flat, const float* weights,
    const int* rid, const int* counts, const void* w1, const void* w3,
    const void* w2, int w_dtype, float* mid, float* hbuf, void* y, int S,
    int k, int M, int F, int E, int cap, int act, int wire, void* stream) {
  if (S <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || E <= 0 ||
      cap <= 0 || F <= 0 || k <= 0 || E > 65535 || (cap + 15) / 16 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  if (x_dtype == 0 && w_dtype == 0)
    err = launch_by_rows<float, float>(x, rid, counts, w1, w3, w2, mid, hbuf,
                                       S, M, F, E, cap, act, wire, st);
  else if (x_dtype == 1 && w_dtype == 1)
    err = launch_by_rows<__nv_bfloat16, __nv_bfloat16>(
        x, rid, counts, w1, w3, w2, mid, hbuf, S, M, F, E, cap, act, wire,
        st);
  else if (x_dtype == 0)
    err = launch_ffn<float, __nv_bfloat16, 64>(x, rid, counts, w1, w3, w2,
                                               mid, hbuf, S, M, F, E, cap,
                                               act, wire, st);
  else
    err = launch_ffn<__nv_bfloat16, float, 64>(x, rid, counts, w1, w3, w2,
                                               mid, hbuf, S, M, F, E, cap,
                                               act, wire, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 cgrid(S, (M + kCombineThreads - 1) / kCombineThreads);
  if (x_dtype == 0)
    grouped_combine_kernel<float><<<cgrid, kCombineThreads, 0, st>>>(
        hbuf, flat, weights, counts, static_cast<float*>(y), k, M, E, cap);
  else
    grouped_combine_kernel<__nv_bfloat16><<<cgrid, kCombineThreads, 0, st>>>(
        hbuf, flat, weights, counts, static_cast<__nv_bfloat16*>(y), k, M, E,
        cap);
  return static_cast<int>(cudaGetLastError());
}
