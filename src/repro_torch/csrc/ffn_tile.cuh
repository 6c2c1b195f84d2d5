// The expert FFN's up and down kernels on fma_tile.cuh's mainloop, shared
// by csrc/expert_ffn_grouped.cu (routed token rows gathered by id) and
// csrc/expert_ffn.cu (the dense and ragged forms: a group's rows are
// contiguous).  A row source (GatherRows, ContigRows in those files) tells
// the kernels where each row of a group lies and how many are live; the
// rest is common:
//
//   up:   grid (ceil(F / columns), ceil(c / BM), groups).  A = the group's
//         live rows, B = 64 columns of w1 beside the same 64 of w3 under
//         GLU (a thread holds 4 x 4 of each of h1 and h3), else 128 of w1.
//         Epilogue: act(h1) [* h3] into an f32 (groups * c, F) scratch.
//   down: grid (ceil(M / 128), ceil(c / BM), groups).  A = the group's
//         contiguous scratch rows, B = 128 columns of w2.  Epilogue: the
//         rows in the output's type, with the bf16 wire round trip when
//         asked; a row source that zeroes tails writes rows at or past
//         the count as exact zeros, a dead tile's block without reading
//         anything.
//
// A tile multiplies only its 16-row groups that hold live rows, and a
// block whose tile lies past the count returns before touching the
// weights.  Group g's weights are expert g / G (groups are expert-major).
// BM follows the rows per group (launch_by_rows): 16 rows (a 4-stage ring
// of 16 KB weight slabs, three blocks per SM: decode, bytes-bound), 64
// (qwen3's training pools, cap 160: tiles of 64 + 64 + 32) or 128 (gpt2-
// moe's 1232 and 2464 rows: fewer passes over an expert's weights).  Mixed
// x / weight dtypes take the 64-row instance.  Every instance runs the
// same k-order fmaf chains (fma_tile.cuh), so the choice never changes a
// bit of the output, and neither does which rows share a tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fma_tile.cuh"

namespace repro {

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

// Four consecutive outputs of a row (16-byte aligned for f32, 8 for bf16).
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

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
  fma_mainloop<TA, TB, BM, kS, L>(smem, a_row, a_any, b_src, b_split, ldb, \
                                  b_cols, K, round_a, nrows, acc)
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

// Rows: the row source.  Rows::count(g) is group g's live rows (<= c),
// Rows::row(x, g, r, M) the address of its row r (nullptr: a dead row,
// zero-filled), Rows::kZeroTail whether the down kernel writes rows at or
// past the count as zeros.
template <typename TX, typename TW, int BM, bool kGlu, typename Rows>
__global__ void __launch_bounds__(kTileThreads, Inst<BM>::kMinBlocks)
ffn_up_kernel(const TX* __restrict__ x, Rows rows,
              const TW* __restrict__ w1, const TW* __restrict__ w3,
              float* __restrict__ mid, int M, int F, int G, int c, int act,
              int wire) {
  using T = typename Inst<BM>::template Tile<TX, TW>;
  constexpr int kOut = kGlu ? 1 : kSegs;  // 64-column groups of mid
  const int grp = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int cnt = rows.count(grp);
  if (r0 >= cnt) return;  // ragged: empty (group, row tile) pairs skipped
  const int nrows = min(BM, cnt - r0);
  const int n0 = blockIdx.x * 64 * kOut;
  extern __shared__ float4 smem4[];

  const TX* a_row[T::kAPer];
#pragma unroll
  for (int p = 0; p < T::kAPer; ++p) {
    const int row = T::chunk_row(p);
    a_row[p] = row < nrows ? rows.row(x, grp, r0 + row, M) : nullptr;
  }
  // B: w1's columns n0.., then (GLU) w3's same columns
  const size_t woff = static_cast<size_t>(grp / G) * M * F + n0;
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
    float* out = mid + (static_cast<size_t>(grp) * c + r0 + r) * F;
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
      store4(out + f, h);
    }
  }
}

template <typename TW, typename TY, int BM, typename Rows>
__global__ void __launch_bounds__(kTileThreads, Inst<BM>::kMinBlocks)
ffn_down_kernel(const float* __restrict__ mid, Rows rows,
                const TW* __restrict__ w2, TY* __restrict__ y, int M, int F,
                int G, int c, int wire) {
  using T = typename Inst<BM>::template Tile<float, TW>;
  const int grp = blockIdx.z;
  const int r0 = blockIdx.y * BM;
  const int cnt = rows.count(grp);
  const int m0 = blockIdx.x * 64 * kSegs;
  const int ty = threadIdx.x >> 4;
  const int mc = m0 + (threadIdx.x & 15) * 4;
  const size_t row0 = static_cast<size_t>(grp) * c + r0;
  const int tile_rows = min(BM, c - r0);  // rows of the pool in this tile
  if (r0 >= cnt) {  // the whole tile is past the count
    if constexpr (Rows::kZeroTail) {
      const float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < T::kTM; ++i) {
        const int r = ty + 16 * i;
        if (r >= tile_rows) continue;
#pragma unroll
        for (int g = 0; g < kSegs; ++g)
          if (mc + 64 * g < M) store4(y + (row0 + r) * M + mc + 64 * g, z);
      }
    }
    return;
  }
  const int nrows = min(BM, cnt - r0);
  extern __shared__ float4 smem4[];

  const float* a_row[T::kAPer];
#pragma unroll
  for (int p = 0; p < T::kAPer; ++p) {
    const int row = T::chunk_row(p);
    a_row[p] = row < nrows ? mid + (row0 + row) * F : nullptr;
  }
  const TW* wb = w2 + static_cast<size_t>(grp / G) * F * M + m0;
  const TW* b_src[2] = {wb, wb};
  const int b_cols[2] = {M - m0, 0};
  float acc[T::kTM][4 * kSegs];
#pragma unroll
  for (int i = 0; i < T::kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kSegs; ++j) acc[i][j] = 0.f;
  run_mainloop<float, TW, BM>(reinterpret_cast<char*>(smem4), a_row, mid,
                              b_src, kSegs, M, b_cols, F, false, nrows, acc);

#pragma unroll
  for (int i = 0; i < T::kTM; ++i) {
    const int r = ty + 16 * i;
    const bool live = r < nrows;
    if (!(live || (Rows::kZeroTail && r < tile_rows))) continue;
    TY* out = y + (row0 + r) * M;
#pragma unroll
    for (int g = 0; g < kSegs; ++g) {
      const int m = mc + 64 * g;
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = acc[i][4 * g + j];
        v[j] = !live ? 0.f : wire ? bf16_round(a) : a;
      }
      store4(out + m, v);
    }
  }
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

// Up then down over `groups` groups of c rows (weights of expert g / G):
// mid is the f32 (groups * c, F) scratch, y the (groups * c, M) output.
template <typename TX, typename TW, typename TY, int BM, typename Rows>
cudaError_t launch_ffn_tiles(const void* x, const Rows& rows, const void* w1,
                             const void* w3, const void* w2, float* mid,
                             TY* y, int M, int F, int groups, int G, int c,
                             int act, int wire, cudaStream_t st) {
  using Up = typename Inst<BM>::template Tile<TX, TW>;
  using Down = typename Inst<BM>::template Tile<float, TW>;
  const int ytiles = (c + BM - 1) / BM;
  cudaError_t err;
  if (w3 != nullptr) {
    auto kern = ffn_up_kernel<TX, TW, BM, true, Rows>;
    err = set_smem(kern, Up::kSmemBytes);
    if (err != cudaSuccess) return err;
    kern<<<dim3((F + 63) / 64, ytiles, groups), kTileThreads, Up::kSmemBytes,
           st>>>(static_cast<const TX*>(x), rows, static_cast<const TW*>(w1),
                 static_cast<const TW*>(w3), mid, M, F, G, c, act, wire);
  } else {
    auto kern = ffn_up_kernel<TX, TW, BM, false, Rows>;
    err = set_smem(kern, Up::kSmemBytes);
    if (err != cudaSuccess) return err;
    kern<<<dim3((F + 127) / 128, ytiles, groups), kTileThreads,
           Up::kSmemBytes, st>>>(static_cast<const TX*>(x), rows,
                                 static_cast<const TW*>(w1), nullptr, mid, M,
                                 F, G, c, act, wire);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto down = ffn_down_kernel<TW, TY, BM, Rows>;
  err = set_smem(down, Down::kSmemBytes);
  if (err != cudaSuccess) return err;
  down<<<dim3((M + 127) / 128, ytiles, groups), kTileThreads,
         Down::kSmemBytes, st>>>(mid, rows, static_cast<const TW*>(w2), y, M,
                                 F, G, c, wire);
  return cudaGetLastError();
}

// The row-tile instance for c rows per group (see the note at the top);
// mixed x / weight dtypes take the 64-row one.  Any choice gives the same
// bits.
template <typename TX, typename TW, typename TY, typename Rows>
cudaError_t launch_by_rows(const void* x, const Rows& rows, const void* w1,
                           const void* w3, const void* w2, float* mid, TY* y,
                           int M, int F, int groups, int G, int c, int act,
                           int wire, cudaStream_t st) {
  if constexpr (sizeof(TX) != sizeof(TW)) {
    return launch_ffn_tiles<TX, TW, TY, 64>(x, rows, w1, w3, w2, mid, y, M,
                                            F, groups, G, c, act, wire, st);
  } else {
    if (c <= 48)
      return launch_ffn_tiles<TX, TW, TY, 16>(x, rows, w1, w3, w2, mid, y, M,
                                              F, groups, G, c, act, wire, st);
    if (c <= 320)
      return launch_ffn_tiles<TX, TW, TY, 64>(x, rows, w1, w3, w2, mid, y, M,
                                              F, groups, G, c, act, wire, st);
    return launch_ffn_tiles<TX, TW, TY, 128>(x, rows, w1, w3, w2, mid, y, M,
                                             F, groups, G, c, act, wire, st);
  }
}

}  // namespace repro
