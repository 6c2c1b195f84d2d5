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
//   * up and down are ffn_tile.cuh's kernels (shared with csrc/expert_ffn.cu)
//     on fma_tile.cuh's register-blocked mainloop, fed by this file's row
//     source (GatherRows): a block of 256 threads owns BM routed rows x 128
//     B columns and streams 32-deep slabs of A and B through a ring of
//     cp.async stages.
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

#include "ffn_tile.cuh"

namespace {

using repro::kTileThreads;
using repro::store;

constexpr int kCombineThreads = 256;

// The routed rows of expert e: slot r holds token rid[e * cap + r] (an id
// outside [0, S) is an empty slot, zero-filled); counts[e] are live.
struct GatherRows {
  const int* rid;
  const int* counts;
  int S, cap;
  static constexpr bool kZeroTail = false;  // never read: combine skips them
  __device__ int count(int e) const { return min(counts[e], cap); }
  template <typename TX>
  __device__ const TX* row(const TX* x, int e, int r, int M) const {
    const int id = rid[static_cast<size_t>(e) * cap + r];
    return id >= 0 && id < S ? x + static_cast<size_t>(id) * M : nullptr;
  }
};

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
  const GatherRows rows{rid, counts, S, cap};
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = repro::launch_by_rows<float, float>(x, rows, w1, w3, w2, mid, hbuf,
                                              M, F, E, 1, cap, act, wire, st);
  else if (x_dtype == 1 && w_dtype == 1)
    err = repro::launch_by_rows<__nv_bfloat16, __nv_bfloat16>(
        x, rows, w1, w3, w2, mid, hbuf, M, F, E, 1, cap, act, wire, st);
  else if (x_dtype == 0)
    err = repro::launch_by_rows<float, __nv_bfloat16>(
        x, rows, w1, w3, w2, mid, hbuf, M, F, E, 1, cap, act, wire, st);
  else
    err = repro::launch_by_rows<__nv_bfloat16, float>(
        x, rows, w1, w3, w2, mid, hbuf, M, F, E, 1, cap, act, wire, st);
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
