// Expert FFN over a capacity buffer for Hopper (sm_90a), dense and ragged,
// plain C interface (loaded with ctypes).
//
// Replaces:
//   * src/repro/kernels/expert_ffn.py::expert_ffn (_ffn_kernel): per expert
//     out[e] = (act(x[e] @ w1[e]) [* (x[e] @ w3[e])]) @ w2[e] over an
//     (E, T, M) buffer, every row computed (entry point repro_expert_ffn);
//   * src/repro/kernels/expert_ffn_grouped.py::expert_ffn_ragged
//     (_ragged_kernel): the same FFN over an (E, G, c, M) pool with (E, G)
//     routed-row counts; row tiles wholly past a count are skipped and rows
//     at or past the count are written as exact zeros (entry point
//     repro_expert_ffn_ragged).
// Both compute in f32 whatever the input and weight dtypes; the dense
// output takes the promoted dtype of x and the weights, the ragged output
// x's dtype (the JAX oracles' casts).
//
// What bounds it on an H100: operations at the training shapes, bytes at
// decode.  gpt2-moe (E 8, T 2464, M 768, F 3072, two-layer) does 2 * 2 *
// 19712 * 768 * 3072 = 186 GFLOP on 272 MB (151 MB of weights, the buffer
// in and out): ~680 flop/byte, far past the f32 ridge (~20), so the floor
// is the FMAs at 67 TFLOP/s (no tensor cores: the reference is f32).
// qwen3's decode (E 128, T 8, M 2048, F 768, SwiGLU) reads 2.4 GB of
// weights for 8 rows per expert: ~4 flop/byte, bytes-bound.
//
// Design: the grouped kernel's up and down (csrc/ffn_tile.cuh on
// fma_tile.cuh's mainloop) with a contiguous row source and no gather or
// combine.  A group's rows lie at (group * c + r) * M; `counts` (or c in
// the dense form) give each tile's live rows, and a tile multiplies only
// its live 16-row groups.  up writes act(h1) [* h3] into an f32
// (E*G*c, F) scratch; down writes y in its dtype directly.  In the ragged
// form down writes rows at or past the count as zeros, and a block whose
// tile lies wholly past it writes its zeros without reading the weights.
// BM by rows per group: 16 at decode (T 8), 64 at qwen3's c 160, 128 at
// gpt2-moe's 1232 and 2464, 64 for mixed x / weight dtypes.
// Every output element is one fmaf chain in k order from 0.f over its own
// row's inputs (no split-K, no atomics): deterministic, independent of
// which rows share a tile and of T (a capacity buffer cut into chunks
// gives the same rows bitwise), and the grouped kernel's rows bit for bit.
// Rows of x, w1/w3, w2 and the scratch must be 16-byte aligned (the
// wrapper checks: cp.async copies 16 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ffn_tile.cuh"

namespace {

// Group g's rows are contiguous from row g * c; counts (null: the dense
// form, every row live) give its live rows.
struct ContigRows {
  const int* counts;
  int c;
  static constexpr bool kZeroTail = true;
  __device__ int count(int g) const {
    return counts == nullptr ? c : max(0, min(counts[g], c));
  }
  template <typename TX>
  __device__ const TX* row(const TX* x, int g, int r, int M) const {
    return x + (static_cast<size_t>(g) * c + r) * M;
  }
};

template <typename TX, typename TW>
cudaError_t launch_out(const void* x, const ContigRows& rows, const void* w1,
                       const void* w3, const void* w2, float* mid, void* y,
                       int y_dtype, int M, int F, int EG, int G, int c,
                       int act, cudaStream_t st) {
  if (y_dtype == 0)
    return repro::launch_by_rows<TX, TW>(x, rows, w1, w3, w2, mid,
                                         static_cast<float*>(y), M, F, EG, G,
                                         c, act, 0, st);
  return repro::launch_by_rows<TX, TW>(x, rows, w1, w3, w2, mid,
                                       static_cast<__nv_bfloat16*>(y), M, F,
                                       EG, G, c, act, 0, st);
}

// Both entry points: up then down over E*G groups of c rows each.
int run_ffn(const void* x, int x_dtype, const int* counts, const void* w1,
            const void* w3, const void* w2, int w_dtype, float* mid, void* y,
            int y_dtype, int E, int G, int c, int M, int F, int act,
            void* stream) {
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 ||
      y_dtype < 0 || y_dtype > 1 || E <= 0 || G <= 0 || c < 0 || M <= 0 ||
      F <= 0 || act < 0 || act > 1 || E * G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ContigRows rows{counts, c};
  const int EG = E * G;
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch_out<float, float>(x, rows, w1, w3, w2, mid, y, y_dtype, M,
                                   F, EG, G, c, act, st);
  else if (x_dtype == 0)
    err = launch_out<float, __nv_bfloat16>(x, rows, w1, w3, w2, mid, y,
                                           y_dtype, M, F, EG, G, c, act, st);
  else if (w_dtype == 0)
    err = launch_out<__nv_bfloat16, float>(x, rows, w1, w3, w2, mid, y,
                                           y_dtype, M, F, EG, G, c, act, st);
  else
    err = launch_out<__nv_bfloat16, __nv_bfloat16>(
        x, rows, w1, w3, w2, mid, y, y_dtype, M, F, EG, G, c, act, st);
  return static_cast<int>(err);
}

}  // namespace

// Dense form.  x (E, T, M) in x_dtype (0 = float32, 1 = bfloat16); w1/w3
// (E, M, F), w2 (E, F, M) in w_dtype (w3 null for two-layer experts); mid
// an f32 (E*T, F) scratch; y (E, T, M) in y_dtype.  act: 0 = silu, 1 =
// gelu (tanh).  Returns the first cudaError_t of the two launches.
extern "C" int repro_expert_ffn(const void* x, int x_dtype, const void* w1,
                                const void* w3, const void* w2, int w_dtype,
                                float* mid, void* y, int y_dtype, int E,
                                int T, int M, int F, int act, void* stream) {
  return run_ffn(x, x_dtype, nullptr, w1, w3, w2, w_dtype, mid, y, y_dtype,
                 E, 1, T, M, F, act, stream);
}

// Ragged form.  xb (E, G, c, M) in x_dtype; counts (E, G) int32 routed rows
// per group; y (E, G, c, M) in x_dtype, rows at or past a count exactly 0;
// mid an f32 (E*G*c, F) scratch.  Otherwise as repro_expert_ffn.
extern "C" int repro_expert_ffn_ragged(const void* xb, int x_dtype,
                                       const int* counts, const void* w1,
                                       const void* w3, const void* w2,
                                       int w_dtype, float* mid, void* y,
                                       int E, int G, int c, int M, int F,
                                       int act, void* stream) {
  if (counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return run_ffn(xb, x_dtype, counts, w1, w3, w2, w_dtype, mid, y, x_dtype,
                 E, G, c, M, F, act, stream);
}
