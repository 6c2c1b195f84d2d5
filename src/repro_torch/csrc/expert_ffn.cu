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
// What bounds it on an H100: operations, at the training shapes.  gpt2-moe
// (E 8, T 2464, M 768, F 3072, two-layer) does 2 * 2 * 19712 * 768 * 3072
// = 186 GFLOP on 272 MB (151 MB of weights, the buffer in and out): ~680
// flop/byte, far past the f32 ridge (~20).  The floor is the FMAs at 67 TFLOP/s (no tensor
// cores: the reference is f32).
//
// Design (the structure of csrc/expert_ffn_grouped.cu, without the row
// gather: a group's rows are contiguous):
//   * up:   grid (F/64, ceil(c/16), E*G).  A block whose 16-row tile lies
//           past the group's count returns before touching memory.  Live
//           blocks stream 32-deep slabs of x and of w1/w3 through shared
//           memory, 4 rows x 1 column of f32 accumulators per thread, and
//           write act(h1) [* h3] into an f32 (E*G*c, F) scratch.
//   * down: grid (M/64, ceil(c/16), E*G), the same tiling over w2, writing
//           the output rows; in the ragged form a tile past the count, and
//           the rows of a partial tile past it, are written as zeros.
// Every output element is one FMA chain in k order over its own row's
// inputs (no split-K, no atomics): the result is deterministic and does
// not depend on which rows share a tile or on T, so a capacity buffer cut
// into chunks gives the same rows bitwise, and the arithmetic is the
// grouped kernel's FMA for FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 16;        // rows per tile
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // reduction depth per shared-memory slab
constexpr int kThreads = 256;  // kBN columns x 4 row groups
constexpr int kRowsPerThread = kBT / (kThreads / kBN);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// act: 0 = silu, 1 = gelu in its tanh form (jax.nn.gelu's default).
__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return v / (1.f + expf(-v));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ int group_count(const int* counts, int g, int c) {
  return counts == nullptr ? c : max(0, min(counts[g], c));
}

template <typename TX, typename TW, bool kGlu>
__global__ void __launch_bounds__(kThreads)
ffn_up_kernel(const TX* __restrict__ x, const int* __restrict__ counts,
              const TW* __restrict__ w1, const TW* __restrict__ w3,
              float* __restrict__ mid, int G, int c, int M, int F, int act) {
  const int grp = blockIdx.z;  // (expert, group) pair, expert-major
  const int e = grp / G;
  const int r0 = blockIdx.y * kBT;
  const int cnt = group_count(counts, grp, c);
  if (r0 >= cnt) return;  // ragged: empty row tiles skipped
  const int nrows = min(kBT, cnt - r0);
  const int f0 = blockIdx.x * kBN;
  const size_t row0 = static_cast<size_t>(grp) * c + r0;

  __shared__ float xs[kBT][kBK + 1];
  __shared__ float w1s[kBK][kBN];
  __shared__ float w3s[kGlu ? kBK : 1][kBN];

  const int tid = threadIdx.x;
  const int col = tid % kBN;
  const int rg = tid / kBN;
  float a1[kRowsPerThread];
  float a3[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) a1[j] = a3[j] = 0.f;
  const size_t wbase = static_cast<size_t>(e) * M * F;

  for (int k0 = 0; k0 < M; k0 += kBK) {
    for (int i = tid; i < kBT * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK, m = k0 + kk;
      xs[r][kk] = (r < nrows && m < M)
                      ? to_f32(x[(row0 + r) * M + m])
                      : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, cc = i % kBN, m = k0 + kk, f = f0 + cc;
      const bool ok = m < M && f < F;
      const size_t off = wbase + static_cast<size_t>(m) * F + f;
      w1s[kk][cc] = ok ? to_f32(w1[off]) : 0.f;
      if constexpr (kGlu) w3s[kk][cc] = ok ? to_f32(w3[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float b1 = w1s[kk][col];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float a = xs[rg * kRowsPerThread + j][kk];
        a1[j] = fmaf(a, b1, a1[j]);
        if constexpr (kGlu) a3[j] = fmaf(a, w3s[kk][col], a3[j]);
      }
    }
    __syncthreads();
  }

  const int f = f0 + col;
  if (f >= F) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = rg * kRowsPerThread + j;
    if (r < nrows) {
      float h = act_fn(a1[j], act);
      if constexpr (kGlu) h *= a3[j];
      mid[(row0 + r) * F + f] = h;
    }
  }
}

template <typename TW, typename TY>
__global__ void __launch_bounds__(kThreads)
ffn_down_kernel(const float* __restrict__ mid,
                const int* __restrict__ counts, const TW* __restrict__ w2,
                TY* __restrict__ y, int G, int c, int M, int F) {
  const int grp = blockIdx.z;
  const int e = grp / G;
  const int r0 = blockIdx.y * kBT;
  const int cnt = group_count(counts, grp, c);
  const int m0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int col = tid % kBN;
  const int rg = tid / kBN;
  const int m = m0 + col;
  const int tile_rows = min(kBT, c - r0);  // rows of the pool in this tile
  const size_t row0 = static_cast<size_t>(grp) * c + r0;

  if (r0 >= cnt) {  // ragged: the whole tile is past the count
    if (m < M) {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int r = rg * kRowsPerThread + j;
        if (r < tile_rows) store(y + (row0 + r) * M + m, 0.f);
      }
    }
    return;
  }
  const int nrows = min(kBT, cnt - r0);

  __shared__ float hs[kBT][kBK + 1];
  __shared__ float ws[kBK][kBN];

  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;
  const size_t wbase = static_cast<size_t>(e) * F * M;

  for (int k0 = 0; k0 < F; k0 += kBK) {
    for (int i = tid; i < kBT * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK, fk = k0 + kk;
      hs[r][kk] = (r < nrows && fk < F) ? mid[(row0 + r) * F + fk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, cc = i % kBN, fk = k0 + kk, mm = m0 + cc;
      ws[kk][cc] = (fk < F && mm < M)
                       ? to_f32(w2[wbase + static_cast<size_t>(fk) * M + mm])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float b = ws[kk][col];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        acc[j] = fmaf(hs[rg * kRowsPerThread + j][kk], b, acc[j]);
      }
    }
    __syncthreads();
  }

  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = rg * kRowsPerThread + j;
    if (r < nrows)
      store(y + (row0 + r) * M + m, acc[j]);
    else if (r < tile_rows)  // partial tile: rows past the count are 0
      store(y + (row0 + r) * M + m, 0.f);
  }
}

template <typename TX, typename TW>
cudaError_t launch_up(const void* x, const int* counts, const void* w1,
                      const void* w3, float* mid, int EG, int G, int c, int M,
                      int F, int act, cudaStream_t st) {
  const dim3 grid((F + kBN - 1) / kBN, (c + kBT - 1) / kBT, EG);
  if (w3 != nullptr)
    ffn_up_kernel<TX, TW, true><<<grid, kThreads, 0, st>>>(
        static_cast<const TX*>(x), counts, static_cast<const TW*>(w1),
        static_cast<const TW*>(w3), mid, G, c, M, F, act);
  else
    ffn_up_kernel<TX, TW, false><<<grid, kThreads, 0, st>>>(
        static_cast<const TX*>(x), counts, static_cast<const TW*>(w1),
        nullptr, mid, G, c, M, F, act);
  return cudaGetLastError();
}

template <typename TW>
cudaError_t launch_down(const float* mid, const int* counts, const void* w2,
                        void* y, int y_dtype, int EG, int G, int c, int M,
                        int F, cudaStream_t st) {
  const dim3 grid((M + kBN - 1) / kBN, (c + kBT - 1) / kBT, EG);
  if (y_dtype == 0)
    ffn_down_kernel<TW, float><<<grid, kThreads, 0, st>>>(
        mid, counts, static_cast<const TW*>(w2), static_cast<float*>(y), G,
        c, M, F);
  else
    ffn_down_kernel<TW, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        mid, counts, static_cast<const TW*>(w2),
        static_cast<__nv_bfloat16*>(y), G, c, M, F);
  return cudaGetLastError();
}

// Both entry points: up then down over E*G groups of c rows each.
int run_ffn(const void* x, int x_dtype, const int* counts, const void* w1,
            const void* w3, const void* w2, int w_dtype, float* mid, void* y,
            int y_dtype, int E, int G, int c, int M, int F, int act,
            void* stream) {
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 ||
      y_dtype < 0 || y_dtype > 1 || E <= 0 || G <= 0 || c < 0 || M <= 0 ||
      F <= 0 || act < 0 || act > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int EG = E * G;
  cudaError_t err;
  if (x_dtype == 0 && w_dtype == 0)
    err = launch_up<float, float>(x, counts, w1, w3, mid, EG, G, c, M, F,
                                  act, st);
  else if (x_dtype == 0)
    err = launch_up<float, __nv_bfloat16>(x, counts, w1, w3, mid, EG, G, c,
                                          M, F, act, st);
  else if (w_dtype == 0)
    err = launch_up<__nv_bfloat16, float>(x, counts, w1, w3, mid, EG, G, c,
                                          M, F, act, st);
  else
    err = launch_up<__nv_bfloat16, __nv_bfloat16>(x, counts, w1, w3, mid, EG,
                                                  G, c, M, F, act, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w_dtype == 0)
    err = launch_down<float>(mid, counts, w2, y, y_dtype, EG, G, c, M, F, st);
  else
    err = launch_down<__nv_bfloat16>(mid, counts, w2, y, y_dtype, EG, G, c,
                                     M, F, st);
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
