// Dropless grouped expert FFN (fused dispatch -> FFN -> combine) for Hopper
// (sm_90a), plain C interface (loaded with ctypes).
//
// Replaces: src/repro/kernels/expert_ffn_grouped.py::expert_ffn_grouped
// (_fused_kernel), the Pallas TPU single-device megakernel: gather each
// expert's routed token rows, run act(x @ w1) [* (x @ w3)] @ w2 in f32, and
// return the gate-weighted sum of each token's k expert outputs, with the
// optional bf16 wire round-trip at the two pool boundaries.
//
// What bounds it on an H100: memory, at every serving shape.  The op reads
// every routed expert's weights once (3 * M * F elements per hit expert) and
// does 2 * 3 * rows * M * F flops on them, i.e. about rows_per_expert / 2
// flop/byte in f32.  Decode (8 tokens x top-8) touches at most 64 of 128
// experts with ~1 row each and a 512-token prefill ~32 rows each: both far
// below the f32 ridge (~20 flop/byte), so the floor is the hit experts'
// weight bytes at 3.35 TB/s.
//
// Design (a simple, right kernel first; wgmma/TMA/cp.async come later):
//   * The routed-row metadata (slot -> token row, routed rows per expert) is
//     built on the device in torch by the wrapper.  Slots of an expert are
//     contiguous from 0 (GShard slot priority), so `counts` are ragged group
//     sizes.
//   * up:   grid (F/64, ceil(cap/16), E).  A block whose 16-row tile lies
//           past the expert's routed count returns before touching memory,
//           so unrouted experts' weights are never read.  Live blocks gather
//           their rows by id (pad and unrouted rows are skipped, never
//           multiplied by a zero weight, so NaN rows cannot leak), stream
//           32-deep slabs of w1/w3 through shared memory and keep
//           4 rows x 1 column of f32 accumulators per thread.  Epilogue:
//           act(h1) [* h3] into an f32 (E*cap, F) scratch.
//   * down: grid (M/64, ceil(cap/16), E), the same tiling over w2, with the
//           wire round-trip in the epilogue, into an f32 (E*cap, M) scratch.
//   * combine: one block row per token sums its k choices in choice order
//           (as moe_combine_ref) and casts to x's dtype.  Dropped choices
//           are skipped.
// No float atomics anywhere and every output row is a fixed-order sum over
// its own inputs: the result is deterministic and independent of which
// other tokens share a tile (the serving engine's batch-independence rests
// on this).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBT = 16;        // routed rows per tile
constexpr int kBN = 64;        // output columns per block
constexpr int kBK = 32;        // reduction depth per shared-memory slab
constexpr int kThreads = 256;  // kBN columns x 4 row groups
constexpr int kRowsPerThread = kBT / (kThreads / kBN);
constexpr int kCombineThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// The fused wire codec: a round trip through bf16 (round to nearest even).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// act: 0 = silu, 1 = gelu in its tanh form (jax.nn.gelu's default).
__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return v / (1.f + expf(-v));
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
}

template <typename TX, typename TW, bool kGlu>
__global__ void __launch_bounds__(kThreads)
grouped_up_kernel(const TX* __restrict__ x, const int* __restrict__ rid,
                  const int* __restrict__ counts, const TW* __restrict__ w1,
                  const TW* __restrict__ w3, float* __restrict__ mid, int S,
                  int M, int F, int cap, int act, int wire) {
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kBT;
  const int cnt = min(counts[e], cap);
  if (r0 >= cnt) return;  // ragged: empty (expert, row tile) pairs skipped
  const int nrows = min(kBT, cnt - r0);
  const int f0 = blockIdx.x * kBN;

  __shared__ int src[kBT];
  __shared__ float xs[kBT][kBK + 1];
  __shared__ float w1s[kBK][kBN];
  __shared__ float w3s[kGlu ? kBK : 1][kBN];

  const int tid = threadIdx.x;
  if (tid < kBT) {
    int id = -1;
    if (tid < nrows) {
      const int v = rid[static_cast<size_t>(e) * cap + r0 + tid];
      if (v >= 0 && v < S) id = v;
    }
    src[tid] = id;
  }
  __syncthreads();

  const int col = tid % kBN;
  const int rg = tid / kBN;
  float a1[kRowsPerThread];
  float a3[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) a1[j] = a3[j] = 0.f;
  const size_t wbase = static_cast<size_t>(e) * M * F;

  for (int k0 = 0; k0 < M; k0 += kBK) {
    for (int i = tid; i < kBT * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK, m = k0 + kk, id = src[r];
      float v = 0.f;
      if (id >= 0 && m < M) {
        v = to_f32(x[static_cast<size_t>(id) * M + m]);
        if (wire) v = bf16_round(v);
      }
      xs[r][kk] = v;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN, m = k0 + kk, f = f0 + c;
      const bool ok = m < M && f < F;
      const size_t off = wbase + static_cast<size_t>(m) * F + f;
      w1s[kk][c] = ok ? to_f32(w1[off]) : 0.f;
      if constexpr (kGlu) w3s[kk][c] = ok ? to_f32(w3[off]) : 0.f;
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
      mid[(static_cast<size_t>(e) * cap + r0 + r) * F + f] = h;
    }
  }
}

template <typename TW>
__global__ void __launch_bounds__(kThreads)
grouped_down_kernel(const float* __restrict__ mid,
                    const int* __restrict__ counts, const TW* __restrict__ w2,
                    float* __restrict__ hbuf, int M, int F, int cap,
                    int wire) {
  const int e = blockIdx.z;
  const int r0 = blockIdx.y * kBT;
  const int cnt = min(counts[e], cap);
  if (r0 >= cnt) return;
  const int nrows = min(kBT, cnt - r0);
  const int m0 = blockIdx.x * kBN;

  __shared__ float hs[kBT][kBK + 1];
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int col = tid % kBN;
  const int rg = tid / kBN;
  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;
  const size_t row0 = static_cast<size_t>(e) * cap + r0;
  const size_t wbase = static_cast<size_t>(e) * F * M;

  for (int k0 = 0; k0 < F; k0 += kBK) {
    for (int i = tid; i < kBT * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK, fk = k0 + kk;
      hs[r][kk] = (r < nrows && fk < F) ? mid[(row0 + r) * F + fk] : 0.f;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int kk = i / kBN, c = i % kBN, fk = k0 + kk, m = m0 + c;
      ws[kk][c] = (fk < F && m < M)
                      ? to_f32(w2[wbase + static_cast<size_t>(fk) * M + m])
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

  const int m = m0 + col;
  if (m >= M) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = rg * kRowsPerThread + j;
    if (r < nrows) {
      const float v = wire ? bf16_round(acc[j]) : acc[j];
      hbuf[(row0 + r) * M + m] = v;
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

template <typename TX, typename TW>
cudaError_t launch_up(const void* x, const int* rid, const int* counts,
                      const void* w1, const void* w3, float* mid, int S, int M,
                      int F, int E, int cap, int act, int wire,
                      cudaStream_t st) {
  const dim3 grid((F + kBN - 1) / kBN, (cap + kBT - 1) / kBT, E);
  if (w3 != nullptr) {
    grouped_up_kernel<TX, TW, true><<<grid, kThreads, 0, st>>>(
        static_cast<const TX*>(x), rid, counts, static_cast<const TW*>(w1),
        static_cast<const TW*>(w3), mid, S, M, F, cap, act, wire);
  } else {
    grouped_up_kernel<TX, TW, false><<<grid, kThreads, 0, st>>>(
        static_cast<const TX*>(x), rid, counts, static_cast<const TW*>(w1),
        nullptr, mid, S, M, F, cap, act, wire);
  }
  return cudaGetLastError();
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16; y has x's dtype.  w3 may be
// null (2-layer experts).  act: 0 = silu, 1 = gelu (tanh).  wire: 0 = f32,
// 1 = bf16 round trip.  rid (E*cap) and counts (E) come from the wrapper's
// slot metadata; mid (E*cap, F) and hbuf (E*cap, M) are f32 scratch.
// Returns the first cudaError_t of the three launches (0 on success).
extern "C" int repro_expert_ffn_grouped(
    const void* x, int x_dtype, const int* flat, const float* weights,
    const int* rid, const int* counts, const void* w1, const void* w3,
    const void* w2, int w_dtype, float* mid, float* hbuf, void* y, int S,
    int k, int M, int F, int E, int cap, int act, int wire, void* stream) {
  if (S <= 0 || M <= 0) return static_cast<int>(cudaSuccess);
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1 || E <= 0 ||
      cap <= 0 || F <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  if (x_dtype == 0 && w_dtype == 0)
    err = launch_up<float, float>(x, rid, counts, w1, w3, mid, S, M, F, E, cap,
                                  act, wire, st);
  else if (x_dtype == 0)
    err = launch_up<float, __nv_bfloat16>(x, rid, counts, w1, w3, mid, S, M, F,
                                          E, cap, act, wire, st);
  else if (w_dtype == 0)
    err = launch_up<__nv_bfloat16, float>(x, rid, counts, w1, w3, mid, S, M, F,
                                          E, cap, act, wire, st);
  else
    err = launch_up<__nv_bfloat16, __nv_bfloat16>(x, rid, counts, w1, w3, mid,
                                                  S, M, F, E, cap, act, wire,
                                                  st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 dgrid((M + kBN - 1) / kBN, (cap + kBT - 1) / kBT, E);
  if (w_dtype == 0)
    grouped_down_kernel<float><<<dgrid, kThreads, 0, st>>>(
        mid, counts, static_cast<const float*>(w2), hbuf, M, F, cap, wire);
  else
    grouped_down_kernel<__nv_bfloat16><<<dgrid, kThreads, 0, st>>>(
        mid, counts, static_cast<const __nv_bfloat16*>(w2), hbuf, M, F, cap,
        wire);
  err = cudaGetLastError();
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
