// MoE dispatch (token -> capacity-slot scatter) and combine (gate-weighted
// gather back to tokens) for Hopper (sm_90a), plain C interface (loaded
// with ctypes).
//
// Replaces: src/repro/kernels/moe_dispatch.py::moe_dispatch
// (_dispatch_kernel) and ::moe_combine (_combine_kernel), the Pallas TPU
// kernels that keep the whole (n_slots, M) capacity buffer in VMEM and walk
// the token stream over a sequential grid.
//
//   dispatch: buf[flat[s, j]] += x[s] for every token s and choice j; slot
//             n_slots is the drop sentinel (skipped).  The buffer is zeroed
//             first (cudaMemsetAsync), then one thread per (token, column)
//             adds its value into each of the token's k slots with
//             atomicAdd.  The gate never gives two choices one slot, so
//             every slot receives at most one value and 0 + v == v: the
//             result is exact and deterministic.  The op's contract still
//             sums duplicate slots; those sums are taken in an undefined
//             order (atomics), so duplicates are exact only up to the
//             order of a floating-point sum.
//   combine:  y[s] = sum_j w[s, j] * buf[flat[s, j]], one FMA chain per
//             output in choice order j = 0..k-1, in f32, then cast to the
//             buffer's dtype.  Each weight is first rounded to the buffer's
//             dtype, as the plain version casts it.  A dropped choice adds
//             nothing.  No atomics: deterministic and row-independent.
//
// What bounds them on an H100: memory.  Neither does more than one FMA per
// element moved.  Dispatch must read x (S x M) and write the buffer
// (n_slots x M, zero rows included); combine reads k gathered rows per
// token and writes S x M.  The design reads each token row once per
// choice through the L2 and keeps neighbouring threads on neighbouring
// columns (coalesced rows); vector loads and a slot-sorted order are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dispatch_kernel(const T* __restrict__ x, const int* __restrict__ flat,
                T* __restrict__ buf, int k, int M, int n_slots) {
  const int s = blockIdx.x;
  const int m = blockIdx.y * kThreads + threadIdx.x;
  if (m >= M) return;
  const T v = x[static_cast<size_t>(s) * M + m];
  for (int j = 0; j < k; ++j) {
    const int slot = flat[static_cast<size_t>(s) * k + j];
    if (slot < 0 || slot >= n_slots) continue;  // drop sentinel
    atomicAdd(buf + static_cast<size_t>(slot) * M + m, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ buf, const int* __restrict__ flat,
               const float* __restrict__ weights, T* __restrict__ y, int k,
               int M, int n_slots) {
  const int s = blockIdx.x;
  const int m = blockIdx.y * kThreads + threadIdx.x;
  if (m >= M) return;
  float acc = 0.f;
  for (int j = 0; j < k; ++j) {
    const size_t sj = static_cast<size_t>(s) * k + j;
    const int slot = flat[sj];
    if (slot < 0 || slot >= n_slots) continue;  // dropped: adds nothing
    const float w = to_f32(from_f32<T>(weights[sj]));
    acc = fmaf(w, to_f32(buf[static_cast<size_t>(slot) * M + m]), acc);
  }
  y[static_cast<size_t>(s) * M + m] = from_f32<T>(acc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and buf share it).  x (S, M), flat
// (S, k) int32, buf (n_slots, M).  Returns the first cudaError_t (0 on
// success).
extern "C" int repro_moe_dispatch(const void* x, int dtype, const int* flat,
                                  void* buf, int S, int k, int M, int n_slots,
                                  void* stream) {
  if (dtype < 0 || dtype > 1 || S < 0 || k <= 0 || M <= 0 || n_slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16);
  cudaError_t err = cudaMemsetAsync(
      buf, 0, static_cast<size_t>(n_slots) * M * es, st);
  if (err != cudaSuccess || S == 0) return static_cast<int>(err);
  const dim3 grid(S, (M + kThreads - 1) / kThreads);
  if (dtype == 0)
    dispatch_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), flat, static_cast<float*>(buf), k, M,
        n_slots);
  else
    dispatch_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), flat,
        static_cast<__nv_bfloat16*>(buf), k, M, n_slots);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (buf and y share it).  buf (n_slots, M),
// flat (S, k) int32, weights (S, k) float32, y (S, M).
extern "C" int repro_moe_combine(const void* buf, int dtype, const int* flat,
                                 const float* weights, void* y, int S, int k,
                                 int M, int n_slots, void* stream) {
  if (dtype < 0 || dtype > 1 || S < 0 || k <= 0 || M <= 0 || n_slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(S, (M + kThreads - 1) / kThreads);
  if (dtype == 0)
    combine_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(buf), flat, weights, static_cast<float*>(y),
        k, M, n_slots);
  else
    combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(buf), flat, weights,
        static_cast<__nv_bfloat16*>(y), k, M, n_slots);
  return static_cast<int>(cudaGetLastError());
}
