// RMSNorm for Hopper (sm_90a), plain C interface (loaded with ctypes).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (_rmsnorm_kernel), the
// Pallas TPU kernel: out = x * rsqrt(mean(x^2) + eps) * scale, statistics in
// f32, output in x's dtype.
//
// What bounds it on an H100: memory.  Each element is read once and written
// once and costs ~4 flops, about 0.5 flop/byte in f32 against a ridge of
// ~20 flop/byte (67 TFLOP/s f32 / 3.35 TB/s), so the floor is the bytes.  At
// the serving path's shapes (8..512 rows of 2048) the op is a few hundred KB
// and launch latency dominates.
//
// Design: one 256-thread block per row.  Pass 1 sums squares in f32 with
// coalesced strided loads and a warp-shuffle + shared-memory reduction; pass 2
// re-reads the row (an L1/L2 hit: a 2048-wide f32 row is 8 KB) and writes the
// scaled result, so device memory sees each byte once.  No atomics: the sum
// order is fixed, so a row's result depends on that row alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's astype
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);

  __shared__ float part[kThreads / 32];
  __shared__ float inv;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) t += part[w];
    inv = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < d; i += kThreads) {
    store(orow + i, to_f32(xr[i]) * inv * scale[i]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out); scale is always float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_rmsnorm(const void* x, const float* scale, void* out,
                             int rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), scale, static_cast<float*>(out), d, eps);
  } else if (dtype == 1) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale,
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
