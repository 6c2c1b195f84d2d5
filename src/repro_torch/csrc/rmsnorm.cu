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
// Design: 256-thread blocks, two paths chosen by the host.
//
//   vector (rows of a multiple of 16 bytes, every pointer 16-byte aligned,
//   at most 8 vectors per thread at 256 threads per row): TPR threads per
//   row (32..256, about four 16-byte vectors each; 256 / TPR rows per
//   block).  Each thread loads its vectors c = t, t + TPR, ... of the row
//   once, into registers, and sums their squares in a fixed order (vector
//   by vector, element by element); a warp-shuffle tree, and the row's
//   warps' partial sums added in warp order through shared memory, give
//   the row's sum; the thread then scales the values it holds and stores
//   them as vectors.  At D 2048 f32 that is 128 threads and four float4
//   per thread, two rows per block: the row is read once and never
//   re-read.  (One 256-thread row, two float4 each, measured 10.8 us for
//   qwen3's 2048 x 2048 step against 8.8 at 128 threads, 9.0 at 64 and
//   10.2 at 32, by launch/kernel_times.py on one H100.)
//
//   scalar (any other row): one block per row; pass 1 sums squares with
//   strided 4-byte loads, pass 2 re-reads the row (an L1/L2 hit) and
//   writes the result.
//
// No atomics and no cross-row state: a row's result depends on that row and
// D alone (never on the number of rows), so batching never changes bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "vec16.cuh"

namespace {

using repro::kVec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecsPerThread = 4;  // vector path: the aim per thread
constexpr int kMaxVecs = 8;        // and the most (at 256 per row)

// The sum of the partial sums ss of a row's TPR threads, in every one of
// them: a fixed shuffle tree per warp, then the row's warps' sums added in
// warp order through shared memory.  Every thread of the block calls it.
template <int TPR>
__device__ __forceinline__ float row_sum(float ss) {
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (TPR > 32) {
    __shared__ float part[kWarps];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int w0 = (threadIdx.x / TPR) * (TPR / 32);
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) ss += part[w0 + w];
  }
  return ss;
}

template <typename T, int NV, int TPR>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int rows, int d, float eps) {
  constexpr int W = kVec<T>;
  constexpr int kRows = kThreads / TPR;
  const int nvec = d / W;
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * kRows + threadIdx.x / TPR;
  const bool live = row < rows;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* orow = out + static_cast<size_t>(row) * d;

  float v[NV][W];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * TPR;
    if (live && c < nvec) {
      repro::load<T, W>(xr + c * W, v[i]);
#pragma unroll
      for (int e = 0; e < W; ++e) ss = fmaf(v[i][e], v[i][e], ss);
    }
  }
  const float inv = rsqrtf(row_sum<TPR>(ss) / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * TPR;
    if (live && c < nvec) {
      float o[W];
#pragma unroll
      for (int h = 0; h < W; h += 4) {  // scale is f32: W / 4 float4 loads
        const float4 s = *reinterpret_cast<const float4*>(scale + c * W + h);
        o[h] = v[i][h] * inv * s.x;
        o[h + 1] = v[i][h + 1] * inv * s.y;
        o[h + 2] = v[i][h + 2] * inv * s.z;
        o[h + 3] = v[i][h + 3] * inv * s.w;
      }
      repro::store<T, W>(orow + c * W, o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      T* __restrict__ out, int d, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::widen(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float inv =
      rsqrtf(row_sum<kThreads>(ss) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    orow[i] = repro::narrow<T>(repro::widen(xr[i]) * inv * scale[i]);
}

// The vector path for rows of d elements of W per vector at these
// addresses: threads per row (the least power of two from 32 to 256 that
// gives at most kVecsPerThread vectors each, measured fastest at qwen3's
// 2048-wide f32 rows) and vectors per thread (a power of two up to
// kMaxVecs), or {0, 0} for the scalar path.
struct VecPath {
  int tpr, nv;
};
VecPath vec_path(int d, int W, const void* x, const void* scale,
                 const void* out) {
  if (d % W || !repro::aligned16(x, scale, out)) return {0, 0};
  const int nvec = d / W;
  int tpr = 32;
  while (tpr < kThreads && tpr * kVecsPerThread < nvec) tpr *= 2;
  int nv = 1;
  while (nv < kMaxVecs && nv * tpr < nvec) nv *= 2;
  if (nv * tpr < nvec) return {0, 0};
  return {tpr, nv};
}

template <typename T>
cudaError_t launch(const T* x, const float* scale, T* out, int rows, int d,
                   float eps, cudaStream_t s) {
  const VecPath p = vec_path(d, kVec<T>, x, scale, out);
  const auto go = [&](auto kernel, int rows_per_block) {
    const int grid = (rows + rows_per_block - 1) / rows_per_block;
    kernel<<<grid, kThreads, 0, s>>>(x, scale, out, rows, d, eps);
  };
  switch (p.tpr * 100 + p.nv) {  // every (tpr, nv) that vec_path gives
    case 3201: go(rmsnorm_vec_kernel<T, 1, 32>, 8); break;
    case 3202: go(rmsnorm_vec_kernel<T, 2, 32>, 8); break;
    case 3204: go(rmsnorm_vec_kernel<T, 4, 32>, 8); break;
    case 6404: go(rmsnorm_vec_kernel<T, 4, 64>, 4); break;
    case 12804: go(rmsnorm_vec_kernel<T, 4, 128>, 2); break;
    case 25604: go(rmsnorm_vec_kernel<T, 4, 256>, 1); break;
    case 25608: go(rmsnorm_vec_kernel<T, 8, 256>, 1); break;
    default:
      rmsnorm_scalar_kernel<T><<<rows, kThreads, 0, s>>>(x, scale, out, d,
                                                         eps);
  }
  return cudaGetLastError();
}

}  // namespace

// The arguments of one call, packed by the wrapper in this order and
// layout (Python struct format "PPPPiiif": one ctypes argument costs the
// host far less than eight).  dtype: 0 = float32, 1 = bfloat16 (x and out);
// scale is always float32.
struct RmsnormArgs {
  const void* x;
  const float* scale;
  void* out;
  void* stream;
  int rows, d, dtype;
  float eps;
};
static_assert(sizeof(RmsnormArgs) == 48, "the wrapper packs 48 bytes");

// Returns the cudaError_t of the launch (0 on success; 0 rows launch
// nothing).
extern "C" int repro_rmsnorm(const void* packed) {
  RmsnormArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.rows <= 0 || a.d <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(a.stream);
  if (a.dtype == 0)
    return static_cast<int>(launch(static_cast<const float*>(a.x), a.scale,
                                   static_cast<float*>(a.out), a.rows, a.d,
                                   a.eps, s));
  if (a.dtype == 1)
    return static_cast<int>(
        launch(static_cast<const __nv_bfloat16*>(a.x), a.scale,
               static_cast<__nv_bfloat16*>(a.out), a.rows, a.d, a.eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The path rows of d elements of dtype at these addresses take: threads
// per row and vectors per thread of the vector path, or 0 and 0 for the
// scalar path.  Launches nothing (for the tests).
extern "C" void repro_rmsnorm_path(const void* x, const float* scale,
                                   const void* out, int d, int dtype,
                                   int* tpr, int* nv) {
  const VecPath p = vec_path(
      d, dtype == 0 ? kVec<float> : kVec<__nv_bfloat16>, x, scale, out);
  *tpr = p.tpr;
  *nv = p.nv;
}
