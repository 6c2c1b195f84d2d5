// Flash attention (forward) for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel), the Pallas TPU kernel: causal and/or sliding-window GQA
// attention over q (B, Lq, H, hd) and k, v (B, Lk, K, hd), H % K == 0.  q is
// scaled in f32 before the dot; the online softmax keeps f32 m, l and acc,
// starting from m = -1e30; masked scores are the FINITE -1e30; the output is
// acc / max(l, 1e-30) in q's dtype.  Positions of q and k both count from 0,
// so when Lq != Lk they align at the top.
//
// What bounds it on an H100: operations.  A causal call does about
// 4 * B * H * Lq * Lk * hd / 2 flops on (B * (Lq * H + 2 * Lk * K) * hd)
// elements read once: at the training shapes (L = 1024..2048, hd 64..128)
// hundreds of flops per byte, far above the f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte).  The floor is the f32 FMA rate.
//
// Design (simple and right first): one 256-thread block per (q tile of 64
// rows, head, batch row).  The TPU's sequential kv grid axis becomes a loop
// over 64-row KV tiles inside the block; (m, l, acc) stay in registers
// across it.  The q tile (scaled) and each K tile are staged transposed in
// shared memory and V row-major, all as f32 (bf16 is converted on load), and
// each thread computes a 4 x 4 block of the 64 x 64 score tile with float4
// shared-memory reads, so every smem load feeds 8 FMAs.  The probability
// tile goes back through shared memory for the P @ V product, where each
// thread owns 4 rows x hd/16 columns of the accumulator.  K/V are read in
// their native (B, L, K, hd) layout at kv head h / (H / K): no repeat is
// ever written.  Under the causal mask the loop stops after the last tile
// the q tile can see; under the window mask it starts at the first one.
// Query tiles are launched heaviest first.  Deterministic: no atomics, no
// cross-block reduction.  Tensor cores (wgmma), TMA and cp.async pipelining
// are later work.
//
// The finite mask is load-bearing: when a row's first visited tile is fully
// masked, exp(-1e30 - -1e30) = 1 accumulates garbage that the next real tile
// wipes through corr = exp(-1e30 - m) = 0, exactly as the TPU kernel does;
// with -INFINITY that path gives NaN.  Columns past Lk (a ragged last tile;
// the TPU kernel halves its block instead) do not exist at all: they score
// -INFINITY, which the finite running max turns into probability 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per KV tile
constexpr int kThreads = 256;  // 16 x 16: a 4 x 4 score block each
constexpr int kPad = 4;        // smem row padding, keeps float4 alignment
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's astype
}

template <int HD>
struct Smem {  // sizes in floats
  static constexpr int kQt = HD * (kBQ + kPad);  // [HD][kBQ + kPad]
  static constexpr int kKt = HD * (kBK + kPad);  // [HD][kBK + kPad]
  static constexpr int kV = kBK * HD;            // [kBK][HD]
  static constexpr int kPt = kBK * (kBQ + kPad); // [kBK][kBQ + kPad]
  static constexpr size_t kBytes = sizeof(float) * (kQt + kKt + kV + kPt);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Lq,
                  int Lk, int H, int K, float scale, int causal,
                  int window) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + Smem<HD>::kQt;
  float* Vs = Kt + Smem<HD>::kKt;
  float* Pt = Vs + Smem<HD>::kV;
  constexpr int kQs = kBQ + kPad;
  constexpr int kKs = kBK + kPad;
  constexpr int kCols = HD / 64;  // float4 groups of output columns

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx*4.., output columns 64c+tx*4..
  const int ty = tid >> 4;  // rows ty*4..ty*4+3

  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(K) * HD;
  const T* qb = q + static_cast<size_t>(b) * Lq * q_row +
                static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * Lk * kv_row +
                        static_cast<size_t>(h / (H / K)) * HD;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int qp = q0 + r;
    Qt[d * kQs + r] = qp < Lq ? to_f32(qb[qp * q_row + d]) * scale : 0.f;
  }

  const int n_kt = (Lk + kBK - 1) / kBK;
  int kt_begin = 0, kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (min(q0 + kBQ, Lq) - 1) / kBK + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;
  if (kt_begin >= kt_end) {  // no row sees a key: visit all, as the TPU does
    kt_begin = 0;
    kt_end = n_kt;
  }

  float m[4], l[4], acc[4][4 * kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's reads are done (Qt is visible)
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int kp = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kp < Lk) {
        kv = to_f32(kb[kp * kv_row + d]);
        vv = to_f32(vb[kp * kv_row + d]);
      }
      Kt[d * kKs + c] = kv;
      Vs[c * HD + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * kQs + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * kKs + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        float sv = s[i][j];
        if (kp >= Lk) {
          sv = -INFINITY;
        } else if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) {
          sv = kMask;
        }
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      // the 16 lanes of a half warp share row i
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + rs;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kQs + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * kCols; ++c) acc[i][c] *= corr[i];
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + c * kQs + ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        const float4 va =
            *reinterpret_cast<const float4*>(Vs + c * HD + g * 64 + tx * 4);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][g * 4 + j] = fmaf(pv[i], vv[j], acc[i][g * 4 + j]);
      }
    }
  }

  T* ob = out + static_cast<size_t>(b) * Lq * q_row +
          static_cast<size_t>(h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < kCols; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(ob + qp * q_row + g * 64 + tx * 4 + j, acc[i][g * 4 + j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Lq, int Lk, int H, int K, float scale, int causal, int window,
           cudaStream_t s) {
  auto kern = flash_attn_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<HD>::kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, Smem<HD>::kBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, H, K, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Lq, H, hd); k, v: (B, Lk, K, hd); out: (B, Lq, H, hd); all
// contiguous, one dtype (0 = float32, 1 = bfloat16).  hd is 64 or 128.
// causal: 0 or 1; window: 0 for none, else the sliding window in tokens.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Lq,
                                     int Lk, int H, int K, int hd,
                                     float scale, int causal, int window,
                                     int dtype, void* stream) {
  if (B <= 0 || Lq <= 0) return static_cast<int>(cudaSuccess);
  if (Lk <= 0 || H <= 0 || K <= 0 || H % K != 0 || B > 65535 || H > 65535 ||
      window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, out, B, Lq, Lk, H, K, scale, causal,
                             window, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, out, B, Lq, Lk, H, K, scale, causal,
                              window, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, Lq, Lk, H, K, scale,
                                     causal, window, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, Lq, Lk, H, K, scale,
                                      causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
