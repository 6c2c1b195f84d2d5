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
// 3.35 TB/s = 20 flop/byte).  The floor is the f32 FMA rate.  No tensor
// cores: the reference is f32, and TF32 (10 mantissa bits) or bf16 inputs
// would be a precision decision the JAX package never makes.
//
// Design: one 256-thread block per (query tile, head, batch row), launched
// heaviest query tile first over all heads and batch rows; (m, l, acc)
// stay in registers across the loop over KV tiles.
//   * Tiles: 128 query rows x 64 keys.  Thread (ty, tx) = (t / 16, t % 16)
//     owns query rows ty + 16 i and keys tx + 16 j of the score tile (an
//     8 x 4 block), and the same rows x head-dim columns tx * 4 + 64 g of
//     acc (8 x 4 at hd 64, 8 x 8 at hd 128).  At hd 128, 64 x 128 tiles (a
//     4 x 8 block) measured slower at qwen3's shape: the 8-row block feeds
//     P @ V 16 FMAs per shared load instead of 10.7.
//   * Q (scaled by scale * log2(e), as f32) sits row-major in shared memory,
//     each row padded by 16 bytes, for the whole kernel.  K and V stream
//     through a ring of 64-deep slabs: a K slab is all keys of the tile x
//     64 head dims (row-major, padded rows), a V slab the 64 keys x all
//     head dims (so 2 slabs per tile at hd 64, 3 at hd 128; 32-deep slabs
//     measured slower, their extra barriers idling the warps).  The ring
//     of 3 slots is filled with 16-byte cp.async.cg copies, raw (bf16 stays
//     bf16 and is widened on the shared-to-register read); keys past Lk are
//     zero-filled.  Two slabs are in flight while one computes.
//   * S = Q K^T reads Q and K rows as four head dims per load: per four
//     head dims a thread issues 12 shared loads for 128 FMAs.  The warp's
//     two Q rows fall in different banks; its 16 K rows are one conflict-
//     free pair of 128-byte wavefronts.  P goes to shared memory (rows
//     padded to 16 banks, so a warp's two 16-float row segments never
//     collide) and P @ V reads it and V four keys / columns per load.
//   * Softmax in base 2: log2(e) is folded into the scale, p = exp2f(s - m).
//     Row maxima are reduced over the 16 lanes that share a row; row sums
//     stay per thread and are reduced once at the end.  The mask is applied
//     only on tiles that cross the causal diagonal, the window edge or Lk;
//     interior tiles skip it.
// K/V are read in their native (B, L, K, hd) layout at kv head h / (H / K):
// no repeat is ever written.  Under the causal mask the loop stops after the
// last tile the query tile can see; under the window mask it starts at the
// first one.  Deterministic: no atomics, no cross-block reduction.
//
// The finite mask is load-bearing: when a row's first visited tile is fully
// masked, exp2(-1e30 - -1e30) = 1 accumulates garbage that the next real
// tile wipes through corr = exp2(-1e30 - m) = 0, exactly as the TPU kernel
// does; with -INFINITY that path gives NaN.  Columns past Lk (a ragged last
// tile; the TPU kernel halves its block instead) do not exist at all: they
// score -INFINITY, which the finite running max turns into probability 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fma_tile.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ld4;
using repro::store;

constexpr int kThreads = 256;
constexpr int kBQ = 128;    // query rows per block
constexpr int kBKV = 64;    // keys per KV tile
constexpr int kSD = 64;     // slab depth: head dims of K, keys of V
constexpr int kStages = 3;  // ring slots
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int HD>
struct Smem {  // sizes in bytes
  static constexpr int kQS = HD + 4;          // Q row stride, floats
  static constexpr int kPS = kBKV + 16;       // P row stride, floats
  static constexpr int kE = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int kKS = kSD + kE;        // K slab row stride, elements
  static constexpr int kQ = kBQ * kQS * 4;
  static constexpr int kP = kBQ * kPS * 4;
  static constexpr int kKSlab = kBKV * kKS * sizeof(T);
  static constexpr int kVSlab = kSD * HD * sizeof(T);
  static constexpr int kSlab = kKSlab > kVSlab ? kKSlab : kVSlab;
  static constexpr int kBytes = kQ + kP + kStages * kSlab;
};

// Four elements of global memory as f32 (16-byte aligned for f32).
__device__ __forceinline__ float4 ldg4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  return ld4(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  store(p, v.x);
  store(p + 1, v.y);
  store(p + 2, v.z);
  store(p + 3, v.w);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Lq,
                  int Lk, int H, int K, float scale2, int causal,
                  int window) {
  using L = Smem<T, HD>;
  constexpr int kTM = kBQ / 16;      // query rows per thread
  constexpr int kTN = kBKV / 16;     // keys per thread
  constexpr int kG = HD / 64;        // float4 groups of acc columns
  constexpr int kNK = HD / kSD;      // K slabs per tile
  constexpr int kNS = kNK + kBKV / kSD;  // K and V slabs per tile
  constexpr int kQS = L::kQS, kPS = L::kPS, kKS = L::kKS, kE = L::kE;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ps = Qs + kBQ * kQS;
  char* ring = reinterpret_cast<char*>(Ps + kBQ * kPS);

  // heaviest query tile first, over every (head, batch row)
  const int n_qt = (Lq + kBQ - 1) / kBQ;
  const int hb = gridDim.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = static_cast<int>(blockIdx.x) % hb % H;
  const int b = static_cast<int>(blockIdx.x) % hb / H;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const size_t q_row = static_cast<size_t>(H) * HD;
  const size_t kv_row = static_cast<size_t>(K) * HD;
  const T* qb = q + static_cast<size_t>(b) * Lq * q_row +
                static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * Lk * kv_row +
                        static_cast<size_t>(h / (H / K)) * HD;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  const int n_kt = (Lk + kBKV - 1) / kBKV;
  int kt_begin = 0, kt_end = n_kt;
  if (causal) kt_end = min(n_kt, (min(q0 + kBQ, Lq) - 1) / kBKV + 1);
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBKV;
  if (kt_begin >= kt_end) {  // no row sees a key: visit all, as the TPU does
    kt_begin = 0;
    kt_end = n_kt;
  }
  const int n_slabs = (kt_end - kt_begin) * kNS;

  // slab n of the visit: part < kNK is K head dims [kSD part, +kSD), else
  // V keys [kSD (part - kNK), +kSD) of tile kt_begin + n / kNS
  auto issue = [&](int n) {
    T* dst = reinterpret_cast<T*>(ring + (n % kStages) * L::kSlab);
    const int part = n % kNS;
    const int k0 = (kt_begin + n / kNS) * kBKV;
    if (part < kNK) {
      constexpr int kCpr = kSD / kE;
#pragma unroll
      for (int c = tid; c < kBKV * kCpr; c += kThreads) {
        const int r = c / kCpr, d = part * kSD + (c % kCpr) * kE;
        const bool ok = k0 + r < Lk;
        cp_async16(dst + r * kKS + (c % kCpr) * kE,
                   ok ? kb + (k0 + r) * kv_row + d : kb, ok);
      }
    } else {
      constexpr int kCpr = HD / kE;
      const int c0 = k0 + (part - kNK) * kSD;
#pragma unroll
      for (int c = tid; c < kSD * kCpr; c += kThreads) {
        const int r = c / kCpr, d = (c % kCpr) * kE;
        const bool ok = c0 + r < Lk;
        cp_async16(dst + r * HD + d, ok ? vb + (c0 + r) * kv_row + d : vb,
                   ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slabs) issue(s);
    cp_async_commit();
  }

  // Q, scaled (in base 2) in f32, while the first slabs are in flight
  for (int i = tid; i < kBQ * HD / 4; i += kThreads) {
    const int r = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Lq) {
      val = ldg4(qb + (q0 + r) * q_row + d);
      val.x *= scale2;
      val.y *= scale2;
      val.z *= scale2;
      val.w *= scale2;
    }
    store4(Qs + r * kQS + d, val);
  }

  float m[kTM], l[kTM], s[kTM][kTN], acc[kTM][4 * kG];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kG; ++c) acc[i][c] = 0.f;
  }

  for (int n = 0; n < n_slabs; ++n) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slab n (and Q, P) visible; slot n - 1 is free
    if (n + kStages - 1 < n_slabs) issue(n + kStages - 1);
    cp_async_commit();
    const T* sl = reinterpret_cast<const T*>(ring + (n % kStages) * L::kSlab);
    const int part = n % kNS;

    if (part < kNK) {  // S += Q[:, d0:d0+kSD] K[:, d0:d0+kSD]^T
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
      }
      const float* qr = Qs + ty * kQS + part * kSD;
      const T* kr = sl + tx * kKS;
#pragma unroll
      for (int d = 0; d < kSD; d += 4) {
        float4 kf[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) kf[j] = ld4(kr + 16 * j * kKS + d);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float4 qf = ld4(qr + 16 * i * kQS + d);
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
            s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
            s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
            s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
          }
        }
      }
      if (part == kNK - 1) {  // the tile's scores are complete: softmax
        const int k0 = (kt_begin + n / kNS) * kBKV;
        const bool edge = k0 + kBKV > Lk ||
                          (causal && k0 + kBKV - 1 > q0) ||
                          (window > 0 && q0 + kBQ - 1 - k0 >= window);
        if (edge) {
#pragma unroll
          for (int i = 0; i < kTM; ++i) {
            const int qp = q0 + ty + 16 * i;
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
              const int kp = k0 + tx + 16 * j;
              if (kp >= Lk)
                s[i][j] = -INFINITY;
              else if ((causal && kp > qp) ||
                       (window > 0 && qp - kp >= window))
                s[i][j] = kMask;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          float mx = s[i][0];
#pragma unroll
          for (int j = 1; j < kTN; ++j) mx = fmaxf(mx, s[i][j]);
          // the 16 lanes of a half warp share row i
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[i], mx);
          const float corr = exp2f(m[i] - m_new);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            const float p = exp2f(s[i][j] - m_new);
            rs += p;
            Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
          }
          l[i] = l[i] * corr + rs;  // this thread's keys only
          m[i] = m_new;
#pragma unroll
          for (int c = 0; c < 4 * kG; ++c) acc[i][c] *= corr;
        }
      }
    } else {  // acc += P[:, c0:c0+kSD] V[c0:c0+kSD, :]
      const float* pr = Ps + ty * kPS + (part - kNK) * kSD;
      const T* vr = sl + tx * 4;
#pragma unroll
      for (int c = 0; c < kSD; c += 4) {
        float4 pf[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) pf[i] = ld4(pr + 16 * i * kPS + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            const float4 vf = ld4(vr + (c + cc) * HD + 64 * g);
#pragma unroll
            for (int i = 0; i < kTM; ++i) {
              const float p = repro::comp(pf[i], cc);
              acc[i][4 * g] = fmaf(p, vf.x, acc[i][4 * g]);
              acc[i][4 * g + 1] = fmaf(p, vf.y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(p, vf.z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(p, vf.w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
  }

  T* ob = out + static_cast<size_t>(b) * Lq * q_row +
          static_cast<size_t>(h) * HD;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const int qp = q0 + ty + 16 * i;
    if (qp >= Lq) continue;
    const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
    for (int g = 0; g < kG; ++g)
      store4(ob + qp * q_row + 64 * g + tx * 4,
             make_float4(acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
                         acc[i][4 * g + 2] / denom,
                         acc[i][4 * g + 3] / denom));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Lq, int Lk, int H, int K, float scale, int causal, int window,
           cudaStream_t s) {
  auto kern = flash_attn_kernel<T, HD>;
  constexpr int kBytes = Smem<T, HD>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n_qt = (Lq + kBQ - 1) / kBQ;
  const long long blocks = n_qt * H * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), kThreads, kBytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Lq, Lk, H, K,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Lq, H, hd); k, v: (B, Lk, K, hd); out: (B, Lq, H, hd); all
// contiguous and 16-byte aligned, one dtype (0 = float32, 1 = bfloat16).
// hd is 64 or 128.  causal: 0 or 1; window: 0 for none, else the sliding
// window in tokens.  Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Lq,
                                     int Lk, int H, int K, int hd,
                                     float scale, int causal, int window,
                                     int dtype, void* stream) {
  if (B <= 0 || Lq <= 0) return static_cast<int>(cudaSuccess);
  if (Lk <= 0 || H <= 0 || K <= 0 || H % K != 0 || window < 0)
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
