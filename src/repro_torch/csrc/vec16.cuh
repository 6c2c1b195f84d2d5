// Row access in 16-byte vectors for the port's memory-bound kernels
// (csrc/rmsnorm.cu, csrc/moe_dispatch.cu), with the scalar access of the
// same interface for rows the vectors cannot take.
//
// An access of W elements of T goes through float registers: load<T, W>
// widens W elements (exactly: bf16 -> f32 is exact) and store<T, W>
// narrows W floats (round to nearest even, as XLA's astype); load_bits
// and element split a load in two.  W == 1 is one scalar access; W ==
// kVec<T> (4 f32 or 8 bf16) is one 16-byte ld.global.v4 / st.global.v4
// and needs a 16-byte-aligned address.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro {

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// True when every pointer starts on a 16-byte boundary.
__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}
template <typename... P>
__host__ __forceinline__ bool aligned16(const void* p, P... rest) {
  return aligned16(p) && aligned16(rest...);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int W>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = widen(*p);
  } else {
    static_assert(W == kVec<T>, "a vector access is 16 bytes");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        f[i] = __uint_as_float(w[i]);
      } else {  // two bf16 per word, the lower address in the low half
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// load in two, for a kernel that keeps many loads in flight as loaded
// words and widens each element where it uses it: the words holding W
// elements' bits (one 16-byte vector, or one element in the low bits of
// one word) ...
template <int W>
constexpr int kWords = W == 1 ? 1 : 4;

// ... loaded from p.
template <typename T, int W>
__device__ __forceinline__ void load_bits(const T* __restrict__ p,
                                          uint32_t (&b)[kWords<W>]) {
  if constexpr (W == 1) {
    using U = std::conditional_t<sizeof(T) == 4, uint32_t, unsigned short>;
    b[0] = *reinterpret_cast<const U*>(p);
  } else {
    static_assert(W == kVec<T>, "a vector access is 16 bytes");
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    b[0] = r.x;
    b[1] = r.y;
    b[2] = r.z;
    b[3] = r.w;
  }
}

// Element e of those words, widened to float (exactly), as load widens it.
template <typename T, int W>
__device__ __forceinline__ float element(const uint32_t (&b)[kWords<W>],
                                         int e) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(b[e]);
  else if constexpr (W == 1)
    return __uint_as_float(b[0] << 16);
  else  // two bf16 per word, the lower address in the low half
    return __uint_as_float(e % 2 ? b[e / 2] & 0xffff0000u : b[e / 2] << 16);
}

// kStream: the streaming (evict-first) cache hint, for an output this
// kernel never reads back, to keep what it does re-read in L2.
template <typename T, int W, bool kStream = false>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[W]) {
  if constexpr (W == 1) {
    if constexpr (kStream)
      __stcs(p, narrow<T>(f[0]));
    else
      *p = narrow<T>(f[0]);
  } else {
    static_assert(W == kVec<T>, "a vector access is 16 bytes");
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        w[i] = __float_as_uint(f[i]);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    const uint4 r = make_uint4(w[0], w[1], w[2], w[3]);
    if constexpr (kStream)
      __stcs(reinterpret_cast<uint4*>(p), r);
    else
      *reinterpret_cast<uint4*>(p) = r;
  }
}

}  // namespace repro
