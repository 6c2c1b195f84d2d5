// Shared pieces of the port's f32 FMA kernels for Hopper (sm_90a):
// 16-byte cp.async copies with zero fill, shared-memory fragment loads that
// widen bf16 exactly, and the register-blocked GEMM mainloop of the expert
// FFN kernels (csrc/ffn_tile.cuh's up and down kernels).
//
// The mainloop computes, for one block of 256 threads, a BM x 128 tile of
// A (BM rows, K deep, row-major) times B (K rows, two 64-column segments,
// row-major).  Its contract is the one every expert FFN kernel of the port
// rests on: each output element is ONE fmaf chain over k in ascending
// order, starting from 0.f, over its own row of A and column of B.  No
// split-K, no second partial accumulator, no reassociation, and no fast
// math: the chain of an element is the same whatever BM, the thread tile,
// the ring depth, or the other rows that share its tile, so every instance
// gives the same bits, in the grouped, dense and ragged forms alike.
// K slabs past K are zero-filled, so they add fmaf(0, 0, acc) = acc.
//
// Layout.  Thread t is (ty, tx) = (t / 16, t % 16).  It owns A rows
// ty + 16 i (i < BM / 16) and B columns 64 g + tx * 4 .. + 3 of each
// segment g: acc[i][4 g .. 4 g + 3].  Row strides are chosen so that the
// two A rows a warp reads at one k lie in different banks (padded by one
// 16-byte chunk) and the 16 column groups it reads of a segment are one
// contiguous 256-byte run (no pad).  A is read as four k values per row
// per shared load, B as four columns per load: at BM 128 a thread issues
// 256 FMAs per 16 shared loads.  The segments come from one source (128
// columns of w1 or w2) or two (64 of w1 beside the same 64 of w3 under
// GLU).  (Four or eight segments per block, for longer runs of each weight
// row, measured slower at decode: fewer blocks.)
//
// The copy side: BK-deep slabs of A and B go through a ring of STAGES
// slots with 16-byte cp.async.cg (L2 only; the weights are streamed).
// STAGES - 1 slabs are in flight while one computes.  A rows are gathered
// straight from their source row pointers (the routed token rows); a dead
// row (nullptr) or a chunk past K, and a B chunk past its segment's
// columns or past K, is zero-filled by cp.async's src-size 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kTileThreads = 256;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's astype
}
// The fused wire codec: a round trip through bf16 (round to nearest even).
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 bytes global -> shared, asynchronously.  pred false reads nothing and
// zero-fills the destination; src must still be a valid global address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements (16-byte aligned for f32, 8 for bf16) as f32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

constexpr int kSegs = 2;  // 64-column segments of a B tile

// Shape of one mainloop instance (TA: A's element type, TB: B's).
template <typename TA, typename TB, int BM, int STAGES>
struct FmaTile {
  static_assert(BM % 16 == 0 && STAGES >= 2, "tile shape");
  static constexpr int kTM = BM / 16;            // A rows per thread
  static constexpr int kBN = 64 * kSegs;         // B tile columns
  static constexpr int kBK = 32;                 // slab depth
  static constexpr int kAE = 16 / sizeof(TA);    // A elements per chunk
  static constexpr int kBE = 16 / sizeof(TB);    // B elements per chunk
  static constexpr int kAStride = kBK + kAE;     // padded A row, elements
  static constexpr int kACpr = kBK / kAE;        // chunks per A row
  static constexpr int kAChunks = BM * kACpr;
  static constexpr int kAPer = (kAChunks + kTileThreads - 1) / kTileThreads;
  static constexpr int kBCps = 64 / kBE;         // chunks per segment row
  static constexpr int kBChunks = kBK * kSegs * kBCps;
  static constexpr int kBPer = kBChunks / kTileThreads;
  static_assert(kBChunks % kTileThreads == 0, "B slab split");
  static constexpr int kABytes = BM * kAStride * sizeof(TA);
  static constexpr int kBBytes = kBK * kBN * sizeof(TB);
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmemBytes = STAGES * kStageBytes;

  // Row of A that the thread's p-th copy chunk belongs to.
  __device__ static int chunk_row(int p) {
    return (static_cast<int>(threadIdx.x) + p * kTileThreads) / kACpr;
  }
};

// acc += A (BM x K) . B (K x 128) for one block; see the note at the top.
// Only the first LIVE 16-row groups are multiplied: a caller whose tile
// holds fewer live rows picks the smallest LIVE that covers them (the
// other rows' accumulators stay 0 and are never stored), so a partial tile
// costs FMAs by 16-row group, not by BM.
// a_row[p]: source row of the thread's p-th A chunk (nullptr: dead row,
// zero-filled); a_any: any valid A address (the zero-fill source).
// b_src[0], b_src[1]: the two B sources at k = 0 and the block's first
// column; segments 0 .. b_split - 1 are source 0's first 64 b_split
// columns, the rest source 1's.  ldb: both sources' row stride; b_cols[s]:
// source s's valid columns from the block's first one (a multiple of the
// chunk width; <= 0: none).
// round_a: round every A value through bf16 once it lands (the wire
// codec; a no-op for bf16 A, which is on the bf16 grid already).
// nrows: the tile's live rows; a warp whose rows all lie past it (its
// first row, 2 * warp, does) copies and waits but multiplies nothing.
template <typename TA, typename TB, int BM, int STAGES, int LIVE>
__device__ __forceinline__ void fma_mainloop(
    char* smem, const TA* const (&a_row)[FmaTile<TA, TB, BM, STAGES>::kAPer],
    const TA* a_any, const TB* const (&b_src)[2], int b_split, int ldb,
    const int (&b_cols)[2], int K, bool round_a, int nrows,
    float (&acc)[BM / 16][4 * kSegs]) {
  using T = FmaTile<TA, TB, BM, STAGES>;
  static_assert(LIVE >= 1 && LIVE <= T::kTM, "live row groups");
  constexpr int kBK = T::kBK;
  constexpr int kBN = T::kBN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int nk = (K + kBK - 1) / kBK;
  const bool active = 2 * (tid >> 5) < nrows;  // warp-uniform

  auto slot_a = [&](int s) {
    return reinterpret_cast<TA*>(smem + s * T::kStageBytes);
  };
  auto slot_b = [&](int s) {
    return reinterpret_cast<TB*>(smem + s * T::kStageBytes + T::kABytes);
  };
  auto load = [&](int kt) {
    const int s = kt % STAGES;
    const int k0 = kt * kBK;
    TA* as = slot_a(s);
    TB* bs = slot_b(s);
#pragma unroll
    for (int p = 0; p < T::kAPer; ++p) {
      const int c = tid + p * kTileThreads;
      if (T::kAChunks % kTileThreads == 0 || c < T::kAChunks) {
        const int row = c / T::kACpr;
        const int kc = (c % T::kACpr) * T::kAE;
        const bool ok = a_row[p] != nullptr && k0 + kc < K;
        cp_async16(as + row * T::kAStride + kc,
                   ok ? a_row[p] + k0 + kc : a_any, ok);
      }
    }
#pragma unroll
    for (int p = 0; p < T::kBPer; ++p) {
      const int c = tid + p * kTileThreads;
      const int k = c / (kSegs * T::kBCps);
      const int rem = c % (kSegs * T::kBCps);
      const int seg = rem / T::kBCps;
      const int col = (rem % T::kBCps) * T::kBE;
      // selects, not b_src[hi]: a runtime index would put the arrays in
      // local memory
      const bool hi = seg >= b_split;
      const int scol = (hi ? seg - b_split : seg) * 64 + col;
      const bool ok = k0 + k < K && scol < (hi ? b_cols[1] : b_cols[0]);
      const TB* src = ok ? (hi ? b_src[1] : b_src[0]) +
                               static_cast<size_t>(k0 + k) * ldb + scol
                         : b_src[0];
      cp_async16(bs + k * kBN + seg * 64 + col, src, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab kt landed for every thread; slot kt-1 is free
    const int s = kt % STAGES;
    if constexpr (sizeof(TA) == 4) {  // bf16 A is already on the grid
      if (round_a) {
        TA* as = slot_a(s);
        for (int i = tid; i < BM * kBK; i += kTileThreads) {
          TA* p = as + (i / kBK) * T::kAStride + i % kBK;
          *p = bf16_round(*p);
        }
        __syncthreads();
      }
    }
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    if (!active) continue;

    const TA* as = slot_a(s) + ty * T::kAStride;
    const TB* bs = slot_b(s) + tx * 4;
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float4 a[LIVE];
#pragma unroll
      for (int i = 0; i < LIVE; ++i)
        a[i] = ld4(as + 16 * i * T::kAStride + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[kSegs];
#pragma unroll
        for (int g = 0; g < kSegs; ++g)
          b[g] = ld4(bs + (kq + kk) * kBN + 64 * g);
#pragma unroll
        for (int i = 0; i < LIVE; ++i) {
          const float av = comp(a[i], kk);
#pragma unroll
          for (int g = 0; g < kSegs; ++g) {
            acc[i][4 * g] = fmaf(av, b[g].x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(av, b[g].y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(av, b[g].z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(av, b[g].w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }
}

}  // namespace repro
