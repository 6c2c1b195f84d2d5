// MoE dispatch (token -> capacity-slot scatter) and combine (gate-weighted
// gather back to tokens) for Hopper (sm_90a), plain C interface (loaded
// with ctypes).
//
// Replaces: src/repro/kernels/moe_dispatch.py::moe_dispatch
// (_dispatch_kernel) and ::moe_combine (_combine_kernel), the Pallas TPU
// kernels that keep the whole (n_slots, M) capacity buffer in VMEM and walk
// the token stream over a sequential grid.
//
//   dispatch: buf[slot] = the sum, over the entries e = s * k + j of flat
//             that name the slot, of x[s], taken from 0 in ascending e
//             (token s, then choice j: the Pallas kernel's order) and
//             rounded to the buffer's dtype after each addition, as its
//             o_ref is; a slot no entry names is 0; slot n_slots is the
//             drop sentinel (names no row).  Gate routing names each slot
//             at most once, so a row is 0 + x[s]: x[s] exactly (-0 becomes
//             +0, as in the reference).
//   combine:  y[s] = sum_j w[s, j] * buf[flat[s, j]], one FMA chain per
//             output element, from 0.f in choice order j = 0..k-1, in f32,
//             then cast to the buffer's dtype.  Each weight is first
//             rounded to the buffer's dtype, as the plain version casts
//             it.  A dropped choice (slot < 0 or >= n_slots) adds nothing.
//             No atomics: deterministic, every output row independent of
//             every other (the grouped op's combine, csrc/
//             expert_ffn_grouped.cu, runs the same chains: phase 6 and the
//             card tests hold the two bitwise).
//
// What bounds them on an H100: memory.  Neither does more than one add or
// FMA per element moved.  Dispatch must write the whole buffer (n_slots x
// M, zero rows included) and read each routed token row; combine reads k
// gathered rows per token and writes S x M.

// Dispatch's design: one launch, no memset and no atomics; every buffer
// row is written once, by the block that owns it.  Block b owns the
// contiguous slot rows [b * rows, (b + 1) * rows) (rows chosen by the host
// for about four blocks per SM, 8..256).  It reads all S * k entries of
// flat once (an L2-resident int array: 64 KB at the training shapes, eight
// loads in flight per lane): each of its eight warps lists, in shared
// memory and in entry order, the entries of its contiguous share that name
// the block's rows (ballot + popc, no atomics).  Each row then learns
// whether one entry names it or more (two passes of plain shared stores:
// every entry writes its list index into its row's cell, then an entry
// that finds another index there marks the row as summed).  Each warp
// writes its rows whole: zeros, a copy of the one token row, or, for a
// summed row, its entries in list order (warp by warp) accumulated in
// registers one column tile at a time.  Rows of a multiple of 16 bytes at
// 16-byte-aligned addresses move as 16-byte vectors, any other row element
// by element.  Stores are streaming (evict-first), so the token rows,
// read k times each, stay in L2 (qwen3's step: 0.095 -> 0.087 ms).  A
// block where one warp's share names its rows more than kSeg times (only
// possible when slots repeat) sums every row by scanning flat itself in
// entry order.
//
// Combine's design: one warp per (token row, column tile) item, as many
// blocks of eight warps as the SMs run at once (the instance's occupancy)
// striding over the items in row-major order.  Every lane loads the row's
// k slot ids and weights itself: the same address across the warp, one
// broadcast load each (measured faster at every shape than lanes 0..k-1
// loading them and __shfl_sync, with or without the next item's loaded
// ahead); each weight is rounded to the buffer's dtype there.  Instances
// unrolled for k = 1, 2, 4 and 8 (llama4, gpt2-moe and bert-moe, the
// quickstart, qwen3) issue all k rows' 16-byte loads of a tile before the
// first fmaf, eight loads a lane (a tile is 32 x 8 / k vectors); any other
// k runs one choice at a time, four loads a lane.  A dropped choice is
// left out by predicate: the chain's order never changes.  Loads and
// stores carry no cache hint: the buffer comes from expert_ffn's stores
// just before, and the residual add reads y next.  Rows of a multiple of
// 16 bytes at 16-byte-aligned addresses move as 16-byte vectors, any
// other element by element.  Where the rows give fewer items than a full
// grid has warps (decode's 8 rows), each row is cut into narrower tiles,
// down to one vector a lane, in blocks of fewer warps, so that the
// gathers spread over more SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstring>

#include "vec16.cuh"

namespace {

using repro::kVec;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 256;   // slot rows per dispatch block, at most
constexpr int kSeg = kMaxRows;  // entries each warp of a block lists
constexpr int kTile = 4;        // vectors per lane per column tile (sums)
constexpr int kScan = 8;        // slot loads in flight per lane (scans)
constexpr int kBlocksPerSM = 4;

// x rounded to T and back: the buffer's precision after each addition.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return repro::widen(repro::narrow<T>(v));
}

// W elements per access (1, or one 16-byte vector).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
dispatch_kernel(const T* __restrict__ x, const int* __restrict__ flat,
                T* __restrict__ buf, int n, int k, int M, int n_slots,
                int rows) {
  // warp w's list: the entries of its share naming this block's rows, in
  // entry order, at [w * kSeg, w * kSeg + warp_hits[w])
  __shared__ int hit_e[kWarps * kSeg];            // entry s * k + j
  __shared__ unsigned char hit_r[kWarps * kSeg];  // its row in the block
  __shared__ int warp_hits[kWarps];
  __shared__ int first[kMaxRows];             // a list index naming the row
  __shared__ unsigned char summed[kMaxRows];  // 1: two or more entries

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rows;
  const unsigned nr = static_cast<unsigned>(min(rows, n_slots - r0));
  for (int r = threadIdx.x; r < static_cast<int>(nr); r += kThreads) {
    first[r] = -1;
    summed[r] = 0;
  }
  // the row of this block entry i names, or >= nr
  auto row_of = [&](int i) {
    return static_cast<unsigned>(flat[i]) - static_cast<unsigned>(r0);
  };

  // 1. one pass over flat: warp w lists the hits of its contiguous share,
  // kScan loads in flight per lane, runs of 32 entries in order, lanes in
  // order.  Without repeated slots a warp has at most nr <= kSeg hits.
  const int share = ((n + kWarps - 1) / kWarps + 32 * kScan - 1) &
                    ~(32 * kScan - 1);
  const int beg = min(warp * share, n), end = min(beg + share, n);
  int count = 0;
  for (int b = beg; b < end; b += 32 * kScan) {
    unsigned r[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int i = b + 32 * u + lane;
      r[u] = i < end ? row_of(i) : nr;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const unsigned m = __ballot_sync(kFull, r[u] < nr);
      const int h = count + __popc(m & ((1u << lane) - 1u));
      if (r[u] < nr && h < kSeg) {
        hit_e[warp * kSeg + h] = b + 32 * u + lane;
        hit_r[warp * kSeg + h] = static_cast<unsigned char>(r[u]);
      }
      count += __popc(m);
    }
  }
  if (lane == 0) warp_hits[warp] = count;
  __syncthreads();
  bool listed = true;  // the same in every thread
#pragma unroll
  for (int w = 0; w < kWarps; ++w) listed = listed && warp_hits[w] <= kSeg;

  if (listed) {
    // 2. one list index per row (any writer wins), then mark the rows
    // where an entry finds another one's index
    for (int h = threadIdx.x; h < kWarps * kSeg; h += kThreads)
      if (h % kSeg < warp_hits[h / kSeg]) first[hit_r[h]] = h;
    __syncthreads();
    for (int h = threadIdx.x; h < kWarps * kSeg; h += kThreads)
      if (h % kSeg < warp_hits[h / kSeg] && first[hit_r[h]] != h)
        summed[hit_r[h]] = 1;
  }
  __syncthreads();

  // 3. each warp writes its rows whole, with streaming stores: the buffer
  // is written once and read by the next kernel, and keeping x in L2
  // matters more (each token row is read k times)
  const int nvec = M / W;
  for (int r = warp; r < static_cast<int>(nr); r += kWarps) {
    T* dst = buf + static_cast<size_t>(r0 + r) * M;
    if (listed && !summed[r]) {
      const int h = first[r];
      if (h < 0) {  // no entry names the slot
        float z[W];
#pragma unroll
        for (int e = 0; e < W; ++e) z[e] = 0.f;
        for (int v = lane; v < nvec; v += 32)
          repro::store<T, W, true>(dst + v * W, z);
      } else {      // one entry: 0 + x[s]
        const T* src = x + static_cast<size_t>(hit_e[h] / k) * M;
#pragma unroll 4
        for (int v = lane; v < nvec; v += 32) {
          float f[W];
          repro::load<T, W>(src + v * W, f);
#pragma unroll
          for (int e = 0; e < W; ++e) f[e] = 0.f + f[e];
          repro::store<T, W, true>(dst + v * W, f);
        }
      }
      continue;
    }
    // two or more entries (or no list): their rows summed in entry order,
    // kTile vectors per lane at a time
    for (int t0 = 0; t0 < nvec; t0 += 32 * kTile) {
      float acc[kTile][W];
#pragma unroll
      for (int c = 0; c < kTile; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[c][e] = 0.f;
      auto add = [&](int entry) {
        const T* src = x + static_cast<size_t>(entry / k) * M;
#pragma unroll
        for (int c = 0; c < kTile; ++c) {
          const int v = t0 + c * 32 + lane;
          if (v < nvec) {
            float f[W];
            repro::load<T, W>(src + v * W, f);
#pragma unroll
            for (int e = 0; e < W; ++e)
              acc[c][e] = rounded<T>(acc[c][e] + f[e]);
          }
        }
      };
      if (listed) {  // the warps' lists in warp order
        for (int w = 0; w < kWarps; ++w) {
          for (int b = 0; b < warp_hits[w]; b += 32) {
            const int h = w * kSeg + b + lane;
            unsigned m = __ballot_sync(
                kFull, b + lane < warp_hits[w] && hit_r[h] == r);
            for (; m; m &= m - 1) add(hit_e[w * kSeg + b + __ffs(m) - 1]);
          }
        }
      } else {
        for (int b = 0; b < n; b += 32) {
          const int i = b + lane;
          unsigned m = __ballot_sync(
              kFull, i < n && row_of(i) == static_cast<unsigned>(r));
          for (; m; m &= m - 1) add(b + __ffs(m) - 1);
        }
      }
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int v = t0 + c * 32 + lane;
        if (v < nvec) repro::store<T, W, true>(dst + v * W, acc[c]);
      }
    }
  }
}

// Column vectors each lane gathers per choice in one tile of the K-choice
// instance: all K choices' loads of a tile are issued before the first
// fmaf, eight of them a lane.  The generic loop: kGenericCols a choice.
constexpr int kGenericCols = 4;
template <int K>
__host__ __device__ constexpr int combine_cols() {
  return K == 0 ? kGenericCols : 8 / K;
}

// Entry rj = r * k + j of flat: its slot row, or -1 where the choice is
// dropped, and its weight rounded to T.  Every lane of a warp loads the
// same entry: one broadcast load each, the two in flight together.
struct Choice {
  int slot;
  float w;
};
template <typename T>
__device__ __forceinline__ Choice load_choice(const int* __restrict__ flat,
                                              const float* __restrict__ weights,
                                              size_t rj, int n_slots) {
  const int slot = flat[rj];
  const float w = weights[rj];
  if (slot < 0 || slot >= n_slots) return {-1, 0.f};
  return {slot, repro::widen(repro::narrow<T>(w))};
}

// One warp per (token row, column tile) item, items in row-major order,
// each warp striding by the grid's warp count (blocks of 1..8 warps).  K:
// the unrolled choice count (k == K), or 0 for the generic loop over any
// k.  A tile is tv vectors of W elements from column vector t * tv; lane l
// takes vectors l, l + 32, ... of it (tv <= 32 * combine_cols<K>()).
template <typename T, int W, int K>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ buf, const int* __restrict__ flat,
               const float* __restrict__ weights, T* __restrict__ y, int S,
               int k, int M, int n_slots, int n_tiles, int tv) {
  constexpr int C = combine_cols<K>(), NW = repro::kWords<W>;
  const int lane = threadIdx.x & 31;
  const int nvec = M / W;
  // this warp's first item and its stride, as (row, tile) steps
  const int wpb = blockDim.x >> 5, warps = gridDim.x * wpb;
  const int first = blockIdx.x * wpb + (threadIdx.x >> 5);
  int s = first / n_tiles, t = first % n_tiles;
  const int ds = warps / n_tiles, dt = warps % n_tiles;

  while (s < S) {
    const int t0 = t * tv;
    const size_t r0 = static_cast<size_t>(s) * k;
    bool live[C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      live[c] = c * 32 + lane < tv && t0 + c * 32 + lane < nvec;
    T* dst = y + static_cast<size_t>(s) * M;

    if constexpr (K > 0) {
      // every choice's loads of the tile in flight, then the chains
      float wj[K];
      bool ok[K];
      uint32_t bits[K][C][NW];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const Choice ch = load_choice<T>(flat, weights, r0 + j, n_slots);
        wj[j] = ch.w;
        ok[j] = ch.slot >= 0;
        const T* src = buf + static_cast<size_t>(ok[j] ? ch.slot : 0) * M;
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int i = 0; i < NW; ++i) bits[j][c][i] = 0u;
          if (ok[j] && live[c])
            repro::load_bits<T, W>(src + (t0 + c * 32 + lane) * W,
                                         bits[j][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!live[c]) continue;
        float acc[W];
#pragma unroll
        for (int e = 0; e < W; ++e) {
          acc[e] = 0.f;
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (ok[j])
              acc[e] = fmaf(wj[j], repro::element<T, W>(bits[j][c], e),
                            acc[e]);
        }
        repro::store<T, W>(dst + (t0 + c * 32 + lane) * W, acc);
      }
    } else {
      // any k: one choice at a time, its C loads in flight
      float acc[C][W];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int e = 0; e < W; ++e) acc[c][e] = 0.f;
      for (int j = 0; j < k; ++j) {
        const Choice ch = load_choice<T>(flat, weights, r0 + j, n_slots);
        if (ch.slot < 0) continue;  // dropped: adds nothing
        const T* src = buf + static_cast<size_t>(ch.slot) * M;
        // a column past the tile reads the row's first vector again
        // (unused): unconditional loads, which ptxas keeps in registers
        uint32_t bits[C][NW];
#pragma unroll
        for (int c = 0; c < C; ++c)
          repro::load_bits<T, W>(
              src + (live[c] ? t0 + c * 32 + lane : 0) * W, bits[c]);
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int e = 0; e < W; ++e)
            acc[c][e] = fmaf(ch.w, repro::element<T, W>(bits[c], e),
                             acc[c][e]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (live[c])
          repro::store<T, W>(dst + (t0 + c * 32 + lane) * W, acc[c]);
    }
    s += ds;
    t += dt;
    if (t >= n_tiles) {
      t -= n_tiles;
      ++s;
    }
  }
}

// The card's SM count, read once.
int sm_count() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms <= 0)
      sms = 132;  // an H100 SXM
  }
  return sms;
}

// Slot rows per dispatch block: about four blocks per SM (measured faster
// than two, three or six at both training shapes), 8..256 rows.
int dispatch_rows(int n_slots) {
  const int sms = sm_count();
  const int rows = (n_slots + kBlocksPerSM * sms - 1) / (kBlocksPerSM * sms);
  return rows < kWarps ? kWarps : rows > kMaxRows ? kMaxRows : rows;
}

template <typename T>
void launch_dispatch(const T* x, const int* flat, T* buf, int n, int k,
                     int M, int n_slots, cudaStream_t st) {
  const int rows = dispatch_rows(n_slots);
  const int grid = (n_slots + rows - 1) / rows;
  if (M % kVec<T> == 0 && repro::aligned16(x, buf))
    dispatch_kernel<T, kVec<T>><<<grid, kThreads, 0, st>>>(x, flat, buf, n, k,
                                                          M, n_slots, rows);
  else
    dispatch_kernel<T, 1><<<grid, kThreads, 0, st>>>(x, flat, buf, n, k, M,
                                                     n_slots, rows);
}

// Combine's launch.  Items: S rows of n_tiles column tiles, a row's tiles
// as wide as a tile's loads allow (32 * combine_cols<K>() vectors).  The
// grid holds as many blocks of eight warps as the SMs run at once (the
// instance's occupancy, read once), each warp striding over the items.
// Where the rows give fewer items than those warps (decode's few rows),
// each row is cut into narrower tiles, down to one vector a lane, and the
// blocks shrink to as few warps as put the items on every SM.
template <typename T, int W, int K>
void launch_combine_k(const T* buf, const int* flat, const float* w, T* y,
                      int S, int k, int M, int n_slots, cudaStream_t st) {
  constexpr int C = combine_cols<K>();
  static int per_sm = 0;
  if (per_sm <= 0 &&
      (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, combine_kernel<T, W, K>, kThreads, 0) != cudaSuccess ||
       per_sm <= 0))
    per_sm = 1;
  const long long sms = sm_count(), blocks_max = sms * per_sm,
                  warps_max = blocks_max * kWarps, nvec = M / W;
  long long n_tiles = (nvec + 32 * C - 1) / (32 * C);
  if (S * n_tiles < warps_max)
    n_tiles = std::min((nvec + 31) / 32,
                       std::max(n_tiles, (warps_max + S - 1) / S));
  const int tv = static_cast<int>((nvec + n_tiles - 1) / n_tiles);
  const long long items = S * n_tiles;
  const int wpb = static_cast<int>(
      std::min<long long>(kWarps, std::max(1LL, (items + sms - 1) / sms)));
  const long long blocks = std::min((items + wpb - 1) / wpb, blocks_max);
  combine_kernel<T, W, K><<<static_cast<int>(blocks), 32 * wpb, 0, st>>>(
      buf, flat, w, y, S, k, M, n_slots, static_cast<int>(n_tiles), tv);
}

template <typename T, int W>
void launch_combine_w(const T* buf, const int* flat, const float* w, T* y,
                      int S, int k, int M, int n_slots, cudaStream_t st) {
  switch (k) {
    case 1:
      return launch_combine_k<T, W, 1>(buf, flat, w, y, S, k, M, n_slots, st);
    case 2:
      return launch_combine_k<T, W, 2>(buf, flat, w, y, S, k, M, n_slots, st);
    case 4:
      return launch_combine_k<T, W, 4>(buf, flat, w, y, S, k, M, n_slots, st);
    case 8:
      return launch_combine_k<T, W, 8>(buf, flat, w, y, S, k, M, n_slots, st);
    default:
      return launch_combine_k<T, W, 0>(buf, flat, w, y, S, k, M, n_slots, st);
  }
}

// 16-byte vectors where every row starts on a 16-byte boundary, else one
// element at a time.
template <typename T>
void launch_combine(const T* buf, const int* flat, const float* w, T* y,
                    int S, int k, int M, int n_slots, cudaStream_t st) {
  if (M % kVec<T> == 0 && repro::aligned16(buf, y))
    launch_combine_w<T, kVec<T>>(buf, flat, w, y, S, k, M, n_slots, st);
  else
    launch_combine_w<T, 1>(buf, flat, w, y, S, k, M, n_slots, st);
}

}  // namespace

// The arguments of one dispatch call, packed by the wrapper in this order
// and layout (Python struct format "PPPPiiiii4x": one ctypes argument
// costs the host far less than nine).  dtype: 0 = float32, 1 = bfloat16 (x
// and buf share it).  x (S, M), flat (S, k) int32, buf (n_slots, M), every
// row of which the one launch writes.
struct DispatchArgs {
  const void* x;
  const int* flat;
  void* buf;
  void* stream;
  int dtype, S, k, M, n_slots;
};
static_assert(sizeof(DispatchArgs) == 56, "the wrapper packs 56 bytes");

// Returns the cudaError_t of the launch (0 on success; n_slots 0 launches
// nothing).
extern "C" int repro_moe_dispatch(const void* packed) {
  DispatchArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.dtype < 0 || a.dtype > 1 || a.S < 0 || a.k <= 0 || a.M <= 0 ||
      a.n_slots < 0 || static_cast<long long>(a.S) * a.k > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_slots == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  if (a.dtype == 0)
    launch_dispatch(static_cast<const float*>(a.x), a.flat,
                    static_cast<float*>(a.buf), a.S * a.k, a.k, a.M,
                    a.n_slots, st);
  else
    launch_dispatch(static_cast<const __nv_bfloat16*>(a.x), a.flat,
                    static_cast<__nv_bfloat16*>(a.buf), a.S * a.k, a.k, a.M,
                    a.n_slots, st);
  return static_cast<int>(cudaGetLastError());
}

// The arguments of one combine call (Python struct format
// "PPPPPiiiii4x").  dtype: 0 = float32, 1 = bfloat16 (buf and y share it).
// buf (n_slots, M), flat (S, k) int32, weights (S, k) float32, y (S, M).
struct CombineArgs {
  const void* buf;
  const int* flat;
  const float* weights;
  void* y;
  void* stream;
  int dtype, S, k, M, n_slots;
};
static_assert(sizeof(CombineArgs) == 64, "the wrapper packs 64 bytes");

extern "C" int repro_moe_combine(const void* packed) {
  CombineArgs a;
  memcpy(&a, packed, sizeof a);
  if (a.dtype < 0 || a.dtype > 1 || a.S < 0 || a.k <= 0 || a.M <= 0 ||
      a.n_slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.S == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  if (a.dtype == 0)
    launch_combine(static_cast<const float*>(a.buf), a.flat, a.weights,
                   static_cast<float*>(a.y), a.S, a.k, a.M, a.n_slots, st);
  else
    launch_combine(static_cast<const __nv_bfloat16*>(a.buf), a.flat,
                   a.weights, static_cast<__nv_bfloat16*>(a.y), a.S, a.k,
                   a.M, a.n_slots, st);
  return static_cast<int>(cudaGetLastError());
}
