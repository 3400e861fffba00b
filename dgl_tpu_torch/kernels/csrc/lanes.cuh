// Device helpers shared by the port's CUDA kernels (csr_spmm.cu, seg_sum.cu,
// gat_attention.cu, row_gather.cu): K1, K2 and K3 walk runs of a CSR's
// rows with warps, staged in shared memory (the staged reads, the run
// search and the in-launch fold of long rows below); P1 and P2 read rows
// one warp a row.
//
// The warp is cut into groups = 32 / L lane groups of L lanes. A group takes
// one staged row at a time and its lanes stride that row's D values with
// reads of V values: 16, 8, 4 or 2 bytes a lane, so a narrow row still
// keeps all 32 lanes busy (float D = 16: L = 4, 8 rows at once). Every
// value is converted to float as it is read (bfloat16 with cuda_bf16.h's
// __bfloat1622float2 / __bfloat162float, which are exact), and every sum is
// kept in float. L is the least power of two that covers the D / V vectors
// of a row, at most 32; a kernel runs wider rows as column pieces. The
// groups' partial sums are combined by a butterfly of warp shuffles over the
// lane offsets L, 2L, ..., 16, always in the same order, so the kernels need
// no atomics to sum and two runs are bitwise equal. Each kernel computes its
// lane's group (lane / L) and column (lane % L) itself: taken from a shared
// struct, they changed K1's generated code and cost it 12% on reddit's
// reverse hub row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_csr {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kNone = INT64_MAX;

// The raw word of V bfloat16 values (2·V bytes) that one load or store moves.
template <int V> struct Bf16Word;
template <> struct Bf16Word<2> { using type = __nv_bfloat162; };
template <> struct Bf16Word<4> { using type = uint2; };
template <> struct Bf16Word<8> { using type = uint4; };

// V floats to a float row at p (V = 8: two 16-byte stores).
template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&v)[V]) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "1, 2, 4 or 8 floats");
  if constexpr (V >= 4) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h)
      reinterpret_cast<float4*>(p)[h] =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// V floats rounded to bfloat16 (to nearest, ties to even, as torch's
// .to(torch.bfloat16)) and stored at p, one store of 2·V bytes.
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* __restrict__ p, const float (&v)[V]) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "1, 2, 4 or 8 bfloat16 values");
  if constexpr (V == 1) {
    p[0] = __float2bfloat16_rn(v[0]);
  } else {
    using W = typename Bf16Word<V>::type;
    W raw;
    auto* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<W*>(p) = raw;
  }
}

// V values of a staged float row at p (shared memory), as floats.
template <int V>
__device__ __forceinline__ void lds_vec(const float* p, float (&v)[V]) {
  static_assert(V == 1 || V == 2 || V == 4, "1, 2 or 4 floats");
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// V values of a staged bfloat16 row at p (shared memory), converted exactly:
// one read of 2·V bytes (V = 8: 16 bytes).
template <int V>
__device__ __forceinline__ void lds_vec(const __nv_bfloat16* p, float (&v)[V]) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "1, 2, 4 or 8 bfloat16 values");
  if constexpr (V == 1) {
    v[0] = __bfloat162float(*p);
  } else {
    using W = typename Bf16Word<V>::type;
    const W raw = *reinterpret_cast<const W*>(p);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
}

// V floats of a partials row through L2 (written by other warps of this launch).
template <int V>
__device__ __forceinline__ void ldcg_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldcg(p);
  }
}

// The least i in [lo, hi] with key(i) >= target, for a non-decreasing key
// with key(hi) >= target: each round the 32 lanes read 32 keys spread over
// the range, which shrinks it 31-fold. The same for every lane.
template <typename Key>
__device__ __forceinline__ int64_t warp_search(int64_t lo, int64_t hi, int64_t target, Key key) {
  const int lane = threadIdx.x % kWarp;
  while (true) {
    const int64_t step = (hi - lo + 30) / 31;
    const int64_t p = min(lo + lane * step, hi);
    const int first = __ffs(__ballot_sync(kFull, key(p) >= target)) - 1;  // lane 31 reads hi
    if (first == 0) return lo;
    const int64_t a = lo + (first - 1) * step + 1, b = min(lo + first * step, hi);
    if (a == b) return a;
    lo = a;
    hi = b;
  }
}

// indptr[base .. base + 31] across the lanes, for rows visited one by one in
// ascending order; the next 31 rows' offsets are loaded a batch ahead.
// `indptr(i)` reads offset i of a CSR of n_rows rows. I: the offsets' type
// (K3 walks in 32 bits, gat_attention.cu).
template <typename I>
struct RowOffsetsOf {
  I base, cur, next;

  template <typename Ip>
  __device__ __forceinline__ I load(Ip indptr, I n_rows, I b) const {
    const I i = b + static_cast<I>(threadIdx.x % kWarp);
    return indptr(i < n_rows ? i : n_rows);
  }

  template <typename Ip>
  __device__ __forceinline__ void init(Ip indptr, I n_rows, I r0) {
    base = r0;
    cur = load(indptr, n_rows, r0);
    next = load(indptr, n_rows, r0 + 31);
  }

  // first and end edge of row r (called for every row, r = base.. ascending)
  template <typename Ip>
  __device__ __forceinline__ void row(Ip indptr, I n_rows, I r, I& s, I& e) {
    if (r - base == 31) {
      base += 31;
      cur = next;
      next = load(indptr, n_rows, base + 31);
    }
    const int k = static_cast<int>(r - base);
    s = __shfl_sync(kFull, cur, k);
    e = __shfl_sync(kFull, cur, k + 1);
  }
};

using RowOffsets = RowOffsetsOf<int64_t>;

// Sum over the lane groups (the butterfly), the same order every run.
__device__ __forceinline__ float group_sum(float x, int lanes) {
  for (int off = lanes; off < kWarp; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int T, int V>
__device__ __forceinline__ void group_sum(float (&acc)[T][V], int lanes) {
#pragma unroll
  for (int t = 0; t < T; ++t)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[t][k] = group_sum(acc[t][k], lanes);
}

// One warp per row (P1, P2: row_gather.cu).
inline dim3 grid_for(int64_t n_rows) {
  return dim3(static_cast<unsigned>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

// ---- The row split (dgl_tpu_torch/graph/split.py) ---------------------------
//
// A row of more than T edges would keep one warp for its whole length, and a
// launch lasts as long as its longest row (reddit's reverse CSR: 212,102
// edges). The host lists such rows once per CSR, each cut into chunks of at
// most T edges in ascending edge order: `chunks` holds each chunk's
// [begin, end) edge offsets (int64 pairs), `chunk_ptr` each long row's first
// chunk and `rows` the long rows. A kernel's launch gives its first blocks
// to the chunks, which a warp sums into its rows of a partials buffer,
// float32, with the lane layout above; its other blocks take runs of rows,
// which skip the listed rows. The chunk blocks come first, so the longest
// work starts first. K1, K2 and K3 fold the long rows inside their launch
// (count_and_fold, below). No atomics decide an order: two runs are bitwise
// equal.

// The long row i that owns chunk k (chunk_ptr[i] <= k < chunk_ptr[i + 1]), by
// binary search of chunk_ptr: for a kernel whose chunk needs its row's own
// operands (K3's a_dst or a_src) or its counter. The same for every lane of
// the warp.
__device__ __forceinline__ int64_t chunk_owner(const int64_t* __restrict__ chunk_ptr,
                                               int64_t n_long, int64_t k) {
  int64_t lo = 0, hi = n_long;
  while (hi - lo > 1) {
    const int64_t mid = (lo + hi) / 2;
    if (chunk_ptr[mid] <= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// ---- Long rows folded inside the launch (K1, K2, K3) -----------------------
//
// A chunk warp sums its chunks into their partials rows, fences, and counts
// them on their rows' arrival counters (count_and_fold); the warp that
// brings a row's count to its number of chunks folds the row: it adds the
// row's partials in ascending chunk order (read through L2; K1 and K2 by
// fold_row, which applies mean's 1 / deg of the whole row, K3 by its own,
// gat_attention.cu), writes the row once and sets the counter back to 0.
// The order of the additions does not depend on which warp arrives last and
// no atomic decides one, so two runs are bitwise equal. The counters belong
// to the plan, so two launches over one CSR must not run at once on two
// streams.

constexpr int kFoldUnroll = 8;  // chunks in flight a lane group in the fold

struct Fold {
  const float* partials;  // (n_chunks, d)
  const int64_t* rows;
  const int64_t* chunk_ptr;
  const int64_t* chunks;
  int32_t* counters;  // one a long row, 0 between launches
  float* out;
  int64_t n_long;
  int d, mean;
};

// out[rows[i]] = scale · Σ_k partials[k] over long row i's chunks in
// ascending k, read through L2. The lane groups load kFoldUnroll·groups
// chunks at once; every lane adds them in ascending k through shuffles, so
// the order does not depend on the lane layout.
template <int V>
__device__ __forceinline__ void fold_row(const Fold& f, int64_t i) {
  const int lane = threadIdx.x % kWarp;
  const int64_t k0 = f.chunk_ptr[i], k1 = f.chunk_ptr[i + 1];
  float scale = 1.f;
  if (f.mean) {  // the whole row's degree: its first chunk's begin to its last chunk's end
    const int64_t deg = f.chunks[2 * (k1 - 1) + 1] - f.chunks[2 * k0];
    scale = 1.f / static_cast<float>(deg > 1 ? deg : 1);
  }
  const int nvec = f.d / V;
  int lanes = 1;
  while (lanes < nvec && lanes < kWarp) lanes <<= 1;
  const int groups = kWarp / lanes, g = lane / lanes, col = lane % lanes;
  const int64_t step = static_cast<int64_t>(groups) * kFoldUnroll;
  float* orow = f.out + f.rows[i] * f.d;
  for (int c0 = 0; c0 < nvec; c0 += lanes) {
    const int c = c0 + col;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int64_t kb = k0; kb < k1; kb += step) {
      float v[kFoldUnroll][V];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const int64_t k = kb + static_cast<int64_t>(u) * groups + g;
        if (k < k1 && c < nvec) {
          ldcg_vec<V>(f.partials + k * f.d + static_cast<int64_t>(c) * V, v[u]);
        } else {
#pragma unroll
          for (int kk = 0; kk < V; ++kk) v[u][kk] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u)
        for (int gg = 0; gg < groups; ++gg)
#pragma unroll
          for (int kk = 0; kk < V; ++kk) acc[kk] += __shfl_sync(kFull, v[u][kk], gg * lanes + col);
    }
    if (g == 0 && c < nvec) {
      float r[V];
#pragma unroll
      for (int k = 0; k < V; ++k) r[k] = acc[k] * scale;
      store_vec<V>(orow + static_cast<int64_t>(c) * V, r);
    }
  }
}

// After this warp summed chunks [k0, k1) into their partials rows: count
// them on their rows' counters; the warp that completes long row i's count
// calls fold(i) and sets its counter back to 0 (K3 calls it with its own
// fold).
template <typename FoldFn>
__device__ __forceinline__ void count_and_fold(int32_t* counters, const int64_t* chunk_ptr,
                                               int64_t n_long, int64_t k0, int64_t k1,
                                               FoldFn fold) {
  const int lane = threadIdx.x % kWarp;
  __threadfence();
  __syncwarp();
  for (int64_t k = k0, i = chunk_owner(chunk_ptr, n_long, k0); k < k1; ++i) {
    const int64_t mine = min(chunk_ptr[i + 1], k1) - k;
    int last = 0;
    if (lane == 0) {
      const int n = static_cast<int>(chunk_ptr[i + 1] - chunk_ptr[i]);
      __threadfence();
      last = atomicAdd(counters + i, static_cast<int>(mine)) == n - mine;
    }
    if (__shfl_sync(kFull, last, 0)) {
      __threadfence();
      fold(i);
      if (lane == 0) counters[i] = 0;  // ready for the next launch
    }
    k += mine;
  }
}

// count_and_fold with fold_row (K1, K2).
template <int V>
__device__ __forceinline__ void count_chunks(const Fold& f, int64_t k0, int64_t k1) {
  count_and_fold(f.counters, f.chunk_ptr, f.n_long, k0, k1,
                 [&f](int64_t i) { fold_row<V>(f, i); });
}

}  // namespace warp_csr
