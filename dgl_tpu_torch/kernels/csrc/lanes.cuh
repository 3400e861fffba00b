// Device helpers shared by the port's CUDA kernels (csr_spmm.cu, seg_sum.cu,
// gat_attention.cu, row_gather.cu), which walk a CSR with warps: K3 one
// warp a row reading device memory, K1 and K2 runs of rows staged in
// shared memory (the staged reads, the run search and the in-launch fold of
// long rows below).
//
// The warp is cut into groups = 32 / L lane groups of L lanes. A group takes
// one edge at a time and its lanes stride that edge's row of D values with
// loads of V values: 16, 8, 4 or 2 bytes a lane (float rows: V = 4, 2 or 1;
// bfloat16 rows: V = 8, 4, 2 or 1), so a narrow row still keeps all 32
// lanes busy (float D = 16: L = 4, 8 edges at once; bfloat16 D = 16: L = 2,
// 16 edges at once). Every value is converted to float as it is loaded
// (bfloat16 with cuda_bf16.h's __bfloat1622float2 / __bfloat162float, which
// are exact), and every sum is kept in float. L is the least power of two
// that covers the D / V vectors of a row, at most 32; a kernel runs wider
// rows as feature tiles. The groups' partial sums are combined by a
// butterfly of warp shuffles over the lane offsets L, 2L, ..., 16, always in
// the same order, so the kernels need no atomics and two runs are bitwise
// equal. Each kernel computes its lane's group (slot = lane / L) and column
// (col = lane % L) itself: taken from a shared struct, they changed K1's
// generated code and cost it 12% on reddit's reverse hub row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace warp_csr {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // edges in flight per lane group
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kNone = INT64_MAX;

// The CSR row of this warp; a whole warp leaves together when it is past the
// last row.
__device__ __forceinline__ int64_t warp_row() {
  return static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
}

// V values of a float row at p, one 16-, 8- or 4-byte load (V = 8: two
// 16-byte loads).
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[V]) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "1, 2, 4 or 8 floats");
  if constexpr (V >= 4) {
#pragma unroll
    for (int h = 0; h < V / 4; ++h) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + h);
      v[4 * h] = t.x; v[4 * h + 1] = t.y; v[4 * h + 2] = t.z; v[4 * h + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// The raw word of V bfloat16 values (2·V bytes) that one load or store moves.
template <int V> struct Bf16Word;
template <> struct Bf16Word<2> { using type = __nv_bfloat162; };
template <> struct Bf16Word<4> { using type = uint2; };
template <> struct Bf16Word<8> { using type = uint4; };

// V values of a bfloat16 row at p, as floats: one 16-, 8-, 4- or 2-byte load.
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float (&v)[V]) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8, "1, 2, 4 or 8 bfloat16 values");
  if constexpr (V == 1) {
    v[0] = __bfloat162float(__ldg(p));
  } else {
    using W = typename Bf16Word<V>::type;
    const W raw = __ldg(reinterpret_cast<const W*>(p));
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
}

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
// `indptr(i)` reads offset i of a CSR of n_rows rows.
struct RowOffsets {
  int64_t base, cur, next;

  template <typename Ip>
  __device__ __forceinline__ int64_t load(Ip indptr, int64_t n_rows, int64_t b) const {
    const int64_t i = b + threadIdx.x % kWarp;
    return indptr(i < n_rows ? i : n_rows);
  }

  template <typename Ip>
  __device__ __forceinline__ void init(Ip indptr, int64_t n_rows, int64_t r0) {
    base = r0;
    cur = load(indptr, n_rows, r0);
    next = load(indptr, n_rows, r0 + 31);
  }

  // first and end edge of row r (called for every row, r = base.. ascending)
  template <typename Ip>
  __device__ __forceinline__ void row(Ip indptr, int64_t n_rows, int64_t r, int64_t& s,
                                      int64_t& e) {
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

// L for a row of d values read v at a time.
inline int lanes_for(int d, int v) {
  const int nvec = d / v;
  int l = 1;
  while (l < nvec && l < kWarp) l <<= 1;
  return l;
}

// A row operand of a launch: its base pointer and the bytes of one value.
struct Rows {
  const void* p;
  int bytes;
};

// The widest vector of V values that d and every operand allow: the first
// operand, the one a kernel gathers, sets the widest load (16 bytes: V =
// 16 / its value's bytes), and each operand's pointer must be aligned to its
// access of V values (V · bytes, at most 16: wider float accesses are split
// into 16-byte ones). d % V == 0 keeps every row aligned as its base.
inline int vec_width(int d, std::initializer_list<Rows> rows) {
  for (int v = 16 / rows.begin()->bytes; v > 1; v >>= 1) {
    bool ok = d % v == 0;
    for (const Rows& r : rows) {
      const int need = v * r.bytes < 16 ? v * r.bytes : 16;
      ok = ok && reinterpret_cast<uintptr_t>(r.p) % need == 0;
    }
    if (ok) return v;
  }
  return 1;
}

// One warp per row; `y` is a second grid dimension (GAT's heads).
inline dim3 grid_for(int64_t n_rows, unsigned y = 1) {
  return dim3(static_cast<unsigned>((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock), y);
}

inline dim3 block_dim() { return dim3(kWarp * kWarpsPerBlock); }

// ---- The row split (dgl_tpu_torch/graph/split.py) ---------------------------
//
// A row of more than T edges would keep one warp for its whole length, and a
// launch lasts as long as its longest row (reddit's reverse CSR: 212,102
// edges). The host lists such rows once per CSR, each cut into chunks of at
// most T edges in ascending edge order: `chunks` holds each chunk's
// [begin, end) edge offsets (int64 pairs), `chunk_ptr` each long row's first
// chunk and `rows` the long rows. A kernel's launch gives its first
// chunk_blocks(C) blocks to the chunks, one warp each, which sums its chunk
// into row k of a partials buffer (C, D), float32, with the lane layout
// above; its other blocks take the rows, and a warp whose row has more than T
// edges leaves at once. The chunk blocks come first, so the longest work
// starts first. K3's b2 pass then launches combine_chunks_kernel, which adds
// each long row's partials in ascending chunk order, scales the sum and
// writes the row once; K1 and K2 fold the rows inside their launch
// (count_chunks). No atomics decide an order: two runs are bitwise equal.

inline int64_t chunk_blocks(int64_t n_chunks) {
  return (n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// This warp's work item: a chunk (returns true) in the first `n_chunk_blocks`
// blocks, else a row (or the first of its rows); uniform across the block.
__device__ __forceinline__ bool warp_item(int64_t n_chunk_blocks, int64_t& item) {
  const int64_t b = blockIdx.x;
  const bool is_chunk = b < n_chunk_blocks;
  item = (is_chunk ? b : b - n_chunk_blocks) * kWarpsPerBlock + threadIdx.x / kWarp;
  return is_chunk;
}

// The long row i that owns chunk k (chunk_ptr[i] <= k < chunk_ptr[i + 1]), by
// binary search of chunk_ptr: for a kernel whose chunk needs its row's own
// operands (K3's a_dst or a_src). The same for every lane of the warp.
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

// ---- Long rows folded inside the launch (K1, K2) ---------------------------
//
// A chunk warp sums its chunks into their partials rows, fences, and counts
// them on their rows' arrival counters (count_chunks); the warp that brings
// a row's count to its number of chunks adds the row's partials in ascending
// chunk order (read through L2), applies mean's 1 / deg of the whole row,
// writes the row once and sets the counter back to 0. The order of the
// additions does not depend on which warp arrives last and no atomic decides
// one, so two runs are bitwise equal. The counters belong to the plan, so
// two launches over one CSR must not run at once on two streams.

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
// them on their rows' counters; the warp that completes a row's count folds
// the row (fold_row) and sets its counter back to 0.
template <int V>
__device__ __forceinline__ void count_chunks(const Fold& f, int64_t k0, int64_t k1) {
  const int lane = threadIdx.x % kWarp;
  __threadfence();
  __syncwarp();
  for (int64_t k = k0, i = chunk_owner(f.chunk_ptr, f.n_long, k0); k < k1; ++i) {
    const int64_t mine = min(f.chunk_ptr[i + 1], k1) - k;
    int last = 0;
    if (lane == 0) {
      const int n = static_cast<int>(f.chunk_ptr[i + 1] - f.chunk_ptr[i]);
      __threadfence();
      last = atomicAdd(f.counters + i, static_cast<int>(mine)) == n - mine;
    }
    if (__shfl_sync(kFull, last, 0)) {
      __threadfence();
      fold_row<V>(f, i);
      if (lane == 0) f.counters[i] = 0;  // ready for the next launch
    }
    k += mine;
  }
}

constexpr int kCombineUnroll = 8;  // chunks in flight per lane group

// One warp per long row: out[rows[i]] = scale · Σ_k partials[k] over the row's
// chunks k in ascending order, scale = 1 / deg (mean) or 1, written as OutT
// (float, or bfloat16 rounded once from the float sum). The lane groups
// load kCombineUnroll·groups chunks at once (group g holds chunk kb + u·groups
// + g); every lane then adds them in ascending k through shuffles, so the
// order of the additions does not depend on the lane layout.
template <int V, typename OutT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
combine_chunks_kernel(const float* __restrict__ partials, const int64_t* __restrict__ rows,
                      const int64_t* __restrict__ chunk_ptr, const int64_t* __restrict__ chunks,
                      OutT* __restrict__ out, int64_t n_long, int d, int lanes, int mean) {
  const int64_t i = warp_row();
  if (i >= n_long) return;  // uniform across the warp
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int64_t k0 = chunk_ptr[i], k1 = chunk_ptr[i + 1];
  float scale = 1.f;
  if (mean) {  // the whole row's degree: its first chunk's begin to its last chunk's end
    const int64_t deg = chunks[2 * (k1 - 1) + 1] - chunks[2 * k0];
    scale = 1.f / static_cast<float>(deg > 1 ? deg : 1);
  }
  const int nvec = d / V;
  const int64_t step = static_cast<int64_t>(groups) * kCombineUnroll;
  OutT* orow = out + rows[i] * d;
  for (int c0 = 0; c0 < nvec; c0 += lanes) {
    const int c = c0 + col;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    for (int64_t kb = k0; kb < k1; kb += step) {
      float v[kCombineUnroll][V];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        const int64_t k = kb + static_cast<int64_t>(u) * groups + slot;
        if (k < k1 && c < nvec) {
          load_vec<V>(partials + k * d + static_cast<int64_t>(c) * V, v[u]);
        } else {
#pragma unroll
          for (int kk = 0; kk < V; ++kk) v[u][kk] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u)
        for (int g = 0; g < groups; ++g)
#pragma unroll
          for (int kk = 0; kk < V; ++kk)
            acc[kk] += __shfl_sync(0xffffffffu, v[u][kk], g * lanes + col);
    }
    if (slot == 0 && c < nvec) {
      float r[V];
#pragma unroll
      for (int k = 0; k < V; ++k) r[k] = acc[k] * scale;
      store_vec<V>(orow + static_cast<int64_t>(c) * V, r);
    }
  }
}

// The combine launch of a split CSR (nothing to do without long rows). Its
// vector width is its own: the order of the additions does not depend on it.
template <typename OutT>
void combine_chunks(const float* partials, const int64_t* rows, const int64_t* chunk_ptr,
                    const int64_t* chunks, OutT* out, int64_t n_long, int d, int mean,
                    cudaStream_t stream) {
  if (n_long <= 0) return;
  const int vw = vec_width(d, {{partials, 4}, {out, static_cast<int>(sizeof(OutT))}});
  const int lanes = lanes_for(d, vw);
  const dim3 grid = grid_for(n_long), block = block_dim();
  auto kernel = combine_chunks_kernel<1, OutT>;
  if (vw == 4) {
    kernel = combine_chunks_kernel<4, OutT>;
  } else if (vw == 2) {
    kernel = combine_chunks_kernel<2, OutT>;
  }
  kernel<<<grid, block, 0, stream>>>(partials, rows, chunk_ptr, chunks, out, n_long, d, lanes,
                                     mean);
}

}  // namespace warp_csr
