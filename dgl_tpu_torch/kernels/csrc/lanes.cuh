// Device helpers shared by the port's CUDA kernels (csr_spmm.cu, seg_sum.cu,
// gat_attention.cu), which all walk a CSR with one warp per row.
//
// The warp is cut into groups = 32 / L lane groups of L lanes. A group takes
// one edge at a time and its lanes stride that edge's row of D floats with
// V-float loads (V = 4, 2 or 1: 16-, 8- or 4-byte), so a narrow row still
// keeps all 32 lanes busy (D = 16: L = 4, 8 edges at once). L is the least
// power of two that covers the D / V vectors of a row, at most 32; a kernel
// runs wider rows as feature tiles. The groups' partial sums are combined by
// a butterfly of warp shuffles over the lane offsets L, 2L, ..., 16, always
// in the same order, so the kernels need no atomics and two runs are
// bitwise equal. Each kernel computes its lane's group (slot = lane / L)
// and column (col = lane % L) itself: taken from a shared struct, they
// changed K1's generated code and cost it 12% on reddit's reverse hub row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_csr {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;  // edges in flight per lane group

// The CSR row of this warp; a whole warp leaves together when it is past the
// last row.
__device__ __forceinline__ int64_t warp_row() {
  return static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
}

template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* __restrict__ p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

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

// L for a row of d floats read v at a time.
inline int lanes_for(int d, int v) {
  const int nvec = d / v;
  int l = 1;
  while (l < nvec && l < kWarp) l <<= 1;
  return l;
}

// The widest vector that d and every row pointer (OR-ed into `align`) allow.
inline int vec_width(int d, uintptr_t align) {
  if (d % 4 == 0 && align % 16 == 0) return 4;
  if (d % 2 == 0 && align % 8 == 0) return 2;
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
// starts first. combine_chunks_kernel then adds each long row's partials in
// ascending chunk order, scales the sum and writes the row once. No atomics
// decide an order: two runs are bitwise equal.

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

constexpr int kCombineUnroll = 8;  // chunks in flight per lane group

// One warp per long row: out[rows[i]] = scale · Σ_k partials[k] over the row's
// chunks k in ascending order, scale = 1 / deg (mean) or 1. The lane groups
// load kCombineUnroll·groups chunks at once (group g holds chunk kb + u·groups
// + g); every lane then adds them in ascending k through shuffles, so the
// order of the additions does not depend on the lane layout.
template <int V>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
combine_chunks_kernel(const float* __restrict__ partials, const int64_t* __restrict__ rows,
                      const int64_t* __restrict__ chunk_ptr, const int64_t* __restrict__ chunks,
                      float* __restrict__ out, int64_t n_long, int d, int lanes, int mean) {
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
  float* orow = out + rows[i] * d;
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

// The combine launch of a split CSR (nothing to do without long rows).
inline void combine_chunks(int vw, const float* partials, const int64_t* rows,
                           const int64_t* chunk_ptr, const int64_t* chunks, float* out,
                           int64_t n_long, int d, int mean, cudaStream_t stream) {
  if (n_long <= 0) return;
  const int lanes = lanes_for(d, vw);
  const dim3 grid = grid_for(n_long), block = block_dim();
  if (vw == 4) {
    combine_chunks_kernel<4><<<grid, block, 0, stream>>>(partials, rows, chunk_ptr, chunks, out,
                                                         n_long, d, lanes, mean);
  } else if (vw == 2) {
    combine_chunks_kernel<2><<<grid, block, 0, stream>>>(partials, rows, chunk_ptr, chunks, out,
                                                         n_long, d, lanes, mean);
  } else {
    combine_chunks_kernel<1><<<grid, block, 0, stream>>>(partials, rows, chunk_ptr, chunks, out,
                                                         n_long, d, lanes, mean);
  }
}

}  // namespace warp_csr
