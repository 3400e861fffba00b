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

}  // namespace warp_csr
