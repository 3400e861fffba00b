// K1 for Hopper (sm_90a): CSR SpMM, the copy_u / u_mul_e × sum / mean
// aggregation of message passing.
//
//   out[r] = scale_r * Σ_{j ∈ [indptr[r], indptr[r+1])} (w ? w[j] : 1) * x[indices[j]]
//   scale_r = mean ? 1 / max(indptr[r+1] - indptr[r], 1) : 1
//
// Replaces: dgl_tpu/kernels/lane_spmm.py:lane_spmm (body _make_kernel, gather
// _window_gather, host planner build_plan). The TPU kernel regroups edges
// into 128-edge runs per (dst group, src window), lane-gathers a
// VMEM-resident feature-major x and scatters with one-hot MXU matmuls. None
// of that is needed here: the card gathers rows from device memory and L2
// directly, so the kernel walks the dst-sorted CSR as it is. The backward of
// gspmm is the same launch over the reverse CSR.
//
// What bounds it on this card: bytes. Per launch it must read indices (E·4 B),
// indptr, x once (N_src·D·4 B) and write out once (N_dst·D·4 B); at the main
// path's shape (reddit, D = 16) that is about 78 MB, some 23 µs at 3.35 TB/s,
// while the arithmetic (E·D FMAs) is far below the float32 peak. The
// repeated gathers of x rows hit L2 (x is 15 MB at D = 16, L2 is 50 MB), so
// the real cost is the latency of two dependent loads per edge (index, then
// row) and the number of them in flight.
//
// What the design does about it:
//   * one warp per row, no atomics: each row's sum is combined in a fixed
//     order, so results are deterministic from run to run;
//   * the lane layout of lanes.cuh, shared with K2 and K3: the warp is cut
//     into P = 32 / L lane groups of L lanes; each group takes one edge at
//     a time and its lanes stride the feature dimension with 16-, 8- or
//     4-byte loads (V = 4, 2 or 1 floats), so a narrow row (D = 16: L = 4,
//     P = 8) still keeps all 32 lanes busy on 8 edges;
//   * each lane group keeps kUnroll edges in flight (all index loads first,
//     then all row loads), to hide the two dependent L2 latencies;
//   * wide rows (D = 602 for the hoisted precompute) run as feature tiles of
//     L·kTile vectors, so the accumulators stay in registers for any D;
//   * the lane groups are combined with warp shuffles and written once.
// Known limit: a row is one warp, so a hub row is serial. The reverse CSR
// of the synthetic reddit graph has a row of about 212,000 edges; splitting
// such rows across warps is later work.

#include "lanes.cuh"

namespace {

using namespace warp_csr;

constexpr int kTile = 4;  // vectors per lane per feature tile

template <int V, typename IdxT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_spmm_kernel(const IdxT* __restrict__ indptr, const int32_t* __restrict__ indices,
                const float* __restrict__ w, const float* __restrict__ x,
                float* __restrict__ out, int64_t n_rows, int d, int lanes, int mean) {
  const int64_t row = warp_row();
  if (row >= n_rows) return;  // uniform across the warp
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;  // edges taken at once
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  const int nvec = d / V;
  float scale = 1.f;
  if (mean) {
    const int64_t deg = end - start;
    scale = 1.f / static_cast<float>(deg > 1 ? deg : 1);
  }
  const int64_t stride = static_cast<int64_t>(groups) * kUnroll;

  for (int c0 = 0; c0 < nvec; c0 += lanes * kTile) {
    float acc[kTile][V];
#pragma unroll
    for (int t = 0; t < kTile; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[t][k] = 0.f;

    for (int64_t j0 = start + slot; j0 < end; j0 += stride) {
      int32_t src[kUnroll];
      float wt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + static_cast<int64_t>(u) * groups;
        const bool ok = j < end;
        src[u] = ok ? __ldg(indices + j) : -1;
        wt[u] = ok ? (w != nullptr ? __ldg(w + j) : 1.f) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (src[u] < 0) continue;
        const float* xr = x + static_cast<int64_t>(src[u]) * d;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const int c = c0 + col + t * lanes;
          if (c < nvec) {
            float v[V];
            load_vec<V>(xr + static_cast<int64_t>(c) * V, v);
#pragma unroll
            for (int k = 0; k < V; ++k) acc[t][k] = fmaf(wt[u], v[k], acc[t][k]);
          }
        }
      }
    }

    group_sum<kTile, V>(acc, lanes);
    if (slot == 0) {
      float* orow = out + row * d;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int c = c0 + col + t * lanes;
        if (c < nvec) {
          float v[V];
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = acc[t][k] * scale;
          store_vec<V>(orow + static_cast<int64_t>(c) * V, v);
        }
      }
    }
  }
}

template <typename IdxT>
void dispatch(const IdxT* indptr, const int32_t* indices, const float* w, const float* x,
              float* out, int64_t n_rows, int d, int mean, cudaStream_t stream) {
  const int vw = vec_width(d, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out));
  const int lanes = lanes_for(d, vw);
  const dim3 grid = grid_for(n_rows), block = block_dim();
  if (vw == 4) {
    csr_spmm_kernel<4, IdxT><<<grid, block, 0, stream>>>(indptr, indices, w, x, out, n_rows, d,
                                                         lanes, mean);
  } else if (vw == 2) {
    csr_spmm_kernel<2, IdxT><<<grid, block, 0, stream>>>(indptr, indices, w, x, out, n_rows, d,
                                                         lanes, mean);
  } else {
    csr_spmm_kernel<1, IdxT><<<grid, block, 0, stream>>>(indptr, indices, w, x, out, n_rows, d,
                                                         lanes, mean);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers;
// `w` may be null. Returns cudaGetLastError() after the launch.
extern "C" int csr_spmm_f32(const void* indptr, int indptr_is_int64, const void* indices,
                            const void* w, const void* x, void* out, long long n_rows,
                            int d, int mean, void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* wp = static_cast<const float*>(w);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (indptr_is_int64) {
    dispatch(static_cast<const int64_t*>(indptr), idx, wp, xp, op, n_rows, d, mean, s);
  } else {
    dispatch(static_cast<const int32_t*>(indptr), idx, wp, xp, op, n_rows, d, mean, s);
  }
  return static_cast<int>(cudaGetLastError());
}
