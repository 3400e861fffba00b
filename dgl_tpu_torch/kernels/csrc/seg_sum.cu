// K2 for Hopper (sm_90a): sorted segment sum of edge messages by dst, the
// copy_e × sum reduction of message passing.
//
//   out[r] = Σ_{j ∈ [indptr[r], indptr[r+1])} msg[j]      msg (E, W) float32
//
// Replaces: dgl_tpu/kernels/piece_reduce.py:piece_partials (body _kernel,
// wrapped by segment_sum_mxu). The TPU kernel multiplies each block of 128
// edges by a one-hot (slot × edge) matrix on the MXU and then combines the
// per-block pieces with a small sorted scatter, because a systolic array
// reduces a dense tile faster than it can scan. On the card the messages of
// a dst row are one contiguous range of the dst-sorted edge array, so the
// kernel reads that range and sums it: no one-hot, no gather, no pieces.
//
// What bounds it on this card: bytes. It must read msg once (E·W·4 B) and
// indptr, and write out once (N·W·4 B); the E·W additions are far below the
// float32 peak. At the GAT path's shape (reddit with self-loops, W = 16)
// that is about 773 MB, some 0.23 ms at 3.35 TB/s.
//
// What the design does about it:
//   * one warp per row, no atomics: a row's sum is combined in a fixed order,
//     so two runs are bitwise equal and small-integer sums are exact;
//   * the lane layout of lanes.cuh, shared with K1 and K3: the warp is cut
//     into P = 32 / L lane groups of L lanes; a group takes one edge at a
//     time and its lanes stride the row of W floats with 16-, 8- or 4-byte
//     loads, so W = 16 keeps all 32 lanes on 8 edges at once;
//   * each group keeps kUnroll edges in flight to cover the load latency;
//   * wide rows run as feature tiles of L·kTile vectors, so the sums stay in
//     registers for any W;
//   * the lane groups are combined with warp shuffles and written once.
// Known limit: a row is one warp, so a hub row is serial. The reverse CSR of
// the synthetic reddit graph with self-loops has a row of 212,080 edges;
// splitting such rows is later work.

#include "lanes.cuh"

namespace {

using namespace warp_csr;

constexpr int kTile = 2;  // vectors per lane per feature tile

template <int V, typename IdxT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
seg_sum_kernel(const IdxT* __restrict__ indptr, const float* __restrict__ msg,
               float* __restrict__ out, int64_t n_rows, int w, int lanes) {
  const int64_t row = warp_row();
  if (row >= n_rows) return;  // uniform across the warp
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;  // edges taken at once
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  const int nvec = w / V;
  const int64_t stride = static_cast<int64_t>(groups) * kUnroll;

  for (int c0 = 0; c0 < nvec; c0 += lanes * kTile) {
    float acc[kTile][V];
#pragma unroll
    for (int t = 0; t < kTile; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[t][k] = 0.f;

    for (int64_t j0 = start + slot; j0 < end; j0 += stride) {
      float v[kUnroll][kTile][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + static_cast<int64_t>(u) * groups;
        const float* mr = msg + j * w;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const int c = c0 + col + t * lanes;
          if (j < end && c < nvec) {
            load_vec<V>(mr + static_cast<int64_t>(c) * V, v[u][t]);
          } else {
#pragma unroll
            for (int k = 0; k < V; ++k) v[u][t][k] = 0.f;
          }
        }
      }
      // edges of a group are added in ascending order of j
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int t = 0; t < kTile; ++t)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[t][k] += v[u][t][k];
    }

    group_sum<kTile, V>(acc, lanes);
    if (slot == 0) {
      float* orow = out + row * w;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int c = c0 + col + t * lanes;
        if (c < nvec) store_vec<V>(orow + static_cast<int64_t>(c) * V, acc[t]);
      }
    }
  }
}

template <typename IdxT>
void dispatch(const IdxT* indptr, const float* msg, float* out, int64_t n_rows, int w,
              cudaStream_t stream) {
  const int vw = vec_width(w, reinterpret_cast<uintptr_t>(msg) | reinterpret_cast<uintptr_t>(out));
  const int lanes = lanes_for(w, vw);
  const dim3 grid = grid_for(n_rows), block = block_dim();
  if (vw == 4) {
    seg_sum_kernel<4, IdxT><<<grid, block, 0, stream>>>(indptr, msg, out, n_rows, w, lanes);
  } else if (vw == 2) {
    seg_sum_kernel<2, IdxT><<<grid, block, 0, stream>>>(indptr, msg, out, n_rows, w, lanes);
  } else {
    seg_sum_kernel<1, IdxT><<<grid, block, 0, stream>>>(indptr, msg, out, n_rows, w, lanes);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers.
// Returns cudaGetLastError() after the launch.
extern "C" int seg_sum_f32(const void* indptr, int indptr_is_int64, const void* msg, void* out,
                           long long n_rows, int w, void* stream) {
  if (n_rows <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const auto* mp = static_cast<const float*>(msg);
  auto* op = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (indptr_is_int64) {
    dispatch(static_cast<const int64_t*>(indptr), mp, op, n_rows, w, s);
  } else {
    dispatch(static_cast<const int32_t*>(indptr), mp, op, n_rows, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
