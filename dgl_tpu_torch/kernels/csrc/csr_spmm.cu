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
// The rows of x are float or bfloat16 (csr_spmm_bf16: the JAX package's
// bf16 messages, lane_spmm's compute_dtype = bfloat16, lane_spmm.py:425-451).
// A bfloat16 row is read 16, 8, 4 or 2 bytes a lane (8, 4, 2 or 1 values)
// and converted exactly to float as it is loaded; the edge weight stays
// float, w·x is one float FMA into a float sum, and the chunk partials, the
// combine and the output are float. (The lane kernel rounds w·x to bfloat16
// before its float sum, lane_spmm.py:390; this kernel keeps the product in
// float.) Per launch a bfloat16 x moves half the bytes of a float one.
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
//     a time and its lanes stride the feature dimension with 16-, 8-, 4- or
//     (bfloat16) 2-byte loads (V = 4, 2 or 1 floats, 8, 4, 2 or 1 bfloat16
//     values), so a narrow row (D = 16: L = 4, P = 8 in float, L = 2,
//     P = 16 in bfloat16) still keeps all 32 lanes busy;
//   * each lane group keeps kUnroll edges in flight (all index loads first,
//     then all row loads), to hide the two dependent L2 latencies;
//   * wide rows (D = 602 for the hoisted precompute) run as feature tiles of
//     L·kTile vectors, so the accumulators stay in registers for any D;
//   * the lane groups are combined with warp shuffles and written once;
//   * long rows are split (lanes.cuh, "The row split"): a row of more than
//     T edges (graph/split.py: SPLIT_T = 512, the fastest of 256, 512 and
//     1024 on reddit's reverse CSR) is cut into chunks of at most T edges,
//     each one warp's work in the first blocks of the same launch, summed
//     into a partials buffer; one small combine launch adds each long row's
//     chunks in ascending order, applies the mean's 1 / deg of the whole
//     row and writes it. The edge weight is applied per edge as for any
//     row. Without the split one warp walked the reverse reddit CSR's
//     212,102-edge row alone, and the launch took 22× its forward's time;
//     T bounds any warp's walk at T edges while rows of at most T edges
//     keep the per-row code.

#include "lanes.cuh"

namespace {

using namespace warp_csr;

// Vectors per lane per feature tile: 16 float accumulators a lane at V = 4
// (float's widest load), and as many at bfloat16's V = 8.
template <int V>
constexpr int kTile = V == 8 ? 2 : 4;

// The warp's sum of edges [start, end), times `scale`, written to orow; x's
// rows are XT (float or bfloat16), the sums float.
template <int V, typename XT>
__device__ __forceinline__ void spmm_range(const int32_t* __restrict__ indices,
                                           const float* __restrict__ w,
                                           const XT* __restrict__ x, float* __restrict__ orow,
                                           int64_t start, int64_t end, int d, int lanes,
                                           float scale) {
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;  // edges taken at once
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int nvec = d / V;
  const int64_t stride = static_cast<int64_t>(groups) * kUnroll;

  for (int c0 = 0; c0 < nvec; c0 += lanes * kTile<V>) {
    float acc[kTile<V>][V];
#pragma unroll
    for (int t = 0; t < kTile<V>; ++t)
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
        const XT* xr = x + static_cast<int64_t>(src[u]) * d;
#pragma unroll
        for (int t = 0; t < kTile<V>; ++t) {
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

    group_sum<kTile<V>, V>(acc, lanes);
    if (slot == 0) {
#pragma unroll
      for (int t = 0; t < kTile<V>; ++t) {
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

// The first n_chunk_blocks blocks sum the long rows' chunks into `partials`;
// the others take one row per warp and write the rows of at most long_t edges.
template <int V, typename IdxT, typename XT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
csr_spmm_kernel(const IdxT* __restrict__ indptr, const int32_t* __restrict__ indices,
                const float* __restrict__ w, const XT* __restrict__ x,
                float* __restrict__ out, int64_t n_rows, int d, int lanes, int mean,
                int64_t long_t, const int64_t* __restrict__ chunks, int64_t n_chunks,
                int64_t n_chunk_blocks, float* __restrict__ partials) {
  int64_t item;
  if (warp_item(n_chunk_blocks, item)) {
    if (item >= n_chunks) return;  // uniform across the warp
    spmm_range<V>(indices, w, x, partials + item * d, chunks[2 * item], chunks[2 * item + 1], d,
                  lanes, 1.f);
    return;
  }
  const int64_t row = item;
  if (row >= n_rows) return;  // uniform across the warp
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  const int64_t deg = end - start;
  if (deg > long_t) return;  // a long row: its chunks and the combine write it
  float scale = 1.f;
  if (mean) scale = 1.f / static_cast<float>(deg > 1 ? deg : 1);
  spmm_range<V>(indices, w, x, out + row * d, start, end, d, lanes, scale);
}

template <typename IdxT, typename XT>
void dispatch(const IdxT* indptr, const int32_t* indices, const float* w, const XT* x,
              float* out, int64_t n_rows, int d, int mean, int64_t long_t, const int64_t* rows,
              const int64_t* chunk_ptr, int64_t n_long, const int64_t* chunks, int64_t n_chunks,
              float* partials, cudaStream_t stream) {
  const int vw = vec_width(d, {{x, static_cast<int>(sizeof(XT))}, {out, 4}, {partials, 4}});
  const int lanes = lanes_for(d, vw);
  const int64_t cb = chunk_blocks(n_chunks);
  const dim3 grid(static_cast<unsigned>(cb + grid_for(n_rows).x)), block = block_dim();
  auto kernel = csr_spmm_kernel<1, IdxT, XT>;
  if (vw == 8) {
    if constexpr (sizeof(XT) == 2) kernel = csr_spmm_kernel<8, IdxT, XT>;
  } else if (vw == 4) {
    kernel = csr_spmm_kernel<4, IdxT, XT>;
  } else if (vw == 2) {
    kernel = csr_spmm_kernel<2, IdxT, XT>;
  }
  kernel<<<grid, block, 0, stream>>>(indptr, indices, w, x, out, n_rows, d, lanes, mean, long_t,
                                     chunks, n_chunks, cb, partials);
  combine_chunks(partials, rows, chunk_ptr, chunks, out, n_long, d, mean, stream);
}

template <typename XT>
int run(const void* indptr, int indptr_is_int64, const void* indices, const void* w,
        const void* x, void* out, long long n_rows, int d, int mean, long long long_t,
        const void* rows, const void* chunk_ptr, long long n_long, const void* chunks,
        long long n_chunks, void* partials, void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const auto* idx = static_cast<const int32_t*>(indices);
  const auto* wp = static_cast<const float*>(w);
  const auto* xp = static_cast<const XT*>(x);
  auto* op = static_cast<float*>(out);
  const auto* rp = static_cast<const int64_t*>(rows);
  const auto* cp = static_cast<const int64_t*>(chunk_ptr);
  const auto* ch = static_cast<const int64_t*>(chunks);
  auto* pp = static_cast<float*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  if (indptr_is_int64) {
    dispatch(static_cast<const int64_t*>(indptr), idx, wp, xp, op, n_rows, d, mean, long_t, rp, cp,
             n_long, ch, n_chunks, pp, s);
  } else {
    dispatch(static_cast<const int32_t*>(indptr), idx, wp, xp, op, n_rows, d, mean, long_t, rp, cp,
             n_long, ch, n_chunks, pp, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes: x float (csr_spmm_f32) or
// bfloat16 (csr_spmm_bf16); everything else the same. Pointers are device
// pointers; `w` may be null. The row split (graph/split.py): rows of more
// than long_t edges are the n_long `rows`, whose chunks [chunks[2k],
// chunks[2k+1]) are chunk_ptr[i]..chunk_ptr[i+1]; `partials` holds n_chunks ×
// d floats. Launches the kernel, then the combine when n_long > 0; returns
// cudaGetLastError().
#define CSR_SPMM_ENTRY(NAME, XT)                                                               \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* indices,            \
                      const void* w, const void* x, void* out, long long n_rows, int d,        \
                      int mean, long long long_t, const void* rows, const void* chunk_ptr,     \
                      long long n_long, const void* chunks, long long n_chunks,                \
                      void* partials, void* stream) {                                          \
    return run<XT>(indptr, indptr_is_int64, indices, w, x, out, n_rows, d, mean, long_t, rows, \
                   chunk_ptr, n_long, chunks, n_chunks, partials, stream);                     \
  }

CSR_SPMM_ENTRY(csr_spmm_f32, float)
CSR_SPMM_ENTRY(csr_spmm_bf16, __nv_bfloat16)
