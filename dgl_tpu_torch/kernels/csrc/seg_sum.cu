// K2 for Hopper (sm_90a): sorted segment sum of edge messages by dst, the
// copy_e × sum reduction of message passing.
//
//   out[r] = Σ_{j ∈ [indptr[r], indptr[r+1])} msg[j]      msg (E, W) float32 or bfloat16
//
// The sums and the output are float32 whatever msg's type (seg_sum_bf16: the
// JAX package's _seg_sum_by_dst promotes bf16 messages to an f32 sum,
// dgl_tpu/ops/spmm.py:121-123); a bfloat16 value is converted exactly to
// float as it is loaded.
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
//   * no atomics: a row's sum is combined in a fixed order, so two runs are
//     bitwise equal and small-integer sums are exact;
//   * the lane layout of lanes.cuh, shared with K1 and K3: the warp is cut
//     into P = 32 / L lane groups of L lanes; a group takes one edge at a
//     time and its lanes stride the row of W values with 16-, 8-, 4- or
//     (bfloat16) 2-byte loads, so W = 16 keeps all 32 lanes on 8 edges at
//     once (16 in bfloat16);
//   * each group keeps kUnroll edges in flight to cover the load latency;
//   * the feature tile is picked from W at dispatch: one vector per lane
//     when a row of W floats fits in the L lanes (W = 16, 64), two for wider
//     rows (W = 41, 602), so no load or shuffle is spent on an empty tile;
//   * a warp takes kRowsPerWarp = 2 consecutive rows, whose edges are one
//     contiguous range: one load of 3 row offsets across the lanes, in place
//     of two dependent loads per row, and fewer blocks to schedule (of 1, 2
//     and 4 rows, 2 ran fastest over the dst CSR on the card; PERF.md);
//   * long rows are split (lanes.cuh, "The row split"): a row of more than
//     T edges (graph/split.py: SPLIT_T = 512, chosen for K1's reverse CSR;
//     K2 takes it within 1 % of its own best) is cut into chunks of at most
//     T edges, each one warp's work in the first blocks of the same launch,
//     summed into a partials buffer; one small combine launch adds each long
//     row's chunks in ascending order and writes the row. Without the split
//     one warp walked the reverse reddit CSR's 212,080-edge row alone (35×
//     the dst CSR's time); T bounds any warp's walk at T edges.

#include "lanes.cuh"

namespace {

using namespace warp_csr;

constexpr int kRowsPerWarp = 2;  // consecutive short rows per warp, < kWarp

// The warp's sum of msg rows [start, end) (MT: float or bfloat16), in float,
// written to orow; TILE vectors per lane per feature tile.
template <int V, int TILE, typename MT>
__device__ __forceinline__ void sum_range(const MT* __restrict__ msg, float* __restrict__ orow,
                                          int64_t start, int64_t end, int w, int lanes) {
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;  // edges taken at once
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int nvec = w / V;
  const int64_t stride = static_cast<int64_t>(groups) * kUnroll;

  for (int c0 = 0; c0 < nvec; c0 += lanes * TILE) {
    float acc[TILE][V];
#pragma unroll
    for (int t = 0; t < TILE; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[t][k] = 0.f;

    for (int64_t j0 = start + slot; j0 < end; j0 += stride) {
      float v[kUnroll][TILE][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + static_cast<int64_t>(u) * groups;
        const MT* mr = msg + j * w;
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
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
        for (int t = 0; t < TILE; ++t)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[t][k] += v[u][t][k];
    }

    group_sum<TILE, V>(acc, lanes);
    if (slot == 0) {
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const int c = c0 + col + t * lanes;
        if (c < nvec) store_vec<V>(orow + static_cast<int64_t>(c) * V, acc[t]);
      }
    }
  }
}

// The first n_chunk_blocks blocks sum the long rows' chunks into `partials`;
// each warp of the others takes kRowsPerWarp consecutive rows and writes
// those of at most long_t edges. A minimum of one block per SM in the launch
// bounds leaves ptxas free to give the V = 4, TILE = 1 variant (W = 16, 64)
// 64 registers rather than 48: fewer warps fit on an SM, but each keeps its
// loads in flight, and that variant ran faster so on the card.
template <int V, int TILE, typename IdxT, typename MT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, 1)
seg_sum_kernel(const IdxT* __restrict__ indptr, const MT* __restrict__ msg,
               float* __restrict__ out, int64_t n_rows, int w, int lanes,
               int64_t long_t, const int64_t* __restrict__ chunks, int64_t n_chunks,
               int64_t n_chunk_blocks, float* __restrict__ partials) {
  int64_t item;
  if (warp_item(n_chunk_blocks, item)) {
    if (item >= n_chunks) return;  // uniform across the warp
    sum_range<V, TILE>(msg, partials + item * w, chunks[2 * item], chunks[2 * item + 1], w, lanes);
    return;
  }
  const int64_t r0 = item * kRowsPerWarp;
  if (r0 >= n_rows) return;  // uniform across the warp
  const int nr = static_cast<int>(n_rows - r0 < kRowsPerWarp ? n_rows - r0 : kRowsPerWarp);
  // lane i holds the offset of row r0 + i, i <= nr: the bounds of all the rows
  const int lane = threadIdx.x % kWarp;
  const int64_t bound = lane <= nr ? static_cast<int64_t>(indptr[r0 + lane]) : 0;
  for (int i = 0; i < nr; ++i) {
    const int64_t start = __shfl_sync(0xffffffffu, bound, i);
    const int64_t end = __shfl_sync(0xffffffffu, bound, i + 1);
    if (end - start > long_t) continue;  // a long row: its chunks and the combine write it
    sum_range<V, TILE>(msg, out + (r0 + i) * w, start, end, w, lanes);
  }
}

template <int V, typename IdxT, typename MT>
void launch(int tile, dim3 grid, cudaStream_t stream, const IdxT* indptr, const MT* msg,
            float* out, int64_t n_rows, int w, int lanes, int64_t long_t,
            const int64_t* chunks, int64_t n_chunks, int64_t cb, float* partials) {
  auto kernel = tile == 1 ? seg_sum_kernel<V, 1, IdxT, MT> : seg_sum_kernel<V, 2, IdxT, MT>;
  kernel<<<grid, block_dim(), 0, stream>>>(indptr, msg, out, n_rows, w, lanes, long_t, chunks,
                                           n_chunks, cb, partials);
}

template <typename IdxT, typename MT>
void dispatch(const IdxT* indptr, const MT* msg, float* out, int64_t n_rows, int w,
              int64_t long_t, const int64_t* rows, const int64_t* chunk_ptr, int64_t n_long,
              const int64_t* chunks, int64_t n_chunks, float* partials, cudaStream_t stream) {
  const int vw = vec_width(w, {{msg, static_cast<int>(sizeof(MT))}, {out, 4}, {partials, 4}});
  const int lanes = lanes_for(w, vw);
  const int tile = w / vw <= lanes ? 1 : 2;
  const int64_t cb = chunk_blocks(n_chunks);
  const int64_t row_items = (n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const dim3 grid(static_cast<unsigned>(cb + grid_for(row_items).x));
  if (vw == 8) {
    if constexpr (sizeof(MT) == 2)
      launch<8>(tile, grid, stream, indptr, msg, out, n_rows, w, lanes, long_t, chunks,
                n_chunks, cb, partials);
  } else if (vw == 4) {
    launch<4>(tile, grid, stream, indptr, msg, out, n_rows, w, lanes, long_t, chunks,
              n_chunks, cb, partials);
  } else if (vw == 2) {
    launch<2>(tile, grid, stream, indptr, msg, out, n_rows, w, lanes, long_t, chunks,
              n_chunks, cb, partials);
  } else {
    launch<1>(tile, grid, stream, indptr, msg, out, n_rows, w, lanes, long_t, chunks,
              n_chunks, cb, partials);
  }
  combine_chunks(partials, rows, chunk_ptr, chunks, out, n_long, w, 0, stream);
}

template <typename MT>
int run(const void* indptr, int indptr_is_int64, const void* msg, void* out, long long n_rows,
        int w, long long long_t, const void* rows, const void* chunk_ptr, long long n_long,
        const void* chunks, long long n_chunks, void* partials, void* stream) {
  if (n_rows <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const auto* mp = static_cast<const MT*>(msg);
  auto* op = static_cast<float*>(out);
  const auto* rp = static_cast<const int64_t*>(rows);
  const auto* cp = static_cast<const int64_t*>(chunk_ptr);
  const auto* ch = static_cast<const int64_t*>(chunks);
  auto* pp = static_cast<float*>(partials);
  auto s = static_cast<cudaStream_t>(stream);
  if (indptr_is_int64) {
    dispatch(static_cast<const int64_t*>(indptr), mp, op, n_rows, w, long_t, rp, cp,
             n_long, ch, n_chunks, pp, s);
  } else {
    dispatch(static_cast<const int32_t*>(indptr), mp, op, n_rows, w, long_t, rp, cp,
             n_long, ch, n_chunks, pp, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes: msg float (seg_sum_f32) or
// bfloat16 (seg_sum_bf16), out float either way. Pointers are device
// pointers. The row split as for csr_spmm_f32. Launches the kernel, then the
// combine when n_long > 0; returns cudaGetLastError().
#define SEG_SUM_ENTRY(NAME, MT)                                                                \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* msg, void* out,     \
                      long long n_rows, int w, long long long_t, const void* rows,             \
                      const void* chunk_ptr, long long n_long, const void* chunks,             \
                      long long n_chunks, void* partials, void* stream) {                      \
    return run<MT>(indptr, indptr_is_int64, msg, out, n_rows, w, long_t, rows, chunk_ptr,      \
                   n_long, chunks, n_chunks, partials, stream);                                \
  }

SEG_SUM_ENTRY(seg_sum_f32, float)
SEG_SUM_ENTRY(seg_sum_bf16, __nv_bfloat16)
