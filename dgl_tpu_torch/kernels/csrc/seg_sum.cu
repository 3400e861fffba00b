// K2 for Hopper (sm_90a): sorted segment sum of edge messages by dst, the
// copy_e × sum reduction of message passing.
//
//   out[r] = Σ_{j ∈ [indptr[r], indptr[r+1])} msg[j]      msg (E, W) float32 or bfloat16
//
// The sums and the output are float32 whatever msg's type (seg_sum_bf16: the
// JAX package's _seg_sum_by_dst promotes bf16 messages to an f32 sum,
// dgl_tpu/ops/spmm.py:121-123); a bfloat16 value is converted exactly to
// float as it is read.
//
// Replaces: dgl_tpu/kernels/piece_reduce.py:piece_partials (body _kernel,
// wrapped by segment_sum_mxu). The TPU kernel multiplies each block of 128
// edges by a one-hot (slot × edge) matrix on the MXU and then combines the
// per-block pieces with a small sorted scatter, because a systolic array
// reduces a dense tile faster than it can scan. On the card the messages of
// a dst row are one contiguous range of the dst-sorted edge array, so the
// kernel reads that range and sums it: no one-hot, no gather, no pieces.
//
// What bounds it on this card: bytes. It must read msg once (E·W·4 B, or 2
// in bfloat16) and indptr, and write out once (N·W·4 B); the E·W additions
// are far below the float32 peak. At the GAT path's shape (reddit with
// self-loops, W = 16) that is about 773 MB, some 0.23 ms at 3.35 TB/s.
//
// The design (one launch a call; k2_p1_geometry.h sizes it):
//   * a warp takes a run of consecutive rows of about run_units rows plus
//     edges (k1_geometry.h's runs(), shared with K1), found by a 32-way
//     search of r + indptr[r]. A run's messages are one contiguous span of
//     msg, less the long rows' (below);
//   * the span streams through a ring of 2 stages of about 2 KB a warp. A stage is the next stage_rows message rows,
//     copied as the 16-byte-aligned span that covers them, whatever W and
//     msg's alignment: by one TMA bulk copy from 144-byte spans up (K1's
//     crossover), by cp.async copies of 16 bytes over the lanes below; both
//     complete on the stage's mbarrier, which expects one arrival, lane 0's
//     (32 lanes arriving on one barrier serialise), the cp.async copies in
//     the stage's commit group. A span that would cross msg's first or last
//     byte moves only the values inside msg. No lane loads a message from
//     device memory, so no register waits on one;
//   * the lanes read the staged rows at the alignment every row start shares,
//     16 bytes where W allows it in either type (float32 W % 4 == 0,
//     bfloat16 W % 8 == 0): a lane group of L lanes takes a row, and a pass
//     sums up to 4 staged rows a group (2 where a lane sums more than one
//     vector); the groups' sums are combined by a butterfly of shuffles when
//     the row ends, and the row is written once. Rows wider than 512 values
//     run as column pieces, each a walk of its own, one row's piece a stage;
//   * long rows keep the row split (lanes.cuh): the rows the plan lists
//     (more than T = 512 edges, graph/split.py) are cut into chunks of at
//     most T edges, one chunk a warp of the first blocks, summed into its
//     partials row; the run warps skip the listed rows. The combine is folded
//     into the launch (lanes.cuh's count_chunks, as K1): the chunk warp that
//     completes a row's count on the plan's counters adds the row's partials
//     in ascending chunk order and writes the row. No atomic decides an order
//     of additions, so two runs are bitwise equal and small-integer sums
//     exact;
//   * a run warp takes at least 16 rows plus edges (K1's take 64), so that
//     a small CSR (a molhiv batch's 1,679 rows) still spreads over the card;
//   * blocks of 4 warps (about 16 KB) and at most 64 registers a thread, so
//     that 8 share an SM: on the card more warps beat more or larger stages
//     a warp (k2_p1_geometry.h).

#include "async_copy.cuh"
#include "k2_p1_geometry.h"
#include "lanes.cuh"

#include <type_traits>

namespace {

using namespace async_copy;
using namespace warp_csr;

using k2::kStages;
using k2::kWarps;

struct Params {
  const void* indptr;  // int32 or int64 (ip64)
  uint64_t msg, msg_end;  // msg's bytes: [msg, msg_end)
  float* out;
  float* partials;  // (n_chunks, d)
  const int64_t* rows;
  const int64_t* chunk_ptr;
  const int64_t* chunks;
  int32_t* counters;  // one a long row, 0 between launches
  int64_t n_rows, n_long, n_chunks, n_chunk_blocks, run_units, n_runs, n_units;
  int ip64, d, row_bytes, piece_cols, lanes, stage_bytes, stage_rows, warp_smem;
};

__device__ __forceinline__ int64_t indptr_at(const Params& p, int64_t i) {
  return p.ip64 ? static_cast<const int64_t*>(p.indptr)[i]
                : static_cast<int64_t>(static_cast<const int32_t*>(p.indptr)[i]);
}

// A warp's shared memory (k2_p1_geometry.h sizes it): kStages stages of
// stage_bytes, one mbarrier a stage, and each stage's row count and the
// offset of its first row in its span.
struct Ring {
  char* stages;
  uint64_t* bars;  // (kStages)
  int* counts;     // (kStages): rows staged (0: the stream is done)
  int* offs;       // (kStages)

  __device__ __forceinline__ Ring(char* base, int stage_bytes) {
    stages = base;
    bars = reinterpret_cast<uint64_t*>(base + kStages * stage_bytes);
    counts = reinterpret_cast<int*>(bars + kStages);
    offs = counts + kStages;
  }
};

// The producer side of one warp's ring: the stream of message rows [f, end),
// less the listed long rows' [skip_s, skip_e) (the chunk warps take them),
// stage_rows rows (or one row's piece) a stage, each stage one span.
template <typename MT>
struct Stream {
  using Raw = std::conditional_t<sizeof(MT) == 4, uint32_t, uint16_t>;
  // the cursor and the next skip: the listed long row k below r1 (a run), or
  // the gap from chunk k's end to chunk k + 1's, below r1 (chunks)
  int64_t f, end, skip_s, skip_e, k, r1;
  bool chunks;
  uint64_t piece_off;  // the walk's first column, in bytes
  int piece_bytes;

  __device__ __forceinline__ void next_skip(const Params& p) {
    skip_s = skip_e = kNone;
    if (chunks) {
      if (k + 1 < r1) {
        skip_s = p.chunks[2 * k + 1];
        skip_e = p.chunks[2 * k + 2];
      }
    } else if (k < p.n_long) {
      const int64_t r = p.rows[k];
      if (r < r1) {
        skip_s = indptr_at(p, r);
        skip_e = indptr_at(p, r + 1);
      }
    }
  }

  // The values of the 16-byte chunk at a that lie inside msg, one at a time
  // (only a chunk at msg's first or last bytes).
  __device__ __forceinline__ void copy_inside(const Params& p, char* dst, uint64_t a) const {
#pragma unroll
    for (int o = 0; o < 16; o += static_cast<int>(sizeof(Raw))) {
      if (a + o >= p.msg && a + o + sizeof(Raw) <= p.msg_end)
        *reinterpret_cast<Raw*>(dst + o) = *reinterpret_cast<const Raw*>(a + o);
    }
  }

  // Fill stage s (ring slot s % kStages) and commit its cp.async group. Its
  // mbarrier expects one arrival, lane 0's, with the TMA copy's byte count
  // (32 lanes arriving on one barrier serialise); copies by cp.async land in
  // the stage's group, which wait() waits for.
  __device__ __forceinline__ void issue(const Params& p, const Ring& ring, uint32_t s) {
    const int lane = threadIdx.x % kWarp;
    while (f == skip_s) {  // adjacent long rows: skip each
      f = skip_e;
      ++k;
      next_skip(p);
    }
    const int64_t stop = skip_s < end ? skip_s : end;
    const int n = f < stop ? static_cast<int>(min(static_cast<int64_t>(p.stage_rows), stop - f)) : 0;
    const int b = static_cast<int>(s % kStages);
    uint64_t* bar = ring.bars + b;
    char* stage = ring.stages + b * p.stage_bytes;
    if (n == 0) {
      if (lane == 0) {
        ring.counts[b] = 0;
        mbar_arrive(bar);
      }
      cp_async_commit();
      return;
    }
    const uint64_t a = p.msg + static_cast<uint64_t>(f) * p.row_bytes + piece_off;
    const int off = static_cast<int>(a & 15u);
    const uint64_t a0 = a - off;
    const uint32_t span = static_cast<uint32_t>(
        (off + static_cast<int64_t>(n - 1) * p.row_bytes + piece_bytes + 15) & ~int64_t{15});
    if (lane == 0) {
      ring.counts[b] = n;
      ring.offs[b] = off;
    }
    if (span >= k1::kBulkMinBytes && a0 >= p.msg && a0 + span <= p.msg_end) {
      if (lane == 0) {
        mbar_arrive_tx(bar, span);
        bulk_copy(stage, a0, span, bar);
      }
    } else {
      for (uint32_t o = 16u * lane; o < span; o += 16u * kWarp) {
        if (a0 + o >= p.msg && a0 + o + 16 <= p.msg_end) {
          cp_async16(stage + o, a0 + o);
        } else {
          copy_inside(p, stage + o, a0 + o);
        }
      }
      if (lane == 0) mbar_arrive(bar);
    }
    cp_async_commit();
    f += n;
  }

  // Wait for stage s, issued kStages - 1 stages before the newest.
  __device__ __forceinline__ void wait(const Ring& ring, uint32_t s) const {
    mbar_wait(ring.bars + s % kStages, (s / kStages) & 1u);
    cp_async_wait<kStages - 1>();
    __syncwarp();
  }
};

// One column piece of one warp's work: the rows [r0, r1) of a run (the
// plan's long rows among them skipped, k0 the first listed at or after r0),
// or the chunks [r0, r1) (`chunks`), each summed into its partials row; one
// stream over their messages. A lane sums kVecs vectors of V values.
// `ticket` numbers this warp's stages across its walks (the mbarriers'
// phases).
template <int V, int kVecs, typename MT>
__device__ __forceinline__ void walk(const Params& p, const Ring& ring, int64_t r0, int64_t r1,
                                     int64_t k0, bool chunks, int piece, uint32_t& ticket) {
  constexpr int kPass = kVecs == 1 ? 4 : 2;  // staged rows a lane group sums a pass
  const int lane = threadIdx.x % kWarp;
  const int col0 = piece * p.piece_cols;
  const int nvec = min(p.piece_cols, p.d - col0) / V;
  const int lanes = p.lanes, groups = kWarp / lanes, g = lane / lanes, col = lane % lanes;
  const auto indptr = [&p](int64_t i) { return indptr_at(p, i); };

  Stream<MT> st;
  st.k = chunks ? r0 : k0;
  st.r1 = r1;
  st.chunks = chunks;
  st.piece_off = static_cast<uint64_t>(col0) * sizeof(MT);
  st.piece_bytes = nvec * V * static_cast<int>(sizeof(MT));
  st.f = chunks ? p.chunks[2 * r0] : indptr(r0);
  st.end = chunks ? p.chunks[2 * r1 - 1] : indptr(r1);
  st.next_skip(p);
  const uint32_t first = ticket;
  uint32_t issued = first;
  for (; issued < first + kStages; ++issued) st.issue(p, ring, issued);

  float acc[kVecs][V];
#pragma unroll
  for (int t = 0; t < kVecs; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;

  RowOffsets offs;
  if (!chunks) offs.init(indptr, p.n_rows, r0);
  int64_t kc = k0;
  int64_t next_long = !chunks && kc < p.n_long ? p.rows[kc] : kNone;
  uint32_t stage = first;  // the stage being summed, once `started`
  bool started = false;
  int pos = 0, cnt = 0;
  const char* rows = nullptr;  // the stage's first staged row
  for (int64_t r = r0; r < r1; ++r) {
    int64_t deg;
    float* orow;
    if (chunks) {
      deg = p.chunks[2 * r + 1] - p.chunks[2 * r];
      orow = p.partials + r * p.d + col0;
    } else {
      int64_t s0, e0;
      offs.row(indptr, p.n_rows, r, s0, e0);
      if (r == next_long) {  // its chunks and the fold write it
        ++kc;
        next_long = kc < p.n_long ? p.rows[kc] : kNone;
        continue;
      }
      deg = e0 - s0;
      orow = p.out + r * p.d + col0;
    }
    for (int64_t rem = deg; rem > 0;) {
      if (pos == cnt) {  // the next stage: refill the one just summed, wait for the next
        if (started) {
          __syncwarp();
          st.issue(p, ring, issued++);
          ++stage;
        }
        started = true;
        st.wait(ring, stage);
        const int b = static_cast<int>(stage % kStages);
        cnt = ring.counts[b];
        rows = ring.stages + b * p.stage_bytes + ring.offs[b];
        pos = 0;
        if (cnt == 0) break;  // a plan that does not match the CSR: leave the row
      }
      // a pass: each lane group sums up to kPass staged rows of this row, in
      // ascending order within the group
      const int take = static_cast<int>(
          min(static_cast<int64_t>(min(kPass * groups, cnt - pos)), rem));
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int j = u * groups + g;
        if (j < take) {
          const MT* xr = reinterpret_cast<const MT*>(rows + (pos + j) * p.row_bytes);
#pragma unroll
          for (int t = 0; t < kVecs; ++t) {
            const int c = col + t * lanes;
            if (c < nvec) {
              float v[V];
              lds_vec<V>(xr + c * V, v);
#pragma unroll
              for (int k = 0; k < V; ++k) acc[t][k] += v[k];
            }
          }
        }
      }
      pos += take;
      rem -= take;
    }
    // the row's sum: the lane groups' sums by the butterfly, written once
    if (groups > 1) {
#pragma unroll
      for (int t = 0; t < kVecs; ++t)
#pragma unroll
        for (int k = 0; k < V; ++k) acc[t][k] = group_sum(acc[t][k], lanes);
    }
    if (g == 0) {
#pragma unroll
      for (int t = 0; t < kVecs; ++t) {
        const int c = col + t * lanes;
        if (c < nvec) store_vec<V>(orow + c * V, acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < kVecs; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) acc[t][k] = 0.f;
  }
  // the stages issued past the last one summed are empty (or, for a plan
  // that does not match the CSR, unread): let them land before the ring is
  // reused
  for (uint32_t s = started ? stage + 1 : first; s < issued; ++s)
    mbar_wait(ring.bars + s % kStages, (s / kStages) & 1u);
  cp_async_wait_all();
  __syncwarp();
  ticket = issued;
}

// The first n_chunk_blocks blocks: one chunk a warp, then the fold; the
// others: one run of rows a warp.
// k2::kMinBlocks blocks an SM, all their shared memory allows: at most 64
// registers a thread (unbounded, ptxas took 80-124, and registers capped the
// SM at 4-5 blocks; PERF.md).
template <int V, int kVecs, typename MT>
__global__ void __launch_bounds__(kWarp * kWarps, k2::kMinBlocks)
seg_sum_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) char smem[];
  const Ring ring(smem + (threadIdx.x / kWarp) * p.warp_smem, p.stage_bytes);
  const int lane = threadIdx.x % kWarp;
  const int pieces = (p.d + p.piece_cols - 1) / p.piece_cols;
  if (lane == 0)  // one arrival a stage, lane 0's
    for (int b = 0; b < kStages; ++b) mbar_init(ring.bars + b, 1);
  mbar_init_fence();
  __syncwarp();
  uint32_t ticket = 0;
  const int64_t b = blockIdx.x;
  const bool is_chunk = b < p.n_chunk_blocks;
  const int64_t item = (is_chunk ? b : b - p.n_chunk_blocks) * kWarps + threadIdx.x / kWarp;
  if (is_chunk) {
    if (item >= p.n_chunks) return;  // uniform across the warp
    for (int piece = 0; piece < pieces; ++piece)
      walk<V, kVecs, MT>(p, ring, item, item + 1, 0, true, piece, ticket);
    // the fold reads and writes float rows: at most 4 floats a lane
    count_chunks<(V < 4 ? V : 4)>(Fold{p.partials, p.rows, p.chunk_ptr, p.chunks, p.counters,
                                       p.out, p.n_long, p.d, 0},
                                  item, item + 1);
    return;
  }
  if (item >= p.n_runs) return;  // uniform across the warp
  // rows and edges: row r starts at unit r + indptr[r]; this warp takes the
  // rows that start in [t0, t1)
  const auto unit = [&p](int64_t r) { return r + indptr_at(p, r); };
  const int64_t t0 = min(item * p.run_units, p.n_units);
  const int64_t t1 = min(t0 + p.run_units, p.n_units);
  const int64_t r0 = warp_search(0, p.n_rows, t0, unit);
  const int64_t r1 = warp_search(r0, min(p.n_rows, r0 + p.run_units), t1, unit);
  if (r0 == r1) return;
  int64_t k0 = 0;
  if (p.n_long > 0) {
    const int64_t* rows = p.rows;
    const int64_t n_long = p.n_long;
    k0 = warp_search(0, n_long, r0,
                     [rows, n_long](int64_t k) { return k < n_long ? rows[k] : kNone; });
  }
  for (int piece = 0; piece < pieces; ++piece)
    walk<V, kVecs, MT>(p, ring, r0, r1, k0, false, piece, ticket);
}

// The instantiation that sums `vecs` vectors a lane: 1, 2, 4 or all
// k2::kAccFloats / V.
template <int V, typename MT>
auto kernel_for(int vecs) {
  constexpr int kMost = k2::kAccFloats / V;
  auto kernel = seg_sum_kernel<V, kMost, MT>;
  if (vecs == 1) {
    kernel = seg_sum_kernel<V, 1, MT>;
  } else if (vecs == 2 && kMost > 2) {
    kernel = seg_sum_kernel<V, (kMost > 2 ? 2 : kMost), MT>;
  } else if (vecs <= 4 && kMost > 4) {
    kernel = seg_sum_kernel<V, (kMost > 4 ? 4 : kMost), MT>;
  }
  return kernel;
}

template <typename MT>
int run(const void* indptr, int indptr_is_int64, const void* msg, void* out, long long n_rows,
        int w, long long n_edges, const void* rows, const void* chunk_ptr, long long n_long,
        const void* chunks, long long n_chunks, void* partials, void* counters, void* stream) {
  if (n_rows <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  k2::Geometry g;
  if (!k2::geometry(w, static_cast<int>(sizeof(MT)), reinterpret_cast<uint64_t>(msg), n_rows,
                    n_edges, g) ||
      (n_long > 0 && (counters == nullptr || partials == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.indptr = indptr;
  p.ip64 = indptr_is_int64;
  p.msg = reinterpret_cast<uint64_t>(msg);
  p.msg_end = p.msg + static_cast<uint64_t>(n_edges) * static_cast<uint64_t>(w) * sizeof(MT);
  p.out = static_cast<float*>(out);
  p.partials = static_cast<float*>(partials);
  p.rows = static_cast<const int64_t*>(rows);
  p.chunk_ptr = static_cast<const int64_t*>(chunk_ptr);
  p.chunks = static_cast<const int64_t*>(chunks);
  p.counters = static_cast<int32_t*>(counters);
  p.n_rows = n_rows;
  p.n_long = n_long;
  p.n_chunks = n_chunks;
  p.n_chunk_blocks = (n_chunks + kWarps - 1) / kWarps;
  p.run_units = g.run_units;
  p.n_runs = g.n_runs;
  p.n_units = n_rows + n_edges;
  p.d = w;
  p.row_bytes = w * static_cast<int>(sizeof(MT));
  p.piece_cols = g.piece_cols;
  p.lanes = g.lanes;
  p.stage_bytes = g.stage_bytes;
  p.stage_rows = g.stage_rows;
  p.warp_smem = g.warp_smem;
  auto kernel = kernel_for<1, MT>(g.vecs);
  if (g.vec == 2) {
    kernel = kernel_for<2, MT>(g.vecs);
  } else if (g.vec == 4) {
    kernel = kernel_for<4, MT>(g.vecs);
  } else if (g.vec == 8) {
    if constexpr (sizeof(MT) == 2) kernel = kernel_for<8, MT>(g.vecs);
  }
  const size_t smem = static_cast<size_t>(g.warp_smem) * kWarps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(p.n_chunk_blocks + (p.n_runs + kWarps - 1) / kWarps));
  kernel<<<grid, dim3(kWarp * kWarps), smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes: msg float (seg_sum_f32) or
// bfloat16 (seg_sum_bf16), n_edges rows of w values; out float either way.
// Pointers are device pointers. The row split (graph/split.py,
// RowSplit.kernel_args): the n_long `rows`, whose chunks
// [chunks[2k], chunks[2k+1]) are chunk_ptr[i]..chunk_ptr[i+1]; `partials`
// holds n_chunks × w floats and `counters` n_long int32 zeros, left zero
// (both may be null without long rows). One launch; returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernel does not
// take.
#define SEG_SUM_ENTRY(NAME, MT)                                                                \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* msg, void* out,     \
                      long long n_rows, int w, long long n_edges, const void* rows,            \
                      const void* chunk_ptr, long long n_long, const void* chunks,             \
                      long long n_chunks, void* partials, void* counters, void* stream) {      \
    return run<MT>(indptr, indptr_is_int64, msg, out, n_rows, w, n_edges, rows, chunk_ptr,     \
                   n_long, chunks, n_chunks, partials, counters, stream);                      \
  }

SEG_SUM_ENTRY(seg_sum_f32, float)
SEG_SUM_ENTRY(seg_sum_bf16, __nv_bfloat16)
