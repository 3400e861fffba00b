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
// A bfloat16 value is converted exactly to float as it is read; the edge
// weight stays float, w·x is one float FMA into a float sum, and the chunk
// partials, the fold and the output are float. (The lane kernel rounds w·x
// to bfloat16 before its float sum, lane_spmm.py:390; this kernel keeps the
// product in float.)
//
// What bounds it on this card: dependent row gathers. Each edge costs two
// dependent loads, its index and then its row of x. Where x is larger than
// the 50 MB L2 (products: 627 MB in float at D = 64) the rows come from
// HBM; at reddit's D = 16 (x 15 MB) and arxiv's widths mostly from L2. Two
// yardsticks: the bytes bound (each input read once, the output written
// once, at 3.35 TB/s) and the no-reuse gather floor (every edge's row read
// once from HBM, plus the indices and the output): no edge order of a CSR
// reads each row of x once, so where x is beyond L2 the floor is the one
// within reach. The arithmetic is one FMA a value and there is no dense
// product, so the tensor cores do not apply.
//
// The design (one launch a call; k1_geometry.h sizes it):
//   * rows go through shared memory: each warp keeps a ring of kStages
//     stages of `slots` staged rows (about 8 KB a warp), so it has up to
//     kStages·slots rows in flight whatever the width (128 at 64 B, 20 at
//     400 B, 8 at 1 KB) and its registers hold only the sums. The indices
//     and weights come in blocks of 32 edges, copied by cp.async kBlocks
//     blocks ahead of the stages, so a stage never waits for its indices;
//   * every row is copied as the 16-byte-aligned span that covers it (D = 47
//     in float: 188 B in a 192- or 208-byte span), at any width and any
//     alignment of x; the consumer reads the row at its offset in the span.
//     Rows of more than 128 B go by TMA's 1-D bulk copy, one a row, issued
//     by the row's lane and completing on the stage's mbarrier with its byte
//     count; narrower rows by cp.async.cg copies of 16 bytes spread over the
//     32 lanes, in the stage's commit group (a TMA request for a 64-byte
//     row costs more than the row: on an H100, reddit's D = 16 was slower by
//     the bulk route, arxiv's D = 128 and 256 faster). A
//     span that would cross x's first or last byte (a view, or an end off 16
//     bytes) moves only the values inside x, one at a time;
//   * the lanes consume columns: a lane owns V values of a row at each of
//     its columns (V: the alignment every row start shares, at most 4
//     values: 16 bytes of float, 8 of bfloat16), so no lane copies idle at
//     odd widths, and a narrow row lets a pass take 32 / L staged rows of the
//     same CSR row, two or four to a lane group (reddit's D = 16: L = 4,
//     32 rows a pass), combined by a butterfly of shuffles when the row
//     ends; rows wider than 512 values run as column pieces, each a walk of
//     its own;
//   * a warp walks a run of consecutive rows as one stream of edges (a CSR's
//     rows are contiguous in indices) and writes each row when its last edge
//     is summed. Each run takes about `run_units` rows plus edges: a warp
//     finds its first and last row by a 32-way search of r + indptr[r];
//   * long rows keep the row split (lanes.cuh, "The row split"): the rows the
//     plan lists (more than T = 512 edges, graph/split.py) are cut into
//     chunks of at most T edges; a warp of the first blocks walks one chunk,
//     or two consecutive ones as one stream on plans with many chunks
//     (k1_geometry.h), summing each into its partials row,
//     and the run warps skip the listed rows. The combine is folded into the
//     launch: a chunk warp fences, counts its chunks on their rows' counters,
//     and the warp that completes a row's count adds the row's partials in
//     ascending chunk order (read through L2), applies mean's 1 / deg of the
//     whole row, writes the row once and sets the counter back to 0. The
//     order of the additions does not depend on which warp arrives last and
//     no atomic decides one, so two runs are bitwise equal. The counters
//     belong to the plan, so two launches over one CSR must not run at once
//     on two streams (the package runs on one stream);
//   * blocks of 4 warps, so that the rings of 16 to 20 warps share an SM.

#include "async_copy.cuh"
#include "k1_geometry.h"
#include "lanes.cuh"

#include <type_traits>

namespace {

using namespace async_copy;
using namespace warp_csr;

using k1::kAccFloats;
using k1::kBlocks;
using k1::kStages;
using k1::kWarps;

struct Params {
  const void* indptr;  // int32 or int64 (ip64)
  const int32_t* indices;
  const float* w;  // null: unweighted
  uint64_t x, x_end;  // x's bytes: [x, x_end)
  float* out;
  float* partials;  // (n_chunks, d)
  const int64_t* rows;
  const int64_t* chunk_ptr;
  const int64_t* chunks;
  int32_t* counters;  // one a long row, 0 between launches
  int64_t n_rows, n_long, n_chunks, n_chunk_blocks, run_units, n_runs, n_units;
  int ip64, d, mean, piece_cols, lanes, slots, slot_bytes, warp_smem;
  int chunk_group;  // consecutive chunks a chunk warp walks as one stream
  int whole;  // every row starts on 16 bytes (and x ends on 16 bytes): spans are the rows
};

__device__ __forceinline__ int64_t indptr_at(const Params& p, int64_t i) {
  return p.ip64 ? static_cast<const int64_t*>(p.indptr)[i]
                : static_cast<int64_t>(static_cast<const int32_t*>(p.indptr)[i]);
}

// A warp's shared memory (k1_geometry.h sizes it): its ring
// of kStages stages of `slots` staged rows of slot_bytes each; one mbarrier
// a stage (the bulk route); the edge range of each of its kBlocks index
// blocks; each staged row's offset in its span and its weight; each stage's
// row count; and the blocks' indices and weights, 32 edges a block.
struct Ring {
  char* rows;
  uint64_t* bars;   // (kStages)
  int64_t* bounds;  // (kBlocks, 2): a block's [first, end) edge
  int2* meta;       // (kStages · slots): the offset in the span, the weight's bits
  int* counts;      // (kStages): rows staged (0: the stream is done)
  int32_t* src;     // (kBlocks, 32)
  float* wt;        // (kBlocks, 32)

  __device__ __forceinline__ Ring(char* base, int slots, int slot_bytes) {
    rows = base;
    bars = reinterpret_cast<uint64_t*>(base + kStages * slots * slot_bytes);
    bounds = reinterpret_cast<int64_t*>(bars + kStages);
    meta = reinterpret_cast<int2*>(bounds + 2 * kBlocks);
    counts = reinterpret_cast<int*>(meta + kStages * slots);
    src = counts + kStages;
    wt = reinterpret_cast<float*>(src + kBlocks * kWarp);
  }
};

// The producer side of one warp's ring. The stream of edges [f, end), less
// the listed long rows' edges [skip_s, skip_e) (the chunk warps take them),
// is fetched in blocks of up to 32 indices and weights (cp.async, 4 bytes a
// lane) kBlocks blocks ahead of the stages, so that a stage's row copies
// never wait for its indices. A stage takes up to `slots` edges of the
// current block [lo, hi) and copies each row as its 16-byte span: kBulk, one
// TMA bulk copy a row, issued by the row's lane and completing on the
// stage's mbarrier; else cp.async.cg copies of 16 bytes spread over the
// lanes, in the stage's commit group.
template <typename XT, bool kBulk>
struct Stager {
  using Raw = std::conditional_t<sizeof(XT) == 4, uint32_t, uint16_t>;
  // the fetch cursor and the next skip: the listed long row k below r1 (a
  // run), or the gap from chunk k's end to chunk k + 1's, below r1 (chunks)
  int64_t f, end, skip_s, skip_e, k, r1;
  bool chunks;
  int64_t c, lo, hi;                      // the stage cursor in the current block
  int cb;                                 // the current block's slot
  uint64_t piece_base;                    // x's first byte of this walk's columns
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

  // The next block of the stream into slot b; its copies join the open group.
  __device__ __forceinline__ void fetch(const Params& p, const Ring& ring, int b) {
    const int lane = threadIdx.x % kWarp;
    while (f == skip_s) {  // adjacent long rows: skip each
      f = skip_e;
      ++k;
      next_skip(p);
    }
    const int64_t stop = skip_s < end ? skip_s : end;
    const int64_t e = f < stop ? min(f + kWarp, stop) : f;
    if (f + lane < e) {
      cp_async4(ring.src + b * kWarp + lane, p.indices + f + lane);
      if (p.w != nullptr) cp_async4(ring.wt + b * kWarp + lane, p.w + f + lane);
    }
    if (lane == 0) {
      ring.bounds[2 * b] = f;
      ring.bounds[2 * b + 1] = e;
    }
    f = e;
  }

  // Fetch the first kBlocks blocks and wait for them (once a walk).
  __device__ __forceinline__ void start(const Params& p, const Ring& ring) {
    for (int b = 0; b < kBlocks; ++b) fetch(p, ring, b);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    cb = 0;
    lo = c = ring.bounds[0];
    hi = ring.bounds[1];
  }

  // The values of the 16-byte chunk at a that lie inside x, one at a time
  // (only a chunk at x's first or last bytes).
  __device__ __forceinline__ void copy_inside(const Params& p, char* dst, uint64_t a) const {
#pragma unroll
    for (int o = 0; o < 16; o += static_cast<int>(sizeof(Raw))) {
      if (a + o >= p.x && a + o + sizeof(Raw) <= p.x_end)
        *reinterpret_cast<Raw*>(dst + o) = *reinterpret_cast<const Raw*>(a + o);
    }
  }

  // Fill stage s (ring slot s % kStages) and commit its group. When the
  // current block is staged, its slot is refilled and the next block becomes
  // current; that block was fetched kBlocks - 1 >= kStages stages before, so
  // its indices have landed (cp.async route: the consumer waited for the
  // stage that fetched them; bulk route: the wait below).
  __device__ __forceinline__ void issue(const Params& p, const Ring& ring, uint32_t s) {
    const int lane = threadIdx.x % kWarp;
    if (c == hi) {
      fetch(p, ring, cb);
      cb = cb + 1 == kBlocks ? 0 : cb + 1;
      if constexpr (kBulk) {
        cp_async_wait<kBlocks - 2>();
        __syncwarp();
      }
      lo = c = ring.bounds[2 * cb];
      hi = ring.bounds[2 * cb + 1];
    }
    const int b = static_cast<int>(s % kStages);
    const int n = static_cast<int>(min(static_cast<int64_t>(p.slots), hi - c));
    const int32_t* src = ring.src + cb * kWarp + static_cast<int>(c - lo);
    const float* wt = ring.wt + cb * kWarp + static_cast<int>(c - lo);
    const uint64_t row_bytes = static_cast<uint64_t>(p.d) * sizeof(XT);
    char* stage = ring.rows + b * p.slots * p.slot_bytes;
    if (lane == 0) ring.counts[b] = n;
    c += n;
    if constexpr (kBulk) {
      uint64_t* bar = ring.bars + b;
      if (lane < n) {
        const uint64_t a = piece_base + static_cast<uint64_t>(src[lane]) * row_bytes;
        const int off = static_cast<int>(a & 15u);
        const uint64_t a0 = a - off;
        const uint32_t span = static_cast<uint32_t>(off + piece_bytes + 15) & ~15u;
        ring.meta[b * p.slots + lane] =
            make_int2(off, __float_as_int(p.w != nullptr ? wt[lane] : 1.f));
        char* dst = stage + lane * p.slot_bytes;
        if (a0 >= p.x && a0 + span <= p.x_end) {
          mbar_arrive_tx(bar, span);
          bulk_copy(dst, a0, span, bar);
        } else {
          for (uint32_t o = 0; o < span; o += 16) copy_inside(p, dst + o, a0 + o);
          mbar_arrive(bar);
        }
      } else {
        mbar_arrive(bar);
      }
    } else {
      if (lane < n) {
        const uint64_t a = piece_base + static_cast<uint64_t>(src[lane]) * row_bytes;
        ring.meta[b * p.slots + lane] =
            make_int2(static_cast<int>(a & 15u), __float_as_int(p.w != nullptr ? wt[lane] : 1.f));
      }
      const int chunks = (piece_bytes + 15) / 16;
      if (p.whole && kWarp % chunks == 0) {
        // every span is its row, chunks dividing 32: a lane copies the same
        // chunk of every (32 / chunks)-th row
        const int i = lane % chunks, jstep = kWarp / chunks;
        for (int j = lane / chunks; j < n; j += jstep)
          cp_async16(stage + j * p.slot_bytes + 16 * i,
                     piece_base + static_cast<uint64_t>(src[j]) * row_bytes + 16u * i);
      } else {
        // chunk q of the stage: row j = q / width, chunk i = q % width
        const int width = p.slot_bytes / 16;
        const int total = n * width;
        int j = lane / width, i = lane % width;
        const int jstep = kWarp / width, istep = kWarp % width;
        for (int q = lane; q < total; q += kWarp) {
          const uint64_t a = piece_base + static_cast<uint64_t>(src[j]) * row_bytes;
          if (i < static_cast<int>(((a & 15u) + piece_bytes + 15) >> 4)) {
            const uint64_t chunk = (a & ~uint64_t{15}) + 16u * static_cast<uint64_t>(i);
            char* dst = stage + j * p.slot_bytes + 16 * i;
            if (chunk >= p.x && chunk + 16 <= p.x_end) {
              cp_async16(dst, chunk);
            } else {
              copy_inside(p, dst, chunk);
            }
          }
          j += jstep;
          i += istep;
          if (i >= width) {
            i -= width;
            ++j;
          }
        }
      }
    }
    cp_async_commit();
  }

  // Wait for stage s (the cp.async route: every older group).
  __device__ __forceinline__ void wait(const Ring& ring, uint32_t s) const {
    if constexpr (kBulk) {
      mbar_wait(ring.bars + s % kStages, (s / kStages) & 1u);
    } else {
      cp_async_wait<kStages - 1>();
    }
    __syncwarp();
  }
};

// One column piece of one warp's work: the rows [r0, r1) of a run (the
// plan's long rows among them skipped, k0 the first listed at or after r0),
// or the chunks [r0, r1) (`chunks`), each summed into its partials row; one
// stream over their edges.
// A lane sums kVecs vectors of V values (kVecs = 1 where a row has at most
// 32 vectors). `ticket` numbers this warp's stages across its walks (the
// mbarriers' phases).
template <int V, int kVecs, typename XT, bool kBulk>
__device__ __forceinline__ void walk(const Params& p, const Ring& ring, int64_t r0, int64_t r1,
                                     int64_t k0, bool chunks, int piece, uint32_t& ticket) {
  constexpr int kPass = kVecs == 1 ? 4 : 2;  // staged rows a lane group sums a pass
  const int lane = threadIdx.x % kWarp;
  const int col0 = piece * p.piece_cols;
  const int nvec = min(p.piece_cols, p.d - col0) / V;
  const int lanes = p.lanes, groups = kWarp / lanes, g = lane / lanes, col = lane % lanes;

  Stager<XT, kBulk> st;
  st.k = chunks ? r0 : k0;
  st.r1 = r1;
  st.chunks = chunks;
  st.piece_base = p.x + static_cast<uint64_t>(col0) * sizeof(XT);
  st.piece_bytes = nvec * V * static_cast<int>(sizeof(XT));
  st.f = chunks ? p.chunks[2 * r0] : indptr_at(p, r0);
  st.end = chunks ? p.chunks[2 * r1 - 1] : indptr_at(p, r1);
  st.next_skip(p);
  st.start(p, ring);
  const uint32_t first = ticket;
  uint32_t issued = first;
  for (; issued < first + kStages; ++issued) st.issue(p, ring, issued);

  float acc[kVecs][V];
#pragma unroll
  for (int t = 0; t < kVecs; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;

  const auto indptr = [&p](int64_t i) { return indptr_at(p, i); };
  RowOffsets offs;
  if (!chunks) offs.init(indptr, p.n_rows, r0);
  int64_t kc = k0;
  int64_t next_long = !chunks && kc < p.n_long ? p.rows[kc] : kNone;
  uint32_t stage = first;  // the stage being summed, once `started`
  bool started = false;
  int pos = 0, cnt = 0;
  for (int64_t r = r0; r < r1; ++r) {
    int64_t deg;
    float* orow;
    float scale = 1.f;
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
      if (p.mean) scale = __frcp_rn(static_cast<float>(deg > 1 ? deg : 1));
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
        cnt = ring.counts[stage % kStages];
        pos = 0;
        if (cnt == 0) break;  // a plan that does not match the CSR: leave the row
      }
      // a pass: each lane group sums up to kPass staged rows of this row
      const int take = static_cast<int>(
          min(static_cast<int64_t>(min(kPass * groups, cnt - pos)), rem));
      const int base = static_cast<int>(stage % kStages) * p.slots + pos;
#pragma unroll
      for (int u = 0; u < kPass; ++u) {
        const int j = u * groups + g;
        if (j < take) {
          const int2 m = ring.meta[base + j];
          const float wt = __int_as_float(m.y);
          const XT* xr =
              reinterpret_cast<const XT*>(ring.rows + (base + j) * p.slot_bytes + m.x);
#pragma unroll
          for (int t = 0; t < kVecs; ++t) {
            const int c = col + t * lanes;
            if (c < nvec) {
              float v[V];
              lds_vec<V>(xr + c * V, v);
#pragma unroll
              for (int k = 0; k < V; ++k) acc[t][k] = fmaf(wt, v[k], acc[t][k]);
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
        if (c < nvec) {
          float v[V];
#pragma unroll
          for (int k = 0; k < V; ++k) v[k] = acc[t][k] * scale;
          store_vec<V>(orow + c * V, v);
        }
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
  if constexpr (kBulk) {
    for (uint32_t s = started ? stage + 1 : first; s < issued; ++s) st.wait(ring, s);
  } else {
    cp_async_wait_all();
    __syncwarp();
  }
  ticket = issued;
}

// The first n_chunk_blocks blocks: one chunk a warp, then the fold; the
// others: one run of rows a warp.
template <int V, int kVecs, typename XT, bool kBulk>
__global__ void __launch_bounds__(kWarp * kWarps)
csr_spmm_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) char smem[];
  const Ring ring(smem + (threadIdx.x / kWarp) * p.warp_smem, p.slots, p.slot_bytes);
  const int lane = threadIdx.x % kWarp;
  const int pieces = (p.d + p.piece_cols - 1) / p.piece_cols;
  if constexpr (kBulk) {  // one arrival a lane a stage
    if (lane == 0)
      for (int b = 0; b < kStages; ++b) mbar_init(ring.bars + b, kWarp);
    mbar_init_fence();
    __syncwarp();
  }
  uint32_t ticket = 0;
  // this warp's work item: a group of chunks in the first n_chunk_blocks blocks, else a run
  const int64_t b = blockIdx.x;
  const bool is_chunk = b < p.n_chunk_blocks;
  const int64_t item = (is_chunk ? b : b - p.n_chunk_blocks) * kWarps + threadIdx.x / kWarp;
  if (is_chunk) {
    const int64_t k0 = item * p.chunk_group;
    if (k0 >= p.n_chunks) return;  // uniform across the warp
    const int64_t k1 = min(k0 + p.chunk_group, p.n_chunks);
    for (int piece = 0; piece < pieces; ++piece)
      walk<V, kVecs, XT, kBulk>(p, ring, k0, k1, 0, true, piece, ticket);
    count_chunks<V>(Fold{p.partials, p.rows, p.chunk_ptr, p.chunks, p.counters, p.out, p.n_long,
                         p.d, p.mean},
                    k0, k1);
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
    walk<V, kVecs, XT, kBulk>(p, ring, r0, r1, k0, false, piece, ticket);
}

// The instantiation that sums `vecs` vectors a lane: 1, 2, 4 or kAccFloats / V;
// the cp.async route (rows of at most 128 bytes) only 1 or 2, else null.
template <int V, typename XT, bool kBulk>
auto kernel_for(int vecs) {
  constexpr int kMost = kAccFloats / V;
  if constexpr (!kBulk) {
    decltype(&csr_spmm_kernel<V, 1, XT, kBulk>) kernel = nullptr;
    if (vecs == 1) {
      kernel = csr_spmm_kernel<V, 1, XT, kBulk>;
    } else if (vecs == 2) {
      kernel = csr_spmm_kernel<V, 2, XT, kBulk>;
    }
    return kernel;
  }
  auto kernel = csr_spmm_kernel<V, kMost, XT, kBulk>;
  if (vecs == 1) {
    kernel = csr_spmm_kernel<V, 1, XT, kBulk>;
  } else if (vecs == 2 && kMost > 2) {
    kernel = csr_spmm_kernel<V, (kMost > 2 ? 2 : kMost), XT, kBulk>;
  } else if (vecs <= 4 && kMost > 4) {
    kernel = csr_spmm_kernel<V, (kMost > 4 ? 4 : kMost), XT, kBulk>;
  }
  return kernel;
}

template <typename XT, bool kBulk>
int launch(Params p, int vec, int vecs, cudaStream_t stream) {
  const int64_t groups = (p.n_chunks + p.chunk_group - 1) / p.chunk_group;
  const int64_t cb = (groups + kWarps - 1) / kWarps;
  const dim3 grid(static_cast<unsigned>(cb + (p.n_runs + kWarps - 1) / kWarps));
  const size_t smem = static_cast<size_t>(p.warp_smem) * kWarps;
  p.n_chunk_blocks = cb;
  auto kernel = kernel_for<1, XT, kBulk>(vecs);
  if (vec == 2) {
    kernel = kernel_for<2, XT, kBulk>(vecs);
  } else if (vec == 4) {
    kernel = kernel_for<4, XT, kBulk>(vecs);
  }
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, dim3(kWarp * kWarps), smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int run(const void* indptr, int indptr_is_int64, const void* indices, const void* w,
        const void* x, long long n_src, void* out, long long n_rows, int d, int mean,
        const void* rows, const void* chunk_ptr, long long n_long, const void* chunks,
        long long n_chunks, void* partials, void* counters, long long n_edges, void* stream) {
  if (n_rows <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  k1::Geometry g;
  if (!k1::geometry(d, static_cast<int>(sizeof(XT)), reinterpret_cast<uint64_t>(x), n_rows,
                    n_edges, n_chunks, g) ||
      (n_long > 0 && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.indptr = indptr;
  p.ip64 = indptr_is_int64;
  p.indices = static_cast<const int32_t*>(indices);
  p.w = static_cast<const float*>(w);
  p.x = reinterpret_cast<uint64_t>(x);
  p.x_end = p.x + static_cast<uint64_t>(n_src) * static_cast<uint64_t>(d) * sizeof(XT);
  p.out = static_cast<float*>(out);
  p.partials = static_cast<float*>(partials);
  p.rows = static_cast<const int64_t*>(rows);
  p.chunk_ptr = static_cast<const int64_t*>(chunk_ptr);
  p.chunks = static_cast<const int64_t*>(chunks);
  p.counters = static_cast<int32_t*>(counters);
  p.n_rows = n_rows;
  p.n_long = n_long;
  p.n_chunks = n_chunks;
  p.n_chunk_blocks = 0;
  p.run_units = g.run_units;
  p.n_runs = g.n_runs;
  p.n_units = n_rows + n_edges;
  p.d = d;
  p.mean = mean;
  p.piece_cols = g.piece_cols;
  p.lanes = g.lanes;
  p.slots = g.slots;
  p.slot_bytes = g.slot_bytes;
  p.warp_smem = g.warp_smem;
  p.chunk_group = g.chunk_group;
  p.whole = g.align == 16;
  auto s = static_cast<cudaStream_t>(stream);
  return g.bulk ? launch<XT, true>(p, g.vec, g.vecs, s) : launch<XT, false>(p, g.vec, g.vecs, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes: x float (csr_spmm_f32) or
// bfloat16 (csr_spmm_bf16), n_src rows of d values; everything else the
// same. Pointers are device pointers; `w` may be null. The row split
// (graph/split.py, RowSplit.kernel_args): long_t is the plan's T (the
// rows it lists are the long ones; not read here), the n_long `rows`, whose
// chunks [chunks[2k], chunks[2k+1]) are chunk_ptr[i]..chunk_ptr[i+1];
// `partials` holds n_chunks × d floats and `counters` n_long int32 zeros,
// left zero. n_edges: the CSR's. k1_geometry.h sizes the launch.
// One launch; returns cudaGetLastError(), or cudaErrorInvalidValue for
// what the kernel does not take.
#define CSR_SPMM_ENTRY(NAME, XT)                                                                 \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* indices,              \
                      const void* w, const void* x, long long n_src, void* out, long long n_rows, \
                      int d, int mean, long long long_t, const void* rows, const void* chunk_ptr, \
                      long long n_long, const void* chunks, long long n_chunks, void* partials,   \
                      void* counters, long long n_edges, void* stream) {                          \
    (void)long_t;                                                                                 \
    return run<XT>(indptr, indptr_is_int64, indices, w, x, n_src, out, n_rows, d, mean, rows,    \
                   chunk_ptr, n_long, chunks, n_chunks, partials, counters, n_edges, stream);     \
  }

// Each library holds one: kernels/build.py compiles this file a second time
// with -DK1_ROWS_BF16, so that the two build in parallel.
#ifdef K1_ROWS_BF16
CSR_SPMM_ENTRY(csr_spmm_bf16, __nv_bfloat16)
#else
CSR_SPMM_ENTRY(csr_spmm_f32, float)
#endif
