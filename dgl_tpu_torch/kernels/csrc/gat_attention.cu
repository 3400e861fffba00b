// K3 for Hopper (sm_90a): fused GAT attention, forward and backward, with no
// per-edge tensor in device memory.
//
//   out[d] = Σ_{j: s→d} m_j · α_j · v[s],   α_j = p_j / Σ_{j'→d} p_j',
//   p_j = exp(z_j − shift[d]),  z_j = leaky_relu(a_src[s] + a_dst[d]),
//   m_j = the dropout factor of the forward-canonical edge id j under head
//   h (1 without dropout), every head h independently.
//
// Replaces: dgl_tpu/kernels/lane_attention.py:_attn_pass, passes "fwd" and
// "b2" (body _make_kernel, dropout _hash_keep, custom VJP _lane_gat_fwd /
// _lane_gat_bwd, entry lane_gat_agg). The TPU kernel walks 128-edge runs of
// a lane plan, gathers from a VMEM-resident feature-major slab and
// accumulates with one-hot MXU matmuls. Here each pass walks a CSR as it is:
// the forward the dst-sorted CSR, the backward (b2) the reverse CSR.
//
//   gat_fwd: for every dst row d and head h, sums num = Σ m·p·v,
//     s = Σ p, w1u = Σ m·p·slope·v and w1su = Σ p·slope relative to the
//     exact shift leaky_relu(max_{s→d} a_src[s] + a_dst[d]) (the JAX kernel
//     shifts by the loose bound leaky_relu(max_all a_src + a_dst[d]) and has
//     no rescue when a row's every p underflows; softmax does not change
//     under the shift, and the exact one never underflows). It writes
//     out = num / s, w1 = w1u / s, w1s = w1su / s, inv_s = 1 / s and shift
//     (all 0 on an empty row).
//   gat_b2: for every src row s of the reverse CSR (slot j holds the
//     original dst d and the forward-canonical id eid[j]) and head h,
//     recomputes p with the forward's shift, α = p·inv_s[d], and sums
//     grad_v = Σ m·α·g[d], w2 = Σ m·α·slope·g[d] and w3 = Σ α·slope·C[d],
//     with C = Σ_D g·out. The per-dst operands (a_dst, shift, inv_s, C) come
//     packed as one float4 per (d, h). It writes grad_v and, from v's row,
//     grad_a_src = Σ_D v·w2 − w3 (head_dots); w2 and w3 never leave it.
//   The node passes (below, "K3's node passes") compute the rest of the
//   gradients of a_src and a_dst as N-wide closed forms, as _lane_gat_bwd
//   does: C and grad_a_dst = Σ_D g·w1 − C·w1s before b2 (gat_score_grad),
//   and they compute the scores a_src = z·attn_src, a_dst = z_dst·attn_dst
//   before the forward (gat_scores) and the gradients of z and of the
//   attention vectors after b2 (gat_vector_grad).
//
// bfloat16 values (gat_fwd_bf16, gat_b2_bf16: the JAX package's lane_gat_agg
// with compute_dtype = bfloat16, lane_attention.py:503): the forward reads
// v's rows as bfloat16, converted exactly to float as they are read; the
// logits, the row shift, the softmax, the dropout and every sum stay float,
// and the forward writes float. b2 reads the float cotangent g (not rounded
// to bfloat16, as the lane kernel rounds it) and sums grad_v in float, then
// rounds each grad_v value once to bfloat16, v's type (lane_attention.py:
// 477); w2 and w3 stay float, and grad_a_src = Σ_D v·w2 − w3 reads v in the
// epilogue. kernels/build.py compiles this file a second time with -DK3_BF16
// for the bfloat16 entry points, so that the two libraries build in
// parallel.
//
// Dropout: murmur3 fmix32 of (key ^ seed) as uint32, kept where its low 24
// bits are below int(keep·2^24), scaled by float32(1/keep): the JAX
// package's _hash_keep, keyed on key = eid·H + h (mod 2^32), so every
// (edge, head) pair is dropped on its own, as DGL's GATConv and the edge
// form drop them; at H = 1 the key is eid and the mask equals _hash_keep's
// bit for bit (the lane kernel keys on eid alone, one mask for every head).
// The mask multiplies the numerator terms only; s stays unmasked. The seed
// is read from device memory, so drawing it on the card needs no host sync.
//
// What bounds it on this card: dependent row gathers, as in K1. Each edge
// costs its index, then its H·D row of v (g in b2) and its H values of
// a_src (b2: its H float4s of node), read from L2 at the main paths'
// shapes (reddit's v is 15 MB at D = 16); the bytes bound counts the CSR,
// the node arrays once and the outputs once. The arithmetic is two FMAs a
// value and an exp a (edge, head) and there is no dense product, so the
// tensor cores do not apply. Before this design one warp took one (row,
// head), heads were the grid's y dimension, and rows were gathered into
// registers a few at a time: H warps read the same indices and a_src rows,
// each a D-wide slice of the same row of v, with only a few rows in flight,
// and long rows took one to three combine launches after the pass.
//
// The design (one launch a pass; k3_geometry.h sizes it):
//   * heads folded into the warp: a warp walks a run of consecutive rows
//     (about run_units rows plus edges, found by K1's 32-way search of
//     r + indptr[r]) for every head, so each edge's index is read once and
//     its whole H·D row (256 B at arxiv's H = 4, D = 16) moves as one
//     staged span. The lanes own columns of the H·D row, V values a vector
//     (V divides D, so a vector lies in one head: at D = 41 or 47 V is 1);
//     a narrow row lets a pass take 32 / L staged rows, two or four to a
//     lane group, combined by a butterfly of shuffles when the row ends;
//     rows wider than the lanes' sums (256 values; 128 at V = 1) run as
//     column pieces;
//   * rows through shared memory (csrc/async_copy.cuh, as K1): each warp
//     keeps a ring of kStages stages of `slots` staged rows, the indices
//     (and b2's eid) come in blocks of 32 fetched kBlocks blocks ahead, each
//     row is copied as the 16-byte-aligned span that covers it at any width
//     and any alignment of the gathered array (spans of 144 B up by one TMA
//     bulk copy completing on the stage's mbarrier, narrower ones by 16-byte
//     cp.async copies spread over the lanes; a span that would cross the
//     array's first or last byte moves only the values inside it), and
//     beside each row the edge's H values of a_src (forward) or its H
//     float4s of node (b2) by cp.async;
//   * scores per (edge, head), once: a row's next staged edges in a stage
//     form a block of at most 32 / hp (hp: H rounded up to a power of two);
//     lane l scores head l % hp of the block's edge l / hp from the staged
//     values (the logit, p, slope and dropout factor) and writes the pair's
//     two weights to shared memory, and the lanes that hold the edge's row
//     read their own head's, in passes over the block. A lane keeps its
//     head's running sums of p (and p·slope; b2: w3) and the row's a_dst
//     (b2: a_src), loaded 32 / hp rows at a time ahead of the walk;
//   * the online maximum stays per head (design (a)): the running maximum of
//     a_src and its shift; a block where some lane's pair passes its head's
//     maximum (every row's first) takes each head's block maximum (one warp
//     reduction at H = 1, a butterfly over a head's lanes else), and a rise
//     first rescales that head's sums by exp(old − new shift) ≤ 1. Design
//     (b), a pre-pass over the row's indices and a_src alone for the exact
//     maxima, then one sweep with a fixed shift, was built beside it and
//     timed in turns on an NVIDIA H100 80GB HBM3 at 700 W, then removed: (a)
//     won, 0.5153 ms against 0.5796 at H = 1 (reddit, D = 16) and 0.4482
//     against 0.5066 at H = 4 (arxiv, D = 16), with dropout (PERF.md §6
//     names the run); (b) pays a dependent index and a_src load chain before
//     every row, where (a) takes a block maximum on a row's first block and,
//     after it, only where a pair passes the running maximum;
//   * long rows keep the row split (lanes.cuh, "The row split"): the rows the
//     plan lists (more than T = 512 edges, graph/split.py) are cut into
//     chunks of at most T edges, one chunk a warp of the first blocks (two
//     consecutive ones as one stream on plans of 2,048 chunks or more, as
//     K1), summed into its partials (the forward's unnormalised sums and the
//     chunk's own shift per head; b2's linear sums), and the run warps skip
//     the listed rows. The combine is folded into the launch (lanes.cuh,
//     count_and_fold): a chunk warp fences and counts its chunk on its row's
//     counter, and the warp that completes the count combines the row and
//     sets the counter back to 0. The forward takes sh = max_k sh_k, the
//     row's shift, scales chunk k by f_k = exp(sh_k − sh) ≤ 1 and adds the
//     chunks in ascending order; b2 adds grad_v, w2 and w3 in ascending
//     order and rounds grad_v once. The order of the additions does not
//     depend on which warp arrives last and no atomic decides one, so two
//     runs are bitwise equal. The counters belong to the plan, and the
//     forward and b2 over one CSR share them, so two launches over one CSR
//     must not run at once on two streams (the package runs on one stream);
//   * a row's sums end in one butterfly, level by level, for the vectors'
//     sums and the heads' scalars together;
//   * a walk's edge and row positions are 32-bit (the index arrays are
//     int32), and blocks of 4 warps take at most 128 registers a thread
//     (k3::kMinBlocks blocks an SM): no variant spills.

#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "async_copy.cuh"
#include "k3_geometry.h"
#include "lanes.cuh"

namespace {

using namespace async_copy;
using namespace warp_csr;

using k3::kBlocks;
using k3::kStages;
using k3::kWarps;

// the forward's staged a_src (kStages·slots·H floats) ends on 16 bytes, so
// the mbarriers after it are aligned
static_assert(kStages % 4 == 0, "kStages must be a multiple of 4");

struct Params {
  const void* indptr;       // int32 or int64 (ip64)
  const int32_t* idx;       // forward: src; b2: dst (the ids of the gathered rows)
  const int32_t* eid;       // b2 with dropout: each slot's forward-canonical id; else null
  uint64_t x, x_end;        // the gathered rows' bytes: forward v, b2 g
  const float* edge_src;    // forward: a_src (N_src, H), staged beside each row
  const float4* edge_node;  // b2: node (N_dst, H), staged beside each row
  const float* row_in;      // forward: a_dst (N_dst, H); b2: a_src (N_src, H); one a row
  const void* v;            // b2: v (n_rows, H, D), of grad_v's type, read once a row
  void* out0;               // forward: out (float); b2: grad_v (float or bfloat16)
  float* out1;              // forward: w1
  float* s0;                // forward: inv_s; b2: grad_a_src (n_rows, H)
  float* s1;                // forward: w1s
  float* s2;                // forward: shift
  float* part0;             // (n_chunks, H·D): forward num, b2 grad_v
  float* part1;             // (n_chunks, H·D): forward w1u, b2 w2
  float* pscal;             // forward (3, n_chunks, H): sh_k, s_k, w1su_k; b2 (n_chunks, H): w3
  const int64_t* rows;
  const int64_t* chunk_ptr;
  const int64_t* chunks;
  int32_t* counters;   // one a long row, 0 between launches
  const int32_t* seed;  // one int32 on the card, or null without dropout
  uint32_t thresh;      // int(keep · 2^24)
  float scale;          // float32(1 / keep)
  float ns;             // leaky_relu's negative slope
  int64_t n_rows, n_long, n_chunks, n_chunk_blocks, run_units, n_runs, n_units;
  int ip64, heads, hp, hs, d, hd, piece_cols, lanes, slots, slot_bytes, edge_bytes, warp_smem;
  int chunk_group;  // consecutive chunks a chunk warp walks as one stream
  int whole;  // every row starts on 16 bytes (and x ends on 16 bytes): spans are the rows
  int v_vec;  // b2: v starts on 16 bytes, so a lane reads its V values of a row at once
};

// A walk's edge and row positions are 32-bit: src, dst and eid are int32,
// so a CSR the kernels take has fewer than 2^31 edges and rows (params_of
// refuses more), and 32-bit cursors keep the walk's registers and integer
// work at half of 64-bit ones.
constexpr int kNone32 = INT32_MAX;

__device__ __forceinline__ int indptr_at(const Params& p, int64_t i) {
  return p.ip64 ? static_cast<int>(static_cast<const int64_t*>(p.indptr)[i])
                : static_cast<const int32_t*>(p.indptr)[i];
}

__device__ __forceinline__ float leaky(float x, float ns) { return x > 0.f ? x : ns * x; }

// The dropout factor of forward-canonical edge e under head h.
__device__ __forceinline__ float keep_of(const Params& p, int32_t seed, uint32_t e, int h) {
  uint32_t x = (e * static_cast<uint32_t>(p.heads) + static_cast<uint32_t>(h)) ^
               static_cast<uint32_t>(seed);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & 0xFFFFFFu) < p.thresh ? p.scale : 0.f;
}

// Over the lanes of one head (lanes hp apart): one warp reduction of the
// floats' ordered integers where every lane holds one head, else a
// butterfly. Exact either way.
__device__ __forceinline__ float head_max(float x, int hp) {
  if (hp == 1) {
    const int b = __float_as_int(x);
    const int m = __reduce_max_sync(kFull, b ^ ((b >> 31) & 0x7fffffff));
    return __int_as_float(m ^ ((m >> 31) & 0x7fffffff));
  }
  for (int off = hp; off < kWarp; off <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// V values of a row in device memory at p, as floats: one read where p is
// aligned to the V values (`vec`), else one value at a time.
template <int V, typename T>
__device__ __forceinline__ void ld_vals(const T* p, bool vec, float (&v)[V]) {
  if (vec) {
    lds_vec<V>(p, v);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_float(p[k]);
  }
}

// A warp's shared memory (k3_geometry.h sizes it): its ring of kStages
// stages of `slots` staged rows of slot_bytes each, and beside them each
// staged edge's a_src or node; one mbarrier a stage (the bulk route); the
// edge range of each of its kBlocks index blocks; each staged row's offset
// in its span and its edge id; a block's (edge, head) weights; each stage's
// row count; the blocks' indices and b2's edge ids, 32 edges a block.
struct Ring {
  char* rows;
  char* edge;       // (kStages · slots, H): float a_src or float4 node
  uint64_t* bars;   // (kStages)
  int* bounds;      // (kBlocks, 2): a block's [first, end) edge
  int2* meta;       // (kStages · slots): the offset in the span, the edge id
  float2* wts;      // (32): a block's weights, edge u, head h at u·hp + h
  int* counts;      // (kStages): rows staged (0: the stream is done)
  int32_t* idx;     // (kBlocks, 32)
  int32_t* eid;     // (kBlocks, 32)

  __device__ __forceinline__ Ring(char* base, const Params& p) {
    rows = base;
    edge = base + kStages * p.slots * p.slot_bytes;
    bars = reinterpret_cast<uint64_t*>(edge + kStages * p.slots * p.edge_bytes);
    bounds = reinterpret_cast<int*>(bars + kStages);
    meta = reinterpret_cast<int2*>(bounds + 2 * kBlocks);
    wts = reinterpret_cast<float2*>(meta + kStages * p.slots);
    counts = reinterpret_cast<int*>(wts + kWarp);
    idx = counts + kStages;
    eid = idx + kBlocks * kWarp;
  }
};

// The producer side of one warp's ring, as K1's (csr_spmm.cu): the stream
// of edges [f, end), less the listed long rows' edges [skip_s, skip_e) (the
// chunk warps take them), is fetched in blocks of up to 32 indices (and
// b2's edge ids) kBlocks blocks ahead of the stages; a stage takes up to
// `slots` edges of the current block and copies each row as its 16-byte
// span (kBulk: one TMA bulk copy a row, completing on the stage's mbarrier;
// else cp.async.cg copies of 16 bytes over the lanes) and each edge's a_src
// (forward) or node (b2) by cp.async, in the stage's commit group.
template <typename XT, bool kBulk, bool kFwd>
struct Stager {
  using Raw = std::conditional_t<sizeof(XT) == 4, uint32_t, uint16_t>;
  // the fetch cursor and the next skip: the listed long row k below r1 (a
  // run), or the gap from chunk k's end to chunk k + 1's, below r1 (chunks)
  int f, end, skip_s, skip_e, k, r1;
  bool chunks;
  int c, lo, hi;                          // the stage cursor in the current block
  int cb;                                 // the current block's slot
  uint64_t piece_base;                    // the array's first byte of this walk's columns
  int piece_bytes;
  // the cp.async route's lane split of a stage's 16-byte copies (a walk's
  // constants, so that no stage divides): width 16-byte chunks a row, lane l
  // starts at row cj, chunk ci and steps cjs rows and cis chunks; `whole`:
  // every span is its row and width divides 32 (cis = 0)
  int width, cj, ci, cjs, cis;
  bool whole;

  __device__ __forceinline__ void next_skip(const Params& p) {
    skip_s = skip_e = kNone32;
    if (chunks) {
      if (k + 1 < r1) {
        skip_s = static_cast<int>(p.chunks[2 * k + 1]);
        skip_e = static_cast<int>(p.chunks[2 * k + 2]);
      }
    } else if (k < p.n_long) {
      const int r = static_cast<int>(p.rows[k]);
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
    const int stop = skip_s < end ? skip_s : end;
    const int e = f < stop ? min(f + kWarp, stop) : f;
    if (f + lane < e) {
      cp_async4(ring.idx + b * kWarp + lane, p.idx + f + lane);
      if (!kFwd && p.eid != nullptr) cp_async4(ring.eid + b * kWarp + lane, p.eid + f + lane);
    }
    if (lane == 0) {
      ring.bounds[2 * b] = f;
      ring.bounds[2 * b + 1] = e;
    }
    f = e;
  }

  // Fetch the first kBlocks blocks and wait for them (once a walk).
  __device__ __forceinline__ void start(const Params& p, const Ring& ring) {
    if constexpr (!kBulk) {
      const int lane = threadIdx.x % kWarp;
      const int chunks16 = (piece_bytes + 15) / 16;
      whole = p.whole && kWarp % chunks16 == 0;
      width = whole ? chunks16 : p.slot_bytes / 16;
      cj = lane / width;
      ci = lane % width;
      cjs = kWarp / width;
      cis = whole ? 0 : kWarp % width;
    }
    for (int b = 0; b < kBlocks; ++b) fetch(p, ring, b);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    cb = 0;
    lo = c = ring.bounds[0];
    hi = ring.bounds[1];
  }

  // The values of the 16-byte chunk at a that lie inside the array, one at a
  // time (only a chunk at its first or last bytes).
  __device__ __forceinline__ void copy_inside(const Params& p, char* dst, uint64_t a) const {
#pragma unroll
    for (int o = 0; o < 16; o += static_cast<int>(sizeof(Raw))) {
      if (a + o >= p.x && a + o + sizeof(Raw) <= p.x_end)
        *reinterpret_cast<Raw*>(dst + o) = *reinterpret_cast<const Raw*>(a + o);
    }
  }

  // Fill stage s (ring slot s % kStages) and commit its group. When the
  // current block is staged, its slot is refilled and the next block becomes
  // current; that block was fetched kBlocks - 1 = kStages stages before, so
  // its indices have landed (wait() waited for that stage's group).
  __device__ __forceinline__ void issue(const Params& p, const Ring& ring, uint32_t s) {
    const int lane = threadIdx.x % kWarp;
    if (c == hi) {
      fetch(p, ring, cb);
      cb = cb + 1 == kBlocks ? 0 : cb + 1;
      lo = c = ring.bounds[2 * cb];
      hi = ring.bounds[2 * cb + 1];
    }
    const int b = static_cast<int>(s % kStages);
    const int n = min(p.slots, hi - c);
    const int32_t* src = ring.idx + cb * kWarp + (c - lo);
    const uint64_t row_bytes = static_cast<uint64_t>(p.hd) * sizeof(XT);
    char* stage = ring.rows + b * p.slots * p.slot_bytes;
    if (lane == 0) ring.counts[b] = n;
    if (lane < n) {
      const uint64_t a = piece_base + static_cast<uint64_t>(src[lane]) * row_bytes;
      // the dropout key's edge: the forward's CSR position, b2's eid
      const int32_t e = kFwd ? c + lane
                             : (p.eid != nullptr ? ring.eid[cb * kWarp + (c - lo) + lane] : 0);
      ring.meta[b * p.slots + lane] = make_int2(static_cast<int>(a & 15u), e);
    }
    // each edge's H values of a_src, or its H float4s of node
    const int items = n << p.hs;
    for (int q = lane; q < items; q += kWarp) {
      const int u = q >> p.hs, h = q & (p.hp - 1);
      if (h >= p.heads) continue;
      const int64_t at = static_cast<int64_t>(src[u]) * p.heads + h;
      if constexpr (kFwd) {
        cp_async4(reinterpret_cast<float*>(ring.edge) + (b * p.slots + u) * p.heads + h,
                  p.edge_src + at);
      } else {
        cp_async16(reinterpret_cast<float4*>(ring.edge) + (b * p.slots + u) * p.heads + h,
                   reinterpret_cast<uint64_t>(p.edge_node + at));
      }
    }
    c += n;
    if constexpr (kBulk) {
      uint64_t* bar = ring.bars + b;
      if (lane < n) {
        const uint64_t a = piece_base + static_cast<uint64_t>(src[lane]) * row_bytes;
        const int off = static_cast<int>(a & 15u);
        const uint64_t a0 = a - off;
        const uint32_t span = static_cast<uint32_t>(off + piece_bytes + 15) & ~15u;
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
      if (whole) {
        // every span is its row, chunks dividing 32: a lane copies the same
        // chunk of every (32 / chunks)-th row
        for (int j = cj; j < n; j += cjs)
          cp_async16(stage + j * p.slot_bytes + 16 * ci,
                     piece_base + static_cast<uint64_t>(src[j]) * row_bytes + 16u * ci);
      } else {
        // chunk q of the stage: row j = q / width, chunk i = q % width
        const int total = n * width;
        int j = cj, i = ci;
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
          j += cjs;
          i += cis;
          if (i >= width) {
            i -= width;
            ++j;
          }
        }
      }
    }
    cp_async_commit();
  }

  // Wait for stage s: its rows (the bulk route: its mbarrier) and its
  // cp.async group (every older group).
  __device__ __forceinline__ void wait(const Ring& ring, uint32_t s) const {
    if constexpr (kBulk) mbar_wait(ring.bars + s % kStages, (s / kStages) & 1u);
    cp_async_wait<kStages - 1>();
    __syncwarp();
  }
};

// The row inputs (the forward's a_dst, b2's a_src) of rows visited one by
// one in ascending order, 32 / hp rows a batch: lane l holds head l % hp of
// row base + l / hp, the next batch loaded a batch ahead.
struct RowHeads {
  int base;
  float cur, next;
  int per;

  __device__ __forceinline__ float load(const Params& p, int b) const {
    const int lane = threadIdx.x % kWarp;
    const int r = b + (lane >> p.hs);
    const int h = lane & (p.hp - 1);
    return h < p.heads && r < p.n_rows ? __ldg(p.row_in + static_cast<int64_t>(r) * p.heads + h)
                                       : 0.f;
  }

  __device__ __forceinline__ void init(const Params& p, int r0) {
    per = kWarp >> p.hs;
    base = r0;
    cur = load(p, r0);
    next = load(p, r0 + per);
  }

  // this lane's head of row r (called for every row, r = base.. ascending)
  __device__ __forceinline__ float at(const Params& p, int r) {
    if (r - base == per) {
      base += per;
      cur = next;
      next = load(p, base + per);
    }
    const int lane = threadIdx.x % kWarp;
    return __shfl_sync(kFull, cur, ((r - base) << p.hs) + (lane & (p.hp - 1)));
  }
};

// b2, at the end of row r's walk over one piece: grad_a_src = Σ_D v·w2 − w3
// of the heads whose columns lie in the piece. Each lane takes the dot of
// its vectors of w2 (acc1, the row's sums, the same on every lane group)
// with its values of v (vr). Each row t of the lanes' vectors (c = col +
// t·lanes) is summed per head by a segmented reduction down the group's
// lanes (a head's vectors are consecutive, at most d / V of them), which
// leaves each head's share of the row on the lane of its first vector
// there; lane h adds head h's shares over the rows t, adds the share an
// earlier piece wrote where the head began there, and takes w3 (ps: lane h
// holds head h's) off in the head's last piece. The same order every run.
template <int kVecs, int V>
__device__ __forceinline__ void head_dots(const Params& p, int r, int col0, int nvec, int lanes,
                                          int col, const int (&head)[kVecs],
                                          const float (&vr)[kVecs][V],
                                          const float (&acc1)[kVecs][V], float ps) {
  const int lane = threadIdx.x % kWarp;
  const int per_head = p.d / V;  // vectors a head
  float x[kVecs];
  int span[kVecs];  // offsets down the lanes that stay in this lane's head and row
#pragma unroll
  for (int t = 0; t < kVecs; ++t) {
    const int c = col + t * lanes;
    x[t] = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) x[t] = fmaf(vr[t][k], acc1[t][k], x[t]);
    const int next = min(((head[t] + 1) * p.d - col0) / V, nvec);  // the next head's first vector
    span[t] = c < nvec ? min(next - c, lanes - col) : 0;
  }
  for (int off = 1; off < lanes && off < per_head; off <<= 1) {
#pragma unroll
    for (int t = 0; t < kVecs; ++t) {
      const float y = __shfl_down_sync(kFull, x[t], off);
      if (off < span[t]) x[t] += y;
    }
  }
  // lane h: head h's first and last vector in the piece, and its shares
  const int end = col0 + nvec * V;  // the piece's last column, plus one
  const int h = lane;
  const bool mine = h < p.heads && h * p.d < end && (h + 1) * p.d > col0;
  const int first = max(h * p.d - col0, 0) / V, last = min((h + 1) * p.d - col0, end - col0) / V;
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < kVecs; ++t) {
    const int src = max(first, t * lanes);
    const bool in_row = mine && src < min(last, (t + 1) * lanes);
    const float y = __shfl_sync(kFull, x[t], in_row ? src - t * lanes : 0);
    if (in_row) sum += y;
  }
  if (mine) {
    float* o = p.s0 + static_cast<int64_t>(r) * p.heads + h;
    if (h * p.d < col0) sum = *o + sum;
    if ((h + 1) * p.d <= end) sum -= ps;
    *o = sum;
  }
}

// One column piece of one warp's work: the rows [r0, r1) of a run (the
// plan's long rows among them skipped, k0 the first listed at or after r0),
// or the chunks [r0, r1) (`chunk`; k0 the long row of chunk r0), each summed
// into its partials; one stream over their edges. A lane sums kVecs vectors
// of V values in each of its two sums. `ticket` numbers this warp's stages
// across its walks (the mbarriers' phases).
template <bool kFwd, int V, int kVecs, typename XT, typename OT, bool kBulk>
__device__ __forceinline__ void walk(const Params& p, const Ring& ring, int r0, int r1, int k0,
                                     bool chunk, int piece, uint32_t& ticket) {
  constexpr int kPass = kVecs == 1 ? 4 : 2;  // staged rows a lane group sums a pass
  const int lane = threadIdx.x % kWarp;
  const int hl = lane & (p.hp - 1);  // the head this lane scores
  const int col0 = piece * p.piece_cols;
  const int nvec = min(p.piece_cols, p.hd - col0) / V;
  const int lanes = p.lanes, groups = kWarp / lanes, g = lane / lanes, col = lane % lanes;
  const int32_t seed = p.seed != nullptr ? __ldg(p.seed) : 0;
  int head[kVecs];  // the head of each of this lane's vectors
#pragma unroll
  for (int t = 0; t < kVecs; ++t) {
    const int c = col + t * lanes;
    head[t] = c < nvec ? k3::head_of(col0, c, V, p.d) : 0;
  }

  Stager<XT, kBulk, kFwd> st;
  st.k = chunk ? r0 : k0;
  st.r1 = r1;
  st.chunks = chunk;
  st.piece_base = p.x + static_cast<uint64_t>(col0) * sizeof(XT);
  st.piece_bytes = nvec * V * static_cast<int>(sizeof(XT));
  st.f = chunk ? static_cast<int>(p.chunks[2 * r0]) : indptr_at(p, r0);
  st.end = chunk ? static_cast<int>(p.chunks[2 * r1 - 1]) : indptr_at(p, r1);
  st.next_skip(p);
  st.start(p, ring);
  const uint32_t first = ticket;
  uint32_t issued = first;
  for (; issued < first + kStages; ++issued) st.issue(p, ring, issued);

  const auto indptr = [&p](int i) { return indptr_at(p, i); };
  const int n_rows = static_cast<int>(p.n_rows);
  RowOffsetsOf<int> offs;
  RowHeads rh;
  float rin = 0.f;  // this lane's head of the row input
  const OT* vrow = static_cast<const OT*>(p.v) + col0;  // b2: v's columns of this piece
  if (!chunk) {
    offs.init(indptr, n_rows, r0);
    rh.init(p, r0);
  }
  int kc = k0;  // a run: the next listed long row; chunks: chunk r's long row
  int next_long = !chunk && kc < p.n_long ? static_cast<int>(p.rows[kc]) : kNone32;
  uint32_t stage = first;  // the stage being summed, once `started`
  bool started = false;
  int pos = 0, cnt = 0;
  for (int r = r0; r < r1; ++r) {
    int s0, e0;
    if (chunk) {
      s0 = static_cast<int>(p.chunks[2 * r]);
      e0 = static_cast<int>(p.chunks[2 * r + 1]);
      if (r > r0 && r == p.chunk_ptr[kc + 1]) ++kc;  // the next long row's first chunk
      rin = hl < p.heads ? __ldg(p.row_in + p.rows[kc] * p.heads + hl) : 0.f;
    } else {
      offs.row(indptr, n_rows, r, s0, e0);
      rin = rh.at(p, r);
      if (r == next_long) {  // its chunks and the fold write it
        ++kc;
        next_long = kc < p.n_long ? static_cast<int>(p.rows[kc]) : kNone32;
        continue;
      }
    }
    // this lane's head: the forward's running maximum m of a_src, its shift
    // sh = leaky(m + a_dst), and Σ p, Σ p·slope of the lane's pairs; b2's Σ
    // α·slope·C
    float m = -INFINITY, sh = 0.f, ps = 0.f, pss = 0.f;
    float acc0[kVecs][V], acc1[kVecs][V];
#pragma unroll
    for (int t = 0; t < kVecs; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) acc0[t][k] = acc1[t][k] = 0.f;
    // b2: this lane's values of v's row r, read before the row's edges so
    // that the read is in flight while they are summed
    float vr[kVecs][V];
    if constexpr (!kFwd) {
#pragma unroll
      for (int t = 0; t < kVecs; ++t) {
        const int c = col + t * lanes;
#pragma unroll
        for (int k = 0; k < V; ++k) vr[t][k] = 0.f;
        if (!chunk && c < nvec)
          ld_vals<V>(vrow + static_cast<int64_t>(r) * p.hd + c * V, p.v_vec != 0, vr[t]);
      }
    }
    for (int rem = e0 - s0; rem > 0;) {
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
      // a block: this row's next edges in this stage, at most 32 / hp, scored
      // at once (one (edge, head) pair a lane: lane l takes head hl of edge
      // l / hp), then summed in passes
      const int blk = min(min(cnt - pos, kWarp >> p.hs), rem);
      const int base = static_cast<int>(stage % kStages) * p.slots + pos;
      const int u = lane >> p.hs;  // this lane's edge of the block
      const bool live = hl < p.heads && u < blk;
      if constexpr (kFwd) {
        const float a = live ? reinterpret_cast<const float*>(ring.edge)[(base + u) * p.heads + hl]
                             : -INFINITY;
        // the block's maximum of each head only where a lane's pair passes
        // its head's running maximum (the first block of a row): the result
        // is the same, as a rise needs every lane of the head
        if (__any_sync(kFull, a > m)) {
          const float mx = head_max(a, p.hp);
          float f = 1.f;
          if (mx > m) {  // the same on every lane of the head: raise the shift
            const float nsh = leaky(mx + rin, p.ns);
            if (m > -INFINITY) f = expf(sh - nsh);
            m = mx;
            sh = nsh;
          }
          if (__any_sync(kFull, f != 1.f)) {  // rescale the sums so far, each by its head's f
            ps *= f;
            pss *= f;
#pragma unroll
            for (int t = 0; t < kVecs; ++t) {
              const float ft = __shfl_sync(kFull, f, head[t]);
#pragma unroll
              for (int k = 0; k < V; ++k) {
                acc0[t][k] *= ft;
                acc1[t][k] *= ft;
              }
            }
          }
        }
        if (live) {
          const float z = a + rin;
          const float slope = z > 0.f ? 1.f : p.ns;
          const float e = expf(leaky(z, p.ns) - sh);
          const float pm =
              p.seed != nullptr
                  ? e * keep_of(p, seed, static_cast<uint32_t>(ring.meta[base + u].y), hl)
                  : e;
          ps += e;
          pss += e * slope;
          ring.wts[lane] = make_float2(pm, pm * slope);
        }
      } else if (live) {
        // a_dst, shift, inv_s, C of the edge's dst
        const float4 nd = reinterpret_cast<const float4*>(ring.edge)[(base + u) * p.heads + hl];
        const float z = rin + nd.x;
        const float slope = z > 0.f ? 1.f : p.ns;
        const float alpha = expf(leaky(z, p.ns) - nd.y) * nd.z;
        const float wv =
            p.seed != nullptr
                ? alpha * keep_of(p, seed, static_cast<uint32_t>(ring.meta[base + u].y), hl)
                : alpha;
        ps = fmaf(alpha * slope, nd.w, ps);
        ring.wts[lane] = make_float2(wv, wv * slope);
      }
      __syncwarp();
      // sum the staged rows in passes of up to kPass rows a lane group, each
      // vector with its head's weights
      for (int b0 = 0; b0 < blk; b0 += kPass * groups) {
#pragma unroll
        for (int pr = 0; pr < kPass; ++pr) {  // a pass's rows of this lane group
          const int j = b0 + pr * groups + g;
          if (j >= blk) continue;
          const XT* xr = reinterpret_cast<const XT*>(ring.rows + (base + j) * p.slot_bytes +
                                                     ring.meta[base + j].x);
#pragma unroll
          for (int t = 0; t < kVecs; ++t) {
            const int c = col + t * lanes;
            if (c < nvec) {
              const float2 w = ring.wts[(j << p.hs) + head[t]];
              float v[V];
              lds_vec<V>(xr + c * V, v);
#pragma unroll
              for (int k = 0; k < V; ++k) {
                acc0[t][k] = fmaf(w.x, v[k], acc0[t][k]);
                acc1[t][k] = fmaf(w.y, v[k], acc1[t][k]);
              }
            }
          }
        }
      }
      __syncwarp();
      pos += blk;
      rem -= blk;
    }
    // the row's sums: the lane groups' by the butterfly (offsets lanes ..
    // 16), each head's scalars over its lanes (offsets hp .. 16), level by
    // level so that a level's shuffles are in flight together; the same
    // order every run
    for (int off = lanes < p.hp ? lanes : p.hp; off < kWarp; off <<= 1) {
      if (off >= lanes) {
#pragma unroll
        for (int t = 0; t < kVecs; ++t)
#pragma unroll
          for (int k = 0; k < V; ++k) {
            acc0[t][k] += __shfl_xor_sync(kFull, acc0[t][k], off);
            acc1[t][k] += __shfl_xor_sync(kFull, acc1[t][k], off);
          }
      }
      if (off >= p.hp) {
        ps += __shfl_xor_sync(kFull, ps, off);
        if (kFwd) pss += __shfl_xor_sync(kFull, pss, off);
      }
    }
    float sv[kVecs];  // the forward's s of each vector's head
#pragma unroll
    for (int t = 0; t < kVecs; ++t) sv[t] = __shfl_sync(kFull, ps, head[t]);
    if (g == 0) {
#pragma unroll
      for (int t = 0; t < kVecs; ++t) {
        const int c = col + t * lanes;
        if (c >= nvec) continue;
        // r: the chunk or the row
        const int64_t off = static_cast<int64_t>(r) * p.hd + col0 + c * V;
        if (chunk) {
          store_vec<V>(p.part0 + off, acc0[t]);
          store_vec<V>(p.part1 + off, acc1[t]);
        } else if (kFwd) {
          // out = num / s, w1 = w1u / s, or 0 on an empty row
          float o0[V], o1[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            o0[k] = sv[t] > 0.f ? acc0[t][k] / sv[t] : 0.f;
            o1[k] = sv[t] > 0.f ? acc1[t][k] / sv[t] : 0.f;
          }
          store_vec<V>(static_cast<float*>(p.out0) + off, o0);
          store_vec<V>(p.out1 + off, o1);
        } else {
          store_vec<V>(static_cast<OT*>(p.out0) + off, acc0[t]);
        }
      }
    }
    if constexpr (!kFwd) {
      if (!chunk) head_dots<kVecs, V>(p, r, col0, nvec, lanes, col, head, vr, acc1, ps);
    }
    if (piece == 0 && lane < p.heads) {
      const int64_t at = static_cast<int64_t>(r) * p.heads + lane;
      if (kFwd && chunk) {
        const int64_t ch = p.n_chunks * p.heads;
        p.pscal[at] = sh;
        p.pscal[ch + at] = ps;
        p.pscal[2 * ch + at] = pss;
      } else if (kFwd) {
        p.s0[at] = ps > 0.f ? 1.f / ps : 0.f;
        p.s1[at] = ps > 0.f ? pss / ps : 0.f;
        p.s2[at] = sh;
      } else if (chunk) {
        p.pscal[at] = ps;
      }
    }
  }
  // the stages issued past the last one summed are empty (or, for a plan
  // that does not match the CSR, unread): let them land before the ring is
  // reused
  if constexpr (kBulk) {
    for (uint32_t s = started ? stage + 1 : first; s < issued; ++s)
      mbar_wait(ring.bars + s % kStages, (s / kStages) & 1u);
  }
  cp_async_wait_all();
  __syncwarp();
  ticket = issued;
}

// For every column c < n_cols: out(c, Σ_k term(k, c)) over the chunks k in
// [k0, k1), added in ascending k. Lane groups of L lanes (the least power of
// two that covers n_cols, at most 32) read kFoldUnroll·groups chunks at once,
// group g the chunks kb + u·groups + g; every lane then adds them in
// ascending k through shuffles, so the order does not depend on the lanes
// (lanes.cuh's fold_row, with the term and the store left to the caller).
template <typename Term, typename Out>
__device__ __forceinline__ void fold_columns(int64_t k0, int64_t k1, int n_cols, Term term,
                                             Out out) {
  const int lane = threadIdx.x % kWarp;
  int lanes = 1;
  while (lanes < n_cols && lanes < kWarp) lanes <<= 1;
  const int groups = kWarp / lanes, g = lane / lanes, col = lane % lanes;
  const int64_t step = static_cast<int64_t>(groups) * kFoldUnroll;
  for (int c0 = 0; c0 < n_cols; c0 += lanes) {
    const int c = c0 + col;
    float acc = 0.f;
    for (int64_t kb = k0; kb < k1; kb += step) {
      float v[kFoldUnroll];
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const int64_t k = kb + static_cast<int64_t>(u) * groups + g;
        v[u] = k < k1 && c < n_cols ? term(k, c) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u)
        for (int gg = 0; gg < groups; ++gg) acc += __shfl_sync(kFull, v[u], gg * lanes + col);
    }
    if (g == 0 && c < n_cols) out(c, acc);
  }
}

// The fold of long row i, by the warp that counted its last chunk
// (`scratch`: 96 floats of the warp's shared memory; out of line, as it
// runs once a long row): the chunks' partials (written by other warps of this launch, read
// through L2) added in ascending chunk order by fold_columns. Forward: per head,
// sh = max_k sh_k and chunk k's sums scaled by f_k = exp(sh_k − sh) ≤ 1
// (every chunk holds its maximum edge, whose p is 1, so s >= 1); b2:
// linear sums, grad_v rounded once, then grad_a_src from w2 and w3 as
// head_dots takes it.
template <bool kFwd, typename OT>
__device__ __noinline__ void fold(const Params& p, float* scratch, int64_t i) {
  const int lane = threadIdx.x % kWarp;
  const int64_t k0 = p.chunk_ptr[i], k1 = p.chunk_ptr[i + 1], row = p.rows[i];
  const int64_t ch = p.n_chunks * p.heads;
  const int H = p.heads, hd = p.hd, d = p.d;
  const float* psh = p.pscal;
  if constexpr (kFwd) {
    // each head's shift sh, then its s and w1su: scratch[h], [32 + h], [64 + h]
    float* shs = scratch;
    float* ss = scratch + kWarp;
    float* sss = scratch + 2 * kWarp;
    for (int h = 0; h < H; ++h) {
      float sh = -INFINITY;
      for (int64_t k = k0 + lane; k < k1; k += kWarp) sh = fmaxf(sh, __ldcg(psh + k * H + h));
      sh = head_max(sh, 1);
      if (lane == 0) shs[h] = sh;
    }
    __syncwarp();
    const auto f = [&](int64_t k, int h) { return expf(__ldcg(psh + k * H + h) - shs[h]); };
    fold_columns(k0, k1, H, [&](int64_t k, int h) { return f(k, h) * __ldcg(psh + ch + k * H + h); },
                 [&](int h, float x) { ss[h] = x; });
    fold_columns(k0, k1, H,
                 [&](int64_t k, int h) { return f(k, h) * __ldcg(psh + 2 * ch + k * H + h); },
                 [&](int h, float x) { sss[h] = x; });
    __syncwarp();
    float* out = static_cast<float*>(p.out0) + row * hd;
    float* w1 = p.out1 + row * hd;
    fold_columns(k0, k1, hd, [&](int64_t k, int c) { return f(k, c / d) * __ldcg(p.part0 + k * hd + c); },
                 [&](int c, float num) { out[c] = num / ss[c / d]; });
    fold_columns(k0, k1, hd, [&](int64_t k, int c) { return f(k, c / d) * __ldcg(p.part1 + k * hd + c); },
                 [&](int c, float wu) { w1[c] = wu / ss[c / d]; });
    if (lane < H) {
      p.s0[row * H + lane] = 1.f / ss[lane];
      p.s1[row * H + lane] = sss[lane] / ss[lane];
      p.s2[row * H + lane] = shs[lane];
    }
    __syncwarp();
  } else {
    OT* gv = static_cast<OT*>(p.out0) + row * hd;
    float* w2 = p.part1 + k0 * hd;
    fold_columns(k0, k1, hd, [&](int64_t k, int c) { return __ldcg(p.part0 + k * hd + c); },
                 [&](int c, float x) {
                   const float o[1] = {x};
                   store_vec<1>(gv + c, o);
                 });
    // w2 into chunk k0's partials row (each value read by the lane that
    // writes it, before it writes it), w3 into scratch
    fold_columns(k0, k1, hd, [&](int64_t k, int c) { return __ldcg(p.part1 + k * hd + c); },
                 [&](int c, float x) { __stcg(w2 + c, x); });
    fold_columns(k0, k1, H, [&](int64_t k, int h) { return __ldcg(psh + k * H + h); },
                 [&](int h, float x) { scratch[h] = x; });
    __syncwarp();
    // grad_a_src = Σ_D v·w2 − w3, a head at a time, summed over the lanes
    const OT* v = static_cast<const OT*>(p.v) + row * hd;
    for (int h = 0; h < H; ++h) {
      float x = 0.f;
      for (int j = lane; j < d; j += kWarp) x = fmaf(to_float(v[h * d + j]), __ldcg(w2 + h * d + j), x);
      for (int off = 1; off < kWarp; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
      if (lane == 0) p.s0[row * H + h] = x - scratch[h];
    }
    __syncwarp();
  }
}

// A pass's launch: the first n_chunk_blocks blocks take chunk_group chunks
// a warp, then the fold; the others one run of rows a warp, every head.
template <bool kFwd, int V, int kVecs, typename XT, typename OT, bool kBulk>
__device__ __forceinline__ void pass(const Params& p) {
  extern __shared__ __align__(16) char smem[];
  const Ring ring(smem + (threadIdx.x / kWarp) * p.warp_smem, p);
  const int lane = threadIdx.x % kWarp;
  const int pieces = (p.hd + p.piece_cols - 1) / p.piece_cols;
  if constexpr (kBulk) {  // one arrival a lane a stage
    if (lane == 0)
      for (int b = 0; b < kStages; ++b) mbar_init(ring.bars + b, kWarp);
    mbar_init_fence();
    __syncwarp();
  }
  uint32_t ticket = 0;
  // this warp's work item: a chunk in the first n_chunk_blocks blocks, else a run
  const int64_t b = blockIdx.x;
  const bool is_chunk = b < p.n_chunk_blocks;
  const int64_t item = (is_chunk ? b : b - p.n_chunk_blocks) * kWarps + threadIdx.x / kWarp;
  if (is_chunk) {
    const int64_t k0 = item * p.chunk_group;
    if (k0 >= p.n_chunks) return;  // uniform across the warp
    const int64_t k1 = min(k0 + p.chunk_group, p.n_chunks);
    const int64_t i = chunk_owner(p.chunk_ptr, p.n_long, k0);
    for (int piece = 0; piece < pieces; ++piece)
      walk<kFwd, V, kVecs, XT, OT, kBulk>(p, ring, static_cast<int>(k0), static_cast<int>(k1),
                                          static_cast<int>(i), true, piece, ticket);
    count_and_fold(p.counters, p.chunk_ptr, p.n_long, k0, k1,
                   [&](int64_t i_long) {  // the index blocks, done with, as scratch
                     fold<kFwd, OT>(p, reinterpret_cast<float*>(ring.idx), i_long);
                   });
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
    walk<kFwd, V, kVecs, XT, OT, kBulk>(p, ring, static_cast<int>(r0), static_cast<int>(r1),
                                        static_cast<int>(k0), false, piece, ticket);
}

// The two passes' kernels, each named for its pass in a profile.
template <int V, int kVecs, typename XT, bool kBulk>
__global__ void __launch_bounds__(kWarp * kWarps, k3::kMinBlocks)
gat_fwd_kernel(const __grid_constant__ Params p) {
  pass<true, V, kVecs, XT, float, kBulk>(p);
}

template <int V, int kVecs, typename OT, bool kBulk>
__global__ void __launch_bounds__(kWarp * kWarps, k3::kMinBlocks)
gat_b2_kernel(const __grid_constant__ Params p) {
  pass<false, V, kVecs, float, OT, kBulk>(p);
}

using Kernel = void (*)(Params);

template <bool kFwd, int V, int kVecs, typename XT, typename OT, bool kBulk>
Kernel kernel_of() {
  if constexpr (kFwd) {
    return gat_fwd_kernel<V, kVecs, XT, kBulk>;
  } else {
    return gat_b2_kernel<V, kVecs, OT, kBulk>;
  }
}

// The instantiation that sums `vecs` vectors a lane: 1, 2 or the most
// (kMaxVecs, at most kAccFloats / V values); the cp.async route (spans under
// 144 bytes) only 1 or 2, else null.
template <bool kFwd, int V, typename XT, typename OT, bool kBulk>
Kernel kernel_for(int vecs) {
  constexpr int kMost = k3::kMaxVecs * V < k3::kAccFloats ? k3::kMaxVecs : k3::kAccFloats / V;
  Kernel kernel = nullptr;
  if (vecs == 1) {
    kernel = kernel_of<kFwd, V, 1, XT, OT, kBulk>();
  } else if (vecs == 2) {
    kernel = kernel_of<kFwd, V, 2, XT, OT, kBulk>();
  } else if constexpr (kBulk && kMost > 2) {
    if (vecs <= kMost) kernel = kernel_of<kFwd, V, kMost, XT, OT, kBulk>();
  }
  return kernel;
}

template <bool kFwd, typename XT, typename OT, bool kBulk>
int launch(const Params& p, int vec, int vecs, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(p.n_chunk_blocks + (p.n_runs + kWarps - 1) / kWarps));
  const size_t smem = static_cast<size_t>(p.warp_smem) * kWarps;
  auto kernel = kernel_for<kFwd, 1, XT, OT, kBulk>(vecs);
  if (vec == 2) {
    kernel = kernel_for<kFwd, 2, XT, OT, kBulk>(vecs);
  } else if (vec == 4) {
    kernel = kernel_for<kFwd, 4, XT, OT, kBulk>(vecs);
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

// Params of one pass over the CSR (indptr, idx) and the gathered array x of
// n_x rows of elem_bytes values, sized by k3::geometry; false for what the
// kernels do not take.
bool params_of(int pass, const void* indptr, int ip64, const void* idx, const void* x,
               long long n_x, int elem_bytes, long long n_rows, int heads, int d, float ns,
               const void* seed, unsigned thresh, float scale, const void* rows,
               const void* chunk_ptr, long long n_long, const void* chunks, long long n_chunks,
               void* counters, long long n_edges, Params& p, k3::Geometry& g) {
  // 32-bit positions (src, dst and eid are int32), with room for a batch of
  // 32 rows past the last
  constexpr long long kMaxCount = INT32_MAX - 64;
  if (!k3::geometry(pass, heads, d, elem_bytes, reinterpret_cast<uint64_t>(x), n_rows, n_edges,
                    n_chunks, g) ||
      (n_long > 0 && counters == nullptr) || n_rows > kMaxCount || n_edges > kMaxCount ||
      n_chunks > kMaxCount)
    return false;
  p = Params{};
  p.indptr = indptr;
  p.ip64 = ip64;
  p.idx = static_cast<const int32_t*>(idx);
  p.x = reinterpret_cast<uint64_t>(x);
  p.x_end = p.x + static_cast<uint64_t>(n_x) * static_cast<uint64_t>(heads) *
                      static_cast<uint64_t>(d) * static_cast<uint64_t>(elem_bytes);
  p.rows = static_cast<const int64_t*>(rows);
  p.chunk_ptr = static_cast<const int64_t*>(chunk_ptr);
  p.chunks = static_cast<const int64_t*>(chunks);
  p.counters = static_cast<int32_t*>(counters);
  p.seed = static_cast<const int32_t*>(seed);
  p.thresh = thresh;
  p.scale = scale;
  p.ns = ns;
  p.n_rows = n_rows;
  p.n_long = n_long;
  p.n_chunks = n_chunks;
  p.n_chunk_blocks = g.n_chunk_blocks;
  p.run_units = g.run_units;
  p.n_runs = g.n_runs;
  p.n_units = n_rows + n_edges;
  p.heads = heads;
  p.hp = g.hp;
  p.hs = __builtin_ctz(static_cast<unsigned>(g.hp));
  p.d = d;
  p.hd = heads * d;
  p.piece_cols = g.piece_cols;
  p.lanes = g.lanes;
  p.slots = g.slots;
  p.slot_bytes = g.slot_bytes;
  p.edge_bytes = g.edge_bytes;
  p.warp_smem = g.warp_smem;
  p.chunk_group = g.chunk_group;
  p.whole = g.align == 16;
  return true;
}

template <typename VT>
int run_fwd(const void* indptr, int ip64, const void* src, const void* v, long long n_src,
            const void* a_src, const void* a_dst, void* out, void* w1, void* inv_s, void* w1s,
            void* shift, long long n_rows, int heads, int d, float ns, const void* seed,
            unsigned thresh, float scale, const void* rows, const void* chunk_ptr,
            long long n_long, const void* chunks, long long n_chunks, void* pnum, void* counters,
            void* pw1u, void* pscal, long long n_edges, void* stream) {
  if (n_rows <= 0 || heads <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  k3::Geometry g;
  if (!params_of(k3::kFwd, indptr, ip64, src, v, n_src, static_cast<int>(sizeof(VT)), n_rows,
                 heads, d, ns, seed, thresh, scale, rows, chunk_ptr, n_long, chunks, n_chunks,
                 counters, n_edges, p, g))
    return static_cast<int>(cudaErrorInvalidValue);
  p.edge_src = static_cast<const float*>(a_src);
  p.row_in = static_cast<const float*>(a_dst);
  p.out0 = out;
  p.out1 = static_cast<float*>(w1);
  p.s0 = static_cast<float*>(inv_s);
  p.s1 = static_cast<float*>(w1s);
  p.s2 = static_cast<float*>(shift);
  p.part0 = static_cast<float*>(pnum);
  p.part1 = static_cast<float*>(pw1u);
  p.pscal = static_cast<float*>(pscal);
  auto s = static_cast<cudaStream_t>(stream);
  return g.bulk ? launch<true, VT, float, true>(p, g.vec, g.vecs, s)
                : launch<true, VT, float, false>(p, g.vec, g.vecs, s);
}

template <typename GVT>
int run_b2(const void* indptr, int ip64, const void* dst, const void* eid, const void* g_out,
           long long n_dst, const void* node, const void* a_src, const void* v, void* grad_v,
           void* grad_a_src, long long n_rows, int heads, int d, float ns, const void* seed,
           unsigned thresh, float scale, const void* rows, const void* chunk_ptr,
           long long n_long, const void* chunks, long long n_chunks, void* pgv, void* counters,
           void* pw2, void* pw3, long long n_edges, void* stream) {
  if (n_rows <= 0 || heads <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  Params p;
  k3::Geometry g;
  if (!params_of(k3::kB2, indptr, ip64, dst, g_out, n_dst, 4, n_rows, heads, d, ns, seed, thresh,
                 scale, rows, chunk_ptr, n_long, chunks, n_chunks, counters, n_edges, p, g) ||
      reinterpret_cast<uint64_t>(node) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.eid = seed != nullptr ? static_cast<const int32_t*>(eid) : nullptr;
  p.edge_node = static_cast<const float4*>(node);
  p.row_in = static_cast<const float*>(a_src);
  p.v = v;
  p.v_vec = reinterpret_cast<uint64_t>(v) % 16 == 0;
  p.out0 = grad_v;
  p.s0 = static_cast<float*>(grad_a_src);
  p.part0 = static_cast<float*>(pgv);
  p.part1 = static_cast<float*>(pw2);
  p.pscal = static_cast<float*>(pw3);
  auto s = static_cast<cudaStream_t>(stream);
  return g.bulk ? launch<false, float, GVT, true>(p, g.vec, g.vecs, s)
                : launch<false, float, GVT, false>(p, g.vec, g.vecs, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// `seed` is null when there is no dropout. The forward gathers n_src rows
// of v (N_src, H, D), b2 n_dst rows of g (N_dst, H, D). The row split
// (graph/split.py, RowSplit.kernel_args(p0, counters=True) less its T):
// the n_long `rows`, whose chunks [chunks[2k], chunks[2k+1]) are
// chunk_ptr[i]..chunk_ptr[i+1], then the first partials buffer and the
// `counters` (n_long int32 zeros, left zero), then the others: the
// forward's pnum and pw1u (n_chunks, H, D) and pscal (3, n_chunks, H); b2's
// pgv and pw2 (n_chunks, H, D) and pw3 (n_chunks, H); null when n_chunks is
// 0, as nothing reads them then. n_edges: the CSR's. k3_geometry.h sizes the launch. One launch a call; returns
// cudaGetLastError(), or cudaErrorInvalidValue for what the kernels do not
// take. b2 reads v (n_rows, H, D), the forward's gathered rows, once a row,
// and writes grad_v and grad_a_src (n_rows, H). gat_fwd_bf16 reads v as
// bfloat16, gat_b2_bf16 reads v and writes grad_v as bfloat16; every other
// operand is float in all four.
#define GAT_FWD_ENTRY(NAME, VT)                                                                  \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* src, const void* v,   \
                      long long n_src, const void* a_src, const void* a_dst, void* out,          \
                      void* w1, void* inv_s, void* w1s, void* shift, long long n_rows,           \
                      int heads, int d, float ns, const void* seed, unsigned thresh,             \
                      float scale, const void* rows, const void* chunk_ptr, long long n_long,    \
                      const void* chunks, long long n_chunks, void* pnum, void* counters,        \
                      void* pw1u, void* pscal, long long n_edges, void* stream) {                \
    return run_fwd<VT>(indptr, indptr_is_int64, src, v, n_src, a_src, a_dst, out, w1, inv_s,     \
                       w1s, shift, n_rows, heads, d, ns, seed, thresh, scale, rows, chunk_ptr,   \
                       n_long, chunks, n_chunks, pnum, counters, pw1u, pscal, n_edges, stream);  \
  }

#define GAT_B2_ENTRY(NAME, GVT)                                                                  \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* dst,                  \
                      const void* eid, const void* g, long long n_dst, const void* node,         \
                      const void* a_src, const void* v, void* grad_v, void* grad_a_src,         \
                      long long n_rows, int heads, int d, float ns, const void* seed,            \
                      unsigned thresh, float scale, const void* rows, const void* chunk_ptr,     \
                      long long n_long, const void* chunks, long long n_chunks, void* pgv,       \
                      void* counters, void* pw2, void* pw3, long long n_edges, void* stream) {   \
    return run_b2<GVT>(indptr, indptr_is_int64, dst, eid, g, n_dst, node, a_src, v, grad_v,      \
                       grad_a_src, n_rows, heads, d, ns, seed, thresh, scale, rows, chunk_ptr,   \
                       n_long, chunks, n_chunks, pgv, counters, pw2, pw3, n_edges, stream);      \
  }

// Each library holds one type's pair: kernels/build.py compiles this file a
// second time with -DK3_BF16, so that the two build in parallel.
#ifdef K3_BF16
GAT_FWD_ENTRY(gat_fwd_bf16, __nv_bfloat16)
GAT_B2_ENTRY(gat_b2_bf16, __nv_bfloat16)
#else
GAT_FWD_ENTRY(gat_fwd_f32, float)
GAT_B2_ENTRY(gat_b2_f32, float)
#endif

// ---- K3's node passes -------------------------------------------------------
//
// The per-(node, head) dot products around the two edge passes, in float
// (only the float32 library holds them): pair p = n·H + h of an (N, H, D)
// array is its row of D values at p·D, taken with head h's row of an
// attention vector (H, D).
//
//   gat_scores_kernel (before gat_fwd): a_src = Σ_D z·attn_src over the
//     source rows and a_dst = Σ_D z_dst·attn_dst over the dst rows, one read
//     of each row (z_dst null: z is both, each row read once for both);
//   gat_score_grad_kernel (before b2): over the dst pairs, C = Σ_D g·out and
//     grad_a_dst = Σ_D g·w1 − C·w1s, and b2's node float4 (a_dst, shift,
//     inv_s, C) written directly;
//   gat_vector_grad_kernel (after b2): grad_z = grad_v + grad_a_src ⊗
//     attn_src + grad_a_dst ⊗ attn_dst (grad_v null where v is not z: 0; a
//     separate z_dst takes grad_a_dst ⊗ attn_dst in grad_z_dst), written
//     over grad_v where they share a buffer, and the attention vectors'
//     gradients Σ_n grad_a_src·z and Σ_n grad_a_dst·z_dst.
//
// A dot product is summed by FMAs in ascending order within a lane, then
// pairwise by a butterfly over the pair's lanes: S lanes a pair (the least
// power of two that covers its D / V vectors, at most 32), 32 / S pairs a
// warp at once, V = 4 values a read where D is a multiple of 4 and every
// row array starts on 16 bytes, else 1. The attention vectors' gradients
// are column sums over N: each block sums its rows into fixed partials
// (each thread its rows in ascending order, then the block's row lanes in
// ascending order), and the block that arrives last on the ticket (a
// counter of the call's own, zeroed on the launch's stream just before it,
// so launches on other streams, or one cut short, never share it) adds the
// blocks' partials in ascending block order in the same launch. No atomic
// decides an order: two runs are bitwise equal.

#ifndef K3_BF16
namespace {

constexpr int kNodeThreads = 256;
constexpr int kNodeWarps = kNodeThreads / kWarp;
constexpr int64_t kNodeMaxBlocks = 65535;
constexpr int kNodeTiles = 4;  // gat_vector_grad: rows a thread reads at once, then sums

template <int V>
__device__ __forceinline__ void ldg_vals(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ float lanes_sum(float x, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

struct ScoreParams {
  const float* z;
  const float* zd;  // z_dst, or null where it is z
  const float* att_s;
  const float* att_d;  // (H, D) each
  float* a_src;
  float* a_dst;
  int64_t n_src, n_dst;
  int heads, d, lanes;
};

// The pair's row n = pr / heads, in 32 bits where every pair index fits.
__device__ __forceinline__ int64_t row_of(int64_t pr, int heads, bool narrow) {
  return narrow ? static_cast<int64_t>(static_cast<uint32_t>(pr) / static_cast<uint32_t>(heads))
                : pr / heads;
}

template <int V>
__global__ void __launch_bounds__(kNodeThreads) gat_scores_kernel(const __grid_constant__ ScoreParams p) {
  const int lane = threadIdx.x % kWarp, S = p.lanes, sub = lane % S, per = kWarp / S;
  const int nv = p.d / V;
  const int64_t pairs = max(p.n_src, p.n_dst) * p.heads;
  const bool narrow = pairs + kWarp * kNodeWarps <= UINT32_MAX;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kNodeWarps;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * kNodeWarps + threadIdx.x / kWarp) * per;
       base < pairs; base += warps * per) {
    const int64_t pr = base + lane / S, n = row_of(pr, p.heads, narrow);
    const int h = static_cast<int>(pr - n * p.heads);
    const bool src = pr < pairs && n < p.n_src, dst = pr < pairs && n < p.n_dst;
    float s = 0.f, t = 0.f;
    for (int j = sub; j < nv; j += S) {
      float x[V], a[V];
      if (src) {
        ldg_vals<V>(p.z + pr * p.d + j * V, x);
        ldg_vals<V>(p.att_s + h * p.d + j * V, a);
#pragma unroll
        for (int k = 0; k < V; ++k) s = fmaf(x[k], a[k], s);
      }
      if (dst) {  // z_dst null: z, whose rows hold every dst row (read above)
        if (p.zd != nullptr) ldg_vals<V>(p.zd + pr * p.d + j * V, x);
        ldg_vals<V>(p.att_d + h * p.d + j * V, a);
#pragma unroll
        for (int k = 0; k < V; ++k) t = fmaf(x[k], a[k], t);
      }
    }
    s = lanes_sum(s, S);
    t = lanes_sum(t, S);
    if (sub == 0) {
      if (src) p.a_src[pr] = s;
      if (dst) p.a_dst[pr] = t;
    }
  }
}

struct ScoreGradParams {
  const float* g;
  const float* out;
  const float* w1;  // (N_dst, H, D) each
  const float* a_dst;
  const float* shift;
  const float* inv_s;
  const float* w1s;  // (N_dst, H) each
  float4* node;
  float* grad_a_dst;
  int64_t n;
  int heads, d, lanes;
};

template <int V>
__global__ void __launch_bounds__(kNodeThreads)
gat_score_grad_kernel(const __grid_constant__ ScoreGradParams p) {
  const int lane = threadIdx.x % kWarp, S = p.lanes, sub = lane % S, per = kWarp / S;
  const int nv = p.d / V;
  const int64_t pairs = p.n * p.heads;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kNodeWarps;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * kNodeWarps + threadIdx.x / kWarp) * per;
       base < pairs; base += warps * per) {
    const int64_t pr = base + lane / S;
    const bool live = pr < pairs;
    float c = 0.f, t = 0.f;
    for (int j = sub; live && j < nv; j += S) {
      float g[V], o[V], w[V];
      ldg_vals<V>(p.g + pr * p.d + j * V, g);
      ldg_vals<V>(p.out + pr * p.d + j * V, o);
      ldg_vals<V>(p.w1 + pr * p.d + j * V, w);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        c = fmaf(g[k], o[k], c);
        t = fmaf(g[k], w[k], t);
      }
    }
    c = lanes_sum(c, S);
    t = lanes_sum(t, S);
    if (sub == 0 && live) {
      p.node[pr] = make_float4(__ldg(p.a_dst + pr), __ldg(p.shift + pr), __ldg(p.inv_s + pr), c);
      p.grad_a_dst[pr] = t - c * __ldg(p.w1s + pr);
    }
  }
}

struct VectorGradParams {
  const float* z;
  const float* zd;  // z_dst, or null where it is z (then n_dst = n_src)
  const float* att_s;
  const float* att_d;  // (H, D) each
  const float* ga_s;   // (N_src, H)
  const float* ga_d;   // (N_dst, H)
  const float* gv;     // (N_src, H, D) added to grad_z, or null
  float* gz;           // (N_src, H, D), may be gv
  float* gzd;          // (N_dst, H, D) where zd is given
  float* part;         // (gridDim.x, 2, H·D)
  int* ticket;
  float* g_att;        // (2, H·D): attn_src's gradient, then attn_dst's
  int64_t n_src, n_dst, rows_per_block;
  int heads, d, hd, cols;  // cols: the block's column lanes C, a power of two
};

template <int V>
__global__ void __launch_bounds__(kNodeThreads)
gat_vector_grad_kernel(const __grid_constant__ VectorGradParams p) {
  __shared__ float red[2][kNodeThreads * V];
  __shared__ bool last;
  const int C = p.cols, R = kNodeThreads / C, ci = threadIdx.x % C, ri = threadIdx.x / C;
  const int nvh = p.hd / V;
  const bool same = p.zd == nullptr;
  const int64_t n_rows = max(p.n_src, p.n_dst);
  const int64_t r0 = min(static_cast<int64_t>(blockIdx.x) * p.rows_per_block, n_rows);
  const int64_t r1 = min(r0 + p.rows_per_block, n_rows);
  float* part = p.part + static_cast<int64_t>(blockIdx.x) * 2 * p.hd;
  for (int j0 = 0; j0 < nvh; j0 += C) {  // the same count on every thread
    const int j = j0 + ci, col = j * V;
    const bool live = j < nvh;
    const int h = live ? col / p.d : 0;
    float as[V], ad[V], accs[V], accd[V];
#pragma unroll
    for (int k = 0; k < V; ++k) as[k] = ad[k] = accs[k] = accd[k] = 0.f;
    if (live) {
      ldg_vals<V>(p.att_s + col, as);
      ldg_vals<V>(p.att_d + col, ad);
      // kNodeTiles rows at once: every row's reads first, then the sums
      for (int64_t n0 = r0 + ri; n0 < r1; n0 += kNodeTiles * R) {
        float x[kNodeTiles][V], g[kNodeTiles][V], gs[kNodeTiles], gd[kNodeTiles];
#pragma unroll
        for (int u = 0; u < kNodeTiles; ++u) {
          const int64_t n = n0 + u * R, at = n * p.hd + col, nh = n * p.heads + h;
#pragma unroll
          for (int k = 0; k < V; ++k) g[u][k] = 0.f;
          gs[u] = gd[u] = 0.f;
          if (n < r1 && n < p.n_src) {
            ldg_vals<V>(p.z + at, x[u]);
            if (p.gv != nullptr) lds_vec<V>(p.gv + at, g[u]);
            gs[u] = __ldg(p.ga_s + nh);
            if (same) gd[u] = __ldg(p.ga_d + nh);
          }
        }
#pragma unroll
        for (int u = 0; u < kNodeTiles; ++u) {
          const int64_t n = n0 + u * R;
          if (n >= r1 || n >= p.n_src) continue;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            g[u][k] = fmaf(gs[u], as[k], g[u][k]);
            accs[k] = fmaf(gs[u], x[u][k], accs[k]);
            if (same) {
              g[u][k] = fmaf(gd[u], ad[k], g[u][k]);
              accd[k] = fmaf(gd[u], x[u][k], accd[k]);
            }
          }
          store_vec<V>(p.gz + n * p.hd + col, g[u]);
        }
        if (same) continue;
#pragma unroll
        for (int u = 0; u < kNodeTiles; ++u) {
          const int64_t n = n0 + u * R;
          if (n < r1 && n < p.n_dst) {
            ldg_vals<V>(p.zd + n * p.hd + col, x[u]);
            gd[u] = __ldg(p.ga_d + n * p.heads + h);
          }
        }
#pragma unroll
        for (int u = 0; u < kNodeTiles; ++u) {
          const int64_t n = n0 + u * R;
          if (n >= r1 || n >= p.n_dst) continue;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            g[u][k] = gd[u] * ad[k];
            accd[k] = fmaf(gd[u], x[u][k], accd[k]);
          }
          store_vec<V>(p.gzd + n * p.hd + col, g[u]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][threadIdx.x * V + k] = accs[k];
      red[1][threadIdx.x * V + k] = accd[k];
    }
    __syncthreads();
    if (ri == 0 && live) {
      float s[V], t[V];
#pragma unroll
      for (int k = 0; k < V; ++k) s[k] = t[k] = 0.f;
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < V; ++k) {
          s[k] += red[0][(i * C + ci) * V + k];
          t[k] += red[1][(i * C + ci) * V + k];
        }
      store_vec<V>(part + col, s);
      store_vec<V>(part + p.hd + col, t);
    }
    __syncthreads();
  }
  // the last block to arrive adds every block's partials, in ascending block
  // order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // V columns a read: thread (rs, cs) adds blocks rs, rs + R2, ... of
  // column vector cs, then the R2 sums in ascending rs
  const int n_vecs = 2 * p.hd / V;
  int C2 = 1;
  while (C2 < n_vecs && C2 < kNodeThreads) C2 <<= 1;
  const int R2 = kNodeThreads / C2, cs = threadIdx.x % C2, rs = threadIdx.x / C2;
  for (int c0 = 0; c0 < n_vecs; c0 += C2) {
    const int c = c0 + cs;
    float acc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = 0.f;
    if (c < n_vecs) {
#pragma unroll 4
      for (int64_t b = rs; b < gridDim.x; b += R2) {
        float x[V];
        ldcg_vec<V>(p.part + b * 2 * p.hd + c * V, x);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] += x[k];
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) red[0][threadIdx.x * V + k] = acc[k];
    __syncthreads();
    if (rs == 0 && c < n_vecs) {
      float x[V];
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = 0.f;
      for (int i = 0; i < R2; ++i)
#pragma unroll
        for (int k = 0; k < V; ++k) x[k] += red[0][(i * C2 + cs) * V + k];
      store_vec<V>(p.g_att + c * V, x);
    }
    __syncthreads();
  }
}

// V: 4 where d is a multiple of 4 and every pointer starts on 16 bytes.
int node_vec(int d, std::initializer_list<const void*> ptrs) {
  if (d % 4 != 0) return 1;
  for (const void* q : ptrs)
    if (q != nullptr && reinterpret_cast<uint64_t>(q) % 16 != 0) return 1;
  return 4;
}

// The pair passes' lanes a pair and grid.
int pair_lanes(int d, int vec) {
  int s = 1;
  while (s < d / vec && s < kWarp) s <<= 1;
  return s;
}

dim3 pair_grid(int64_t pairs, int lanes) {
  const int64_t per_block = static_cast<int64_t>(kNodeWarps) * (kWarp / lanes);
  const int64_t blocks = (pairs + per_block - 1) / per_block;
  return dim3(static_cast<unsigned>(blocks < kNodeMaxBlocks ? blocks : kNodeMaxBlocks));
}

}  // namespace

// The node passes' C entry points (the float32 library only). Pointers are
// device pointers, every array contiguous; z_dst null: z is both sides.
// One launch a call (none for no pairs); returns cudaGetLastError(), or
// cudaErrorInvalidValue for what the kernels do not take.
extern "C" int gat_scores_f32(const void* z, const void* z_dst, const void* attn_src,
                              const void* attn_dst, void* a_src, void* a_dst, long long n_src,
                              long long n_dst, int heads, int d, void* stream) {
  const int64_t pairs = (n_src > n_dst ? n_src : n_dst) * static_cast<int64_t>(heads);
  if (z_dst == nullptr && n_dst > n_src) return static_cast<int>(cudaErrorInvalidValue);
  if (pairs <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  ScoreParams p{static_cast<const float*>(z), static_cast<const float*>(z_dst),
                static_cast<const float*>(attn_src), static_cast<const float*>(attn_dst),
                static_cast<float*>(a_src), static_cast<float*>(a_dst), n_src, n_dst, heads, d, 1};
  const int vec = node_vec(d, {z, z_dst, attn_src, attn_dst});
  p.lanes = pair_lanes(d, vec);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    gat_scores_kernel<4><<<pair_grid(pairs, p.lanes), kNodeThreads, 0, s>>>(p);
  } else {
    gat_scores_kernel<1><<<pair_grid(pairs, p.lanes), kNodeThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gat_score_grad_f32(const void* g, const void* out, const void* w1,
                                  const void* a_dst, const void* shift, const void* inv_s,
                                  const void* w1s, void* node, void* grad_a_dst, long long n,
                                  int heads, int d, void* stream) {
  const int64_t pairs = n * static_cast<int64_t>(heads);
  if (pairs <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  if (reinterpret_cast<uint64_t>(node) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  ScoreGradParams p{static_cast<const float*>(g),     static_cast<const float*>(out),
                    static_cast<const float*>(w1),    static_cast<const float*>(a_dst),
                    static_cast<const float*>(shift), static_cast<const float*>(inv_s),
                    static_cast<const float*>(w1s),   static_cast<float4*>(node),
                    static_cast<float*>(grad_a_dst),  n, heads, d, 1};
  const int vec = node_vec(d, {g, out, w1});
  p.lanes = pair_lanes(d, vec);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    gat_score_grad_kernel<4><<<pair_grid(pairs, p.lanes), kNodeThreads, 0, s>>>(p);
  } else {
    gat_score_grad_kernel<1><<<pair_grid(pairs, p.lanes), kNodeThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// max_blocks: the partials' rows ((max_blocks, 2, H·D) floats); ticket: one
// int32 of this call's own, zeroed here on the stream; grad_attn (2, H·D).
extern "C" int gat_vector_grad_f32(const void* z, const void* z_dst, const void* attn_src,
                                   const void* attn_dst, const void* grad_a_src,
                                   const void* grad_a_dst, const void* grad_v, void* grad_z,
                                   void* grad_z_dst, void* partials, long long max_blocks,
                                   void* ticket, void* grad_attn, long long n_src,
                                   long long n_dst, int heads, int d, void* stream) {
  const int64_t n_rows = n_src > n_dst ? n_src : n_dst;
  const int hd = heads * d;
  if (n_rows <= 0 || hd <= 0 || max_blocks <= 0 || (z_dst == nullptr && n_src != n_dst))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = node_vec(d, {z, z_dst, attn_src, attn_dst, grad_v, grad_z, grad_z_dst});
  int cols = 1;
  while (cols < hd / vec && cols < kNodeThreads) cols <<= 1;
  const int64_t rows_at_once = kNodeThreads / cols;
  int64_t blocks = (n_rows + rows_at_once - 1) / rows_at_once;
  if (blocks > max_blocks) blocks = max_blocks;
  VectorGradParams p{static_cast<const float*>(z),        static_cast<const float*>(z_dst),
                     static_cast<const float*>(attn_src), static_cast<const float*>(attn_dst),
                     static_cast<const float*>(grad_a_src),
                     static_cast<const float*>(grad_a_dst),
                     static_cast<const float*>(grad_v),   static_cast<float*>(grad_z),
                     static_cast<float*>(grad_z_dst),     static_cast<float*>(partials),
                     static_cast<int*>(ticket),           static_cast<float*>(grad_attn),
                     n_src, n_dst, (n_rows + blocks - 1) / blocks, heads, d, hd, cols};
  auto s = static_cast<cudaStream_t>(stream);
  if (const cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(int), s); e != cudaSuccess)
    return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec == 4) {
    gat_vector_grad_kernel<4><<<grid, kNodeThreads, 0, s>>>(p);
  } else {
    gat_vector_grad_kernel<1><<<grid, kNodeThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
#endif  // K3_BF16
