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
//   gat_fwd, one warp per (dst row d, head h), one sweep of the row: the
//     warp keeps a running maximum m of a_src over the edges it has read and
//     sums num = Σ m·p·v, s = Σ p, w1u = Σ m·p·slope·v and w1su = Σ p·slope
//     relative to the shift leaky_relu(m + a_dst[d]); a round of edges that
//     raises m first rescales the sums so far by exp(old − new shift) ≤ 1.
//     At the end m is the exact row maximum, so
//       shift[d] = leaky_relu(max_{s→d} a_src[s] + a_dst[d])
//     (the JAX kernel shifts by the loose bound leaky_relu(max_all a_src +
//     a_dst[d]) and has no rescue when a row's every p underflows; softmax
//     does not change under the shift, and the exact one never underflows).
//     It writes out = num / s, w1 = w1u / s, w1s = w1su / s, inv_s = 1 / s
//     and shift (all 0 on an empty row). With every logit of a row equal,
//     every p is exp(0) = 1 and every rescale is skipped.
//   gat_b2, one warp per (src row s, head h) of the reverse CSR, whose
//     slot j holds the original dst d and the forward-canonical id eid[j]:
//     recomputes p with the forward's shift, α = p·inv_s[d], and
//     accumulates grad_v = Σ m·α·g[d], w2 = Σ m·α·slope·g[d] and
//     w3 = Σ α·slope·C[d], with C = Σ_D g·out. The per-dst operands
//     (a_dst, shift, inv_s, C) come packed as one float4 per (d, h).
//   The gradients of a_src and a_dst are N-wide closed forms of these sums
//   (kernels/gat_attention.py), as in _lane_gat_bwd.
//
// bfloat16 values (gat_fwd_bf16, gat_b2_bf16: the JAX package's lane_gat_agg
// with compute_dtype = bfloat16, lane_attention.py:503): the forward reads
// v's rows as bfloat16, converted exactly to float as they are loaded; the
// logits, the row shift, the softmax, the dropout and every sum stay float,
// and the forward writes float. b2 reads the float cotangent g (not rounded
// to bfloat16, as the lane kernel rounds it) and sums grad_v in float, then
// rounds each grad_v value once to bfloat16, v's type (lane_attention.py:
// 477): the rows directly, the long rows in the combine; w2 and w3 stay
// float, and grad_a_src = Σ_D v·w2 − w3 reads v in the wrapper.
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
// What bounds it on this card: bytes. Per (d, h) and edge the forward reads
// src[j], a_src[s] and v[s] (D floats), b2 dst[j] (and eid[j] with
// dropout), the node float4 of d and g[d]; at the main path's shape (reddit
// with self-loops, H = 1, D = 16) the gathered rows stay in L2, so the cost
// is the latency of two dependent loads per round of edges, as in K1, and
// the number of rounds one warp walks. The bytes bound counts the CSR, the
// node arrays once and the outputs once.
//
// What the design does about it:
//   * the lane layout of lanes.cuh, as in K1: lane groups of L lanes take
//     one edge each, loads of at most 4 values along D (16-, 8- or 4-byte
//     float loads, 8-, 4- or 2-byte bfloat16 ones), one feature tile (two
//     for rows of more than 32 vectors), warp-shuffle combine in a fixed
//     order, no atomics, so two runs are bitwise equal; heads are the grid's
//     y dimension;
//   * each edge's scalars once: a round is at most one edge a lane (G groups
//     take U = min(L, kUnroll) edges each), lane i loads the index of the
//     round's edge i, computes its logit, p, slope and dropout factor and
//     shuffles them to the group that gathers the edge's row, which it has
//     already requested, so the L lanes of a group do not each repeat them
//     (one lane of the group computing them would save no instruction);
//   * one sweep of the forward's row (above): src and a_src are read once,
//     with v, not first for the maximum alone;
//   * long rows are split in both passes (lanes.cuh, "The row split"): a row
//     of more than T edges (graph/split.py: SPLIT_T = 512) is cut into
//     chunks of at most T edges, each one warp's work in the first blocks
//     of the same launch, and a row warp whose row is long leaves at once.
//     A b2 chunk writes its sums to partials, and lanes.cuh's combine adds
//     each long row's partials in ascending chunk order, one launch for each
//     of grad_v, w2 and w3 (linear sums, no shift). A forward chunk writes
//     its own shift sh_k (over its edges only) and its unnormalised sums;
//     gat_fwd_combine takes sh = max_k sh_k, the row's shift, scales chunk
//     k by f_k = exp(sh_k − sh) ≤ 1, adds the chunks in ascending order and
//     writes the row once. Without the split one warp walked reddit's
//     212,080-edge reverse row alone in b2.

#include <math.h>

#include <algorithm>

#include "lanes.cuh"

namespace {

using namespace warp_csr;

constexpr unsigned kAll = 0xffffffffu;

struct Drop {
  const int32_t* seed;  // device pointer to one int32, or null without dropout
  uint32_t thresh;      // int(keep · 2^24)
  float scale;          // float32(1 / keep)
};

// The row split of the CSR a pass walks (graph/split.py).
struct Split {
  int64_t long_t;            // rows of more than long_t edges are split
  const int64_t* rows;       // (n_long,) the long rows
  const int64_t* chunk_ptr;  // (n_long + 1,) each long row's first chunk
  int64_t n_long;
  const int64_t* chunks;     // (n_chunks, 2) each chunk's [begin, end)
  int64_t n_chunks;
  int64_t n_chunk_blocks;    // chunk_blocks(n_chunks): the launch's first blocks
};

// The dropout key of forward-canonical edge e under head h. Built with
// -DK3_DROP_KEY_PER_EDGE it is e for every head, the key before the per-head
// mask, which chip_smoke.py builds only to time the two keys side by side.
__device__ __forceinline__ uint32_t drop_key(int64_t e, int heads, int h) {
#ifdef K3_DROP_KEY_PER_EDGE
  return static_cast<uint32_t>(e);
#else
  return static_cast<uint32_t>(e) * static_cast<uint32_t>(heads) + static_cast<uint32_t>(h);
#endif
}

__device__ __forceinline__ float keep_scale(uint32_t key, int32_t seed, const Drop& drop) {
  uint32_t x = key ^ static_cast<uint32_t>(seed);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & 0xFFFFFFu) < drop.thresh ? drop.scale : 0.f;
}

__device__ __forceinline__ float leaky(float x, float ns) { return x > 0.f ? x : ns * x; }

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 1; off < kWarp; off <<= 1) x = fmaxf(x, __shfl_xor_sync(kAll, x, off));
  return x;
}

template <int V>
__device__ __forceinline__ void store_scaled(float* __restrict__ p, const float (&v)[V], float s) {
  // v / s, or 0 where s == 0 (an empty row)
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = s > 0.f ? v[k] / s : 0.f;
  store_vec<V>(p, o);
}

template <int TILE, int V>
__device__ __forceinline__ void fill(float (&a)[TILE][V], float x) {
#pragma unroll
  for (int t = 0; t < TILE; ++t)
#pragma unroll
    for (int k = 0; k < V; ++k) a[t][k] = x;
}

template <int TILE, int V>
__device__ __forceinline__ void scale(float (&a)[TILE][V], float f) {
#pragma unroll
  for (int t = 0; t < TILE; ++t)
#pragma unroll
    for (int k = 0; k < V; ++k) a[t][k] *= f;
}

// The lane's vectors of head h of row r of an (N, heads, d) array (T: float
// or bfloat16) in feature tile c0, as floats; zeros past the row's end or
// for r < 0 (no edge).
template <int TILE, int V, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ base, int32_t r, int heads,
                                         int h, int d, int c0, int col, int lanes, int nvec,
                                         float (&x)[TILE][V]) {
  const T* row = base + (static_cast<int64_t>(r) * heads + h) * d;
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    const int c = c0 + col + t * lanes;
    if (r >= 0 && c < nvec) {
      load_vec<V>(row + static_cast<int64_t>(c) * V, x[t]);
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) x[t][k] = 0.f;
    }
  }
}

template <int TILE, int V>
__device__ __forceinline__ void fma_row(float (&acc)[TILE][V], float w, const float (&x)[TILE][V]) {
#pragma unroll
  for (int t = 0; t < TILE; ++t)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[t][k] = fmaf(w, x[t][k], acc[t][k]);
}

// The forward over edges [start, end) of one (row, head), a_dst = ad.
// `chunk`: writes the unnormalised num, w1u, s, w1su and the chunk's own
// shift to orow, wrow, s_out, ss_out, sh_out; else the row's out, w1, inv_s,
// w1s and shift. v's rows are VT (float or bfloat16).
template <int V, int TILE, typename VT>
__device__ __forceinline__ void fwd_range(const int32_t* __restrict__ src,
                                          const VT* __restrict__ v,
                                          const float* __restrict__ a_src, int64_t start,
                                          int64_t end, int heads, int h, int d, int lanes,
                                          float ad, float ns, const Drop& drop, int32_t seed,
                                          bool chunk, float* __restrict__ orow,
                                          float* __restrict__ wrow, float* __restrict__ s_out,
                                          float* __restrict__ ss_out, float* __restrict__ sh_out) {
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int unroll = lanes < kUnroll ? lanes : kUnroll;  // edges a group takes a round
  const int per_round = groups * unroll;                 // at most kWarp
  const int nvec = d / V;
  for (int c0 = 0; c0 < nvec; c0 += lanes * TILE) {
    float num[TILE][V], w1u[TILE][V];
    fill(num, 0.f);
    fill(w1u, 0.f);
    float ps = 0.f, pss = 0.f;      // Σ p and Σ p·slope of this lane's edges
    float m = -INFINITY, sh = 0.f;  // the running maximum of a_src and its shift
    for (int64_t j0 = start; j0 < end; j0 += per_round) {
      // lane i takes the round's edge j0 + i: its source and a_src
      const int64_t j = j0 + lane;
      const bool mine = lane < per_round && j < end;
      const int32_t s = mine ? __ldg(src + j) : -1;
      const float a = mine ? __ldg(a_src + static_cast<int64_t>(s) * heads + h) : -INFINITY;
      // the group's edges are the round's slot·U + u: request their v rows
      int32_t su[kUnroll];
      float x[kUnroll][TILE][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int32_t from = __shfl_sync(kAll, s, (slot * unroll + u) % kWarp);
        su[u] = u < unroll ? from : -1;
        load_row(v, su[u], heads, h, d, c0, col, lanes, nvec, x[u]);
      }
      const float rm = warp_max(a);
      if (rm > m) {  // uniform across the warp: raise the shift, rescale the sums so far
        if (m > -INFINITY) {
          const float f = expf(sh - leaky(rm + ad, ns));
          scale(num, f);
          scale(w1u, f);
          ps *= f;
          pss *= f;
        }
        m = rm;
        sh = leaky(m + ad, ns);
      }
      float pm = 0.f, pms = 0.f;
      if (mine) {
        const float z = a + ad;
        const float slope = z > 0.f ? 1.f : ns;
        const float p = expf(leaky(z, ns) - sh);
        const float keep =
            drop.seed != nullptr ? keep_scale(drop_key(j, heads, h), seed, drop) : 1.f;
        pm = p * keep;
        pms = pm * slope;
        ps += p;
        pss += p * slope;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int from = (slot * unroll + u) % kWarp;
        const float wu = __shfl_sync(kAll, pm, from);
        const float wsu = __shfl_sync(kAll, pms, from);
        if (su[u] < 0) continue;
        fma_row(num, wu, x[u]);
        fma_row(w1u, wsu, x[u]);
      }
    }

    group_sum<TILE, V>(num, lanes);
    group_sum<TILE, V>(w1u, lanes);
    ps = group_sum(ps, 1);  // each lane summed its own edges: combine all lanes
    pss = group_sum(pss, 1);
    if (slot == 0) {
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const int c = c0 + col + t * lanes;
        if (c >= nvec) continue;
        const int64_t off = static_cast<int64_t>(c) * V;
        if (chunk) {
          store_vec<V>(orow + off, num[t]);
          store_vec<V>(wrow + off, w1u[t]);
        } else {
          store_scaled<V>(orow + off, num[t], ps);
          store_scaled<V>(wrow + off, w1u[t], ps);
        }
      }
    }
    if (c0 == 0 && lane == 0) {
      *s_out = chunk ? ps : (ps > 0.f ? 1.f / ps : 0.f);
      *ss_out = chunk ? pss : (ps > 0.f ? pss / ps : 0.f);
      *sh_out = sh;
    }
  }
}

// b2 over edges [start, end) of one (src row, head) of the reverse CSR,
// a_src = as; writes grad_v, w2 and w3 sums to grow (GT: float, or grad_v's
// bfloat16, rounded once), wrow and w3_out.
template <int V, int TILE, typename GT>
__device__ __forceinline__ void b2_range(const int32_t* __restrict__ dst,
                                         const int32_t* __restrict__ eid,
                                         const float* __restrict__ g,
                                         const float4* __restrict__ node, int64_t start,
                                         int64_t end, int heads, int h, int d, int lanes,
                                         float as, float ns, const Drop& drop, int32_t seed,
                                         GT* __restrict__ grow, float* __restrict__ wrow,
                                         float* __restrict__ w3_out) {
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int unroll = lanes < kUnroll ? lanes : kUnroll;
  const int per_round = groups * unroll;
  const int nvec = d / V;
  for (int c0 = 0; c0 < nvec; c0 += lanes * TILE) {
    float gv[TILE][V], w2a[TILE][V];
    fill(gv, 0.f);
    fill(w2a, 0.f);
    float w3a = 0.f;  // this lane's edges

    for (int64_t j0 = start; j0 < end; j0 += per_round) {
      const int64_t j = j0 + lane;
      const bool mine = lane < per_round && j < end;
      const int32_t dd = mine ? __ldg(dst + j) : -1;
      const int32_t e = mine && drop.seed != nullptr ? __ldg(eid + j) : 0;
      int32_t du[kUnroll];
      float x[kUnroll][TILE][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int32_t from = __shfl_sync(kAll, dd, (slot * unroll + u) % kWarp);
        du[u] = u < unroll ? from : -1;
        load_row(g, du[u], heads, h, d, c0, col, lanes, nvec, x[u]);
      }
      float wv = 0.f, w2e = 0.f;
      if (mine) {
        const float4 q = __ldg(node + static_cast<int64_t>(dd) * heads + h);  // a_dst, shift, inv_s, C
        const float z = as + q.x;
        const float slope = z > 0.f ? 1.f : ns;
        const float alpha = expf(leaky(z, ns) - q.y) * q.z;
        const float keep =
            drop.seed != nullptr ? keep_scale(drop_key(e, heads, h), seed, drop) : 1.f;
        wv = alpha * keep;
        w2e = wv * slope;
        w3a += alpha * slope * q.w;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int from = (slot * unroll + u) % kWarp;
        const float wu = __shfl_sync(kAll, wv, from);
        const float w2u = __shfl_sync(kAll, w2e, from);
        if (du[u] < 0) continue;
        fma_row(gv, wu, x[u]);
        fma_row(w2a, w2u, x[u]);
      }
    }

    group_sum<TILE, V>(gv, lanes);
    group_sum<TILE, V>(w2a, lanes);
    w3a = group_sum(w3a, 1);
    if (slot == 0) {
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const int c = c0 + col + t * lanes;
        if (c >= nvec) continue;
        store_vec<V>(grow + static_cast<int64_t>(c) * V, gv[t]);
        store_vec<V>(wrow + static_cast<int64_t>(c) * V, w2a[t]);
      }
    }
    if (c0 == 0 && lane == 0) *w3_out = w3a;
  }
}

// The first n_chunk_blocks blocks take the dst CSR's chunks, into pnum,
// pw1u (C, H, D) and pscal (3, C, H: sh_k, s_k, w1su_k); the others one row
// per warp, and write the rows of at most long_t edges.
template <int V, int TILE, typename IdxT, typename VT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gat_fwd_kernel(const IdxT* __restrict__ indptr, const int32_t* __restrict__ src,
               const VT* __restrict__ v, const float* __restrict__ a_src,
               const float* __restrict__ a_dst, float* __restrict__ out,
               float* __restrict__ w1, float* __restrict__ inv_s, float* __restrict__ w1s,
               float* __restrict__ shift, int64_t n_rows, int heads, int d, int lanes,
               float ns, Drop drop, Split sp, float* __restrict__ pnum,
               float* __restrict__ pw1u, float* __restrict__ pscal) {
  const int h = blockIdx.y;
  const int32_t seed = drop.seed != nullptr ? __ldg(drop.seed) : 0;
  int64_t item;
  if (warp_item(sp.n_chunk_blocks, item)) {
    if (item >= sp.n_chunks) return;  // uniform across the warp
    const int64_t row = sp.rows[chunk_owner(sp.chunk_ptr, sp.n_long, item)];
    const int64_t kh = item * heads + h, ch = sp.n_chunks * heads;
    fwd_range<V, TILE>(src, v, a_src, sp.chunks[2 * item], sp.chunks[2 * item + 1], heads, h, d,
                       lanes, __ldg(a_dst + row * heads + h), ns, drop, seed, true,
                       pnum + kh * d, pw1u + kh * d, pscal + ch + kh, pscal + 2 * ch + kh,
                       pscal + kh);
    return;
  }
  const int64_t row = item;
  if (row >= n_rows) return;  // uniform across the warp
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  if (end - start > sp.long_t) return;  // a long row: its chunks and the combine write it
  const int64_t rh = row * heads + h;
  fwd_range<V, TILE>(src, v, a_src, start, end, heads, h, d, lanes, __ldg(a_dst + rh), ns, drop,
                     seed, false, out + rh * d, w1 + rh * d, inv_s + rh, w1s + rh, shift + rh);
}

// One warp per (long row, head) of the dst CSR: sh = max_k sh_k, then the
// chunks' sums scaled by f_k = exp(sh_k − sh) and added in ascending chunk
// order; writes out, w1, inv_s, w1s and shift once. Every chunk holds its
// maximum edge, whose p is 1, so s >= 1.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gat_fwd_combine_kernel(const float* __restrict__ pnum, const float* __restrict__ pw1u,
                       const float* __restrict__ pscal, const int64_t* __restrict__ rows,
                       const int64_t* __restrict__ chunk_ptr, int64_t n_long, int64_t n_chunks,
                       int heads, int d, float* __restrict__ out, float* __restrict__ w1,
                       float* __restrict__ inv_s, float* __restrict__ w1s,
                       float* __restrict__ shift) {
  const int64_t i = warp_row();
  if (i >= n_long) return;  // uniform across the warp
  const int h = blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const int64_t k0 = chunk_ptr[i], k1 = chunk_ptr[i + 1], ch = n_chunks * heads;
  const float* psh = pscal;
  const float* ps = pscal + ch;
  const float* pss = pscal + 2 * ch;
  float sh = -INFINITY;
  for (int64_t k = k0 + lane; k < k1; k += kWarp) sh = fmaxf(sh, psh[k * heads + h]);
  sh = warp_max(sh);
  float s = 0.f, ss = 0.f;
  for (int64_t k = k0; k < k1; ++k) {
    const int64_t kh = k * heads + h;
    const float f = expf(psh[kh] - sh);
    s = fmaf(f, ps[kh], s);
    ss = fmaf(f, pss[kh], ss);
  }
  const int64_t rh = rows[i] * heads + h;
  for (int c = lane; c < d; c += kWarp) {
    float num = 0.f, wu = 0.f;
    for (int64_t k = k0; k < k1; ++k) {
      const int64_t kh = k * heads + h;
      const float f = expf(psh[kh] - sh);
      num = fmaf(f, pnum[kh * d + c], num);
      wu = fmaf(f, pw1u[kh * d + c], wu);
    }
    out[rh * d + c] = num / s;
    w1[rh * d + c] = wu / s;
  }
  if (lane == 0) {
    inv_s[rh] = 1.f / s;
    w1s[rh] = ss / s;
    shift[rh] = sh;
  }
}

// The first n_chunk_blocks blocks take the reverse CSR's chunks, into pgv,
// pw2 (C, H, D) and pw3 (C, H); the others one row per warp, and write the
// rows of at most long_t edges.
template <int V, int TILE, typename IdxT, typename GVT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gat_b2_kernel(const IdxT* __restrict__ indptr, const int32_t* __restrict__ dst,
              const int32_t* __restrict__ eid, const float* __restrict__ g,
              const float4* __restrict__ node, const float* __restrict__ a_src,
              GVT* __restrict__ grad_v, float* __restrict__ w2, float* __restrict__ w3,
              int64_t n_rows, int heads, int d, int lanes, float ns, Drop drop, Split sp,
              float* __restrict__ pgv, float* __restrict__ pw2, float* __restrict__ pw3) {
  const int h = blockIdx.y;
  const int32_t seed = drop.seed != nullptr ? __ldg(drop.seed) : 0;
  int64_t item;
  if (warp_item(sp.n_chunk_blocks, item)) {
    if (item >= sp.n_chunks) return;  // uniform across the warp
    const int64_t row = sp.rows[chunk_owner(sp.chunk_ptr, sp.n_long, item)];
    const int64_t kh = item * heads + h;
    b2_range<V, TILE>(dst, eid, g, node, sp.chunks[2 * item], sp.chunks[2 * item + 1], heads, h,
                      d, lanes, __ldg(a_src + row * heads + h), ns, drop, seed, pgv + kh * d,
                      pw2 + kh * d, pw3 + kh);
    return;
  }
  const int64_t row = item;
  if (row >= n_rows) return;  // uniform across the warp
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  if (end - start > sp.long_t) return;  // a long row: its chunks and the combine write it
  const int64_t rh = row * heads + h;
  b2_range<V, TILE>(dst, eid, g, node, start, end, heads, h, d, lanes, __ldg(a_src + rh), ns, drop,
                    seed, grad_v + rh * d, w2 + rh * d, w3 + rh);
}

// One feature tile when a row's vectors fit the lane group, else two.
inline int tile_for(int d, int vw, int lanes) { return d / vw <= lanes ? 1 : 2; }

template <typename IdxT, typename VT>
void fwd(const IdxT* indptr, const int32_t* src, const VT* v, const float* a_src,
         const float* a_dst, float* out, float* w1, float* inv_s, float* w1s, float* shift,
         int64_t n_rows, int heads, int d, float ns, Drop drop, Split sp, float* pnum,
         float* pw1u, float* pscal, cudaStream_t stream) {
  // At most 4 values a lane, for bfloat16 rows too: a round gives each
  // group min(L, kUnroll) edges, so 16-byte bfloat16 loads (L = 2 at D = 16)
  // would halve the edges a lane keeps in flight, and that variant took 111
  // registers; it ran 2.2-2.5x float's time on the card (PERF.md, PR 15). At
  // V = 4 a bfloat16 row keeps float's lane layout with 8-byte loads.
  const int vw = std::min(4, vec_width(d, {{v, static_cast<int>(sizeof(VT))}, {out, 4}, {w1, 4},
                                           {pnum, 4}, {pw1u, 4}}));
  const int lanes = lanes_for(d, vw);
  const int tile = tile_for(d, vw, lanes);
  auto kernel = tile == 1 ? gat_fwd_kernel<1, 1, IdxT, VT> : gat_fwd_kernel<1, 2, IdxT, VT>;
  if (vw == 4) {
    kernel = tile == 1 ? gat_fwd_kernel<4, 1, IdxT, VT> : gat_fwd_kernel<4, 2, IdxT, VT>;
  } else if (vw == 2) {
    kernel = tile == 1 ? gat_fwd_kernel<2, 1, IdxT, VT> : gat_fwd_kernel<2, 2, IdxT, VT>;
  }
  const dim3 grid(static_cast<unsigned>(sp.n_chunk_blocks + grid_for(n_rows).x),
                  static_cast<unsigned>(heads));
  kernel<<<grid, block_dim(), 0, stream>>>(indptr, src, v, a_src, a_dst, out, w1, inv_s, w1s,
                                           shift, n_rows, heads, d, lanes, ns, drop, sp, pnum,
                                           pw1u, pscal);
  if (sp.n_long > 0) {
    gat_fwd_combine_kernel<<<grid_for(sp.n_long, heads), block_dim(), 0, stream>>>(
        pnum, pw1u, pscal, sp.rows, sp.chunk_ptr, sp.n_long, sp.n_chunks, heads, d, out, w1,
        inv_s, w1s, shift);
  }
}

template <typename IdxT, typename GVT>
void b2(const IdxT* indptr, const int32_t* dst, const int32_t* eid, const float* g,
        const float4* node, const float* a_src, GVT* grad_v, float* w2, float* w3,
        int64_t n_rows, int heads, int d, float ns, Drop drop, Split sp, float* pgv, float* pw2,
        float* pw3, cudaStream_t stream) {
  const int vw = vec_width(d, {{g, 4}, {grad_v, static_cast<int>(sizeof(GVT))}, {w2, 4},
                               {pgv, 4}, {pw2, 4}});
  const int lanes = lanes_for(d, vw);
  const int tile = tile_for(d, vw, lanes);
  // g is float: vw is at most 4
  auto kernel = tile == 1 ? gat_b2_kernel<1, 1, IdxT, GVT> : gat_b2_kernel<1, 2, IdxT, GVT>;
  if (vw == 4) {
    kernel = tile == 1 ? gat_b2_kernel<4, 1, IdxT, GVT> : gat_b2_kernel<4, 2, IdxT, GVT>;
  } else if (vw == 2) {
    kernel = tile == 1 ? gat_b2_kernel<2, 1, IdxT, GVT> : gat_b2_kernel<2, 2, IdxT, GVT>;
  }
  const dim3 grid(static_cast<unsigned>(sp.n_chunk_blocks + grid_for(n_rows).x),
                  static_cast<unsigned>(heads));
  kernel<<<grid, block_dim(), 0, stream>>>(indptr, dst, eid, g, node, a_src, grad_v, w2, w3,
                                           n_rows, heads, d, lanes, ns, drop, sp, pgv, pw2, pw3);
  // grad_v and w2 are (N, H·D) rows and w3 (N, H): one combine launch each
  const int hd = heads * d;
  combine_chunks(pgv, sp.rows, sp.chunk_ptr, sp.chunks, grad_v, sp.n_long, hd, 0, stream);
  combine_chunks(pw2, sp.rows, sp.chunk_ptr, sp.chunks, w2, sp.n_long, hd, 0, stream);
  combine_chunks(pw3, sp.rows, sp.chunk_ptr, sp.chunks, w3, sp.n_long, heads, 0, stream);
}

Split split_of(long long long_t, const void* rows, const void* chunk_ptr, long long n_long,
               const void* chunks, long long n_chunks) {
  return Split{long_t, static_cast<const int64_t*>(rows), static_cast<const int64_t*>(chunk_ptr),
               n_long, static_cast<const int64_t*>(chunks), n_chunks, chunk_blocks(n_chunks)};
}

template <typename VT>
int run_fwd(const void* indptr, int indptr_is_int64, const void* src, const void* v,
            const void* a_src, const void* a_dst, void* out, void* w1, void* inv_s, void* w1s,
            void* shift, long long n_rows, int heads, int d, float ns, const void* seed,
            unsigned thresh, float scale, long long long_t, const void* rows,
            const void* chunk_ptr, long long n_long, const void* chunks, long long n_chunks,
            void* pnum, void* pw1u, void* pscal, void* stream) {
  if (n_rows <= 0 || heads <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const Drop drop{static_cast<const int32_t*>(seed), thresh, scale};
  const Split sp = split_of(long_t, rows, chunk_ptr, n_long, chunks, n_chunks);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* srcp = static_cast<const int32_t*>(src);
  const auto* vp = static_cast<const VT*>(v);
  const auto* asp = static_cast<const float*>(a_src);
  const auto* adp = static_cast<const float*>(a_dst);
  auto* op = static_cast<float*>(out);
  auto* w1p = static_cast<float*>(w1);
  auto* isp = static_cast<float*>(inv_s);
  auto* w1sp = static_cast<float*>(w1s);
  auto* shp = static_cast<float*>(shift);
  auto* pn = static_cast<float*>(pnum);
  auto* pw = static_cast<float*>(pw1u);
  auto* pc = static_cast<float*>(pscal);
  if (indptr_is_int64) {
    fwd(static_cast<const int64_t*>(indptr), srcp, vp, asp, adp, op, w1p, isp, w1sp, shp, n_rows,
        heads, d, ns, drop, sp, pn, pw, pc, s);
  } else {
    fwd(static_cast<const int32_t*>(indptr), srcp, vp, asp, adp, op, w1p, isp, w1sp, shp, n_rows,
        heads, d, ns, drop, sp, pn, pw, pc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename GVT>
int run_b2(const void* indptr, int indptr_is_int64, const void* dst, const void* eid,
           const void* g, const void* node, const void* a_src, void* grad_v, void* w2, void* w3,
           long long n_rows, int heads, int d, float ns, const void* seed, unsigned thresh,
           float scale, long long long_t, const void* rows, const void* chunk_ptr,
           long long n_long, const void* chunks, long long n_chunks, void* pgv, void* pw2,
           void* pw3, void* stream) {
  if (n_rows <= 0 || heads <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const Drop drop{static_cast<const int32_t*>(seed), thresh, scale};
  const Split sp = split_of(long_t, rows, chunk_ptr, n_long, chunks, n_chunks);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dp = static_cast<const int32_t*>(dst);
  const auto* ep = static_cast<const int32_t*>(eid);
  const auto* gp = static_cast<const float*>(g);
  const auto* np_ = static_cast<const float4*>(node);
  const auto* asp = static_cast<const float*>(a_src);
  auto* gvp = static_cast<GVT*>(grad_v);
  auto* w2p = static_cast<float*>(w2);
  auto* w3p = static_cast<float*>(w3);
  auto* pg = static_cast<float*>(pgv);
  auto* p2 = static_cast<float*>(pw2);
  auto* p3 = static_cast<float*>(pw3);
  if (indptr_is_int64) {
    b2(static_cast<const int64_t*>(indptr), dp, ep, gp, np_, asp, gvp, w2p, w3p, n_rows, heads, d,
       ns, drop, sp, pg, p2, p3, s);
  } else {
    b2(static_cast<const int32_t*>(indptr), dp, ep, gp, np_, asp, gvp, w2p, w3p, n_rows, heads, d,
       ns, drop, sp, pg, p2, p3, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// `seed` is null when there is no dropout. The row split as for
// csr_spmm_f32 (long_t, rows, chunk_ptr, n_long, chunks, n_chunks), with the
// partials of its chunks: the forward's pnum and pw1u (n_chunks, heads, d)
// and pscal (3, n_chunks, heads); b2's pgv and pw2 (n_chunks, heads, d) and
// pw3 (n_chunks, heads); all null when n_chunks is 0, as nothing reads
// them then. Each launches its pass, then its combine launches
// when n_long > 0 (the forward one, b2 three), and returns
// cudaGetLastError(). gat_fwd_bf16 reads v as bfloat16, gat_b2_bf16 writes
// grad_v as bfloat16; every other operand is float in all four.
#define GAT_FWD_ENTRY(NAME, VT)                                                                \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* src, const void* v, \
                      const void* a_src, const void* a_dst, void* out, void* w1, void* inv_s,  \
                      void* w1s, void* shift, long long n_rows, int heads, int d, float ns,    \
                      const void* seed, unsigned thresh, float scale, long long long_t,        \
                      const void* rows, const void* chunk_ptr, long long n_long,               \
                      const void* chunks, long long n_chunks, void* pnum, void* pw1u,          \
                      void* pscal, void* stream) {                                             \
    return run_fwd<VT>(indptr, indptr_is_int64, src, v, a_src, a_dst, out, w1, inv_s, w1s,     \
                       shift, n_rows, heads, d, ns, seed, thresh, scale, long_t, rows,         \
                       chunk_ptr, n_long, chunks, n_chunks, pnum, pw1u, pscal, stream);        \
  }

#define GAT_B2_ENTRY(NAME, GVT)                                                                \
  extern "C" int NAME(const void* indptr, int indptr_is_int64, const void* dst,                \
                      const void* eid, const void* g, const void* node, const void* a_src,     \
                      void* grad_v, void* w2, void* w3, long long n_rows, int heads, int d,    \
                      float ns, const void* seed, unsigned thresh, float scale,                \
                      long long long_t, const void* rows, const void* chunk_ptr,               \
                      long long n_long, const void* chunks, long long n_chunks, void* pgv,     \
                      void* pw2, void* pw3, void* stream) {                                    \
    return run_b2<GVT>(indptr, indptr_is_int64, dst, eid, g, node, a_src, grad_v, w2, w3,      \
                       n_rows, heads, d, ns, seed, thresh, scale, long_t, rows, chunk_ptr,     \
                       n_long, chunks, n_chunks, pgv, pw2, pw3, stream);                       \
  }

GAT_FWD_ENTRY(gat_fwd_f32, float)
GAT_FWD_ENTRY(gat_fwd_bf16, __nv_bfloat16)
GAT_B2_ENTRY(gat_b2_f32, float)
GAT_B2_ENTRY(gat_b2_bf16, __nv_bfloat16)
