// K3 for Hopper (sm_90a): fused GAT attention, forward and backward, with no
// per-edge tensor in device memory.
//
//   out[d] = Σ_{j: s→d} m_j · α_j · v[s],   α_j = p_j / Σ_{j'→d} p_j',
//   p_j = exp(z_j − shift[d]),  z_j = leaky_relu(a_src[s] + a_dst[d]),
//   m_j = the dropout hash of the forward-canonical edge id j (1 without
//   dropout), for every head h independently.
//
// Replaces: dgl_tpu/kernels/lane_attention.py:_attn_pass, passes "fwd" and
// "b2" (body _make_kernel, dropout _hash_keep, custom VJP _lane_gat_fwd /
// _lane_gat_bwd, entry lane_gat_agg). The TPU kernel walks 128-edge runs of
// a lane plan, gathers from a VMEM-resident feature-major slab and
// accumulates with one-hot MXU matmuls. Here each pass walks a CSR as it is:
// the forward the dst-sorted CSR, the backward (b2) the reverse CSR.
//
//   gat_fwd, one warp per (dst row d, head h):
//     sweep 1 reads a_src over the row and takes its exact maximum, so
//       shift[d] = leaky_relu(max_{s→d} a_src[s] + a_dst[d])
//     (the JAX kernel shifts by the loose bound leaky_relu(max_all a_src +
//     a_dst[d]) and has no rescue when a row's every p underflows; softmax
//     does not change under the shift, and the exact one never underflows);
//     sweep 2 accumulates num = Σ m·p·v, s = Σ p, w1u = Σ m·p·slope·v and
//     w1su = Σ p·slope, and writes out = num / s, w1 = w1u / s,
//     w1s = w1su / s, inv_s = 1 / s and shift (all 0 on an empty row).
//   gat_b2, one warp per (src row s, head h) of the reverse CSR, whose
//     slot j holds the original dst d and the forward-canonical id eid[j]:
//     recomputes p with the forward's shift, α = p·inv_s[d], and
//     accumulates grad_v = Σ m·α·g[d], w2 = Σ m·α·slope·g[d] and
//     w3 = Σ α·slope·C[d], with C = Σ_D g·out. The per-dst operands
//     (a_dst, shift, inv_s, C) come packed as one float4 per (d, h).
//   The gradients of a_src and a_dst are N-wide closed forms of these sums
//   (kernels/gat_attention.py), as in _lane_gat_bwd.
//
// Dropout: murmur3 fmix32 of (eid ^ seed) as uint32, kept where its low 24
// bits are below int(keep·2^24), scaled by float32(1/keep); bit for bit the
// JAX package's _hash_keep. The mask multiplies the numerator terms only;
// s stays unmasked. The seed is read from device memory, so drawing it on
// the card needs no host sync.
//
// What bounds it on this card: bytes. Per (d, h) and edge the forward reads
// src[j], a_src[s] and v[s] (D floats); at the main path's shape (reddit
// with self-loops, H = 1, D = 16) v is 15 MB and stays in L2, so the cost
// is the latency of two dependent loads per edge, as in K1. The bytes bound
// counts the CSR, v, a_src and a_dst once and the outputs once.
//
// What the design does about it: the lane layout of lanes.cuh, as in K1
// (lane groups of L lanes take one edge each, 16-, 8- or 4-byte loads along
// D, kUnroll edges in flight per group, feature tiles for wide D,
// warp-shuffle combine in a fixed order, no atomics, so two runs are
// bitwise equal); heads are the
// grid's y dimension. Known limit: a row is one warp, and the reverse CSR
// of the synthetic reddit graph with self-loops has a row of 212,080
// edges, so b2 on that row is serial; splitting hub rows is later work.

#include <math.h>

#include "lanes.cuh"

namespace {

using namespace warp_csr;

constexpr int kTile = 2;  // vectors per lane per feature tile

struct Drop {
  const int32_t* seed;  // device pointer to one int32, or null without dropout
  uint32_t thresh;      // int(keep · 2^24)
  float scale;          // float32(1 / keep)
};

__device__ __forceinline__ float keep_scale(int32_t eid, int32_t seed, const Drop& drop) {
  uint32_t x = static_cast<uint32_t>(eid ^ seed);
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return (x & 0xFFFFFFu) < drop.thresh ? drop.scale : 0.f;
}

__device__ __forceinline__ float leaky(float x, float ns) { return x > 0.f ? x : ns * x; }

template <int V>
__device__ __forceinline__ void store_scaled(float* __restrict__ p, const float (&v)[V], float s) {
  // v / s, or 0 where s == 0 (an empty row)
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = s > 0.f ? v[k] / s : 0.f;
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    p[0] = o[0];
  }
}

template <int V, typename IdxT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gat_fwd_kernel(const IdxT* __restrict__ indptr, const int32_t* __restrict__ src,
               const float* __restrict__ v, const float* __restrict__ a_src,
               const float* __restrict__ a_dst, float* __restrict__ out,
               float* __restrict__ w1, float* __restrict__ inv_s, float* __restrict__ w1s,
               float* __restrict__ shift, int64_t n_rows, int heads, int d, int lanes,
               float ns, Drop drop) {
  const int64_t row = warp_row();
  if (row >= n_rows) return;  // uniform across the warp
  const int h = blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  const int64_t rh = row * heads + h;
  const float ad = __ldg(a_dst + rh);
  const int32_t seed = drop.seed != nullptr ? __ldg(drop.seed) : 0;

  // sweep 1: the exact row maximum of a_src (leaky_relu is monotone)
  float mx = -INFINITY;
  for (int64_t j = start + lane; j < end; j += kWarp)
    mx = fmaxf(mx, __ldg(a_src + static_cast<int64_t>(__ldg(src + j)) * heads + h));
  for (int off = 1; off < kWarp; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float sh = end > start ? leaky(mx + ad, ns) : 0.f;

  const int nvec = d / V;
  const int64_t stride = static_cast<int64_t>(groups) * kUnroll;
  for (int c0 = 0; c0 < nvec; c0 += lanes * kTile) {
    float num[kTile][V], w1u[kTile][V];
#pragma unroll
    for (int t = 0; t < kTile; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) num[t][k] = w1u[t][k] = 0.f;
    float ps = 0.f, pss = 0.f;

    for (int64_t j0 = start + slot; j0 < end; j0 += stride) {
      int32_t s[kUnroll];
      float pm[kUnroll], pms[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + static_cast<int64_t>(u) * groups;
        s[u] = j < end ? __ldg(src + j) : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        pm[u] = pms[u] = 0.f;
        if (s[u] < 0) continue;
        const int64_t j = j0 + static_cast<int64_t>(u) * groups;
        const float raw = __ldg(a_src + static_cast<int64_t>(s[u]) * heads + h) + ad;
        const float slope = raw > 0.f ? 1.f : ns;
        const float p = expf(leaky(raw, ns) - sh);
        const float m = drop.seed != nullptr ? keep_scale(static_cast<int32_t>(j), seed, drop) : 1.f;
        pm[u] = p * m;
        pms[u] = pm[u] * slope;
        ps += p;
        pss += p * slope;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s[u] < 0) continue;
        const float* vr = v + (static_cast<int64_t>(s[u]) * heads + h) * d;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const int c = c0 + col + t * lanes;
          if (c < nvec) {
            float x[V];
            load_vec<V>(vr + static_cast<int64_t>(c) * V, x);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              num[t][k] = fmaf(pm[u], x[k], num[t][k]);
              w1u[t][k] = fmaf(pms[u], x[k], w1u[t][k]);
            }
          }
        }
      }
    }

    // every lane of a group summed the same p: combine across groups only
    group_sum<kTile, V>(num, lanes);
    group_sum<kTile, V>(w1u, lanes);
    ps = group_sum(ps, lanes);
    pss = group_sum(pss, lanes);
    if (slot == 0) {
      float* orow = out + rh * d;
      float* wrow = w1 + rh * d;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int c = c0 + col + t * lanes;
        if (c < nvec) {
          store_scaled<V>(orow + static_cast<int64_t>(c) * V, num[t], ps);
          store_scaled<V>(wrow + static_cast<int64_t>(c) * V, w1u[t], ps);
        }
      }
    }
    if (c0 == 0 && lane == 0) {
      inv_s[rh] = ps > 0.f ? 1.f / ps : 0.f;
      w1s[rh] = ps > 0.f ? pss / ps : 0.f;
      shift[rh] = sh;
    }
  }
}

template <int V, typename IdxT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
gat_b2_kernel(const IdxT* __restrict__ indptr, const int32_t* __restrict__ dst,
              const int32_t* __restrict__ eid, const float* __restrict__ g,
              const float4* __restrict__ node, const float* __restrict__ a_src,
              float* __restrict__ grad_v, float* __restrict__ w2, float* __restrict__ w3,
              int64_t n_rows, int heads, int d, int lanes, float ns, Drop drop) {
  const int64_t row = warp_row();
  if (row >= n_rows) return;  // uniform across the warp
  const int h = blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int64_t start = static_cast<int64_t>(indptr[row]);
  const int64_t end = static_cast<int64_t>(indptr[row + 1]);
  const int64_t rh = row * heads + h;
  const float as = __ldg(a_src + rh);
  const int32_t seed = drop.seed != nullptr ? __ldg(drop.seed) : 0;

  const int nvec = d / V;
  const int64_t stride = static_cast<int64_t>(groups) * kUnroll;
  for (int c0 = 0; c0 < nvec; c0 += lanes * kTile) {
    float gv[kTile][V], w2a[kTile][V];
#pragma unroll
    for (int t = 0; t < kTile; ++t)
#pragma unroll
      for (int k = 0; k < V; ++k) gv[t][k] = w2a[t][k] = 0.f;
    float w3a = 0.f;

    for (int64_t j0 = start + slot; j0 < end; j0 += stride) {
      int32_t dd[kUnroll], e[kUnroll];
      float wv[kUnroll], w2e[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + static_cast<int64_t>(u) * groups;
        const bool ok = j < end;
        dd[u] = ok ? __ldg(dst + j) : -1;
        e[u] = ok && drop.seed != nullptr ? __ldg(eid + j) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        wv[u] = w2e[u] = 0.f;
        if (dd[u] < 0) continue;
        const float4 q = __ldg(node + static_cast<int64_t>(dd[u]) * heads + h);  // a_dst, shift, inv_s, C
        const float raw = as + q.x;
        const float slope = raw > 0.f ? 1.f : ns;
        const float alpha = expf(leaky(raw, ns) - q.y) * q.z;
        const float m = drop.seed != nullptr ? keep_scale(e[u], seed, drop) : 1.f;
        wv[u] = alpha * m;
        w2e[u] = wv[u] * slope;
        w3a += alpha * slope * q.w;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (dd[u] < 0) continue;
        const float* gr = g + (static_cast<int64_t>(dd[u]) * heads + h) * d;
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const int c = c0 + col + t * lanes;
          if (c < nvec) {
            float x[V];
            load_vec<V>(gr + static_cast<int64_t>(c) * V, x);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              gv[t][k] = fmaf(wv[u], x[k], gv[t][k]);
              w2a[t][k] = fmaf(w2e[u], x[k], w2a[t][k]);
            }
          }
        }
      }
    }

    group_sum<kTile, V>(gv, lanes);
    group_sum<kTile, V>(w2a, lanes);
    w3a = group_sum(w3a, lanes);
    if (slot == 0) {
      float* grow = grad_v + rh * d;
      float* wrow = w2 + rh * d;
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const int c = c0 + col + t * lanes;
        if (c < nvec) {
          store_vec<V>(grow + static_cast<int64_t>(c) * V, gv[t]);
          store_vec<V>(wrow + static_cast<int64_t>(c) * V, w2a[t]);
        }
      }
    }
    if (c0 == 0 && lane == 0) w3[rh] = w3a;
  }
}

template <typename IdxT>
void fwd(const IdxT* indptr, const int32_t* src, const float* v, const float* a_src,
         const float* a_dst, float* out, float* w1, float* inv_s, float* w1s, float* shift,
         int64_t n_rows, int heads, int d, float ns, Drop drop, cudaStream_t stream) {
  const int vw = vec_width(d, reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                                  reinterpret_cast<uintptr_t>(w1));
  const dim3 grid = grid_for(n_rows, heads), block = block_dim();
  const int lanes = lanes_for(d, vw);
  if (vw == 4) {
    gat_fwd_kernel<4, IdxT><<<grid, block, 0, stream>>>(indptr, src, v, a_src, a_dst, out, w1,
                                                        inv_s, w1s, shift, n_rows, heads, d,
                                                        lanes, ns, drop);
  } else if (vw == 2) {
    gat_fwd_kernel<2, IdxT><<<grid, block, 0, stream>>>(indptr, src, v, a_src, a_dst, out, w1,
                                                        inv_s, w1s, shift, n_rows, heads, d,
                                                        lanes, ns, drop);
  } else {
    gat_fwd_kernel<1, IdxT><<<grid, block, 0, stream>>>(indptr, src, v, a_src, a_dst, out, w1,
                                                        inv_s, w1s, shift, n_rows, heads, d,
                                                        lanes, ns, drop);
  }
}

template <typename IdxT>
void b2(const IdxT* indptr, const int32_t* dst, const int32_t* eid, const float* g,
        const float4* node, const float* a_src, float* grad_v, float* w2, float* w3,
        int64_t n_rows, int heads, int d, float ns, Drop drop, cudaStream_t stream) {
  const int vw = vec_width(d, reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(grad_v) |
                                  reinterpret_cast<uintptr_t>(w2));
  const dim3 grid = grid_for(n_rows, heads), block = block_dim();
  const int lanes = lanes_for(d, vw);
  if (vw == 4) {
    gat_b2_kernel<4, IdxT><<<grid, block, 0, stream>>>(indptr, dst, eid, g, node, a_src, grad_v,
                                                       w2, w3, n_rows, heads, d, lanes, ns, drop);
  } else if (vw == 2) {
    gat_b2_kernel<2, IdxT><<<grid, block, 0, stream>>>(indptr, dst, eid, g, node, a_src, grad_v,
                                                       w2, w3, n_rows, heads, d, lanes, ns, drop);
  } else {
    gat_b2_kernel<1, IdxT><<<grid, block, 0, stream>>>(indptr, dst, eid, g, node, a_src, grad_v,
                                                       w2, w3, n_rows, heads, d, lanes, ns, drop);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// `seed` is null when there is no dropout. Each returns cudaGetLastError()
// after its launch.
extern "C" int gat_fwd_f32(const void* indptr, int indptr_is_int64, const void* src,
                           const void* v, const void* a_src, const void* a_dst, void* out,
                           void* w1, void* inv_s, void* w1s, void* shift, long long n_rows,
                           int heads, int d, float ns, const void* seed, unsigned thresh,
                           float scale, void* stream) {
  if (n_rows <= 0 || heads <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const Drop drop{static_cast<const int32_t*>(seed), thresh, scale};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int32_t*>(src);
  const auto* vp = static_cast<const float*>(v);
  const auto* asp = static_cast<const float*>(a_src);
  const auto* adp = static_cast<const float*>(a_dst);
  auto* op = static_cast<float*>(out);
  auto* w1p = static_cast<float*>(w1);
  auto* isp = static_cast<float*>(inv_s);
  auto* w1sp = static_cast<float*>(w1s);
  auto* shp = static_cast<float*>(shift);
  if (indptr_is_int64) {
    fwd(static_cast<const int64_t*>(indptr), sp, vp, asp, adp, op, w1p, isp, w1sp, shp, n_rows,
        heads, d, ns, drop, s);
  } else {
    fwd(static_cast<const int32_t*>(indptr), sp, vp, asp, adp, op, w1p, isp, w1sp, shp, n_rows,
        heads, d, ns, drop, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gat_b2_f32(const void* indptr, int indptr_is_int64, const void* dst,
                          const void* eid, const void* g, const void* node, const void* a_src,
                          void* grad_v, void* w2, void* w3, long long n_rows, int heads, int d,
                          float ns, const void* seed, unsigned thresh, float scale,
                          void* stream) {
  if (n_rows <= 0 || heads <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  const Drop drop{static_cast<const int32_t*>(seed), thresh, scale};
  auto s = static_cast<cudaStream_t>(stream);
  const auto* dp = static_cast<const int32_t*>(dst);
  const auto* ep = static_cast<const int32_t*>(eid);
  const auto* gp = static_cast<const float*>(g);
  const auto* np_ = static_cast<const float4*>(node);
  const auto* asp = static_cast<const float*>(a_src);
  auto* gvp = static_cast<float*>(grad_v);
  auto* w2p = static_cast<float*>(w2);
  auto* w3p = static_cast<float*>(w3);
  if (indptr_is_int64) {
    b2(static_cast<const int64_t*>(indptr), dp, ep, gp, np_, asp, gvp, w2p, w3p, n_rows, heads, d,
       ns, drop, s);
  } else {
    b2(static_cast<const int32_t*>(indptr), dp, ep, gp, np_, asp, gvp, w2p, w3p, n_rows, heads, d,
       ns, drop, s);
  }
  return static_cast<int>(cudaGetLastError());
}
