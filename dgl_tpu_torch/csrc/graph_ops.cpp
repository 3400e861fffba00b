// Host-side neighbour sampling for dgl_tpu_torch.
//
// The port's own copy of the samplers of the JAX package's native runtime
// (dgl_tpu/csrc/graph_ops.cpp: splitmix64, Rng, sample_neighbors,
// sample_neighbors_noreplace), so both packages draw the same neighbours
// from the same seed wherever the OpenMP team size is the same. Host C++
// only; the Python layer (native.py) builds and binds it with ctypes.
//
// Both functions are thread-parallel with OpenMP and read an int64 in-edge
// CSR owned by the caller (NumPy buffers).

#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// xorshift128+ per-thread RNG, seeded per (seed, thread).
static inline uint64_t splitmix64(uint64_t &x) {
  uint64_t z = (x += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    uint64_t x = seed;
    s0 = splitmix64(x);
    s1 = splitmix64(x);
  }
  inline uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // bounded draw in [0, n) by multiply-shift (no rejection)
  inline uint64_t bounded(uint64_t n) {
    return (uint64_t)(((__uint128_t)next() * n) >> 64);
  }
};

// Sample `fanout` in-neighbours (with replacement) for each seed.
// out: (n_seeds * fanout) neighbour ids; zero-degree seeds yield themselves.
void sample_neighbors(const int64_t *indptr, const int64_t *indices,
                      const int64_t *seeds, int64_t n_seeds, int64_t fanout,
                      uint64_t seed, int64_t *out) {
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(seed * 0x9e3779b97f4a7c15ull + (uint64_t)tid + 1);
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_seeds; ++i) {
      int64_t v = seeds[i];
      int64_t lo = indptr[v], hi = indptr[v + 1];
      int64_t deg = hi - lo;
      int64_t *dst = out + i * fanout;
      if (deg <= 0) {
        for (int64_t j = 0; j < fanout; ++j) dst[j] = v;
      } else {
        for (int64_t j = 0; j < fanout; ++j)
          dst[j] = indices[lo + (int64_t)rng.bounded((uint64_t)deg)];
      }
    }
  }
}

// Sample up to `fanout` distinct in-neighbours per seed (DGL's
// without-replacement semantics) by Robert Floyd's algorithm: O(fanout^2)
// per seed, no allocation, no dependence on the degree. Seeds with
// deg <= fanout take all deg neighbours and fill the remaining slots
// cyclically from them (a static slot count); zero-degree seeds yield
// themselves. fanout is at most 64 (the Python wrapper checks).
void sample_neighbors_noreplace(const int64_t *indptr, const int64_t *indices,
                                const int64_t *seeds, int64_t n_seeds,
                                int64_t fanout, uint64_t seed, int64_t *out) {
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(seed * 0x9e3779b97f4a7c15ull + (uint64_t)tid + 1);
    int64_t chosen[64];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n_seeds; ++i) {
      int64_t v = seeds[i];
      int64_t lo = indptr[v], hi = indptr[v + 1];
      int64_t deg = hi - lo;
      int64_t *dst = out + i * fanout;
      if (deg <= 0) {
        for (int64_t j = 0; j < fanout; ++j) dst[j] = v;
      } else if (deg <= fanout) {
        for (int64_t j = 0; j < fanout; ++j) dst[j] = indices[lo + j % deg];
      } else {
        // Floyd: k distinct draws from [0, deg)
        int64_t k = fanout;
        for (int64_t t = deg - k, m = 0; t < deg; ++t, ++m) {
          int64_t j = (int64_t)rng.bounded((uint64_t)(t + 1));
          bool dup = false;
          for (int64_t q = 0; q < m; ++q)
            if (chosen[q] == j) { dup = true; break; }
          chosen[m] = dup ? t : j;
        }
        for (int64_t m = 0; m < k; ++m) dst[m] = indices[lo + chosen[m]];
      }
    }
  }
}

}  // extern "C"
