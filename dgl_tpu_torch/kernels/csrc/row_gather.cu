// P1 and P2 for Hopper (sm_90a): the row gather out[i] = x[idx[i]], two ways.
//
//   x (n, row_bytes) float32 or bfloat16 rows, idx (e,) int32 or int64,
//   out (e, row_bytes). The kernels move bytes and never look at a value,
//   so the result is x[idx] bit for bit. An index outside [0, n) is not
//   checked: it reads outside x.
//
// Replaces: tools/exp_dma_gather.py:dma_gather (P1) and :vmem_gather (P2),
// the JAX package's probe of how fast the chip can read indexed rows. The
// TPU kernels are a sequential grid of output tiles: P1 keeps one async
// HBM→VMEM DMA per row of the tile in flight on its own semaphore, P2 holds
// all of x in VMEM (tens of MB there) and copies rows by dynamic sublane
// slices.
//
// What bounds them on this card: bytes. A gather must read E rows, write E
// rows and read E indices: 2·E·row_bytes + E·idx_bytes (x itself, once, if
// it is smaller). P2 also reads x once per block, 132 times a few hundred KB,
// which is nothing beside the rows. The E row reads are dependent loads (the
// address comes from idx) at random rows: they hit L2 when x fits in its
// 50 MB (reddit at D = 16 is 14.9 MB), HBM otherwise (the probe's default x
// is 173 MB). No arithmetic to speak of.
//
// What the designs do about it:
//   P1, row_gather_async: a block owns `tile` output rows. It loads the
//   tile's indices into shared memory, then issues one cp.async per 16 bytes
//   of every row (8 or 4 bytes where the row's bytes or the pointers allow no
//   more), global → shared, so all the tile's row reads are in flight at
//   once with no register held for them, and writes the staged rows back
//   with coalesced stores of the same width. cp.async, not a TMA 1-D bulk
//   copy per row: the bulk copy needs 16-byte multiples of size and address,
//   and so would refuse rows like 41 floats, while cp.async takes every
//   width this kernel is given in one path, and spreads a row's requests over
//   the lanes of a warp. A tile whose rows exceed kStageBytes (the probe's
//   1 KB rows at tile 256 need 256 KB, more than the 227 KB a block may
//   have) is staged in pieces of at most kStageBytes, two buffers deep: the
//   next piece's copies are in flight while the current one is written out.
//   A row wider than a piece is cut into column pieces. bfloat16 rows of an
//   odd width have 2-byte granularity, below cp.async's 4: they are copied
//   with plain loads through the same staging.
//   P2, row_gather_smem: the TPU's "x wholly in fast memory". One persistent
//   block per SM copies all of x into dynamic shared memory once, then walks
//   tiles of `tile` output rows (tile b, b + gridDim.x, ...), copying indexed
//   rows from shared memory to out. Shared memory holds at most 227 KB a
//   block, so P2 takes only an x of at most kSmemLimit bytes (cora at
//   D = 16 is 173 KB; reddit is not); the wrapper refuses a larger x before
//   any launch.
//   Both: a warp is cut into lane groups as in lanes.cuh (L lanes per row,
//   32 / L rows at once), so a narrow row still keeps all 32 lanes busy and
//   every warp-wide store covers 32 / L whole consecutive output rows.

#include <algorithm>
#include <type_traits>

#include "lanes.cuh"

namespace {

using warp_csr::kWarp;

constexpr int kStageBytes = 32 * 1024;   // P1: bytes of one staged piece
constexpr int kAsyncThreads = 256;       // P1: threads per block
constexpr int kSmemThreads = 1024;       // P2: one block per SM, 32 warps
constexpr int kSmemLimit = 232448;       // 227 KB, the most a block may have
constexpr int kUnroll = 4;               // P2: rows in flight per lane group

template <int V> struct Vec;
template <> struct Vec<16> { using T = int4; };
template <> struct Vec<8> { using T = int2; };
template <> struct Vec<4> { using T = int; };
template <> struct Vec<2> { using T = short; };

template <int V>
__device__ __forceinline__ void copy_vec(char* __restrict__ dst, const char* __restrict__ src) {
  using T = typename Vec<V>::T;
  *reinterpret_cast<T*>(dst) = *reinterpret_cast<const T*>(src);
}

// One V-byte copy, global → shared; asynchronous for V ≥ 4.
template <int V>
__device__ __forceinline__ void cp_async(char* smem, const char* gmem) {
  if constexpr (V == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else if constexpr (V >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(V)
                 : "memory");
  } else {
    copy_vec<V>(smem, gmem);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The lane group of this thread: `lanes` (a power of two) lanes per row.
struct Groups {
  int slot, col, lanes, rows_per_step;
};

__device__ __forceinline__ Groups lane_groups(int nvec, int warps) {
  int lanes = 1;
  while (lanes < nvec && lanes < kWarp) lanes <<= 1;
  const int lane = threadIdx.x % kWarp;
  const int per_warp = kWarp / lanes;
  return {static_cast<int>(threadIdx.x / kWarp) * per_warp + lane / lanes, lane % lanes, lanes,
          warps * per_warp};
}

// ---- P1 ---------------------------------------------------------------------

// A piece is rows [r0, r0 + nr) of the tile and bytes [c0, c0 + nb) of each
// row; it is staged row after row at a stride of `cw` bytes.
template <int V>
__device__ __forceinline__ void issue_piece(char* stage, const int64_t* s_off,
                                            const char* __restrict__ x, int r0, int nr,
                                            int64_t c0, int nb, int cw, const Groups& g) {
  const int nvec = nb / V;
  for (int r = g.slot; r < nr; r += g.rows_per_step) {
    const char* src = x + s_off[r0 + r] + c0;
    char* dst = stage + static_cast<int64_t>(r) * cw;
    for (int c = g.col; c < nvec; c += g.lanes) cp_async<V>(dst + c * V, src + c * V);
  }
}

template <int V>
__device__ __forceinline__ void store_piece(const char* stage, char* __restrict__ out,
                                            int64_t row_bytes, int64_t t0, int r0, int nr,
                                            int64_t c0, int nb, int cw, const Groups& g) {
  const int nvec = nb / V;
  for (int r = g.slot; r < nr; r += g.rows_per_step) {
    const char* src = stage + static_cast<int64_t>(r) * cw;
    char* dst = out + (t0 + r0 + r) * row_bytes + c0;
    for (int c = g.col; c < nvec; c += g.lanes) copy_vec<V>(dst + c * V, src + c * V);
  }
}

template <int V, typename IdxT>
__global__ void __launch_bounds__(kAsyncThreads)
row_gather_async_kernel(const char* __restrict__ x, const IdxT* __restrict__ idx,
                        char* __restrict__ out, int64_t e, int64_t row_bytes, int tile,
                        int rows_per_piece, int cw) {
  extern __shared__ __align__(16) char smem[];
  int64_t* s_off = reinterpret_cast<int64_t*>(smem);
  char* stage0 = smem + ((static_cast<int64_t>(tile) * 8 + 15) / 16) * 16;
  const int64_t piece_bytes = static_cast<int64_t>(rows_per_piece) * cw;

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int rows = static_cast<int>(min64(tile, e - t0));  // ragged tail
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    s_off[r] = static_cast<int64_t>(idx[t0 + r]) * row_bytes;
  __syncthreads();

  const Groups g = lane_groups(cw / V, kAsyncThreads / kWarp);
  const int col_pieces = static_cast<int>((row_bytes + cw - 1) / cw);
  const int pieces = (rows + rows_per_piece - 1) / rows_per_piece * col_pieces;
  auto piece = [&](int p, int& r0, int& nr, int64_t& c0, int& nb) {
    r0 = (p / col_pieces) * rows_per_piece;
    nr = min(rows_per_piece, rows - r0);
    c0 = static_cast<int64_t>(p % col_pieces) * cw;
    nb = static_cast<int>(min64(cw, row_bytes - c0));
  };

  int r0, nr, nb;
  int64_t c0;
  piece(0, r0, nr, c0, nb);
  issue_piece<V>(stage0, s_off, x, r0, nr, c0, nb, cw, g);
  cp_async_commit();
  for (int p = 0; p < pieces; ++p) {
    char* stage = stage0 + (p & 1) * piece_bytes;
    if (p + 1 < pieces) {  // the next piece's copies fly while this one is written
      int r1, n1, b1;
      int64_t c1;
      piece(p + 1, r1, n1, c1, b1);
      issue_piece<V>(stage0 + ((p + 1) & 1) * piece_bytes, s_off, x, r1, n1, c1, b1, cw, g);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of piece p have landed
    piece(p, r0, nr, c0, nb);
    store_piece<V>(stage, out, row_bytes, t0, r0, nr, c0, nb, cw, g);
    __syncthreads();  // piece p's buffer is free for piece p + 2
  }
}

// ---- P2 ---------------------------------------------------------------------

template <int V, typename IdxT>
__global__ void __launch_bounds__(kSmemThreads)
row_gather_smem_kernel(const char* __restrict__ x, int64_t x_bytes, const IdxT* __restrict__ idx,
                       char* __restrict__ out, int64_t e, int64_t row_bytes, int tile) {
  extern __shared__ __align__(16) char xs[];
  for (int64_t b = static_cast<int64_t>(threadIdx.x) * V; b < x_bytes;
       b += static_cast<int64_t>(blockDim.x) * V)
    copy_vec<V>(xs + b, x + b);
  __syncthreads();

  const int nvec = static_cast<int>(row_bytes / V);
  const Groups g = lane_groups(nvec, kSmemThreads / kWarp);
  const int64_t tiles = (e + tile - 1) / tile;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t t0 = t * tile;
    const int rows = static_cast<int>(min64(tile, e - t0));
    for (int r = g.slot; r < rows; r += kUnroll * g.rows_per_step) {
      int64_t off[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // kUnroll independent index loads in flight
        const int ru = r + u * g.rows_per_step;
        off[u] = ru < rows ? static_cast<int64_t>(idx[t0 + ru]) * row_bytes : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ru = r + u * g.rows_per_step;
        if (ru >= rows) break;
        const char* src = xs + off[u];
        char* dst = out + (t0 + ru) * row_bytes;
        for (int c = g.col; c < nvec; c += g.lanes) copy_vec<V>(dst + c * V, src + c * V);
      }
    }
  }
}

// The widest copy that the row's bytes and every pointer allow.
int vec_bytes(int64_t row_bytes, uintptr_t align) {
  for (int v = 16; v > 2; v >>= 1)
    if (row_bytes % v == 0 && align % v == 0) return v;
  return 2;
}

template <int V, typename IdxT>
cudaError_t launch_async(const char* x, const IdxT* idx, char* out, int64_t e, int64_t row_bytes,
                         int tile, cudaStream_t stream) {
  const int cw = static_cast<int>(std::min<int64_t>(row_bytes, kStageBytes));
  const int rows_per_piece = std::max(1, std::min(tile, kStageBytes / cw));
  const int64_t pieces = (static_cast<int64_t>(tile) + rows_per_piece - 1) / rows_per_piece *
                         ((row_bytes + cw - 1) / cw);
  const size_t smem = ((static_cast<size_t>(tile) * 8 + 15) / 16) * 16 +
                      static_cast<size_t>(std::min<int64_t>(pieces, 2)) * rows_per_piece * cw;
  auto kernel = row_gather_async_kernel<V, IdxT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (e + tile - 1) / tile;
  kernel<<<static_cast<unsigned>(blocks), kAsyncThreads, smem, stream>>>(
      x, idx, out, e, row_bytes, tile, rows_per_piece, cw);
  return cudaGetLastError();
}

template <int V, typename IdxT>
cudaError_t launch_smem(const char* x, int64_t n, const IdxT* idx, char* out, int64_t e,
                        int64_t row_bytes, int tile, cudaStream_t stream) {
  const int64_t x_bytes = n * row_bytes;
  if (x_bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = row_gather_smem_kernel<V, IdxT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(x_bytes));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int64_t tiles = (e + tile - 1) / tile;
  kernel<<<static_cast<unsigned>(std::min<int64_t>(sms, tiles)), kSmemThreads, x_bytes, stream>>>(
      x, x_bytes, idx, out, e, row_bytes, tile);
  return cudaGetLastError();
}

template <typename Launch>
cudaError_t by_width(int v, Launch launch) {
  switch (v) {
    case 16: return launch(std::integral_constant<int, 16>{});
    case 8: return launch(std::integral_constant<int, 8>{});
    case 4: return launch(std::integral_constant<int, 4>{});
    default: return launch(std::integral_constant<int, 2>{});
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// row_bytes is even (float32 or bfloat16 rows). Each returns the launch's
// cudaError_t (0 on success).
extern "C" int row_gather_async(const void* x, const void* idx, int idx_is_int64, void* out,
                                long long e, long long row_bytes, int tile, void* stream) {
  if (e <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const char*>(x);
  auto* op = static_cast<char*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int v = vec_bytes(row_bytes, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out));
  return static_cast<int>(by_width(v, [&](auto vc) {
    constexpr int V = decltype(vc)::value;
    return idx_is_int64 ? launch_async<V>(xp, static_cast<const int64_t*>(idx), op, e, row_bytes, tile, s)
                        : launch_async<V>(xp, static_cast<const int32_t*>(idx), op, e, row_bytes, tile, s);
  }));
}

extern "C" int row_gather_smem(const void* x, long long n, const void* idx, int idx_is_int64,
                               void* out, long long e, long long row_bytes, int tile,
                               void* stream) {
  if (e <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (tile <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const char*>(x);
  auto* op = static_cast<char*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int v = vec_bytes(row_bytes, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out));
  return static_cast<int>(by_width(v, [&](auto vc) {
    constexpr int V = decltype(vc)::value;
    return idx_is_int64
               ? launch_smem<V>(xp, n, static_cast<const int64_t*>(idx), op, e, row_bytes, tile, s)
               : launch_smem<V>(xp, n, static_cast<const int32_t*>(idx), op, e, row_bytes, tile, s);
  }));
}
