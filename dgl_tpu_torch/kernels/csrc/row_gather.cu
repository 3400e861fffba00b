// P1 and P2 for Hopper (sm_90a): the row gather out[i] = x[idx[i]], three ways.
//
//   x (n, row_bytes) rows of any 2-, 4- or 8-byte type, idx (e,) int32 or
//   int64, out (e, row_bytes). The kernels move bytes and never look at a
//   value, so the result is x[idx] bit for bit. An index outside [0, n) is
//   not checked: it reads outside x.
//
// Replaces: tools/exp_dma_gather.py:dma_gather (P1) and :vmem_gather (P2),
// the JAX package's probe of how fast the chip can read indexed rows. The
// TPU kernels are a sequential grid of output tiles: P1 keeps one async
// HBM→VMEM DMA per row of the tile in flight on its own semaphore, P2 holds
// all of x in VMEM (tens of MB there) and copies rows by dynamic sublane
// slices.
//
// What bounds them on this card: bytes. A gather must read the rows idx
// touches, write E rows and read E indices: n·row_bytes + E·row_bytes +
// E·idx_bytes at the least. P2 also reads x once per block, 132 times a
// few hundred KB, which is nothing beside the rows. The two index-order
// kernels read a row once per index, at random: from L2 when x fits in its
// 50 MB (reddit at D = 16 is 14.9 MB), from HBM otherwise (the probe's
// default x is 173 MB, read 13.8 times over). No arithmetic to speak of.
//
// What the designs do about it:
//   P1, row_gather_async (index order): a block owns `tile` output rows. It
//   loads the tile's indices into shared memory, then issues one cp.async
//   per 16 bytes of every row (8 or 4 bytes where the row's bytes or the
//   pointers allow no more), global → shared, so all the tile's row reads
//   are in flight at once with no register held for them, and writes the
//   staged rows back with coalesced stores of the same width. cp.async, not
//   a TMA 1-D bulk copy per row: the bulk copy needs 16-byte multiples of
//   size and address, and so would refuse rows like 41 floats, while
//   cp.async takes every width this kernel is given in one path, and
//   spreads a row's requests over the lanes of a warp. A tile whose rows
//   exceed kStageBytes (the probe's 1 KB rows at tile 256 need 256 KB, more
//   than the 227 KB a block may have) is staged in pieces of at most
//   kStageBytes, two buffers deep: the next piece's copies are in flight
//   while the current one is written out. A row wider than a piece is cut
//   into column pieces. Rows of 2-byte granularity (bfloat16 of an odd
//   width), below cp.async's 4, are copied with plain loads through the
//   same staging.
//   P1, row_gather_by_source (source order): the same function given the
//   plan of idx, its CSR by source row (indptr; pos, the output position of
//   each slot; the row split). It reads each row of x once and writes it to
//   every position that asks for it, so the bytes are the bound's: x once,
//   the positions and offsets once, the output once (the probe's default:
//   173 MB + 9 MB + 0.7 MB read, 2.39 GB written, against 1.7 GB or more of
//   row reads from HBM in index order). A warp walks a row's slots with
//   its lanes cut into lane groups as in lanes.cuh (L lanes, the least power
//   of two over the row's vectors, at most 32): every group loads the row
//   with 16-byte read-only loads (8, 4 or 2 bytes where the row's bytes or
//   the pointers allow no more) into registers, kRegVecs vectors a lane
//   (the groups' repeats of one load hit L1); the warp then reads 32
//   positions at once (one coalesced read), shares them by shuffle, and its
//   32 / L groups store the whole row at 32 / L positions a step, with
//   stores of the load's width. A row wider than the register tile is
//   walked once per column piece. A warp's scattered stores retire slowly,
//   so one warp walking a row of hundreds of slots outlasts the rest of the
//   launch (pubmed's reverse CSR has such rows among rows of a few slots),
//   and no warp may walk long: a block takes kWarpsPerBlock rows, or one
//   chunk of a row of more than T slots (the plan's RowSplit; the chunk
//   blocks come first in the launch). Each warp walks its own row whole
//   when that takes at most kShortSteps steps (32 · 32 / L slots); the
//   block's longer rows, or its chunk, are laid end to end and every warp
//   walks an equal slice of them, loading each row its slice touches. So
//   short rows keep one warp each, with no extra read, and a long one is
//   shared by eight. Every output row is written by exactly one warp, so
//   there is nothing to combine, no atomic, and two runs are bitwise equal.
//   Without a position array (pos = null) slot k is output row k: the
//   dst-CSR gathers v[dst[j]], whose stores are contiguous runs. Offsets
//   are 64-bit: 2,332,672 positions × 1 KB is over 2^31.
//   P2, row_gather_smem: the TPU's "x wholly in fast memory". One persistent
//   block per SM copies all of x into dynamic shared memory once, then walks
//   tiles of `tile` output rows (tile b, b + gridDim.x, ...), copying indexed
//   rows from shared memory to out. Shared memory holds at most 227 KB a
//   block, so P2 takes only an x of at most kSmemLimit bytes (cora at
//   D = 16 is 173 KB; reddit is not); the wrapper refuses a larger x before
//   any launch.
//   All three: a warp is cut into lane groups as in lanes.cuh (L lanes per
//   row, 32 / L rows or positions at once), so a narrow row still keeps all
//   32 lanes busy.

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
constexpr int kRegVecs = 2;              // P1 by source: vectors of a row a lane holds
constexpr int kShortSteps = 32;          // P1 by source: the longest walk one warp takes alone

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

template <int V>
__device__ __forceinline__ typename Vec<V>::T load_ro(const char* src) {
  return __ldg(reinterpret_cast<const typename Vec<V>::T*>(src));
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

// ---- P1 by source -----------------------------------------------------------

// Row r of x stored at positions pos[k] (k without pos) for k in [begin,
// end), by one warp: every lane group holds the row (piece); the warp reads
// 32 positions at once and its groups store the row at 32 / L of them a step.
template <int V, typename PosT>
__device__ __forceinline__ void walk_row(const char* __restrict__ x, const PosT* __restrict__ pos,
                                         char* __restrict__ out, int64_t r, int64_t begin,
                                         int64_t end, int64_t row_bytes, int lanes) {
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lanes;
  const int slot = lane / lanes;
  const int col = lane % lanes;
  const int nvec = static_cast<int>(row_bytes / V);
  const char* src = x + r * row_bytes;
  for (int c0 = 0; c0 < nvec; c0 += lanes * kRegVecs) {
    typename Vec<V>::T v[kRegVecs];
#pragma unroll
    for (int t = 0; t < kRegVecs; ++t) {
      const int c = c0 + col + t * lanes;
      if (c < nvec) v[t] = load_ro<V>(src + static_cast<int64_t>(c) * V);
    }
    for (int64_t k0 = begin; k0 < end; k0 += kWarp) {
      const int cnt = static_cast<int>(min64(kWarp, end - k0));
      long long mine = 0;
      if (pos != nullptr && lane < cnt) mine = static_cast<long long>(pos[k0 + lane]);
      for (int j0 = 0; j0 < cnt; j0 += groups) {  // uniform: every lane shuffles
        const int j = j0 + slot;
        const int64_t p = pos != nullptr ? __shfl_sync(0xffffffffu, mine, j) : k0 + j;
        if (j >= cnt) continue;
        char* dst = out + p * row_bytes;
#pragma unroll
        for (int t = 0; t < kRegVecs; ++t) {
          const int c = c0 + col + t * lanes;
          if (c < nvec)
            *reinterpret_cast<typename Vec<V>::T*>(dst + static_cast<int64_t>(c) * V) = v[t];
        }
      }
    }
  }
}

// out[pos[k]] = x[r] (out[k] = x[r] without pos) for every slot k of row r.
// The first n_chunks blocks take one chunk of a long row each, the others
// kWarpsPerBlock rows each (a row of more than long_t slots is its chunks'
// work). Every warp reads the block's items itself (lane i holds item i), so
// the warps need no barrier. Warp w walks item w whole when it takes at most
// kShortSteps store steps; the block's longer items are laid end to end and
// every warp walks an equal slice of them.
template <int V, typename IptrT, typename PosT>
__global__ void __launch_bounds__(kWarp * warp_csr::kWarpsPerBlock)
row_gather_by_source_kernel(const char* __restrict__ x, const IptrT* __restrict__ indptr,
                            const PosT* __restrict__ pos, char* __restrict__ out, int64_t n_rows,
                            int64_t row_bytes, int lanes, int64_t long_t,
                            const int64_t* __restrict__ rows, const int64_t* __restrict__ chunk_ptr,
                            int64_t n_long, const int64_t* __restrict__ chunks, int64_t n_chunks) {
  constexpr int kItems = warp_csr::kWarpsPerBlock;
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const bool chunk_block = blockIdx.x < n_chunks;
  const int n_items = chunk_block ? 1 : kItems;
  long long r = 0, begin = 0, len = 0;  // lane i: item i
  if (chunk_block) {
    if (lane == 0) {
      const int64_t k = blockIdx.x;
      begin = chunks[2 * k];
      len = chunks[2 * k + 1] - begin;
      r = rows[warp_csr::chunk_owner(chunk_ptr, n_long, k)];
    }
  } else {
    const int64_t r0 = (static_cast<int64_t>(blockIdx.x) - n_chunks) * kItems;
    long long off = 0;  // lanes 0..kItems read the block's kItems + 1 offsets
    if (lane <= kItems && r0 + lane <= n_rows) off = static_cast<long long>(indptr[r0 + lane]);
    const long long next = __shfl_down_sync(0xffffffffu, off, 1);
    if (lane < kItems && r0 + lane < n_rows) {
      r = r0 + lane;
      begin = off;
      len = next - off;
      if (len > long_t) len = 0;  // a long row: its chunks write it
    }
  }
  const int64_t short_len = static_cast<int64_t>(kShortSteps) * (kWarp / lanes);
  const long long my_len = __shfl_sync(0xffffffffu, len, w);
  const long long my_r = __shfl_sync(0xffffffffu, r, w);
  const long long my_begin = __shfl_sync(0xffffffffu, begin, w);
  if (w < n_items && my_len > 0 && my_len <= short_len)
    walk_row<V>(x, pos, out, my_r, my_begin, my_begin + my_len, row_bytes, lanes);
  const long long long_len = len > short_len ? len : 0;  // the items shared by every warp
  long long total = long_len;
#pragma unroll
  for (int o = 1; o < kItems; o <<= 1) total += __shfl_xor_sync(0xffffffffu, total, o);
  total = __shfl_sync(0xffffffffu, total, 0);
  const int64_t share = (total + kItems - 1) / kItems;
  const int64_t lo = min64(total, w * share), hi = min64(total, lo + share);
  int64_t at = 0;
  for (int i = 0; i < n_items && at < hi; ++i) {
    const int64_t li = __shfl_sync(0xffffffffu, long_len, i);
    const int64_t a = lo > at ? lo : at;
    const int64_t b = min64(hi, at + li);
    if (a < b) {
      const int64_t bi = __shfl_sync(0xffffffffu, begin, i);
      walk_row<V>(x, pos, out, __shfl_sync(0xffffffffu, r, i), bi + (a - at), bi + (b - at),
                  row_bytes, lanes);
    }
    at += li;
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

template <int V, typename IptrT, typename PosT>
cudaError_t launch_by_source(const char* x, const IptrT* indptr, const PosT* pos, char* out,
                             int64_t n_rows, int64_t row_bytes, int64_t long_t,
                             const int64_t* rows, const int64_t* chunk_ptr, int64_t n_long,
                             const int64_t* chunks, int64_t n_chunks, cudaStream_t stream) {
  const int lanes = warp_csr::lanes_for(static_cast<int>(row_bytes / V), 1);
  const dim3 grid(static_cast<unsigned>(n_chunks + warp_csr::grid_for(n_rows).x));
  row_gather_by_source_kernel<V, IptrT, PosT><<<grid, warp_csr::block_dim(), 0, stream>>>(
      x, indptr, pos, out, n_rows, row_bytes, lanes, long_t, rows, chunk_ptr, n_long, chunks,
      n_chunks);
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

// out[pos[k]] = x[r] for every slot k in [indptr[r], indptr[r+1]) (out[k]
// with pos null). The row split: rows of more than long_t slots are the
// n_long `rows`, whose chunks [chunks[2k], chunks[2k+1]) are
// chunk_ptr[i]..chunk_ptr[i+1]; without a split long_t is above every row
// and n_chunks 0.
extern "C" int row_gather_by_source(const void* x, const void* indptr, int indptr_is_int64,
                                    const void* pos, int pos_is_int64, void* out,
                                    long long n_rows, long long row_bytes, long long long_t,
                                    const void* rows, const void* chunk_ptr, long long n_long,
                                    const void* chunks, long long n_chunks, void* stream) {
  if (n_rows <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  if (row_bytes % 2) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const char*>(x);
  auto* op = static_cast<char*>(out);
  const auto* rp = static_cast<const int64_t*>(rows);
  const auto* cp = static_cast<const int64_t*>(chunk_ptr);
  const auto* ch = static_cast<const int64_t*>(chunks);
  auto s = static_cast<cudaStream_t>(stream);
  const int v = vec_bytes(row_bytes, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out));
  return static_cast<int>(by_width(v, [&](auto vc) {
    constexpr int V = decltype(vc)::value;
    auto with_pos = [&](auto* ip) {
      return pos_is_int64
                 ? launch_by_source<V>(xp, ip, static_cast<const int64_t*>(pos), op, n_rows,
                                       row_bytes, long_t, rp, cp, n_long, ch, n_chunks, s)
                 : launch_by_source<V>(xp, ip, static_cast<const int32_t*>(pos), op, n_rows,
                                       row_bytes, long_t, rp, cp, n_long, ch, n_chunks, s);
    };
    return indptr_is_int64 ? with_pos(static_cast<const int64_t*>(indptr))
                           : with_pos(static_cast<const int32_t*>(indptr));
  }));
}
