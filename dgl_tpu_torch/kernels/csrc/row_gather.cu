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
// few hundred KB, which is nothing beside the rows. The index-order kernels
// read a row once per index, at random: from L2 when x fits in its 50 MB
// (reddit at D = 16 is 14.9 MB), from HBM otherwise (the probe's default x
// is 173 MB, read 13.8 times over). No arithmetic to speak of.
//
// What the designs do about it (k2_p1_geometry.h sizes each launch; the
// copies are async_copy.cuh's):
//   P1, row_gather_async (index order): a block of 4 warps owns `tile`
//   output rows, one contiguous slice a warp. Each warp streams its rows
//   through a ring of 4 stages on mbarriers (2 KB, or one row of up to 4 KB;
//   k2_p1_geometry.h): a stage's rows come in
//   as their 16-byte-aligned spans, by one TMA bulk copy a row from 144-byte
//   spans up (issued by the row's lane), completing on the stage's
//   mbarrier, which expects one arrival, lane 0's, with the stage's TMA
//   bytes (32 lanes arriving on one barrier serialise), or by cp.async
//   copies of 16 bytes over the lanes below, in the stage's commit group.
//   Where the rows
//   are a multiple of 16 bytes and x and out are 16-byte aligned, a stage's
//   rows sit in shared memory as out holds them and go out by one bulk store
//   (shared → global); otherwise each row sits at its offset in a slot of
//   its span's size and the lanes store its 16-byte words, as the source
//   order does (store_words). A stage is refilled once its bulk store has read it,
//   so three stages of copies stay in flight while one goes out. A row wider
//   than a stage runs in pieces, one a stage. A span that would cross x's
//   first or last byte moves only the values inside x.
//   P1, row_gather_by_source (source order): the same function given the
//   plan of idx, its CSR by source row (indptr; pos, the output position of
//   each slot; the row split). It reads each row of x once and writes it to
//   every position that asks for it, so the bytes are the bound's: x once,
//   the positions and offsets once, the output once (the probe's default:
//   173 MB + 9 MB + 0.7 MB read, 2.39 GB written, against 1.7 GB or more of
//   row reads from HBM in index order). A warp stages its row once in shared
//   memory (TMA from 144-byte spans up, cp.async below; rows wider than
//   2 KB in pieces), then writes each slot's copy with 16-byte stores at any
//   width and alignment: a slot's destination splits into a head up to its
//   first 16-byte boundary, a body of 16-byte words and a tail (split16);
//   each lane takes one word of one slot, reads its 16 source bytes from the
//   staged row at whatever alignment they have there, and stores them at
//   once; head and tail go at the width their ends allow. The warp reads 32
//   positions at once and shares them by shuffle. Without a position array
//   (pos = null: the dst-CSR gathers v[dst[j]], gather_dst, spread_dst and
//   segment_sum's backward) a row's slots are one contiguous range of out:
//   where it holds 1 KB or more, the warp lays the row out repeated in
//   shared memory, starting at the range's offset from 16 bytes, and the
//   range's aligned body goes out by bulk stores of whole periods
//   (lcm(row_bytes, 16)) from that one place; head and tail by lanes. A
//   warp's stores retire slowly, so one warp walking a row of hundreds of
//   slots outlasts the rest of the launch (pubmed's reverse CSR has such rows
//   among rows of a few slots), and no warp may walk long: a block takes
//   kWarpsPerBlock rows, or one chunk of a row of more than T slots (the
//   plan's RowSplit; the chunk blocks come first in the launch). Each warp
//   walks its own row whole when it writes at most kShortBytes; the block's
//   longer rows, or its chunk, are laid end to end and every warp walks an
//   equal slice of them, staging each row its slice touches. So short rows
//   keep one warp each, with no extra read, and a long one is shared by
//   eight. Every output byte is written by exactly one warp, so there is
//   nothing to combine, no atomic, and two runs are bitwise equal. Offsets
//   are 64-bit: 2,332,672 positions × 1 KB is over 2^31.
//   P2, row_gather_smem: the TPU's "x wholly in fast memory". One persistent
//   block per SM copies all of x into dynamic shared memory once, then walks
//   tiles of `tile` output rows (tile b, b + gridDim.x, ...), copying indexed
//   rows from shared memory to out. Shared memory holds at most 227 KB a
//   block, so P2 takes only an x of at most kSmemLimit bytes (cora at
//   D = 16 is 173 KB; reddit is not); the wrapper refuses a larger x before
//   any launch. Its warp is cut into lane groups as in lanes.cuh (L lanes per
//   row, 32 / L rows at once), so a narrow row still keeps all 32 lanes busy.

#include <algorithm>
#include <type_traits>

#include "async_copy.cuh"
#include "k2_p1_geometry.h"
#include "lanes.cuh"

namespace {

using namespace async_copy;
using warp_csr::kFull;
using warp_csr::kWarp;

constexpr int kSmemThreads = 1024;       // P2: one block per SM, 32 warps
constexpr int kSmemLimit = 232448;       // 227 KB, the most a block may have
constexpr int kUnroll = 4;               // P2: rows in flight per lane group
constexpr int64_t kShortBytes = 16384;   // P1 by source: the most one warp writes alone

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

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// The lowest set bit of a | 16: the alignment, at most 16, that a allows.
__device__ __forceinline__ int low16(uint64_t a) {
  const uint64_t m = a | 16u;
  return static_cast<int>(m & (~m + 1));
}

// n bytes (n < 16 or any even count) from src to dst, at the widest width
// both addresses and n allow (every width here is even).
__device__ __forceinline__ void copy_bytes(char* dst, const char* src, int n) {
  const int w = low16(reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                      static_cast<uint64_t>(n) | 8u);
  for (int o = 0; o < n; o += w) {
    if (w == 8) {
      copy_vec<8>(dst + o, src + o);
    } else if (w == 4) {
      copy_vec<4>(dst + o, src + o);
    } else {
      copy_vec<2>(dst + o, src + o);
    }
  }
}

// 16 bytes of shared memory at s, at whatever (even) alignment they have.
__device__ __forceinline__ int4 lds16(const char* s) {
  const int a = low16(reinterpret_cast<uintptr_t>(s));
  if (a == 16) return *reinterpret_cast<const int4*>(s);
  int4 v;
  char* d = reinterpret_cast<char*>(&v);
  if (a == 8) {
    copy_vec<8>(d, s);
    copy_vec<8>(d + 8, s + 8);
  } else if (a == 4) {
#pragma unroll
    for (int o = 0; o < 16; o += 4) copy_vec<4>(d + o, s + o);
  } else {
#pragma unroll
    for (int o = 0; o < 16; o += 2) copy_vec<2>(d + o, s + o);
  }
  return v;
}

// Word q of a destination [d, d + bytes) whose source is shared memory at s:
// the 16 bytes of out from the q-th 16-byte boundary at or below d, cut to
// the destination. A whole word is one 16-byte load (at whatever alignment
// it has in shared memory) and one 16-byte store; a cut one (the head or the
// tail) goes at the width its ends allow. kAligned: d, s and bytes are
// multiples of 16, so every word is whole and aligned.
template <bool kAligned>
__device__ __forceinline__ void store_word(uint64_t d, const char* s, int bytes, int q) {
  if constexpr (kAligned) {
    *reinterpret_cast<int4*>(d + 16u * q) = *reinterpret_cast<const int4*>(s + 16 * q);
    return;
  }
  const uint64_t w0 = (d & ~uint64_t{15}) + 16u * q;
  const uint64_t lo = w0 > d ? w0 : d, hi = w0 + 16 < d + bytes ? w0 + 16 : d + bytes;
  if (lo >= hi) return;
  if (hi - lo == 16) {
    *reinterpret_cast<int4*>(lo) = lds16(s + (lo - d));
  } else {
    copy_bytes(reinterpret_cast<char*>(lo), s + (lo - d), static_cast<int>(hi - lo));
  }
}

// The words of n destinations, nw a destination (store_word), one a lane at
// a time: destination j is dst(j), its source src(j), each `bytes` long.
// dst is called by every lane on every step (it may shuffle).
template <bool kAligned, typename Dst, typename Src>
__device__ __forceinline__ void store_words(int n, int nw, int bytes, Dst dst, Src src) {
  const int lane = threadIdx.x % kWarp;
  const int items = n * nw;
  int j = lane / nw, q = lane % nw;
  const int jstep = kWarp / nw, qstep = kWarp % nw;
  for (int it0 = 0; it0 < items; it0 += kWarp) {
    const uint64_t d = dst(j < n ? j : 0);
    if (it0 + lane < items) store_word<kAligned>(d, src(j), bytes, q);
    j += jstep;
    q += qstep;
    if (q >= nw) {
      q -= nw;
      ++j;
    }
  }
}

// x's bytes, for the copies at its first or last bytes.
struct Span {
  uint64_t lo, hi;

  // The 16-byte chunk at a (16-byte aligned) into shared memory at dst: a
  // cp.async copy where it lies inside x, else its values inside x one at a
  // time (every value is at least 2 bytes, every row start even).
  __device__ __forceinline__ void chunk(char* dst, uint64_t a) const {
    if (a >= lo && a + 16 <= hi) {
      cp_async16(dst, a);
      return;
    }
#pragma unroll
    for (int o = 0; o < 16; o += 2)
      if (a + o >= lo && a + o + 2 <= hi)
        *reinterpret_cast<uint16_t*>(dst + o) = *reinterpret_cast<const uint16_t*>(a + o);
  }

  // Whether [a0, a0 + span) can be one TMA bulk copy: kBulkMinBytes up, and
  // inside x.
  __device__ __forceinline__ bool bulk(uint64_t a0, uint32_t span) const {
    return span >= k1::kBulkMinBytes && a0 >= lo && a0 + span <= hi;
  }

  // The span [a0, a0 + span) into dst by the warp: one TMA bulk copy where
  // bulk() allows it, completing on `bar` (which expects one arrival a phase,
  // lane 0's), else 16-byte chunks over the lanes in one cp.async group;
  // then waits for both.
  __device__ __forceinline__ void stage(char* dst, uint64_t a0, uint32_t span, uint64_t* bar,
                                        uint32_t& phase, int lane) const {
    if (bulk(a0, span)) {
      if (lane == 0) {
        mbar_arrive_tx(bar, span);
        bulk_copy(dst, a0, span, bar);
      }
      mbar_wait(bar, phase);
      phase ^= 1u;
    } else {
      for (uint32_t o = 16u * lane; o < span; o += 16u * kWarp) chunk(dst + o, a0 + o);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncwarp();
  }
};

// ---- P1, index order ----------------------------------------------------------

struct AsyncParams {
  const void* idx;  // int32 or int64
  char* out;
  Span x;
  int64_t e, row_bytes;
  int tile, rows_per_warp, piece_bytes, pieces, slot_bytes, stage_rows, stage_bytes, warp_smem;
  int words;
};

// A warp's shared memory: kStages stages of stage_bytes, one mbarrier a
// stage, and each staged row's offset in its slot.
struct AsyncRing {
  char* stages;
  uint64_t* bars;  // (kStages)
  int* offs;       // (kStages, kMaxStageRows)

  __device__ __forceinline__ AsyncRing(char* base, int stage_bytes) {
    stages = base;
    bars = reinterpret_cast<uint64_t*>(base + p1::kStages * stage_bytes);
    offs = reinterpret_cast<int*>(bars + p1::kStages);
  }
};

// Stage s of this warp's rows [a, b): stage_rows rows (or one row's piece).
template <typename IdxT>
struct AsyncStream {
  int64_t a, b;
  int64_t n_stages;

  __device__ __forceinline__ void rows(const AsyncParams& p, int64_t s, int64_t& r0, int& n,
                                       int& piece) const {
    if (p.pieces > 1) {
      r0 = a + s / p.pieces;
      piece = static_cast<int>(s % p.pieces);
      n = 1;
    } else {
      r0 = a + s * p.stage_rows;
      piece = 0;
      n = static_cast<int>(min64(p.stage_rows, b - r0));
    }
  }

  // Fill stage s (ring slot s % kStages) and commit its cp.async group;
  // past the last stage, only arrive and commit. The stage's mbarrier
  // expects one arrival, lane 0's, with the bytes of every row's TMA copy;
  // copies by cp.async land in the stage's group.
  template <bool kWhole>
  __device__ __forceinline__ void issue(const AsyncParams& p, const AsyncRing& ring,
                                        int64_t s) const {
    const int lane = threadIdx.x % kWarp;
    const int slot = static_cast<int>(s % p1::kStages);
    uint64_t* bar = ring.bars + slot;
    char* stage = ring.stages + slot * p.stage_bytes;
    if (s >= n_stages) {
      if (lane == 0) mbar_arrive(bar);
      cp_async_commit();
      return;
    }
    int64_t r0;
    int n, piece;
    rows(p, s, r0, n, piece);
    const int64_t c0 = static_cast<int64_t>(piece) * p.piece_bytes;
    const int pb = static_cast<int>(min64(p.piece_bytes, p.row_bytes - c0));
    // lane j < n: row r0 + j's source bytes
    uint64_t src = 0;
    if (lane < n)
      src = p.x.lo + static_cast<uint64_t>(static_cast<const IdxT*>(p.idx)[r0 + lane]) *
                         p.row_bytes + c0;
    const int off = static_cast<int>(src & 15u);
    if (!kWhole && lane < n) ring.offs[slot * p1::kMaxStageRows + lane] = off;
    const uint32_t span = static_cast<uint32_t>((off + pb + 15) & ~15);
    if (p.slot_bytes >= k1::kBulkMinBytes) {  // one TMA copy a row, by its lane
      char* to = stage + lane * p.slot_bytes;
      const bool tma = lane < n && p.x.bulk(src - off, span);
      if (lane < n && !tma)  // a span at x's first or last bytes: by this lane
        for (uint32_t o = 0; o < span; o += 16) p.x.chunk(to + o, src - off + o);
      cp_async_commit();
      const uint32_t bytes = __reduce_add_sync(kFull, tma ? span : 0u);
      if (lane == 0) mbar_arrive_tx(bar, bytes);  // the bytes expected before any copy
      __syncwarp();
      if (tma) bulk_copy(to, src - off, span, bar);
      return;
    }
    // 16-byte chunks over the lanes: chunk q is row q / width's chunk q % width
    const int width = p.slot_bytes / 16;
    const int total = n * width;
    for (int q0 = 0; q0 < total; q0 += kWarp) {
      const int q = q0 + lane, j = q / width, i = q % width;
      const uint64_t sj = __shfl_sync(kFull, src, j < n ? j : 0);
      if (q < total) {
        const int oj = static_cast<int>(sj & 15u);
        if (i < ((oj + pb + 15) >> 4)) p.x.chunk(stage + j * p.slot_bytes + 16 * i, sj - oj + 16u * i);
      }
    }
    cp_async_commit();
    if (lane == 0) mbar_arrive(bar);
  }
};

// Each warp takes its slice of the block's `tile` rows and streams it: the
// first kStages - 1 stages are issued up front; after stage s goes out, the
// slot of stage s - 1 (whose bulk store has read it by then) takes stage
// s + kStages - 1.
template <bool kWhole, typename IdxT>
__global__ void __launch_bounds__(kWarp * p1::kAsyncWarps)
row_gather_async_kernel(const __grid_constant__ AsyncParams p) {
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const AsyncRing ring(smem + w * p.warp_smem, p.stage_bytes);
  if (lane == 0)
    for (int b = 0; b < p1::kStages; ++b) mbar_init(ring.bars + b, 1);
  mbar_init_fence();
  __syncwarp();
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * p.tile;
  const int64_t t1 = min64(t0 + p.tile, p.e);
  AsyncStream<IdxT> st;
  st.a = min64(t0 + static_cast<int64_t>(w) * p.rows_per_warp, t1);
  st.b = min64(st.a + p.rows_per_warp, t1);
  if (st.a == st.b) return;  // uniform across the warp
  st.n_stages = p.pieces > 1 ? (st.b - st.a) * p.pieces
                             : (st.b - st.a + p.stage_rows - 1) / p.stage_rows;
  for (int64_t s = 0; s < p1::kStages - 1; ++s) st.template issue<kWhole>(p, ring, s);
  for (int64_t s = 0; s < st.n_stages; ++s) {
    const int slot = static_cast<int>(s % p1::kStages);
    mbar_wait(ring.bars + slot, static_cast<uint32_t>(s / p1::kStages) & 1u);
    cp_async_wait<p1::kStages - 2>();  // stage s's group: kStages - 2 were committed after it
    __syncwarp();
    int64_t r0;
    int n, piece;
    st.rows(p, s, r0, n, piece);
    const int64_t c0 = static_cast<int64_t>(piece) * p.piece_bytes;
    const int pb = static_cast<int>(min64(p.piece_bytes, p.row_bytes - c0));
    const char* stage = ring.stages + slot * p.stage_bytes;
    char* dst = p.out + r0 * p.row_bytes + c0;
    if constexpr (kWhole) {  // the stage is out's image: one bulk store
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) {
        bulk_store(reinterpret_cast<uint64_t>(dst), stage, static_cast<uint32_t>(n * pb));
        bulk_commit();
        bulk_wait_read<1>();  // stage s - 1's store has read its slot
      }
    } else {  // by the lanes, a 16-byte word of one row each at a time
      const int* offs = ring.offs + slot * p1::kMaxStageRows;
      store_words<false>(
          n, p.words, pb,
          [&](int j) { return reinterpret_cast<uint64_t>(dst) + static_cast<uint64_t>(j) * p.row_bytes; },
          [&](int j) { return stage + j * p.slot_bytes + offs[j]; });
    }
    __syncwarp();
    st.template issue<kWhole>(p, ring, s + p1::kStages - 1);
  }
  if (kWhole && lane == 0) bulk_wait<0>();
}

// ---- P1, source order ---------------------------------------------------------

struct SourceParams {
  const char* x;
  Span xs;
  const void* indptr;  // int32 or int64
  const void* pos;     // int32 or int64, or null: slot k is output row k
  char* out;
  int64_t n_rows, row_bytes, long_t, n_long, n_chunks;
  const int64_t* rows;
  const int64_t* chunk_ptr;
  const int64_t* chunks;
  int64_t period, chunk;
  int piece_bytes, pieces, repeat, warp_smem, windows;
  int aligned;  // x, out and the rows' bytes on 16 bytes: every word whole
};

// A warp's shared memory: the staged piece, the row repeated (pos = null),
// and one mbarrier.
struct SourceRing {
  char* stage;
  char* rep;
  uint64_t* bar;

  __device__ __forceinline__ SourceRing(char* base, int warp_smem) {
    stage = base;
    rep = base + p1::kPieceBytes;
    bar = reinterpret_cast<uint64_t*>(base + warp_smem - 16);
  }
};

// Slots [begin, end) of the staged piece at `src` (pb bytes from column
// byte c0): 32 slots at a time, their positions read at once and shared by
// shuffle, their 16-byte words one a lane (store_words).
template <bool kAligned, typename PosT>
__device__ __forceinline__ void store_slots(const SourceParams& p, const char* src, int pb,
                                            int64_t c0, int64_t begin, int64_t end) {
  const int lane = threadIdx.x % kWarp;
  const PosT* pos = static_cast<const PosT*>(p.pos);
  const uint64_t out = reinterpret_cast<uint64_t>(p.out) + c0;
  const int nw = kAligned ? pb / 16 : p.windows;
  for (int64_t k0 = begin; k0 < end; k0 += kWarp) {
    const int cnt = static_cast<int>(min64(kWarp, end - k0));
    long long mine = 0;
    if (lane < cnt) mine = pos != nullptr ? static_cast<long long>(pos[k0 + lane]) : k0 + lane;
    store_words<kAligned>(
        cnt, nw, pb,
        [&](int j) { return out + __shfl_sync(kFull, mine, j) * p.row_bytes; },
        [&](int) { return src; });
  }
}

// Slots [begin, end) with pos = null and the row in one piece: one
// contiguous range of out, the row repeated. The row is laid out repeated in
// the warp's buffer so that buffer byte u holds row byte (u - δ) mod
// row_bytes, δ the range's offset from 16 bytes: then every period from the
// first 16-byte boundary of the range starts at the same buffer offset u0,
// and the range's body goes out by bulk stores of up to `chunk` bytes from
// there. Head and tail by lanes 0 and 1.
__device__ __forceinline__ void store_repeated(const SourceParams& p, const SourceRing& ring,
                                               const char* src, int64_t begin, int64_t end) {
  const int lane = threadIdx.x % kWarp;
  const int64_t rb = p.row_bytes, len = (end - begin) * rb;
  const uint64_t d = reinterpret_cast<uint64_t>(p.out) + begin * rb;
  const int delta = static_cast<int>(d & 15u);
  const p1::Split sp = p1::split16(d, len);
  const int64_t u0 = (sp.head + delta) % p.period;
  const int64_t fill = min64(p.chunk, sp.body);
  if (lane == 0) bulk_wait_read<0>();  // the last row's stores have read the buffer
  __syncwarp();
  // units of g bytes: g divides the row's bytes, δ, u0 and the staged row's offset
  const int g = low16(static_cast<uint64_t>(rb) | reinterpret_cast<uintptr_t>(src));
  const int64_t step = (static_cast<int64_t>(kWarp) * g) % rb;
  int64_t t = ((u0 + static_cast<int64_t>(lane) * g - delta) % rb + rb) % rb;
  for (int64_t u = u0 + static_cast<int64_t>(lane) * g; u < u0 + fill; u += kWarp * g) {
    char* to = ring.rep + u;
    const char* from = src + t;
    if (g == 16) {
      copy_vec<16>(to, from);
    } else if (g == 8) {
      copy_vec<8>(to, from);
    } else if (g == 4) {
      copy_vec<4>(to, from);
    } else {
      copy_vec<2>(to, from);
    }
    t += step;
    if (t >= rb) t -= rb;
  }
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) {
    for (int64_t o = sp.head; o < sp.head + sp.body; o += p.chunk)
      bulk_store(d + o, ring.rep + u0, static_cast<uint32_t>(min64(p.chunk, sp.head + sp.body - o)));
    bulk_commit();
  }
  // head [0, head) and tail [head + body, len): at most 15 bytes each
  const int64_t o = lane == 0 ? 0 : sp.head + sp.body;
  const int n = static_cast<int>(lane == 0 ? sp.head : sp.tail);
  if (lane < 2 && n > 0) {
    const int w = low16(d + o | static_cast<uint64_t>(n) | static_cast<uint64_t>(rb) |
                        reinterpret_cast<uintptr_t>(src) | 8u);
    for (int k = 0; k < n; k += w)
      copy_bytes(reinterpret_cast<char*>(d + o + k), src + (o + k) % rb, w);
  }
}

// Row r of x stored to slots [begin, end): each piece staged once, then
// stored to every slot (by bulk stores where `repeat` allows).
template <typename PosT>
__device__ __forceinline__ void walk_row(const SourceParams& p, const SourceRing& ring,
                                         int64_t r, int64_t begin, int64_t end,
                                         uint32_t& phase) {
  const int lane = threadIdx.x % kWarp;
  for (int piece = 0; piece < p.pieces; ++piece) {
    const int64_t c0 = static_cast<int64_t>(piece) * p.piece_bytes;
    const int pb = static_cast<int>(min64(p.piece_bytes, p.row_bytes - c0));
    const uint64_t a = reinterpret_cast<uint64_t>(p.x) + r * p.row_bytes + c0;
    const int off = static_cast<int>(a & 15u);
    p.xs.stage(ring.stage, a - off, static_cast<uint32_t>((off + pb + 15) & ~15), ring.bar, phase,
               lane);
    if (p.repeat && (end - begin) * p.row_bytes >= p1::kBulkStoreMin) {
      store_repeated(p, ring, ring.stage + off, begin, end);
    } else if (p.aligned) {
      store_slots<true, PosT>(p, ring.stage + off, pb, c0, begin, end);
    } else {
      store_slots<false, PosT>(p, ring.stage + off, pb, c0, begin, end);
    }
    __syncwarp();  // the stage is refilled next
  }
}

// out[pos[k]] = x[r] (out[k] = x[r] without pos) for every slot k of row r.
// The first n_chunks blocks take one chunk of a long row each, the others
// kWarpsPerBlock rows each (a row of more than long_t slots is its chunks'
// work). Every warp reads the block's items itself (lane i holds item i), so
// the warps need no barrier. Warp w walks item w whole when it writes at
// most kShortBytes; the block's longer items are laid end to end and every
// warp walks an equal slice of them.
template <typename IptrT, typename PosT>
__global__ void __launch_bounds__(kWarp * warp_csr::kWarpsPerBlock)
row_gather_by_source_kernel(const __grid_constant__ SourceParams p) {
  constexpr int kItems = warp_csr::kWarpsPerBlock;
  extern __shared__ __align__(16) char smem[];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const SourceRing ring(smem + w * p.warp_smem, p.warp_smem);
  if (lane == 0) mbar_init(ring.bar, 1);
  mbar_init_fence();
  __syncwarp();
  uint32_t phase = 0;
  const IptrT* indptr = static_cast<const IptrT*>(p.indptr);
  const bool chunk_block = blockIdx.x < p.n_chunks;
  const int n_items = chunk_block ? 1 : kItems;
  long long r = 0, begin = 0, len = 0;  // lane i: item i
  if (chunk_block) {
    if (lane == 0) {
      const int64_t k = blockIdx.x;
      begin = p.chunks[2 * k];
      len = p.chunks[2 * k + 1] - begin;
      r = p.rows[warp_csr::chunk_owner(p.chunk_ptr, p.n_long, k)];
    }
  } else {
    const int64_t r0 = (static_cast<int64_t>(blockIdx.x) - p.n_chunks) * kItems;
    long long off = 0;  // lanes 0..kItems read the block's kItems + 1 offsets
    if (lane <= kItems && r0 + lane <= p.n_rows) off = static_cast<long long>(indptr[r0 + lane]);
    const long long next = __shfl_down_sync(kFull, off, 1);
    if (lane < kItems && r0 + lane < p.n_rows) {
      r = r0 + lane;
      begin = off;
      len = next - off;
      if (len > p.long_t) len = 0;  // a long row: its chunks write it
    }
  }
  const int64_t short_len = kShortBytes / p.row_bytes > 0 ? kShortBytes / p.row_bytes : 1;
  const long long my_len = __shfl_sync(kFull, len, w);
  const long long my_r = __shfl_sync(kFull, r, w);
  const long long my_begin = __shfl_sync(kFull, begin, w);
  if (w < n_items && my_len > 0 && my_len <= short_len)
    walk_row<PosT>(p, ring, my_r, my_begin, my_begin + my_len, phase);
  const long long long_len = len > short_len ? len : 0;  // the items shared by every warp
  long long total = long_len;
#pragma unroll
  for (int o = 1; o < kItems; o <<= 1) total += __shfl_xor_sync(kFull, total, o);
  total = __shfl_sync(kFull, total, 0);
  const int64_t share = (total + kItems - 1) / kItems;
  const int64_t lo = min64(total, w * share), hi = min64(total, lo + share);
  int64_t at = 0;
  for (int i = 0; i < n_items && at < hi; ++i) {
    const int64_t li = __shfl_sync(kFull, long_len, i);
    const int64_t a = lo > at ? lo : at;
    const int64_t b = min64(hi, at + li);
    if (a < b) {
      const int64_t bi = __shfl_sync(kFull, begin, i);
      walk_row<PosT>(p, ring, __shfl_sync(kFull, r, i), bi + (a - at), bi + (b - at), phase);
    }
    at += li;
  }
  if (p.repeat && lane == 0) bulk_wait<0>();
}

// ---- P2 ---------------------------------------------------------------------

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

template <typename Kernel, typename Params>
cudaError_t launch(Kernel kernel, unsigned blocks, unsigned threads, size_t smem, const Params& p,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers;
// row_bytes is even (float32 or bfloat16 rows); n is x's row count. Each
// returns the launch's cudaError_t (0 on success), or cudaErrorInvalidValue
// for what the kernel does not take.
extern "C" int row_gather_async(const void* x, long long n, const void* idx, int idx_is_int64,
                                void* out, long long e, long long row_bytes, int tile,
                                void* stream) {
  if (e <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  p1::AsyncGeometry g;
  if (tile <= 0 || !p1::async_geometry(row_bytes, reinterpret_cast<uint64_t>(x),
                                       reinterpret_cast<uint64_t>(out), g))
    return static_cast<int>(cudaErrorInvalidValue);
  AsyncParams p;
  p.idx = idx;
  p.out = static_cast<char*>(out);
  p.x.lo = reinterpret_cast<uint64_t>(x);
  p.x.hi = p.x.lo + static_cast<uint64_t>(n) * static_cast<uint64_t>(row_bytes);
  p.e = e;
  p.row_bytes = row_bytes;
  p.tile = tile;
  p.rows_per_warp = (tile + p1::kAsyncWarps - 1) / p1::kAsyncWarps;
  p.piece_bytes = g.piece_bytes;
  p.pieces = g.pieces;
  p.slot_bytes = g.slot_bytes;
  p.stage_rows = g.stage_rows;
  p.stage_bytes = g.stage_bytes;
  p.warp_smem = g.warp_smem;
  p.words = g.words;
  const unsigned blocks = static_cast<unsigned>((e + tile - 1) / tile);
  const size_t smem = static_cast<size_t>(g.warp_smem) * p1::kAsyncWarps;
  auto s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto whole) {
    constexpr bool kWhole = decltype(whole)::value;
    return idx_is_int64
               ? launch(row_gather_async_kernel<kWhole, int64_t>, blocks, kWarp * p1::kAsyncWarps,
                        smem, p, s)
               : launch(row_gather_async_kernel<kWhole, int32_t>, blocks, kWarp * p1::kAsyncWarps,
                        smem, p, s);
  };
  return static_cast<int>(g.whole ? go(std::true_type{}) : go(std::false_type{}));
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
// with pos null), x of n_rows rows. The row split: rows of more than long_t
// slots are the n_long `rows`, whose chunks [chunks[2k], chunks[2k+1]) are
// chunk_ptr[i]..chunk_ptr[i+1]; without a split long_t is above every row
// and n_chunks 0.
extern "C" int row_gather_by_source(const void* x, const void* indptr, int indptr_is_int64,
                                    const void* pos, int pos_is_int64, void* out,
                                    long long n_rows, long long row_bytes, long long long_t,
                                    const void* rows, const void* chunk_ptr, long long n_long,
                                    const void* chunks, long long n_chunks, void* stream) {
  if (n_rows <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  p1::SourceGeometry g;
  if (!p1::source_geometry(row_bytes, pos != nullptr, g))
    return static_cast<int>(cudaErrorInvalidValue);
  SourceParams p;
  p.x = static_cast<const char*>(x);
  p.xs.lo = reinterpret_cast<uint64_t>(x);
  p.xs.hi = p.xs.lo + static_cast<uint64_t>(n_rows) * static_cast<uint64_t>(row_bytes);
  p.indptr = indptr;
  p.pos = pos;
  p.out = static_cast<char*>(out);
  p.n_rows = n_rows;
  p.row_bytes = row_bytes;
  p.long_t = long_t;
  p.n_long = n_long;
  p.n_chunks = n_chunks;
  p.rows = static_cast<const int64_t*>(rows);
  p.chunk_ptr = static_cast<const int64_t*>(chunk_ptr);
  p.chunks = static_cast<const int64_t*>(chunks);
  p.period = g.period;
  p.chunk = g.chunk;
  p.piece_bytes = g.piece_bytes;
  p.pieces = g.pieces;
  // bulk stores need out on 16 bytes (the range's offsets then follow the rows')
  p.repeat = g.repeat && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  p.warp_smem = g.warp_smem;
  p.windows = static_cast<int>(
      p1::words(g.piece_bytes, align16(reinterpret_cast<uint64_t>(out), static_cast<uint64_t>(row_bytes))));
  p.aligned = align16(reinterpret_cast<uint64_t>(x) | reinterpret_cast<uint64_t>(out),
                      static_cast<uint64_t>(row_bytes)) == 16;
  const unsigned blocks = static_cast<unsigned>(n_chunks + warp_csr::grid_for(n_rows).x);
  const size_t smem = static_cast<size_t>(g.warp_smem) * warp_csr::kWarpsPerBlock;
  auto s = static_cast<cudaStream_t>(stream);
  const unsigned threads = kWarp * warp_csr::kWarpsPerBlock;
  auto with_pos = [&](auto ip) {
    using IptrT = std::remove_pointer_t<decltype(ip)>;
    return pos_is_int64
               ? launch(row_gather_by_source_kernel<IptrT, int64_t>, blocks, threads, smem, p, s)
               : launch(row_gather_by_source_kernel<IptrT, int32_t>, blocks, threads, smem, p, s);
  };
  return static_cast<int>(indptr_is_int64 ? with_pos(static_cast<const int64_t*>(nullptr))
                                          : with_pos(static_cast<const int32_t*>(nullptr)));
}
