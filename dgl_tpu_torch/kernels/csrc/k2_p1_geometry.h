// K2's and P1's geometry (seg_sum.cu, row_gather.cu): how a launch's
// shared-memory stages, lane layout and runs are sized, and how P1 splits a
// destination into its stores. Plain C++ with no CUDA, like k1_geometry.h,
// whose run arithmetic K2 shares: the kernels' libraries size every launch
// with these functions, and the CPU tests
// (tests/test_torch_k2_p1_geometry.py) compile this file alone with g++ and
// call its C entry points. Include it in one translation unit of a library.

#ifndef DGL_TPU_TORCH_K2_P1_GEOMETRY_H_
#define DGL_TPU_TORCH_K2_P1_GEOMETRY_H_

#include <stdint.h>

#include "k1_geometry.h"

// P1's slot split runs on the card too (row_gather.cu)
#ifdef __CUDACC__
#define K2P1_HD __host__ __device__
#else
#define K2P1_HD
#endif

// The alignment (a power of two, at most 16) that address a and count b
// share.
inline int align16(uint64_t a, uint64_t b) {
  const uint64_t m = a | b | 16u;
  return static_cast<int>(m & (~m + 1));
}

inline int64_t round16(int64_t a) { return (a + 15) / 16 * 16; }

namespace k2 {

// Two stages of 2 KB a warp and 8 blocks of 4 warps an SM (at most 64
// registers a thread): of 2, 3 and 4 stages at 6 or 8 blocks, and 4 KB
// stages, the fastest on the card at reddit's (E, 16) in float32 and
// bfloat16 (PERF.md): more warps beat more stages a warp.
constexpr int kStages = 2;         // stages a warp keeps in flight
constexpr int kStageBytes = 2048;  // a stage's messages, at the least
constexpr int kMinBlocks = 8;      // blocks an SM (the kernel's launch bound)
constexpr int kWarps = 4;          // warps a block
constexpr int kAccFloats = 16;     // float sums a lane
constexpr int64_t kRunUnitsMin = 16;  // rows plus edges a run warp takes, at the least

struct Geometry {
  int align;        // the alignment every message row start shares (at most 16)
  int vec;          // values a lane reads of a staged row at once: align bytes
  int piece_cols;   // columns a walk (rows wider than 32·kAccFloats values: pieces)
  int pieces;
  int lanes;        // lanes a staged row: 32 / lanes rows a pass
  int vecs;         // vectors a lane sums
  int stage_bytes;  // a stage's buffer: the 16-byte-aligned span of its rows
  int stage_rows;   // message rows a stage holds (1 where a row runs in pieces)
  int warp_smem;    // a warp's shared memory (seg_sum.cu: Ring)
  int64_t run_units, n_runs;
};

// The geometry of messages (n_edges rows of d values of elem_bytes bytes at
// address msg) over a CSR of n_rows rows. False for what the kernel does
// not take.
//
// A run's messages are one contiguous span of msg, so a stage is `n`
// consecutive message rows, [a, a + n·row_bytes), copied as the
// 16-byte-aligned span that covers it: its offset in the span is at most
// 16 - align, so n·row_bytes + 16 - align bytes must fit stage_bytes. A
// piece of a wider row is a stage of its own, one row's piece_cols columns
// (a multiple of 16 bytes, so each piece starts as its row does).
inline bool geometry(int d, int elem_bytes, uint64_t msg, int64_t n_rows, int64_t n_edges,
                     Geometry& g) {
  if (d < 1 || (elem_bytes != 2 && elem_bytes != 4) || n_rows < 0 || n_edges < 0) return false;
  const int64_t row_bytes = static_cast<int64_t>(d) * elem_bytes;
  g.align = align16(msg, static_cast<uint64_t>(row_bytes));
  g.vec = g.align / elem_bytes > 0 ? g.align / elem_bytes : 1;
  const int n_pieces = static_cast<int>(k1::ceil_div(d, 32 * kAccFloats));
  const int q = 16 / elem_bytes;
  g.piece_cols =
      n_pieces == 1 ? d : static_cast<int>(k1::ceil_div(k1::ceil_div(d, n_pieces), q) * q);
  g.pieces = static_cast<int>(k1::ceil_div(d, g.piece_cols));
  const int nvec = g.piece_cols / g.vec;
  g.lanes = 1;
  while (g.lanes < nvec && g.lanes < 32) g.lanes <<= 1;
  g.vecs = static_cast<int>(k1::ceil_div(nvec, g.lanes));
  const int64_t piece_span = round16(static_cast<int64_t>(g.piece_cols) * elem_bytes + 16 - g.align);
  g.stage_bytes = static_cast<int>(piece_span > kStageBytes ? piece_span : kStageBytes);
  g.stage_rows = g.pieces > 1 ? 1 : static_cast<int>((g.stage_bytes - (16 - g.align)) / row_bytes);
  // the stages, an mbarrier, a row count and an offset a stage (seg_sum.cu: Ring)
  g.warp_smem = static_cast<int>(round16(kStages * (g.stage_bytes + 8 + 4 + 4)));
  k1::runs(n_rows, n_edges, kRunUnitsMin, g.run_units, g.n_runs);
  // the sums fit a lane's accumulators, a lane reads at most 16 bytes, the
  // block fits Hopper's shared memory
  return g.vecs * g.vec <= kAccFloats && g.vec * elem_bytes <= 16 && g.stage_rows >= 1 &&
         kWarps * g.warp_smem <= k1::kSmemLimit;
}

}  // namespace k2

namespace p1 {

constexpr int kStages = 4;            // index order: stages a warp keeps in flight
constexpr int kStageBytes = 2048;     // index order: a stage, at the least
constexpr int kWideStageBytes = 4096; // index order: the most a stage of one wide row takes
constexpr int kPieceBytes = 2048;     // source order: a staged piece, its span included
constexpr int kRepeatBytes = 2048;    // source order: the row repeated, for bulk stores
constexpr int kMaxStageRows = 32;     // index order: rows a stage (one a lane)
constexpr int kAsyncWarps = 4;        // index order: warps a block
constexpr int kBulkStoreMin = 1024;   // source order: ranges of this many bytes up go by bulk stores

// A destination [dst, dst + bytes) cut at 16-byte boundaries: its head up to
// the first boundary, its body of whole 16-byte words, its tail. A range
// inside one word is all head.
struct Split {
  int64_t head, body, tail;
};

K2P1_HD inline Split split16(uint64_t dst, int64_t bytes) {
  int64_t head = static_cast<int64_t>((16 - (dst & 15u)) & 15u);
  if (head > bytes) head = bytes;
  const int64_t body = (bytes - head) / 16 * 16;
  return {head, body, bytes - head - body};
}

// The most 16-byte words a destination of `bytes` touches when it starts
// at an alignment of `align` (its offset from 16 bytes at most 16 - align).
inline int64_t words(int64_t bytes, int align) { return (16 - align + bytes + 15) / 16; }

// The period of a row of row_bytes repeated: lcm(row_bytes, 16), the least
// length after which both the row and the 16-byte words start again.
inline int64_t period(int64_t row_bytes) {
  int64_t a = row_bytes, b = 16;
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return row_bytes / a * 16;
}

// Index order: `tile` output rows a block, cut into one contiguous slice a
// warp, streamed through a ring of kStages stages of stage_bytes: 2 KB, or
// one row's span up to 4 KB where a row needs more (4 KB stages for every
// row cost 64-byte rows occupancy on the card; PERF.md). `whole`: rows of a
// multiple of 16 bytes at 16-byte-aligned x and out, so a row's span is the
// row, a stage's rows are laid out as out holds them and go out by one bulk
// store; else each row sits in a slot of its span's size at its offset and
// the lanes store its `words` 16-byte words. `vec`: the alignment x, out
// and the rows' bytes share. A row wider than a stage runs as pieces, one
// a stage.
// `bulk`: rows come in by TMA bulk copies (spans of kBulkMinBytes up), else
// by 16-byte cp.async copies over the lanes.
struct AsyncGeometry {
  int whole, bulk, vec;
  int words;                // 16-byte words a row (piece) touches in out
  int piece_bytes, pieces;  // bytes of a row a stage, a multiple of 16 but the last
  int slot_bytes;           // a staged row (piece) in the ring
  int stage_rows;           // rows a stage
  int stage_bytes;          // a stage: kStageBytes, or one wide row's slot
  int warp_smem;            // a warp's shared memory (row_gather.cu: AsyncRing)
};

inline bool async_geometry(int64_t row_bytes, uint64_t x, uint64_t out, AsyncGeometry& g) {
  if (row_bytes < 2 || row_bytes % 2) return false;
  const int ax = align16(x, static_cast<uint64_t>(row_bytes));
  g.vec = align16(x | out, static_cast<uint64_t>(row_bytes));
  g.whole = ax == 16 && g.vec == 16;
  const int64_t pad = g.whole ? 0 : 16;  // a span's offset from 16 bytes, at most
  const int64_t most = (row_bytes + pad <= kWideStageBytes ? kWideStageBytes : kStageBytes) - pad;
  g.piece_bytes = static_cast<int>(row_bytes < most ? row_bytes : most);
  g.pieces = static_cast<int>(k1::ceil_div(row_bytes, g.piece_bytes));
  g.slot_bytes = static_cast<int>(g.whole ? g.piece_bytes : round16(g.piece_bytes + 16 - ax));
  g.stage_bytes = g.slot_bytes > kStageBytes ? g.slot_bytes : kStageBytes;
  const int rows = g.stage_bytes / g.slot_bytes;
  g.stage_rows = g.pieces > 1 ? 1 : rows < kMaxStageRows ? rows : kMaxStageRows;
  g.bulk = g.slot_bytes >= k1::kBulkMinBytes;
  g.words = static_cast<int>(words(g.piece_bytes, align16(out, static_cast<uint64_t>(row_bytes))));
  g.warp_smem = static_cast<int>(round16(kStages * (g.stage_bytes + 8 + 4 * kMaxStageRows)));
  return g.stage_rows >= 1 && kAsyncWarps * g.warp_smem <= k1::kSmemLimit;
}

// Source order: a warp stages a row of x (or a piece of it) once and stores
// it to each of its slots. A piece is at most kPieceBytes - 16 bytes (a
// multiple of 16 but the last), so its span fits the stage. `repeat`: a
// row's slots are one contiguous range of out (no positions) and one piece,
// and its period fits the repeat buffer beside the stage: the row is laid
// out repeated there and the range's 16-byte-aligned body goes out by bulk
// stores of `chunk` bytes (a multiple of the period), each from the same
// place in the buffer.
struct SourceGeometry {
  int piece_bytes, pieces;
  int repeat;
  int64_t period, chunk;
  int warp_smem;  // a warp's shared memory (row_gather.cu: SourceRing)
};

inline bool source_geometry(int64_t row_bytes, int has_pos, SourceGeometry& g) {
  if (row_bytes < 2 || row_bytes % 2) return false;
  const int64_t most = kPieceBytes - 16;
  g.piece_bytes = static_cast<int>(row_bytes < most ? row_bytes : most);
  g.pieces = static_cast<int>(k1::ceil_div(row_bytes, g.piece_bytes));
  g.period = period(row_bytes);
  g.chunk = (kRepeatBytes - 16) / g.period * g.period;
  g.repeat = !has_pos && g.pieces == 1 && g.chunk > 0;
  g.warp_smem = kPieceBytes + (g.repeat ? kRepeatBytes : 0) + 16;
  return k1::kSmemLimit >= 8 * g.warp_smem;
}

}  // namespace p1

// The geometries as numbers, for the CPU tests. Each returns 0, or 1 (out
// unwritten) for what the kernel does not take.
//   seg_sum_geometry: align, vec, piece_cols, pieces, lanes, vecs,
//     stage_bytes, stage_rows, warp_smem, block_smem, run_units, n_runs;
//   row_gather_async_geometry: whole, bulk, vec, words, piece_bytes, pieces,
//     slot_bytes, stage_rows, stage_bytes, warp_smem, block_smem;
//   row_gather_source_geometry: piece_bytes, pieces, repeat, period, chunk,
//     warp_smem;
//   slot_split16: head, body, tail of [dst, dst + bytes).
extern "C" int seg_sum_geometry(int d, int elem_bytes, unsigned long long msg, long long n_rows,
                                long long n_edges, long long* out) {
  k2::Geometry g;
  if (!k2::geometry(d, elem_bytes, msg, n_rows, n_edges, g)) return 1;
  const long long v[12] = {g.align,      g.vec,        g.piece_cols, g.pieces,
                           g.lanes,      g.vecs,       g.stage_bytes, g.stage_rows,
                           g.warp_smem,  static_cast<long long>(k2::kWarps) * g.warp_smem,
                           g.run_units,  g.n_runs};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

extern "C" int row_gather_async_geometry(long long row_bytes, unsigned long long x,
                                         unsigned long long out_base, long long* out) {
  p1::AsyncGeometry g;
  if (!p1::async_geometry(row_bytes, x, out_base, g)) return 1;
  const long long v[11] = {g.whole,       g.bulk,   g.vec,        g.words,
                           g.piece_bytes, g.pieces, g.slot_bytes, g.stage_rows,
                           g.stage_bytes, g.warp_smem,
                           static_cast<long long>(p1::kAsyncWarps) * g.warp_smem};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

extern "C" int row_gather_source_geometry(long long row_bytes, int has_pos, long long* out) {
  p1::SourceGeometry g;
  if (!p1::source_geometry(row_bytes, has_pos, g)) return 1;
  const long long v[6] = {g.piece_bytes, g.pieces, g.repeat, g.period, g.chunk, g.warp_smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

extern "C" void slot_split16(unsigned long long dst, long long bytes, long long* out) {
  const p1::Split s = p1::split16(dst, bytes);
  out[0] = s.head;
  out[1] = s.body;
  out[2] = s.tail;
}

#endif  // DGL_TPU_TORCH_K2_P1_GEOMETRY_H_
