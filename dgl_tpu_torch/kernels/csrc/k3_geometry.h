// K3's geometry (gat_attention.cu): how one pass's shared-memory ring,
// copy route, lane layout, heads and runs of rows are sized from the heads,
// the head width, the value's bytes, the alignment of the gathered rows and
// the CSR's counts. Plain C++ with no CUDA, like k1_geometry.h, whose run
// arithmetic K3 shares: run_fwd and run_b2 in gat_attention.cu size every
// launch with k3::geometry, and the CPU tests
// (tests/test_torch_k3_geometry.py) compile this file alone with g++ and
// call its C entry points. Include it in one translation unit of a library.

#ifndef DGL_TPU_TORCH_K3_GEOMETRY_H_
#define DGL_TPU_TORCH_K3_GEOMETRY_H_

#include <stdint.h>

#include "k1_geometry.h"

// The head of a lane's vector runs on the card too (gat_attention.cu)
#ifdef __CUDACC__
#define K3_HD __host__ __device__
#else
#define K3_HD
#endif

namespace k3 {

enum Pass { kFwd = 0, kB2 = 1 };

constexpr int kStages = 4;            // stages of staged rows a warp keeps in flight
constexpr int kBlocks = kStages + 1;  // blocks of 32 indices a warp fetches ahead
constexpr int kAccFloats = 8;   // floats a lane sums in each of its pass's two sums
constexpr int kMaxVecs = 4;     // vectors a lane sums (at one value a vector: 4 floats)
constexpr int kMaxVec = 4;      // values a lane reads of a staged row at once
constexpr int kWarps = 4;       // warps a block
constexpr int kMinBlocks = 4;   // blocks an SM (the kernels' launch bound: 128 registers)
constexpr int kRingBytes = 8192;              // a warp's staged rows, all stages
// rows a stage: at least 4 (wider rows than 512 B take a ring of more than
// kRingBytes: four rows a stage ran arxiv's D = 40 and the products graph's
// H·D = 256 13-14 % faster than two on the card, PERF.md §6), at most one a
// lane
constexpr int kMinSlots = 4, kMaxSlots = 32;
constexpr int kBulkMinBytes = 144;  // spans of at least this many bytes: TMA bulk copies
constexpr int kMaxHeads = 32;       // heads a pass takes: a head's lanes are hp apart
constexpr int64_t kRunUnitsMin = 64;  // rows plus edges a run warp takes, at the least
constexpr int64_t kChunkPairsMin = 2048;  // plans of this many chunks or more: two a chunk warp

struct Geometry {
  int hp;          // heads rounded up to a power of two: lane l scores head l % hp
  int align;       // the alignment every gathered row start shares (at most 16)
  int vec;         // values a lane reads at once: align's values, at most kMaxVec,
                   // dividing d (so a vector lies in one head)
  int vecs;        // vectors a lane sums
  int piece_cols;  // columns of the H·D row a walk over the edges takes
  int pieces;
  int lanes;       // lanes a staged row: 32 / lanes rows a pass
  int slot_bytes;  // a staged row: the largest 16-byte span of a piece
  int slots;       // rows a stage
  int bulk;        // 1: one TMA bulk copy a row; 0: cp.async copies of 16 bytes over the lanes
  int edge_bytes;  // staged beside each row: its a_src (forward, 4·H) or node (b2, 16·H)
  int warp_smem;   // a warp's shared memory (gat_attention.cu: Ring)
  int64_t run_units, n_runs;  // rows plus edges a run warp takes; run warps
  int chunk_group;            // consecutive chunks of the row split a chunk warp walks
  int64_t n_chunk_blocks;     // the launch's first blocks: chunk_group chunks a warp
};

inline int lowbit(uint64_t m) { return static_cast<int>(m & (~m + 1)); }

// The head of the vector at column c (in vectors) of a piece that starts at
// value col0, `vec` values a vector: vec divides d and col0, so the vector's
// values lie in one head.
K3_HD inline int head_of(int col0, int c, int vec, int d) { return (col0 + c * vec) / d; }

// The geometry of one pass over rows of heads·d values of elem_bytes bytes
// at address x (the forward's v, b2's g), over a CSR of n_rows rows and
// n_edges edges whose row split has n_chunks chunks. False for what the
// kernels do not take.
//
// As K1's (k1_geometry.h): every row start shares the alignment of x and
// of the row's bytes, so a row's offset in its 16-byte span is at most
// 16 - align; rows wider than 32 lanes' sums (kMaxVecs vectors of vec
// values, at most kAccFloats) run in pieces of a multiple of 16 bytes (a
// lane of 8 vectors of one value took more than 128 registers and spilled). The vector width also divides d, so that each of a
// lane's vectors lies in one head and takes that head's weight: at an odd d
// (41, 47) a lane reads one value at a time. A stage stages beside each row
// the edge's H values of a_src (forward) or its H float4s of node (b2), and
// a block of a row's staged edges scores at most 32 (edge, head) pairs, one
// a lane. As K1's, a chunk warp walks two consecutive chunks as one stream
// on plans with chunks enough to fill the card (reddit's reverse CSR: 8,586),
// one where few chunk warps would each walk alone.
inline bool geometry(int pass, int heads, int d, int elem_bytes, uint64_t x, int64_t n_rows,
                     int64_t n_edges, int64_t n_chunks, Geometry& g) {
  if ((pass != kFwd && pass != kB2) || heads < 1 || heads > kMaxHeads || d < 1 ||
      (elem_bytes != 2 && elem_bytes != 4) || n_rows < 0 || n_edges < 0 || n_chunks < 0)
    return false;
  const int hd = heads * d;
  g.hp = 1;
  while (g.hp < heads) g.hp <<= 1;
  g.align = lowbit(x | static_cast<uint64_t>(hd) * static_cast<uint64_t>(elem_bytes) | 16u);
  g.vec = g.align / elem_bytes;
  if (g.vec > kMaxVec) g.vec = kMaxVec;
  if (g.vec > lowbit(static_cast<uint64_t>(d))) g.vec = lowbit(static_cast<uint64_t>(d));
  const int lane_vals = kMaxVecs * g.vec < kAccFloats ? kMaxVecs * g.vec : kAccFloats;
  const int n_pieces = static_cast<int>(k1::ceil_div(hd, 32 * lane_vals));
  const int q = 16 / elem_bytes;
  g.piece_cols = n_pieces == 1 ? hd : static_cast<int>(k1::ceil_div(k1::ceil_div(hd, n_pieces), q) * q);
  g.pieces = static_cast<int>(k1::ceil_div(hd, g.piece_cols));
  const int nvec = g.piece_cols / g.vec;
  g.lanes = 1;
  while (g.lanes < nvec && g.lanes < 32) g.lanes <<= 1;
  g.vecs = static_cast<int>(k1::ceil_div(nvec, g.lanes));
  g.slot_bytes = 16 * static_cast<int>(k1::ceil_div(g.piece_cols * elem_bytes + 16 - g.align, 16));
  const int slots = kRingBytes / (kStages * g.slot_bytes);
  g.slots = slots < kMinSlots ? kMinSlots : slots > kMaxSlots ? kMaxSlots : slots;
  g.bulk = g.slot_bytes >= kBulkMinBytes;
  g.edge_bytes = (pass == kFwd ? 4 : 16) * heads;
  // rows, the edges' a_src or node, one mbarrier a stage, the index blocks'
  // bounds, each staged row's offset and edge id, each stage's row count,
  // the blocks' indices and edge ids, a block's (edge, head) weights
  g.warp_smem = 16 * static_cast<int>(k1::ceil_div(
                         kStages * g.slots * (g.slot_bytes + g.edge_bytes) + kStages * 8 +
                             kBlocks * 8 + kStages * g.slots * 8 + kStages * 4 +
                             kBlocks * 32 * 8 + 32 * 8,
                         16));
  k1::runs(n_rows, n_edges, kRunUnitsMin, g.run_units, g.n_runs);
  g.chunk_group = n_chunks >= kChunkPairsMin ? 2 : 1;
  g.n_chunk_blocks = k1::ceil_div(k1::ceil_div(n_chunks, g.chunk_group), kWarps);
  // the sums fit a lane's accumulators, the cp.async route (spans under
  // kBulkMinBytes) has instantiations for 1 or 2 vectors a lane, the block
  // fits Hopper's shared memory
  return g.vecs <= kMaxVecs && g.vecs * g.vec <= kAccFloats && (g.bulk || g.vecs <= 2) &&
         kWarps * g.warp_smem <= k1::kSmemLimit;
}

}  // namespace k3

// The geometry as 17 numbers in out: hp, align, vec, vecs, piece_cols,
// pieces, lanes, slot_bytes, slots, bulk, edge_bytes, warp_smem,
// block_smem, run_units, n_runs, chunk_group, n_chunk_blocks. Returns 0, or
// 1 (out unwritten) for what the kernels do not take.
extern "C" int gat_attention_geometry(int pass, int heads, int d, int elem_bytes,
                                      unsigned long long x, long long n_rows, long long n_edges,
                                      long long n_chunks, long long* out) {
  k3::Geometry g;
  if (!k3::geometry(pass, heads, d, elem_bytes, x, n_rows, n_edges, n_chunks, g)) return 1;
  const long long v[17] = {g.hp,         g.align,      g.vec,
                           g.vecs,       g.piece_cols, g.pieces,
                           g.lanes,      g.slot_bytes, g.slots,
                           g.bulk,       g.edge_bytes, g.warp_smem,
                           static_cast<long long>(k3::kWarps) * g.warp_smem,
                           g.run_units,  g.n_runs,     g.chunk_group,
                           g.n_chunk_blocks};
  for (int i = 0; i < 17; ++i) out[i] = v[i];
  return 0;
}

// The head of each (lane column, vector) of piece `piece` of a row of
// heads·d values: out[col·vecs + t] for col < lanes, t < vecs, the head of
// the vector at column col + t·lanes, or -1 past the piece's end. Returns
// 0, or 1 (out unwritten) for what the kernels do not take.
extern "C" int gat_attention_lane_heads(int pass, int heads, int d, int elem_bytes,
                                        unsigned long long x, int piece, long long* out) {
  k3::Geometry g;
  if (!k3::geometry(pass, heads, d, elem_bytes, x, 1, 1, 0, g) || piece < 0 ||
      piece >= g.pieces)
    return 1;
  const int col0 = piece * g.piece_cols;
  const int cols = heads * d - col0 < g.piece_cols ? heads * d - col0 : g.piece_cols;
  const int nvec = cols / g.vec;
  for (int col = 0; col < g.lanes; ++col)
    for (int t = 0; t < g.vecs; ++t) {
      const int c = col + t * g.lanes;
      out[col * g.vecs + t] = c < nvec ? k3::head_of(col0, c, g.vec, d) : -1;
    }
  return 0;
}

#endif  // DGL_TPU_TORCH_K3_GEOMETRY_H_
