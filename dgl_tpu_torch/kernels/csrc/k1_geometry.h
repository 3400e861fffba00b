// K1's geometry (csr_spmm.cu): how one call's shared-memory ring, copy
// route, lane layout and runs of rows are sized from the row width, the
// value's bytes, the alignment of x and the CSR's counts. Plain C++ with no
// CUDA, so that the kernel's library and a host compiler build the same
// code: run() in csr_spmm.cu sizes every launch with k1::geometry, and the
// CPU tests (tests/test_torch_k1_geometry.py) compile this file alone with
// g++ and call csr_spmm_geometry. Include it in one translation unit of a
// library (it defines csr_spmm_geometry).

#ifndef DGL_TPU_TORCH_K1_GEOMETRY_H_
#define DGL_TPU_TORCH_K1_GEOMETRY_H_

#include <stdint.h>

namespace k1 {

constexpr int kStages = 4;            // stages of staged rows a warp keeps in flight
constexpr int kBlocks = kStages + 1;  // blocks of 32 indices a warp fetches ahead
constexpr int kAccFloats = 16;        // float sums a lane
constexpr int kMaxVec = 4;  // values a lane reads of a staged row at once (16 B of float, 8 of bf16)
constexpr int kWarps = 4;   // warps a block: small blocks pack an SM
constexpr int kRingBytes = 8192;              // a warp's staged rows, all stages
constexpr int kMinSlots = 2, kMaxSlots = 32;  // rows a stage: at least 2, at most one a lane
constexpr int kBulkMinBytes = 144;  // spans of at least this many bytes: TMA bulk copies
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may have on Hopper (227 KB)
constexpr int64_t kRunWarps = 8192;                         // run warps a launch aims at
constexpr int64_t kRunUnitsMin = 64, kRunUnitsMax = 4096;   // rows plus edges a run warp takes
constexpr int64_t kChunkPairsMin = 2048;  // plans of this many chunks or more: two a chunk warp

struct Geometry {
  int align;       // the alignment every row start shares (a power of two, at most 16)
  int vec;         // values a lane reads at once: align's values, at most kMaxVec
  int vecs;        // vectors a lane sums
  int piece_cols;  // columns a walk over the edges (rows wider than 32·kAccFloats: pieces)
  int pieces;
  int lanes;       // lanes a staged row: 32 / lanes rows a pass
  int slot_bytes;  // a staged row: the largest 16-byte span of a piece
  int slots;       // rows a stage
  int bulk;        // 1: one TMA bulk copy a row; 0: cp.async copies of 16 bytes over the lanes
  int warp_smem;   // a warp's shared memory (csr_spmm.cu: Ring)
  int64_t run_units, n_runs;  // rows plus edges a run warp takes; run warps
  int chunk_group;            // consecutive chunks of the row split a chunk warp walks
};

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Runs of consecutive rows over a CSR of n_rows rows and n_edges edges (K1's
// and K2's run warps): row r starts at unit r + indptr[r], and run warp i
// takes the rows that start in [i, i + 1)·run_units (found on the card by a
// search of indptr), so every warp walks about run_units rows plus edges and
// every row belongs to exactly one run.
// `least`: the fewest units a run takes (K1's kRunUnitsMin; K2 streams its
// runs through shared memory and takes fewer, so small CSRs spread wider).
inline void runs(int64_t n_rows, int64_t n_edges, int64_t least, int64_t& run_units,
                 int64_t& n_runs) {
  const int64_t units = n_rows + n_edges;
  const int64_t u = ceil_div(units, kRunWarps);
  run_units = u < least ? least : u > kRunUnitsMax ? kRunUnitsMax : u;
  n_runs = ceil_div(units, run_units);
}

// The geometry of rows of d values of elem_bytes bytes at address x, over a
// CSR of n_rows rows and n_edges edges whose row split has n_chunks chunks.
// False for what the kernel does not take.
//
// Every row start shares the alignment of x and of the row's bytes (at most
// 16), so a row's offset in its 16-byte span is at most 16 - align and a
// lane may read align bytes at once. Rows of more than 32·kAccFloats values
// run in pieces of a multiple of 16 bytes, so each piece starts as its row
// does. The run warps as runs() sizes them. A chunk
// warp walks two consecutive chunks where the plan has chunks enough to
// fill the card, one where few chunk warps would each walk alone (the launch
// lasts as long as its longest walk).
inline bool geometry(int d, int elem_bytes, uint64_t x, int64_t n_rows, int64_t n_edges,
                     int64_t n_chunks, Geometry& g) {
  if (d < 1 || (elem_bytes != 2 && elem_bytes != 4) || n_rows < 0 || n_edges < 0 || n_chunks < 0)
    return false;
  const uint64_t m = x | static_cast<uint64_t>(d) * static_cast<uint64_t>(elem_bytes) | 16u;
  g.align = static_cast<int>(m & (~m + 1));
  g.vec = g.align / elem_bytes < kMaxVec ? g.align / elem_bytes : kMaxVec;
  const int n_pieces = static_cast<int>(ceil_div(d, 32 * kAccFloats));
  const int q = 16 / elem_bytes;
  g.piece_cols = n_pieces == 1 ? d : static_cast<int>(ceil_div(ceil_div(d, n_pieces), q) * q);
  g.pieces = static_cast<int>(ceil_div(d, g.piece_cols));
  const int nvec = g.piece_cols / g.vec;
  g.lanes = 1;
  while (g.lanes < nvec && g.lanes < 32) g.lanes <<= 1;
  g.vecs = static_cast<int>(ceil_div(nvec, g.lanes));
  g.slot_bytes = 16 * static_cast<int>(ceil_div(g.piece_cols * elem_bytes + 16 - g.align, 16));
  const int slots = kRingBytes / (kStages * g.slot_bytes);
  g.slots = slots < kMinSlots ? kMinSlots : slots > kMaxSlots ? kMaxSlots : slots;
  g.bulk = g.slot_bytes >= kBulkMinBytes;
  g.warp_smem = 16 * static_cast<int>(ceil_div(kStages * g.slots * (g.slot_bytes + 8) +
                                                   kStages * 8 + kBlocks * 16 + kStages * 4 +
                                                   kBlocks * 32 * 8,
                                               16));
  runs(n_rows, n_edges, kRunUnitsMin, g.run_units, g.n_runs);
  g.chunk_group = n_chunks >= kChunkPairsMin ? 2 : 1;
  // the sums fit a lane's accumulators, the cp.async route (spans under
  // kBulkMinBytes) has instantiations for 1 or 2 vectors a lane, the block
  // fits Hopper's shared memory
  return g.vecs * g.vec <= kAccFloats && (g.bulk || g.vecs <= 2) &&
         kWarps * g.warp_smem <= kSmemLimit;
}

}  // namespace k1

// The geometry as 14 numbers in out: align, vec, vecs, piece_cols, pieces,
// lanes, slot_bytes, slots, bulk, warp_smem, block_smem, run_units, n_runs,
// chunk_group. Returns 0, or 1 (out unwritten) for what the kernel does not
// take.
extern "C" int csr_spmm_geometry(int d, int elem_bytes, unsigned long long x, long long n_rows,
                                 long long n_edges, long long n_chunks, long long* out) {
  k1::Geometry g;
  if (!k1::geometry(d, elem_bytes, x, n_rows, n_edges, n_chunks, g)) return 1;
  const long long v[14] = {g.align,     g.vec,       g.vecs,  g.piece_cols,
                           g.pieces,    g.lanes,     g.slot_bytes, g.slots,
                           g.bulk,      g.warp_smem, static_cast<long long>(k1::kWarps) * g.warp_smem,
                           g.run_units, g.n_runs,    g.chunk_group};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

#endif  // DGL_TPU_TORCH_K1_GEOMETRY_H_
