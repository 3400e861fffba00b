"""K3's host-side arithmetic (``dgl_tpu_torch/kernels/csrc/k3_geometry.h``):
the geometry of both passes' shared-memory ring, copy route, lane layout and
heads, their runs of rows and the chunk warps.

The header is plain C++, included by ``gat_attention.cu``, which sizes every
launch with it; here it is compiled alone with ``g++`` and called through
its ``gat_attention_geometry`` and ``gat_attention_lane_heads`` entry points.
The geometry must give every H·D row of the gathered array (the forward's
v, b2's g), at every width, value size and alignment of its base, a slot
that holds the 16-byte span that covers each piece of the row, a vector
width that every row start allows and that divides D (so that each of a
lane's vectors lies in one head), sums that fit a lane's 8 accumulators of
each kind and a block within Hopper's 227 KB of shared memory; the lanes'
vectors must cover each piece's values once, each vector inside the head
the kernel weighs it with; the runs must tile the CSR's rows plus edges,
and the chunk warps must take every chunk of the row split once.
"""

import ctypes
import dataclasses
import os
import subprocess

import numpy as np
import pytest

HEADER = os.path.join(os.path.dirname(__file__), "..", "dgl_tpu_torch", "kernels", "csrc",
                      "k3_geometry.h")
FWD, B2 = 0, 1
ACC_FLOATS, MAX_VECS, MAX_VEC, SMEM_LIMIT = 8, 4, 4, 232448  # a lane's sums, its widest read
STAGES, BLOCKS, MIN_SLOTS, MAX_SLOTS, WARPS, PAIRS = 4, 5, 4, 32, 4, 32
BULK_MIN = 144
RUN_UNITS_MIN, RUN_UNITS_MAX = 64, 4096


@dataclasses.dataclass(frozen=True)
class Geometry:
    hp: int
    align: int
    vec: int
    vecs: int
    piece_cols: int
    pieces: int
    lanes: int
    slot_bytes: int
    slots: int
    bulk: int
    edge_bytes: int
    warp_smem: int
    block_smem: int
    run_units: int
    n_runs: int
    chunk_group: int
    n_chunk_blocks: int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("k3_geometry") / "libk3_geometry.so")
    subprocess.run(["g++", "-O1", "-Wall", "-Werror", "-shared", "-fPIC", "-x", "c++", HEADER,
                    "-o", path], check=True, capture_output=True)
    return ctypes.CDLL(path)


@pytest.fixture(scope="module")
def geometry(lib):
    """``gat_attention_geometry``: (pass, heads, d, elem_bytes, base, n_rows,
    n_edges, n_chunks) -> Geometry, or None for what the kernels do not
    take."""
    fn = lib.gat_attention_geometry
    ll = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_ulonglong, ll, ll, ll, ctypes.POINTER(ll)]
    fn.restype = ctypes.c_int

    def call(pass_, heads, d, elem, base, n_rows=1000, n_edges=5000, n_chunks=0):
        out = (ll * 17)()
        if fn(pass_, heads, d, elem, base, n_rows, n_edges, n_chunks, out):
            return None
        return Geometry(*out)

    return call


@pytest.fixture(scope="module")
def lane_heads(lib):
    """``gat_attention_lane_heads``: the head of each (lane column, vector)
    of a piece, as a (lanes, vecs) array (-1 past the piece's end)."""
    fn = lib.gat_attention_lane_heads
    ll = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_ulonglong, ctypes.c_int, ctypes.POINTER(ll)]
    fn.restype = ctypes.c_int

    def call(geo, pass_, heads, d, elem, base, piece):
        out = (ll * (geo.lanes * geo.vecs))()
        assert fn(pass_, heads, d, elem, base, piece, out) == 0
        return np.array(out, dtype=np.int64).reshape(geo.lanes, geo.vecs)

    return call


# H·D rows of 64, 160, 188, 256, 512 and 1024 bytes in each value size
ROWS = {
    4: [(1, 16), (4, 4), (1, 40), (4, 10), (1, 47), (4, 16), (1, 64), (8, 16), (2, 64), (4, 64),
        (16, 16)],
    2: [(1, 32), (2, 16), (1, 80), (2, 40), (1, 94), (2, 47), (8, 16), (2, 64), (4, 64), (8, 32),
        (8, 64), (32, 16)],
}


def _spans(geo, hd, elem, base, rows):
    """16-byte chunks that each (row, piece) span covers."""
    starts = base + np.arange(rows, dtype=np.int64) * hd * elem
    out = []
    for piece in range(geo.pieces):
        cols = min(geo.piece_cols, hd - piece * geo.piece_cols)
        a = starts + piece * geo.piece_cols * elem
        out.append(((a % 16) + cols * elem + 15) // 16)
    return np.concatenate(out), starts


# b2 gathers the float32 cotangent: its rows are 4-byte values
@pytest.mark.parametrize("pass_, elem", [(FWD, 4), (FWD, 2), (B2, 4)])
def test_span_and_route_of_every_row_at_every_base(geometry, pass_, elem):
    for heads, d in ROWS[elem]:
        hd = heads * d
        assert hd * elem in (64, 160, 188, 256, 512, 1024)
        for base in ((0, 4, 8) if elem == 4 else (0, 2, 4, 8)):
            geo = geometry(pass_, heads, d, elem, 4096 + base)
            chunks, starts = _spans(geo, hd, elem, 4096 + base, 40)
            assert chunks.max() * 16 <= geo.slot_bytes and geo.slot_bytes % 16 == 0
            assert geo.bulk == int(geo.slot_bytes >= BULK_MIN)
            # every row start allows a read of vec values; vec divides d
            assert np.all(starts % geo.align == 0) and geo.align % (geo.vec * elem) == 0
            assert geo.vec <= MAX_VEC and d % geo.vec == 0 and geo.piece_cols % geo.vec == 0
            assert (geo.pieces - 1) * geo.piece_cols < hd <= geo.pieces * geo.piece_cols
            assert geo.pieces == 1 or geo.piece_cols % (16 // elem) == 0
            assert geo.vecs <= MAX_VECS and geo.vecs * geo.vec <= ACC_FLOATS
            assert geo.bulk or geo.vecs <= 2
            assert geo.hp >= heads and geo.hp & (geo.hp - 1) == 0 and geo.hp < 2 * heads
            assert geo.edge_bytes == (4 if pass_ == FWD else 16) * heads


@pytest.mark.parametrize("pass_, heads, d, elem, base, want", [
    # (vec, lanes, vecs, slot_bytes, slots, bulk)
    (FWD, 1, 16, 4, 0, (4, 4, 1, 64, 32, 0)),  # reddit GAT: 8 rows a pass
    (FWD, 4, 16, 4, 0, (4, 16, 1, 256, 8, 1)),  # arxiv GAT: one 256-byte span an edge
    (FWD, 4, 40, 4, 0, (4, 32, 2, 640, 4, 1)),  # arxiv's last layer: four rows a stage
    (FWD, 8, 16, 4, 0, (4, 32, 1, 512, 4, 1)),  # ns_gat's evaluation
    (FWD, 1, 41, 4, 0, (1, 32, 2, 176, 11, 1)),  # 164-byte rows: a value a lane
    (FWD, 4, 41, 4, 0, (1, 32, 3, 336, 6, 1)),  # aligned rows, but D odd: V = 1, two pieces
    (FWD, 4, 64, 4, 0, (4, 32, 2, 1024, 4, 1)),  # cluster GAT: a ring of 16 KB
    (FWD, 4, 16, 2, 0, (4, 16, 1, 128, 16, 0)),  # bfloat16 v: 8 bytes a lane
    (B2, 4, 16, 4, 8, (2, 32, 1, 272, 7, 1)),  # g 8 bytes off 16: a wider span
])
def test_geometry_at_the_paths_shapes(geometry, pass_, heads, d, elem, base, want):
    geo = geometry(pass_, heads, d, elem, 1 << 20 | base)
    assert (geo.vec, geo.lanes, geo.vecs, geo.slot_bytes, geo.slots, geo.bulk) == want


@pytest.mark.parametrize("pass_, elem", [(FWD, 4), (FWD, 2), (B2, 4)])
def test_lanes_own_each_heads_columns_once(geometry, lane_heads, pass_, elem):
    """The lanes' vectors cover each piece's values once, and the head the
    kernel weighs a vector with is the head of each of its values."""
    for heads, d in [(1, 16), (2, 40), (4, 16), (4, 41), (3, 47), (8, 16), (8, 64), (32, 10)]:
        for base in (0, 4, 8):
            geo = geometry(pass_, heads, d, elem, 4096 + base)
            hd = heads * d
            seen = np.zeros(hd, np.int64)
            for piece in range(geo.pieces):
                col0 = piece * geo.piece_cols
                cols = min(geo.piece_cols, hd - col0)
                table = lane_heads(geo, pass_, heads, d, elem, 4096 + base, piece)
                for col in range(geo.lanes):
                    for t in range(geo.vecs):
                        c = col + t * geo.lanes
                        if c * geo.vec >= cols:
                            assert table[col, t] == -1
                            continue
                        first = col0 + c * geo.vec
                        values = np.arange(first, first + geo.vec)
                        seen[values] += 1
                        assert np.all(values // d == table[col, t]), (heads, d, base, col, t)
            assert np.all(seen == 1), (heads, d, base)


def test_ring_and_block_fit_shared_memory(geometry):
    """Every shape the kernels take: a warp's ring holds its stages, the
    edges' a_src or node, the index blocks and a block's weights, and a
    block of 4 warps fits Hopper's 227 KB."""
    for pass_ in (FWD, B2):
        for elem in ((4, 2) if pass_ == FWD else (4,)):
            for heads in (1, 2, 3, 4, 7, 8, 16, 32):
                for d in range(1, 130):
                    geo = geometry(pass_, heads, d, elem, 4096 + 4)
                    assert geo is not None, (pass_, elem, heads, d)
                    assert MIN_SLOTS <= geo.slots <= MAX_SLOTS
                    need = (STAGES * geo.slots * (geo.slot_bytes + geo.edge_bytes) + STAGES * 8
                            + BLOCKS * 8 + STAGES * geo.slots * 8 + STAGES * 4
                            + BLOCKS * 32 * 8 + PAIRS * 8)
                    assert need <= geo.warp_smem < need + 16 and geo.warp_smem % 16 == 0
                    assert geo.block_smem == WARPS * geo.warp_smem <= SMEM_LIMIT
                    # a block scores at most PAIRS (edge, head) pairs, one a lane
                    assert PAIRS // geo.hp >= 1


def test_geometry_refuses_what_the_kernels_do_not_take(geometry):
    assert geometry(FWD, 33, 16, 4, 0) is None and geometry(FWD, 0, 16, 4, 0) is None
    assert geometry(FWD, 4, 0, 4, 0) is None and geometry(FWD, 4, 16, 8, 0) is None
    assert geometry(2, 4, 16, 4, 0) is None and geometry(B2, 4, 16, 4, 0, n_rows=-1) is None
    assert geometry(FWD, 32, 16, 4, 0) is not None and geometry(B2, 1, 1, 4, 0) is not None


@pytest.mark.parametrize("case", ["skewed", "empty_rows", "no_edges", "one_row", "hub"])
def test_runs_give_every_row_to_one_warp(geometry, case):
    """Run warp w takes the rows whose unit r + indptr[r] lies in
    [w, w + 1)·run_units: the runs must cover every unit, each row in one
    run, within the kernels' bounds."""
    rng = np.random.default_rng(len(case))
    degrees = {
        "skewed": rng.zipf(1.5, 3000) % 4000,
        "empty_rows": np.where(rng.random(5000) < 0.9, 0, rng.integers(1, 40, 5000)),
        "no_edges": np.zeros(700, np.int64),
        "one_row": np.array([12345]),
        "hub": np.concatenate([rng.integers(0, 30, 2000), [200_000], rng.integers(0, 30, 2000)]),
    }[case]
    indptr = np.zeros(len(degrees) + 1, np.int64)
    np.cumsum(degrees, out=indptr[1:])
    n, e = len(degrees), int(indptr[-1])
    for pass_ in (FWD, B2):
        geo = geometry(pass_, 4, 16, 4, 0, n_rows=n, n_edges=e)
        unit, n_runs = geo.run_units, geo.n_runs
        assert RUN_UNITS_MIN <= unit <= RUN_UNITS_MAX
        assert (n_runs - 1) * unit < n + e <= n_runs * unit
        owner = (np.arange(n) + indptr[:-1]) // unit
        assert np.all(owner < n_runs) and np.all(np.diff(owner) >= 0)


@pytest.mark.parametrize("n_chunks", [0, 1, 3, 4, 5, 59, 2047, 2048, 2049, 8586])
def test_chunk_warps_take_every_chunk_once(geometry, n_chunks):
    """The first n_chunk_blocks blocks give warp w of block b the chunks
    [k0, k0 + chunk_group) from k0 = (4·b + w)·chunk_group (a warp past the
    last chunk leaves): every chunk has one warp, no chunk block is all
    idle, and a warp walks two chunks only on plans of 2,048 or more."""
    for pass_ in (FWD, B2):
        geo = geometry(pass_, 1, 16, 4, 0, n_chunks=n_chunks)
        assert geo.chunk_group == (2 if n_chunks >= 2048 else 1)
        warps = np.arange(geo.n_chunk_blocks * WARPS)
        k0 = warps * geo.chunk_group
        taken = np.concatenate([np.arange(k, min(k + geo.chunk_group, n_chunks))
                                for k in k0[k0 < n_chunks]] or [np.zeros(0, np.int64)])
        assert np.array_equal(taken, np.arange(n_chunks))
        assert geo.n_chunk_blocks == 0 or k0[-WARPS] < n_chunks


def test_the_kernels_build_with_this_header():
    """``gat_attention.cu`` sizes its launches with this header, the build
    hashes it, and the bfloat16 entry points build from the same source."""
    from dgl_tpu_torch.kernels import build

    assert os.path.samefile(HEADER, next(h for h in build.HEADERS if h.endswith("k3_geometry.h")))
    with open(build.SOURCES["gat_attention"]) as f:
        assert '#include "k3_geometry.h"' in f.read()
    assert build.SOURCES["gat_attention_bf16"] == build.SOURCES["gat_attention"]
    assert build.DEFINES["gat_attention_bf16"] == ["-DK3_BF16"]
