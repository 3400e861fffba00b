"""K1's host-side arithmetic (``dgl_tpu_torch/kernels/csrc/k1_geometry.h``):
the geometry of its shared-memory ring and lane layout, its runs of rows
and the chunks a chunk warp walks.

The header is plain C++, included by ``csr_spmm.cu``, which sizes every
launch with it; here it is compiled alone with ``g++`` and called through
its ``csr_spmm_geometry`` entry point. The geometry must give every row of
x, at every width, value size and alignment of x's base, a slot that holds
the 16-byte span that covers each piece of the row, a vector width that
every row start allows, sums that fit a lane's 16 accumulators and a block
within Hopper's 227 KB of shared memory; the runs must tile the CSR's rows
plus edges, so that the card's search of ``r + indptr[r]`` gives every row
to exactly one run warp.
"""

import ctypes
import dataclasses
import os
import subprocess

import numpy as np
import pytest

HEADER = os.path.join(os.path.dirname(__file__), "..", "dgl_tpu_torch", "kernels", "csrc",
                      "k1_geometry.h")
ACC_FLOATS, MAX_VEC, SMEM_LIMIT = 16, 4, 232448  # a lane's sums, its widest read, Hopper's 227 KB
STAGES, MIN_SLOTS, MAX_SLOTS = 4, 2, 32
RUN_UNITS_MIN, RUN_UNITS_MAX = 64, 4096


@dataclasses.dataclass(frozen=True)
class Geometry:
    align: int
    vec: int
    vecs: int
    piece_cols: int
    pieces: int
    lanes: int
    slot_bytes: int
    slots: int
    bulk: int
    warp_smem: int
    block_smem: int
    run_units: int
    n_runs: int
    chunk_group: int


@pytest.fixture(scope="module")
def geometry(tmp_path_factory):
    """``k1_geometry.h``'s ``csr_spmm_geometry``, built with g++: (d,
    elem_bytes, base, n_rows, n_edges, n_chunks) -> Geometry, or None for
    what the kernel does not take."""
    lib = str(tmp_path_factory.mktemp("k1_geometry") / "libk1_geometry.so")
    subprocess.run(["g++", "-O1", "-Wall", "-Werror", "-shared", "-fPIC", "-x", "c++", HEADER,
                    "-o", lib], check=True, capture_output=True)
    fn = ctypes.CDLL(lib).csr_spmm_geometry
    ll = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ll, ll, ll, ctypes.POINTER(ll)]
    fn.restype = ctypes.c_int

    def call(d, elem, base, n_rows=1000, n_edges=5000, n_chunks=0):
        out = (ll * 14)()
        if fn(d, elem, base, n_rows, n_edges, n_chunks, out):
            return None
        return Geometry(*out)

    return call


def _spans(geo, d, elem, base, rows):
    """Chunks of 16 bytes that each (row, piece) span covers, and each row
    start's offset in its span."""
    starts = base + np.arange(rows, dtype=np.int64) * d * elem
    out = []
    for piece in range(geo.pieces):
        cols = min(geo.piece_cols, d - piece * geo.piece_cols)
        a = starts + piece * geo.piece_cols * elem
        out.append(((a % 16) + cols * elem + 15) // 16)
    return np.concatenate(out), starts


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("widths", [(1, 130), (130, 600), (600, 1100)])
def test_geometry_fits_every_row_at_every_width_and_alignment(geometry, elem, widths):
    for d in range(*widths):
        for base in range(0, 16, elem):
            geo = geometry(d, elem, 4096 + base)
            chunks, starts = _spans(geo, d, elem, 4096 + base, 40)
            assert chunks.max() * 16 <= geo.slot_bytes and geo.slot_bytes % 16 == 0
            # every row start allows a read of vec values, and so every piece start
            assert np.all(starts % geo.align == 0) and geo.align % (geo.vec * elem) == 0
            assert geo.vec <= MAX_VEC
            assert geo.piece_cols % geo.vec == 0
            assert (geo.pieces - 1) * geo.piece_cols < d <= geo.pieces * geo.piece_cols
            assert geo.pieces == 1 or geo.piece_cols % (16 // elem) == 0
            nvec = geo.piece_cols // geo.vec
            assert geo.lanes in (1, 2, 4, 8, 16, 32) and (geo.lanes >= min(nvec, 32))
            assert geo.vecs == -(-nvec // geo.lanes) and geo.vecs * geo.vec <= ACC_FLOATS
            # the cp.async route (rows of at most 128 bytes) sums at most 2 vectors a lane
            assert geo.bulk or geo.vecs <= 2
            assert MIN_SLOTS <= geo.slots <= MAX_SLOTS
            assert geo.block_smem % geo.warp_smem == 0 and geo.block_smem <= SMEM_LIMIT
            assert geo.warp_smem % 16 == 0
            assert geo.warp_smem >= STAGES * geo.slots * geo.slot_bytes


@pytest.mark.parametrize("d, elem, base, want", [
    # (vec, piece_cols, pieces, lanes, slot_bytes, slots)
    (16, 4, 0, (4, 16, 1, 4, 64, 32)),  # reddit, the main path: 8 rows a pass
    (16, 4, 4, (1, 16, 1, 16, 80, 25)),  # the same rows at a base 4 bytes off
    (16, 2, 0, (4, 16, 1, 4, 32, 32)),  # at most 4 values a lane: 8 bytes of bfloat16
    (47, 4, 0, (1, 47, 1, 32, 208, 9)),  # 188 B rows: spans of 12 or 13 chunks
    (47, 2, 0, (1, 47, 1, 32, 112, 18)),
    (100, 4, 0, (4, 100, 1, 32, 400, 5)),
    (100, 2, 0, (4, 100, 1, 32, 208, 9)),  # 200 B rows start 8 bytes apart
    (256, 4, 0, (4, 256, 1, 32, 1024, 2)),
    (602, 4, 0, (2, 304, 2, 32, 1232, 2)),  # reddit's features: two pieces
])
def test_geometry_at_the_paths_widths(geometry, d, elem, base, want):
    geo = geometry(d, elem, 1 << 20 | base)
    assert (geo.vec, geo.piece_cols, geo.pieces, geo.lanes, geo.slot_bytes, geo.slots) == want


def test_geometry_refuses_what_the_kernel_does_not_take(geometry):
    assert geometry(16, 8, 0) is None and geometry(16, 3, 0) is None
    assert geometry(0, 4, 0) is None and geometry(16, 4, 0, n_rows=-1) is None
    assert geometry(16, 4, 0) is not None


def test_chunk_warps_walk_two_chunks_only_where_the_plan_has_many(geometry):
    groups = [geometry(16, 4, 0, n_chunks=c).chunk_group for c in (0, 2047, 2048, 8586)]
    assert groups == [1, 1, 2, 2]


@pytest.mark.parametrize("case", ["skewed", "empty_rows", "no_edges", "one_row", "hub"])
def test_runs_give_every_row_to_one_warp(geometry, case):
    """Run warp w takes the rows whose unit r + indptr[r] lies in
    [w, w + 1)·run_units: the runs must cover every unit, each warp about
    the same count, within the kernel's bounds."""
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
    geo = geometry(16, 4, 0, n_rows=n, n_edges=e)
    unit, n_runs = geo.run_units, geo.n_runs
    assert RUN_UNITS_MIN <= unit <= RUN_UNITS_MAX
    assert (n_runs - 1) * unit < n + e <= n_runs * unit
    starts = np.arange(n) + indptr[:-1]
    owner = starts // unit
    assert np.all(owner < n_runs) and np.all(np.diff(owner) >= 0)


def test_runs_at_the_paths_sizes(geometry):
    """About 8192 run warps a launch, within 64 and 4096 rows plus edges a
    warp: reddit's 232,965 rows and 114,615,892 edges take 4096 a warp; a
    small CSR takes 64."""
    big = geometry(16, 4, 0, n_rows=232_965, n_edges=114_615_892)
    assert (big.run_units, big.n_runs) == (4096, -(-(232_965 + 114_615_892) // 4096))
    mid = geometry(16, 4, 0, n_rows=169_343, n_edges=2_484_941)
    assert mid.run_units == -(-(169_343 + 2_484_941) // 8192) and mid.n_runs <= 8192
    small = geometry(16, 4, 0, n_rows=100, n_edges=300)
    assert (small.run_units, small.n_runs) == (64, 7)


def test_no_reuse_gather_floor_and_bound():
    """chip_smoke's yardsticks for K1: the no-reuse gather floor reads every
    edge's row, the bound each row of x once."""
    import chip_smoke

    n, e, d = 1000, 50_000, 16
    bound, by = chip_smoke.spmm_bound(n, n, e, d, 8)
    floor = chip_smoke.spmm_floor(n, e, d, 8)
    assert by == "bytes"
    assert floor == pytest.approx(1e3 * (e * (4 * d + 4) + (n + 1) * 8 + n * d * 4) / 3.35e12)
    assert floor > bound > 0
    assert chip_smoke.spmm_floor(n, e, d, 8, x_bytes=2, weighted=True) < floor


def test_the_kernel_builds_with_this_header():
    """``csr_spmm.cu`` sizes its launches with this header, and the build
    hashes it, so a changed geometry rebuilds K1's libraries."""
    from dgl_tpu_torch.kernels import build

    assert os.path.samefile(HEADER, next(h for h in build.HEADERS if h.endswith("k1_geometry.h")))
    with open(build.SOURCES["csr_spmm"]) as f:
        assert '#include "k1_geometry.h"' in f.read()
    assert build.SOURCES["csr_spmm_bf16"] == build.SOURCES["csr_spmm"]
