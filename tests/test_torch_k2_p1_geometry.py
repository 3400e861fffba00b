"""K2's and P1's host-side arithmetic (``dgl_tpu_torch/kernels/csrc/k2_p1_geometry.h``):
K2's runs and shared-memory stages, P1's stages and the split of each slot's
destination into a head, a 16-byte body and a tail.

The header is plain C++, included by ``seg_sum.cu`` and ``row_gather.cu``,
which size every launch with it; here it is compiled alone with ``g++`` and
called through its C entry points. K2's runs must give every row to exactly
one run warp, every stage's 16-byte-aligned span must hold its rows and fit
the stage, and every block must fit Hopper's 227 KB of shared memory; P1's
slot split must tile a slot's bytes exactly at every width and alignment.
"""

import ctypes
import math
import os
import subprocess

import numpy as np
import pytest

HEADER = os.path.join(os.path.dirname(__file__), "..", "dgl_tpu_torch", "kernels", "csrc",
                      "k2_p1_geometry.h")
SMEM_LIMIT, ACC_FLOATS, BULK_MIN = 232448, 16, 144
K2_STAGES, K2_MIN_BLOCKS, P1_STAGES = 2, 8, 4
P1_STAGE, P1_WIDE_STAGE, P1_PIECE, P1_REPEAT, P1_MAX_ROWS = 2048, 4096, 2048, 2048, 32
LL = ctypes.c_longlong


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("k2_p1_geometry") / "libk2_p1_geometry.so")
    subprocess.run(["g++", "-O1", "-Wall", "-Werror", "-shared", "-fPIC", "-x", "c++", HEADER,
                    "-o", path], check=True, capture_output=True)
    lib = ctypes.CDLL(path)
    lib.seg_sum_geometry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, LL, LL,
                                     ctypes.POINTER(LL)]
    lib.row_gather_async_geometry.argtypes = [LL, ctypes.c_ulonglong, ctypes.c_ulonglong,
                                              ctypes.POINTER(LL)]
    lib.row_gather_source_geometry.argtypes = [LL, ctypes.c_int, ctypes.POINTER(LL)]
    lib.slot_split16.argtypes = [ctypes.c_ulonglong, LL, ctypes.POINTER(LL)]
    lib.slot_split16.restype = None
    return lib


def _k2(lib, d, elem, base, n_rows=1000, n_edges=5000):
    out = (LL * 12)()
    assert lib.seg_sum_geometry(d, elem, base, n_rows, n_edges, out) == 0
    keys = ("align", "vec", "piece_cols", "pieces", "lanes", "vecs", "stage_bytes", "stage_rows",
            "warp_smem", "block_smem", "run_units", "n_runs")
    return dict(zip(keys, out))


def _round16(a):
    return (a + 15) // 16 * 16


@pytest.mark.parametrize("n_rows, mean_deg", [(1, 0), (7, 3), (1679, 2), (50_000, 40),
                                               (233_000, 50)])
def test_k2_runs_give_every_row_to_exactly_one_run_warp(lib, n_rows, mean_deg):
    rng = np.random.default_rng(n_rows)
    deg = rng.poisson(mean_deg, n_rows)
    deg[rng.integers(0, n_rows, 3)] = 0
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    g = _k2(lib, 16, 4, 0, n_rows, int(indptr[-1]))
    units = n_rows + int(indptr[-1])
    assert (g["n_runs"] - 1) * g["run_units"] < units <= g["n_runs"] * g["run_units"]
    # run warp i takes the rows whose unit r + indptr[r] lies in [i, i + 1)·run_units
    starts = np.arange(n_rows) + indptr[:-1]
    run = starts // g["run_units"]
    assert run.min() >= 0 and run.max() < g["n_runs"]
    assert np.all(np.diff(run) >= 0)  # consecutive rows: one contiguous run each
    bounds = np.searchsorted(starts, np.arange(g["n_runs"] + 1) * g["run_units"])
    assert bounds[0] == 0 and bounds[-1] == n_rows
    assert np.array_equal(np.repeat(np.arange(g["n_runs"]), np.diff(bounds)), run)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("widths", [(1, 300), (300, 700), (700, 1300)])
def test_k2_stage_spans_hold_their_rows_at_every_width_and_alignment(lib, elem, widths):
    for d in range(*widths):
        rb = d * elem
        for base in range(0, 16, elem):
            g = _k2(lib, d, elem, 4096 + base)
            assert g["align"] == math.gcd(4096 + base, rb, 16)
            assert g["vec"] * elem == g["align"] and g["vecs"] * g["vec"] <= ACC_FLOATS
            nvec = g["piece_cols"] // g["vec"]
            assert g["piece_cols"] % g["vec"] == 0
            assert g["lanes"] in (1, 2, 4, 8, 16, 32) and g["lanes"] >= min(nvec, 32)
            assert g["vecs"] == -(-nvec // g["lanes"])
            assert (g["pieces"] - 1) * g["piece_cols"] < d <= g["pieces"] * g["piece_cols"]
            assert g["pieces"] == 1 or (g["piece_cols"] * elem % 16 == 0 and g["stage_rows"] == 1)
            assert g["stage_bytes"] % 16 == 0 and g["stage_rows"] >= 1
            # every stage: stage_rows consecutive rows (or one row's piece) from
            # any row f; its span starts at the row's offset from 16 bytes
            f = np.arange(16)
            for piece in range(g["pieces"]):
                c0 = piece * g["piece_cols"] * elem
                cols = min(g["piece_cols"], d - piece * g["piece_cols"])
                off = (4096 + base + f * rb + c0) % 16
                span = _round16(off + (g["stage_rows"] - 1) * rb + cols * elem)
                assert span.max() <= g["stage_bytes"]
            assert g["warp_smem"] >= K2_STAGES * (g["stage_bytes"] + 16)
            # the launch bound's blocks fit the SM's shared memory
            assert K2_MIN_BLOCKS * g["block_smem"] <= SMEM_LIMIT


@pytest.mark.parametrize("elem", [4, 2])
def test_p1_slot_split_tiles_every_slot_at_every_width_and_alignment(lib, elem):
    out = (LL * 3)()
    for d in range(1, 1300):
        rb = d * elem
        for delta in range(0, 16, 2):
            dst = 1 << 20 | delta
            lib.slot_split16(dst, rb, out)
            head, body, tail = out
            assert head + body + tail == rb and min(head, body, tail) >= 0
            assert body % 16 == 0 and tail < 16 and head < 16
            assert head == min(rb, (16 - delta) % 16)
            if body or tail:  # the body and the tail start on a 16-byte boundary
                assert (dst + head) % 16 == 0


@pytest.mark.parametrize("elem", [4, 2])
def test_p1_stages_hold_their_rows_at_every_width_and_alignment(lib, elem):
    out = (LL * 11)()
    for d in range(1, 1300):
        rb = d * elem
        for xo in range(0, 16, elem):
            for oo in (0, 4, 8):
                assert lib.row_gather_async_geometry(rb, 4096 + xo, 8192 + oo, out) == 0
                (whole, bulk, vec, words, piece, pieces, slot, rows, stage, warp_smem,
                 block_smem) = out
                # a stage is 2 KB, or one row's slot of up to 4 KB
                assert stage == max(P1_STAGE, slot) and stage <= P1_WIDE_STAGE
                assert pieces == 1 or rb > P1_WIDE_STAGE - 16
                # the words of a row (piece) at every offset out allows
                delta = (8192 + oo + np.arange(16) * rb) % 16
                assert words == (16 - math.gcd(8192 + oo, rb, 16) + piece + 15) // 16
                assert (((delta + piece + 15) // 16) <= words).all()
                assert whole == (math.gcd(4096 + xo, rb, 16) == 16 and vec == 16)
                assert vec == math.gcd(4096 + xo | 8192 + oo, rb, 16)
                assert (pieces - 1) * piece < rb <= pieces * piece
                assert pieces == 1 or (piece % 16 == 0 and rows == 1)
                # each staged row's span fits its slot, the slots the stage
                for c0 in range(0, rb, piece):
                    off = (4096 + xo + np.arange(16) * rb + c0) % 16
                    span = _round16(off + min(piece, rb - c0))
                    assert whole or span.max() <= slot
                    assert not whole or (off.max() == 0 and slot == piece)
                assert 1 <= rows <= P1_MAX_ROWS and rows * slot <= stage
                assert warp_smem >= P1_STAGES * (stage + 8 + 4 * P1_MAX_ROWS)
                assert bulk == (slot >= BULK_MIN)
                assert block_smem <= SMEM_LIMIT


@pytest.mark.parametrize("has_pos", [0, 1])
def test_p1_source_order_repeats_whole_periods(lib, has_pos):
    out = (LL * 6)()
    for rb in range(2, 2 * 1300, 2):
        assert lib.row_gather_source_geometry(rb, has_pos, out) == 0
        piece, pieces, repeat, period, chunk, warp_smem = out
        assert (pieces - 1) * piece < rb <= pieces * piece
        assert pieces == 1 or piece % 16 == 0
        assert _round16(15 + piece) <= P1_PIECE  # a piece's span at any offset fits the stage
        assert period == rb * 16 // math.gcd(rb, 16)
        assert chunk % period == 0 and 16 + chunk <= P1_REPEAT
        assert repeat == (not has_pos and pieces == 1 and chunk > 0)
        assert warp_smem == P1_PIECE + (P1_REPEAT if repeat else 0) + 16
        assert 8 * warp_smem <= SMEM_LIMIT
