"""The port's SpMM / SDDMM kernel sweep (``dgl_tpu_torch.kernel.bench_kernels``)
at a tiny scale on the CPU: a line per width in the reference's format,
every point held to its plain version, the JAX sweep's ``_min_bytes``, the
other ops and reduces, the scatter tier, the CSV, and the per-width catch,
which takes ``torch.OutOfMemoryError`` and nothing else."""

import importlib.util
import os
import re

import numpy as np
import pytest
import torch

import dgl_tpu

import dgl_tpu_torch
from dgl_tpu_torch.kernel import bench_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"^hidden size: (\d+), avg time: [0-9.e-]+  \(plain ")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))


def _graph(seed=0, n=80, e=900):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, n - 6, e)
    return src, dst, n, dgl_tpu_torch.from_edges(src, dst, n, device="cpu")


def test_main_prints_a_line_per_width_at_its_defaults(cache, capsys, tmp_path):
    csv = tmp_path / "sweep.csv"
    rows = bench_kernels.main(["--device", "cpu", "--scale", "0.002", "--datasets",
                               "ogbn-arxiv,ogbn-proteins", "--csv", str(csv)])
    out = capsys.readouterr().out
    assert "benchmarking on: ogbn-proteins" in out and "SPMM\n----" in out and "SDDMM\n----" in out
    widths = [int(m.group(1)) for m in map(LINE.match, out.splitlines()) if m]
    assert widths == bench_kernels.FEAT_SIZES * 4
    assert [(r["dataset"], r["kind"], r["op"]) for r in rows[::8]] == [
        ("ogbn-arxiv", "spmm", "copy_lhs.sum"), ("ogbn-arxiv", "sddmm", "add"),
        ("ogbn-proteins", "spmm", "copy_lhs.sum"), ("ogbn-proteins", "sddmm", "add")]
    for r in rows:
        assert not r["oom"] and r["bound_used"] <= 1.0 and r["seconds"] > 0
        assert r["library_seconds"] is not None and r["sol_pct"] > 0
    assert len(csv.read_text().splitlines()) == 1 + len(rows)


def _jax_sweep():
    """The JAX package's ``kernel/bench_kernels.py`` (a script, not a module)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_kernels", os.path.join(ROOT, "kernel", "bench_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_min_bytes_equal_the_jax_sweeps():
    src, dst, n, gt = _graph()
    gj = dgl_tpu.from_edges(src, dst, n)
    jax_sweep = _jax_sweep()
    for kind in ("spmm", "sddmm", "scatter", "other"):
        for d in bench_kernels.FEAT_SIZES:
            assert bench_kernels._min_bytes(kind, gt, d) == jax_sweep._min_bytes(kind, gj, d)


@pytest.mark.parametrize("op,reduce", [("copy_lhs", "mean"), ("copy_rhs", "sum"),
                                       ("mul", "mean"), ("div", "sum"), ("sub", "max"),
                                       ("copy_lhs", "min")])
def test_spmm_ops_and_reduces_hold_their_check(capsys, op, reduce):
    *_, g = _graph(1)
    rows = bench_kernels.bench_spmm("tiny", g, op, reduce, feat_sizes=[1, 3])
    assert [r["hidden"] for r in rows] == [1, 3]
    for r in rows:
        assert r["op"] == f"{op}.{reduce}" and r["bound_used"] <= 1.0
        assert (r["library_seconds"] is None) == (op != "copy_lhs" or reduce not in ("sum", "mean"))
    assert capsys.readouterr().out.count("hidden size:") == 2


@pytest.mark.parametrize("op", ["sub", "mul", "div", "dot"])
def test_sddmm_ops_hold_their_check(op):
    *_, g = _graph(2)
    rows = bench_kernels.bench_sddmm("tiny", g, op, feat_sizes=[2, 5])
    assert all(r["bound_used"] <= 1.0 for r in rows)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_scatter_tier_holds_its_check(reduce):
    *_, g = _graph(3)
    rows = bench_kernels.bench_scatter("tiny", g, reduce, feat_sizes=[4])
    assert rows[0]["kind"] == "scatter" and rows[0]["bound_used"] <= 1.0


def test_a_wrong_kernel_route_fails_its_check(monkeypatch):
    *_, g = _graph(4)
    real = bench_kernels.gspmm
    monkeypatch.setattr(bench_kernels, "gspmm", lambda *a, **k: real(*a, **k) + 1e-3)
    with pytest.raises(AssertionError, match="off the plain version"):
        bench_kernels.bench_spmm("tiny", g, "copy_lhs", "sum", feat_sizes=[4])
    real_sddmm = bench_kernels.gsddmm
    monkeypatch.setattr(bench_kernels, "gsddmm", lambda *a, **k: real_sddmm(*a, **k) * 1.0001)
    with pytest.raises(AssertionError, match="off the plain version"):
        bench_kernels.bench_sddmm("tiny", g, "add", feat_sizes=[4])


def test_only_out_of_memory_is_caught(monkeypatch, capsys):
    *_, g = _graph(5)
    real = bench_kernels.gspmm

    def oom_at_2(g_, op, reduce, x=None, e=None):
        if x.shape[1] == 2:
            raise torch.OutOfMemoryError("no room")
        return real(g_, op, reduce, x=x, e=e)

    monkeypatch.setattr(bench_kernels, "gspmm", oom_at_2)
    rows = bench_kernels.bench_spmm("tiny", g, "copy_lhs", "sum", feat_sizes=[1, 2, 4])
    assert [r["oom"] for r in rows] == [False, True, False]
    assert "hidden size: 2, OOM" in capsys.readouterr().out

    def fails(*a, **k):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(bench_kernels, "gspmm", fails)
    with pytest.raises(RuntimeError, match="not a memory error"):
        bench_kernels.bench_spmm("tiny", g, "copy_lhs", "sum", feat_sizes=[1])
