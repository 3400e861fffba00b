"""The port's native subgraph extractor, CSR build and partitioners against
the JAX package's, bit for bit in one process, on random graphs with hub
nodes, isolated nodes, self-loops and duplicate edges; and
``graph/partition.py`` against ``dgl_tpu.graph.partition``: the same
assignments, cache file names, statistics and part lists, each package
reading the other's cache, and a concurrent cache write that leaves one
whole file. The JAX binding's ``partition_lp`` races across OpenMP
threads, so it is the reference only at one thread; the port's runs
serially and is held to it with one thread and with four."""

import contextlib
import ctypes
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from dgl_tpu.csrc import native as jax_native
from dgl_tpu.graph import partition as jax_partition

from dgl_tpu_torch.csrc import native
from dgl_tpu_torch.graph import partition


def _graph(seed, n=600, e=5000):
    """Edges among nodes 0 .. n - 41 (the last 40 isolated), a third of them
    out of or into two hubs (nodes 0 and 1), some self-loops and duplicates."""
    rng = np.random.default_rng(seed)
    m = n - 40
    src, dst = rng.integers(0, m, e), rng.integers(0, m, e)
    src[: e // 6] = 0
    dst[e // 6: e // 3] = 1
    src[e // 3: e // 3 + 50] = dst[e // 3: e // 3 + 50]
    src[-100:], dst[-100:] = src[:100], dst[:100]
    return src, dst, n


GRAPHS = [_graph(0), _graph(1, n=2500, e=9000)]
# big enough for several coarsening levels (the multilevel path coarsens
# down to max(2k, 2048) nodes)
BIG = _graph(2, n=30000, e=150000)


@contextlib.contextmanager
def _omp_threads(k):
    """The OpenMP team size of later parallel regions on this thread (both
    libraries share the process's OpenMP runtime)."""
    lib = native.load()
    before = lib.omp_get_max_threads()
    lib.omp_set_num_threads(k)
    try:
        yield
    finally:
        lib.omp_set_num_threads(before)


@pytest.mark.parametrize("gi", range(len(GRAPHS)))
def test_build_csr_and_subgraphs_equal_the_jax_library(gi):
    src, dst, n = GRAPHS[gi]
    assert jax_native.get_lib() is not None  # the JAX package's native path
    got = native.build_csr(src, dst, n)
    for a, b in zip(got, jax_native.build_csr(src, dst, n)):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    indptr, nbrs, _ = got
    ours = native.SubgraphExtractor(indptr, nbrs, n)
    theirs = jax_native.SubgraphExtractor(indptr, nbrs, n)
    rng = np.random.default_rng(gi)
    for nodes in (np.arange(n), np.array([0, 1]), np.array([n - 1]), np.zeros(0, np.int64),
                  rng.permutation(n)[: n // 3], np.concatenate([[1, 0], rng.integers(2, n, 50)])):
        nodes = np.unique(nodes) if len(nodes) > 2 else nodes
        s, d = ours.extract(nodes)
        s2, d2 = theirs.extract(nodes)
        np.testing.assert_array_equal(s, s2)
        np.testing.assert_array_equal(d, d2)
        # every edge with both ends in nodes, once, relabelled
        keep = np.isin(src, nodes) & np.isin(dst, nodes)
        pos = {v: i for i, v in enumerate(nodes.tolist())}
        want = sorted(zip((pos[v] for v in src[keep]), (pos[v] for v in dst[keep])))
        assert sorted(zip(s.tolist(), d.tolist())) == want


@pytest.mark.parametrize("gi", range(len(GRAPHS) + 1))
@pytest.mark.parametrize("k", [2, 7, 33, 150])
def test_partition_multilevel_equals_the_jax_library(gi, k):
    src, dst, n = (GRAPHS + [BIG])[gi]
    for seed in (0, 5):
        got = native.partition_multilevel(src, dst, n, k, seed)
        np.testing.assert_array_equal(got, jax_native.partition_multilevel(src, dst, n, k, seed))
        assert got.dtype == np.int64 and got.min() >= 0 and got.max() < k


@pytest.mark.parametrize("gi", range(len(GRAPHS)))
def test_partition_lp_equals_the_jax_library_at_one_thread(gi):
    src, dst, n = GRAPHS[gi]
    with _omp_threads(1):
        for k, seed in ((4, 0), (40, 3)):
            got = native.partition_lp(src, dst, n, k, 30, seed)
            np.testing.assert_array_equal(got, jax_native.partition_lp(src, dst, n, k, 30, seed))
            assert got.min() >= 0 and got.max() < k


_LP_CASES = ((4, 0), (40, 3))  # (k, seed)
_LP_IN_SUBPROCESS = f"""
import sys
import numpy as np
from dgl_tpu_torch.csrc import native
src, dst, n = np.load(sys.argv[1]), np.load(sys.argv[2]), int(sys.argv[3])
np.save(sys.argv[4], np.stack([native.partition_lp(src, dst, n, k, 30, seed)
                               for k, seed in {_LP_CASES!r}]))
"""


@pytest.mark.parametrize("gi", range(len(GRAPHS)))
def test_partition_lp_with_four_threads_equals_the_jax_library_at_one_thread(gi, tmp_path):
    """The port's binding in a process of OMP_NUM_THREADS=4 against the JAX
    binding at one thread in this one."""
    src, dst, n = GRAPHS[gi]
    np.save(tmp_path / "src.npy", src)
    np.save(tmp_path / "dst.npy", dst)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=root)
    out = tmp_path / "parts.npy"
    subprocess.run([sys.executable, "-c", _LP_IN_SUBPROCESS, str(tmp_path / "src.npy"),
                    str(tmp_path / "dst.npy"), str(n), str(out)],
                   env=env, cwd=root, check=True, timeout=120)
    with _omp_threads(1):
        want = np.stack([jax_native.partition_lp(src, dst, n, k, 30, seed)
                         for k, seed in _LP_CASES])
    np.testing.assert_array_equal(np.load(out), want)


@pytest.mark.parametrize("method", ["metis", "lp", "random"])
def test_partition_assignment_matches_the_jax_module(tmp_path, method):
    src, dst, n = GRAPHS[1]
    k = 25
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    with _omp_threads(1):
        got = partition.partition_assignment(src, dst, n, k, method=method, seed=3,
                                             cache_dir=str(mine), cache_key="g")
        want = jax_partition.partition_assignment(src, dst, n, k, method=method, seed=3,
                                                  cache_dir=str(theirs), cache_key="g")
    np.testing.assert_array_equal(got, want)
    assert os.listdir(mine) == os.listdir(theirs) and len(os.listdir(mine)) == 1
    # each package reads the other's file (a cache hit returns the file's array)
    cached = np.full(n, k - 1)
    np.save(mine / os.listdir(mine)[0], cached)
    np.testing.assert_array_equal(
        jax_partition.partition_assignment(src, dst, n, k, method=method, seed=3,
                                           cache_dir=str(mine), cache_key="g"), cached)
    np.testing.assert_array_equal(
        partition.partition_assignment(src, dst, n, k, method=method, seed=3,
                                       cache_dir=str(theirs), cache_key="g"), want)
    assert partition.partition_stats(src, dst, got, k) == jax_partition.partition_stats(
        src, dst, want, k)
    lists = partition.get_partition_list(got, k)
    for a, b in zip(lists, jax_partition.get_partition_list(want, k), strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(np.concatenate(lists)), np.arange(n))


def test_balance_matches_the_jax_module():
    rng = np.random.default_rng(2)
    part = np.where(rng.random(3000) < 0.6, 0, rng.integers(0, 30, 3000))
    np.testing.assert_array_equal(partition._balance(part, 30), jax_partition._balance(part, 30))
    assert partition._balance(part, 30).max() < 30


def test_a_concurrent_cache_write_leaves_one_whole_file(tmp_path):
    src, dst, n = GRAPHS[0]
    outs, errs = [], []

    def work():
        try:
            outs.append(partition.partition_assignment(src, dst, n, 9, method="metis",
                                                       cache_dir=str(tmp_path), cache_key="c"))
        except BaseException as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=work) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".npy"), files
    whole = np.load(tmp_path / files[0])
    for o in outs:
        np.testing.assert_array_equal(o, whole)


def test_unknown_method_raises():
    src, dst, n = GRAPHS[0]
    with pytest.raises(ValueError, match="unknown partition method"):
        partition.partition_assignment(src, dst, n, 4, method="spectral")


def test_the_omp_runtime_is_shared():
    """Both libraries resolve the same OpenMP runtime, so _omp_threads sets
    the JAX library's team size too."""
    ours = ctypes.cast(native.load().omp_set_num_threads, ctypes.c_void_p).value
    theirs = ctypes.cast(jax_native.get_lib().omp_set_num_threads, ctypes.c_void_p).value
    assert ours == theirs
