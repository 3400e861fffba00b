"""The port's native neighbour samplers against the JAX package's, bit for
bit in one process (so one OpenMP team size): with and without replacement,
zero-degree seeds, degrees below the fanout (the cyclic fill), hub degrees
far above it and the fanout cap of 64; and the library's build, which a
concurrent build cannot leave half-written and a failed build raises."""

import ctypes
import os
import threading

import numpy as np
import pytest

from dgl_tpu.csrc import native as jax_native

from dgl_tpu_torch.csrc import native


def _csr(rng):
    """An in-edge CSR where nodes 0-9 have no in-edge, 10-59 one to four,
    node 60 is a hub of 3,000 in-edges and the rest ~Poisson(12)."""
    n = 400
    deg = np.zeros(n, np.int64)
    deg[10:60] = rng.integers(1, 5, 50)
    deg[60] = 3000
    deg[61:] = rng.poisson(12, n - 61)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    return indptr, rng.integers(0, n, int(indptr[-1])), n


@pytest.mark.parametrize("replace", [True, False])
@pytest.mark.parametrize("fanout", [1, 3, 10, 25, 64])
def test_samples_equal_the_jax_samplers_bit_for_bit(replace, fanout):
    rng = np.random.default_rng(fanout)
    indptr, indices, n = _csr(rng)
    seeds = np.concatenate([np.arange(70), rng.integers(0, n, 500), [60] * 7])
    ours = native.sample_neighbors if replace else native.sample_neighbors_noreplace
    theirs = jax_native.sample_neighbors if replace else jax_native.sample_neighbors_noreplace
    assert jax_native.get_lib() is not None  # the JAX package's native path, not its fallback
    for seed in (0, 12345, 2**63 - 2):
        got = ours(indptr, indices, seeds, fanout, seed)
        want = theirs(indptr, indices, seeds, fanout, seed)
        assert got.shape == (len(seeds), fanout) and got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    # zero-degree seeds sample themselves
    np.testing.assert_array_equal(got[:10], np.repeat(np.arange(10)[:, None], fanout, 1))
    if not replace:
        for i, v in enumerate(seeds):
            nb = indices[indptr[v]:indptr[v + 1]]
            deg = len(nb)
            if 0 < deg <= fanout:  # all deg neighbours, cyclically
                np.testing.assert_array_equal(got[i], nb[np.arange(fanout) % deg])
            elif deg > fanout:  # distinct slots of the row
                assert len(set(got[i].tolist())) <= fanout
                assert set(got[i].tolist()) <= set(nb.tolist())


def test_the_fanout_cap_and_bad_seeds_raise():
    indptr, indices, n = _csr(np.random.default_rng(0))
    with pytest.raises(ValueError, match="capped at 64"):
        native.sample_neighbors_noreplace(indptr, indices, np.arange(4), 65, 0)
    with pytest.raises(ValueError, match="capped at 64"):
        jax_native.sample_neighbors_noreplace(indptr, indices, np.arange(4), 65, 0)
    with pytest.raises(ValueError, match="out of range"):
        native.sample_neighbors(indptr, indices, np.array([n]), 3, 0)


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Each build writes its own temporary file and renames it into place,
    so however builds interleave, the library a process opens is whole."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as e:  # handed to the test thread
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(paths)) == 1 and os.path.dirname(paths[0]) == str(tmp_path)
    assert os.listdir(tmp_path) == [os.path.basename(paths[0])]  # no temporary file left
    lib = ctypes.CDLL(paths[0])
    assert lib.sample_neighbors and lib.sample_neighbors_noreplace


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "graph_ops.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".so")]
