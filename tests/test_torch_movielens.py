"""The port's MovieLens pipeline against the JAX package's, bit for bit: the
synthetic ml-100k table at the GCMC driver's seed, and the ``u.data`` /
``u.user`` / ``u.item`` fixture of ``tests/test_loaders.py`` read from a data
root of its own. Compared: the rating values and counts, the features,
every relation's canonical ``src``/``dst``/``eid`` in the train, valid and
test encoder graphs, the decoder graphs, their labels (the JAX arrays
without their padding) and the norms."""

import os

import numpy as np
import pytest

from dgl_tpu.data.movielens import load_movielens as jax_load_movielens

from dgl_tpu_torch.data.movielens import ML_SHAPES, load_movielens


def _canonical(jg):
    """A JAX graph's canonical arrays without the padding."""
    e = jg.num_edges
    return (np.asarray(jg.src)[:e], np.asarray(jg.dst)[:e], np.asarray(jg.eid)[:e],
            jg.num_src_nodes, jg.num_dst_nodes)


def _port(g):
    return (g.src.numpy(), g.dst.numpy(), g.eid.numpy(), g.num_src_nodes, g.num_dst_nodes)


def _assert_same(want, got):
    assert got.rating_vals == want.rating_vals
    assert (got.num_users, got.num_movies, got.synthetic) == (
        want.num_users, want.num_movies, want.synthetic)
    for name in ("user_feat", "movie_feat"):
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for split in ("train", "valid", "test"):
        (je, jd, jy), (te, td, ty) = getattr(want, split), getattr(got, split)
        assert te.etypes == je.etypes and dict(te.num_nodes) == dict(je.num_nodes)
        te.validate()
        for et in je.etypes:
            for a, b in zip(_canonical(je[et]), _port(te[et])):
                assert np.array_equal(np.asarray(a), np.asarray(b)), (split, et)
        for a, b in zip(_canonical(jd), _port(td)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (split, "decoder")
        assert ty.dtype == np.int64 and ty.shape == (td.num_edges,)
        assert np.array_equal(np.asarray(jy)[: jd.num_edges], ty), split
    for nt in ("user", "movie"):
        for a, b in zip(want.norms[nt], got.norms[nt]):
            assert np.array_equal(np.asarray(a), b.numpy()), nt


def test_synthetic_ml100k_matches_the_jax_pipeline(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))  # no u.data: the synthetic table
    want = jax_load_movielens("ml-100k", seed=123)
    got = load_movielens("ml-100k", seed=123, device="cpu")
    assert (got.num_users, got.num_movies) == ML_SHAPES["ml-100k"][:2]
    assert len(got.train[2]) == 85_000 and len(got.train[0].relations) == 10
    _assert_same(want, got)


@pytest.fixture
def fixture_root(tmp_path, monkeypatch, rng):
    """``tests/test_loaders.py::test_movielens_fixture``'s files."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    root = os.path.join(str(tmp_path), "ml-100k")
    os.makedirs(root)
    n_u, n_m, n_r = 8, 6, 60
    users = rng.integers(0, n_u, n_r)
    movies = rng.integers(0, n_m, n_r)
    ratings = rng.integers(1, 6, n_r)
    with open(os.path.join(root, "u.data"), "w") as f:
        for u, m, r in zip(users, movies, ratings):
            f.write(f"{u + 1}\t{m + 1}\t{r}\t884182806\n")
    occs = ["artist", "doctor", "engineer"]
    with open(os.path.join(root, "u.user"), "w") as f:
        for u in range(n_u):
            f.write(f"{u + 1}|{20 + u}|{'F' if u % 2 else 'M'}|{occs[u % 3]}|55414\n")
    genres = np.eye(19, dtype=int)
    with open(os.path.join(root, "u.item"), "w", encoding="latin1") as f:
        for m in range(n_m):
            flags = "|".join(str(v) for v in genres[m % 19])
            f.write(f"{m + 1}|Toy Story {m} (199{m})|01-Jan-199{m}||http://x|{flags}\n")
    return root


def test_the_movielens_fixture_matches_the_jax_pipeline(fixture_root):
    want = jax_load_movielens("ml-100k", seed=0)
    got = load_movielens("ml-100k", seed=0, device="cpu")
    assert not got.synthetic and got.user_feat.shape == (8, 5) and got.movie_feat.shape == (6, 320)
    _assert_same(want, got)
