"""The port's dataset readers against the JAX package's, bit for bit, on the
fixture files of ``tests/test_loaders.py`` (the exact public layouts):
the canonical node npz, Planetoid pickles, DGL reddit, OGB node csv.gz,
TU text and OGB graph csv.gz, each read through both packages'
``load_node_dataset`` / ``load_graph_dataset`` from one data root; the
convert tool's round trip (the port's tool writes the file the JAX tool
writes, and both packages read it back as the raw files read); and a
present but broken raw file, which the port raises on where the JAX
loader falls back to synthetic data."""

import gzip
import os
import pickle
import sys

import numpy as np
import pytest

from dgl_tpu.data import loaders as jax_loaders

from dgl_tpu_torch.data import loaders
from dgl_tpu_torch.tools import convert_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def data_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    return str(tmp_path)


def _gz(path, arr, fmt):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        np.savetxt(f, arr, delimiter=",", fmt=fmt)


def _write_npz(d, rng):
    n, e = 20, 60
    masks = np.zeros((3, n), bool)
    masks[0, :10], masks[1, 10:15], masks[2, 15:] = True, True, True
    np.savez(os.path.join(d, "mini.npz"), src=rng.integers(0, n, e), dst=rng.integers(0, n, e),
             x=rng.standard_normal((n, 7)).astype(np.float32), y=rng.integers(0, 4, n),
             train=masks[0], val=masks[1], test=masks[2],
             ef=rng.standard_normal((e, 2)).astype(np.float32))
    return "mini"


def _write_planetoid(d, rng):
    """``tests/test_loaders.py``'s cora pickles: the test rows stored in
    sorted-id order, listed unsorted in ``test.index``."""
    import scipy.sparse as sp

    n, n_train, n_test, f, c = 12, 4, 4, 5, 3
    feat = rng.standard_normal((n, f)).astype(np.float32)
    lab = rng.integers(0, c, n)
    test_idx = np.array([10, 8, 11, 9])
    base = n - n_test
    tx, ty = np.zeros((n_test, f), np.float32), np.zeros((n_test, c), np.float32)
    for i, t in enumerate(np.sort(test_idx)):
        tx[t - base] = feat[test_idx[i]]
        ty[t - base, lab[test_idx[i]]] = 1
    ally = np.zeros((base, c), np.float32)
    ally[np.arange(base), lab[:base]] = 1
    root = os.path.join(d, "cora")
    os.makedirs(root)
    objs = {"x": sp.csr_matrix(feat[:n_train]), "tx": sp.csr_matrix(tx),
            "allx": sp.csr_matrix(feat[:base]), "y": ally[:n_train], "ty": ty, "ally": ally,
            "graph": {0: [1, 2], 1: [0], 2: [0, 3], 3: [2], 10: [0], 8: [3]}}
    for suffix, obj in objs.items():
        with open(os.path.join(root, f"ind.cora.{suffix}"), "wb") as fh:
            pickle.dump(obj, fh)
    with open(os.path.join(root, "ind.cora.test.index"), "wb") as fh:
        fh.write("\n".join(str(i) for i in test_idx).encode())
    return "cora"


def _write_reddit(d, rng):
    import scipy.sparse as sp

    n = 15
    src, dst = rng.integers(0, n, 40), rng.integers(0, n, 40)
    a = sp.coo_matrix((np.ones(80), (np.r_[src, dst], np.r_[dst, src])), shape=(n, n)).tocsr()
    a.sum_duplicates()
    root = os.path.join(d, "reddit")
    os.makedirs(root)
    np.savez(os.path.join(root, "reddit_data.npz"),
             feature=rng.standard_normal((n, 6)).astype(np.float32),
             label=rng.integers(0, 5, n), node_types=np.array([1] * 8 + [2] * 3 + [3] * 4))
    sp.save_npz(os.path.join(root, "reddit_graph.npz"), a)
    return "reddit"


def _write_ogb_node(d, rng):
    n, e = 18, 50
    base = os.path.join(d, "ogbn_arxiv")
    _gz(os.path.join(base, "raw", "edge.csv.gz"),
        np.c_[rng.integers(0, n, e), rng.integers(0, n, e)], "%d")
    _gz(os.path.join(base, "raw", "node-feat.csv.gz"),
        rng.standard_normal((n, 4)).astype(np.float32), "%.6f")
    _gz(os.path.join(base, "raw", "node-label.csv.gz"), rng.integers(0, 6, n)[:, None], "%d")
    for part, idx in (("train", np.arange(0, 10)), ("valid", np.arange(10, 14)),
                      ("test", np.arange(14, 18))):
        _gz(os.path.join(base, "split", "time", f"{part}.csv.gz"), idx, "%d")
    return "ogbn-arxiv"


def _write_tu(d, rng):
    root = os.path.join(d, "ENZYMES")
    os.makedirs(root)
    np.savetxt(os.path.join(root, "ENZYMES_A.txt"), [[1, 2], [2, 3], [3, 1], [4, 5], [5, 4]],
               fmt="%d", delimiter=", ")
    np.savetxt(os.path.join(root, "ENZYMES_graph_indicator.txt"), [1, 1, 1, 2, 2], fmt="%d")
    np.savetxt(os.path.join(root, "ENZYMES_graph_labels.txt"), [2, 6], fmt="%d")
    np.savetxt(os.path.join(root, "ENZYMES_node_attributes.txt"),
               rng.standard_normal((5, 18)).astype(np.float32), delimiter=",", fmt="%.6f")
    return "ENZYMES"


def _write_ogb_graphs(d, rng):
    raw = os.path.join(d, "ogbg_molhiv", "raw")
    _gz(os.path.join(raw, "edge.csv.gz"), [[0, 1], [1, 0], [0, 2], [2, 1], [1, 0]], "%d")
    _gz(os.path.join(raw, "num-node-list.csv.gz"), [[2], [3], [2]], "%d")
    _gz(os.path.join(raw, "num-edge-list.csv.gz"), [[2], [2], [1]], "%d")
    _gz(os.path.join(raw, "graph-label.csv.gz"), [[0], [1], [0]], "%d")
    _gz(os.path.join(raw, "node-feat.csv.gz"), rng.integers(0, 10, (7, 9)), "%d")
    _gz(os.path.join(raw, "edge-feat.csv.gz"), rng.integers(0, 4, (5, 3)), "%d")
    split = os.path.join(d, "ogbg_molhiv", "split", "scaffold")
    for part, i in (("train", 0), ("valid", 1), ("test", 2)):
        _gz(os.path.join(split, f"{part}.csv.gz"), [[i]], "%d")
    return "ogbg-molhiv"


def _same(a, b):
    """Equal values, dtypes and shapes, through nested dicts and sequences."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _assert_same_data(want, got):
    assert type(want).__name__ == type(got).__name__
    fields = want.__dataclass_fields__
    assert fields.keys() == got.__dataclass_fields__.keys()
    for f in fields:
        assert _same(getattr(want, f), getattr(got, f)), f
    assert not got.synthetic


NODE_FIXTURES = {"npz": _write_npz, "planetoid": _write_planetoid, "reddit": _write_reddit,
                 "ogb_node": _write_ogb_node}
GRAPH_FIXTURES = {"tu": _write_tu, "ogb_graphs": _write_ogb_graphs}


@pytest.mark.parametrize("kind", sorted(NODE_FIXTURES) + sorted(GRAPH_FIXTURES))
def test_each_fixture_reads_as_the_jax_loader_reads_it(data_dir, rng, kind):
    if kind in NODE_FIXTURES:
        name = NODE_FIXTURES[kind](data_dir, rng)
        _assert_same_data(jax_loaders.load_node_dataset(name), loaders.load_node_dataset(name))
    else:
        name = GRAPH_FIXTURES[kind](data_dir, rng)
        _assert_same_data(jax_loaders.load_graph_dataset(name), loaders.load_graph_dataset(name))


def _jax_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import convert_dataset as tool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    return tool


@pytest.mark.parametrize("kind", ["tu", "ogb_graphs", "ogb_node"])
def test_the_convert_tools_round_trip(data_dir, tmp_path, rng, kind, monkeypatch):
    """The port's tool and the JAX tool write the same canonical arrays, and
    both packages read the file as they read the raw files."""
    writer, graph = {**NODE_FIXTURES, **GRAPH_FIXTURES}[kind], kind in GRAPH_FIXTURES
    name = writer(data_dir, rng)
    load = loaders.load_graph_dataset if graph else loaders.load_node_dataset
    jax_load = jax_loaders.load_graph_dataset if graph else jax_loaders.load_node_dataset
    raw = load(name)
    file = f"{name}_graphs.npz" if graph else f"{name}.npz"
    jax_root = tmp_path / "jax_tool"
    jax_root.mkdir()
    for path in os.listdir(data_dir):  # the JAX tool's copy of the raw files
        if path != "jax_tool":
            os.symlink(os.path.join(data_dir, path), jax_root / path)
    monkeypatch.setattr(sys, "argv", ["convert_dataset.py", "graph" if graph else "node", name,
                                      "--root", str(jax_root)])
    _jax_tool().main()
    convert_dataset.main(["graph" if graph else "node", name])
    ours, theirs = np.load(os.path.join(data_dir, file)), np.load(jax_root / file)
    assert sorted(ours.files) == sorted(theirs.files)
    for k in ours.files:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    _assert_same_data(raw, load(name))
    _assert_same_data(jax_load(name), load(name))


@pytest.mark.parametrize("kind", ["ogb_node", "tu"])
def test_a_broken_raw_file_raises(data_dir, rng, kind):
    """The JAX loader prints the error and returns synthetic data; the port
    raises it."""
    if kind == "ogb_node":
        name = _write_ogb_node(data_dir, rng)
        with gzip.open(os.path.join(data_dir, "ogbn_arxiv", "raw", "node-label.csv.gz"),
                       "wt") as f:
            f.write("not,a,label\n")
        assert jax_loaders.load_node_dataset(name, scale=0.01).synthetic
        with pytest.raises(ValueError):
            loaders.load_node_dataset(name, scale=0.01)
    else:
        name = _write_tu(data_dir, rng)
        os.remove(os.path.join(data_dir, "ENZYMES", "ENZYMES_graph_labels.txt"))
        assert jax_loaders.load_graph_dataset(name, num_graphs=4).synthetic
        with pytest.raises(OSError):
            loaders.load_graph_dataset(name, num_graphs=4)
