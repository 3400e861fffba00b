"""Port parity: the graph-classification data (the synthetic generator and
the canonical graphs npz, bit for bit) and the drivers' loss and metric
helpers (integer-label cross-entropy, the rank ROC-AUC with ties) against
the JAX package's."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgl_tpu.data import loaders as jax_loaders
from dgl_tpu.data import synthetic as jax_synthetic
from dgl_tpu_torch.benchmarks import common
from dgl_tpu_torch.data import load_graph_dataset, loaders as torch_loaders
from dgl_tpu_torch.data import synthetic as torch_synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_common():
    """The JAX drivers' ``benchmarks/common.py`` (not a package module)."""
    spec = importlib.util.spec_from_file_location(
        "jax_benchmarks_common", os.path.join(ROOT, "benchmarks", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same_graph_data(got, ref):
    assert got.name == ref.name and got.num_classes == ref.num_classes
    assert got.synthetic == ref.synthetic
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert got.labels.dtype == ref.labels.dtype
    assert len(got.graphs) == len(ref.graphs)
    for (s, d, n), (rs, rd, rn) in zip(got.graphs, ref.graphs):
        assert n == rn and s.dtype == rs.dtype and d.dtype == rd.dtype
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(d, rd)
    for a, b in zip(got.node_feats, ref.node_feats):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.edge_feats, ref.edge_feats):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (got.splits is None) == (ref.splits is None)
    for k in (got.splits or {}):
        np.testing.assert_array_equal(got.splits[k], ref.splits[k])


def test_graph_dataset_stats_match():
    assert torch_synthetic.GRAPH_DATASET_STATS == jax_synthetic.GRAPH_DATASET_STATS


@pytest.mark.parametrize("name,num_graphs,seed", [
    ("ENZYMES", 40, 0), ("ENZYMES", 25, 3), ("ogbg-molhiv", 40, 0), ("ogbg-ppa", 12, 1),
])
def test_synthetic_graph_classification_bitwise(name, num_graphs, seed):
    ref = jax_synthetic.synthetic_graph_classification(name, seed=seed, num_graphs=num_graphs)
    got = torch_synthetic.synthetic_graph_classification(name, seed=seed, num_graphs=num_graphs)
    _assert_same_graph_data(got, ref)


def test_synthetic_graph_classification_rejects_unknown():
    with pytest.raises(ValueError, match="unknown dataset"):
        torch_synthetic.synthetic_graph_classification("ogbg-code2")


def _write_graphs_npz(path, data, splits=True):
    """A canonical graphs npz of ``data`` (the layout of the JAX package's
    ``tools/convert_dataset.py``)."""
    eo = np.cumsum([0] + [len(s) for s, _, _ in data.graphs])
    no = np.cumsum([0] + [n for _, _, n in data.graphs])
    arrays = dict(
        src=np.concatenate([s for s, _, _ in data.graphs]).astype(np.int32),
        dst=np.concatenate([d for _, d, _ in data.graphs]).astype(np.int32),
        edge_offsets=eo, node_offsets=no,
        num_nodes=np.asarray([n for _, _, n in data.graphs]),
        node_feat=np.concatenate(data.node_feats), labels=data.labels,
    )
    if data.edge_feats[0] is not None:
        arrays["edge_feat"] = np.concatenate(data.edge_feats)
    if splits:
        g = len(data.graphs)
        arrays.update(split_train=np.arange(0, g, 2), split_valid=np.arange(1, g, 4),
                      split_test=np.arange(3, g, 4))
    np.savez(path, **arrays)


@pytest.mark.parametrize("name,splits", [("ogbg-molhiv", True), ("ENZYMES", False)])
def test_canonical_graphs_npz_reader_bitwise(tmp_path, name, splits):
    src = jax_synthetic.synthetic_graph_classification(name, seed=2, num_graphs=30)
    path = tmp_path / f"{name}_graphs.npz"
    _write_graphs_npz(path, src, splits)
    ref = jax_loaders._load_canonical_graphs_npz(str(path), name)
    got = torch_loaders._load_canonical_graphs_npz(str(path), name)
    _assert_same_graph_data(got, ref)
    assert not got.synthetic
    # the search order: the npz first, capped on request as the JAX loader caps it
    for cap in (None, 17):
        _assert_same_graph_data(load_graph_dataset(name, root=str(tmp_path), num_graphs=cap),
                                jax_loaders.load_graph_dataset(name, root=str(tmp_path),
                                                               num_graphs=cap))


def test_load_graph_dataset_falls_back_to_synthetic(tmp_path):
    got = load_graph_dataset("ENZYMES", root=str(tmp_path), seed=4, num_graphs=9)
    _assert_same_graph_data(got, jax_synthetic.synthetic_graph_classification(
        "ENZYMES", seed=4, num_graphs=9))


def test_softmax_ce_int_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((37, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, 37)
    ref = np.asarray(_jax_common().softmax_ce_int(jnp.asarray(logits), jnp.asarray(labels)))
    got = common.softmax_ce_int(torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)  # float32


@pytest.mark.parametrize("case", ["random", "ties", "all_tied", "one_class"])
def test_roc_auc_matches_jax(case):
    rng = np.random.default_rng(1)
    scores = rng.standard_normal(200)
    labels = rng.integers(0, 2, 200)
    if case == "ties":
        scores = np.round(scores, 1)  # many tied scores across both classes
    elif case == "all_tied":
        scores = np.zeros(200)
    elif case == "one_class":
        labels = np.ones(200, np.int64)
    ref = _jax_common().roc_auc(scores, labels)
    got = common.roc_auc(scores, labels)
    if case == "one_class":
        assert np.isnan(got) and np.isnan(ref)
    else:
        assert got == ref  # the same float64 arithmetic
    if case == "all_tied":
        assert got == 0.5


def test_logger_scale(capsys):
    log = common.Logger(1, scale=1.0)
    log.add_result(0, (0.9, 0.8, 0.7))
    log.print_statistics(0)
    assert "   Final Test: 0.70" in capsys.readouterr().out
    log = common.Logger(1)
    log.add_result(0, (0.9, 0.8, 0.7))
    log.print_statistics()
    assert "   Final Test: 70.00 ± 0.00" in capsys.readouterr().out
