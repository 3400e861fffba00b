"""Port parity: GCNConv, GCNConvEdge, the OGB encoders and both GCN graph
classifiers against the JAX package's flax modules on its padded batches,
with weights carried by ``convert.py``; dropout off; values, parameter
gradients and BN statistics, float32 on the CPU. The port's batch has no
padding: its outputs are held to the JAX rows of the real nodes, edges and
graphs, and its BN over all nodes to the JAX masked BN over the real ones."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgl_tpu.data import synthetic as jax_synthetic
from dgl_tpu.graph.batch import batch_graphs as jax_batch_graphs
from dgl_tpu.models import GCNGraphClassifier as FlaxGCNGraph
from dgl_tpu.models import GCNMolClassifier as FlaxGCNMol
from dgl_tpu.nn import AtomEncoder as FlaxAtomEncoder
from dgl_tpu.nn import BondEncoder as FlaxBondEncoder
from dgl_tpu.nn import GCNConv as FlaxGCNConv
from dgl_tpu.nn import GCNConvEdge as FlaxGCNConvEdge

from dgl_tpu_torch.convert import gcn_graph_state_dict_from_flax, gcn_mol_state_dict_from_flax
from dgl_tpu_torch.graph import batch_graphs
from dgl_tpu_torch.models import GCNGraphClassifier, GCNMolClassifier
from dgl_tpu_torch.nn import AtomEncoder, BondEncoder, GCNConv, GCNConvEdge

RTOL, ATOL = 1e-5, 1e-5  # float32; a few layers of sums over tens of terms
# deep stacks with BN divide by per-feature deviations: the gradients of the
# first layers carry the rounding of every layer above them
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Under pytest-xdist several workers share the machine's cores:
    torch's intra-op threads in each would oversubscribe them, and these
    tests run many small ops, which that slows most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _problem(name, n_graphs, seed):
    data = jax_synthetic.synthetic_graph_classification(name, seed=seed, num_graphs=n_graphs)
    jb = jax_batch_graphs(data.graphs)
    tb = batch_graphs(data.graphs, device="cpu")
    n, e = tb.graph.num_dst_nodes, tb.graph.num_edges
    nf = np.concatenate(data.node_feats)
    nf_pad = np.zeros((jb.num_nodes_padded,) + nf.shape[1:], nf.dtype)
    nf_pad[:n] = nf
    ef = ef_pad = None
    if data.edge_feats[0] is not None:
        ef = np.concatenate(data.edge_feats)[tb.graph.eid.numpy()]  # canonical order
        ef_pad = np.zeros((jb.graph.src.shape[0],) + ef.shape[1:], ef.dtype)
        ef_pad[:e] = ef
    return data, jb, tb, (nf, nf_pad), (ef, ef_pad)


def _compare_grads(sd_grads, model):
    params = dict(model.named_parameters())
    assert set(sd_grads) == set(params)
    for k, g_ref in sd_grads.items():
        np.testing.assert_allclose(params[k].grad.numpy(), g_ref.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("lowering", ["fused", "scatter"])
def test_gcnconv_matches_flax(lowering):
    _, jb, tb, (nf, nf_pad), _ = _problem("ENZYMES", 9, 0)
    n = nf.shape[0]
    fm = FlaxGCNConv(16)
    params = _np_tree(fm.init(jax.random.PRNGKey(0), jb.graph, jnp.asarray(nf_pad))["params"])
    cot = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)

    def f(p):
        out = fm.apply({"params": p}, jb.graph, jnp.asarray(nf_pad))[:n]
        return jnp.sum(out * cot), out

    (_, ref), grads = jax.value_and_grad(f, has_aux=True)(params)
    tm = GCNConv(nf.shape[1], 16, lowering=lowering, device="cpu")
    tm.load_state_dict({"fc.weight": torch.from_numpy(np.asarray(params["fc"]["kernel"]).T.copy())})
    x = torch.from_numpy(nf).requires_grad_()
    out = tm(tb.graph, x)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.fc.weight.grad.numpy(), np.asarray(grads["fc"]["kernel"]).T,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lowering", ["fused", "scatter"])
def test_gcnconv_edge_matches_flax(lowering):
    _, jb, tb, _, _ = _problem("ogbg-molhiv", 8, 1)
    rng = np.random.default_rng(2)
    n, e, n_pad, e_pad = tb.graph.num_dst_nodes, tb.graph.num_edges, jb.num_nodes_padded, \
        jb.graph.src.shape[0]
    x = np.zeros((n_pad, 12), np.float32)
    x[:n] = rng.standard_normal((n, 12))
    w = np.zeros((e_pad, 16), np.float32)
    w[:e] = rng.standard_normal((e, 16))
    fm = FlaxGCNConvEdge(16)
    params = _np_tree(fm.init(jax.random.PRNGKey(3), jb.graph, jnp.asarray(x), jnp.asarray(w))
                      ["params"])
    cot = rng.standard_normal((n, 16)).astype(np.float32)

    def f(p, xx, ww):
        out = fm.apply({"params": p}, jb.graph, xx, ww)[:n]
        return jnp.sum(out * cot), out

    (_, ref), (gp, gx, gw) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(w))
    tm = GCNConvEdge(12, 16, lowering=lowering, device="cpu")
    tm.load_state_dict({"fc.weight": torch.from_numpy(np.asarray(params["fc"]["kernel"]).T.copy()),
                        "root_emb": torch.from_numpy(np.array(params["root_emb"]))})
    xt = torch.from_numpy(x[:n]).requires_grad_()
    wt = torch.from_numpy(w[:e]).requires_grad_()
    out = tm(tb.graph, xt, wt)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx)[:n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw)[:e], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.root_emb.grad.numpy(), np.asarray(gp["root_emb"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tm.fc.weight.grad.numpy(), np.asarray(gp["fc"]["kernel"]).T,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flax_cls,torch_cls,cols", [
    (FlaxAtomEncoder, AtomEncoder, 9), (FlaxBondEncoder, BondEncoder, 3)])
def test_encoders_match_flax_and_clip(flax_cls, torch_cls, cols):
    rng = np.random.default_rng(4)
    idx = rng.integers(-3, 130, (50, cols)).astype(np.int32)  # out-of-vocabulary both ways
    fm = flax_cls(8)
    params = _np_tree(fm.init(jax.random.PRNGKey(5), jnp.asarray(idx))["params"])
    cot = rng.standard_normal((50, 8)).astype(np.float32)
    out_ref = np.asarray(fm.apply({"params": params}, jnp.asarray(idx)))
    grads = jax.grad(lambda p: jnp.sum(fm.apply({"params": p}, jnp.asarray(idx)) * cot))(params)
    tm = torch_cls(8, device="cpu", generator=torch.Generator().manual_seed(0))
    tm.load_state_dict({f"embs.{int(k.split('_')[1])}.weight": torch.from_numpy(np.array(v["embedding"]))
                        for k, v in params.items()})
    out = tm(torch.from_numpy(idx))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_ref, rtol=RTOL, atol=ATOL)
    for k, v in grads.items():
        np.testing.assert_allclose(tm.embs[int(k.split("_")[1])].weight.grad.numpy(),
                                   np.asarray(v["embedding"]), rtol=RTOL, atol=ATOL)
    # the init: every table xavier-uniform, inside its bound
    fresh = torch_cls(8, device="cpu", generator=torch.Generator().manual_seed(0))
    for emb in fresh.embs:
        bound = np.sqrt(6.0 / sum(emb.weight.shape))
        assert emb.weight.abs().max() <= bound and emb.weight.std() > bound / 3


def _run_flax(fm, variables, args, cot, train):
    def f(p):
        if train:
            out, state = fm.apply({"params": p, "batch_stats": variables["batch_stats"]}, *args,
                                  deterministic=False, mutable=["batch_stats"])
        else:
            out, state = fm.apply({"params": p, "batch_stats": variables["batch_stats"]}, *args,
                                  deterministic=True), {}
        out = out[: cot.shape[0]]
        return jnp.sum(out * cot), (out, state)

    (_, (out, state)), grads = jax.value_and_grad(f, has_aux=True)(variables["params"])
    return np.asarray(out), _np_tree(grads), _np_tree(state.get("batch_stats", {}))


@pytest.mark.parametrize("train", [True, False])
def test_gcn_graph_classifier_matches_flax(train):
    data, jb, tb, (nf, nf_pad), _ = _problem("ENZYMES", 10, 6)
    fm = FlaxGCNGraph(hidden_feats=16, num_classes=6, num_layers=3, dropout=0.0)
    variables = _np_tree(fm.init(jax.random.PRNGKey(7), jb, jnp.asarray(nf_pad)))
    if not train:  # running statistics away from their initial values
        rng = np.random.default_rng(8)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
            variables["batch_stats"])
    cot = np.random.default_rng(9).standard_normal((10, 6)).astype(np.float32)
    ref, grads, stats = _run_flax(fm, variables, (jb, jnp.asarray(nf_pad)), cot, train)
    tm = GCNGraphClassifier(nf.shape[1], 16, 6, num_layers=3, dropout=0.0, device="cpu")
    tm.load_state_dict(gcn_graph_state_dict_from_flax(variables["params"],
                                                      variables["batch_stats"]))
    tm.train(train)
    out = tm(tb, torch.from_numpy(nf))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    _compare_grads(gcn_graph_state_dict_from_flax(grads), tm)
    if train:
        sd = gcn_graph_state_dict_from_flax(variables["params"], stats)
        for k, v in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,lowering,train", [
    ("ogbg-molhiv", "fused", True), ("ogbg-molhiv", "scatter", True),
    ("ogbg-molhiv", "fused", False), ("ogbg-ppa", "fused", True),
])
def test_gcn_mol_classifier_matches_flax(name, lowering, train):
    data, jb, tb, (nf, nf_pad), (ef, ef_pad) = _problem(name, 9, 10)
    mol = name == "ogbg-molhiv"
    kw = dict(emb_dim=16, num_classes=1 if mol else 37, num_layers=3, dropout=0.0,
              node_encoder="atom" if mol else "embed", edge_encoder="bond" if mol else 7)
    fm = FlaxGCNMol(**kw)
    args = (jb, jnp.asarray(nf_pad), jnp.asarray(ef_pad))
    variables = _np_tree(fm.init(jax.random.PRNGKey(11), *args))
    cot = np.random.default_rng(12).standard_normal((9, kw["num_classes"])).astype(np.float32)
    ref, grads, stats = _run_flax(fm, variables, args, cot, train)
    tm = GCNMolClassifier(**kw, lowering=lowering, device="cpu")
    tm.load_state_dict(gcn_mol_state_dict_from_flax(variables["params"], variables["batch_stats"]))
    tm.train(train)
    out = tm(tb, torch.from_numpy(nf), torch.from_numpy(ef))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    _compare_grads(gcn_mol_state_dict_from_flax(grads), tm)
    if train:
        sd = gcn_mol_state_dict_from_flax(variables["params"], stats)
        for k, v in tm.state_dict().items():
            if "running" in k:
                np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=RTOL, atol=ATOL)


def test_convert_rejects_unknown_groups_and_models_reject_unknown_encoders():
    with pytest.raises(KeyError, match="unexpected"):
        gcn_graph_state_dict_from_flax({"mlp_0": {}})
    with pytest.raises(KeyError, match="unexpected"):
        gcn_mol_state_dict_from_flax({"head": {}})
    with pytest.raises(ValueError, match="node_encoder"):
        GCNMolClassifier(8, 1, node_encoder="onehot", device="cpu")
    with pytest.raises(ValueError, match="edge_encoder"):
        GCNMolClassifier(8, 1, edge_encoder="linear", device="cpu")
