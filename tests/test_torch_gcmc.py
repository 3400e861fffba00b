"""Port parity for the GCMC layers and model against the JAX package's flax
modules on the same numpy inputs, weights carried by
``gcmc_state_dict_from_flax``, dropout off: ``GCMCGraphConv``,
``GCMCLayer`` (stack, sum, ``share_user_item_param``), ``BiDecoder``,
``DenseBiDecoder``, ``HeteroGraphConv`` (all five aggregations, SAGEConv a
relation, as ``tests/test_gcmc.py`` builds it) and ``GCMCNet``, at a few
relations and narrow widths on bipartite graphs with nodes of no edge.

Tolerances: forward values rtol 1e-4 / atol 1e-5; gradients of every
parameter (and of the decoders' inputs) rtol 1e-4 / atol 1e-4 (float32
sums of tens of terms in another order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import flax.linen as fnn

import dgl_tpu
from dgl_tpu.graph.hetero import HeteroGraph as JaxHeteroGraph
from dgl_tpu.models import GCMCNet as FlaxGCMCNet
from dgl_tpu.nn import BiDecoder as FlaxBiDecoder
from dgl_tpu.nn import DenseBiDecoder as FlaxDenseBiDecoder
from dgl_tpu.nn import GCMCGraphConv as FlaxGCMCGraphConv
from dgl_tpu.nn import GCMCLayer as FlaxGCMCLayer
from dgl_tpu.nn import HeteroGraphConv as FlaxHeteroGraphConv
from dgl_tpu.nn import SAGEConv as FlaxSAGEConv

import dgl_tpu_torch
from dgl_tpu_torch.convert import gcmc_state_dict_from_flax, sage_state_dict_from_flax
from dgl_tpu_torch.graph import HeteroGraph
from dgl_tpu_torch.models import GCMCNet
from dgl_tpu_torch.nn import (BiDecoder, DenseBiDecoder, GCMCGraphConv, GCMCLayer,
                              HeteroGraphConv, SAGEConv)

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
N_U, N_M = 11, 8  # users 9, 10 and movie 7 take no rating


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ratings(seed, n_r=70, ratings=("1", "2", "3")):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, N_U - 2, n_r)
    m = (rng.zipf(1.5, n_r) - 1) % (N_M - 1)  # a popular movie
    r = rng.integers(0, len(ratings), n_r)
    return rng, u, m, r


def _hetero(u, m, r, ratings):
    """The same rating heterograph in both packages."""
    jr, tr = {}, {}
    for k, rating in enumerate(ratings):
        s, d = u[r == k], m[r == k]
        jr[("user", rating, "movie")] = dgl_tpu.from_edges(s, d, N_U, N_M)
        jr[("movie", f"rev-{rating}", "user")] = dgl_tpu.from_edges(d, s, N_M, N_U)
        tr[("user", rating, "movie")] = dgl_tpu_torch.from_edges(s, d, N_U, N_M, device="cpu")
        tr[("movie", f"rev-{rating}", "user")] = dgl_tpu_torch.from_edges(d, s, N_M, N_U,
                                                                          device="cpu")
    nn = {"user": N_U, "movie": N_M}
    return JaxHeteroGraph(jr, nn).validate(), HeteroGraph(tr, nn).validate()


def _norms(rng):
    cu = rng.random((N_U, 1)).astype(np.float32) + 0.1
    cm = rng.random((N_M, 1)).astype(np.float32) + 0.1
    jn = {"user": (jnp.asarray(cu), jnp.asarray(cu)), "movie": (jnp.asarray(cm), jnp.asarray(cm))}
    tn = {"user": (torch.from_numpy(cu), torch.from_numpy(cu)),
          "movie": (torch.from_numpy(cm), torch.from_numpy(cm))}
    return jn, tn


def _load(module, params):
    module.load_state_dict(gcmc_state_dict_from_flax(_np_tree(params)), strict=True)
    return module


def _check_grads(module, jax_grads, convert=gcmc_state_dict_from_flax):
    want = convert(_np_tree(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name, **GRAD)


def test_gcmc_graph_conv_matches_flax():
    rng, u, m, _ = _ratings(0)
    jg, tg = dgl_tpu.from_edges(u, m, N_U, N_M), dgl_tpu_torch.from_edges(u, m, N_U, N_M,
                                                                          device="cpu")
    x = rng.standard_normal((N_U, 5)).astype(np.float32)
    cj = rng.random((N_U, 1)).astype(np.float32)
    ci = rng.random((N_M, 1)).astype(np.float32)
    tgt = rng.standard_normal((N_M, 4)).astype(np.float32)
    conv = FlaxGCMCGraphConv(4)
    params = conv.init(jax.random.PRNGKey(0), jg, (jnp.asarray(x), None), jnp.asarray(cj),
                       jnp.asarray(ci))["params"]

    def loss(p, x):
        out = conv.apply({"params": p}, jg, (x, None), jnp.asarray(cj), jnp.asarray(ci))
        return jnp.sum((out - tgt) ** 2), out

    (_, want), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
    port = _load(GCMCGraphConv(5, 4, device="cpu"), params)
    xt = torch.tensor(x, requires_grad=True)
    out = port(tg, (xt, None), torch.from_numpy(cj), torch.from_numpy(ci))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    _check_grads(port, gp)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **GRAD)


@pytest.mark.parametrize("agg,share", [("stack", False), ("sum", False), ("stack", True)])
def test_gcmc_layer_matches_flax(agg, share):
    ratings = ("1", "2", "3")
    rng, u, m, r = _ratings(1, ratings=ratings)
    jhg, thg = _hetero(u, m, r, ratings)
    jn, tn = _norms(rng)
    d_u, d_m = (6, 6) if share else (6, 9)
    uf = rng.standard_normal((N_U, d_u)).astype(np.float32)
    mf = rng.standard_normal((N_M, d_m)).astype(np.float32)
    tu = rng.standard_normal((N_U, 5)).astype(np.float32)
    tm = rng.standard_normal((N_M, 5)).astype(np.float32)
    layer = FlaxGCMCLayer(rating_vals=list(ratings), msg_units=12, out_units=5, agg=agg,
                          agg_act=fnn.leaky_relu, share_user_item_param=share)
    params = layer.init(jax.random.PRNGKey(1), jhg, uf, mf, jn)["params"]

    def loss(p):
        a, b = layer.apply({"params": p}, jhg, uf, mf, jn)
        return jnp.sum((a - tu) ** 2) + jnp.sum((b - tm) ** 2), (a, b)

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = _load(GCMCLayer(list(ratings), d_u, d_m, 12, 5, agg=agg, agg_act=F.leaky_relu,
                           share_user_item_param=share, device="cpu"), params)
    a, b = port(thg, torch.from_numpy(uf), torch.from_numpy(mf), tn)
    for got, w in zip((a, b), want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), **FWD)
    (((a - torch.from_numpy(tu)) ** 2).sum() + ((b - torch.from_numpy(tm)) ** 2).sum()).backward()
    _check_grads(port, grads)
    if share:
        assert sorted(k for k in dict(port.named_parameters()) if k.startswith("W_r")) == [
            "W_r.1", "W_r.2", "W_r.3"]
        with pytest.raises(ValueError, match="equal user/movie"):
            GCMCLayer(list(ratings), 6, 7, 12, 5, share_user_item_param=True, device="cpu")


def _decoder_case(seed):
    rng, u, m, _ = _ratings(seed)
    jg, tg = dgl_tpu.from_edges(u, m, N_U, N_M), dgl_tpu_torch.from_edges(u, m, N_U, N_M,
                                                                          device="cpu")
    uf = rng.standard_normal((N_U, 6)).astype(np.float32)
    mf = rng.standard_normal((N_M, 6)).astype(np.float32)
    return rng, jg, tg, uf, mf


def test_bidecoder_matches_flax():
    rng, jg, tg, uf, mf = _decoder_case(2)
    e = tg.num_edges
    tgt = rng.standard_normal((e, 3)).astype(np.float32)
    dec = FlaxBiDecoder(num_classes=3, num_basis=2)
    params = dec.init(jax.random.PRNGKey(2), jg, uf, mf)["params"]

    def loss(p, a, b):
        out = dec.apply({"params": p}, jg, a, b)[:e]  # the padded edges are not scored
        return jnp.sum((out - tgt) ** 2), out

    (_, want), (gp, gu, gm) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        params, uf, mf)
    port = _load(BiDecoder(3, 6, 2, device="cpu"), params)
    ut, mt = torch.tensor(uf, requires_grad=True), torch.tensor(mf, requires_grad=True)
    out = port(tg, ut, mt)
    assert out.shape == (e, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    _check_grads(port, gp)
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(gu), **GRAD)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gm), **GRAD)


def test_dense_bidecoder_matches_flax():
    rng = np.random.default_rng(3)
    uf, mf = (rng.standard_normal((7, 4)).astype(np.float32) for _ in range(2))
    tgt = rng.standard_normal((7, 5)).astype(np.float32)
    dec = FlaxDenseBiDecoder(num_classes=5, num_basis=2)
    params = dec.init(jax.random.PRNGKey(3), uf, mf)["params"]

    def loss(p):
        out = dec.apply({"params": p}, uf, mf)
        return jnp.sum((out - tgt) ** 2), out

    (_, want), gp = jax.value_and_grad(loss, has_aux=True)(params)
    port = _load(DenseBiDecoder(5, 4, 2, device="cpu"), params)
    out = port(torch.from_numpy(uf), torch.from_numpy(mf))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    _check_grads(port, gp)


@pytest.mark.parametrize("agg", ["stack", "sum", "mean", "max", "min"])
def test_hetero_graph_conv_matches_flax(agg):
    rng = np.random.default_rng(4)
    n_a, n_b = 6, 4
    edges = {"r1": (rng.integers(0, n_a, 10), rng.integers(0, n_b, 10), "a"),
             "r2": (rng.integers(0, n_b, 8), rng.integers(0, n_b, 8), "b")}
    nn_ = {"a": n_a, "b": n_b}
    jhg = JaxHeteroGraph({(st, k, "b"): dgl_tpu.from_edges(s, d, nn_[st], n_b)
                          for k, (s, d, st) in edges.items()}, nn_).validate()
    thg = HeteroGraph({(st, k, "b"): dgl_tpu_torch.from_edges(s, d, nn_[st], n_b, device="cpu")
                       for k, (s, d, st) in edges.items()}, nn_).validate()
    feats = {t: rng.standard_normal((n, 3)).astype(np.float32) for t, n in nn_.items()}
    conv = FlaxHeteroGraphConv(convs={"r1": FlaxSAGEConv(5), "r2": FlaxSAGEConv(5)}, agg=agg)
    params = _np_tree(conv.init(jax.random.PRNGKey(4), jhg, feats)["params"])
    want = conv.apply({"params": params}, jhg, feats)
    port = HeteroGraphConv({"r1": SAGEConv(3, 5, device="cpu"), "r2": SAGEConv(3, 5, device="cpu")},
                           agg=agg)
    for rel in ("r1", "r2"):  # flax names each conv convs_<rel>
        sd = sage_state_dict_from_flax({"conv_0": params[f"convs_{rel}"]})
        port.convs[rel].load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    got = port(thg, {t: torch.from_numpy(f) for t, f in feats.items()})
    assert set(got) == {"b"} and got["b"].shape == tuple(want["b"].shape)
    np.testing.assert_allclose(got["b"].detach().numpy(), np.asarray(want["b"]), **FWD)


def test_gcmc_net_matches_flax():
    ratings = ("1", "2", "3", "4", "5")
    rng, u, m, r = _ratings(5, n_r=120, ratings=ratings)
    jhg, thg = _hetero(u, m, r, ratings)
    jn, tn = _norms(rng)
    jd = dgl_tpu.from_edges(u, m, N_U, N_M)
    td = dgl_tpu_torch.from_edges(u, m, N_U, N_M, device="cpu")
    uf = rng.standard_normal((N_U, 7)).astype(np.float32)
    mf = rng.standard_normal((N_M, 9)).astype(np.float32)
    e = td.num_edges
    y = r[td.eid.numpy()]  # labels in canonical order
    net = FlaxGCMCNet(rating_vals=list(ratings), msg_units=20, out_units=6, dropout_rate=0.0)
    params = net.init(jax.random.PRNGKey(5), jhg, jd, uf, mf, jn)["params"]

    def loss(p):
        logits = net.apply({"params": p}, jhg, jd, uf, mf, jn)[:e]
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1)), logits

    (lw, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port = _load(GCMCNet(list(ratings), 7, 9, msg_units=20, out_units=6, dropout_rate=0.0,
                         device="cpu"), params)
    logits = port(thg, td, torch.from_numpy(uf), torch.from_numpy(mf), tn)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want), **FWD)
    lt = F.cross_entropy(logits, torch.from_numpy(y))
    np.testing.assert_allclose(lt.item(), float(lw), **FWD)
    lt.backward()
    _check_grads(port, grads)
