"""GATConv's memory-safe edge form, taken here by lowering the message limit
(``_EDGE_MSG_LIMIT_BYTES``) with monkeypatch: the same values and
gradients as the port's edge form and as the JAX layer's memory-safe form
(forced with ``DGL_TPU_MSG_BUDGET_GB``: a budget a quarter of which is a
third of the (E, H, D) messages, so its weighted sum also takes its
edge-chunked path, in three chunks), within 1e-5, dropout off; it
runs through ``gspmm_rel`` (weighted K1 launches, H a direction) and builds
no (E, H, D) tensor."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.nn import GATConv as FlaxGATConv

import dgl_tpu_torch
from dgl_tpu_torch.convert import gat_state_dict_from_flax
from dgl_tpu_torch.kernels import csr_spmm as k1_mod
from dgl_tpu_torch.nn import conv as conv_mod

N = 70
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, e=500):
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, e) - 1) % N  # skewed sources
    dst = rng.integers(0, 3 * N // 4, e)  # the last quarter has no in-edge
    dst[: e // 5] = 2  # a hub destination
    return rng, src, dst


def _torch_run(tc, g, x, cot):
    xt = torch.from_numpy(x).requires_grad_()
    tc.zero_grad(set_to_none=True)
    out = tc(g, xt)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = {n: p.grad.clone() for n, p in tc.named_parameters()}
    return out.detach(), xt.grad, grads


@pytest.mark.parametrize("in_feats,out_feats,heads,residual", [(12, 5, 3, True)])
def test_memory_safe_form_matches_the_edge_form_and_the_jax_layer(monkeypatch, in_feats,
                                                                 out_feats, heads, residual):
    rng, src, dst = _case(in_feats)
    x = rng.standard_normal((N, in_feats)).astype(np.float32)
    cot = rng.standard_normal((N, heads, out_feats)).astype(np.float32)

    gj = dgl_tpu.from_edges(src, dst, N)
    msg_bytes = gj.num_edges_padded * heads * out_feats * 4
    monkeypatch.setenv("DGL_TPU_MSG_BUDGET_GB", repr(4 * msg_bytes / 3 / 2**30))
    fc = FlaxGATConv(out_feats, num_heads=heads, residual=residual)
    params = jax.tree_util.tree_map(
        np.asarray, fc.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))["params"])
    (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(
        lambda p, xx: (lambda o: (jnp.sum(o * cot), o))(fc.apply({"params": p}, gj, xx)),
        argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    tc = dgl_tpu_torch.GATConv(in_feats, out_feats, heads, residual=residual, device="cpu")
    sd = gat_state_dict_from_flax({"gat_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})
    g = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    edge = _torch_run(tc, g, x, cot)

    calls = []
    rel = conv_mod.gspmm_rel
    monkeypatch.setattr(conv_mod, "gspmm_rel", lambda *a, **kw: calls.append(1) or rel(*a, **kw))
    k1 = []
    plain = k1_mod.csr_spmm_plain
    monkeypatch.setattr(k1_mod, "csr_spmm_plain",
                        lambda *a, **kw: k1.append(a[2].shape) or plain(*a, **kw))
    assert not calls
    monkeypatch.setattr(conv_mod, "_EDGE_MSG_LIMIT_BYTES", 0)
    safe = _torch_run(tc, g, x, cot)
    assert calls == [1]
    # H weighted K1 launches forward and H backward, each on (N, D) rows
    # (the rest: gather_src_rows' adjoint on the (E, H) logits)
    assert k1.count((N, out_feats)) == 2 * heads

    want = gat_state_dict_from_flax({"gat_0": jax.tree_util.tree_map(np.asarray, gp)})
    for name, (o, gxt, grads) in (("edge", edge), ("memory-safe", safe)):
        np.testing.assert_allclose(o.numpy(), np.asarray(out_j), err_msg=name, **TOL)
        np.testing.assert_allclose(gxt.numpy(), np.asarray(gx), err_msg=name, **TOL)
        for p, gr in grads.items():
            np.testing.assert_allclose(gr.numpy(), want[f"convs.0.{p}"].numpy(),
                                       err_msg=f"{name} {p}", **TOL)


def test_memory_safe_form_builds_no_edge_message(monkeypatch):
    """No tensor of E·H·D elements is allocated: every factory and op output
    stays at most E·H elements or node-sized."""
    rng, src, dst = _case(9, e=3000)
    heads, d = 4, 16
    g = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    tc = dgl_tpu_torch.GATConv(8, d, heads, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(conv_mod, "_EDGE_MSG_LIMIT_BYTES", 0)
    x = torch.from_numpy(rng.standard_normal((N, 8)).astype(np.float32)).requires_grad_()
    biggest = []

    class Watch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    biggest.append(t.numel())
            return out

    with Watch():
        out = tc(g, x)
    out.sum().backward()
    e = g.num_edges
    assert max(biggest) < e * heads * d and max(biggest) >= e * heads
    assert torch.isfinite(x.grad).all()
