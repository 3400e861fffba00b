"""Port parity for GATConv (both forms), the GAT model and three Adam steps,
against the JAX package's flax modules on the same numpy inputs, with
weights carried by ``gat_state_dict_from_flax``. Dropout is off.

* GATConv's fused form (K3) against the JAX lane path, the Pallas kernel
  run in interpret mode (``DGL_TPU_LANE_INTERPRET=1``, lane plans attached
  in float32), including the narrow case (in < out: aggregate, then W);
  its edge form (K2) against the JAX XLA path.
* The three-layer GAT model in both forms against the JAX XLA path. (The
  JAX lane path computes the same function, as ``tests/test_attention_kernel.py``
  and the GATConv tests here show; compiling three layers of the Pallas
  kernel in interpret mode takes minutes on the CPU.)

Tolerance: 1e-4 relative and absolute on logits and on the gradient of
every parameter (float32, a few layers of sums of tens of terms in another
order; the fused form also shifts its softmax by the exact row maximum).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl_tpu
from dgl_tpu.kernels import attach_lane_plans
from dgl_tpu.models import GAT as FlaxGAT
from dgl_tpu.nn import GATConv as FlaxGATConv

import dgl_tpu_torch
from dgl_tpu_torch.benchmarks.common import masked_softmax_ce
from dgl_tpu_torch.convert import gat_state_dict_from_flax

N, E = 60, 400


def _graph(seed, skew=False, n=N, e=E):
    """Edges into the first 3/4 of the nodes (the rest have in-degree 0)."""
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, e) - 1) % n if skew else rng.integers(0, n, e)
    dst = rng.integers(0, 3 * n // 4, e)
    return rng, src, dst


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conv_case(seed, in_feats, out_feats, heads):
    rng, src, dst = _graph(seed, skew=True)
    x = rng.standard_normal((N, in_feats)).astype(np.float32)
    cot = rng.standard_normal((N, heads, out_feats)).astype(np.float32)
    return rng, src, dst, x, cot


@pytest.mark.parametrize(
    "fused,in_feats,out_feats,heads,residual",
    [(True, 12, 6, 1, False), (True, 5, 9, 2, False), (False, 12, 6, 2, False),
     (False, 7, 4, 3, True)],
    ids=["fused", "fused-narrow", "edge", "edge-residual"],
)
def test_gatconv_matches_flax(monkeypatch, fused, in_feats, out_feats, heads, residual):
    _, src, dst, x, cot = _conv_case(in_feats, in_feats, out_feats, heads)
    g_xla = dgl_tpu.from_edges(src, dst, N)
    if fused:
        monkeypatch.setenv("DGL_TPU_LANE_INTERPRET", "1")
        gj = attach_lane_plans(g_xla, dense_threshold=1, max_expansion=1e9,
                               compute_dtype=jnp.float32)
    else:
        gj = g_xla
    fc = FlaxGATConv(out_feats, num_heads=heads, residual=residual)
    params = _np_tree(fc.init(jax.random.PRNGKey(0), g_xla, jnp.asarray(x))["params"])
    (_, out_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * cot), o))(fc.apply({"params": p}, gj, jnp.asarray(x))),
        has_aux=True))(params)

    tc = dgl_tpu_torch.GATConv(in_feats, out_feats, heads, residual=residual, fused=fused,
                               device="cpu")
    sd = gat_state_dict_from_flax({"gat_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    out_t = tc(gt, torch.from_numpy(x))
    (out_t * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)
    want = gat_state_dict_from_flax({"gat_0": _np_tree(grads_j)})
    for name, p in tc.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[f"convs.0.{name}"].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def _gat_models(fused, gj, x, heads=(2, 2, 1), hidden=3, out=9):
    """hidden·heads = 6 < out = 9: the last layer takes the narrow case."""
    fm = FlaxGAT(hidden_feats=hidden, out_feats=out, heads=heads, remat=False)
    params = _np_tree(fm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x))["params"])
    tm = dgl_tpu_torch.GAT(x.shape[1], hidden, out, heads, fused=fused, device="cpu")
    tm.load_state_dict(gat_state_dict_from_flax(params))
    return fm, params, tm


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "edge"])
def test_gat_model_matches_flax(fused):
    rng, src, dst = _graph(21, skew=True)
    x = rng.standard_normal((N, 10)).astype(np.float32)
    y = rng.integers(0, 9, N)
    mask = (rng.random(N) < 0.6).astype(np.float32)
    gj = dgl_tpu.from_edges(src, dst, N)
    fm, params, tm = _gat_models(fused, gj, x)

    def jax_loss(p):
        logits = fm.apply({"params": p}, gj, jnp.asarray(x))
        logp = jax.nn.log_softmax(logits)
        ce = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1)[:, 0]
        return jnp.sum(ce * mask) / jnp.sum(mask), logits

    (loss_j, logits_j), grads_j = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    logits_t = tm(gt, torch.from_numpy(x))
    loss_t = masked_softmax_ce(logits_t, torch.from_numpy(y), torch.from_numpy(mask))
    loss_t.backward()

    assert logits_t.shape == (N, 9)
    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    want = gat_state_dict_from_flax(_np_tree(grads_j))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_three_adam_steps_with_weight_decay_match_optax():
    rng, src, dst = _graph(31)
    x = rng.standard_normal((N, 10)).astype(np.float32)
    y = rng.integers(0, 9, N)
    mask = (rng.random(N) < 0.6).astype(np.float32)
    gj = dgl_tpu.from_edges(src, dst, N)
    fm, params, tm = _gat_models(False, gj, x)
    lr, wd = 5e-3, 5e-4
    tx = optax.chain(optax.add_decayed_weights(wd), optax.adam(lr))
    state = tx.init(params)

    def jax_loss(p):
        logp = jax.nn.log_softmax(fm.apply({"params": p}, gj, jnp.asarray(x)))
        ce = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1)[:, 0]
        return jnp.sum(ce * mask) / jnp.sum(mask)

    opt = torch.optim.Adam(tm.parameters(), lr=lr, weight_decay=wd)
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    grad_fn = jax.jit(jax.grad(jax_loss))
    for _ in range(3):
        grads = grad_fn(params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        masked_softmax_ce(tm(gt, torch.from_numpy(x)), torch.from_numpy(y),
                          torch.from_numpy(mask)).backward()
        opt.step()
    want = gat_state_dict_from_flax(_np_tree(params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_fused_and_edge_forms_agree_with_dropout_off_and_differ_with_it_on():
    rng, src, dst = _graph(41, skew=True)
    x = torch.from_numpy(rng.standard_normal((N, 10)).astype(np.float32))
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    kw = dict(feat_drop=0.3, attn_drop=0.3, device="cpu")
    models = [dgl_tpu_torch.GAT(10, 4, 5, (2, 2, 1), fused=f, generator=torch.Generator().manual_seed(0),
                                **kw) for f in (True, False)]
    for m in models:
        m.eval()
    torch.testing.assert_close(models[0](gt, x), models[1](gt, x), rtol=1e-5, atol=1e-5)
    # training: the same feature-dropout generator, but the fused form's
    # attention dropout is the edge-id hash, the edge form's a drawn mask
    outs = []
    for m in models:
        m.train()
        outs.append(m(gt, x, generator=torch.Generator().manual_seed(5)))
    assert all(torch.isfinite(o).all() for o in outs) and not torch.allclose(outs[0], outs[1])


def test_gat_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the error raised where there is no card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dgl_tpu_torch.GAT(4, 2, 3, (1, 1))
    with pytest.raises(NotImplementedError, match="slice E"):
        dgl_tpu_torch.GATConv(4, 2, device="cpu")(None, (torch.zeros(3, 4), torch.zeros(2, 4)))
