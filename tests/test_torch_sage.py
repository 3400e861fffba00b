"""Port parity: SAGEConv, GraphSAGE (citation and BN variants), masked
cross-entropy gradients, Adam steps and BN statistics against the flax
models of the JAX package, with weights carried by sage_state_dict_from_flax.
Dropout is off; everything is float32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl_tpu
from dgl_tpu.models import GraphSAGE as FlaxGraphSAGE
from dgl_tpu.nn import SAGEConv as FlaxSAGEConv

import dgl_tpu_torch
from dgl_tpu_torch import bench
from dgl_tpu_torch.benchmarks.common import masked_softmax_ce
from dgl_tpu_torch.convert import sage_state_dict_from_flax
from dgl_tpu_torch.nn import MaskedBatchNorm
from dgl_tpu_torch.train import EpochTimer

N, E, IN, HID, OUT = 200, 2000, 24, 16, 5


def _problem(seed=0, in_feats=IN):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, E)
    dst = rng.integers(0, 3 * N // 4, E)  # the last quarter has no in-edges
    x = rng.standard_normal((N, in_feats)).astype(np.float32)
    y = rng.integers(0, OUT, N)
    mask = (rng.random(N) < 0.6).astype(np.float32)
    gj = dgl_tpu.from_edges(src, dst, N)
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    return gj, gt, x, y, mask


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_loss(logits, y, mask):
    logp = jax.nn.log_softmax(logits)
    ce = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1)[:, 0]
    m = jnp.asarray(mask)
    return jnp.sum(ce * m) / jnp.sum(m)


def _torch_loss(logits, y, mask):
    return masked_softmax_ce(logits, torch.from_numpy(y), torch.from_numpy(mask))


def _models(variant, gj, x):
    if variant == "citation":
        kw = dict(hidden_feats=HID, out_feats=OUT, num_layers=2, dropout=0.0)
    else:
        kw = dict(hidden_feats=32, out_feats=OUT, num_layers=3, dropout=0.0, batch_norm=True)
    fm = FlaxGraphSAGE(**kw)
    variables = _np_tree(fm.init(jax.random.PRNGKey(1), gj, jnp.asarray(x)))
    tm = dgl_tpu_torch.GraphSAGE(x.shape[1], **kw, device="cpu")
    tm.load_state_dict(sage_state_dict_from_flax(variables["params"], variables.get("batch_stats")))
    return fm, variables, tm


@pytest.mark.parametrize(
    "in_feats,out_feats,aggr,relu",
    [(24, 8, "mean", False), (8, 24, "sum", True), (16, 16, "mean", False)],
)
def test_sageconv_matches_flax(in_feats, out_feats, aggr, relu):
    gj, gt, x, _, _ = _problem(1, in_feats)
    fc = FlaxSAGEConv(out_feats, aggr=aggr, activation=jax.nn.relu if relu else None)
    params = _np_tree(fc.init(jax.random.PRNGKey(0), gj, jnp.asarray(x))["params"])
    ref = np.asarray(fc.apply({"params": params}, gj, jnp.asarray(x)))
    tc = dgl_tpu_torch.SAGEConv(in_feats, out_feats, aggr,
                                activation=torch.relu if relu else None, device="cpu")
    sd = sage_state_dict_from_flax({"conv_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})
    got = tc(gt, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["citation", "bn"])
def test_graphsage_logits_and_grads_match_flax(variant):
    gj, gt, x, y, mask = _problem(2)
    fm, variables, tm = _models(variant, gj, x)

    ref = np.asarray(fm.apply(variables, gj, jnp.asarray(x), deterministic=True))
    tm.eval()
    got = tm(gt, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)

    # training-mode gradients (BN on batch statistics)
    def loss_fn(p):
        logits, _ = fm.apply({**variables, "params": p}, gj, jnp.asarray(x),
                             deterministic=False, mutable=["batch_stats"])
        return _jax_loss(logits, y, mask)

    grads = sage_state_dict_from_flax(_np_tree(jax.grad(loss_fn)(variables["params"])))
    tm.train()
    _torch_loss(tm(gt, torch.from_numpy(x)), y, mask).backward()
    named = dict(tm.named_parameters())
    assert set(grads) == set(named)
    for name, g_ref in grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g_ref.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_three_adam_steps_match_optax():
    gj, gt, x, y, mask = _problem(3)
    fm, variables, tm = _models("citation", gj, x)

    tx = optax.chain(optax.add_decayed_weights(5e-4), optax.adam(1e-2))
    params = variables["params"]
    state = tx.init(params)
    grad_fn = jax.grad(lambda p: _jax_loss(
        fm.apply({"params": p}, gj, jnp.asarray(x), deterministic=False), y, mask))
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2, weight_decay=5e-4)
    tm.train()
    for _ in range(3):
        up, state = tx.update(grad_fn(params), state, params)
        params = optax.apply_updates(params, up)
        opt.zero_grad()
        _torch_loss(tm(gt, torch.from_numpy(x)), y, mask).backward()
        opt.step()
    ref = sage_state_dict_from_flax(_np_tree(params))
    got = tm.state_dict()
    for name, v in ref.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("variant", ["citation", "bn"])
def test_hoisted_x_agg_equals_unhoisted(variant):
    gj, gt, x, y, mask = _problem(4)
    _, _, tm = _models(variant, gj, x)
    xt = torch.from_numpy(x)
    x_agg = dgl_tpu_torch.gspmm(gt, "copy_u", "mean", x=xt)
    tm.eval()
    outs, grads = [], []
    for kw in ({}, {"x_agg": x_agg}):
        tm.zero_grad()
        out = tm(gt, xt, **kw)
        _torch_loss(out, y, mask).backward()
        outs.append(out.detach().numpy())
        grads.append({k: p.grad.clone() for k, p in tm.named_parameters()})
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-4, atol=1e-6)
    conv = dgl_tpu_torch.SAGEConv(IN, HID, feat_drop=0.5, device="cpu")
    with pytest.raises(ValueError, match="feat_drop"):
        conv(gt, xt, x_agg=x_agg)


def test_bn_running_stats_after_one_step_match_flax():
    gj, gt, x, _, _ = _problem(5)
    fm, variables, tm = _models("bn", gj, x)
    _, upd = fm.apply(variables, gj, jnp.asarray(x), deterministic=False, mutable=["batch_stats"])
    tm.train()
    tm(gt, torch.from_numpy(x))
    ref = sage_state_dict_from_flax(variables["params"], _np_tree(upd["batch_stats"]))
    got = tm.state_dict()
    for name in [k for k in ref if "running" in k]:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize(
    "entry",
    [
        lambda: dgl_tpu_torch.from_edges([0], [1], 2),
        lambda: dgl_tpu_torch.SAGEConv(4, 2),
        lambda: dgl_tpu_torch.GraphSAGE(4, 8, 2),
        lambda: MaskedBatchNorm(4),
        lambda: EpochTimer(),
        lambda: bench.run("cora", 1, 0),
    ],
    ids=["from_edges", "SAGEConv", "GraphSAGE", "MaskedBatchNorm", "EpochTimer", "bench.run"],
)
def test_entry_points_default_to_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("checks the machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
