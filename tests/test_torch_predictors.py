"""The port's link predictors against the JAX package's flax modules on the
same numpy inputs, with the MLP weights carried by
``predictor_state_dict_from_flax``: scores and the gradients of the
embeddings and of every weight within 1e-5 (float32 sums of a few terms in
another order). Dropout is off."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.nn import DotPredictor as FlaxDot
from dgl_tpu.nn import MLPPredictor as FlaxMLP
from dgl_tpu.nn import PairMLPPredictor as FlaxPair

import dgl_tpu_torch
from dgl_tpu_torch.convert import predictor_state_dict_from_flax
from dgl_tpu_torch.nn import DotPredictor, MLPPredictor, PairMLPPredictor

N, E, D, HID = 40, 300, 6, 8
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, N, E), rng.integers(0, N - 5, E)
    h = rng.standard_normal((N, D)).astype(np.float32)
    return rng, src, dst, h


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _check_grads(module, want_sd, names=None):
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_sd[name].numpy(), err_msg=name, **TOL)


def test_dot_predictor_matches_flax():
    rng, src, dst, h = _case(0)
    gj = dgl_tpu.from_edges(src, dst, N)
    cot = rng.standard_normal(E).astype(np.float32)
    fm = FlaxDot()
    params = fm.init(jax.random.PRNGKey(0), gj, jnp.asarray(h))

    def f(hh):
        s = fm.apply(params, gj, hh)
        return jnp.sum(s[:E] * jnp.asarray(cot)), s[:E]

    (_, sj), gh = jax.value_and_grad(f, has_aux=True)(jnp.asarray(h))
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    ht = torch.from_numpy(h).requires_grad_()
    st = DotPredictor()(gt, ht)
    (st * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), **TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **TOL)


@pytest.mark.parametrize("layers", [1, 3])
def test_mlp_predictor_matches_flax(layers):
    rng, src, dst, h = _case(layers)
    gj = dgl_tpu.from_edges(src, dst, N)
    cot = rng.standard_normal(E).astype(np.float32)
    fm = FlaxMLP(hidden=HID, num_layers=layers)
    params = _np(fm.init(jax.random.PRNGKey(1), gj, jnp.asarray(h))["params"])

    def f(p, hh):
        s = fm.apply({"params": p}, gj, hh)
        return jnp.sum(s[:E] * jnp.asarray(cot)), s[:E]

    (_, sj), (gp, gh) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(h))
    tm = MLPPredictor(D, HID, num_layers=layers, device="cpu")
    tm.load_state_dict(predictor_state_dict_from_flax(params))
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    ht = torch.from_numpy(h).requires_grad_()
    st = tm(gt, ht)
    (st * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), **TOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh), **TOL)
    _check_grads(tm, predictor_state_dict_from_flax(_np(gp)))


def test_pair_mlp_predictor_matches_flax():
    rng = np.random.default_rng(5)
    xi, xj = (rng.standard_normal((50, D)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal(50).astype(np.float32)
    fm = FlaxPair(hidden=HID)
    params = _np(fm.init(jax.random.PRNGKey(2), jnp.asarray(xi), jnp.asarray(xj))["params"])

    def f(p, a, b):
        s = fm.apply({"params": p}, a, b)
        return jnp.sum(s * jnp.asarray(cot)), s

    (_, sj), (gp, ga, gb) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(xi), jnp.asarray(xj))
    tm = PairMLPPredictor(D, HID, device="cpu")
    tm.load_state_dict(predictor_state_dict_from_flax(params))
    a, b = (torch.from_numpy(v).requires_grad_() for v in (xi, xj))
    st = tm(a, b)
    (st * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), **TOL)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), **TOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(gb), **TOL)
    _check_grads(tm, predictor_state_dict_from_flax(_np(gp)))
    # broadcast pairs (the evaluation's (K, 1, D) against (K, M, D)) keep the leading shape
    with torch.no_grad():
        many = tm(a[:4].unsqueeze(1), b[:12].view(4, 3, D))
    assert many.shape == (4, 3)
    np.testing.assert_allclose(many[:, 0].numpy(), tm(a[:4], b[:12].view(4, 3, D)[:, 0]).detach()
                               .numpy(), **TOL)


def test_predictors_draw_flax_style_weights_from_the_generator():
    a = PairMLPPredictor(D, HID, device="cpu", generator=torch.Generator().manual_seed(3))
    b = PairMLPPredictor(D, HID, device="cpu", generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any()
        else:  # lecun_normal: truncated at 2 standard deviations
            assert p.abs().max() <= 2 * (1 / p.shape[1]) ** 0.5 / 0.87962566103423978 + 1e-6
    with pytest.raises(KeyError):
        predictor_state_dict_from_flax({"dense": {}})
