"""Port parity: gspmm (copy_u sum/mean) forward and gradient against the
JAX package, through its XLA path and through the Pallas lane kernel run in
interpret mode. Tolerances cover the different summation order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.kernels import build_plan, lane_spmm
from dgl_tpu.ops import gspmm as jax_gspmm

import dgl_tpu_torch
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm


def _graph(seed, n=200, e=2000):
    """Edges only into the first 3/4 of the nodes: the rest have in-degree 0."""
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, n, e), rng.integers(0, 3 * n // 4, e), n


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("d", [1, 16, 41])
def test_gspmm_forward_and_grad_match_jax(d, reduce):
    rng, src, dst, n = _graph(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)

    gj = dgl_tpu.from_edges(src, dst, n)
    out_j = jax_gspmm(gj, "copy_u", reduce, x=jnp.asarray(x))
    grad_j = jax.grad(
        lambda xx: jnp.sum(jax_gspmm(gj, "copy_u", reduce, x=xx) * jnp.asarray(cot))
    )(jnp.asarray(x))

    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out_t = dgl_tpu_torch.gspmm(gt, "copy_u", reduce, x=xt)
    (out_t * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_j), rtol=1e-5, atol=1e-6)
    assert not out_t.detach()[3 * n // 4:].any()  # zero in-degree rows give 0


def test_gspmm_bipartite_matches_jax():
    """num_src != num_dst: the backward's reverse CSR has num_src rows."""
    rng = np.random.default_rng(11)
    n_src, n_dst, d = 150, 90, 16
    src, dst = rng.integers(0, n_src, 1500), rng.integers(0, n_dst, 1500)
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    cot = rng.standard_normal((n_dst, d)).astype(np.float32)
    gj = dgl_tpu.from_edges(src, dst, n_src, n_dst)
    grad_j = jax.grad(
        lambda xx: jnp.sum(jax_gspmm(gj, "copy_u", "mean", x=xx) * jnp.asarray(cot))
    )(jnp.asarray(x))
    gt = dgl_tpu_torch.from_edges(src, dst, n_src, n_dst, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    out_t = dgl_tpu_torch.gspmm(gt, "copy_u", "mean", x=xt)
    assert out_t.shape == (n_dst, d)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(grad_j), rtol=1e-5, atol=1e-6)


def test_gspmm_matches_lane_kernel_interpret():
    rng, src, dst, n = _graph(7)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    gj = dgl_tpu.from_edges(src, dst, n)
    plan = build_plan(src, dst, n, n, dense_threshold=1)
    ref = np.asarray(
        lane_spmm(plan, jnp.asarray(x), in_degrees=gj.in_degrees(),
                  interpret=True, compute_dtype=jnp.float32)
    )[:n]
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    got = dgl_tpu_torch.gspmm(gt, "copy_lhs", "mean", x=torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng, src, dst, n = _graph(1)
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    before = csr_spmm.launches
    x = torch.randn(n, 8, requires_grad=True)
    dgl_tpu_torch.gspmm(gt, "copy_u", "mean", x=x).sum().backward()
    assert x.grad is not None
    assert csr_spmm.launches == before


@pytest.mark.parametrize(
    "op,reduce,exc,match",
    [
        ("copy_x", "sum", ValueError, "copy_x"),
        ("copy_u", "avg", ValueError, "avg"),
        ("copy_e", "sum", ValueError, "requires edge features"),
        ("u_mul_e", "sum", ValueError, "u_mul_e"),
        ("mul", "sum", ValueError, "requires edge features"),
        ("add", "min", ValueError, "requires edge features"),
    ],
)
def test_gspmm_rejects_bad_or_later_ops(op, reduce, exc, match):
    _, src, dst, n = _graph(2)
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    with pytest.raises(exc, match=match):
        dgl_tpu_torch.gspmm(gt, op, reduce, x=torch.zeros(n, 4))
