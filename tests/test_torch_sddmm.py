"""Port parity: gsddmm (every op, values and gradients) and gspmm's scatter
lowering (against the fused lowering and against the JAX package run under
``DGL_TPU_LOWERING=scatter``), float32 on the CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.ops import gsddmm as jax_gsddmm
from dgl_tpu.ops import gspmm as jax_gspmm

import dgl_tpu_torch
import dgl_tpu_torch.ops.gather as gather_mod
import dgl_tpu_torch.ops.segment as segment_mod
import dgl_tpu_torch.ops.spmm as spmm_mod
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.kernels.seg_sum import seg_sum
from dgl_tpu_torch.ops.sddmm import gsddmm, u_dot_v, u_mul_v

N_SRC, N_DST, E, D = 40, 30, 300, 8
RTOL, ATOL = 1e-5, 1e-5  # float32; sums of a few tens of terms


def _graphs(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_SRC, E)
    dst = rng.integers(0, N_DST - 5, E)  # the last 5 dst nodes get no edge
    return (dgl_tpu.from_edges(src, dst, N_SRC, N_DST),
            dgl_tpu_torch.from_edges(src, dst, N_SRC, N_DST, device="cpu"), rng)


@pytest.mark.parametrize("op,u_tail,v_tail", [
    ("add", (D,), (D,)), ("sub", (D,), (D,)), ("mul", (D,), (1,)), ("div", (D,), (D,)),
    ("dot", (D,), (D,)), ("copy_u", (2, D), None), ("copy_lhs", (D,), None),
    ("copy_v", None, (D,)), ("copy_rhs", None, (3,)),
])
def test_gsddmm_matches_jax(op, u_tail, v_tail):
    gj, gt, rng = _graphs(1)
    u = None if u_tail is None else rng.standard_normal((N_SRC,) + u_tail).astype(np.float32)
    v = None if v_tail is None else (rng.uniform(0.5, 2.0, (N_DST,) + v_tail)
                                     * rng.choice([-1, 1], (N_DST,) + v_tail)).astype(np.float32)
    ref = np.asarray(jax_gsddmm(gj, op, None if u is None else jnp.asarray(u),
                                None if v is None else jnp.asarray(v)))[:E]
    ut = None if u is None else torch.from_numpy(u).requires_grad_()
    vt = None if v is None else torch.from_numpy(v).requires_grad_()
    got = gsddmm(gt, op, ut, vt, mask_padding=False)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=RTOL, atol=ATOL)

    cot = rng.standard_normal(ref.shape).astype(np.float32)

    def loss(uu, vv):
        out = jax_gsddmm(gj, op, uu, vv)[:E]
        return jnp.sum(out * cot)

    args = (None if u is None else jnp.asarray(u), None if v is None else jnp.asarray(v))
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    grads = jax.grad(loss, argnums=argnums)(*args)
    (got * torch.from_numpy(cot)).sum().backward()
    for i, g_ref in zip(argnums, grads):
        t = (ut, vt)[i]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g_ref), rtol=RTOL, atol=ATOL)


def test_u_dot_v_and_u_mul_v_and_unknown_op():
    _, gt, rng = _graphs(2)
    u = torch.from_numpy(rng.standard_normal((N_SRC, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((N_DST, D)).astype(np.float32))
    src, dst = gt.src.long(), gt.dst.long()
    torch.testing.assert_close(u_dot_v(gt, u, v), (u[src] * v[dst]).sum(-1, keepdim=True))
    torch.testing.assert_close(u_mul_v(gt, u, v), u[src] * v[dst])
    with pytest.raises(ValueError, match="unknown sddmm op"):
        gsddmm(gt, "max", u, v)


def test_gsddmm_copy_u_adjoint_is_one_k1_call(monkeypatch):
    """copy_u's backward is gather_src_rows' K1 call over the reverse CSR;
    a binary op on an input that needs no gradient calls no kernel."""
    _, gt, rng = _graphs(3)
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("split"))
        return csr_spmm(*a, **kw)

    monkeypatch.setattr(gather_mod, "csr_spmm", spy)
    c = torch.rand(N_SRC, 1) + 0.5
    u = torch.randn(N_SRC, D, requires_grad=True)
    gsddmm(gt, "mul", c, torch.rand(N_DST, 1)).sum()  # no gradient anywhere: no backward
    gsddmm(gt, "copy_u", u).sum().backward()
    assert calls == [gt.reverse.split]


@pytest.mark.parametrize("op", ["copy_u", "copy_e"])
@pytest.mark.parametrize("reduce_op", ["sum", "mean"])
def test_gspmm_scatter_matches_fused_and_jax_scatter(monkeypatch, op, reduce_op):
    gj, gt, rng = _graphs(4)
    x = rng.standard_normal((N_SRC, D)).astype(np.float32)
    e = rng.standard_normal((E, 2, 3)).astype(np.float32)
    kw_in = ("x", x) if op == "copy_u" else ("e", e)
    out = {}
    for lowering in ("fused", "scatter"):
        t = torch.from_numpy(kw_in[1]).requires_grad_()
        before = (csr_spmm.launches, seg_sum.launches)
        y = dgl_tpu_torch.gspmm(gt, op, reduce_op, lowering=lowering, **{kw_in[0]: t})
        cot = torch.from_numpy(np.random.default_rng(5).standard_normal(tuple(y.shape))
                               .astype(np.float32))
        (y * cot).sum().backward()
        assert (csr_spmm.launches, seg_sum.launches) == before  # CPU tensors launch nothing
        out[lowering] = (y.detach().numpy(), t.grad.numpy(), cot.numpy())
    np.testing.assert_allclose(out["scatter"][0], out["fused"][0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["scatter"][1], out["fused"][1], rtol=RTOL, atol=ATOL)

    monkeypatch.setenv("DGL_TPU_LOWERING", "scatter")
    e_pad = np.zeros((gj.num_edges_padded,) + e.shape[1:], np.float32)
    e_pad[:E] = e

    def f(a):
        kw = {"x": a} if op == "copy_u" else {"e": a}
        return jnp.sum(jax_gspmm(gj, op, reduce_op, **kw) * out["scatter"][2])

    arg = jnp.asarray(x if op == "copy_u" else e_pad)
    ref = np.asarray(jax_gspmm(gj, op, reduce_op, **{kw_in[0]: arg}))
    g_ref = np.asarray(jax.grad(f)(arg))
    np.testing.assert_allclose(out["scatter"][0], ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out["scatter"][1], g_ref[: len(out["scatter"][1])],
                               rtol=RTOL, atol=ATOL)


def test_scatter_lowering_reads_no_reverse_and_calls_no_kernel(monkeypatch):
    """Under scatter, gspmm builds its messages with index_select and sums
    them with index_add_: no K1 or K2 call either way, no reverse CSR."""
    _, gt, rng = _graphs(6)
    calls = []
    for mod, name in ((spmm_mod, "csr_spmm"), (gather_mod, "csr_spmm"), (segment_mod, "seg_sum")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw: calls.append(_n))
    g_norev = type(gt)(**{**gt.__dict__, "reverse": None})
    x = torch.randn(N_SRC, D, requires_grad=True)
    dgl_tpu_torch.gspmm(g_norev, "copy_u", "mean", x=x, lowering="scatter").sum().backward()
    e = torch.randn(E, D, requires_grad=True)
    dgl_tpu_torch.gspmm(g_norev, "copy_e", "sum", e=e, lowering="scatter").sum().backward()
    assert calls == [] and x.grad is not None and e.grad is not None
    with pytest.raises(ValueError, match="unknown spmm lowering"):
        dgl_tpu_torch.gspmm(gt, "copy_u", "sum", x=x, lowering="pyg")
