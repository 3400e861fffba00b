"""Port parity: gspmm's binary ops (add, sub, mul, div) and max/min reduces
against the JAX package's gspmm, in values and in gradients wrt x and e,
float32 on the CPU; mul by a per-edge scalar takes the message path of
every binary op; the scatter lowering's binary ops; and the one place the port departs from the JAX package's max/min (a
non-finite extremum)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.ops import gspmm as jax_gspmm

import dgl_tpu_torch
import dgl_tpu_torch.ops.gather as gather_mod
import dgl_tpu_torch.ops.rel as rel_mod
import dgl_tpu_torch.ops.segment as segment_mod
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
from dgl_tpu_torch.ops import segment_max, segment_min

N_SRC, N_DST, E, D = 30, 26, 240, 5
# float32 sums of at most a few tens of terms in another order, and the
# quotients of div, whose e lies in ±[0.5, 2]
RTOL, ATOL = 1e-5, 1e-5


def _graphs(seed):
    """Edges into the first N_DST - 4 dst nodes only: the last 4 get none."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_SRC, E)
    dst = rng.integers(0, N_DST - 4, E)
    return (dgl_tpu.from_edges(src, dst, N_SRC, N_DST),
            dgl_tpu_torch.from_edges(src, dst, N_SRC, N_DST, device="cpu"), rng)


def _edge_values(rng, shape):
    """Away from 0, so div's quotients stay tame."""
    return (rng.uniform(0.5, 2.0, shape) * rng.choice([-1, 1], shape)).astype(np.float32)


def _both(gj, gt, op, reduce, x, e, cot):
    """(out, grads) of the JAX gspmm and of the port on the same inputs;
    ``e`` in canonical order (the two packages' canonical orders agree: a
    stable sort by dst); grads wrt the given inputs among x and e."""
    xj = None if x is None else jnp.asarray(x)
    ej = None
    if e is not None:  # the JAX graph's padded edges get 1: div's gradient stays finite there
        ej = jnp.ones((gj.num_edges_padded,) + e.shape[1:], jnp.float32).at[:E].set(e)

    def loss(xx, ee):
        return jnp.sum(jax_gspmm(gj, op, reduce, x=xx, e=ee) * cot)

    args = (xj, ej)
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    out_j = np.asarray(jax_gspmm(gj, op, reduce, x=xj, e=ej))
    grads_j = [np.asarray(g) for g in jax.grad(loss, argnums=argnums)(*args)]
    grads_j = [g[:E] if i == 1 else g for i, g in zip(argnums, grads_j)]

    xt = None if x is None else torch.from_numpy(x).requires_grad_()
    et = None if e is None else torch.from_numpy(e).requires_grad_()
    out_t = dgl_tpu_torch.gspmm(gt, op, reduce, x=xt, e=et)
    (out_t * torch.from_numpy(cot)).sum().backward()
    grads_t = [(xt, et)[i].grad.numpy() for i in argnums]
    return out_j, grads_j, out_t.detach().numpy(), grads_t


@pytest.mark.parametrize("op", ["copy_u", "add", "sub", "mul", "div", "copy_e"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "min"])
def test_gspmm_matches_jax(op, reduce):
    """Every op × reduce of the JAX package's test_spmm_matches_dense, e as
    wide as x (mul takes the message path)."""
    gj, gt, rng = _graphs(sum(map(ord, op + reduce)))
    x = None if op == "copy_e" else rng.standard_normal((N_SRC, D)).astype(np.float32)
    e = None if op == "copy_u" else _edge_values(rng, (E, D))
    cot = rng.standard_normal((N_DST, D)).astype(np.float32)
    out_j, grads_j, out_t, grads_t = _both(gj, gt, op, reduce, x, e, cot)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert not out_t[N_DST - 4:].any()  # zero in-degree rows give 0


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_gspmm_broadcast_matches_jax(op, reduce):
    """x (N, H, D) against e (E, H, 1), the attention shape."""
    gj, gt, rng = _graphs(7)
    h = 3
    x = rng.standard_normal((N_SRC, h, D)).astype(np.float32)
    e = _edge_values(rng, (E, h, 1))
    cot = rng.standard_normal((N_DST, h, D)).astype(np.float32)
    out_j, grads_j, out_t, grads_t = _both(gj, gt, op, reduce, x, e, cot)
    assert out_t.shape == (N_DST, h, D)
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("x_tail,e_tail", [((D,), (1,)), ((1, D), (4, 1)), ((4, D), (4, 1)),
                                           ((4, D), (1, 1))])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_mul_by_an_edge_scalar_takes_the_message_path(monkeypatch, x_tail, e_tail, reduce):
    """e (E, 1), or (E, S, 1) against x (N, S or 1, D): mul takes the one
    path of every binary op, the gather of x[src] and a segment sum, and
    not the relation passes (RGCN calls those itself); values and
    gradients as the JAX package's."""
    gj, gt, rng = _graphs(3)
    x = rng.standard_normal((N_SRC,) + x_tail).astype(np.float32)
    e = _edge_values(rng, (E,) + e_tail)
    cot_shape = (N_DST,) + tuple(np.broadcast_shapes(x_tail, e_tail))
    cot = rng.standard_normal(cot_shape).astype(np.float32)
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    def no_call(*a, **k):
        raise AssertionError("mul by an edge scalar took the relation passes")

    monkeypatch.setattr(rel_mod, "csr_spmm", no_call)
    monkeypatch.setattr(gather_mod, "_gather_rows", spy("gather", gather_mod._gather_rows))
    monkeypatch.setattr(segment_mod, "_seg_sum_rows", spy("seg_sum", segment_mod._seg_sum_rows))
    out_j, grads_j, out_t, grads_t = _both(gj, gt, "mul", reduce, x, e, cot)
    assert calls[:2] == ["gather", "seg_sum"]  # the forward; the adjoints follow
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=ATOL)
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", ["add", "mul", "div"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_scatter_lowering_binary_matches_jax_scatter(monkeypatch, op, reduce):
    """lowering="scatter" against the JAX package under
    DGL_TPU_LOWERING=scatter: index_select messages, index_add_, no K1."""
    monkeypatch.setenv("DGL_TPU_LOWERING", "scatter")
    gj, gt, rng = _graphs(11)
    x = rng.standard_normal((N_SRC, D)).astype(np.float32)
    e = _edge_values(rng, (E, 1))
    ej = jnp.zeros((gj.num_edges_padded, 1), jnp.float32).at[:E].set(e)
    ref = np.asarray(jax_gspmm(gj, op, reduce, x=jnp.asarray(x), e=ej))
    before = csr_spmm.launches
    xt = torch.from_numpy(x).requires_grad_()
    got = dgl_tpu_torch.gspmm(gt, op, reduce, x=xt, e=torch.from_numpy(e), lowering="scatter")
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=RTOL, atol=ATOL)
    assert xt.grad is not None and csr_spmm.launches == before


def test_a_nonfinite_extremum_is_kept_where_jax_maps_it_to_zero():
    """The JAX package's segment_max/min map a non-finite extremum to 0
    (dgl_tpu/ops/segment.py:109,116), so a row whose max is +inf gives 0
    there. DGL, and the port, keep +inf; rows with no in-edge give 0 in both."""
    gj, gt, rng = _graphs(5)
    e = _edge_values(rng, (E, 1))
    row = int(gt.dst[0])
    e[0, 0] = np.inf  # canonical edge 0 lies in the first dst row with edges
    ej = jnp.zeros((gj.num_edges_padded, 1), jnp.float32).at[:E].set(e)
    jax_max = np.asarray(jax_gspmm(gj, "copy_e", "max", e=ej))
    port_max = dgl_tpu_torch.gspmm(gt, "copy_e", "max", e=torch.from_numpy(e)).numpy()
    assert jax_max[row, 0] == 0.0
    assert port_max[row, 0] == np.inf
    others = np.arange(N_DST) != row
    np.testing.assert_array_equal(port_max[others], jax_max[others])
    e_min = -e
    jax_min = np.asarray(jax_gspmm(gj, "copy_e", "min", e=-ej))
    port_min = dgl_tpu_torch.gspmm(gt, "copy_e", "min", e=torch.from_numpy(e_min)).numpy()
    assert jax_min[row, 0] == 0.0 and port_min[row, 0] == -np.inf
    assert not port_max[N_DST - 4:].any() and not port_min[N_DST - 4:].any()


def test_segment_min_and_max_match_numpy():
    rng = np.random.default_rng(2)
    data = rng.standard_normal((50, 3)).astype(np.float32)
    seg = np.sort(rng.integers(0, 8, 50))
    seg[seg == 5] = 6  # segment 5 is empty
    for fn, np_fn in ((segment_max, np.max), (segment_min, np.min)):
        got = fn(torch.from_numpy(data), torch.from_numpy(seg), 9).numpy()
        for s in range(9):
            want = np_fn(data[seg == s], axis=0) if (seg == s).any() else np.zeros(3)
            np.testing.assert_array_equal(got[s], want)
