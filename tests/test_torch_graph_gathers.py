"""Port parity for the graph ops whose row gathers are P1 in source order
(``kernels/row_gather.py:row_gather_by_source``): ``gather_src_rows``
(over the reverse CSR, positions ``reverse.eid``), ``gather_dst`` and
``spread_dst`` (over the dst CSR, positions equal to slots) and
``segment_sum``'s backward (over the segments' row offsets).

Values and gradients against ``dgl_tpu/ops/gather.py`` and
``dgl_tpu/ops/segment.py`` on the same numpy inputs; the JAX graph pads
its edge arrays, so inputs are zero-padded for it and its outputs cut
back. Tolerances: a gather copies, so every forward and ``segment_sum``'s
gradient match bit for bit; the other gradients are float32 sums of at
most a few dozen terms in another order than XLA's, 1e-5 relative and
1e-5 absolute. Then which kernel each direction calls: ``gather_dst``'s
gradient is now one K2 call, as ``spread_dst``'s, not ``index_add_``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.ops import gather as jax_gather
from dgl_tpu.ops import segment as jax_segment

import dgl_tpu_torch
import dgl_tpu_torch.ops.segment as segment_mod
from dgl_tpu_torch.graph.split import row_split
from dgl_tpu_torch.kernels.row_gather import row_gather_by_source
from dgl_tpu_torch.kernels.seg_sum import seg_sum
from dgl_tpu_torch.ops import gather_dst, gather_src_rows, segment_sum, spread_dst

RTOL = ATOL = 1e-5
N_SRC, N_DST, E = 70, 50, 600
OPS = ["gather_src_rows", "gather_dst", "spread_dst", "segment_sum"]


def _graphs(seed):
    """Skewed sources (long reverse rows), dst nodes in the lower 3/4 (the
    rest have no in-edge)."""
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.4, E) - 1) % N_SRC
    dst = rng.integers(0, 3 * N_DST // 4, E)
    return (rng, dgl_tpu.from_edges(src, dst, N_SRC, N_DST),
            dgl_tpu_torch.from_edges(src, dst, N_SRC, N_DST, device="cpu"))


def _pad(a, gj):
    out = np.zeros((gj.num_edges_padded,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return jnp.asarray(out)


def _case(op, tail, seed):
    """(JAX function of its input, its input, the port's function, its
    input, the cotangent of the port's output, that cotangent for JAX)."""
    rng, gj, gt = _graphs(seed)
    if op == "segment_sum":  # the edges' messages by dst, S = N_DST segments
        data = rng.standard_normal((E,) + tail).astype(np.float32)
        cot = rng.standard_normal((N_DST,) + tail).astype(np.float32)
        ids = jnp.asarray(np.concatenate([gt.dst.numpy(), np.full(gj.num_edges_padded - E, N_DST)]))
        return (lambda m: jax_segment.segment_sum(m, ids, N_DST, sorted=True), _pad(data, gj),
                lambda m: segment_sum(m, gt.dst, gt.indptr, gt.split), data, cot, jnp.asarray(cot))
    n = N_SRC if op == "gather_src_rows" else N_DST
    x = rng.standard_normal((n,) + tail).astype(np.float32)
    cot = rng.standard_normal((E,) + tail).astype(np.float32)
    jax_fn, port = getattr(jax_gather, op), {"gather_src_rows": gather_src_rows,
                                             "gather_dst": gather_dst, "spread_dst": spread_dst}[op]
    return (lambda a: jax_fn(gj, a), jnp.asarray(x), lambda a: port(gt, a), x, cot, _pad(cot, gj))


@pytest.mark.parametrize("tail", [(1,), (8,), (3, 4)])
@pytest.mark.parametrize("op", OPS)
def test_values_and_gradients_match_jax(op, tail):
    jax_fn, xj, port, x, cot, cot_j = _case(op, tail, seed=len(tail) * 10 + OPS.index(op))
    want, vjp = jax.vjp(jax_fn, xj)
    xt = torch.tensor(x, requires_grad=True)
    got = port(xt)
    (got * torch.from_numpy(cot)).sum().backward()
    n_out = got.shape[0]
    assert got.shape == (n_out,) + tail
    want_grad = np.asarray(vjp(cot_j)[0])[: x.shape[0]]
    if op == "segment_sum":  # its forward is K2's sum, its gradient the gather
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    else:
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want)[:E])
        np.testing.assert_allclose(xt.grad.numpy(), want_grad, rtol=RTOL, atol=ATOL)


def _spied(monkeypatch):
    calls = []

    def spy(real):
        def f(*a, **kw):
            calls.append(real.__name__)
            return real(*a, **kw)
        return f

    monkeypatch.setattr(segment_mod, "row_gather_by_source", spy(row_gather_by_source))
    monkeypatch.setattr(segment_mod, "seg_sum", spy(seg_sum))
    return calls


def test_gather_dst_backward_is_one_k2_call_and_no_index_add(monkeypatch):
    """Its backward is spread_dst's Function (K2), not autograd's
    index_select adjoint (an index_add_ with atomics on the card)."""
    _, _, gt = _graphs(3)
    calls = _spied(monkeypatch)
    v = torch.randn(N_DST, 4, requires_grad=True)
    out = gather_dst(gt, v)
    assert type(out.grad_fn).__name__ == "_SpreadDstBackward"
    assert calls == ["row_gather_by_source"]
    (out * torch.randn_like(out)).sum().backward()
    assert calls == ["row_gather_by_source", "seg_sum"]


def test_segment_sum_backward_is_one_gather_with_or_without_a_split(monkeypatch):
    """The readouts pass their split; without one the gather still takes
    the number of rows from the data, never from indptr."""
    counts = np.array([3, 0, 5, 1, 0, 2])
    ip = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=ip[1:])
    ids = torch.from_numpy(np.repeat(np.arange(len(counts)), counts))
    data = torch.randn(int(ip[-1]), 2, 3, requires_grad=True)
    cot = torch.randn(len(counts), 2, 3)
    calls = _spied(monkeypatch)
    for split in (row_split(ip, t=2), None):
        data.grad = None
        (segment_sum(data, ids, torch.from_numpy(ip), split) * cot).sum().backward()
        assert torch.equal(data.grad, cot[ids])
    assert calls == ["seg_sum", "row_gather_by_source"] * 2


@pytest.mark.parametrize("op", OPS)
def test_a_double_backward_raises(op):
    """The backwards are kernel launches autograd does not trace: the
    derivative of a gradient in its cotangent (a double backward) raises
    instead of dropping their terms."""
    _, _, port, x, cot, _ = _case(op, (2,), seed=5)
    xt = torch.tensor(x, requires_grad=True)
    ct = torch.tensor(cot, requires_grad=True)
    (g,) = torch.autograd.grad(port(xt), xt, grad_outputs=ct, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()
