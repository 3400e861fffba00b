"""Port parity for the edge-message path of GAT's edge form: K2's plain
version (``seg_sum``) against the JAX package's ``segment_sum_mxu`` (the
Pallas piece reduce, run in interpret mode as ``tests/test_kernels.py``
runs it) and ``_seg_sum_by_dst``; then ``gspmm(copy_e)``, the gather and
spread ops and ``edge_softmax`` (exact, bound-shifted, and a row that
forces the rescue), values and gradients against the JAX functions on the
same numpy inputs.

The JAX graph pads its edge arrays to ``num_edges_padded``; inputs are
zero-padded for it and its outputs cut back to ``num_edges``. Tolerances:
float32 sums of at most a few dozen terms in another order, 1e-5 relative
and 1e-5 absolute (K2's forward on small integers: exact).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.kernels.piece_reduce import segment_sum_mxu
from dgl_tpu.ops import edge_softmax as jax_edge_softmax
from dgl_tpu.ops import gspmm as jax_gspmm
from dgl_tpu.ops.gather import gather_src_rows as jax_gather_src_rows
from dgl_tpu.ops.gather import spread_dst as jax_spread_dst
from dgl_tpu.ops.spmm import _seg_sum_by_dst

import dgl_tpu_torch
from dgl_tpu_torch.kernels.seg_sum import seg_sum, seg_sum_plain
from dgl_tpu_torch.ops import edge_softmax, gather_src_rows, seg_sum_dst, spread_dst

RTOL = ATOL = 1e-5
N, E = 60, 400


def _graphs(seed, n=N, e=E, n_dst=None):
    """Random edges into the first 3/4 of the dst nodes (the rest have
    in-degree 0), with a skewed source side."""
    rng = np.random.default_rng(seed)
    n_dst = n if n_dst is None else n_dst
    src = (rng.zipf(1.5, e) - 1) % n
    dst = rng.integers(0, 3 * n_dst // 4, e)
    gj = dgl_tpu.from_edges(src, dst, n, n_dst)
    gt = dgl_tpu_torch.from_edges(src, dst, n, n_dst, device="cpu")
    return rng, gj, gt


def _pad(a, gj):
    out = np.zeros((gj.num_edges_padded,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return jnp.asarray(out)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("tail", [(1,), (3,), (4, 16)])
def test_seg_sum_plain_matches_piece_reduce_and_its_gradient(tail):
    rng, gj, gt = _graphs(sum(tail))
    msg = rng.standard_normal((E,) + tail).astype(np.float32)
    cot = rng.standard_normal((N,) + tail).astype(np.float32)
    mj = _pad(msg, gj)
    want_mxu = segment_sum_mxu(mj, gj.mxublocks, N, True)
    want_xla = _seg_sum_by_dst(gj, mj)
    grad_j = jax.grad(lambda m: jnp.sum(segment_sum_mxu(m, gj.mxublocks, N, True) * cot))(mj)

    got = seg_sum_plain(gt.indptr, _t(msg).reshape(E, -1)).reshape((N,) + tail)
    _close(got, want_mxu, "vs segment_sum_mxu")
    _close(got, want_xla, "vs _seg_sum_by_dst")
    assert not got[3 * N // 4:].any()  # zero in-degree rows give 0

    mt = _t(msg, grad=True)
    out = seg_sum_dst(gt, mt)
    (out * _t(cot)).sum().backward()
    _close(mt.grad, np.asarray(grad_j)[:E], "gradient")


def test_seg_sum_wrapper_on_cpu_takes_plain_version_and_sums_integers_exactly():
    rng, gj, gt = _graphs(5)
    msg = rng.integers(-4, 5, (E, 7)).astype(np.float32)
    before = seg_sum.launches
    got = seg_sum(gt.indptr.long(), _t(msg))
    assert seg_sum.launches == before  # CPU tensors never launch the kernel
    want = np.zeros((N, 7))
    np.add.at(want, gt.dst.numpy(), msg.astype(np.float64))
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    with pytest.raises(TypeError, match="float32"):
        seg_sum(gt.indptr, _t(msg).double())
    with pytest.raises(ValueError, match="2-D"):
        seg_sum(gt.indptr, _t(msg).reshape(E, 7, 1))


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_gspmm_copy_e_matches_jax(reduce):
    rng, gj, gt = _graphs(7, n_dst=45)
    e = rng.standard_normal((E, 2, 5)).astype(np.float32)
    cot = rng.standard_normal((45, 2, 5)).astype(np.float32)
    ej = _pad(e, gj)
    want, vjp = jax.vjp(lambda x: jax_gspmm(gj, "copy_e", reduce, e=x), ej)
    et = _t(e, grad=True)
    out = dgl_tpu_torch.gspmm(gt, "copy_rhs", reduce, e=et)
    (out * _t(cot)).sum().backward()
    _close(out.detach(), want, "forward")
    _close(et.grad, np.asarray(vjp(jnp.asarray(cot))[0])[:E], "gradient")


def test_gather_src_rows_and_spread_dst_match_jax():
    rng, gj, gt = _graphs(9, n_dst=50)
    x = rng.standard_normal((N, 3, 4)).astype(np.float32)
    v = rng.standard_normal((50, 3)).astype(np.float32)
    ge = rng.standard_normal((E, 3, 4)).astype(np.float32)
    gv = rng.standard_normal((E, 3)).astype(np.float32)

    want_x, vjp_x = jax.vjp(lambda a: jax_gather_src_rows(gj, a), jnp.asarray(x))
    want_v, vjp_v = jax.vjp(lambda a: jax_spread_dst(gj, a), jnp.asarray(v))
    xt, vt = _t(x, grad=True), _t(v, grad=True)
    got_x, got_v = gather_src_rows(gt, xt), spread_dst(gt, vt)
    ((got_x * _t(ge)).sum() + (got_v * _t(gv)).sum()).backward()

    _close(got_x.detach(), np.asarray(want_x)[:E], "gather_src_rows")
    _close(got_v.detach(), np.asarray(want_v)[:E], "spread_dst")
    _close(xt.grad, vjp_x(_pad(ge, gj))[0], "gather_src_rows gradient")
    _close(vt.grad, vjp_v(_pad(gv, gj))[0], "spread_dst gradient")


def _softmax_case(seed, force_rescue):
    rng, gj, gt = _graphs(seed)
    logits = rng.standard_normal((E, 4)).astype(np.float32)
    bound = np.zeros((N, 4), np.float32)
    np.maximum.at(bound, gt.dst.numpy(), logits)
    bound += rng.uniform(0.0, 3.0, (N, 4)).astype(np.float32)  # a loose bound
    if force_rescue:
        bound[int(gt.dst[0])] += 100.0  # that row's every term underflows
    cot = rng.standard_normal((E, 4)).astype(np.float32)
    return gj, gt, logits, bound, cot


@pytest.mark.parametrize("form", ["exact", "bound", "rescue"])
def test_edge_softmax_matches_jax(form):
    gj, gt, logits, bound, cot = _softmax_case(11, force_rescue=form == "rescue")
    kw_j = {} if form == "exact" else {"dst_bound": jnp.asarray(bound)}
    want, vjp = jax.vjp(lambda z: jax_edge_softmax(gj, z, **kw_j), _pad(logits, gj))
    lt = _t(logits, grad=True)
    before = edge_softmax.rescues
    got = edge_softmax(gt, lt, **({} if form == "exact" else {"dst_bound": _t(bound)}))
    assert edge_softmax.rescues - before == (form == "rescue")
    (got * _t(cot)).sum().backward()
    _close(got.detach(), np.asarray(want)[:E], "values")
    _close(lt.grad, np.asarray(vjp(_pad(cot, gj))[0])[:E], "gradient")
    # every row with in-edges sums to 1
    sums = seg_sum_plain(gt.indptr, got.detach())
    live = gt.in_degrees() > 0
    torch.testing.assert_close(sums[live], torch.ones_like(sums[live]))


def test_edge_softmax_eps_comes_from_the_dtype():
    from dgl_tpu_torch.ops.softmax import _eps

    assert _eps(torch.float32) == 1e-12 and _eps(torch.bfloat16) == 1e-12
    # 1e-12 flushes to 0 in float16; its smallest normal number does not
    assert _eps(torch.float16) == torch.finfo(torch.float16).smallest_normal
    assert torch.tensor(_eps(torch.float16), dtype=torch.float16) > 0
