"""Port parity for bf16 message passing: K1, K2 and K3 read bfloat16 rows
and sum in float32, as the JAX package's bf16 mode does.

Inputs come from numpy with a seed and go through both packages:

* K1's plain version on bfloat16 rows against ``lane_spmm(...,
  compute_dtype=jnp.bfloat16, interpret=True)`` on fully covered lane plans
  (built as ``tests/test_kernels.py`` builds them). Unweighted within 1e-5
  of the largest sum: both round the same inputs the same way and sum in
  float32. Weighted within 8e-3: the lane kernel rounds w·x to bfloat16
  (``lane_spmm.py:390``), K1 keeps the product in float32.
* ``gspmm`` ``copy_u`` sum and mean and ``copy_e`` sum on bfloat16 against
  the JAX ``gspmm``, both lowerings: the output's type (fused float32,
  scatter bfloat16, the JAX types), the gradient's (bfloat16), the values
  within 1e-5 (fused) and the gradients within one bfloat16 ulp (rtol
  2^-7); the scatter lowering, whose JAX twin sums in bfloat16, within 2^-6
  of the largest entry. The gathers and segment sums likewise.
* K3 (``gat_attention``, whose passes take their plain versions on the CPU,
  and ``gat_attention_plain``) with bfloat16 v against ``lane_gat_agg(...,
  compute_dtype=jnp.bfloat16, interpret=True)`` at keep 1 and 0.82, one
  head (the dropout keys agree there): values and the gradients of v,
  a_src and a_dst within 2e-2 of the largest entry (the lane kernel also
  rounds the cotangent and its weights to bfloat16; JAX's own test allows
  0.05 against float32).
* ``SAGEConv(msg_dtype=torch.bfloat16)``, ``GraphSAGE`` (one Adam step)
  and ``GATConv(edge_dtype=torch.bfloat16)`` (edge and fused forms)
  against the flax modules with the weights carried over, within 1e-2 of
  the largest output: the float32 projections before the cast may round to
  bfloat16 differently on either side.
* ``main_sage --bf16-messages`` at a tiny ``--scale`` prints the
  reference's lines, and its K1 calls are the float32 run's, the forward's
  on bfloat16 rows.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import dgl_tpu
from dgl_tpu.kernels import attach_lane_plans, build_plan
from dgl_tpu.kernels.lane_attention import lane_gat_agg
from dgl_tpu.kernels.lane_spmm import lane_spmm, plan_layout_edata
from dgl_tpu.models import GraphSAGE as FlaxGraphSAGE
from dgl_tpu.nn import GATConv as FlaxGATConv
from dgl_tpu.nn import SAGEConv as FlaxSAGEConv
from dgl_tpu.ops import gspmm as jax_gspmm
from dgl_tpu.ops.gather import gather_src_rows as jax_gather_src_rows
from dgl_tpu.ops.gather import spread_dst as jax_spread_dst
from dgl_tpu.ops.segment import segment_sum as jax_segment_sum

import dgl_tpu_torch
import dgl_tpu_torch.ops.spmm as spmm_mod
from dgl_tpu_torch.benchmarks.common import masked_softmax_ce
from dgl_tpu_torch.benchmarks.node_classification import main_sage
from dgl_tpu_torch.convert import gat_state_dict_from_flax, sage_state_dict_from_flax
from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain
from dgl_tpu_torch.kernels.gat_attention import gat_attention, gat_attention_plain
from dgl_tpu_torch.kernels.seg_sum import seg_sum, seg_sum_plain
from dgl_tpu_torch.ops import gather_src_rows, gspmm, seg_sum_dst, segment_sum, spread_dst

BF16 = torch.bfloat16
ULP = 2.0 ** -7  # one bfloat16 ulp, relative
N, E, D = 60, 500, 12


def _bf16(a):
    """numpy float32 → (the bfloat16 torch tensor, the same values as jnp bfloat16)."""
    t = torch.from_numpy(a).to(BF16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close_to_largest(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _graph(seed, n=N, e=E):
    """Edges into the first 3/4 of the nodes; the canonical (dst-sorted)
    edges, in which both packages agree."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e), rng.integers(0, 3 * n // 4, e)
    gj = dgl_tpu.from_edges(src, dst, n)
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    return rng, gj, gt


# -- K1 against the lane kernel in its bf16 mode -------------------------------

K1_CASES = ("sum", "mean", "weighted")


@pytest.fixture(scope="module")
def k1_case():
    """The inputs, and the lane kernel's three results in one jitted call
    (the interpret-mode kernel compiles for seconds a trace)."""
    rng, gj, gt = _graph(1)
    src_c, dst_c = gj.edges_numpy()
    plan = build_plan(src_c, dst_c, N, N, dense_threshold=1)
    assert len(plan.rem_src) == 0
    x = rng.standard_normal((N, D)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, E).astype(np.float32)
    wp = jnp.asarray(plan_layout_edata(plan, w))
    kw = dict(compute_dtype=jnp.bfloat16, interpret=True)

    @jax.jit
    def lane(x):
        return (lane_spmm(plan, x, **kw), lane_spmm(plan, x, in_degrees=gj.in_degrees(), **kw),
                lane_spmm(plan, x, wp, **kw))

    want = dict(zip(K1_CASES, (np.asarray(o)[:N] for o in lane(jnp.asarray(x)))))
    return gt, x, w, want


@pytest.mark.parametrize("case", K1_CASES)
def test_k1_plain_on_bf16_rows_matches_lane_spmm(k1_case, case):
    gt, x, w, want = k1_case
    xt, _ = _bf16(x)
    wt = torch.from_numpy(w) if case == "weighted" else None
    got = csr_spmm_plain(gt.indptr, gt.src, xt, wt, mean=case == "mean")
    assert got.dtype == torch.float32
    # the wrapper on CPU tensors is the plain version, bf16 rows accepted
    assert torch.equal(got, csr_spmm(gt.indptr, gt.src, xt, wt, mean=case == "mean"))
    _close_to_largest(got, want[case], 8e-3 if case == "weighted" else 1e-5)


# -- gspmm, the gathers and the segment sums against the JAX functions ---------

@pytest.mark.parametrize("lowering", ["fused", "scatter"])
@pytest.mark.parametrize("op,reduce", [("copy_u", "sum"), ("copy_u", "mean"), ("copy_e", "sum")])
def test_gspmm_on_bf16_matches_jax_types_and_values(monkeypatch, lowering, op, reduce):
    rng, gj, gt = _graph(2)
    if lowering == "scatter":
        monkeypatch.setenv("DGL_TPU_LOWERING", "scatter")
    rows = N if op == "copy_u" else E
    a = rng.standard_normal((rows, D)).astype(np.float32)
    cot = rng.standard_normal((N, D)).astype(np.float32)
    at, aj = _bf16(a)
    if op == "copy_e":
        aj = jnp.zeros((gj.num_edges_padded, D), jnp.bfloat16).at[:E].set(aj)

    def jax_out(v):
        return jax_gspmm(gj, op, reduce, **{"x" if op == "copy_u" else "e": v})

    out_j, vjp = jax.vjp(jax_out, aj)
    (grad_j,) = vjp(jnp.asarray(cot, out_j.dtype))
    grad_j = grad_j[:rows]

    at.requires_grad_()
    out_t = gspmm(gt, op, reduce, **{"x" if op == "copy_u" else "e": at}, lowering=lowering)
    (out_t * torch.from_numpy(cot).to(out_t.dtype)).sum().backward()
    want_type = torch.float32 if lowering == "fused" else BF16
    assert out_j.dtype == (jnp.float32 if lowering == "fused" else jnp.bfloat16)
    assert out_t.dtype == want_type and at.grad.dtype == BF16 and grad_j.dtype == jnp.bfloat16
    if lowering == "fused":
        np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(at.grad), _np(grad_j), rtol=ULP, atol=1e-6)
    else:  # the JAX scatter sums in bfloat16, the port in float32 rounded once
        _close_to_largest(out_t, out_j, 2 ** -6)
        _close_to_largest(at.grad, grad_j, 2 ** -6)


@pytest.mark.parametrize("which", ["gather_src_rows", "spread_dst", "segment_sum", "seg_sum_dst"])
def test_gathers_and_segment_sums_on_bf16_match_jax(which):
    """Types: the gathers keep bfloat16 and their adjoints come back
    bfloat16; segment_sum keeps bfloat16 (the JAX type); seg_sum_dst returns
    float32 sums (``_seg_sum_by_dst``), its gradient bfloat16 (torch's
    autograd casts a gradient to its input's type; the JAX custom VJP
    returns float32 there). Values: the forwards within 1e-5, the gradients
    within one bfloat16 ulp."""
    from dgl_tpu.ops.gather import seg_sum_dst as jax_seg_sum_dst

    rng, gj, gt = _graph(3)
    on_edges = which in ("segment_sum", "seg_sum_dst")
    rows = E if on_edges else N
    a = rng.standard_normal((rows, D)).astype(np.float32)
    at, aj = _bf16(a)
    if on_edges:
        aj = jnp.zeros((gj.num_edges_padded, D), jnp.bfloat16).at[:E].set(aj)
    fj = {"gather_src_rows": lambda v: jax_gather_src_rows(gj, v),
          "spread_dst": lambda v: jax_spread_dst(gj, v),
          "segment_sum": lambda v: jax_segment_sum(v, gj.dst, N, sorted=True),
          "seg_sum_dst": lambda v: jax_seg_sum_dst(gj, v)}[which]
    ft = {"gather_src_rows": lambda v: gather_src_rows(gt, v),
          "spread_dst": lambda v: spread_dst(gt, v),
          "segment_sum": lambda v: segment_sum(v, gt.dst, gt.indptr, gt.split),
          "seg_sum_dst": lambda v: seg_sum_dst(gt, v)}[which]
    out_j, vjp = jax.vjp(fj, aj)
    out_rows = E if which in ("gather_src_rows", "spread_dst") else N
    cot = rng.standard_normal((out_rows, D)).astype(np.float32)
    cot_j = jnp.zeros(out_j.shape, out_j.dtype).at[:out_rows].set(jnp.asarray(cot, out_j.dtype))
    (grad_j,) = vjp(cot_j)
    at.requires_grad_()
    out_t = ft(at)
    (out_t * torch.from_numpy(cot).to(out_t.dtype)).sum().backward()
    want = torch.float32 if which == "seg_sum_dst" else BF16
    assert out_t.dtype == want and out_j.dtype == (jnp.float32 if want == torch.float32
                                                   else jnp.bfloat16)
    assert at.grad.dtype == BF16
    if which == "segment_sum":  # the JAX sum runs in bfloat16, the port's in float32
        _close_to_largest(out_t, _np(out_j)[:out_rows], 2 ** -6)
    else:
        np.testing.assert_allclose(_np(out_t), _np(out_j)[:out_rows], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(at.grad), _np(grad_j)[:rows], rtol=ULP, atol=1e-6)


def test_k2_plain_sums_bf16_in_float32():
    rng, _, gt = _graph(4)
    msg = rng.standard_normal((E, 40)).astype(np.float32)
    mt, _ = _bf16(msg)
    got = seg_sum(gt.indptr, mt)
    assert got.dtype == torch.float32 and torch.equal(got, seg_sum_plain(gt.indptr, mt))
    want = np.zeros((N, 40), np.float64)
    np.add.at(want, gt.dst.numpy(), mt.double().numpy())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("wrapper", ["csr_spmm", "seg_sum", "gat_attention"])
def test_the_kernels_refuse_half_precision(wrapper):
    """float16 rows: neither the kernels nor the JAX bf16 mode take them."""
    _, _, gt = _graph(5)
    with pytest.raises(TypeError):
        if wrapper == "csr_spmm":
            csr_spmm(gt.indptr, gt.src, torch.ones(N, 4, dtype=torch.float16))
        elif wrapper == "seg_sum":
            seg_sum(gt.indptr, torch.ones(E, 4, dtype=torch.float16))
        else:
            gat_attention(gt, torch.ones(N, 1, 4, dtype=torch.float16), torch.ones(N, 1),
                          torch.ones(N, 1))


# -- K3 against the lane kernel in its bf16 mode -------------------------------

@pytest.mark.parametrize("keep", [1.0, 0.82])
def test_k3_on_bf16_v_matches_lane_gat_agg(keep):
    seed = -20260
    rng = np.random.default_rng(6)
    n, e, h, d = 40, 300, 1, 8
    src, dst = rng.integers(0, n, e), rng.integers(0, 3 * n // 4, e)
    v, tgt = (rng.standard_normal((n, h, d)).astype(np.float32) for _ in range(2))
    a_s, a_d = (rng.standard_normal((n, h)).astype(np.float32) for _ in range(2))
    gj = attach_lane_plans(dgl_tpu.from_edges(src, dst, n), dense_threshold=1,
                           max_expansion=1e9, compute_dtype=jnp.bfloat16)
    assert len(gj.lane.plan.rem_src) == 0 and len(gj.reverse.lane.plan.rem_src) == 0
    vt, vj = _bf16(v)

    def jax_loss(vv, ss, dd):
        out = lane_gat_agg(gj.lane.plan, gj.reverse.lane.plan, vv, ss, dd, n, attn_keep=keep,
                           seed=seed, compute_dtype=jnp.bfloat16, interpret=True)
        return jnp.sum((out - tgt) ** 2), out

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True))(
        vj, jnp.asarray(a_s), jnp.asarray(a_d))
    assert grads[0].dtype == jnp.bfloat16
    gt = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    s = torch.tensor([seed], dtype=torch.int32)
    for name, fn in (("gat_attention", lambda *a: gat_attention(gt, *a, keep=keep, seed=s)),
                     ("gat_attention_plain", lambda *a: gat_attention_plain(
                         gt.indptr, gt.src, *a, keep=keep, seed=s))):
        ins = [vt.clone().requires_grad_(), torch.tensor(a_s, requires_grad=True),
               torch.tensor(a_d, requires_grad=True)]
        out = fn(*ins)
        assert out.dtype == torch.float32, name
        ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
        assert ins[0].grad.dtype == BF16, name
        _close_to_largest(out, want, 2e-2)
        for t, gw in zip(ins, grads):
            _close_to_largest(t.grad, gw, 2e-2)


# -- the layers and models against flax ----------------------------------------

@pytest.mark.parametrize("in_feats,out_feats", [(24, 8), (8, 8)],
                         ids=["project-first", "aggregate-first"])
def test_sageconv_msg_dtype_matches_flax(in_feats, out_feats):
    rng, gj, gt = _graph(7)
    x = rng.standard_normal((N, in_feats)).astype(np.float32)
    fc = FlaxSAGEConv(out_feats, aggr="mean", msg_dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, {
        "fc_self": {"kernel": rng.standard_normal((in_feats, out_feats)).astype(np.float32)},
        "fc_neigh": {"kernel": rng.standard_normal((in_feats, out_feats)).astype(np.float32)},
        "fc_neigh_bias": rng.standard_normal(out_feats).astype(np.float32)})
    want = fc.apply({"params": params}, gj, jnp.asarray(x))
    tc = dgl_tpu_torch.SAGEConv(in_feats, out_feats, "mean", msg_dtype=BF16, device="cpu")
    sd = sage_state_dict_from_flax({"conv_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})
    got = tc(gt, torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close_to_largest(got, want, 1e-2)
    # the float32 layer differs: the messages really were rounded
    tc.msg_dtype = None
    assert not torch.equal(tc(gt, torch.from_numpy(x)), got)


def test_graphsage_msg_dtype_adam_step_matches_optax():
    rng, gj, gt = _graph(8)
    x = rng.standard_normal((N, 20)).astype(np.float32)
    y = rng.integers(0, 5, N)
    mask = (rng.random(N) < 0.6).astype(np.float32)
    kw = dict(hidden_feats=16, out_feats=5, num_layers=3, dropout=0.0)
    fm = FlaxGraphSAGE(**kw, msg_dtype=jnp.bfloat16)
    widths = [(20, 16), (16, 16), (16, 5)]  # drawn here: flax's init compiles for seconds
    params = {f"conv_{i}": {"fc_self": {"kernel": rng.standard_normal(w).astype(np.float32) / 4},
                            "fc_neigh": {"kernel": rng.standard_normal(w).astype(np.float32) / 4},
                            "fc_neigh_bias": rng.standard_normal(w[1]).astype(np.float32) / 4}
              for i, w in enumerate(widths)}

    def jax_loss(p):
        logp = jax.nn.log_softmax(fm.apply({"params": p}, gj, jnp.asarray(x)))
        ce = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1)[:, 0]
        return jnp.sum(ce * mask) / jnp.sum(mask)

    tx = optax.adam(1e-2)
    up, _ = tx.update(jax.jit(jax.grad(jax_loss))(params), tx.init(params), params)
    want = sage_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, up)))
    tm = dgl_tpu_torch.GraphSAGE(20, **kw, msg_dtype=BF16, device="cpu")
    tm.load_state_dict(sage_state_dict_from_flax(params))
    assert all(c.msg_dtype == BF16 for c in tm.convs)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    loss = masked_softmax_ce(tm(gt, torch.from_numpy(x)), torch.from_numpy(y),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss.detach()), float(jax.jit(jax_loss)(params)), rtol=1e-2)
    loss.backward()
    opt.step()
    got = tm.state_dict()
    for name, v in want.items():
        # an Adam step moves each weight by about lr: held to 1e-2 of it
        _close_to_largest(got[name], v, 1e-2)


@pytest.mark.parametrize("fused,in_feats,heads", [(False, 12, 2), (True, 12, 2), (True, 4, 1)],
                         ids=["edge", "fused", "fused-narrow"])
def test_gatconv_edge_dtype_matches_flax(fused, in_feats, heads):
    """Both forms against flax's edge form with ``edge_dtype`` (its XLA
    path): the same function with bfloat16 rows. The JAX lane path's
    fused kernels compute it too (``test_k3_on_bf16_v_matches_lane_gat_agg``),
    but take 10–40 s a case in interpret mode, and jitted in interpret mode
    on the CPU the narrow case (in < out) of the JAX layer's lane path in
    bfloat16 disagrees with its own eager run."""
    rng, gj, gt = _graph(9)
    out_feats = 6
    x = rng.standard_normal((N, in_feats)).astype(np.float32)
    cot = rng.standard_normal((N, heads, out_feats)).astype(np.float32)
    fc = FlaxGATConv(out_feats, num_heads=heads, edge_dtype=jnp.bfloat16)
    params = {"fc": {"kernel": rng.standard_normal((in_feats, heads * out_feats))
                     .astype(np.float32) * 0.5},
              "attn_l": rng.standard_normal((1, heads, out_feats)).astype(np.float32) * 0.5,
              "attn_r": rng.standard_normal((1, heads, out_feats)).astype(np.float32) * 0.5}
    out_j, grads_j = jax.jit(lambda p: (lambda o, f: (o, f(jnp.asarray(cot))[0]))(
        *jax.vjp(lambda q: fc.apply({"params": q}, gj, jnp.asarray(x)), p)))(params)
    tc = dgl_tpu_torch.GATConv(in_feats, out_feats, heads, edge_dtype=BF16, fused=fused,
                               device="cpu")
    sd = gat_state_dict_from_flax({"gat_0": params})
    tc.load_state_dict({k.removeprefix("convs.0."): v for k, v in sd.items()})
    out_t = tc(gt, torch.from_numpy(x))
    (out_t * torch.from_numpy(cot)).sum().backward()
    assert out_t.dtype == torch.float32 and out_j.dtype == jnp.float32
    _close_to_largest(out_t, out_j, 1e-2)
    want = gat_state_dict_from_flax({"gat_0": jax.tree_util.tree_map(np.asarray, grads_j)})
    for name, p in tc.named_parameters():
        _close_to_largest(p.grad, want[f"convs.0.{name}"], 2e-2)


def test_gatconv_memory_safe_switch_counts_edge_dtype_bytes(monkeypatch):
    """The switch compares the messages at edge_dtype's size, as the JAX
    layer does: bfloat16 messages of twice the limit's float32 elements stay
    in the edge form."""
    import dgl_tpu_torch.nn.conv as conv_mod

    rng, _, gt = _graph(10)
    x = torch.from_numpy(rng.standard_normal((N, 5)).astype(np.float32))
    limit = E * 2 * 3 * 3  # bytes of E·H·D bfloat16 messages, H = 2, D = 3
    monkeypatch.setattr(conv_mod, "_EDGE_MSG_LIMIT_BYTES", limit)
    calls = []
    monkeypatch.setattr(conv_mod.GATConv, "_memory_safe",
                        lambda self, *a: calls.append(self.edge_dtype) or torch.zeros(N, 2, 3))
    for dtype in (BF16, None):
        dgl_tpu_torch.GATConv(5, 3, 2, edge_dtype=dtype, device="cpu")(gt, x)
    assert calls == [None]  # float32's E·H·D·4 bytes pass the limit, bfloat16's do not


# -- the driver ---------------------------------------------------------------

def test_main_sage_bf16_messages_prints_the_reference_lines(tmp_path, monkeypatch, capsys):
    """products at a tiny scale, unhoisted: the K1 calls of a step are the
    float32 run's, the forward's three (D = 64, 64, 47) on bfloat16 rows."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    calls = []
    real = spmm_mod.csr_spmm

    def spy(indptr, indices, x, *a, **kw):
        calls.append((x.dtype, x.shape[1]))
        return real(indptr, indices, x, *a, **kw)

    monkeypatch.setattr(spmm_mod, "csr_spmm", spy)
    runs = {}
    for mode, extra in (("bf16", ["--bf16-messages"]), ("f32", [])):
        calls.clear()
        res = main_sage.main(["--dataset", "ogbn-products", "--device", "cpu", "--scale", "0.002",
                              "--epochs", "4", "--runs", "1", "--eval", "--no-precompute",
                              *extra])
        out = capsys.readouterr().out
        for line in ("Training time/epoch", "Run 00 | Epoch 00003 | Loss", "  Final Train:",
                     "   Final Test:"):
            assert line in out, (mode, line)
        (losses,) = res["losses"]
        assert len(losses) == 4 and all(math.isfinite(v) for v in losses)
        runs[mode] = (list(calls), losses)
    bf16_calls, f32_calls = runs["bf16"][0], runs["f32"][0]
    assert [d for _, d in bf16_calls] == [d for _, d in f32_calls]
    # a step: 3 forward calls on bf16 rows, 3 backward on float32 cotangents;
    # the evaluation's 3 forwards on bf16 rows
    step = [(BF16, 64), (BF16, 64), (BF16, 47), (torch.float32, 47), (torch.float32, 64),
            (torch.float32, 64)]
    assert bf16_calls[:6] == step
    assert {t for t, _ in f32_calls} == {torch.float32}
    l_bf, l_f32 = runs["bf16"][1][0], runs["f32"][1][0]
    assert abs(l_bf - l_f32) <= 1e-2 * abs(l_f32)


def test_main_sage_bf16_messages_refuses_shard(tmp_path, monkeypatch):
    """The sharded models take no msg_dtype (nor do the JAX package's)."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    with pytest.raises(ValueError, match="bf16-messages"):
        main_sage.main(["--dataset", "cora", "--device", "cpu", "--bf16-messages", "--shard", "2",
                        "--dist-backend", "gloo"])
