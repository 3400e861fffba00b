"""Port parity for K3, the fused GAT attention, and its dropout hash.

``gat_attention`` (the autograd Function, whose two passes take their plain
versions on CPU tensors) and ``gat_attention_plain`` against the JAX
package on the same numpy inputs, values and the gradients of v, a_src and
a_dst:

* with dropout (keep 0.7, one shared int32 seed), a skewed source side
  and rows with no in-edges: at one head against ``lane_gat_agg(...,
  compute_dtype=float32, interpret=True)`` on fully covered lane plans, the
  Pallas kernel run as ``tests/test_attention_kernel.py`` runs it (the
  port's key ``eid·H + h`` is the lane kernel's ``eid`` there, so the masks
  agree bit for bit); at four heads, where the lane kernel draws one mask
  an edge for every head, against the JAX package's edge form with the
  mask of a numpy copy of ``_hash_keep`` on the key ``eid·H + h``;
* without dropout, one head, against the JAX package's edge form of the
  same function (``edge_softmax`` and ``gspmm(copy_e, sum)``).

The merges that the kernels' row split performs (a forward chunk's own
shift, b2's linear sums) are pinned in float64 against the unsplit plain
passes.

Tolerances as ``tests/test_attention_kernel.py`` states them: 2e-5 on
values, 5e-4 on gradients (sums of up to ~100 terms of size ~10 in another
order, under another softmax shift).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.kernels import attach_lane_plans
from dgl_tpu.kernels.lane_attention import _hash_keep, lane_gat_agg
from dgl_tpu.ops import edge_softmax as jax_edge_softmax
from dgl_tpu.ops import gspmm as jax_gspmm

import dgl_tpu_torch
from dgl_tpu_torch.graph.split import row_split
from dgl_tpu_torch.kernels.gat_attention import (
    gat_attention,
    gat_attention_bwd,
    gat_attention_bwd_plain,
    gat_attention_fwd,
    gat_attention_fwd_plain,
    gat_attention_plain,
    drop_keys,
    keep_mask,
)
from dgl_tpu_torch.ops import edge_softmax, gather_dst, gather_src_rows, gspmm

N, E, D = 60, 400, 8
SEED = -1234567  # one int32 attention-dropout seed for both packages


def _problem(seed, heads, skew):
    """Edges into the first 3/4 of the nodes (the rest have in-degree 0)."""
    rng = np.random.default_rng(seed)
    src = (rng.zipf(1.5, E) - 1) % N if skew else rng.integers(0, N, E)
    dst = rng.integers(0, 3 * N // 4, E)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((N, heads, D), (N, heads), (N, heads), (N, heads, D))]
    return src, dst, arrays


def _check_port(src, dst, arrays, want, grads_want, keep):
    v, a_s, a_d, tgt = arrays
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    seed = torch.tensor([SEED], dtype=torch.int32)
    for name, fn in [
        ("gat_attention", lambda *a: gat_attention(gt, *a, keep=keep, seed=seed)),
        ("gat_attention_plain",
         lambda *a: gat_attention_plain(gt.indptr, gt.src, *a, keep=keep, seed=seed)),
    ]:
        ins = [torch.tensor(a, requires_grad=True) for a in (v, a_s, a_d)]
        out = fn(*ins)
        ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5,
                                   err_msg=name)
        assert not out.detach()[3 * N // 4:].any()  # zero in-degree rows give 0
        for t, gw, what in zip(ins, grads_want, ("v", "a_src", "a_dst")):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(gw), rtol=5e-4, atol=5e-4,
                                       err_msg=f"{name}: gradient of {what}")


def test_keep_mask_matches_hash_keep_bit_for_bit():
    eid = np.arange(-5, 20000, dtype=np.int32)
    for seed in (0, SEED, 2**31 - 1, -(2**31)):
        for keep in (0.7, 0.82, 0.5):
            want = np.asarray(_hash_keep(jnp.asarray(eid), jnp.int32(seed), keep))
            got = keep_mask(torch.from_numpy(eid), torch.tensor([seed], dtype=torch.int32), keep)
            assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def _np_hash_keep(key, seed, keep):
    """``_hash_keep``'s steps in numpy on uint32 keys."""
    x = key.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    thresh = np.uint32(min(int(keep * float(1 << 24)), 1 << 24))
    return np.where((x & np.uint32(0xFFFFFF)) < thresh, np.float32(1.0 / keep), np.float32(0.0))


def test_drop_keys_mask_matches_a_numpy_copy_of_the_hash():
    eid = np.arange(20000, dtype=np.int64)
    for heads in (1, 3, 4):
        key = (eid[:, None] * heads + np.arange(heads)).astype(np.uint32)
        for seed in (0, SEED, -(2**31)):
            got = keep_mask(drop_keys(torch.from_numpy(eid), heads),
                            torch.tensor([seed], dtype=torch.int32), 0.7)
            assert got.shape == (len(eid), heads)
            assert np.array_equal(got.numpy(), _np_hash_keep(key, seed, 0.7))


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_attention_with_dropout_matches_lane_kernel(heads):
    """H = 1: the lane kernel, whose key is the port's; H = 4: the JAX
    edge form under the port's per-(edge, head) mask, from numpy."""
    keep = 0.7
    src, dst, (v, a_s, a_d, tgt) = _problem(4, heads=heads, skew=True)
    if heads == 1:
        gj = attach_lane_plans(dgl_tpu.from_edges(src, dst, N), dense_threshold=1,
                               max_expansion=1e9, compute_dtype=jnp.float32)
        assert len(gj.lane.plan.rem_src) == 0 and len(gj.reverse.lane.plan.rem_src) == 0

        @jax.jit
        def jax_loss(v, a_s, a_d):
            out = lane_gat_agg(gj.lane.plan, gj.reverse.lane.plan, v, a_s, a_d, N, attn_keep=keep,
                               seed=SEED, compute_dtype=jnp.float32, interpret=True)
            return jnp.sum((out - tgt) ** 2), out
    else:
        gj = dgl_tpu.from_edges(src, dst, N)
        src_c, dst_c = (np.pad(a, (0, gj.num_edges_padded - E)) for a in gj.edges_numpy())
        keys = np.arange(gj.num_edges_padded)[:, None] * heads + np.arange(heads)
        mask = _np_hash_keep(keys, SEED, keep)

        @jax.jit
        def jax_loss(v, a_s, a_d):
            logits = jax.nn.leaky_relu(a_s[src_c] + a_d[dst_c], 0.2)
            alpha = jax_edge_softmax(gj, logits) * mask
            out = jax_gspmm(gj, "copy_e", "sum", e=alpha[..., None] * v[src_c])
            return jnp.sum((out - tgt) ** 2), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(v, a_s, a_d)
    _check_port(src, dst, (v, a_s, a_d, tgt), want, grads, keep)


def test_gat_attention_matches_jax_edge_form():
    src, dst, (v, a_s, a_d, tgt) = _problem(1, heads=1, skew=False)
    gj = dgl_tpu.from_edges(src, dst, N)
    src_c, dst_c = (np.pad(a, (0, gj.num_edges_padded - E)) for a in gj.edges_numpy())

    @jax.jit
    def jax_loss(v, a_s, a_d):
        logits = jax.nn.leaky_relu(a_s[src_c] + a_d[dst_c], 0.2)
        alpha = jax_edge_softmax(gj, logits)
        out = jax_gspmm(gj, "copy_e", "sum", e=alpha[..., None] * v[src_c])
        return jnp.sum((out - tgt) ** 2), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(v, a_s, a_d)
    _check_port(src, dst, (v, a_s, a_d, tgt), want, grads, 1.0)


def test_fused_and_edge_forms_drop_the_same_edge_head_pairs_given_the_same_mask():
    """K3 with dropout against the port's edge form (``edge_softmax``,
    ``gspmm(copy_e, sum)``) whose attention is multiplied by K3's own mask,
    ``keep_mask(drop_keys(eid, H))`` of the canonical edge ids: values and
    gradients agree, and the mask differs between heads of one edge."""
    keep, heads = 0.6, 4
    src, dst, (v, a_s, a_d, tgt) = _problem(7, heads=heads, skew=True)
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    seed = torch.tensor([SEED], dtype=torch.int32)
    mask = keep_mask(drop_keys(torch.arange(gt.num_edges), heads), seed, keep)
    assert (mask != mask[:, :1]).any(1).float().mean() > 0.5

    def edge_form(v, a_s, a_d):
        logits = torch.nn.functional.leaky_relu(gather_src_rows(gt, a_s) + gather_dst(gt, a_d),
                                                0.2)
        alpha = edge_softmax(gt, logits) * mask
        return gspmm(gt, "copy_e", "sum", e=alpha.unsqueeze(-1) * gather_src_rows(gt, v))

    results = []
    for fn in (lambda *a: gat_attention(gt, *a, keep=keep, seed=seed), edge_form):
        ins = [torch.tensor(a, requires_grad=True) for a in (v, a_s, a_d)]
        out = fn(*ins)
        ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
        results.append([out.detach()] + [t.grad for t in ins])
    # values within 2e-5, gradients within 5e-4 (the module's tolerances)
    torch.testing.assert_close(results[0][0], results[1][0], rtol=2e-5, atol=2e-5)
    for got, want, what in zip(results[0][1:], results[1][1:], ("v", "a_src", "a_dst")):
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4, msg=what)


def test_gat_passes_on_cpu_take_plain_versions_and_check_inputs():
    src, dst, _ = _problem(2, heads=2, skew=False)
    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    v, a = torch.randn(N, 2, 4, requires_grad=True), torch.randn(N, 2, requires_grad=True)
    before = (gat_attention_fwd.launches, gat_attention_bwd.launches)
    gat_attention(gt, v, a, a).sum().backward()
    assert (gat_attention_fwd.launches, gat_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="seed"):
        gat_attention(gt, v, a, a, keep=0.5)
    with pytest.raises(TypeError, match="float32"):
        gat_attention(gt, v.double(), a, a)
    with pytest.raises(ValueError, match="do not match"):
        gat_attention(gt, v[:5], a, a)


def _chunks(plan):
    """Each long row with its chunks' [begin, end) pairs, in ascending order."""
    ptr, chunks = plan.chunk_ptr.tolist(), plan.chunks.tolist()
    return [(r, chunks[ptr[i]:ptr[i + 1]]) for i, r in enumerate(plan.rows.tolist())]


@pytest.mark.parametrize("keep", [1.0, 0.82])
@pytest.mark.parametrize("heads,d", [(2, 3), (4, 40)])  # (4, 40): arxiv's last layer
def test_split_merges_match_the_unsplit_passes(heads, d, keep):
    """The algebra of K3's combines, in float64. Both CSRs are cut at t = 4;
    each chunk of a long row runs through the plain pass alone, with its
    global edge ids for the dropout hash (the forward's chunk is the second
    row of a CSR whose first row holds the edges before it), and the chunks
    are merged as the kernels merge them: the forward takes sh = max_k sh_k
    and adds f_k·(num_k, w1u_k, s_k, w1su_k), f_k = exp(sh_k − sh), in
    ascending chunk order; b2 adds its chunks' sums in ascending order
    (grad_a_src = Σ_D v·w2 − w3 is linear in them). All seven outputs of
    every long row match the unsplit plain passes."""
    rng = np.random.default_rng(11)
    n, t = 12, 4
    src = np.concatenate([rng.integers(0, n, 50), np.full(11, 5), rng.integers(0, n, 13)])
    dst = np.concatenate([rng.integers(0, n, 50), rng.integers(0, n, 11), np.full(13, 3)])
    g = dgl_tpu_torch.from_edges(src, dst, n, device="cpu")
    rev = g.reverse
    v, gout = (torch.from_numpy(rng.standard_normal((n, heads, d))) for _ in range(2))
    a_s, a_d, c = (torch.from_numpy(2 * rng.standard_normal((n, heads))) for _ in range(3))
    kw = dict(negative_slope=0.2, keep=keep, seed=torch.tensor([SEED], dtype=torch.int32))
    tol = dict(rtol=1e-12, atol=1e-12)

    fwd = gat_attention_fwd_plain(g.indptr, g.src, v, a_s, a_d, **kw)
    long_fwd = _chunks(row_split(g.indptr, t))
    assert len(long_fwd) >= 2 and max(len(ch) for _, ch in long_fwd) >= 3
    for r, chunks in long_fwd:
        parts = []
        for b, e in chunks:
            ip = torch.tensor([0, b, e], dtype=torch.int64)
            o, w1, inv_s, w1s, sh = (x[1] for x in gat_attention_fwd_plain(
                ip, g.src[:e], v, a_s, a_d[[r, r]], **kw))
            s_k = 1.0 / inv_s  # the chunk's unnormalised sums
            parts.append((sh, o * s_k[:, None], w1 * s_k[:, None], s_k, w1s * s_k))
        sh = torch.stack([p[0] for p in parts]).amax(0)
        num, w1u, s_, w1su = (torch.zeros_like(x) for x in parts[0][1:])
        for sh_k, num_k, w1u_k, s_k, w1su_k in parts:
            f = torch.exp(sh_k - sh)
            num, w1u = num + f[:, None] * num_k, w1u + f[:, None] * w1u_k
            s_, w1su = s_ + f * s_k, w1su + f * w1su_k
        merged = (num / s_[:, None], w1u / s_[:, None], 1.0 / s_, w1su / s_, sh)
        for name, got, want in zip(("out", "w1", "inv_s", "w1s", "shift"), merged, fwd):
            torch.testing.assert_close(got, want[r], **tol, msg=f"forward {name}, row {r}")

    node = torch.stack([a_d, fwd[4], fwd[2], c], -1)
    bwd = gat_attention_bwd_plain(rev.indptr, rev.src, rev.eid, gout, node, a_s, v, **kw)
    long_rev = _chunks(row_split(rev.indptr, t))
    assert len(long_rev) >= 2 and max(len(ch) for _, ch in long_rev) >= 3
    for r, chunks in long_rev:
        merged = None
        for b, e in chunks:
            ip = torch.tensor([0, e - b], dtype=torch.int64)
            part = [x[0] for x in gat_attention_bwd_plain(
                ip, rev.src[b:e], rev.eid[b:e], gout, node, a_s[r:r + 1], v[r:r + 1], **kw)]
            merged = part if merged is None else [m + p for m, p in zip(merged, part)]
        for name, got, want in zip(("grad_v", "grad_a_src"), merged, bwd):
            torch.testing.assert_close(got, want[r], **tol, msg=f"b2 {name}, row {r}")
