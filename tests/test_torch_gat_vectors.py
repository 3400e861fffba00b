"""Port parity for GATConv's fused form with its scores in K3's node passes
(``kernels/gat_attention.py:gat_attention_vectors``: ``gat_scores``,
``gat_score_grad``, b2's ``grad_a_src`` and ``gat_vector_grad``), whose
passes take their plain versions on CPU tensors.

The fused layer's output and the gradients of its input(s), ``fc.weight``,
``attn_l`` and ``attn_r`` against the JAX package's edge form of the same
layer on the same numpy weights (``dgl_tpu.ops.edge_softmax`` and
``gspmm(copy_e, sum)`` over ``x Wᵀ``, the scores ``Σ_D z·attn``), with the
attention dropout as the port draws it (``keep_mask(drop_keys(eid, H))``,
from a numpy copy of the hash) on a graph with zero-in-degree rows and rows
of more than T = 512 edges in both CSRs: v is z; the narrow case (in_feats
< out_feats, the expanded x aggregated); an ``(x_src, x_dst)`` pair (z_dst
apart from z); a bfloat16 ``edge_dtype`` (v the bfloat16 cast of z), each
with and without attention dropout. And the node passes' plain versions
against autograd of the expressions they replace.

Tolerances: 1e-4 on values and gradients in float32 (``tests/test_torch_gat``'s),
bfloat16 v 2e-3 (both sides sum the same bfloat16 values in float32, in
another order, and round v's gradient to bfloat16 once).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl_tpu
from dgl_tpu.ops import edge_softmax as jax_edge_softmax
from dgl_tpu.ops import gspmm as jax_gspmm

import dgl_tpu_torch
from dgl_tpu_torch.graph.split import SPLIT_T
from dgl_tpu_torch.kernels.gat_attention import (
    gat_score_grad,
    gat_scores,
    gat_vector_grad,
    gat_vector_grad_plain,
)

N = 80


def _graph(seed):
    """Edges into the first 3/4 of the nodes (the rest have in-degree 0),
    node 2 receiving and node 7 sending more than T edges."""
    rng = np.random.default_rng(seed)
    e, hub = 600, SPLIT_T + 40
    src = np.concatenate([rng.integers(0, N, e), rng.integers(0, N, hub), np.full(hub, 7)])
    dst = np.concatenate([rng.integers(0, 3 * N // 4, e), np.full(hub, 2),
                          rng.integers(0, 3 * N // 4, hub)])
    return rng, src, dst


def _np_keep(key, seed, keep):
    """The port's dropout factor (``keep_mask``) in numpy on uint32 keys."""
    x = key.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    thresh = np.uint32(min(int(keep * float(1 << 24)), 1 << 24))
    return np.where((x & np.uint32(0xFFFFFF)) < thresh, np.float32(1.0 / keep), np.float32(0.0))


CASES = {  # in_feats, out_feats, heads, pair, edge_dtype
    "z": (12, 6, 2, False, None),
    "narrow": (5, 9, 2, False, None),
    "pair": (8, 6, 3, True, None),
    "bf16": (12, 6, 2, False, torch.bfloat16),
}


@pytest.mark.parametrize("keep", [1.0, 0.7], ids=["no-drop", "drop"])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_gatconv_matches_jax_edge_form(case, keep):
    in_feats, out_feats, heads, pair, edge_dtype = CASES[case]
    rng, src, dst = _graph(len(case) + in_feats)
    x = rng.standard_normal((N, in_feats)).astype(np.float32)
    x_dst = rng.standard_normal((N, in_feats)).astype(np.float32) if pair else x
    cot = rng.standard_normal((N, heads, out_feats)).astype(np.float32)

    gt = dgl_tpu_torch.from_edges(src, dst, N, device="cpu")
    assert gt.split.num_long and gt.reverse.split.num_long
    conv = dgl_tpu_torch.GATConv(in_feats, out_feats, heads, attn_drop=1.0 - keep, fused=True,
                                 edge_dtype=edge_dtype, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    ins = [torch.tensor(x, requires_grad=True)] + ([torch.tensor(x_dst, requires_grad=True)]
                                                   if pair else [])
    out = conv(gt, tuple(ins) if pair else ins[0], generator=torch.Generator().manual_seed(5))
    (out * torch.from_numpy(cot)).sum().backward()
    assert not out.detach()[3 * N // 4:].any()  # zero in-degree rows give 0
    # the dropout seed the layer drew: its generator's first draw
    seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(5)))

    gj = dgl_tpu.from_edges(src, dst, N)
    src_c, dst_c = (np.pad(a, (0, gj.num_edges_padded - len(src))) for a in gj.edges_numpy())
    keys = np.arange(gj.num_edges_padded)[:, None] * heads + np.arange(heads)
    mask = _np_keep(keys, seed, keep) if keep < 1.0 else np.ones_like(keys, np.float32)
    w0, al0, ar0 = (p.detach().numpy() for p in (conv.fc.weight, conv.attn_l, conv.attn_r))
    cast = (lambda t: t.astype(jnp.bfloat16).astype(jnp.float32)) if edge_dtype else (lambda t: t)

    def jax_loss(w, al, ar, xs, xd):
        z = (xs @ w.T).reshape(N, heads, out_feats)
        zd = (xd @ w.T).reshape(N, heads, out_feats)
        logits = jax.nn.leaky_relu(jnp.sum(z * ar, -1)[src_c] + jnp.sum(zd * al, -1)[dst_c], 0.2)
        alpha = jax_edge_softmax(gj, logits) * mask
        o = jax_gspmm(gj, "copy_e", "sum", e=alpha[..., None] * cast(z)[src_c])
        return jnp.sum(o * cot), o

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                                  has_aux=True))(w0, al0, ar0, x, x_dst)
    tol = dict(rtol=2e-3, atol=2e-3) if edge_dtype else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **tol)
    g_x = np.asarray(grads[3]) + (0.0 if pair else np.asarray(grads[4]))
    got = {"fc.weight": conv.fc.weight.grad, "attn_l": conv.attn_l.grad,
           "attn_r": conv.attn_r.grad, "x": ins[0].grad}
    wants = {"fc.weight": grads[0], "attn_l": grads[1], "attn_r": grads[2], "x": g_x}
    if pair:
        got["x_dst"], wants["x_dst"] = ins[1].grad, grads[4]
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(wants[name]), **tol,
                                   err_msg=f"gradient of {name}")


@pytest.mark.parametrize("pair", [False, True], ids=["z", "pair"])
def test_node_passes_match_autograd_of_the_scores(pair):
    """On CPU tensors: ``gat_scores`` is ``Σ_D z·attn``; ``gat_vector_grad``
    gives what autograd gives for z, z_dst and the vectors through the
    scores (plus grad_v where v is z); ``gat_score_grad`` packs node and
    ``grad_a_dst = Σ_D g·w1 − C·w1s``."""
    gen = torch.Generator().manual_seed(3)
    n, h, d = 30, 3, 5
    z = torch.randn(n, h, d, generator=gen, requires_grad=True)
    zd = torch.randn(n, h, d, generator=gen, requires_grad=True) if pair else z
    att_s, att_d = (torch.randn(1, h, d, generator=gen, requires_grad=True) for _ in range(2))
    a_src, a_dst = (z * att_s).sum(-1), (zd * att_d).sum(-1)
    got = gat_scores(z.detach(), att_s.detach(), att_d.detach(), None if not pair else zd.detach())
    torch.testing.assert_close(got[0], a_src.detach())
    torch.testing.assert_close(got[1], a_dst.detach())
    ga_s, ga_d = torch.randn(n, h, generator=gen), torch.randn(n, h, generator=gen)
    gv = None if pair else torch.randn(n, h, d, generator=gen)
    ((a_src * ga_s).sum() + (a_dst * ga_d).sum()).backward()
    gz, gzd, g_as, g_ad = gat_vector_grad(z.detach(), att_s.detach(), att_d.detach(), ga_s, ga_d,
                                          grad_v=gv, z_dst=zd.detach() if pair else None)
    torch.testing.assert_close(gz, z.grad + (0 if gv is None else gv))
    assert (gzd is None) != pair
    if pair:
        torch.testing.assert_close(gzd, zd.grad)
    torch.testing.assert_close(g_as, att_s.grad[0])
    torch.testing.assert_close(g_ad, att_d.grad[0])
    g, out, w1 = (torch.randn(n, h, d, generator=gen) for _ in range(3))
    a_d, shift, inv_s, w1s = (torch.randn(n, h, generator=gen) for _ in range(4))
    node, gad = gat_score_grad(g, out, w1, a_d, shift, inv_s, w1s)
    c = (g * out).sum(-1)
    torch.testing.assert_close(node, torch.stack([a_d, shift, inv_s, c], -1))
    torch.testing.assert_close(gad, (g * w1).sum(-1) - c * w1s)
    # the plain version is the CPU path
    ref = gat_vector_grad_plain(z.detach(), att_s, att_d, ga_s, ga_d, gv,
                                zd.detach() if pair else None)
    torch.testing.assert_close(ref[0], gz)


def test_node_passes_check_their_operands():
    z = torch.randn(4, 2, 3)
    a = torch.randn(1, 2, 3)
    with pytest.raises(TypeError, match="float32"):
        gat_scores(z.double(), a, a)
    with pytest.raises(ValueError, match="attention vector"):
        gat_scores(z, torch.randn(1, 3, 2), a)
    with pytest.raises(ValueError, match="contiguous"):
        gat_scores(z.transpose(1, 2).contiguous().transpose(1, 2), a, a)
    with pytest.raises(ValueError, match="do not match"):
        gat_vector_grad(z, a, a, torch.randn(4, 2), torch.randn(3, 2))
    with pytest.raises(ValueError, match="do not match"):
        gat_score_grad(z, z, z, *(torch.randn(4, 3) for _ in range(4)))
