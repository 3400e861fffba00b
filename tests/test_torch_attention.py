"""Port parity for K3, the fused GAT attention, and its dropout hash.

``gat_attention`` (the autograd Function, whose two passes take their plain
versions on CPU tensors) and ``gat_attention_plain`` against the JAX
package on the same numpy inputs, values and the gradients of v, a_src and
a_dst:

* with dropout (keep 0.7, one shared int32 seed: the masks agree bit for
  bit), four heads, a skewed source side and rows with no in-edges, against
  ``lane_gat_agg(..., compute_dtype=float32, interpret=True)`` on fully
  covered lane plans, the Pallas kernel run as
  ``tests/test_attention_kernel.py`` runs it;
* without dropout, one head, against the JAX package's edge form of the
  same function (``edge_softmax`` and ``gspmm(copy_e, sum)``).

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
from dgl_tpu_torch.kernels.gat_attention import (
    gat_attention,
    gat_attention_bwd,
    gat_attention_fwd,
    gat_attention_plain,
    keep_mask,
)

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


def test_gat_attention_with_dropout_matches_lane_kernel():
    keep = 0.7
    src, dst, (v, a_s, a_d, tgt) = _problem(4, heads=4, skew=True)
    gj = attach_lane_plans(dgl_tpu.from_edges(src, dst, N), dense_threshold=1,
                           max_expansion=1e9, compute_dtype=jnp.float32)
    assert len(gj.lane.plan.rem_src) == 0 and len(gj.reverse.lane.plan.rem_src) == 0

    @jax.jit
    def jax_loss(v, a_s, a_d):
        out = lane_gat_agg(gj.lane.plan, gj.reverse.lane.plan, v, a_s, a_d, N, attn_keep=keep,
                           seed=SEED, compute_dtype=jnp.float32, interpret=True)
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
