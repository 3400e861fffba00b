"""The port's halo exchange against the JAX package's, on gloo ranks.

* The plans bit for bit: ``shard_fullgraph_boundary`` (with and without
  ``return_eids``), ``plan_layout_edata_boundary``, ``shard_fullgraph`` and
  ``exchange_stats`` at k = 2 and 4: every count and table, and each
  shard's edge arrays up to its own length (the JAX arrays carry padding).
* The four aggregations, ``halo_spmm_boundary``, ``halo_spmm``,
  ``halo_rgcn_boundary`` and ``halo_gat_boundary``, on k ranks of
  ``parallel/launch.py`` against the JAX functions on k virtual devices
  (``device_mesh((1, k))``), and their gradients wrt the row-sharded
  inputs; against dense numpy oracles too; rows with no in-edge and the
  padding rows past N exactly 0.
* GAT's softmax shift: the JAX bound ``leaky_relu(pmax(a_src) + a_dst)``
  underflows ``exp`` when ``a_src`` spreads over ~87 and zeroes the rows of
  a shard whose in-edges all lie far below the maximum; the port's exact
  row maximum keeps them.

The port's ``halo_gat_boundary`` takes the attention vectors and scores
the rows itself; the JAX function takes the scores, so its reference is
given ``Σ_D z·attn`` and differentiated through them. The attention
vectors' gradients are the ranks' shares summed.

The port runs in float32. The JAX references of the parity tests run in
float64 (``jax.enable_x64``): in float32 the JAX GAT's bound
shift leaves rounding noise of up to ~4e-5 in ``a_dst``'s gradient on rows
whose exact gradient is 0 (one in-edge), where K3's closed form gives 0.
The underflow test runs the JAX function in float32, as it trains. Outputs
at rtol 1e-4, atol 1e-5; gradients at rtol 1e-3 and an atol of 1e-5 of the
largest entry.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from dgl_tpu import parallel as jpar

from dgl_tpu_torch.parallel import checks, halo, launch
from dgl_tpu_torch.parallel.halo_train import exchange_stats

N, E, D, R, HEADS, DH = 300, 2200, 12, 3, 2, 5
ISOLATED = 20  # the last nodes have no in-edge
TIMEOUT = 120.0


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    src = np.clip(rng.integers(0, N, E) + rng.integers(-40, 40, E), 0, N - 1)
    return src, rng.integers(0, N - ISOLATED, E)


def _inputs(seed=1, a_s=None):
    """The aggregations' inputs; ``a_s``, ``a_d`` (N, H) are scores that
    the underflow test puts in z's first two columns (``a_s`` given there)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    src, dst = _graph()
    a = dict(src=src, dst=dst, n=N, x=f(N, D), cot=f(N, D), y=f(N, R * DH),
             w=rng.random((E, R)).astype(np.float32), cot_rgcn=f(N, DH), z=f(N, HEADS, DH),
             a_s=f(N, HEADS), a_d=f(N, HEADS), cot_gat=f(N, HEADS, DH),
             attn_r=f(1, HEADS, DH), attn_l=f(1, HEADS, DH))
    if a_s is not None:
        a["a_s"] = a_s
    return a


def _scores(a):
    """GAT's float64 scores ``(Σ_D z·attn_r, Σ_D z·attn_l)``, (N, H) each."""
    z = a["z"].astype(np.float64)
    return (z * a["attn_r"]).sum(-1), (z * a["attn_l"]).sum(-1)


def _spawn(tmp_path_factory, fn, a, k):
    path = str(tmp_path_factory.mktemp("halo") / "inputs.npz")
    np.savez(path, k=k, **a)
    out = launch.spawn(fn, k, (path,), backend="gloo", device="cpu", timeout=TIMEOUT)
    return {name: np.concatenate([o[name] for o in out]) for name in out[0]}


def _port_ops(tmp_path_factory, a, k):
    """``checks.halo_ops`` on k ranks, the attention vectors' gradients the
    sum of the ranks' shares."""
    out = _spawn(tmp_path_factory, checks.halo_ops, a, k)
    for name in ("gat_grad_attn_r", "gat_grad_attn_l"):
        out[name] = out[name].sum(0, keepdims=True)
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_rank():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks read it at start-up
    yield
    mp.undo()


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def ops(request, tmp_path_factory):
    """(k, port results, JAX results, inputs): every rank's rows stacked."""
    k, a = request.param, _inputs()
    return k, _port_ops(tmp_path_factory, a, k), _jax_ops(a, k), a


def _mesh(k):
    return jpar.device_mesh((1, k), ("data", "graph"), devices=jax.devices()[:k])


def _jax_ops(a, k, x64=True):
    """The JAX functions' outputs and gradients of Σ out · cot (n_pad rows),
    in float64 unless ``x64`` is False."""
    if x64:
        with jax.enable_x64(True):
            return _jax_ops(a, k, x64=False)
    dtype = jnp.zeros(()).dtype
    mesh = _mesh(k)
    sh = NamedSharding(mesh, P("graph"))
    bs, n_pad, leids, heids = jpar.shard_fullgraph_boundary(a["src"], a["dst"], N, k,
                                                             return_eids=True)
    bs = jax.device_put(bs, jax.tree_util.tree_map(lambda _: sh, bs))
    sg, _ = jpar.shard_fullgraph(a["src"], a["dst"], N, k)
    sg = jpar.place(sg, mesh)

    def pad(v):
        out = np.zeros((n_pad,) + v.shape[1:], dtype)
        out[:N] = v
        return jax.device_put(jnp.asarray(out), sh)

    def both(f, cot, *args):
        c = pad(cot)
        val = jax.jit(f)(*args)
        grads = jax.jit(jax.grad(lambda *xs: jnp.sum(f(*xs) * c),
                                 argnums=tuple(range(len(args)))))(*args)
        return [np.asarray(val)] + [np.asarray(g) for g in grads]

    res = {}
    res["spmm"], res["spmm_grad"] = both(lambda x: jpar.halo_spmm_boundary(bs, x, mesh),
                                         a["cot"], pad(a["x"]))
    res["allgather"], res["allgather_grad"] = both(lambda x: jpar.halo_spmm(sg, x, mesh),
                                                   a["cot"], pad(a["x"]))
    wl, wh = jpar.plan_layout_edata_boundary(bs, leids, heids, a["w"].astype(dtype))
    wl, wh = jax.device_put(wl, sh), jax.device_put(wh, sh)
    res["rgcn"], res["rgcn_grad"] = both(
        lambda y: jpar.halo_rgcn_boundary(bs, y, wl, wh, R, mesh), a["cot_rgcn"], pad(a["y"]))
    res["gat"], res["gat_grad_z"], res["gat_grad_attn_r"], res["gat_grad_attn_l"] = both(
        lambda z, ar, al: jpar.halo_gat_boundary(bs, z, (z * ar).sum(-1), (z * al).sum(-1), mesh),
        a["cot_gat"], pad(a["z"]), jnp.asarray(a["attn_r"], dtype), jnp.asarray(a["attn_l"], dtype))
    return res


# -- the plans ---------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("with_eids", [False, True], ids=["plan", "plan_eids"])
def test_boundary_plan_equals_the_jax_plan(k, with_eids):
    src, dst = _graph()
    ours = halo.shard_fullgraph_boundary(src, dst, N, k, return_eids=with_eids)
    theirs = jpar.shard_fullgraph_boundary(src, dst, N, k, return_eids=with_eids)
    bt, bj = ours[0], theirs[0]
    assert ours[1] == theirs[1] == bt.nodes_per_shard * k
    assert (bt.nodes_per_shard, bt.num_shards, bt.rows_per_pair, bt.num_nodes) == (
        bj.nodes_per_shard, bj.num_shards, bj.rows_per_pair, bj.num_nodes)
    np.testing.assert_array_equal(bt.send_tab, np.asarray(bj.send_tab))
    for s in range(k):
        np.testing.assert_array_equal(bt.local_indptr[s], np.asarray(bj.local_indptr[s]))
        np.testing.assert_array_equal(bt.halo_indptr[s], np.asarray(bj.halo_indptr[s]))
        n_loc, n_hal = int(bt.local_indptr[s][-1]), int(bt.halo_indptr[s][-1])
        assert (len(bt.local_src[s]), len(bt.halo_remap[s])) == (n_loc, n_hal)
        np.testing.assert_array_equal(bt.local_src[s], np.asarray(bj.local_src[s])[:n_loc])
        np.testing.assert_array_equal(bt.halo_remap[s], np.asarray(bj.halo_remap[s])[:n_hal])
    if with_eids:
        for e_t, e_j in zip(ours[2:], theirs[2:]):
            for s in range(k):
                np.testing.assert_array_equal(e_t[s], e_j[s])
        w = np.random.default_rng(3).random((E, R)).astype(np.float32)
        for lt, lj in zip(halo.plan_layout_edata_boundary(bt, *ours[2:], w),
                          jpar.plan_layout_edata_boundary(bj, *theirs[2:], w)):
            for s in range(k):
                np.testing.assert_array_equal(lt[s], np.asarray(lj[s])[:len(lt[s])])


@pytest.mark.parametrize("k", [2, 4])
def test_allgather_plan_and_exchange_stats_equal_the_jax_ones(k):
    src, dst = _graph()
    st, n_pad = halo.shard_fullgraph(src, dst, N, k)
    sj, n_pad_j = jpar.shard_fullgraph(src, dst, N, k)
    assert n_pad == n_pad_j and st.nodes_per_shard == sj.nodes_per_shard
    for s in range(k):
        np.testing.assert_array_equal(st.indptr[s], np.asarray(sj.indptr[s]))
        np.testing.assert_array_equal(st.src[s], np.asarray(sj.src[s])[:len(st.src[s])])
    bt, _ = halo.shard_fullgraph_boundary(src, dst, N, k)
    bj, _ = jpar.shard_fullgraph_boundary(src, dst, N, k)
    for d in (16, 602):
        assert exchange_stats(bt, d) == jpar.exchange_stats(bj, d)


def test_the_rank_graph_holds_every_in_edge_once():
    """Shard s's bipartite graph has its local and halo in-edges, and each
    halo edge reads, through the send table and the exchange, the row it
    names: the global source of every edge is recovered."""
    src, dst = _graph()
    k = 4
    bs, _ = halo.shard_fullgraph_boundary(src, dst, N, k)
    nps, H = bs.nodes_per_shard, bs.rows_per_pair
    for s in range(k):
        sh = halo.place(bs, s, "cpu")
        g = sh.graph
        assert (g.num_src_nodes, g.num_dst_nodes) == (nps + k * H, nps)
        col = g.src.long().numpy()
        halo_col = col[col >= nps] - nps
        owner, slot = halo_col // H, halo_col % H
        global_src = np.where(col < nps, col + s * nps, 0)
        global_src[col >= nps] = owner * nps + bs.send_tab[owner, s, slot]
        got = sorted(zip(global_src.tolist(), (g.dst.long().numpy() + s * nps).tolist()))
        m = dst // nps == s
        assert got == sorted(zip(src[m].tolist(), dst[m].tolist()))


# -- the aggregations ----------------------------------------------------------

def _close(got, want, what, grad=False):
    if grad:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("op", ["spmm", "allgather", "rgcn", "gat"])
def test_aggregations_and_gradients_equal_the_jax_functions(ops, op):
    k, ours, theirs, _ = ops
    names = [n for n in ours if n == op or n.startswith(f"{op}_grad")]
    assert len(names) == (4 if op == "gat" else 2)
    for name in names:
        assert ours[name].shape == theirs[name].shape, name
        _close(ours[name], theirs[name], f"k={k} {name}", grad="grad" in name)


def _mean_oracle(src, dst, v):
    out = np.zeros((N,) + v.shape[1:], np.float64)
    np.add.at(out, dst, v[src])
    return out / np.maximum(np.bincount(dst, minlength=N), 1).reshape((-1,) + (1,) * (v.ndim - 1))


def _gat_oracle(src, dst, z, a_s, a_d):
    logits = a_s[src].astype(np.float64) + a_d[dst]
    logits = np.where(logits > 0, logits, 0.2 * logits)
    out = np.zeros(z.shape, np.float64)
    for v in range(N):
        m = dst == v
        if m.any():
            p = np.exp(logits[m] - logits[m].max(0))
            out[v] = ((p / p.sum(0))[:, :, None] * z[src[m]]).sum(0)
    return out


def test_aggregations_equal_dense_oracles_and_empty_rows_are_zero(ops):
    k, ours, _, a = ops
    src, dst = a["src"], a["dst"]
    _close(ours["spmm"][:N], _mean_oracle(src, dst, a["x"]), "spmm")
    y = a["y"].reshape(N, R, DH)
    msg = np.einsum("er,erd->ed", a["w"].astype(np.float64), y[src])
    rgcn = np.zeros((N, DH))
    np.add.at(rgcn, dst, msg)
    rgcn /= np.maximum(np.bincount(dst, minlength=N), 1)[:, None]
    _close(ours["rgcn"][:N], rgcn, "rgcn")
    _close(ours["gat"][:N], _gat_oracle(src, dst, a["z"], *_scores(a)), "gat")
    empty = np.concatenate([np.arange(N - ISOLATED, N), np.arange(N, ours["spmm"].shape[0])])
    assert ours["spmm"].shape[0] > N  # padding rows past N
    for name in ("spmm", "allgather", "rgcn", "gat"):
        assert not ours[name][empty].any(), name


def test_gat_keeps_the_softmax_where_the_jax_bound_underflows(tmp_path_factory):
    """a_src spreads over 1000: shard 1's nodes sit near -1000, shard 0's
    near 0 (a_src is column 0 of the z rows and a_dst column 1: the
    attention vectors pick them), and shard 1's destinations read shard 1's
    sources only. JAX shifts every logit by leaky_relu(max a_src + a_dst);
    on each row whose in-edges all come from the low nodes exp underflows
    to 0 and its where-guard returns 0. K3 shifts by each row's own
    maximum, and those rows equal the float64 oracle."""
    k = 2
    nps = halo.pad_length(-(-N // k), 8)
    src, dst = _graph()
    a_s = np.random.default_rng(5).standard_normal((N, HEADS)).astype(np.float32)
    low = np.arange(nps, N)  # shard 1's nodes
    a_s[low] -= 1000.0
    src = np.where(np.isin(dst, low), np.clip(src, nps, N - 1), src)
    a = _inputs(a_s=a_s)
    a["src"], a["dst"] = src, dst
    a["z"][..., 0], a["z"][..., 1] = a["a_s"], a["a_d"]
    a["attn_r"][:], a["attn_l"][:] = 0.0, 0.0
    a["attn_r"][..., 0], a["attn_l"][..., 1] = 1.0, 1.0
    a_s, a_d = _scores(a)
    assert np.array_equal(a_s, a["a_s"]) and np.array_equal(a_d, a["a_d"])
    ours = _port_ops(tmp_path_factory, a, k)
    theirs = _jax_ops(a, k, x64=False)
    want = _gat_oracle(src, dst, a["z"], a_s, a_d)
    deg = np.bincount(dst, minlength=N)
    from_low = np.bincount(dst, weights=np.isin(src, low), minlength=N)
    rows = np.flatnonzero((deg > 0) & (from_low == deg))
    others = np.flatnonzero((deg > 0) & (from_low < deg))
    assert len(rows) > 50 and len(others) > 50
    assert not theirs["gat"][rows].any()  # the JAX bound's underflow: all 0
    assert np.abs(want[rows]).max() > 0.1
    _close(ours["gat"][:N], want, "port gat")
    _close(theirs["gat"][others], want[others], "jax gat where it does not underflow")
