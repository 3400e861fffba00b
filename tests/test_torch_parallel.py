"""The port's sharded models, edge-sharded SpMM and data parallelism against
the JAX package, on gloo ranks of ``parallel/launch.py``.

* ``HaloSAGE``, ``HaloGAT`` and ``HaloRGCN`` (``parallel/halo_train.py``) at
  the JAX initialisers' weights, carried by ``convert.py``, on k = 2 and 4
  ranks against ``halo_*_apply`` on k virtual devices: logits at rtol 2e-4,
  atol 2e-5 (dropout 0); three train steps (Adam with coupled L2 for SAGE
  and GAT, plain Adam for RGCN) give the JAX losses within 1e-5 relative;
  after them every rank holds the same parameters, bit for bit.
* HaloSAGE's dropout at 0.5: the kept share within 4σ of 0.5, kept entries
  scaled by 2.
* The launches of a step, counted by spies on the kernel wrappers on the
  CPU, are the ones ``chip_smoke.py`` derives (``halo_*_launches``), the
  payloads' adjoints among them as ``exchange.send_adjoint_launches``
  counts them.
* ``checks.halo_grads``: one step's gradients of HaloSAGE and HaloGAT on
  k gloo ranks, summed over them, equal on every rank and equal to one
  process's over a plan of one shard.
* ``spmd.sharded_gspmm`` mean over k ranks' edge slices against the
  one-process ``gspmm`` and JAX's ``shard_graph`` path, output and the
  gradient wrt the replicated input.
* ``dp.make_dp_train_step`` on two ranks, each with its own sampled
  minibatch, against JAX ``make_dp_train_step`` on a 2-device mesh.
* The launcher: a failing rank's traceback is raised in the parent and the
  ranks blocked with it are killed; at the time limit every rank is killed.
"""

import json
import os
import sys
import time

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import dgl_tpu
from dgl_tpu import parallel as jpar
from dgl_tpu.models import GraphSAGE as FlaxGraphSAGE
from dgl_tpu.sampling import CSRGraph as JaxCSRGraph
from dgl_tpu.sampling import MultiLayerNeighborSampler as JaxSampler

import dgl_tpu_torch.kernels.gat_attention as gat_mod
import dgl_tpu_torch.ops.gather as gather_mod
import dgl_tpu_torch.ops.rel as rel_mod
import dgl_tpu_torch.ops.segment as segment_mod
import dgl_tpu_torch.ops.spmm as spmm_mod
from dgl_tpu_torch.csrc import native
from dgl_tpu_torch.convert import (halo_gat_state_dict_from_jax, halo_rgcn_state_dict_from_jax,
                                   halo_sage_state_dict_from_jax, sage_state_dict_from_flax)
from dgl_tpu_torch.graph import from_edges, transforms
from dgl_tpu_torch.ops import gspmm
from dgl_tpu_torch.parallel import checks, halo, launch
from dgl_tpu_torch.parallel.multihost import RankMesh
from dgl_tpu_torch.parallel.spmd import graph_sharding, node_sharding
from dgl_tpu_torch.parallel.halo_train import (HaloGAT, HaloRGCN, HaloSAGE,
                                               make_halo_gat_train_step,
                                               make_halo_rgcn_train_step, make_halo_train_step)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

N, E, D, C, T, R = 300, 2200, 12, 5, 4, 3
HID, GAT_HID, HEADS = 8, 6, (2, 2)
STEPS, LR, WD = 3, 1e-2, 5e-4
TIMEOUT = 120.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread_per_rank():
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks read it at start-up
    yield
    mp.undo()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    src = np.clip(rng.integers(0, N, E) + rng.integers(-40, 40, E), 0, N - 1)
    dst = rng.integers(0, N - 10, E)
    return dict(src=src, dst=dst, n=N, x=rng.standard_normal((N, D)).astype(np.float32),
                labels=rng.integers(0, C, N), mask=rng.random(N) < 0.6,
                multi=(rng.random((N, T)) < 0.3).astype(np.float32),
                w=rng.random((E, R)).astype(np.float32))


def _jax_params():
    key = jax.random.PRNGKey(0)
    return {"sage": _np_tree(jpar.halo_sage_init(key, D, HID, C, 2)),
            "gat": _np_tree(jpar.halo_gat_init(key, D, GAT_HID, C, heads=HEADS)),
            "rgcn": _np_tree(jpar.halo_rgcn_init(key, D, HID, T, R, num_layers=2))}


def _state_dicts(params):
    conv = {"sage": halo_sage_state_dict_from_jax, "gat": halo_gat_state_dict_from_jax,
            "rgcn": halo_rgcn_state_dict_from_jax}
    return {name: conv[name](params[name]) for name in conv}


def _jax_models(a, params, k):
    """Logits (n_pad rows) and STEPS train-step losses of the JAX halo
    models on a (1, k) mesh."""
    mesh = jpar.device_mesh((1, k), ("data", "graph"), devices=jax.devices()[:k])
    row = NamedSharding(mesh, P("graph"))
    bs, n_pad, leids, heids = jpar.shard_fullgraph_boundary(a["src"], a["dst"], N, k,
                                                             return_eids=True)
    wl, wh = jpar.plan_layout_edata_boundary(bs, leids, heids, a["w"])
    bs = jax.device_put(bs, jax.tree_util.tree_map(lambda _: row, bs))
    wl, wh = jax.device_put(wl, row), jax.device_put(wh, row)

    def pad(v, dtype=None):
        out = np.zeros((n_pad,) + v.shape[1:], dtype or v.dtype)
        out[:N] = v
        return jax.device_put(jnp.asarray(out), row)

    x, y, mask, multi = pad(a["x"]), pad(a["labels"], np.int32), pad(a["mask"]), pad(a["multi"])
    l2 = optax.chain(optax.add_decayed_weights(WD), optax.adam(LR))
    res = {
        "sage_logits": jax.jit(lambda p, b, xx: jpar.halo_sage_apply(p, b, xx, mesh))(
            params["sage"], bs, x),
        "gat_logits": jax.jit(lambda p, b, xx: jpar.halo_gat_apply(p, b, xx, mesh, heads=HEADS))(
            params["gat"], bs, x),
        "rgcn_logits": jax.jit(lambda p, b, xx: jpar.halo_rgcn_apply(p, b, xx, wl, wh, R, mesh))(
            params["rgcn"], bs, x),
    }
    runs = {
        "sage": (jpar.make_halo_train_step(mesh, l2, dropout=0.0), l2,
                 lambda s, p, o: s(p, o, jax.random.PRNGKey(1), bs, x, y, mask)),
        "gat": (jpar.make_halo_gat_train_step(mesh, l2, HEADS), l2,
                lambda s, p, o: s(p, o, bs, x, y, mask)),
        "rgcn": (jpar.make_halo_rgcn_train_step(mesh, optax.adam(LR), R), optax.adam(LR),
                 lambda s, p, o: s(p, o, bs, x, wl, wh, multi, mask)),
    }
    for name, (step, tx, call) in runs.items():
        p, o, losses = params[name], tx.init(params[name]), []
        for _ in range(STEPS):
            p, o, loss = call(step, p, o)
            losses.append(float(loss))
        res[f"{name}_losses"] = np.array(losses)
    return {key: np.asarray(v) for key, v in res.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["k2", "k4"])
def models(request, tmp_path_factory):
    """(k, each rank's results, the JAX results)."""
    k, a, params = request.param, _data(), _jax_params()
    path = str(tmp_path_factory.mktemp("models") / "inputs.npz")
    weights = {f"{name}.{key}": v.numpy() for name, sd in _state_dicts(params).items()
               for key, v in sd.items()}
    np.savez(path, k=k, heads=np.array(HEADS), steps=STEPS, lr=LR, wd=WD, **a, **weights)
    ours = launch.spawn(checks.halo_models, k, (path,), backend="gloo", device="cpu",
                        timeout=TIMEOUT)
    return k, ours, _jax_models(a, params, k)


@pytest.mark.parametrize("name", ["sage", "gat", "rgcn"])
def test_logits_and_train_steps_equal_jax_and_ranks_stay_equal(models, name):
    k, ours, theirs = models
    logits = np.concatenate([o[f"{name}_logits"] for o in ours])
    np.testing.assert_allclose(logits, theirs[f"{name}_logits"], rtol=2e-4, atol=2e-5)
    for o in ours:  # every rank returns the global loss
        np.testing.assert_array_equal(o[f"{name}_losses"], ours[0][f"{name}_losses"])
    np.testing.assert_allclose(ours[0][f"{name}_losses"], theirs[f"{name}_losses"], rtol=1e-5)
    assert ours[0][f"{name}_losses"][-1] < ours[0][f"{name}_losses"][0]
    keys = [key for key in ours[0] if key.startswith(f"{name}.")]
    assert keys
    for o in ours[1:]:
        for key in keys:
            np.testing.assert_array_equal(o[key], ours[0][key], err_msg=f"k={k} {key}")


def _k1_shard(src, dst):
    bs, _ = halo.shard_fullgraph_boundary(src, dst, N, 1)
    return halo.place(bs, 0, "cpu")


def test_sage_dropout_keeps_half_and_scales_by_two():
    """One layer whose w_self is the identity and w_neigh 0 returns its
    dropped input: in a world of one rank (no process group), x = 1."""
    a = _data()
    shard = _k1_shard(a["src"], a["dst"])
    model = HaloSAGE(D, D, D, 1, dropout=0.5, device="cpu")
    with torch.no_grad():
        model.layers[0]["w_self"].copy_(torch.eye(D))
        model.layers[0]["w_neigh"].zero_()
    x = torch.ones(shard.nodes_per_shard, D)
    out = model(shard, x, generator=torch.Generator().manual_seed(3))
    kept = out != 0
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 2.0))
    n = out.numel()
    assert abs(float(kept.float().mean()) - 0.5) < 4 * (0.25 / n) ** 0.5
    model.eval()
    assert torch.equal(model(shard, x), x)  # no dropout in evaluation


def _spy(monkeypatch, counts, module, name, key=None):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        counts[key or name] = counts.get(key or name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("name", ["sage", "gat", "rgcn"])
def test_calls_per_step_are_the_derived_launches(monkeypatch, name):
    """A step's calls of each kernel wrapper (what launches on the card),
    on a plan of one shard, against chip_smoke's derivations (the exchange
    is the identity at k = 1, the calls are those of every rank)."""
    a = _data()
    shard = _k1_shard(a["src"], a["dst"])
    nps = shard.nodes_per_shard
    x = torch.zeros(nps, D)
    x[:N] = torch.from_numpy(a["x"])
    y = torch.zeros(nps, dtype=torch.int64)
    y[:N] = torch.from_numpy(a["labels"])
    mask = torch.zeros(nps, dtype=torch.bool)
    mask[:N] = torch.from_numpy(a["mask"])
    counts = {}
    for module in (spmm_mod, rel_mod):
        _spy(monkeypatch, counts, module, "csr_spmm")
    k1 = gather_mod.csr_spmm

    def k1_launch(*args, **kwargs):
        """A call counted as a launch, as the wrapper counts one on the card."""
        counts["csr_spmm"] = counts.get("csr_spmm", 0) + 1
        k1.launches += 1
        return k1(*args, **kwargs)

    monkeypatch.setattr(gather_mod, "csr_spmm", k1_launch)
    monkeypatch.setattr(k1, "launches", k1.launches)
    _spy(monkeypatch, counts, segment_mod, "row_gather_by_source")
    for fn in ("gat_attention_fwd", "gat_attention_bwd", "gat_scores", "gat_score_grad",
               "gat_vector_grad"):
        _spy(monkeypatch, counts, gat_mod, fn)
    if name == "sage":
        model = HaloSAGE(D, HID, C, 2, dropout=0.5, device="cpu")
        step = make_halo_train_step(model, torch.optim.Adam(model.parameters()))
        run = lambda: step(shard, x, y, mask)  # noqa: E731
        want = chip_smoke.halo_sage_launches(2)
    elif name == "gat":
        model = HaloGAT(D, GAT_HID, C, (2, 2, 1), device="cpu")
        step = make_halo_gat_train_step(model, torch.optim.Adam(model.parameters()))
        run = lambda: step(shard, x, y, mask)  # noqa: E731
        want = chip_smoke.halo_gat_launches(3)
    else:
        bs, _, leids, heids = halo.shard_fullgraph_boundary(a["src"], a["dst"], N, 1,
                                                            return_eids=True)
        w_loc, w_hal = halo.plan_layout_edata_boundary(bs, leids, heids, a["w"])
        weights = shard.edge_weights(w_loc[0], w_hal[0])
        multi = torch.zeros(nps, T)
        multi[:N] = torch.from_numpy(a["multi"])
        model = HaloRGCN(D, HID, T, R, 3, device="cpu")
        step = make_halo_rgcn_train_step(model, torch.optim.Adam(model.parameters()))
        run = lambda: step(shard, x, weights, multi, mask)  # noqa: E731
        want = chip_smoke.halo_rgcn_launches(3, R)
    counts.clear()
    before = halo.exchange.send_adjoint_launches
    for _ in range(2):
        run()
    counts["send_adjoint"] = halo.exchange.send_adjoint_launches - before
    assert counts == {key: 2 * v for key, v in want.items()}


def test_node_sharding_and_graph_sharding_take_this_ranks_block():
    """On a (1, 4) grid, coordinate 2 of the graph axis: rows 2n/4..3n/4
    and edges 2·ceil(E/4)..; along the data axis (size 1) everything."""
    mesh = RankMesh(("data", "graph"), np.arange(4).reshape(1, 4), (0, 2), {})
    x = torch.arange(40.0).reshape(20, 2)
    assert torch.equal(node_sharding(x, mesh), x[10:15])
    assert torch.equal(node_sharding(x, mesh, "data"), x)
    assert graph_sharding(10, mesh) == slice(6, 9)
    with pytest.raises(ValueError, match="equal blocks"):
        node_sharding(x[:19], mesh)


def _spmd_inputs(seed=4):
    rng = np.random.default_rng(seed)
    return dict(src=rng.integers(0, N, E), dst=rng.integers(0, N - 10, E), n=N,
                x=rng.standard_normal((N, D)).astype(np.float32),
                cot=rng.standard_normal((N, D)).astype(np.float32))


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_gspmm_equals_one_process_and_the_jax_shard_graph_path(tmp_path, k):
    a = _spmd_inputs()
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **a)
    ours = launch.spawn(checks.spmd_gspmm, k, (path,), backend="gloo", device="cpu",
                        timeout=TIMEOUT)
    x = torch.from_numpy(a["x"]).requires_grad_()
    ref = gspmm(from_edges(a["src"], a["dst"], N, device="cpu"), "copy_u", "mean", x=x)
    (ref * torch.from_numpy(a["cot"])).sum().backward()
    for o in ours:  # replicated: every rank holds the whole result, the same bits
        np.testing.assert_array_equal(o["out"], ours[0]["out"])
        np.testing.assert_array_equal(o["grad"], ours[0]["grad"])
    np.testing.assert_allclose(ours[0]["out"], ref.detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours[0]["grad"], x.grad.numpy(), rtol=1e-5, atol=1e-6)
    mesh = jpar.device_mesh((1, k), ("data", "graph"), devices=jax.devices()[:k])
    g = dgl_tpu.from_edges(a["src"], a["dst"], N, e_pad=-(-E // (128 * k)) * 128 * k)
    g_sh = jpar.shard_graph(g, mesh)
    x_sh = jax.device_put(jnp.asarray(a["x"]), NamedSharding(mesh, P("graph")))
    f = lambda g, x: dgl_tpu.ops.gspmm(g, "copy_u", "mean", x=x)  # noqa: E731
    np.testing.assert_allclose(ours[0]["out"], np.asarray(jax.jit(f)(g_sh, x_sh)), rtol=1e-5,
                               atol=1e-6)
    grad = jax.jit(jax.grad(lambda x: jnp.sum(f(g_sh, x) * a["cot"])))(x_sh)
    np.testing.assert_allclose(ours[0]["grad"], np.asarray(grad), rtol=1e-5, atol=1e-6)


def test_dp_step_equals_the_jax_dp_step(tmp_path):
    """Two ranks, each its own minibatch (both packages' samplers draw the
    same one from one generator state and one OpenMP thread; the native
    sampler's draws depend on the team size), one SGD step: the mean loss and
    the new parameters of JAX's make_dp_train_step on a (2, 1) mesh; each
    rank's own gradient, averaged, is the step's."""
    rng = np.random.default_rng(0)
    n, e, d, c, fanouts, b = 200, 1500, 8, 4, [3, 3], 16
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.integers(0, c, n)
    csr = JaxCSRGraph.from_edges(src, dst, n)
    sampler = JaxSampler(fanouts)
    mbs, inputs = [], {}
    lib = native.load()  # the ranks sample with one OpenMP thread: so does this
    threads = lib.omp_get_max_threads()
    lib.omp_set_num_threads(1)
    try:
        for r in range(2):
            seeds = rng.choice(n, b, replace=False)
            inputs[f"seeds_{r}"] = seeds
            inputs[f"rng_{r}"] = np.array(json.dumps(rng.bit_generator.state))
            mbs.append(sampler.sample(csr, seeds, rng, b))
    finally:
        lib.omp_set_num_threads(threads)
    model = FlaxGraphSAGE(hidden_feats=8, out_feats=c, num_layers=2, dropout=0.0)
    params = model.init(jax.random.PRNGKey(0), mbs[0].blocks,
                        jnp.take(jnp.asarray(x), mbs[0].input_nodes, axis=0))["params"]

    def loss_fn(p, mb, x, y):
        logits = model.apply({"params": p}, mb.blocks, jnp.take(x, mb.input_nodes, axis=0))
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                  jnp.take(y, mb.seeds, axis=0)[:, None], 1)[:, 0]
        m = mb.seed_mask.astype(ce.dtype)
        return jnp.sum(ce * m) / jnp.maximum(m.sum(), 1.0)

    tx = optax.sgd(0.1)
    mesh = jpar.device_mesh((2, 1), ("data", "graph"), devices=jax.devices()[:2])
    new_params, _, loss = jpar.make_dp_train_step(loss_fn, tx, mesh)(
        params, tx.init(params), jpar.stack_minibatches(mbs), jnp.asarray(x), jnp.asarray(y))
    sd = sage_state_dict_from_flax(_np_tree(params))
    path = str(tmp_path / "inputs.npz")
    np.savez(path, src=src, dst=dst, n=n, x=x, labels=y, fanouts=np.array(fanouts), b_pad=b,
             k=2, lr=0.1, **inputs, **{f"sage.{key}": v.numpy() for key, v in sd.items()})
    ours = launch.spawn(checks.dp_step, 2, (path,), backend="gloo", device="cpu",
                        timeout=TIMEOUT)
    want = sage_state_dict_from_flax(_np_tree(new_params))
    np.testing.assert_allclose(float(ours[0]["own_loss"] + ours[1]["own_loss"]) / 2, float(loss),
                               rtol=1e-5)
    for o in ours:
        np.testing.assert_allclose(float(o["loss"]), float(loss), rtol=1e-5)
        for key, v in want.items():
            np.testing.assert_allclose(o[f"sage.{key}"], v.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=key)
            np.testing.assert_array_equal(o[f"sage.{key}"], ours[0][f"sage.{key}"])
    for key, v in sd.items():
        mean = (ours[0][f"grad.{key}"] + ours[1][f"grad.{key}"]) / 2
        np.testing.assert_allclose(ours[0][f"sage.{key}"], v.numpy() - 0.1 * mean, rtol=1e-5,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("kind", ["sage", "gat"])
def test_halo_grads_sum_over_ranks_to_one_process_gradients(tmp_path, kind):
    """``checks.halo_grads`` on two gloo ranks (the ``lp`` relabel, GAT's
    self-loops): the gradients summed over the ranks are equal on both and
    equal one process's over a plan of one shard, at rtol 1e-3 and atol
    1e-5 of the largest entry; the global loss too (1e-5 relative)."""
    a = _data()
    gen = torch.Generator().manual_seed(3)
    if kind == "sage":
        model = HaloSAGE(D, HID, C, 2, device="cpu", generator=gen)
        heads = ()
    else:
        heads = (2, 2, 1)
        model = HaloGAT(D, GAT_HID, C, heads, device="cpu", generator=gen)
    sd = {f"p.{key}": v.numpy() for key, v in model.state_dict().items()}
    path = str(tmp_path / "inputs.npz")
    np.savez(path, src=a["src"], dst=a["dst"], n=N, x=a["x"], labels=a["labels"],
             mask=a["mask"], kind=kind, bidirect=False, heads=np.array(heads), **sd)
    out = launch.spawn(checks.halo_grads, 2, (path,), backend="gloo", device="cpu",
                       timeout=TIMEOUT)

    src, dst = torch.from_numpy(a["src"]), torch.from_numpy(a["dst"])
    if kind == "gat":
        src, dst = transforms.add_self_loops(src, dst, N)
    shard = _k1_shard(src.numpy(), dst.numpy())
    nps = shard.nodes_per_shard
    x, y, mask = torch.zeros(nps, D), torch.zeros(nps, dtype=torch.int64), torch.zeros(nps)
    x[:N], y[:N] = torch.from_numpy(a["x"]), torch.from_numpy(a["labels"])
    mask[:N] = torch.from_numpy(a["mask"]).float()
    ce = torch.nn.functional.cross_entropy(model(shard, x), y, reduction="none")
    loss = (ce * mask).sum() / mask.sum()
    loss.backward()
    np.testing.assert_allclose(float(out[0]["loss"]), float(loss.detach()), rtol=1e-5)
    for name, p in model.named_parameters():
        want = p.grad.numpy()
        np.testing.assert_array_equal(out[1][f"grad.{name}"], out[0][f"grad.{name}"])
        np.testing.assert_allclose(out[0][f"grad.{name}"], want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
    assert all(int(o["send_adjoint"]) == 0 for o in out)  # CPU tensors launch no kernel


def test_exchange_times_reports_each_width(tmp_path):
    a = _data()
    path = str(tmp_path / "inputs.npz")
    np.savez(path, src=a["src"], dst=a["dst"], n=N, widths=np.array([D, 3]), reps=2)
    out = launch.spawn(checks.exchange_times, 2, (path,), backend="gloo", device="cpu",
                       timeout=TIMEOUT)
    for o in out:
        assert float(o[f"ms_d{D}"]) > 0 and float(o["ms_d3"]) > 0
        assert int(o[f"bytes_d{D}"]) == 4 * D * int(o["bytes_d3"]) // 12
    assert int(out[0]["bytes_d3"]) == int(out[1]["bytes_d3"])


def test_a_failing_rank_is_raised_and_the_others_are_killed():
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed, match="rank 1 fails on purpose"):
        launch.spawn(checks.fail_on, 3, (1,), backend="gloo", device="cpu", timeout=60)
    assert time.monotonic() - t0 < 45


def test_ranks_past_the_time_limit_are_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.spawn(checks.sleep_for, 2, (300.0,), backend="gloo", device="cpu", timeout=8)
    assert time.monotonic() - t0 < 40


def test_nccl_with_more_ranks_than_cards_raises_before_any_process():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="one rank on each card"):
        launch.spawn(checks.sleep_for, cards + 1, (0.0,), backend="nccl", device="cuda",
                     timeout=10)
    with pytest.raises(ValueError, match="runs on CUDA devices"):
        launch.spawn(checks.sleep_for, 1, (0.0,), backend="nccl", device="cpu", timeout=10)
    with pytest.raises(ValueError, match="unknown backend"):
        launch.spawn(checks.sleep_for, 1, (0.0,), backend="mpi", device="cpu", timeout=10)
