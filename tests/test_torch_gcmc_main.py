"""The port's GCMC driver on the CPU: five clip-then-Adam steps against the
JAX driver's optax chain (``optax.clip_by_global_norm`` then Adam under
``inject_hyperparams``) on the same weights and data with dropout 0, an lr
decay that keeps Adam's moments against the same decay of the optax
state, the train RMSE column, and a short run of the driver on a
MovieLens fixture (``u.data`` under the data root, as
``tests/test_loaders.py`` writes it): the reference's lines, both CSV
files, and spies on the kernels' wrappers seeing the launches that
``chip_smoke.gcmc_per_iter`` derives from the code.

Tolerances: losses within 1e-4 relative; parameters after the steps within
1e-4 relative and 1e-5 absolute; the train RMSE within 1e-6 of the RMSE
recomputed from the same logits.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dgl_tpu.data.movielens import load_movielens as jax_load_movielens
from dgl_tpu.models import GCMCNet as FlaxGCMCNet

from dgl_tpu_torch.benchmarks.common import softmax_ce_int
from dgl_tpu_torch.benchmarks.link_prediction import gcmc
from dgl_tpu_torch.convert import gcmc_state_dict_from_flax
from dgl_tpu_torch.data.movielens import load_movielens
from dgl_tpu_torch.kernels import csr_spmm as k1_mod
from dgl_tpu_torch.kernels import row_gather as p1_mod
from dgl_tpu_torch.kernels import seg_sum as k2_mod
from dgl_tpu_torch.models import GCMCNet

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

MSG, OUT = 20, 6  # narrow widths: 4 units a rating over the fixture's 5 ratings


@pytest.fixture
def movielens(tmp_path, monkeypatch):
    """A small ml-100k ``u.data`` (40 users, 30 movies, 600 ratings 1..5,
    a popular movie) under a data root of its own."""
    monkeypatch.setenv("DGL_TPU_DATA_DIR", str(tmp_path))
    root = tmp_path / "ml-100k"
    root.mkdir()
    rng = np.random.default_rng(0)
    users = rng.integers(0, 40, 600)
    movies = (rng.zipf(1.5, 600) - 1) % 30
    ratings = rng.integers(1, 6, 600)
    users[:40], movies[:30] = np.arange(40), np.arange(30)  # every id is seen
    with open(root / "u.data", "w") as f:
        for u, m, r in zip(users, movies, ratings):
            f.write(f"{u + 1}\t{m + 1}\t{r}\t884182806\n")
    return str(tmp_path)


def _setup(clip):
    jd = jax_load_movielens("ml-100k", seed=0)
    td = load_movielens("ml-100k", seed=0, device="cpu")
    rv = [str(r) for r in td.rating_vals]
    net = FlaxGCMCNet(rating_vals=rv, msg_units=MSG, out_units=OUT, dropout_rate=0.0)
    enc, dec, y = jd.train
    params = net.init(jax.random.PRNGKey(0), enc, dec, jd.user_feat, jd.movie_feat,
                      jd.norms)["params"]
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.inject_hyperparams(optax.adam)(learning_rate=0.01))
    mask = jnp.asarray(dec.edge_mask())

    @jax.jit
    def jax_step(params, opt):
        def loss_fn(p):
            logits = net.apply({"params": p}, enc, dec, jd.user_feat, jd.movie_feat, jd.norms)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y))
            return jnp.sum(ce * mask) / jnp.maximum(mask.sum(), 1.0)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        norm = optax.global_norm(grads)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss, norm

    model = GCMCNet(rv, td.user_feat.shape[1], td.movie_feat.shape[1], msg_units=MSG,
                    out_units=OUT, dropout_rate=0.0, device="cpu")
    model.load_state_dict(gcmc_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    opt = torch.optim.Adam(model.parameters(), lr=0.01)
    feats = (torch.from_numpy(td.user_feat), torch.from_numpy(td.movie_feat), td.norms)
    labels = torch.from_numpy(td.train[2])
    rating_arr = torch.tensor(td.rating_vals, dtype=torch.float32)
    step = gcmc.make_train_step(model, opt, clip, td.train[:2], feats, labels, rating_arr,
                                torch.Generator().manual_seed(0))
    return (jax_step, params, tx.init(params)), (step, model, opt), (td, feats, labels, rating_arr)


def _run_both(jax_side, port_side, n, decay_at=None):
    jax_step, params, state = jax_side
    step, model, opt = port_side
    out = []
    for i in range(n):
        if i == decay_at:  # the JAX driver's decay: the lr in the optax state
            state[1].hyperparams["learning_rate"] = jnp.asarray(0.005, jnp.float32)
            for group in opt.param_groups:  # the port's: Adam's state is left as it is
                group["lr"] = 0.005
        params, state, lj, norm = jax_step(params, state)
        lt, _ = step()
        out.append((float(lj), float(lt), float(norm)))
    return params, out


def _assert_params_match(model, params):
    want = gcmc_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_five_clipped_adam_steps_match_the_optax_chain(movielens):
    """clip 0.005, below every step's gradient norm, so every step clips."""
    jax_side, port_side, _ = _setup(clip=0.005)
    params, out = _run_both(jax_side, port_side, 5)
    for lj, lt, norm in out:
        assert norm > 0.005
        np.testing.assert_allclose(lt, lj, rtol=1e-4)
    _assert_params_match(port_side[1], params)


def test_an_lr_decay_keeps_adams_moments(movielens):
    """Three steps, the decay to 0.005, two more: losses and parameters stay
    on the optax chain's, whose decay sets the lr in its state and keeps its
    moments; the port's optimiser keeps its state, whose step count runs on."""
    jax_side, port_side, _ = _setup(clip=1.0)
    _, model, opt = port_side
    params, out = _run_both(jax_side, port_side, 5, decay_at=3)
    for lj, lt, _ in out:
        np.testing.assert_allclose(lt, lj, rtol=1e-4)
    _assert_params_match(model, params)
    assert all(group["lr"] == 0.005 for group in opt.param_groups)
    assert all(int(opt.state[p]["step"]) == 5 for p in model.parameters())


def test_the_train_rmse_column_is_the_expected_rating_rmse_of_the_steps_logits(movielens):
    _, (step, model, _), (td, feats, labels, rating_arr) = _setup(clip=1.0)
    with torch.no_grad():  # dropout 0: the step's own logits are these
        model.train()
        logits = model(*td.train[:2], *feats)
    loss, rmse = step()
    want = gcmc.expected_rmse(logits, labels, rating_arr)
    assert rmse.item() > 0
    np.testing.assert_allclose(rmse.item(), want.item(), atol=1e-6)
    np.testing.assert_allclose(loss.item(), softmax_ce_int(logits, labels).mean().item(), atol=1e-6)


@pytest.fixture
def counts(monkeypatch):
    """Every call of each kernel wrapper's plain version (which CPU tensors
    take)."""
    log = {"csr_spmm": 0, "seg_sum": 0, "row_gather_by_source": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            log[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(k1_mod, "csr_spmm_plain", spy("csr_spmm", k1_mod.csr_spmm_plain))
    monkeypatch.setattr(k2_mod, "seg_sum_plain", spy("seg_sum", k2_mod.seg_sum_plain))
    monkeypatch.setattr(p1_mod, "row_gather_by_source_plain",
                        spy("row_gather_by_source", p1_mod.row_gather_by_source_plain))
    return log


def test_the_driver_prints_the_reference_lines_writes_both_csvs_and_launches_as_derived(
        movielens, tmp_path, counts, capsys):
    save = tmp_path / "logs"
    r = gcmc.main(["--device", "cpu", "--train_max_iter", "12", "--train_valid_interval", "3",
                   "--gcn_agg_units", str(MSG), "--gcn_out_units", str(OUT), "--seed", "0",
                   "--save_dir", str(save), "--profile", "2"])
    out = capsys.readouterr().out
    assert "Training time/iter" in out and "Best valid RMSE:" in out and "Test RMSE:" in out
    assert r["iters"] == 12 and r["evals"]["valid"] == 4 and 1 <= r["evals"]["test"] <= 4
    assert all(np.isfinite(r["losses"])) and r["profile"]["iters"] == 2
    with open(save / "train_metrics.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == "iter,loss,rmse" and len(rows) == 13
    rmse = [float(ln.split(",")[2]) for ln in rows[1:]]
    assert all(v > 0 for v in rmse) and np.allclose(rmse, r["train_rmse"])
    with open(save / "valid_metrics.csv") as f:
        assert f.read().splitlines()[0] == "iter,rmse"
    data = load_movielens("ml-100k", seed=0, device="cpu")
    per = {"iter": chip_smoke.gcmc_per_iter(*data.train[:2])[0],
           "valid": chip_smoke.gcmc_per_iter(*data.valid[:2], train=False)[0],
           "test": chip_smoke.gcmc_per_iter(*data.test[:2], train=False)[0]}
    times = {"iter": r["iters"] + 2, **r["evals"]}
    assert counts == {k: sum(times[s] * per[s][k] for s in per) for k in counts}
    assert per["iter"] == {"csr_spmm": 22, "seg_sum": 2, "row_gather_by_source": 4}
