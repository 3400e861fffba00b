"""Port parity for P1 and P2, the row gather ``out[i] = x[idx[i]]``.

``row_gather_async`` (P1 in index order), ``row_gather_by_source`` (P1 in
source order, through ``gather_plan``) and ``row_gather_smem`` (on CPU
tensors, their plain versions) against the JAX probe's ``dma_gather`` and
``vmem_gather``, loaded by file path from ``tools/exp_dma_gather.py`` and
run with ``interpret=True`` as ``tests/test_kernels.py`` runs the package's
kernels: the same seeded numpy inputs in float32 and bfloat16, a ragged e
(the JAX side padded to its tile and cut back), bit for bit, since a gather
rounds nothing. Then P2's shared-memory size rule, the wrappers' checks, and
the port's probe, ``python -m dgl_tpu_torch.tools.exp_dma_gather --device
cpu``. ``gather_plan`` itself is tested in ``test_torch_gather_plan.py``.
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgl_tpu_torch.kernels.row_gather import (
    SMEM_LIMIT_BYTES,
    gather_plan,
    row_gather_async,
    row_gather_by_source,
    row_gather_by_source_plain,
    row_gather_plain,
    row_gather_smem,
)
from dgl_tpu_torch.tools import exp_dma_gather

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, E, TILE = 300, 128, 500, 128  # the JAX side stays small: interpret mode


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "exp_dma_gather_jax", os.path.join(ROOT, "tools", "exp_dma_gather.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _by_source(x, idx, tile):
    """P1 in source order through the plan of idx (``tile`` has no part)."""
    del tile
    plan = gather_plan(idx, x.shape[0])
    got = row_gather_by_source(x, *plan)
    assert torch.equal(got, row_gather_by_source_plain(x, plan.indptr, plan.pos))
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["async", "by_source", "smem"])
def test_port_matches_the_jax_probe_kernel(kernel, dtype, jax_probe):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    idx = rng.integers(0, N, E).astype(np.int32)
    idx[:3] = [0, N - 1, N - 1]
    e_pad = -(-E // TILE) * TILE
    jax_fn = jax_probe.vmem_gather if kernel == "smem" else jax_probe.dma_gather
    want = jax_fn(jnp.asarray(x).astype(dtype),
                  jnp.asarray(np.concatenate([idx, np.zeros(e_pad - E, np.int32)])),
                  tile=TILE, interpret=True)
    want = np.asarray(want.astype(jnp.float32))[:E]

    port, counter = {"async": (row_gather_async, row_gather_async),
                     "by_source": (_by_source, row_gather_by_source),
                     "smem": (row_gather_smem, row_gather_smem)}[kernel]
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    for it in (torch.from_numpy(idx), torch.from_numpy(idx).long()):
        before = counter.launches
        got = port(xt, it, tile=TILE)
        assert counter.launches == before  # CPU tensors take the plain version
        assert got.dtype == xt.dtype and got.shape == (E, D)
        np.testing.assert_array_equal(got.float().numpy(), want)  # bfloat16 → float32 is exact


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smem_refuses_x_above_its_limit_on_cpu_too(dtype):
    rows_at_limit = SMEM_LIMIT_BYTES // (256 * torch.finfo(dtype).bits // 8)
    x = torch.arange(rows_at_limit * 256, dtype=torch.float32).reshape(-1, 256).to(dtype)
    assert x.numel() * x.element_size() == SMEM_LIMIT_BYTES
    idx = torch.tensor([0, rows_at_limit - 1, 3], dtype=torch.int32)
    assert torch.equal(row_gather_smem(x, idx), x[idx])
    big = torch.zeros(rows_at_limit + 1, 256, dtype=dtype)
    need = big.numel() * big.element_size()
    before = row_gather_smem.launches
    with pytest.raises(ValueError, match=f"x holds {need} B, the limit is {SMEM_LIMIT_BYTES} B"):
        row_gather_smem(big, idx)
    assert row_gather_smem.launches == before
    assert torch.equal(row_gather_async(big, idx), big[idx])  # P1 has no such limit


@pytest.mark.parametrize("fn", [row_gather_async, row_gather_smem])
def test_wrappers_check_inputs(fn):
    x, idx = torch.ones(4, 3), torch.tensor([0, 3])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(x.double(), idx)
    with pytest.raises(TypeError, match="int32/int64"):
        fn(x, idx.float())
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.ones(4), idx)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.ones(3, 4).t(), idx)
    with pytest.raises(ValueError, match="tile"):
        fn(x, idx, tile=0)
    assert fn(x, idx[:0]).shape == (0, 3)
    with pytest.raises(IndexError):  # the plain version checks its indices; the kernels do not
        fn(x, torch.tensor([4]))


def test_async_tile_is_bounded_by_its_offsets_in_shared_memory():
    x, idx = torch.ones(4, 3), torch.tensor([0, 3])
    assert torch.equal(row_gather_async(x, idx, tile=8192), x[idx])
    with pytest.raises(ValueError, match="tile <= 8192"):
        row_gather_async(x, idx, tile=8193)


@pytest.mark.parametrize("dtype,n,refused", [("float32", 4000, True), ("bfloat16", 4000, False),
                                             ("float32", 300, False)])
def test_probe_prints_every_line(dtype, n, refused, capsys):
    lines = exp_dma_gather.main(["--device", "cpu", "--n", str(n), "--d", "16", "--e", "1000",
                                 "--dtype", dtype])
    out = capsys.readouterr().out.splitlines()
    row = 16 * (4 if dtype == "float32" else 2)
    assert out[0] == f"n={n} d=16 e=1024 dtype={dtype} row={row}B device=cpu"
    assert [(ln["name"], ln["tile"]) for ln in lines] == [
        ("index_select", None), ("split4", None), ("row_gather_async", 128),
        ("row_gather_async", 256), ("row_gather_smem", 512), ("row_gather_smem", 2048),
        ("row_gather_by_source", None), ("gather_plan", None)]
    assert len(out) == 9
    assert out[7].startswith("async gather by source: ") and " M rows/s  maxerr=" in out[7]
    assert out[8].startswith("by-source plan build:  ") and " ms " in out[8]
    checked = out[1:5] + out[7:] if refused else out[1:]
    assert all(ln.endswith("maxerr=0.0e+00") for ln in checked), out
    assert all(ln["maxerr"] == 0.0 for ln in lines if "maxerr" in ln)
    if refused:  # P2's own ValueError, raised before any launch, and nothing else
        assert all(ln.startswith(f"smem gather tile={t}: FAILED ValueError: ")
                   for ln, t in zip(out[5:7], (512, 2048))), out
        assert all(ln["failed"].startswith("ValueError") for ln in lines[4:6])


def test_probe_inputs_follow_the_jax_tool():
    """Seed 0, x drawn first, indices padded with 0 to a multiple of 512."""
    x, idx = exp_dma_gather.make_inputs(50, 4, 700, torch.bfloat16, torch.device("cpu"))
    rng = np.random.default_rng(0)
    want_x = jnp.asarray(rng.standard_normal((50, 4)).astype(np.float32)).astype(jnp.bfloat16)
    want_idx = rng.integers(0, 50, 700)
    np.testing.assert_array_equal(x.float().numpy(), np.asarray(want_x.astype(jnp.float32)))
    assert idx.dtype == torch.int32 and idx.shape == (1024,)
    np.testing.assert_array_equal(idx[:700].numpy(), want_idx)
    assert not idx[700:].any()
    assert torch.equal(row_gather_plain(x, idx), x[idx.long()])


def test_importing_the_probe_runs_nothing(capsys):
    importlib.reload(exp_dma_gather)
    assert capsys.readouterr().out == ""


def _plan_case(e=900, n=50, seed=1):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, n // 2, e).astype(np.int32))  # upper rows unread
    return torch.from_numpy(rng.standard_normal((n, 6)).astype(np.float32)), idx


def test_by_source_checks_inputs():
    x, idx = _plan_case()
    ip, pos, split = gather_plan(idx, x.shape[0], t=7)
    with pytest.raises(ValueError, match="2-D"):
        row_gather_by_source(x.reshape(-1), ip, pos, split)
    with pytest.raises(TypeError, match="even byte size"):
        row_gather_by_source(x.to(torch.uint8), ip, pos, split)
    with pytest.raises(TypeError, match="indptr must be 1-D int32/int64"):
        row_gather_by_source(x, ip.float(), pos, split)
    with pytest.raises(ValueError, match="51 offsets for 49 rows"):
        row_gather_by_source(x[:-1], ip, pos, split)
    with pytest.raises(TypeError, match="pos must be 1-D int32/int64"):
        row_gather_by_source(x, ip, pos.float(), split)
    with pytest.raises(ValueError, match="contiguous"):
        row_gather_by_source(torch.ones(6, 50).t(), ip, pos, split)
    with pytest.raises(ValueError, match="disagree on the number of slots"):
        row_gather_by_source(x, ip, pos[:-1], split)
    with pytest.raises(ValueError, match="disagree on the number of slots"):
        row_gather_by_source(x, ip, pos, split, num_out=3)
    with pytest.raises(ValueError, match="never reads indptr back"):
        row_gather_by_source(x, ip)
    with pytest.raises(ValueError, match="row split"):  # the split of one row fewer
        row_gather_by_source(x, ip, pos, gather_plan(idx, x.shape[0] - 1).split)
    with pytest.raises(ValueError, match="indptr holds 900 slots, not 899"):
        row_gather_by_source(x, ip, None, num_out=899)
    before = row_gather_by_source.launches
    assert torch.equal(row_gather_by_source(x, ip, pos, split), x[idx.long()])
    assert torch.equal(row_gather_by_source(x, ip, pos, None), x[idx.long()])  # no split
    assert row_gather_by_source.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64,
                                   torch.int64])
def test_by_source_without_positions_repeats_each_row_in_slot_order(dtype):
    """pos=None: a dst CSR's v[dst[j]], output rows in slot order."""
    x, idx = _plan_case()
    x = (x * 10).to(dtype)
    ip, pos, split = gather_plan(idx, x.shape[0], t=7)
    want = x.repeat_interleave(ip.diff().long(), dim=0)
    assert torch.equal(row_gather_by_source(x, ip, None, split), want)
    assert torch.equal(row_gather_by_source(x, ip, num_out=idx.numel()), want)
    assert torch.equal(row_gather_by_source_plain(x, ip), want)
    assert torch.equal(row_gather_by_source(x, ip, pos, split), x[idx.long()])
    empty = torch.zeros(x.shape[0] + 1, dtype=torch.int64)
    assert row_gather_by_source(x, empty, num_out=0).shape == (0, 6)
    assert row_gather_by_source(x[:, :0], ip, pos, split).shape == (idx.numel(), 0)
