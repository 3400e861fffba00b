"""K1 (csr_spmm): the plain version against a numpy oracle, the wrapper's
checks, and, on a CUDA card, K1, K2 (seg_sum) and both K3 passes
(gat_attention_fwd / _bwd) against their plain versions.

This file imports no JAX, so the card's tests can run where JAX is absent:
    python -m pytest --noconftest tests/test_torch_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain
from dgl_tpu_torch.kernels.gat_attention import (
    gat_attention_bwd,
    gat_attention_bwd_plain,
    gat_attention_fwd,
    gat_attention_fwd_plain,
)
from dgl_tpu_torch.kernels.seg_sum import seg_sum, seg_sum_plain


def _csr(rng, n_rows, n_src, e):
    """Random CSR whose last quarter of rows is empty, plus one hub row."""
    rows = np.concatenate([rng.integers(0, 3 * n_rows // 4, e), np.full(e, 2)])
    cols = rng.integers(0, n_src, 2 * e)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return indptr, cols[order].astype(np.int32), rows[order]


def _oracle(indptr, indices, rows, x, w, mean):
    out = np.zeros((len(indptr) - 1, x.shape[1]))
    np.add.at(out, rows, x[indices].astype(np.float64) * (1.0 if w is None else w[:, None]))
    if mean:
        out /= np.maximum(np.diff(indptr), 1)[:, None]
    return out


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("d", [1, 16, 41])
def test_plain_matches_numpy_oracle(d, weighted, mean):
    rng = np.random.default_rng(d)
    indptr, indices, rows = _csr(rng, 120, 90, 800)
    x = rng.standard_normal((90, d)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, len(indices)).astype(np.float32) if weighted else None
    for ip in (torch.from_numpy(indptr), torch.from_numpy(indptr.astype(np.int32))):
        got = csr_spmm(ip, torch.from_numpy(indices), torch.from_numpy(x),
                       None if w is None else torch.from_numpy(w), mean=mean)
        np.testing.assert_allclose(got.numpy(), _oracle(indptr, indices, rows, x, w, mean),
                                   rtol=1e-5, atol=1e-5)
        assert not got[90:].any()


def test_wrapper_checks_inputs():
    ip = torch.tensor([0, 1, 2])
    idx = torch.tensor([0, 1], dtype=torch.int32)
    x = torch.ones(2, 3)
    with pytest.raises(TypeError, match="float32"):
        csr_spmm(ip, idx, x.double())
    with pytest.raises(TypeError, match="int32"):
        csr_spmm(ip, idx.long(), x)
    with pytest.raises(ValueError, match="w must be"):
        csr_spmm(ip, idx, x, torch.ones(3))
    with pytest.raises(ValueError, match="contiguous"):
        csr_spmm(ip, idx, torch.ones(3, 2).t())


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """Every source includes csrc/lanes.cuh: changing the header renames,
    and so rebuilds, every library."""
    from dgl_tpu_torch.kernels import build

    with open(build.HEADERS[0]) as f:
        text = f.read()
    assert all('#include "lanes.cuh"' in open(src).read() for src in build.SOURCES.values())
    before = {name: build._lib_path(name) for name in build.SOURCES}
    changed = tmp_path / "lanes.cuh"
    changed.write_text(text + "\n// changed\n")
    monkeypatch.setattr(build, "HEADERS", [str(changed)])
    after = {name: build._lib_path(name) for name in build.SOURCES}
    assert all(before[name] != after[name] for name in build.SOURCES)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    indptr, indices, _ = _csr(rng, 3000, 2000, 50_000)
    dev = torch.device("cuda")
    ip, idx = torch.from_numpy(indptr).to(dev), torch.from_numpy(indices).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, len(indices)).astype(np.float32)).to(dev)
    for d in (1, 16, 41, 602):
        x = torch.from_numpy(rng.normal(1.0, 1.0, (2000, d)).astype(np.float32)).to(dev)
        for mean in (False, True):
            for ww in (None, w):
                before = csr_spmm.launches
                got = csr_spmm(ip, idx, x, ww, mean=mean)
                assert csr_spmm.launches == before + 1
                torch.testing.assert_close(got, csr_spmm_plain(ip, idx, x, ww, mean=mean),
                                           rtol=1e-4, atol=1e-4)
                assert torch.equal(got, csr_spmm(ip, idx, x, ww, mean=mean))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_seg_sum_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(1)
    indptr, _, _ = _csr(rng, 3000, 2000, 50_000)
    ip = torch.from_numpy(indptr).to(dev)
    for w in (1, 3, 16, 64):
        msg = torch.from_numpy(rng.normal(1.0, 1.0, (int(indptr[-1]), w)).astype(np.float32)).to(dev)
        before = seg_sum.launches
        got = seg_sum(ip, msg)
        assert seg_sum.launches == before + 1
        torch.testing.assert_close(got, seg_sum_plain(ip, msg), rtol=1e-4, atol=1e-3)
        assert torch.equal(got, seg_sum(ip, msg))
        ints = torch.randint(-4, 5, msg.shape, device=dev).float()  # exact in any order
        assert torch.equal(seg_sum(ip.int(), ints), seg_sum_plain(ip, ints.double()).float())


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.82])
@pytest.mark.parametrize("heads,d", [(1, 16), (4, 41), (8, 8)])
def test_gat_attention_passes_match_plain_on_card(heads, d, keep):
    dev = _card()
    rng = np.random.default_rng(heads * d)
    n, e = 2000, 30_000
    src = torch.from_numpy(rng.integers(0, n, e)).to(dev)
    dst = torch.from_numpy(rng.integers(0, 3 * n // 4, e)).to(dev)
    from dgl_tpu_torch import from_edges

    g = from_edges(src.cpu().numpy(), dst.cpu().numpy(), n, device=dev)
    rev = g.reverse
    v, g_out = (torch.randn(n, heads, d, device=dev) for _ in range(2))
    a_s, a_d = (torch.randn(n, heads, device=dev) for _ in range(2))
    kw = dict(negative_slope=0.2, keep=keep, seed=torch.tensor([77], dtype=torch.int32, device=dev))
    before = gat_attention_fwd.launches
    fwd = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, **kw)
    assert gat_attention_fwd.launches == before + 1
    for got, want in zip(fwd, gat_attention_fwd_plain(g.indptr, g.src, v, a_s, a_d, **kw)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    node = torch.stack([a_d, fwd[4], fwd[2], (g_out * fwd[0]).sum(-1)], -1)
    args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s)
    bwd = gat_attention_bwd(*args, **kw)
    for got, want in zip(bwd, gat_attention_bwd_plain(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(bwd, gat_attention_bwd(*args, **kw)))
