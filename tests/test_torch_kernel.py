"""K1 (csr_spmm): the plain version against a numpy oracle, the wrapper's
checks, and, on a CUDA card, K1, K2 (seg_sum), both K3 passes
(gat_attention_fwd / _bwd) and P1 in both orders and P2
(row_gather_async / _by_source / _smem) against their plain versions; K1, K2 and both K3 passes also on a CSR whose rows
straddle the row split (graph/split.py), against the plain version and
exact sums, and in their bfloat16 instantiations; K1 at odd widths, on x
bases 4 and 8 bytes off 16-byte alignment whose storage ends with x, and
on CSRs made only of long rows and of none (the combine folded into the
launch, the plan's counters back at 0); both K3 passes at heads that are
not a power of two, odd and wide rows and misaligned bases; K3's node
passes (gat_scores, gat_score_grad, gat_vector_grad) against their plain
versions and a fused GAT step on the card against the CPU, with its
launches counted and two runs bitwise equal.

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
from dgl_tpu_torch.kernels.row_gather import (
    SMEM_LIMIT_BYTES,
    gather_plan,
    row_gather_async,
    row_gather_by_source,
    row_gather_by_source_plain,
    row_gather_plain,
    row_gather_smem,
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


def _split_csr(rng, n_src):
    """A CSR whose rows straddle the split T (rows of T - 1 to 2T + 1 edges),
    with short, empty and one 10^5-edge row, and its row split."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split

    t = SPLIT_T
    degrees = np.concatenate([[0, t - 1, t, t + 1, 2 * t, 2 * t + 1, 100_000],
                              rng.integers(0, 3 * t, 400), rng.integers(0, 20, 2000)])
    indptr = np.zeros(len(degrees) + 1, np.int64)
    np.cumsum(degrees, out=indptr[1:])
    idx = rng.integers(0, n_src, int(indptr[-1])).astype(np.int32)
    return indptr, idx, row_split(indptr)


@pytest.mark.cuda
def test_split_k1_matches_plain_and_exact_sums_on_card():
    dev = _card()
    rng = np.random.default_rng(6)
    indptr, indices, plan = _split_csr(rng, 2000)
    plan = plan.to(dev)
    idx = torch.from_numpy(indices).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, len(indices)).astype(np.float32)).to(dev)
    short = torch.from_numpy(np.diff(indptr) <= 1000).to(dev)
    for ip in (torch.from_numpy(indptr).to(dev), torch.from_numpy(indptr).int().to(dev)):
        for d in (1, 16, 41, 602):
            x = torch.from_numpy(rng.normal(1.0, 1.0, (2000, d)).astype(np.float32)).to(dev)
            for mean in (False, True):
                for ww in (None, w):
                    before = csr_spmm.launches
                    got = csr_spmm(ip, idx, x, ww, mean=mean, split=plan)
                    # one launch: the long rows' combine is folded into it
                    assert csr_spmm.launches == before + 1
                    assert not plan.counters.any()
                    want = csr_spmm_plain(ip, idx, x, ww, mean=mean)
                    torch.testing.assert_close(got[short], want[short], rtol=1e-4, atol=1e-4)
                    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-2)
                    assert torch.equal(got, csr_spmm(ip, idx, x, ww, mean=mean, split=plan))
            ints = torch.from_numpy(rng.integers(-4, 5, (2000, d)).astype(np.float32)).to(dev)
            exact = csr_spmm_plain(ip, idx, ints.double()).float()  # exact in any order
            assert torch.equal(csr_spmm(ip, idx, ints, split=plan), exact)


def _x_view(rng, n, d, dtype, shift_bytes, dev, kind="normal"):
    """(n, d) rows at ``shift_bytes`` past a 16-byte-aligned allocation that
    ends where x ends: a span rounded out to 16 bytes at x's first or last
    row would leave the storage."""
    elem = torch.empty((), dtype=dtype).element_size()
    shift = shift_bytes // elem
    a = (rng.normal(1.0, 1.0, n * d) if kind == "normal"
         else rng.integers(-4, 5, n * d)).astype(np.float32)
    flat = torch.empty(shift + n * d, dtype=dtype, device=dev)
    flat[shift:] = torch.from_numpy(a).to(dev).to(dtype)
    x = flat[shift:].view(n, d)
    assert x.data_ptr() % 16 == shift_bytes and x.untyped_storage().nbytes() == flat.numel() * elem
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_odd_widths_and_misaligned_bases_on_card(dtype):
    """D in {1, 3, 40, 41, 47, 100, 602}, x at 0, 4 and 8 bytes off 16-byte
    alignment (bfloat16 also 2), its first and last rows gathered often, on
    a CSR with long rows: the plain version, small integers bit for bit,
    two runs bitwise equal, sum, mean and weighted."""
    dev = _card()
    rng = np.random.default_rng(11)
    n_src = 500
    indptr, idx, plan = _split_csr(rng, n_src)
    ends = rng.random(len(idx)) < 0.2  # a fifth of the edges read row 0 or n_src - 1
    idx[ends] = rng.choice([0, n_src - 1], int(ends.sum())).astype(np.int32)
    ip, ix, plan = torch.from_numpy(indptr).to(dev), torch.from_numpy(idx).to(dev), plan.to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, len(idx)).astype(np.float32)).to(dev)
    wi = torch.from_numpy(rng.integers(1, 4, len(idx)).astype(np.float32)).to(dev)
    short = torch.from_numpy(np.diff(indptr) <= 1000).to(dev)
    shifts = (0, 4, 8) if dtype == torch.float32 else (0, 2, 4, 8)
    for d in (1, 3, 40, 41, 47, 100, 602):
        for shift in shifts:
            x = _x_view(rng, n_src, d, dtype, shift, dev)
            xi = _x_view(rng, n_src, d, dtype, shift, dev, kind="integer")
            for mean, ww, wwi in ((False, None, None), (True, None, None), (False, w, wi)):
                got = csr_spmm(ip, ix, x, ww, mean=mean, split=plan)
                want = csr_spmm_plain(ip, ix, x, ww, mean=mean)
                torch.testing.assert_close(got[short], want[short], rtol=1e-4, atol=1e-4)
                torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-2)
                assert torch.equal(got, csr_spmm(ip, ix, x, ww, mean=mean, split=plan))
                if not mean:
                    exact = csr_spmm_plain(ip, ix, xi.double(), wwi).float()
                    assert torch.equal(csr_spmm(ip.int(), ix, xi, wwi, split=plan), exact)
    assert not plan.counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all_long", "all_long_pairs", "no_long"])
def test_k1_fold_on_all_long_and_no_long_csrs_on_card(case):
    """A CSR of long rows only (every row folded in the launch by the chunk
    warp that completes its count) and one of none, D in {1, 16, 47, 100},
    float32 and bfloat16; ``all_long_pairs`` cuts the plan at t = 2, so it
    has more than 2048 chunks and each chunk warp walks two
    (``k1_geometry.h``): exact integer sums, the plain version, one launch a
    call, two runs bitwise equal and the counters back at 0."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split

    dev = _card()
    rng = np.random.default_rng(12)
    t = SPLIT_T
    degrees = ([t + 1 + 97 * i for i in range(30)] if case != "no_long"
               else [t] * 5 + rng.integers(0, t + 1, 2000).tolist())
    indptr = np.zeros(len(degrees) + 1, np.int64)
    np.cumsum(degrees, out=indptr[1:])
    idx = torch.from_numpy(rng.integers(0, 3000, int(indptr[-1])).astype(np.int32)).to(dev)
    ip = torch.from_numpy(indptr).to(dev)
    plan = row_split(ip, t=2 if case == "all_long_pairs" else t)
    assert plan.num_long == (0 if case == "no_long" else len(degrees))
    assert (plan.num_chunks > 2048) == (case == "all_long_pairs")
    for dtype in (torch.float32, torch.bfloat16):
        for d in (1, 16, 47, 100):
            x = torch.from_numpy(rng.normal(1.0, 1.0, (3000, d)).astype(np.float32)).to(dev)
            xi = torch.randint(-4, 5, (3000, d), device=dev).float()
            x, xi = x.to(dtype), xi.to(dtype)
            for mean in (False, True):
                before = csr_spmm.launches
                got = csr_spmm(ip, idx, x, mean=mean, split=plan)
                assert csr_spmm.launches == before + 1
                torch.testing.assert_close(got, csr_spmm_plain(ip, idx, x, mean=mean),
                                           rtol=1e-3, atol=1e-2)
                assert torch.equal(got, csr_spmm(ip, idx, x, mean=mean, split=plan))
            assert torch.equal(csr_spmm(ip, idx, xi, split=plan),
                               csr_spmm_plain(ip, idx, xi.double()).float())
            assert not plan.counters.any()


@pytest.mark.cuda
def test_split_k2_matches_plain_and_exact_sums_on_card():
    dev = _card()
    rng = np.random.default_rng(7)
    indptr, _, plan = _split_csr(rng, 1)
    plan = plan.to(dev)
    e = int(indptr[-1])
    short = torch.from_numpy(np.diff(indptr) <= 1000).to(dev)
    for ip in (torch.from_numpy(indptr).to(dev), torch.from_numpy(indptr).int().to(dev)):
        for w in (1, 3, 6, 16, 41, 64, 66):  # every vector width and feature tile
            msg = torch.from_numpy(rng.normal(1.0, 1.0, (e, w)).astype(np.float32)).to(dev)
            before, combines = seg_sum.launches, seg_sum.combines
            got = seg_sum(ip, msg, split=plan)
            # one launch: the long rows fold inside it, no combine launch
            assert (seg_sum.launches, seg_sum.combines) == (before + 1, combines)
            assert not plan.counters.any()
            want = seg_sum_plain(ip, msg)
            torch.testing.assert_close(got[short], want[short], rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-1)
            assert torch.equal(got, seg_sum(ip, msg, split=plan))
            ints = torch.from_numpy(rng.integers(-4, 5, (e, w)).astype(np.float32)).to(dev)
            assert torch.equal(seg_sum(ip, ints, split=plan),
                               seg_sum_plain(ip, ints.double()).float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_folds_long_rows_in_one_launch_on_card(dtype):
    """K2 on a CSR whose rows straddle the split, one launch a call and no
    combine launch, the plan's counters back at 0: messages at a base off
    16 bytes and ending off 16 bytes (a view one row in), widths of every
    lane layout, against the plain version, integers exact, two runs equal."""
    dev = _card()
    rng = np.random.default_rng(11)
    indptr, _, plan = _split_csr(rng, 1)
    plan = plan.to(dev)
    e = int(indptr[-1])
    ip = torch.from_numpy(indptr).to(dev)
    short = torch.from_numpy(np.diff(indptr) <= 1000).to(dev)
    for w in (1, 8, 16, 75, 256, 602):
        base = torch.from_numpy(rng.normal(1.0, 1.0, (e + 1, w)).astype(np.float32)).to(dev)
        msg = base.to(dtype)[1:]
        before, combines = seg_sum.launches, seg_sum.combines
        got = seg_sum(ip, msg, split=plan)
        assert (seg_sum.launches, seg_sum.combines) == (before + 1, combines)
        assert not plan.counters.any()
        want = seg_sum_plain(ip, msg)
        torch.testing.assert_close(got[short], want[short], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-1)
        assert torch.equal(got, seg_sum(ip, msg, split=plan))
        ints = torch.from_numpy(rng.integers(-4, 5, (e + 1, w)).astype(np.float32)).to(dev)
        assert torch.equal(seg_sum(ip, ints.to(dtype)[1:], split=plan),
                           seg_sum_plain(ip, ints[1:].double()).float())


@pytest.mark.cuda
def test_p1_at_300_byte_rows_with_and_without_positions_on_card():
    """P1 at GCMC's decoder width (75 float32 values, 300 B: 16-byte words
    that cut every row), bit for bit: in source order with positions, with
    pos=None (a dst CSR's contiguous slots, long enough for bulk stores,
    with a row over T, with and without the split) and in index order; x
    at a base off 16 bytes too."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(12)
    n, d, e = 1682, 75, 85_000
    for shift in (0, 1):
        base = torch.randn(n * d + shift, device=dev, generator=gen)
        x = base[shift:].view(n, d)
        idx = torch.randint(0, n, (e,), device=dev, generator=gen)
        idx[:700] = 5  # a row over T = 512
        plan = gather_plan(idx, n)
        assert plan.split.num_long >= 1
        for ii in (idx, idx.int()):
            assert torch.equal(row_gather_async(x, ii), x[idx])
        got = row_gather_by_source(x, *plan)
        assert torch.equal(got, x[idx]) and torch.equal(got, row_gather_by_source(x, *plan))
        assert torch.equal(row_gather_by_source(x, plan.indptr, plan.pos.long(), plan.split),
                           x[idx])
        # pos=None: out[k] = x[r] over the plan's row offsets
        want = row_gather_by_source_plain(x, plan.indptr)
        for split in (plan.split, None):
            got = row_gather_by_source(x, plan.indptr, None, split, num_out=e)
            assert torch.equal(got, want), (shift, split is None)


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
    args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s, v)
    bwd = gat_attention_bwd(*args, **kw)
    assert len(bwd) == 2 and bwd[1].shape == (n, heads)  # grad_v, grad_a_src
    for got, want in zip(bwd, gat_attention_bwd_plain(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(bwd, gat_attention_bwd(*args, **kw)))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8, 16, 47, 64, 100])
def test_bf16_k1_k2_match_plain_on_card(d):
    """The bfloat16 instantiations: float32 sums of bfloat16 rows, held to
    the plain version (which widens the rows first) and, on small integers,
    to exact sums; the bfloat16 launches counted."""
    dev = _card()
    rng = np.random.default_rng(100 + d)
    indptr, idx, plan = _split_csr(rng, 3000)
    ip, ix = torch.from_numpy(indptr).to(dev), torch.from_numpy(idx).to(dev)
    plan = plan.to(dev)
    x = torch.from_numpy(rng.normal(1.0, 1.0, (3000, d)).astype(np.float32)).to(dev).bfloat16()
    msg = torch.from_numpy(rng.normal(1.0, 1.0, (len(idx), d)).astype(np.float32)).to(dev).bfloat16()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, len(idx)).astype(np.float32)).to(dev)
    short = torch.from_numpy(np.diff(indptr) <= 1000).to(dev)
    before = csr_spmm.launches_bf16, seg_sum.launches_bf16
    for ww in (None, w):
        got = csr_spmm(ip, ix, x, ww, split=plan)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got[short], csr_spmm_plain(ip, ix, x, ww)[short], rtol=1e-4,
                                   atol=1e-4)
    got = seg_sum(ip, msg, split=plan)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got[short], seg_sum_plain(ip, msg)[short], rtol=1e-4, atol=1e-4)
    ints = torch.randint(-4, 5, x.shape, device=dev).bfloat16()  # exact in any order
    assert torch.equal(csr_spmm(ip.int(), ix, ints, split=plan),
                       csr_spmm_plain(ip, ix, ints.double()).float())
    assert (csr_spmm.launches_bf16, seg_sum.launches_bf16) == (before[0] + 3, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.82])
@pytest.mark.parametrize("heads,d", [(1, 16), (4, 40), (4, 41)])
def test_bf16_gat_attention_passes_match_plain_on_card(heads, d, keep):
    """v in bfloat16: the forward's float32 outputs against the plain
    version; b2's bfloat16 grad_v equal to its float32 grad_v (on v
    widened) rounded once, and within one bfloat16 ulp of the plain
    version's; its grad_a_src equal to the float32 pass's."""
    dev = _card()
    rng = np.random.default_rng(heads * d + 7)
    n, e = 2000, 30_000
    from dgl_tpu_torch import from_edges

    g = from_edges(rng.integers(0, n, e), rng.integers(0, 3 * n // 4, e), n, device=dev)
    rev = g.reverse
    v = torch.randn(n, heads, d, device=dev).bfloat16()
    g_out = torch.randn(n, heads, d, device=dev)
    a_s, a_d = (torch.randn(n, heads, device=dev) for _ in range(2))
    kw = dict(negative_slope=0.2, keep=keep, seed=torch.tensor([78], dtype=torch.int32, device=dev))
    before = gat_attention_fwd.launches_bf16, gat_attention_bwd.launches_bf16
    fwd = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)
    for got, want in zip(fwd, gat_attention_fwd_plain(g.indptr, g.src, v, a_s, a_d, **kw)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    node = torch.stack([a_d, fwd[4], fwd[2], (g_out * fwd[0]).sum(-1)], -1)
    args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s)
    bwd = gat_attention_bwd(*args, v, split=rev.split, **kw)
    ref = gat_attention_bwd(*args, v.float(), split=rev.split, **kw)
    assert bwd[0].dtype == torch.bfloat16 and torch.equal(bwd[0], ref[0].bfloat16())
    assert torch.equal(bwd[1], ref[1])
    torch.testing.assert_close(bwd[1], gat_attention_bwd_plain(*args, v, **kw)[1], rtol=1e-4,
                               atol=1e-4)
    plain = gat_attention_bwd_plain(*args, v, **kw)[0]
    torch.testing.assert_close(bwd[0].float(), plain.float(), rtol=2.0 ** -7, atol=1e-4)
    assert (gat_attention_fwd.launches_bf16, gat_attention_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("keep", [1.0, 0.82])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("d", [16, 40])  # lane groups of 4 and 16; 40: arxiv's last layer
def test_split_k3_matches_plain_and_exact_sums_on_card(d, heads, keep):
    """Both K3 passes over one CSR whose rows straddle T (a 10^5-edge row
    among them), read as the dst CSR by the forward and as the reverse CSR
    by b2: against the float64 plain version, on exact-sum inputs (every
    logit equal; keep 1 and 0.5 scale exactly), and two runs bitwise
    equal; one launch each, no combine launch (the long rows fold in the
    launch) and the plan's counters, which both passes share, back at 0."""
    dev = _card()
    rng = np.random.default_rng(8 + heads)
    n_src = 2000
    indptr, indices, plan = _split_csr(rng, n_src)
    plan = plan.to(dev)
    n, e = len(indptr) - 1, len(indices)
    idx = torch.from_numpy(indices).to(dev)
    eid = torch.from_numpy(rng.permutation(e).astype(np.int32)).to(dev)
    short = torch.from_numpy(np.diff(indptr) <= 1000).to(dev)
    gen = torch.Generator(device=dev).manual_seed(heads)
    seed = torch.tensor([91], dtype=torch.int32, device=dev)
    v = 1.0 + torch.randn(n_src, heads, d, device=dev, generator=gen)
    a_s = torch.randn(n_src, heads, device=dev, generator=gen)
    a_d = torch.randn(n, heads, device=dev, generator=gen)
    # b2 over the same CSR read as a reverse CSR: its n rows are sources,
    # its indices the n_src destinations whose node rows it reads
    g_out = 1.0 + torch.randn(n_src, heads, d, device=dev, generator=gen)
    node = torch.stack([torch.randn(n_src, heads, device=dev, generator=gen),
                        torch.full((n_src, heads), 3.0, device=dev),
                        torch.rand(n_src, heads, device=dev, generator=gen),
                        torch.randn(n_src, heads, device=dev, generator=gen)], -1)
    a_s_rev = torch.randn(n, heads, device=dev, generator=gen)
    v_rev = 1.0 + torch.randn(n, heads, d, device=dev, generator=gen)

    def hold(got, want, what):
        for i, (x, w) in enumerate(zip(got, want)):
            w = w.float()
            torch.testing.assert_close(x[short], w[short], rtol=1e-4, atol=1e-4,
                                       msg=f"{what} output {i}, rows of at most 1000 edges")
            torch.testing.assert_close(x, w, rtol=1e-3, atol=1e-2, msg=f"{what} output {i}")

    for ip in (torch.from_numpy(indptr).to(dev), torch.from_numpy(indptr).int().to(dev)):
        kw = dict(negative_slope=0.2, keep=keep, seed=seed)
        counts = (gat_attention_fwd.launches, gat_attention_fwd.combines)
        fwd = gat_attention_fwd(ip, idx, v, a_s, a_d, split=plan, **kw)
        assert (gat_attention_fwd.launches, gat_attention_fwd.combines) == (
            counts[0] + 1, counts[1])
        assert not plan.counters.any(), "the forward's fold left a counter above 0"
        hold(fwd, gat_attention_fwd_plain(ip, idx, v.double(), a_s.double(), a_d.double(), **kw),
             "forward")
        assert all(torch.equal(a, b) for a, b in
                   zip(fwd, gat_attention_fwd(ip, idx, v, a_s, a_d, split=plan, **kw)))
        counts = (gat_attention_bwd.launches, gat_attention_bwd.combines)
        bwd = gat_attention_bwd(ip, idx, eid, g_out, node, a_s_rev, v_rev, split=plan, **kw)
        assert (gat_attention_bwd.launches, gat_attention_bwd.combines) == (
            counts[0] + 1, counts[1])
        assert not plan.counters.any(), "b2's fold left a counter above 0"
        hold(bwd, gat_attention_bwd_plain(ip, idx, eid, g_out.double(), node.double(),
                                          a_s_rev.double(), v_rev.double(), **kw), "b2")
        assert all(torch.equal(a, b) for a, b in zip(bwd, gat_attention_bwd(
            ip, idx, eid, g_out, node, a_s_rev, v_rev, split=plan, **kw)))
        # exact sums: every logit 1 (p = 1, α = 1), small integers, keep 1 or 0.5
        ints = lambda *shape: torch.randint(-4, 5, shape, device=dev, generator=gen).float()  # noqa: E731
        ones = torch.ones(n_src, heads, device=dev)
        vi, gi, vi_rev = ints(n_src, heads, d), ints(n_src, heads, d), ints(n, heads, d)
        node_i = torch.stack([torch.zeros_like(ones), ones, ones, ints(n_src, heads)], -1)
        for k in (1.0, 0.5):
            kwi = dict(negative_slope=0.2, keep=k, seed=seed)
            got = gat_attention_fwd(ip, idx, vi, ones, torch.zeros(n, heads, device=dev),
                                    split=plan, **kwi)
            want = gat_attention_fwd_plain(ip, idx, vi.double(), ones.double(),
                                           torch.zeros(n, heads, device=dev, dtype=torch.float64),
                                           **kwi)
            got += gat_attention_bwd(ip, idx, eid, gi, node_i, torch.ones(n, heads, device=dev),
                                     vi_rev, split=plan, **kwi)
            want += gat_attention_bwd_plain(ip, idx, eid, gi.double(), node_i.double(),
                                            torch.ones(n, heads, device=dev, dtype=torch.float64),
                                            vi_rev.double(), **kwi)
            for i, (x, w) in enumerate(zip(got, want)):
                assert torch.equal(x, w.float()), f"exact output {i}, keep {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4, 8])
@pytest.mark.parametrize("heads,d", [(2, 41), (8, 64), (3, 16)])
def test_k3_heads_widths_and_misaligned_bases_on_card(heads, d, shift):
    """Both K3 passes with every head in one warp: heads that are not a
    power of two, odd and wide rows (two column pieces at H = 8, D = 64),
    v and g at bases 0, 4 and 8 bytes off 16-byte alignment whose storage
    ends with the array, over a graph with a long row in each CSR: the plain
    version, two runs bitwise equal, the counters back at 0."""
    from dgl_tpu_torch import from_edges

    dev = _card()
    rng = np.random.default_rng(heads * d + shift)
    n, e = 900, 20_000
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    src[:1200], dst[1200:2400] = n - 1, 0  # a long row in the reverse CSR and in the dst CSR
    g = from_edges(src, dst, n, device=dev)
    rev = g.reverse

    def rows():  # (n, heads, d) at `shift` bytes past a 16-byte-aligned allocation
        flat = torch.randn(shift // 4 + n * heads * d, device=dev)
        return flat[shift // 4:].view(n, heads, d)

    v, g_out = rows(), rows()
    assert v.data_ptr() % 16 == shift
    a_s, a_d = (torch.randn(n, heads, device=dev) for _ in range(2))
    kw = dict(negative_slope=0.2, keep=0.82, seed=torch.tensor([5], dtype=torch.int32, device=dev))
    fwd = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)
    for got, want in zip(fwd, gat_attention_fwd_plain(g.indptr, g.src, v, a_s, a_d, **kw)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in
               zip(fwd, gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)))
    node = torch.stack([a_d, fwd[4], fwd[2], (g_out * fwd[0]).sum(-1)], -1)
    args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s, v)
    bwd = gat_attention_bwd(*args, split=rev.split, **kw)
    for got, want in zip(bwd, gat_attention_bwd_plain(*args, **kw)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(bwd, gat_attention_bwd(*args, split=rev.split, **kw)))
    assert g.split.num_long and rev.split.num_long
    assert not g.split.counters.any() and not rev.split.counters.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_matches_plain_on_card(dtype):
    """Bit for bit: 16-, 8-, 4- and 2-byte copies (41 bfloat16 values make
    an 82-byte row), 1 KB rows staged in pieces, 40 KB rows in column
    pieces, ragged e, int32 and int64 indices; P2 wherever x fits."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    for n, d, e in ((5000, 16, 100_003), (3000, 41, 7_777), (2000, 256, 10_001),
                    (300, 10_000, 1_001), (227, 256, 3_001)):
        x = torch.randn(n, d, device=dev, generator=gen).to(dtype)
        idx = torch.randint(0, n, (e,), device=dev, generator=gen)
        fits = x.numel() * x.element_size() <= SMEM_LIMIT_BYTES
        for ii in (idx, idx.int()):
            want = row_gather_plain(x, ii)
            for fn, tiles in ((row_gather_async, (1, 128, 256)), (row_gather_smem, (100, 512))):
                if fn is row_gather_smem and not fits:
                    continue
                for tile in tiles:
                    before = fn.launches
                    got = fn(x, ii, tile=tile)
                    assert fn.launches == before + 1
                    assert torch.equal(got, want), (fn.__name__, n, d, e, tile)
    big = torch.zeros(228, 256, device=dev)
    before = row_gather_smem.launches
    with pytest.raises(ValueError, match="limit"):
        row_gather_smem(big, idx[:10])
    assert row_gather_smem.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_by_source_matches_plain_on_card(dtype):
    """Bit for bit against x[idx] and the plain version, two runs equal:
    rows of 64 B, 82 B (2-byte copies), 1 KB and 40 KB (column pieces),
    int32 and int64 indices, a row of 3000 positions (split into chunks)
    beside rows of a few and rows of none, with and without the split, and
    pos=None over the plan's row offsets."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(6)
    for n, d, e in ((5000, 16, 100_003), (3000, 41, 7_777), (2000, 256, 10_001),
                    (300, 10_000, 3_001)):
        x = torch.randn(n, d, device=dev, generator=gen).to(dtype)
        idx = torch.randint(0, n // 2, (e,), device=dev, generator=gen)
        idx[: e // 4] = 3  # one row over T = 512; rows n // 2 and up are never read
        for ii in (idx, idx.int()):
            plan = gather_plan(ii, n)
            assert plan.split.num_long == 1
            for split in (plan.split, None):
                before = row_gather_by_source.launches
                got = row_gather_by_source(x, plan.indptr, plan.pos, split)
                assert row_gather_by_source.launches == before + 1
                assert torch.equal(got, x[idx]), (n, d, e, ii.dtype, split is None)
                assert torch.equal(got, row_gather_by_source(x, plan.indptr, plan.pos, split))
            assert torch.equal(row_gather_by_source(x, plan.indptr, None, plan.split),
                               row_gather_by_source_plain(x, plan.indptr))


@pytest.mark.cuda
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_relation_passes_and_binary_gspmm_match_the_cpu_on_card(reduce):
    """gspmm_rel (R weighted K1 launches each way), gspmm's mul by an edge
    scalar, a binary op and max on the card against the same calls on CPU
    tensors (the plain versions), with a hub row in both CSRs."""
    from dgl_tpu_torch import from_edges, gspmm
    from dgl_tpu_torch.ops import RelEdgeWeights, gspmm_rel

    dev = _card()
    rng = np.random.default_rng(3)
    n, e, r, d = 3000, 60_000, 4, 32
    src = np.concatenate([rng.integers(0, n, e), np.full(5000, 7)])
    dst = np.concatenate([rng.integers(0, n - 100, e), rng.integers(0, n - 100, 5000)])
    w = rng.uniform(0.1, 1.0, (len(src), r)).astype(np.float32)
    y = rng.normal(1.0, 1.0, (r, n, d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)
    res = {}
    for where in ("cpu", dev):
        g = from_edges(src, dst, n, device=where)
        weights = RelEdgeWeights.build(g, torch.from_numpy(w).to(where)[g.eid.long()])
        yk = torch.from_numpy(y).to(where).requires_grad_()
        before = csr_spmm.launches
        out = gspmm_rel(reduce, g, yk, weights)
        out.backward(torch.from_numpy(cot).to(where))
        launched = csr_spmm.launches - before
        x = yk.detach()[0]
        ew = weights.fwd[0].unsqueeze(1)
        res[str(where)] = [out.detach(), yk.grad,
                           gspmm(g, "mul", reduce, x=x, e=ew),
                           gspmm(g, "add", reduce, x=x, e=x.index_select(0, g.dst.long())),
                           gspmm(g, "copy_u", "max", x=x)]
        assert launched == (2 * r if where == dev else 0)
    for got, want in zip(res[str(dev)], res["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("pair", [False, True], ids=["z", "pair"])
@pytest.mark.parametrize("heads,d", [(1, 16), (4, 16), (4, 40), (2, 41), (3, 7)])
def test_k3_node_passes_match_plain_and_repeat_on_card(heads, d, pair, shift):
    """gat_scores, gat_score_grad and gat_vector_grad (z both sides or a
    separate z_dst of another row count; rows at 0 or 4 bytes off 16-byte
    alignment, which takes one value a read): against float64 runs of the
    plain versions, two runs bitwise equal (the attention vectors' column
    sums in the launch's fixed order), grad_z written over grad_v, one
    launch each, and launches on two streams at once equal too (each call
    has its own ticket)."""
    from dgl_tpu_torch.kernels import gat_attention as k3

    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(heads * d + shift)
    n_src = 5000
    n_dst = 3100 if pair else n_src

    def rows(n):
        flat = torch.randn(shift // 4 + n * heads * d, device=dev, generator=gen)
        return flat[shift // 4:].view(n, heads, d)

    z = rows(n_src)
    zd = rows(n_dst) if pair else None
    att_s, att_d = (torch.randn(1, heads, d, device=dev, generator=gen) for _ in range(2))
    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    counts = (k3.gat_scores.launches, k3.gat_score_grad.launches, k3.gat_vector_grad.launches)
    got = k3.gat_scores(z, att_s, att_d, zd)
    for a, b in zip(got, k3.gat_scores_plain(z.double(), att_s.double(), att_d.double(), d64(zd))):
        torch.testing.assert_close(a, b.float(), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, k3.gat_scores(z, att_s, att_d, zd)))
    g, out, w1 = rows(n_dst), rows(n_dst), rows(n_dst)
    hs = [torch.randn(n_dst, heads, device=dev, generator=gen) for _ in range(4)]
    got = k3.gat_score_grad(g, out, w1, *hs)
    for a, b in zip(got, k3.gat_score_grad_plain(g.double(), out.double(), w1.double(),
                                                 *(t.double() for t in hs))):
        torch.testing.assert_close(a, b.float(), rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, k3.gat_score_grad(g, out, w1, *hs)))
    ga_s = torch.randn(n_src, heads, device=dev, generator=gen)
    ga_d = torch.randn(n_dst, heads, device=dev, generator=gen)
    gv = None if pair else rows(n_src)
    want = k3.gat_vector_grad_plain(z.double(), att_s.double(), att_d.double(), ga_s.double(),
                                    ga_d.double(), d64(gv), d64(zd))
    runs = [k3.gat_vector_grad(z, att_s, att_d, ga_s, ga_d,
                               grad_v=None if gv is None else gv.clone(), z_dst=zd)
            for _ in range(2)]
    for a, b in zip(runs[0], want):
        assert (a is None) == (b is None)
        if a is not None:  # column sums over thousands of rows: a float32 bound
            torch.testing.assert_close(a, b.float(), rtol=1e-4, atol=1e-3)
    assert all(a is None or torch.equal(a, b) for a, b in zip(*runs))
    if gv is not None:
        buf = gv.clone()
        assert k3.gat_vector_grad(z, att_s, att_d, ga_s, ga_d, grad_v=buf)[0] is buf
    assert (k3.gat_scores.launches, k3.gat_score_grad.launches, k3.gat_vector_grad.launches) == (
        counts[0] + 2, counts[1] + 2, counts[2] + 2 + (gv is not None))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    grad = lambda: k3.gat_vector_grad(z, att_s, att_d, ga_s, ga_d, z_dst=zd)[2:]  # noqa: E731
    with torch.cuda.stream(side):
        on_side = [grad() for _ in range(4)]
    on_main = [grad() for _ in range(4)]
    torch.cuda.synchronize(dev)
    assert all(torch.equal(a, b) for r in on_side + on_main for a, b in zip(r, runs[0][2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("edge_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_gat_step_on_card_matches_cpu_counts_and_repeats(edge_dtype):
    """A three-layer fused GAT (the last layer narrow: 6 < 9) over a graph
    with long rows in both CSRs: a training step on the card against the
    same step on the CPU (the passes' plain versions; no attention dropout,
    whose seed each device's generator draws apart), two steps with
    attention dropout bitwise equal, and each step's launches: K3's forward
    and b2 3 + 3, the node passes 3 scores + 3 score gradients + 3 vector
    gradients."""
    from dgl_tpu_torch import GAT, from_edges
    from dgl_tpu_torch.kernels import gat_attention as k3

    dev = _card()
    rng = np.random.default_rng(23)
    n, e = 3000, 40_000
    src, dst = rng.integers(0, n, e), rng.integers(0, 3 * n // 4, e)
    src[:1500], dst[1500:3000] = 11, 5  # a long row in the reverse CSR and in the dst CSR
    x = torch.from_numpy(rng.standard_normal((n, 10)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 9, n))
    results = {}
    for where, drop in (("cpu", 0.0), ("cuda", 0.0), ("cuda", 0.3), ("cuda", 0.3)):
        g = from_edges(src, dst, n, device=where)
        model = GAT(10, 3, 9, (2, 2, 1), feat_drop=0.0, attn_drop=drop, fused=True,
                    edge_dtype=edge_dtype, device=where, generator=torch.Generator().manual_seed(4))
        counts = [f.launches for f in (k3.gat_attention_fwd, k3.gat_attention_bwd, k3.gat_scores,
                                       k3.gat_score_grad, k3.gat_vector_grad)]
        logits = model(g, x.to(where), generator=torch.Generator(device=where).manual_seed(6))
        torch.nn.functional.cross_entropy(logits, y.to(where)).backward()
        made = [f.launches - c for f, c in zip(
            (k3.gat_attention_fwd, k3.gat_attention_bwd, k3.gat_scores, k3.gat_score_grad,
             k3.gat_vector_grad), counts)]
        assert made == ([0] * 5 if where == "cpu" else [3, 3, 3, 3, 3]), (where, made)
        results.setdefault((where, drop), []).append(
            [logits.detach().cpu()] + [p.grad.cpu() for p in model.parameters()])
    (first, second), (card,), (cpu,) = (results["cuda", 0.3], results["cuda", 0.0],
                                        results["cpu", 0.0])
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    tol = dict(rtol=2e-3, atol=2e-3) if edge_dtype else dict(rtol=1e-4, atol=1e-4)
    for i, (a, b) in enumerate(zip(card, cpu)):
        torch.testing.assert_close(a, b, **tol, msg=f"output {i}")
