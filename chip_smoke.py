#!/usr/bin/env python3
"""Smoke run of dgl_tpu_torch on one CUDA card: build, check, train.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for float32 matmuls and convolutions;
  2. build: builds every kernel from the sources in dgl_tpu_torch/kernels/csrc
     and prints ptxas' registers and spills of every variant;
  3. random: K1 (csr_spmm) on random CSRs with empty rows and hub rows of
     10^5 edges, D in {1, 16, 41, 602}, sum and mean, with and without edge
     weights, forward and backward through gspmm's autograd, on inputs
     around 1 and on small integers. Every row is held to float64 sums of
     the same inputs within a summation-error bound (integer sums: bit for
     bit), and rows of at most HUB_DEG terms to the plain PyTorch version at
     RTOL/ATOL; two kernel runs must be bitwise equal. The same checks on
     CSRs around the row split T (graph/split.py): rows of T - 1, T, T + 1,
     2T and 2T + 1 edges, every row long, no row long, E = 0, int32 and
     int64 indptr; and a plan that does not match indptr refused before any
     launch;
  4. reddit: the same checks on the full reddit graph at D = 16, forward
     and reverse CSR (one combine launch for the reverse CSR's long rows),
     with CUDA-event times of the kernel at T = 256, 512 and 1024, the plain
     version and torch.sparse.mm, and the bytes bound; T and each CSR's long
     rows and chunks; gspmm's forward and backward under
     torch.cuda.set_sync_debug_mode("error"), which a host sync fails;
  5. main: dgl_tpu_torch.bench.run("reddit") at full size, once unhoisted
     and once hoisted, K1's launch and combine counters set to 0 before each
     run and read after it; the loss must be finite and fall, K1 must launch
     exactly 4 times per unhoisted step and 2 per hoisted step plus once for
     the hoisted precompute, its combine once per backward launch (the
     reverse CSR's long rows), and both modes must agree on the first
     step's loss;
  6. gat_random: K3 (gat_attention_fwd, gat_attention_bwd, each with the
     row split of the CSR it walks) and K2 (seg_sum) on random CSRs with
     empty rows and 10^5-edge hub rows in both directions, H in {1, 4, 8},
     D in {8, 16, 41}, keep in {1.0, 0.82}, on v and g around 1. Every
     output row is held to a float64 run of the
     plain version within the bound (2n + 8 + 4A)·u·Σ|term| (n terms,
     A = |a_src| + |a_dst| + |shift|, which the rounding of each term's
     logit and exp scales with), rows of at most HUB_DEG terms to the
     float32 plain version at RTOL/ATOL; both K3 passes (keep 1 and 0.5,
     see check_k3_exact) and K2 also run on inputs whose sums are exact and
     must match bit for bit on every row, hub rows included; two runs of
     each kernel are bitwise equal; K2 also on the CSRs around the split, W
     in {1, 16, 41, 64, 602}; both K3 passes on graphs whose two CSRs both
     have the rows around the split (H in {1, 4}, D in {16, 40, 41}, keep in
     {1, 0.82}, int32 and int64 indptr, the same checks) and a mismatched
     plan refused by each before any launch;
  7. gat_reddit: K3 forward and b2 on reddit with self-loops (H = 1,
     D = 16, reddit's attention dropout) and K2 at (E, 16) over the dst and
     the reverse CSR: the same checks, CUDA-event medians of the kernel, the
     plain version and, for K2, torch.segment_reduce and index_add_ (its
     row ids made outside the timed calls; K3 has no single PyTorch call to
     compare with), the combine launches of the timed K3 calls counted, the
     T sweep (256, 512, 1024) of K2 and of each K3 pass whose CSR has a row
     over 256 edges, and the bytes bounds; K3's checks and times also at
     arxiv's shapes (bidirected with self-loops, H = 4, D = 16 and the last
     layer's D = 40, long rows in both CSRs); a fused GATConv's forward and
     backward, and seg_sum_dst's, under set_sync_debug_mode("error");
     gather_src_rows' adjoint timed as
     one K1 launch and as index_select + K2 (reddit at W = 16, pubmed at
     W = 64); a fused GATConv's forward and backward allocate no more on
     reddit than on its self-loops alone;
  8. row_gather: P1 (row_gather_async) and P2 (row_gather_smem) held bit
     for bit to x[idx] in float32 and bfloat16, int32 and int64 indices,
     ragged e, rows of 2 B to 40 KB, misaligned x, P2 up to its 227 KB
     limit and its refusal above it, two runs bitwise equal; the row-gather
     probe (python -m dgl_tpu_torch.tools.exp_dma_gather) as its main path,
     at its default shape and at cora's node count at D = 16, each run with
     the P1 and P2 counters set to 0 before it and read after it, every line
     with maxerr 0 but P2's refusal at the default shape; CUDA-event medians
     of P1, index_select and a write-only fill of the same output on the
     index streams of K1 forward and backward, K3 forward and b2 and
     pubmed's gather_src_rows, and the probe's default, with gather_floor_ms
     (P1 less the fill) beside the kernel that gathers them; P2 against P1 and
     index_select at (2708, 16) on reddit's indices mod 2708;
  9. gat_main: main_gat at full width, reddit and ogbn-arxiv (fused
     form, heads (1, 1, 1) and (4, 4, 4)) then pubmed (edge form), each run
     with every launch and combine counter set to 0 before it and read
     after it. reddit and arxiv: K3 forward and b2 exactly 3 per step each,
     K2 and K1 none, the combines their graphs' plans give (see
     phase_gat_main); reddit's training peak device memory above the graph
     and data held below one (E, 16) float32 buffer; pubmed: K3 none, K2
     exactly 9 per step plus one per edge-softmax rescue, K1 3 per step,
     K1's combine once per K1 launch (pubmed's reverse CSR has long rows)
     and K2's none. Losses finite and falling;
  10. sage_main: main_sage at full width on ogbn-arxiv (3 layers, hidden
     256, BN, bidirected; 10 epochs) and the full ogbn-products graph (3
     layers, hidden 64, bidirected; 5 epochs), each hoisted and with
     --no-precompute, arxiv also with lowering="scatter", every counter set
     to 0 before a run and read after it: K1's launches and combines as
     derived from the code (sage_k1_launches), none under scatter; losses
     finite and falling; the first step's loss equal across the modes.
     Then K1 at every width those runs give it (arxiv D = 40, 128, 256;
     products D = 47, 64, 100), forward on the dst CSR and backward on the
     reverse CSR, held to float64 sums and timed beside torch.sparse.mm and
     its bound; load_s, setup_s, precompute_s, memory and each CSR's split;
  11. gc_main: main_gcn at full width on ENZYMES (600 graphs, 5 epochs),
     ogbg-molhiv (41,127 graphs, 3 epochs, fused and scatter) and ogbg-ppa
     (cut to 2,000 graphs, 3 epochs), batch 64, every counter set to 0
     before a run and read after it: K1's and K2's launches per step as
     derived from the code (gc_per_step), no combine; losses finite and
     falling; one molhiv epoch profiled (the device's idle share); K2's mean
     and sum readouts on a molhiv batch at D = 256 against the plain version
     and float64 sums; one molhiv step under set_sync_debug_mode("error");
  12. kernels: one line listing every ported kernel with its numbers, K1's,
     K2's and K3's with T, long rows, chunks and combine launches, K3's at
     arxiv's shapes (D = 16 and 40) beside reddit's and b2's gather floor,
     K1's at the SAGE widths and K1's and K2's launches on the new paths.
The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = ATOL = 1e-4  # kernel vs plain version, on rows of at most HUB_DEG terms
HUB_DEG = 1000  # longer rows are held to float64 sums only
U32 = 2.0 ** -24  # float32 unit roundoff


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def reference64(indptr, indices, x, w=None, mean=False):
    """Float64 sums of the given inputs, and the sums of their absolute
    values (what a float32 summation error scales with)."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm_plain

    x64, w64 = x.double(), None if w is None else w.double()
    want = csr_spmm_plain(indptr, indices, x64, w64, mean=mean)
    mag = csr_spmm_plain(indptr, indices, x64.abs(), None if w is None else w64.abs(), mean=mean)
    return want, mag


def check(what, got, indptr, ref, plain=None, exact=False, slack=(1, 3), amp=None):
    """Hold a kernel's output row by row against a float64 run of the same
    inputs; ``ref`` is (float64 result, float64 sum of the absolute terms,
    or |value| for a per-row scalar).

    K1 (``slack`` (1, 3)): row r of n_r terms may be off by
    (n_r + 3)·u·Σ|term|: a float32 sum of n terms in any order is within
    (n - 1)·u·Σ|term| of the exact one (to first order), plus one rounding
    of each term (the backward's 1/deg scaling) and two of the result (the
    mean's 1/deg and its product). K2 and K3 (``slack`` (2, 8)): two such
    sums per output (a quotient's numerator and denominator) and, with
    ``amp`` = A_r = |a_src| + |a_dst| + |shift| per row (and head), 4·A_r
    more for the rounding of each term's logit and exp, whose absolute
    error scales with A: (2·n_r + 8 + 4·A_r)·u·Σ|term|. ``exact``: the
    inputs are small integers, so every partial sum is exact in float32
    and the output must equal the float64 sum bit for bit; a dropped or
    repeated edge shows however long its row. Rows of at most HUB_DEG
    terms must also match the plain version at RTOL/ATOL. Returns the max
    abs error against the plain version, against the float64 run, and the
    largest share of its bound that an error used.
    """
    want, mag = ref
    got64 = got.double()
    if exact and not torch.equal(got64, want):
        bad = int((got64 != want).flatten(1).any(1).nonzero()[0])
        raise AssertionError(f"{what}: integer sums of row {bad} differ from the exact sums")
    if not got.numel():
        return 0.0, 0.0, 0.0
    deg = (indptr[1:] - indptr[:-1]).double().reshape((-1,) + (1,) * (got.dim() - 1))
    factor = slack[0] * deg + slack[1]
    if amp is not None:
        factor = factor + 4 * amp.reshape(tuple(amp.shape) + (1,) * (got.dim() - amp.dim()))
    err64 = (got64 - want).abs()
    tol = factor * U32 * mag
    over = err64 - tol
    if over.max() > 0:
        i = int(over.argmax())
        r = i // got[0].numel()
        raise AssertionError(f"{what}: row {r} ({int(deg.flatten()[r])} terms) is "
                             f"{err64.flatten()[i].item()} off the float64 run, "
                             f"bound {tol.flatten()[i].item()}")
    err = 0.0
    if plain is not None:
        err = (got - plain).abs().max().item()
        short = deg.flatten() <= HUB_DEG
        if not torch.allclose(got[short], plain[short], rtol=RTOL, atol=ATOL):
            bad = (got[short] - plain[short]).abs().max().item()
            raise AssertionError(f"{what}: kernel differs from the plain version, max abs err {bad}")
    used = (err64 / tol.clamp(min=1e-300)).max().item()
    return err, err64.max().item(), used


def median_ms(fn, reps, warmup):
    from dgl_tpu_torch.train.timing import event_times_ms

    return statistics.median(event_times_ms(fn, reps=reps, warmup=warmup))


def spmm_bound(n_rows, n_src, nnz, d, indptr_bytes):
    """Least time (ms) of one CSR SpMM and what sets it: each input read
    once and the output written once, or nnz·d FMAs at the float32 peak."""
    moved = nnz * 4 + (n_rows + 1) * indptr_bytes + n_src * d * 4 + n_rows * d * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * nnz * d / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], tf32_matmul=False, tf32_cudnn=False)
    return smi


def _ptxas_lines(log):
    """``-Xptxas -v``'s registers and spills of every kernel variant, each
    line prefixed by the variant's mangled name."""
    lines, entry = [], "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln.strip()
        elif "registers" in ln or "spill" in ln:
            lines.append(f"{entry}: {ln.strip().removeprefix('ptxas info    : ')}")
    return lines


def phase_build():
    from dgl_tpu_torch.kernels.build import build

    t0 = time.perf_counter()
    info = build()
    ptxas = {name: _ptxas_lines(b["log"]) for name, b in info.items()}
    emit("build", seconds=time.perf_counter() - t0,
         kernels={name: b["seconds"] for name, b in info.items()}, ptxas=ptxas)


def _random_graph(rng, n, hub_edges):
    """Random edges into the lower half of the nodes (the upper half has no
    in-edges), plus a hub destination and a hub source of ``hub_edges`` each
    (so the forward and the reverse CSR both hold a hub row)."""
    e0 = 5 * n
    src = np.concatenate([rng.integers(0, n, e0), rng.integers(0, n, hub_edges),
                          np.full(hub_edges, 7)])
    dst = np.concatenate([rng.integers(0, n // 2, e0), np.full(hub_edges, 5),
                          rng.integers(0, n // 2, hub_edges)])
    return src, dst


def _inputs(rng, kind, n, d, e, dev):
    """x, the cotangent and edge weights. "normal": around 1 rather than 0,
    so a hub row's sum of 1e5 terms stays far from 0 and the bounds measure
    the summation order, not cancellation. "integer": small integers, whose
    sums float32 holds exactly in any order."""
    if kind == "normal":
        x, cot = (rng.normal(1.0, 1.0, (n, d)) for _ in range(2))
        w = rng.uniform(0.5, 1.5, e)
    else:
        x, cot = (rng.integers(-4, 5, (n, d)) for _ in range(2))
        w = rng.integers(1, 4, e)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (x, cot, w)]


# -- the row split (graph/split.py): rows of more than T edges in chunks -----

def _split_degrees(rng, t):
    """Row lengths around the split T, by case: rows of T - 1, T, T + 1, 2T
    and 2T + 1 edges among short and empty rows; every row long; no row long
    (five of exactly T edges); no edge at all (E = 0)."""
    return {
        "around_T": [0, t - 1, t, t + 1, 2 * t, 2 * t + 1, 1, 0, 3 * t + 5, 7],
        "all_long": [t + 1 + 37 * i for i in range(40)],
        "no_long": [t] * 5 + rng.integers(0, t + 1, 300).tolist(),
        "no_edges": [0] * 7,
    }


def _csr_of(degrees, n_src, rng, dev):
    """An int64 indptr of the given row lengths and random int32 indices."""
    indptr = np.zeros(len(degrees) + 1, np.int64)
    np.cumsum(degrees, out=indptr[1:])
    idx = rng.integers(0, n_src, int(indptr[-1])).astype(np.int32)
    return torch.from_numpy(indptr).to(dev), torch.from_numpy(idx).to(dev)


def _refuses_mismatched_plan(fn, ip, *args, **kw):
    """A plan for one row fewer, and one for one edge fewer, raise ValueError
    before any launch."""
    from dgl_tpu_torch.graph.split import row_split

    host = ip.cpu().numpy()
    bad = [host[:-1]]
    if host[-1] > 0:
        bad.append(np.concatenate([host[:-1], host[-1:] - 1]))
    for b in bad:
        before = fn.launches
        try:
            fn(ip, *args, split=row_split(b, device=ip.device), **kw)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{fn.__name__} took a row split that does not match its indptr")
        if fn.launches != before:
            raise AssertionError(f"{fn.__name__} launched before refusing a mismatched row split")


def check_split_k1(rng, dev):
    """K1 on CSRs around the split, D in {1, 16, 41, 602}, int32 and int64
    indptr, sum and mean, with and without edge weights: float64 bounds, the
    plain version, integer sums bit for bit and a second run, bitwise."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    n_src, cases, acc = 3000, 0, [0.0, 0.0, 0.0]
    for name, degrees in _split_degrees(rng, SPLIT_T).items():
        ip, idx = _csr_of(degrees, n_src, rng, dev)
        plan = row_split(ip)
        for d in (1, 16, 41, 602):
            x, _, w = _inputs(rng, "normal", n_src, d, idx.numel(), dev)
            xi, _, wi = _inputs(rng, "integer", n_src, d, idx.numel(), dev)
            for indptr in (ip.int(), ip):
                for mean in (False, True):
                    for ww, wwi in ((None, None), (w, wi)):
                        what = (f"split {name} D={d} {indptr.dtype} mean={mean} "
                                f"weighted={ww is not None}")
                        got = csr_spmm(indptr, idx, x, ww, mean=mean, split=plan)
                        if not torch.equal(got, csr_spmm(indptr, idx, x, ww, mean=mean, split=plan)):
                            raise AssertionError(f"{what}: two kernel runs differ")
                        _merge(acc, [check(what, got, ip, reference64(ip, idx, x, ww, mean=mean),
                                           csr_spmm_plain(ip, idx, x, ww, mean=mean))])
                        if not mean:
                            check(f"{what} integer", csr_spmm(indptr, idx, xi, wwi, split=plan), ip,
                                  reference64(ip, idx, xi, wwi), exact=True)
                        cases += 1
        _refuses_mismatched_plan(csr_spmm, ip, idx, x)
    return cases, acc


def no_host_sync(run, control):
    """``run()`` under ``torch.cuda.set_sync_debug_mode("error")``, where a
    host sync raises; then ``control()``, which syncs and so must raise
    there, to show that the mode is live."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
        try:
            control()
        except RuntimeError:
            pass
        else:
            raise AssertionError("a host sync did not raise under set_sync_debug_mode('error')")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _split_fields(g):
    """T, and the long rows and chunks of a graph's two CSRs."""
    return {"split_T": g.split.t, "long_rows_fwd": g.split.num_long,
            "chunks_fwd": g.split.num_chunks, "long_rows_rev": g.reverse.split.num_long,
            "chunks_rev": g.reverse.split.num_chunks}


def t_sweep(fn, indptr):
    """``fn(plan)``'s median ms with the plan of each T in (256, 512, 1024);
    None when no row is longer than 256 edges, as all three plans are then
    empty and time the same launch."""
    from dgl_tpu_torch.graph.split import row_split

    plans = {t: row_split(indptr, t) for t in (256, 512, 1024)}
    if plans[256].num_long == 0:
        return None
    return {t: {"long_rows": plan.num_long, "chunks": plan.num_chunks,
                "ms": median_ms(lambda: fn(plan), reps=30, warmup=3)}
            for t, plan in plans.items()}


def phase_random():
    from dgl_tpu_torch import from_edges, gspmm
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n = 20_000
    src, dst = _random_graph(rng, n, 100_000)
    g = from_edges(src, dst, n, device=dev)
    rev = g.reverse
    inv_deg = 1.0 / g.in_degrees().clamp(min=1).double().unsqueeze(1)
    cases, worst, worst64, used = 0, 0.0, 0.0, 0.0
    for d in (1, 16, 41, 602):
        for kind in ("normal", "integer"):
            x, cot, w = _inputs(rng, kind, n, d, g.num_edges, dev)
            for reduce in ("sum", "mean"):
                mean = reduce == "mean"
                exact = kind == "integer" and not mean
                what = f"D={d} {kind} {reduce}"
                runs = []
                for _ in range(2):
                    xk = x.clone().requires_grad_()
                    out = gspmm(g, "copy_u", reduce, x=xk)
                    (out * cot).sum().backward()
                    runs.append((out.detach(), xk.grad))
                if not (torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])):
                    raise AssertionError(f"{what}: two kernel runs differ")
                xp = x.clone().requires_grad_()
                out_p = csr_spmm_plain(g.indptr, g.src, xp, mean=mean)
                (out_p * cot).sum().backward()
                errs = [
                    check(f"{what} forward", runs[0][0], g.indptr,
                          reference64(g.indptr, g.src, x, mean=mean), out_p.detach(), exact),
                    check(f"{what} backward", runs[0][1], rev.indptr,
                          reference64(rev.indptr, rev.src, cot.double() * inv_deg if mean else cot),
                          xp.grad, exact),
                ]
                for indptr in (g.indptr, g.indptr.long()):
                    errs.append(check(
                        f"{what} weighted {indptr.dtype}",
                        csr_spmm(indptr, g.src, x, w, mean=mean, split=g.split),
                        g.indptr, reference64(g.indptr, g.src, x, w, mean=mean),
                        csr_spmm_plain(indptr, g.src, x, w, mean=mean), exact))
                worst = max([worst] + [e[0] for e in errs])
                worst64 = max([worst64] + [e[1] for e in errs])
                used = max([used] + [e[2] for e in errs])
                cases += len(errs)
    split_cases, acc = check_split_k1(rng, dev)
    torch.cuda.synchronize()
    emit("random", cases=cases, nodes=n, edges=g.num_edges,
         max_in_degree=int(g.in_degrees().max()), max_out_degree=int(g.out_degrees().max()),
         zero_in_degree_rows=int((g.in_degrees() == 0).sum()), max_abs_err=max(worst, acc[0]),
         max_abs_err_f64=max(worst64, acc[1]), max_bound_used=max(used, acc[2]), rtol=RTOL,
         atol=ATOL, hub_deg=HUB_DEG, deterministic=True, split_cases=split_cases,
         split_max_abs_err=acc[0], split_max_bound_used=acc[2], **_split_fields(g))


def phase_reddit():
    from dgl_tpu_torch import from_edges, gspmm
    from dgl_tpu_torch.data import load_node_dataset
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = load_node_dataset("reddit")
    g = from_edges(data.src, data.dst, data.num_nodes, device=dev)
    load_s = time.perf_counter() - t0
    n, e, d = data.num_nodes, g.num_edges, 16
    gen = torch.Generator(device=dev).manual_seed(0)
    # inputs around 1 (see _inputs): the reverse hub row sums ~2e5 terms
    x = 1.0 + torch.randn(n, d, device=dev, generator=gen)
    g_out = 1.0 + torch.randn(n, d, device=dev, generator=gen)
    g_scaled = g_out / g.in_degrees().clamp(min=1).float().unsqueeze(1)
    x_int = torch.randint(-4, 5, (n, d), device=dev, generator=gen).float()
    rev = g.reverse
    sides = {
        # forward: mean over the dst-sorted CSR, as in SAGEConv's forward
        "fwd": (g, x, True),
        # backward: sum of the 1/deg-scaled cotangent over the reverse CSR
        "bwd": (rev, g_scaled, False),
    }
    res = {}
    for side, (gg, xx, mean) in sides.items():
        kern = lambda: csr_spmm(gg.indptr, gg.src, xx, mean=mean, split=gg.split)  # noqa: E731
        plain = lambda: csr_spmm_plain(gg.indptr, gg.src, xx, mean=mean)  # noqa: E731
        combines = csr_spmm.combines
        err, err64, used = check(f"reddit {side}", kern(), gg.indptr,
                           reference64(gg.indptr, gg.src, xx, mean=mean), plain())
        if csr_spmm.combines - combines != int(gg.split.num_long > 0):
            raise AssertionError(f"reddit {side}: {gg.split.num_long} long rows but "
                                 f"{csr_spmm.combines - combines} combine launches")
        # every edge counted once: integer sums are exact in any order
        check(f"reddit {side} integer", csr_spmm(gg.indptr, gg.src, x_int, split=gg.split),
              gg.indptr, reference64(gg.indptr, gg.src, x_int), exact=True)
        a = torch.sparse_csr_tensor(gg.indptr.long(), gg.src.long(),
                                    torch.ones(e, device=dev), size=(n, n),
                                    check_invariants=False)
        lib_err = (torch.sparse.mm(a, xx)
                   - csr_spmm(gg.indptr, gg.src, xx, split=gg.split)).abs().max().item()
        bound_ms, bound_by = spmm_bound(n, n, e, d, 4)
        res[side] = {
            "kernel_ms": median_ms(kern, reps=30, warmup=3),
            "plain_ms": median_ms(plain, reps=10, warmup=2),
            "library_ms": median_ms(lambda: torch.sparse.mm(a, xx), reps=30, warmup=3),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "max_abs_err": err,
            "max_abs_err_f64": err64,
            "max_bound_used": used,
            "library_max_abs_err_vs_kernel_sum": lib_err,
            "max_row_nnz": int(gg.in_degrees().max()),
            "split_T": gg.split.t, "long_rows": gg.split.num_long, "chunks": gg.split.num_chunks,
            "t_sweep": t_sweep(lambda p: csr_spmm(gg.indptr, gg.src, xx, mean=mean, split=p),
                               gg.indptr),
        }
        res[side]["at_or_below_library"] = res[side]["kernel_ms"] <= res[side]["library_ms"]
    # gspmm's forward and backward on the card read nothing back: no host sync
    xk = x.clone().requires_grad_()
    no_host_sync(lambda: gspmm(g, "copy_u", "mean", x=xk).backward(g_out),
                 lambda: csr_spmm(g.indptr, g.src, x))  # no plan: built from indptr, a sync
    if xk.grad is None:
        raise AssertionError("gspmm's backward gave no gradient under the sync check")
    emit("reddit", nodes=n, edges=e, d=d, load_s=load_s, no_host_sync=True, **_split_fields(g),
         kernel_ms_fwd=res["fwd"]["kernel_ms"], kernel_ms_bwd=res["bwd"]["kernel_ms"],
         plain_ms_fwd=res["fwd"]["plain_ms"], plain_ms_bwd=res["bwd"]["plain_ms"],
         library_ms_fwd=res["fwd"]["library_ms"], library_ms_bwd=res["bwd"]["library_ms"],
         bound_ms_fwd=res["fwd"]["bound_ms"], bound_ms_bwd=res["bwd"]["bound_ms"], detail=res)
    return res, g


def phase_main():
    """Each mode in a run of its own, its launch count read around it."""
    from dgl_tpu_torch import bench
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm

    res, launches, combines = {}, {}, {}
    for mode in ("unhoisted", "hoisted"):
        csr_spmm.launches = csr_spmm.combines = 0
        r = bench.run("reddit", epochs=5, warmup=3, device="cuda",
                      hoisted=mode == "hoisted", unhoisted=mode == "unhoisted")
        launches[mode] = csr_spmm.launches
        combines[mode] = csr_spmm.combines
        res[mode] = dict(r[mode], setup_s=r["setup_s"], device=r["device"], synthetic=r["synthetic"],
                         precompute_s=r.get("precompute_s"))
    steps = {mode: len(res[mode]["losses"]) for mode in res}
    # 2 forward and 2 backward launches a step; hoisted: layer 1's forward
    # launch and its backward are gone, and x_agg is one launch before training
    want = {"unhoisted": 4 * steps["unhoisted"], "hoisted": 2 * steps["hoisted"] + 1}
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times over {steps} steps; want {want}")
    # only the reverse CSR has long rows: one combine per backward launch
    want = {"unhoisted": 2 * steps["unhoisted"], "hoisted": steps["hoisted"]}
    if combines != want:
        raise AssertionError(f"K1's combine launched {combines} times over {steps} steps; "
                             f"want {want}")
    for mode in res:
        losses = res[mode]["losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{mode} loss did not fall: {losses}")
    l0u, l0h = res["unhoisted"]["losses"][0], res["hoisted"]["losses"][0]
    if abs(l0u - l0h) > 1e-4:
        raise AssertionError(f"first-step loss: unhoisted {l0u} vs hoisted {l0h}")
    emit("main", metric="reddit_sage_epoch_time", device=res["unhoisted"]["device"],
         synthetic=res["unhoisted"]["synthetic"],
         unhoisted_epoch_s=res["unhoisted"]["epoch_s"], hoisted_epoch_s=res["hoisted"]["epoch_s"],
         unhoisted_epochs_s=res["unhoisted"]["epochs_s"], hoisted_epochs_s=res["hoisted"]["epochs_s"],
         setup_s=res["unhoisted"]["setup_s"], precompute_s=res["hoisted"]["precompute_s"],
         losses_unhoisted=res["unhoisted"]["losses"], losses_hoisted=res["hoisted"]["losses"],
         launches_unhoisted=launches["unhoisted"], launches_hoisted=launches["hoisted"],
         launches_per_unhoisted_step=launches["unhoisted"] / steps["unhoisted"],
         combines_unhoisted=combines["unhoisted"], combines_hoisted=combines["hoisted"],
         steps_unhoisted=steps["unhoisted"], steps_hoisted=steps["hoisted"])
    return launches, combines


# -- GAT: K3 (fused attention) and K2 (segment sum) --------------------------

REDDIT_KEEP = 1.0 - 0.18074706609292976  # reddit GAT's tuned attention dropout


def _bound_ms(moved_bytes, flops):
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k3_fwd_bound(n_dst, n_src, e, h, d):
    """Read indptr, src, v, a_src and a_dst once; write out and w1 (N, H, D)
    and inv_s, w1s, shift (N, H). About 4·D + 12 operations per edge and
    head (two FMAs per feature, the logit, exp and scalar sums)."""
    moved = 4 * ((n_dst + 1) + e + n_src * h * d + n_src * h + n_dst * h
                 + 2 * n_dst * h * d + 3 * n_dst * h)
    return _bound_ms(moved, e * h * (4 * d + 12))


def k3_bwd_bound(n_src, n_dst, e, h, d, dropout):
    """Read the reverse indptr and dst (and eid with dropout), g (N, H, D),
    the packed node float4s and a_src once; write grad_v, w2 (N, H, D) and
    w3 (N, H)."""
    moved = 4 * ((n_src + 1) + e * (2 if dropout else 1) + n_dst * h * d + 4 * n_dst * h
                 + n_src * h + 2 * n_src * h * d + n_src * h)
    return _bound_ms(moved, e * h * (4 * d + 14))


def k2_bound(n_rows, e, w):
    """Read msg and indptr once, write out once; one add per element."""
    return _bound_ms(4 * (e * w + n_rows + 1 + n_rows * w), e * w)


def _merge(acc, errs):
    for e in errs:
        acc[0], acc[1], acc[2] = max(acc[0], e[0]), max(acc[1], e[1]), max(acc[2], e[2])


def check_k3_fwd(what, g, v, a_s, a_d, kw, acc):
    """One K3 forward launch against its plain version in float32 and
    float64; returns the kernel's outputs."""
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_fwd, gat_attention_fwd_plain

    got = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)
    again = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two K3 forward runs differ")
    plain = gat_attention_fwd_plain(g.indptr, g.src, v, a_s, a_d, **kw)
    v64, s64, d64 = v.double(), a_s.double(), a_d.double()
    want = gat_attention_fwd_plain(g.indptr, g.src, v64, s64, d64, **kw)
    absrun = gat_attention_fwd_plain(g.indptr, g.src, v64.abs(), s64, d64, **kw)
    amp = d64.abs() + s64.abs().max() + want[4].abs()  # (N_dst, H)
    mags = [absrun[0], absrun[1], want[2].abs(), want[3].abs(), want[4].abs()]
    names = ("out", "w1", "inv_s", "w1s", "shift")
    _merge(acc, [check(f"{what} fwd {nm}", x, g.indptr, (w, m), p, slack=(2, 8), amp=amp)
                 for nm, x, w, m, p in zip(names, got, want, mags, plain)])
    return got


def check_k3_bwd(what, g, g_out, node, a_s, kw, acc):
    """One K3 b2 launch against its plain version in float32 and float64."""
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_bwd_plain

    rev = g.reverse
    args = (rev.indptr, rev.src, rev.eid)
    got = gat_attention_bwd(*args, g_out, node, a_s, split=rev.split, **kw)
    again = gat_attention_bwd(*args, g_out, node, a_s, split=rev.split, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two K3 b2 runs differ")
    plain = gat_attention_bwd_plain(*args, g_out, node, a_s, **kw)
    g64, n64, s64 = g_out.double(), node.double(), a_s.double()
    want = gat_attention_bwd_plain(*args, g64, n64, s64, **kw)
    n_abs = n64.clone()
    n_abs[..., 3] = n_abs[..., 3].abs()
    absrun = gat_attention_bwd_plain(*args, g64.abs(), n_abs, s64, **kw)
    amp = s64.abs() + n64[..., 0].abs().max() + n64[..., 1].abs().max()  # (N_src, H)
    names = ("grad_v", "w2", "w3")
    _merge(acc, [check(f"{what} b2 {nm}", x, rev.indptr, (w, m), p, slack=(2, 8), amp=amp)
                 for nm, x, w, m, p in zip(names, got, want, absrun, plain)])
    return got


def check_k3_exact(what, g, h, d, gen):
    """Both K3 passes on inputs whose every term float32 holds exactly, so a
    dropped, repeated or misrouted edge shows however long its row, unlike
    the float64 bound, which on a hub row is wide.

    Forward: a_src = 1 and a_dst = 0 make every logit 1, the shift 1 and
    each p = exp(0) = 1, so with small-integer v the sums num and s = deg are
    exact, and out = num / s, inv_s = 1 / s are single float32 divisions,
    which the float64 run rounded to float32 reproduces bit for bit (53 ≥
    2·24 + 2 bits: rounding a quotient twice is innocuous). b2: node =
    (a_dst 0, shift 1, inv_s 1, C integer) and a_src = 1 make α = 1 and the
    slope 1, so grad_v, w2 and w3 are integer sums. keep = 0.5 scales the
    kept terms by exactly 2, so the dropout hash is held exactly too."""
    from dgl_tpu_torch.kernels.gat_attention import (
        gat_attention_bwd, gat_attention_bwd_plain, gat_attention_fwd, gat_attention_fwd_plain)

    dev = g.indptr.device
    n_src, n_dst, rev = g.num_src_nodes, g.num_dst_nodes, g.reverse
    ints = lambda *shape: torch.randint(-4, 5, shape, device=dev, generator=gen).float()  # noqa: E731
    v, g_out, c = ints(n_src, h, d), ints(n_dst, h, d), ints(n_dst, h)
    a_s = torch.ones(n_src, h, device=dev)
    a_d = torch.zeros(n_dst, h, device=dev)
    node = torch.stack([a_d, torch.ones_like(a_d), torch.ones_like(a_d), c], -1)
    seed = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32, device=dev, generator=gen)
    for keep in (1.0, 0.5):
        kw = dict(negative_slope=0.2, keep=keep, seed=seed)
        got = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)
        want = gat_attention_fwd_plain(g.indptr, g.src, v.double(), a_s.double(), a_d.double(), **kw)
        got += gat_attention_bwd(rev.indptr, rev.src, rev.eid, g_out, node, a_s, split=rev.split,
                                 **kw)
        want += gat_attention_bwd_plain(rev.indptr, rev.src, rev.eid, g_out.double(), node.double(),
                                        a_s.double(), **kw)
        names = ("out", "w1", "inv_s", "w1s", "shift", "grad_v", "w2", "w3")
        for nm, x, w in zip(names, got, want):
            if not torch.equal(x, w.float()):
                bad = int((x != w.float()).flatten(1).any(1).nonzero()[0])
                raise AssertionError(f"{what} keep={keep} exact {nm}: row {bad} differs from the "
                                     "exact sums")


def check_k2(what, indptr, msg, ints, acc, split):
    """One K2 launch against float64 sums (the (2n + 8)·u·Σ|term| bound),
    the plain version, and small integers summed bit for bit."""
    from dgl_tpu_torch.kernels.seg_sum import seg_sum, seg_sum_plain

    got = seg_sum(indptr, msg, split=split)
    if not torch.equal(got, seg_sum(indptr, msg, split=split)):
        raise AssertionError(f"{what}: two K2 runs differ")
    m64 = msg.double()
    _merge(acc, [check(f"{what} K2", got, indptr,
                       (seg_sum_plain(indptr, m64), seg_sum_plain(indptr, m64.abs())),
                       seg_sum_plain(indptr, msg), slack=(2, 8))])
    i64 = ints.double()
    check(f"{what} K2 integer", seg_sum(indptr, ints, split=split), indptr,
          (seg_sum_plain(indptr, i64), seg_sum_plain(indptr, i64.abs())), exact=True)
    return got


def _with_indptr_dtype(g, dtype):
    """The graph with both CSRs' indptr in ``dtype`` (the plans unchanged)."""
    rev = dataclasses.replace(g.reverse, indptr=g.reverse.indptr.to(dtype))
    return dataclasses.replace(g, indptr=g.indptr.to(dtype), reverse=rev)


def check_split_k3(rng, dev, acc):
    """Both K3 passes on graphs whose dst CSR and reverse CSR both have the
    row lengths of _split_degrees (each node sends as many edges as it
    receives), H in {1, 4}, D in {16, 40, 41} (lane groups of 4, 16 and
    32: 40 is arxiv's last layer), keep in {1, 0.82}, int32 and int64
    indptr: float64 bounds, the plain version, exact sums
    (check_k3_exact) and two runs bitwise equal; then a plan that does not
    match indptr, refused by both passes before any launch. Returns the
    number of cases."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.graph.split import SPLIT_T
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_fwd

    gen = torch.Generator(device=dev).manual_seed(5)
    cases = 0
    for name, degrees in _split_degrees(rng, SPLIT_T).items():
        n = len(degrees)
        dst = np.repeat(np.arange(n), degrees)
        g0 = from_edges(rng.permutation(dst), dst, n, device=dev)
        for h in (1, 4):
            for d in (16, 40, 41):
                v, g_out = (1.0 + torch.randn(n, h, d, device=dev, generator=gen) for _ in range(2))
                a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
                for dtype in (torch.int32, torch.int64):
                    g = _with_indptr_dtype(g0, dtype)
                    what = f"split {name} H={h} D={d} {dtype}"
                    check_k3_exact(what, g, h, d, gen)
                    for keep in (1.0, 0.82):
                        seed = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32,
                                             device=dev, generator=gen)
                        kw = dict(negative_slope=0.2, keep=keep, seed=seed)
                        out, _, inv_s, _, shift = check_k3_fwd(f"{what} keep={keep}", g, v, a_s,
                                                               a_d, kw, acc["fwd"])
                        node = torch.stack([a_d, shift, inv_s, (g_out * out).sum(-1)], -1)
                        check_k3_bwd(f"{what} keep={keep}", g, g_out, node, a_s, kw, acc["bwd"])
                        cases += 1
        kw = dict(negative_slope=0.2)
        _refuses_mismatched_plan(gat_attention_fwd, g0.indptr, g0.src, v, a_s, a_d, **kw)
        _refuses_mismatched_plan(gat_attention_bwd, g0.reverse.indptr, g0.reverse.src,
                                 g0.reverse.eid, g_out, node, a_s, **kw)
    return cases


def check_split_k2(rng, dev, acc):
    """K2 on CSRs around the split (_split_degrees), W in {1, 16, 41, 64,
    602} (every vector width and feature tile), int32 and int64 indptr;
    returns the number of cases."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split
    from dgl_tpu_torch.kernels.seg_sum import seg_sum

    gen = torch.Generator(device=dev).manual_seed(4)
    cases = 0
    for name, degrees in _split_degrees(rng, SPLIT_T).items():
        ip, _ = _csr_of(degrees, 1, rng, dev)
        plan, e = row_split(ip), int(sum(degrees))
        for w in (1, 16, 41, 64, 602):
            msg = 1.0 + torch.randn(e, w, device=dev, generator=gen)
            ints = torch.randint(-4, 5, (e, w), device=dev, generator=gen).float()
            for indptr in (ip.int(), ip):
                check_k2(f"split {name} W={w} {indptr.dtype}", indptr, msg, ints, acc, plan)
                cases += 1
        _refuses_mismatched_plan(seg_sum, ip, msg)
    return cases


def phase_gat_random():
    from dgl_tpu_torch import from_edges

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    n = 20_000
    src, dst = _random_graph(rng, n, 100_000)
    g = from_edges(src, dst, n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    k3 = {"fwd": [0.0, 0.0, 0.0], "bwd": [0.0, 0.0, 0.0]}
    k2 = [0.0, 0.0, 0.0]
    cases = 0
    for h in (1, 4, 8):
        for d in (8, 16, 41):
            # v and g around 1 (see _inputs): a hub row's sums stay far from 0
            v, g_out = (1.0 + torch.randn(n, h, d, device=dev, generator=gen) for _ in range(2))
            a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
            check_k3_exact(f"H={h} D={d}", g, h, d, gen)
            for keep in (1.0, 0.82):
                what = f"H={h} D={d} keep={keep}"
                seed = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32, device=dev,
                                     generator=gen)
                kw = dict(negative_slope=0.2, keep=keep, seed=seed)
                out, w1, inv_s, w1s, shift = check_k3_fwd(what, g, v, a_s, a_d, kw, k3["fwd"])
                node = torch.stack([a_d, shift, inv_s, (g_out * out).sum(-1)], -1)
                check_k3_bwd(what, g, g_out, node, a_s, kw, k3["bwd"])
                cases += 1
            # K2 on the same shapes as GAT's edge form: (E, H·D), both CSRs
            w = h * d
            for side, gg in (("dst", g), ("reverse", g.reverse)):
                msg = 1.0 + torch.randn(g.num_edges, w, device=dev, generator=gen)
                ints = torch.randint(-4, 5, (g.num_edges, w), device=dev, generator=gen).float()
                check_k2(f"{what} {side}", gg.indptr, msg, ints, k2, gg.split)
    split_cases = check_split_k2(np.random.default_rng(4), dev, k2)
    k3_split_cases = check_split_k3(np.random.default_rng(6), dev, k3)
    torch.cuda.synchronize()
    emit("gat_random", cases=cases, nodes=n, edges=g.num_edges,
         max_in_degree=int(g.in_degrees().max()), max_out_degree=int(g.out_degrees().max()),
         zero_in_degree_rows=int((g.in_degrees() == 0).sum()),
         k3_fwd_max_abs_err=k3["fwd"][0], k3_fwd_max_abs_err_f64=k3["fwd"][1],
         k3_fwd_max_bound_used=k3["fwd"][2], k3_bwd_max_abs_err=k3["bwd"][0],
         k3_bwd_max_abs_err_f64=k3["bwd"][1], k3_bwd_max_bound_used=k3["bwd"][2],
         k2_max_abs_err=k2[0], k2_max_abs_err_f64=k2[1], k2_max_bound_used=k2[2],
         k2_split_cases=split_cases, k3_split_cases=k3_split_cases, rtol=RTOL, atol=ATOL,
         hub_deg=HUB_DEG, deterministic=True, **_split_fields(g))


def _gat_graph(name, dev):
    """The graph main_gat builds: made bidirected where its dataset table
    says so (ogbn-arxiv), then self-loops on every graph."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.benchmarks.node_classification.main_gat import DATASET_CFG
    from dgl_tpu_torch.data import load_node_dataset
    from dgl_tpu_torch.graph import transforms

    data = load_node_dataset(name)
    src = torch.from_numpy(np.asarray(data.src, np.int64)).to(dev)
    dst = torch.from_numpy(np.asarray(data.dst, np.int64)).to(dev)
    if DATASET_CFG[name]["bidirect"]:  # on the card, as main_gat does
        src, dst = transforms.to_bidirected(src, dst, data.num_nodes)
    src, dst = transforms.add_self_loops(src, dst, data.num_nodes)
    return from_edges(src, dst, data.num_nodes, device=dev)


def timed_combines(wrapper, call, per_call, reps, warmup):
    """``call``'s median ms and the combine launches of its timed and
    warm-up calls, which must be ``per_call`` each."""
    before = wrapper.combines
    ms = median_ms(call, reps=reps, warmup=warmup)
    combines = wrapper.combines - before
    if combines != per_call * (reps + warmup):
        raise AssertionError(f"{wrapper.__name__}: {combines} combine launches in {reps + warmup} "
                             f"calls; want {per_call} a call")
    return ms, combines


def k3_shape(name, g, h, d, gen, keep):
    """Both K3 passes on graph ``g`` at H = h, D = d: check_k3_exact, the
    float64 checks, CUDA-event medians of each pass with its combines
    counted, the plain versions' times and the bytes bounds; b2's T sweep."""
    from dgl_tpu_torch.kernels.gat_attention import (
        B2_COMBINES, gat_attention_bwd, gat_attention_bwd_plain, gat_attention_fwd,
        gat_attention_fwd_plain)

    dev = g.indptr.device
    rev = g.reverse
    n, e = g.num_dst_nodes, g.num_edges
    check_k3_exact(name, g, h, d, gen)
    # v and g around 1 (see _inputs): a hub row's sums stay far from 0
    v, g_out = (1.0 + torch.randn(n, h, d, device=dev, generator=gen) for _ in range(2))
    a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
    kw = dict(negative_slope=0.2, keep=keep, seed=torch.tensor([20260], dtype=torch.int32,
                                                                device=dev))
    res = {}
    acc = [0.0, 0.0, 0.0]
    out, _, inv_s, _, shift = check_k3_fwd(name, g, v, a_s, a_d, kw, acc)
    fwd_args = (g.indptr, g.src, v, a_s, a_d)
    bound, by = k3_fwd_bound(n, n, e, h, d)
    ms, combines = timed_combines(
        gat_attention_fwd, lambda: gat_attention_fwd(*fwd_args, split=g.split, **kw),
        int(g.split.num_long > 0), reps=30, warmup=3)
    res["gat_attention_fwd"] = {
        "ms": ms, "combines_timed": combines,
        "plain_ms": median_ms(lambda: gat_attention_fwd_plain(*fwd_args, **kw), reps=5, warmup=1),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
        "max_row_nnz": int(g.in_degrees().max()),
        "split_T": g.split.t, "long_rows": g.split.num_long, "chunks": g.split.num_chunks,
        "t_sweep": t_sweep(lambda p: gat_attention_fwd(*fwd_args, split=p, **kw), g.indptr),
    }
    acc = [0.0, 0.0, 0.0]
    node = torch.stack([a_d, shift, inv_s, (g_out * out).sum(-1)], -1)
    del out, inv_s, shift
    check_k3_bwd(name, g, g_out, node, a_s, kw, acc)
    bwd_args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s)
    bound, by = k3_bwd_bound(n, n, e, h, d, dropout=keep < 1.0)
    ms, combines = timed_combines(
        gat_attention_bwd, lambda: gat_attention_bwd(*bwd_args, split=rev.split, **kw),
        B2_COMBINES * int(rev.split.num_long > 0), reps=20, warmup=2)
    res["gat_attention_bwd"] = {
        "ms": ms, "combines_timed": combines,
        "plain_ms": median_ms(lambda: gat_attention_bwd_plain(*bwd_args, **kw), reps=5, warmup=1),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
        "max_row_nnz": int(rev.in_degrees().max()),
        "split_T": rev.split.t, "long_rows": rev.split.num_long, "chunks": rev.split.num_chunks,
        "t_sweep": t_sweep(lambda p: gat_attention_bwd(*bwd_args, split=p, **kw), rev.indptr),
    }
    return res


def adjoint_times(g, w, gen):
    """gather_src_rows' adjoint on (E, w) cotangents, two ways: the port's
    one K1 launch over the reverse CSR indexed by rev.eid, and the JAX
    package's pairing, a permuting index_select and one K2 launch."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.seg_sum import seg_sum

    rev = g.reverse
    ge = 1.0 + torch.randn(g.num_edges, w, device=g.indptr.device, generator=gen)
    k1 = lambda: csr_spmm(rev.indptr, rev.eid, ge, split=rev.split)  # noqa: E731
    k2 = lambda: seg_sum(rev.indptr, ge.index_select(0, rev.eid), split=rev.split)  # noqa: E731
    a, b = k1(), k2()
    return {"w": w, "edges": g.num_edges, "k1_ms": median_ms(k1, reps=20, warmup=2),
            "index_select_k2_ms": median_ms(k2, reps=20, warmup=2),
            "bitwise_equal": torch.equal(a, b), "max_abs_diff": (a - b).abs().max().item()}


def fused_memory(g, gen):
    """The fused GATConv allocates no per-edge tensor: the device memory one
    forward and backward of a training-mode layer (16 → 16, and the narrow
    16 → 41) allocates above what is live before it is the same on the
    reddit graph with self-loops as on a graph of the same nodes with only
    the self-loops (E = N). An (E, 1) float32 buffer would differ by
    4·(E − N) bytes; the check allows half of that."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.nn import GATConv

    dev = g.indptr.device
    n = g.num_dst_nodes
    loops = from_edges(np.arange(n), np.arange(n), n, device=dev)
    x = (1.0 + torch.randn(n, 16, device=dev, generator=gen)).requires_grad_()
    extra = {}
    for out_feats in (16, 41):
        conv = GATConv(16, out_feats, 1, feat_drop=0.18, attn_drop=0.18, fused=True, device=dev,
                       generator=torch.Generator().manual_seed(out_feats))
        for name, gg in (("reddit", g), ("self_loops", loops)):
            def step():
                conv(gg, x, generator=gen).sum().backward()
                torch.cuda.synchronize()
                conv.zero_grad(set_to_none=True)
                x.grad = None
            step()  # warm-up: every lazy allocation happens here
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step()
            extra[f"{out_feats}_{name}"] = torch.cuda.max_memory_allocated() - base
    limit = 4 * (g.num_edges - n) // 2
    for out_feats in (16, 41):
        diff = extra[f"{out_feats}_reddit"] - extra[f"{out_feats}_self_loops"]
        if abs(diff) > limit:
            raise AssertionError(f"fused GATConv 16 → {out_feats} allocates {diff} B more on reddit "
                                 f"than on its self-loops alone (limit {limit} B): a per-edge buffer")
    return {"extra_bytes": extra, "limit_bytes": limit, "edges": g.num_edges, "nodes": n}


def fused_conv_no_host_sync(g, gen):
    """A fused GATConv's forward and backward (training mode: feature and
    attention dropout) under set_sync_debug_mode("error"): both K3 passes
    take the graph's plans, so nothing reads back from the card."""
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_fwd
    from dgl_tpu_torch.nn import GATConv

    dev = g.indptr.device
    n = g.num_dst_nodes
    conv = GATConv(16, 16, 1, feat_drop=0.18, attn_drop=0.18, fused=True, device=dev,
                   generator=torch.Generator().manual_seed(5))
    x = (1.0 + torch.randn(n, 16, device=dev, generator=gen)).requires_grad_()
    v, a = torch.ones(n, 1, 16, device=dev), torch.zeros(n, 1, device=dev)
    before = gat_attention_fwd.launches
    no_host_sync(lambda: conv(g, x, generator=gen).sum().backward(),
                 # no plan: built from indptr, a sync
                 lambda: gat_attention_fwd(g.indptr, g.src, v, a, a, negative_slope=0.2))
    if x.grad is None or gat_attention_fwd.launches != before + 1:
        raise AssertionError("the fused GATConv ran no K3 forward or gave no gradient under the "
                             "sync check")


def phase_gat_reddit():
    from dgl_tpu_torch.kernels.seg_sum import csr_rows, seg_sum, seg_sum_plain
    from dgl_tpu_torch.ops import seg_sum_dst

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = _gat_graph("reddit", dev)
    load_s = time.perf_counter() - t0
    rev = g.reverse
    n, e, h, d = g.num_dst_nodes, g.num_edges, 1, 16
    gen = torch.Generator(device=dev).manual_seed(2)
    res = k3_shape("reddit", g, h, d, gen, REDDIT_KEEP)
    fused_conv_no_host_sync(g, gen)
    # arxiv's 4-head shapes, D = 16 and the last layer's D = 40 (lane groups
    # of 4 and of 16): its dst CSR has long rows too, which the forward splits
    arxiv = _gat_graph("ogbn-arxiv", dev)
    res_arxiv = k3_shape("ogbn-arxiv", arxiv, 4, 16, gen, REDDIT_KEEP)
    res_arxiv40 = k3_shape("ogbn-arxiv D=40", arxiv, 4, 40, gen, REDDIT_KEEP)
    arxiv_fields = {"nodes": arxiv.num_dst_nodes, "edges": arxiv.num_edges, "heads": 4,
                    "d": [16, 40], **_split_fields(arxiv)}
    del arxiv
    msg = 1.0 + torch.randn(e, d, device=dev, generator=gen)
    ints = torch.randint(-4, 5, (e, d), device=dev, generator=gen).float()
    for side, gg in (("fwd", g), ("rev", rev)):
        indptr, acc = gg.indptr, [0.0, 0.0, 0.0]
        combines = seg_sum.combines
        got = check_k2(f"reddit {side}", indptr, msg, ints, acc, gg.split)
        if seg_sum.combines - combines != 3 * int(gg.split.num_long > 0):
            raise AssertionError(f"reddit {side}: {gg.split.num_long} long rows but "
                                 f"{seg_sum.combines - combines} K2 combine launches in three runs")
        offsets = indptr.long()
        rows = csr_rows(indptr, e)  # index_add_'s row ids, made outside the timed calls
        lib = torch.segment_reduce(msg, "sum", offsets=offsets)
        bound, by = k2_bound(n, e, d)
        r = res[f"seg_sum_{side}"] = {
            "ms": median_ms(lambda: seg_sum(indptr, msg, split=gg.split), reps=20, warmup=2),
            "plain_ms": median_ms(lambda: seg_sum_plain(indptr, msg), reps=5, warmup=1),
            "library_ms": median_ms(lambda: torch.segment_reduce(msg, "sum", offsets=offsets),
                                    reps=20, warmup=2),
            "index_add_ms": median_ms(lambda: torch.zeros(n, d, device=dev).index_add_(0, rows, msg),
                                      reps=20, warmup=2),
            "library_max_abs_err_vs_kernel": (lib - got).abs().max().item(),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
            "max_row_nnz": int((indptr[1:] - indptr[:-1]).max()),
            "split_T": gg.split.t, "long_rows": gg.split.num_long, "chunks": gg.split.num_chunks,
            "t_sweep": t_sweep(lambda p: seg_sum(indptr, msg, split=p), indptr),
        }
        r["at_or_below_segment_reduce"] = r["ms"] <= r["library_ms"]
        r["at_or_below_index_add"] = r["ms"] <= r["index_add_ms"]
        del rows
    # seg_sum_dst's forward and backward on the card read nothing back: no host sync
    mk = msg.clone().requires_grad_()
    cot = torch.randn(n, d, device=dev, generator=gen)
    no_host_sync(lambda: seg_sum_dst(g, mk).backward(cot),
                 lambda: seg_sum(g.indptr, msg))  # no plan: built from indptr, a sync
    if mk.grad is None:
        raise AssertionError("seg_sum_dst's backward gave no gradient under the sync check")
    del msg, ints, mk
    adjoint = {"reddit": adjoint_times(g, d, gen),
               "pubmed": adjoint_times(_gat_graph("pubmed", dev), 64, gen)}
    memory = fused_memory(g, gen)
    emit("gat_reddit", nodes=n, edges=e, heads=h, d=d, keep=REDDIT_KEEP, load_s=load_s,
         gather_adjoint=adjoint, fused_memory=memory, no_host_sync=True,
         fused_conv_no_host_sync=True, **_split_fields(g),
         seg_sum_fwd_index_add_ms=res["seg_sum_fwd"]["index_add_ms"],
         seg_sum_rev_index_add_ms=res["seg_sum_rev"]["index_add_ms"],
         seg_sum_fwd_library_ms=res["seg_sum_fwd"]["library_ms"],
         seg_sum_rev_library_ms=res["seg_sum_rev"]["library_ms"],
         k3_library="none: no single PyTorch call computes the fused attention",
         **{f"{k}_ms": r["ms"] for k, r in res.items()},
         **{f"{k}_ms_arxiv": r["ms"] for k, r in res_arxiv.items()},
         **{f"{k}_ms_arxiv_d40": r["ms"] for k, r in res_arxiv40.items()},
         k3_b2_t_sweep=res["gat_attention_bwd"]["t_sweep"],
         k3_fwd_t_sweep_arxiv=res_arxiv["gat_attention_fwd"]["t_sweep"],
         arxiv=arxiv_fields, detail=res, detail_arxiv=res_arxiv, detail_arxiv_d40=res_arxiv40)
    return res, res_arxiv, res_arxiv40, g


# -- P1 and P2: the row gather ----------------------------------------------

def gather_bound(idx, row_bytes):
    """Least time (ms) of ``x[idx]``: the rows idx touches read once, idx
    read once and the output written once; and the same with all E rows
    read, as the kernels read them (``bound_ms_e_rows``)."""
    e, ib = idx.numel(), idx.element_size()
    touched = torch.unique(idx).numel()
    bound, by = _bound_ms(touched * row_bytes + e * ib + e * row_bytes, 0)
    return bound, by, _bound_ms(2 * e * row_bytes + e * ib, 0)[0]


def check_row_gather(gen):
    """P1 and P2 against x[idx], bit for bit, on every path the kernels
    have: float32 and bfloat16, int32 and int64 indices, ragged e, copies of
    16, 8, 4 and 2 bytes (rows of 41 bfloat16 values; x shifted off its
    alignment), P1's staged pieces (1 KB rows) and column pieces (40 KB
    rows), P2 up to and at its shared-memory limit; then P2's refusal
    above the limit, before any launch. Returns the number of cases."""
    from dgl_tpu_torch.kernels.row_gather import (
        SMEM_LIMIT_BYTES, row_gather_async, row_gather_plain, row_gather_smem)

    dev = torch.device("cuda")
    cases = 0

    def hold(what, fn, x, idx, tile):
        nonlocal cases
        got = fn(x, idx, tile=tile)
        if not torch.equal(got, row_gather_plain(x, idx)):
            bad = int((got != row_gather_plain(x, idx)).flatten(1).any(1).nonzero()[0])
            raise AssertionError(f"{what} tile={tile}: row {bad} differs from x[idx]")
        if not torch.equal(got, fn(x, idx, tile=tile)):
            raise AssertionError(f"{what} tile={tile}: two runs differ")
        cases += 1

    def inputs(n, d, e, dtype, shift=0):
        base = torch.randn(n * d + shift, device=dev, generator=gen).to(dtype)
        idx = torch.randint(0, n, (e,), device=dev, generator=gen)
        idx[: min(e, 64)] = n - 1  # the last row, and one row read many times
        return base[shift:].view(n, d), idx

    # (n, d, e, tiles) for P1 and P2; every e is ragged against every tile
    p1 = [(5000, 16, 100_003, (128, 256)), (3000, 41, 77_777, (128, 256)),
          (2000, 256, 10_001, (128, 256)), (300, 10_000, 1_001, (1, 256)),
          (1000, 1, 5_003, (256, 1000))]
    p2 = [(2708, 16, 100_003, (512, 2048)), (500, 41, 77_777, (512, 100)),
          (227, 256, 10_001, (512, 2048))]  # 227 rows of 1 KB: exactly the limit
    for fn, shapes in ((row_gather_async, p1), (row_gather_smem, p2)):
        for n, d, e, tiles in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x, idx = inputs(n, d, e, dtype)
                for ii in (idx.int(), idx):
                    for tile in tiles:
                        hold(f"{fn.__name__} ({n}, {d}) {dtype} e={e} {ii.dtype}", fn, x, ii, tile)
    for fn in (row_gather_async, row_gather_smem):  # x 8 and 4 bytes off 16-byte alignment
        for shift in (2, 1):
            x, idx = inputs(2708, 16, 50_001, torch.float32, shift)
            hold(f"{fn.__name__} x shifted by {shift} floats", fn, x, idx.int(), 512)
    x, idx = inputs(228, 256, 1000, torch.float32)
    before = row_gather_smem.launches
    try:
        row_gather_smem(x, idx)
    except ValueError as ex:
        if row_gather_smem.launches != before or str(SMEM_LIMIT_BYTES) not in str(ex):
            raise AssertionError(f"P2's refusal launched or does not name the limit: {ex}")
    else:
        raise AssertionError("row_gather_smem took an x above its shared-memory limit")
    torch.cuda.synchronize()
    return cases


def phase_row_gather(red, red_graph, gred, gat_graph):
    """P1 and P2 checked, the probe run as the path's main path, and the
    gather floor of K1 and K3 measured on their own index streams."""
    from dgl_tpu_torch.kernels.row_gather import row_gather_async, row_gather_plain, row_gather_smem
    from dgl_tpu_torch.tools import exp_dma_gather
    from dgl_tpu_torch.train.timing import device_profile

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = check_row_gather(gen)

    # the main path: the probe, each run with the counters set to 0 before it
    probe, launches = {}, {}
    for key, argv in (("default", []), ("cora_d16", ["--n", "2708", "--d", "16"])):
        torch.cuda.synchronize()
        row_gather_async.launches = row_gather_smem.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            lines = exp_dma_gather.main(argv)
        launches[key] = {"row_gather_async": row_gather_async.launches,
                         "row_gather_smem": row_gather_smem.launches}
        probe[key] = {"stdout": log.getvalue().splitlines(), "lines": lines}
        # only P2's refusal of the default 173 MB x may fail, at both tiles
        failed = [ln for ln in lines if "failed" in ln]
        if len(lines) != 6 or len(failed) != (2 if key == "default" else 0) or not all(
                ln["name"] == "row_gather_smem" and ln["failed"].startswith("ValueError")
                for ln in failed):
            raise AssertionError(f"probe {key}: unexpected lines {lines}")
        if any(ln["maxerr"] != 0.0 for ln in lines if "maxerr" in ln):
            raise AssertionError(f"probe {key}: a gather differs from x[idx]: {lines}")
        torch.cuda.empty_cache()
    want = {"default": {"row_gather_async": 18, "row_gather_smem": 0},
            "cora_d16": {"row_gather_async": 18, "row_gather_smem": 18}}
    if launches != want:  # per tile: 1 checked call, 2 cold, 6 timed
        raise AssertionError(f"probe launches {launches}; want {want}")

    # the gather floor on the kernels' own index streams
    pubmed = _gat_graph("pubmed", dev)
    tool_x, tool_idx = exp_dma_gather.make_inputs(169343, 256, 2332486, torch.float32, dev)
    streams = {  # name: (idx, n, d, the kernel that gathers these rows, its ms)
        "k1_fwd": (red_graph.src, red_graph.num_src_nodes, 16, "K1 forward", red["fwd"]["kernel_ms"]),
        "k1_bwd": (red_graph.reverse.src, red_graph.num_dst_nodes, 16, "K1 backward",
                   red["bwd"]["kernel_ms"]),
        "k3_fwd": (gat_graph.src, gat_graph.num_src_nodes, 16, "K3 forward",
                   gred["gat_attention_fwd"]["ms"]),
        # b2 gathers g's rows by each reverse slot's original dst
        "k3_b2": (gat_graph.reverse.src, gat_graph.num_dst_nodes, 16, "K3 b2",
                  gred["gat_attention_bwd"]["ms"]),
        "gather_src_rows": (pubmed.src, pubmed.num_src_nodes, 64, "gather_src_rows (index_select)",
                            None),
        "tool_default": (tool_idx, 169343, 256, None, None),
    }
    floors = {}
    for key, (idx, n, d, kernel, kernel_ms) in streams.items():
        x = tool_x if key == "tool_default" else torch.randn(n, d, device=dev, generator=gen)
        buf = torch.empty(idx.numel(), d, device=dev)
        got = row_gather_async(x, idx)
        if not torch.equal(got, x.index_select(0, idx)):
            raise AssertionError(f"{key}: P1 differs from index_select")
        del got
        p1 = {tile: median_ms(lambda: row_gather_async(x, idx, tile=tile), reps=20, warmup=3)
              for tile in (128, 256)}
        lib = median_ms(lambda: x.index_select(0, idx), reps=20, warmup=3)
        idx64 = idx.long()
        lib64 = median_ms(lambda: x.index_select(0, idx64), reps=20, warmup=3)
        fill = median_ms(lambda: buf.fill_(1.0), reps=20, warmup=3)
        # an event pair around one call also spans the wrapper's host work,
        # which a small gather (pubmed's) does not hide: the profiler's
        # device time per call beside it
        busy = {name: device_profile(fn, 20, dev)["device_busy_ms_per_epoch"] for name, fn in (
            ("p1", lambda: row_gather_async(x, idx)), ("index_select", lambda: x.index_select(0, idx)),
            ("fill", lambda: buf.fill_(1.0)))}
        bound, by, bound_rows = gather_bound(idx, 4 * d)
        floors[key] = {
            "rows": idx.numel(), "n": n, "d": d, "p1_ms_tile128": p1[128], "p1_ms_tile256": p1[256],
            "index_select_ms": lib, "index_select_int64_ms": lib64, "fill_ms": fill,
            # the time to read the indexed rows alone: P1 (its faster tile) less the write
            "gather_floor_ms": min(p1.values()) - fill,
            "p1_device_ms": busy["p1"], "index_select_device_ms": busy["index_select"],
            "fill_device_ms": busy["fill"], "gather_floor_device_ms": busy["p1"] - busy["fill"],
            "bound_ms": bound, "bound_ms_e_rows": bound_rows,
            "kernel": kernel, "kernel_ms": lib if key == "gather_src_rows" else kernel_ms,
        }
        if key == "tool_default":
            floors[key]["plain_ms"] = median_ms(lambda: row_gather_plain(x, idx), reps=10, warmup=2)
            floors[key]["bound_by"] = by
        del buf, idx64
    del tool_x, tool_idx

    # P2 where it fits: cora's node count at reddit's width, reddit's indices
    idx = red_graph.src % 2708
    x = torch.randn(2708, 16, device=dev, generator=gen)
    ref = x.index_select(0, idx)
    got = row_gather_smem(x, idx)
    err = (got - ref).abs().max().item()
    if not torch.equal(got, ref):
        raise AssertionError("P2 on reddit's indices mod 2708 differs from index_select")
    bound, by, bound_rows = gather_bound(idx, 64)
    smem = {
        "rows": idx.numel(), "n": 2708, "d": 16, "max_abs_err": err,
        "ms": median_ms(lambda: row_gather_smem(x, idx), reps=20, warmup=3),
        "ms_tile2048": median_ms(lambda: row_gather_smem(x, idx, tile=2048), reps=20, warmup=3),
        "p1_ms": median_ms(lambda: row_gather_async(x, idx), reps=20, warmup=3),
        "plain_ms": median_ms(lambda: row_gather_plain(x, idx), reps=20, warmup=3),
        "library_ms": median_ms(lambda: x.index_select(0, idx), reps=20, warmup=3),
        "bound_ms": bound, "bound_by": by, "bound_ms_e_rows": bound_rows,
    }
    emit("row_gather", seconds=time.perf_counter() - t0, cases=cases, launches=launches,
         probe=probe, gather_floor=floors, smem_2708x16=smem,
         **{f"gather_floor_ms_{k}": f["gather_floor_ms"] for k, f in floors.items()})
    default = floors["tool_default"]
    return floors, {
        "row_gather_async": {
            "launches": launches["default"]["row_gather_async"], "max_abs_err": max(
                ln["maxerr"] for ln in probe["default"]["lines"] if ln["name"] == "row_gather_async"),
            "ms": default["p1_ms_tile256"], "plain_ms": default["plain_ms"],
            "library_ms": default["index_select_ms"], "bound_ms": default["bound_ms"],
            "bound_by": default["bound_by"], "bound_ms_e_rows": default["bound_ms_e_rows"],
            "shape": f"x (169343, 256) float32, e = {default['rows']} (the probe's default), "
                     "tile 256",
        },
        "row_gather_smem": {
            "launches": launches["cora_d16"]["row_gather_smem"], "max_abs_err": smem["max_abs_err"],
            "ms": smem["ms"], "plain_ms": smem["plain_ms"], "library_ms": smem["library_ms"],
            "bound_ms": smem["bound_ms"], "bound_by": smem["bound_by"],
            "bound_ms_e_rows": smem["bound_ms_e_rows"],
            "shape": f"x (2708, 16) float32, reddit's {smem['rows']} indices mod 2708, tile 512 "
                     "(the probe's default x, 173 MB, does not fit)",
        },
    }


def phase_gat_main():
    """main_gat's three paths, each with every counter set to 0 just
    before it and read just after it.

    reddit and ogbn-arxiv run the fused form: one K3 forward and one b2 call
    a layer and step, no K1 or K2. A forward call combines once when the dst
    CSR has long rows (arxiv's), a b2 call B2_COMBINES times when the
    reverse CSR has (both graphs').

    pubmed runs the edge form; its launches per step, from the code
    (ops/gather.py, ops/softmax.py, nn/conv.py), for each of its 3 layers:
      K2 forward: edge_softmax's seg_sum_dst (1) and gspmm(copy_e, sum) (1);
      K2 backward: spread_dst's adjoint in edge_softmax (1);
      K1 backward: gather_src_rows' adjoint over the reverse CSR (1);
      (gather_dst and gspmm's copy_e adjoint are row gathers, no kernel)
    = 3 K2 and 1 K1 per layer, 9 K2 and 3 K1 per step. A rescue in
    edge_softmax (every term of a row underflowed under the loose bound)
    adds one forward K2 launch: the exact form's seg_sum_dst; its backward
    replaces the loose form's.

    The reddit run's device memory is read from the start of training
    (``train_peak_bytes`` above ``setup_bytes``): what the steps add beyond
    the graph and the data must stay below one (E, 16) float32 buffer;
    fused_memory (phase gat_reddit) is the check that sees an (E, 1) one.
    """
    from dgl_tpu_torch.benchmarks.node_classification import main_gat
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.gat_attention import B2_COMBINES, gat_attention_bwd, gat_attention_fwd
    from dgl_tpu_torch.kernels.seg_sum import seg_sum
    from dgl_tpu_torch.ops.softmax import edge_softmax

    counters = {"csr_spmm": csr_spmm, "gat_attention_fwd": gat_attention_fwd,
                "gat_attention_bwd": gat_attention_bwd, "seg_sum": seg_sum}
    steps = {"reddit": 8, "ogbn-arxiv": 10, "pubmed": 30}
    res, launches, rescues, combines = {}, {}, {}, {}
    for ds in steps:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = fn.combines = 0
        edge_softmax.rescues = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            r = main_gat.run(ds, epochs=steps[ds], runs=1, device="cuda")
        launches[ds] = {k: fn.launches for k, fn in counters.items()}
        combines[ds] = {k: fn.combines for k, fn in counters.items()}
        rescues[ds] = edge_softmax.rescues
        res[ds] = r
        if "Training time/epoch" not in log.getvalue():
            raise AssertionError(f"{ds}: the driver printed no 'Training time/epoch' line")
    # the plans of the graphs main_gat built, built again here
    graphs = {ds: _gat_graph(ds, torch.device("cuda")) for ds in steps}
    plans = {ds: _split_fields(gg) for ds, gg in graphs.items()}
    want_l, want_c = {}, {}
    for ds in ("reddit", "ogbn-arxiv"):
        s, gg = steps[ds], graphs[ds]
        want_l[ds] = {"csr_spmm": 0, "gat_attention_fwd": 3 * s, "gat_attention_bwd": 3 * s,
                      "seg_sum": 0}
        want_c[ds] = {"csr_spmm": 0, "gat_attention_fwd": 3 * s * int(gg.split.num_long > 0),
                      "gat_attention_bwd": B2_COMBINES * 3 * s * int(gg.reverse.split.num_long > 0),
                      "seg_sum": 0}
    s, pub = steps["pubmed"], graphs["pubmed"]
    want_l["pubmed"] = {"csr_spmm": 3 * s, "gat_attention_fwd": 0, "gat_attention_bwd": 0,
                        "seg_sum": 9 * s + rescues["pubmed"]}
    # K1's launches (the gather adjoint) run over pubmed's reverse CSR, whose
    # long rows each take a combine; K2 runs over the dst CSR, which has none
    want_c["pubmed"] = {"csr_spmm": 3 * s * int(pub.reverse.split.num_long > 0),
                        "gat_attention_fwd": 0, "gat_attention_bwd": 0,
                        "seg_sum": (9 * s + rescues["pubmed"]) * int(pub.split.num_long > 0)}
    del graphs, pub
    if launches != want_l:
        raise AssertionError(f"launches {launches}; want {want_l}")
    if combines != want_c:
        raise AssertionError(f"combine launches {combines}; want {want_c}")
    for ds in res:
        losses = res[ds]["losses"][0]
        tail = statistics.mean(losses[-5:])
        if not tail < losses[0]:
            raise AssertionError(f"{ds} loss did not fall: {losses}")
    # the fused training steps keep no (E, H, D) tensor
    n, e = 232_965, res["reddit"]["num_edges"]
    train_extra = {ds: res[ds]["train_peak_bytes"] - res[ds]["setup_bytes"] for ds in res}
    edge_buffer = 4 * e * 16
    if not train_extra["reddit"] < edge_buffer:
        raise AssertionError(f"reddit fused training adds {train_extra['reddit']} B to the "
                             f"{res['reddit']['setup_bytes']} B of its graph and data: an (E, 16) "
                             f"buffer ({edge_buffer} B) or more")
    emit("gat_main", device=res["reddit"]["device"], synthetic=res["reddit"]["synthetic"],
         **{f"{k}_epoch_s": res[ds]["epoch_s"] for ds, k in _GAT_KEYS.items()},
         **{f"{k}_epochs_s": res[ds]["epochs_s"] for ds, k in _GAT_KEYS.items()},
         **{f"{k}_setup_s": res[ds]["setup_s"] for ds, k in _GAT_KEYS.items()},
         **{f"{k}_losses": res[ds]["losses"][0] for ds, k in _GAT_KEYS.items()},
         steps=steps, launches=launches, combines=combines, pubmed_rescues=rescues["pubmed"],
         splits=plans, pubmed_k2_per_step_derived=9, pubmed_k1_per_step_derived=3,
         reddit_setup_bytes=res["reddit"]["setup_bytes"],
         reddit_train_peak_bytes=res["reddit"]["train_peak_bytes"],
         reddit_train_extra_bytes=train_extra["reddit"],
         reddit_train_extra_floats_per_node=train_extra["reddit"] / (4 * n),
         arxiv_train_extra_bytes=train_extra["ogbn-arxiv"],
         pubmed_setup_bytes=res["pubmed"]["setup_bytes"],
         pubmed_train_peak_bytes=res["pubmed"]["train_peak_bytes"],
         reddit_edge_buffer_bytes=edge_buffer,
         **{f"{k}_edges": res[ds]["num_edges"] for ds, k in _GAT_KEYS.items()})
    return launches, combines


_GAT_KEYS = {"reddit": "reddit", "ogbn-arxiv": "arxiv", "pubmed": "pubmed"}


# -- SAGE on arxiv and products: the suite's driver, K1 at new widths -------

SAGE_EPOCHS = {"ogbn-arxiv": 10, "ogbn-products": 5}
SAGE_LOSS_ATOL = 1e-4  # first-step loss: hoisted vs unhoisted, scatter vs fused


def sage_k1_launches(in_feats, hidden, classes, layers, hoisted):
    """K1's launches in one training step of GraphSAGE, from the code
    (nn/conv.py:SAGEConv, ops/spmm.py): a layer with out < in projects first
    and aggregates at out, else it aggregates its input at in; each
    aggregation is one forward launch over the dst CSR and, where what it
    aggregates needs a gradient, one backward launch over the reverse CSR.
    Layer 1's input is data, so aggregated first it has no backward; hoisted,
    layer 1 aggregates nothing (x_agg is one launch before training).
    Returns [(layer, "fwd" | "bwd", D), ...]."""
    out = []
    for i in range(layers):
        d_in = in_feats if i == 0 else hidden
        d_out = classes if i == layers - 1 else hidden
        if i == 0 and hoisted:
            continue
        project_first = d_out < d_in
        width = d_out if project_first else d_in
        out.append((i, "fwd", width))
        if project_first or i > 0:
            out.append((i, "bwd", width))
    return out


def _sage_graph(name, dev):
    """The graph main_sage builds: bidirected where its table says so, no
    self-loops; and the dataset."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.benchmarks.node_classification.main_sage import DATASET_CFG
    from dgl_tpu_torch.data import load_node_dataset
    from dgl_tpu_torch.graph import transforms

    data = load_node_dataset(name)
    src = torch.from_numpy(np.asarray(data.src, np.int64)).to(dev)
    dst = torch.from_numpy(np.asarray(data.dst, np.int64)).to(dev)
    if DATASET_CFG[name]["bidirect"]:  # on the card, as main_sage does
        src, dst = transforms.to_bidirected(src, dst, data.num_nodes)
    return from_edges(src, dst, data.num_nodes, device=dev), data


def reference64_sparse(indptr, indices, x, n_src, mean):
    """Float64 sums of a CSR SpMM and of its absolute terms through a
    float64 torch.sparse.mm: no (E, D) buffer, so it serves products."""
    crow, col = indptr.long(), indices.long()
    a = torch.sparse_csr_tensor(crow, col, torch.ones(col.numel(), dtype=torch.float64,
                                                      device=x.device),
                                size=(indptr.numel() - 1, n_src), check_invariants=False)
    x64 = x.double()
    want, mag = torch.sparse.mm(a, x64), torch.sparse.mm(a, x64.abs())
    if mean:
        inv = 1.0 / (indptr[1:] - indptr[:-1]).clamp(min=1).double().unsqueeze(1)
        want, mag = want * inv, mag * inv
    return want, mag


def k1_width(name, gg, d, mean, gen, plain, by_eid=False):
    """K1 over one CSR at width d: held to float64 sums (and to the plain
    version where ``plain``), CUDA-event medians of the kernel, the plain
    version and torch.sparse.mm at the same shape, and the bytes bound.
    ``by_eid``: the CSR's eid is the index into (E, d) rows, as
    gather_src_rows' adjoint launches K1 over the reverse CSR."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    n_rows, e = gg.num_dst_nodes, gg.num_edges
    idx, n_src = (gg.eid, e) if by_eid else (gg.src, gg.num_src_nodes)
    x = 1.0 + torch.randn(n_src, d, device=gg.indptr.device, generator=gen)
    kern = lambda: csr_spmm(gg.indptr, idx, x, mean=mean, split=gg.split)  # noqa: E731
    got = kern()
    if not torch.equal(got, kern()):
        raise AssertionError(f"{name} D={d}: two K1 runs differ")
    p = csr_spmm_plain(gg.indptr, idx, x, mean=mean) if plain else None
    err, err64, used = check(f"{name} D={d}", got, gg.indptr,
                             reference64_sparse(gg.indptr, idx, x, n_src, mean), p)
    del got, p
    a = torch.sparse_csr_tensor(gg.indptr.long(), idx.long(),
                                torch.ones(e, device=x.device), size=(n_rows, n_src),
                                check_invariants=False)
    bound, by = spmm_bound(n_rows, n_src, e, d, 4)
    return {"d": d, "mean": mean, "ms": median_ms(kern, reps=20, warmup=3),
            "plain_ms": (median_ms(lambda: csr_spmm_plain(gg.indptr, idx, x, mean=mean),
                                   reps=5, warmup=1) if plain else None),
            "library_ms": median_ms(lambda: torch.sparse.mm(a, x), reps=20, warmup=3),
            "bound_ms": bound, "bound_by": by, "max_abs_err": err, "max_abs_err_f64": err64,
            "max_bound_used": used}


def phase_sage_main():
    """main_sage on ogbn-arxiv (3 layers, hidden 256, BN, bidirected) and
    full ogbn-products (3 layers, hidden 64, bidirected), each hoisted and
    unhoisted, arxiv also with lowering="scatter", every counter set to 0
    before a run and read after it. K1's launches are sage_k1_launches per
    step (+1 hoisted), scatter's none; each launch over a CSR with long rows
    combines once. Losses finite and falling; the modes agree on the first
    step's loss. Then K1 at each width the runs launched it, forward (mean,
    dst CSR) and backward (sum, reverse CSR), against float64 sums,
    torch.sparse.mm and its bound (the plain version on arxiv only: on
    products its (E, D) buffer is 32–50 GB)."""
    from dgl_tpu_torch.benchmarks.node_classification import main_sage
    from dgl_tpu_torch.data import NODE_DATASET_STATS
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    res, launches, combines, want_l, want_c, plans, widths = {}, {}, {}, {}, {}, {}, {}
    for ds, epochs in SAGE_EPOCHS.items():
        cfg = main_sage.DATASET_CFG[ds]
        _, _, feat, classes = NODE_DATASET_STATS[ds]
        modes = {"hoisted": (True, "fused"), "unhoisted": (False, "fused")}
        if ds == "ogbn-arxiv":
            modes["scatter"] = (False, "scatter")
        for mode, (hoist, lowering) in modes.items():
            torch.cuda.synchronize()
            csr_spmm.launches = csr_spmm.combines = 0
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                r = main_sage.run(ds, epochs=epochs, runs=1, device="cuda", precompute=hoist,
                                  lowering=lowering)
            r["run_s"] = time.perf_counter() - t0
            launches[(ds, mode)], combines[(ds, mode)] = csr_spmm.launches, csr_spmm.combines
            if "Training time/epoch" not in log.getvalue():
                raise AssertionError(f"{ds} {mode}: no 'Training time/epoch' line")
            res[(ds, mode)] = r
            torch.cuda.empty_cache()
        g, _ = _sage_graph(ds, dev)
        plans[ds] = _split_fields(g)
        fwd_long, rev_long = int(g.split.num_long > 0), int(g.reverse.split.num_long > 0)
        for mode, (hoist, lowering) in modes.items():
            steps = len(res[(ds, mode)]["losses"][0])
            per_step = sage_k1_launches(feat, cfg["hidden"], classes, cfg["layers"], hoist)
            n_fwd = sum(side == "fwd" for _, side, _ in per_step) * steps + int(hoist)
            n_bwd = sum(side == "bwd" for _, side, _ in per_step) * steps
            if lowering == "scatter":
                n_fwd = n_bwd = 0
            want_l[(ds, mode)] = n_fwd + n_bwd
            want_c[(ds, mode)] = n_fwd * fwd_long + n_bwd * rev_long
        ds_widths = sorted({d for _, _, d in sage_k1_launches(feat, cfg["hidden"], classes,
                                                               cfg["layers"], False)}
                           | {feat})
        widths[ds] = {}
        for d in ds_widths:
            widths[ds][d] = {
                "fwd": k1_width(f"{ds} fwd", g, d, True, gen, plain=ds == "ogbn-arxiv"),
                "bwd": k1_width(f"{ds} bwd", g.reverse, d, False, gen, plain=ds == "ogbn-arxiv"),
            }
        del g
        torch.cuda.empty_cache()
    if launches != want_l:
        raise AssertionError(f"K1 launches {launches}; want {want_l}")
    if combines != want_c:
        raise AssertionError(f"K1 combines {combines}; want {want_c}")
    for key, r in res.items():
        losses = r["losses"][0]
        if not statistics.mean(losses[-3:]) < losses[0]:
            raise AssertionError(f"{key} loss did not fall: {losses}")
    for ds in SAGE_EPOCHS:
        first = {mode: r["losses"][0][0] for (d, mode), r in res.items() if d == ds}
        if max(abs(v - first["unhoisted"]) for v in first.values()) > SAGE_LOSS_ATOL:
            raise AssertionError(f"{ds}: first-step losses differ: {first}")
    key = lambda ds, mode: f"{ds.removeprefix('ogbn-')}_{mode}"  # noqa: E731
    fields = ("run_s", "load_s", "setup_s", "precompute_s", "epoch_s", "epochs_s", "setup_bytes",
              "train_peak_bytes", "num_edges")
    emit("sage_main", seconds=time.perf_counter() - t_phase, device=res[("ogbn-arxiv", "hoisted")]["device"],
         synthetic=res[("ogbn-arxiv", "hoisted")]["synthetic"], epochs=SAGE_EPOCHS,
         **{key(*k): {f: r[f] for f in fields} | {"losses": r["losses"][0],
                                                  "launches": launches[k], "combines": combines[k]}
            for k, r in res.items()},
         splits=plans, first_step_atol=SAGE_LOSS_ATOL,
         k1_widths={ds: {str(d): w for d, w in v.items()} for ds, v in widths.items()})
    return launches, combines, widths


# -- graph classification: GCN on ENZYMES, molhiv and ppa ------------------

GC_RUNS = {  # key: (dataset, lowering, num_graphs, epochs)
    "enzymes": ("ENZYMES", "fused", None, 5),
    "molhiv": ("ogbg-molhiv", "fused", None, 3),
    "molhiv_scatter": ("ogbg-molhiv", "scatter", None, 3),
    "ppa": ("ogbg-ppa", "fused", 2000, 3),
}
GC_PROFILE_STEPS = 64  # molhiv's profiled window: its idle share, not a whole epoch's trace


def gc_per_step(dataset, lowering):
    """K1 and K2 launches in one training step, from the code (nn/conv.py,
    ops/sddmm.py, graph/batch.py). ENZYMES: 4 GCNConv, each a forward K1
    and, as W x needs a gradient, a backward K1; the mean readout one K2 (its
    backward is a row gather). molhiv and ppa: 5 GCNConvEdge, each
    gsddmm(copy_u)'s adjoint, one K1, and fused one K2 for gspmm(copy_e,
    sum) (backward a row gather; scatter: index_add_, no kernel); the
    readout one K2. norm = gsddmm(mul, c, c) needs no gradient: no launch."""
    if dataset == "ENZYMES":
        return {"csr_spmm": 8, "seg_sum": 1}
    return {"csr_spmm": 5, "seg_sum": 6 if lowering == "fused" else 1}


def _gc_long_rows(dataset, num_graphs):
    """The longest row any batch's CSRs or readout can hold: a batch is a
    block-diagonal union, so its rows are its members' in- and out-degree
    rows and its readout rows their node counts."""
    from dgl_tpu_torch.data import load_graph_dataset

    data = load_graph_dataset(dataset, num_graphs=num_graphs)
    return max(max(np.bincount(d, minlength=n).max(), np.bincount(s, minlength=n).max(), n)
               for s, d, n in data.graphs)


def _gc_batch(dataset, with_edge_feats):
    """The first batch of 64 graphs, unshuffled, on the card."""
    from dgl_tpu_torch.data import load_graph_dataset
    from dgl_tpu_torch.sampling import GraphBatchLoader

    data = load_graph_dataset(dataset, num_graphs=64)
    batch, _, _, _ = next(iter(GraphBatchLoader(
        data.graphs, data.node_feats, data.labels, 64, shuffle=False, device="cuda",
        edge_feats=data.edge_feats if with_edge_feats else None)))
    return batch


def gc_kernel_checks(gen):
    """K1 and K2 at graph classification's own shapes, on one batch of 64
    graphs, each held to the plain version and to float64 sums, and timed
    beside the plain version, a library call and the bound. K2 on a molhiv
    batch at D = 256: the mean and sum readouts (the batch's node ranges)
    and gspmm(copy_e, sum) ((E, 256) over the dst CSR; also on small
    integers, bit for bit). K1 on the same batch at D = 256: the
    gsddmm(copy_u) adjoint (the reverse CSR indexed by eid, what GCNConvEdge
    launches) and a copy_u sum over the dst CSR; and on an ENZYMES batch at
    D = 128 GCNConv's forward (dst CSR) and backward (reverse CSR). Returns
    the K2 fields and {dataset: {d: {side: k1_width}}}."""
    from dgl_tpu_torch.graph import readout
    from dgl_tpu_torch.kernels.seg_sum import csr_rows, seg_sum, seg_sum_plain

    batch = _gc_batch("ogbg-molhiv", True)
    ip = batch.graph_indptr
    x = 1.0 + torch.randn(batch.graph.num_dst_nodes, 256, device=ip.device, generator=gen)
    acc = [0.0, 0.0, 0.0]
    cnt = (ip[1:] - ip[:-1]).clamp(min=1).double().unsqueeze(1)
    for op in ("sum", "mean"):
        scale = 1.0 if op == "sum" else 1.0 / cnt
        want = (seg_sum_plain(ip, x.double()) * scale, seg_sum_plain(ip, x.double().abs()) * scale)
        plain = seg_sum_plain(ip, x) * (1.0 if op == "sum" else (1.0 / cnt).float())
        _merge(acc, [check(f"molhiv readout {op}", readout(batch, x, op), ip, want, plain,
                           slack=(2, 8))])
    g = batch.graph
    msg = 1.0 + torch.randn(g.num_edges, 256, device=ip.device, generator=gen)
    ints = torch.randint(-4, 5, (g.num_edges, 256), device=ip.device, generator=gen).float()
    acc_e = [0.0, 0.0, 0.0]
    check_k2("molhiv copy_e", g.indptr, msg, ints, acc_e, g.split)
    times = {}
    for name, (indptr, m, split) in {"readout": (ip, x, batch.graph_split),
                                     "copy_e": (g.indptr, msg, g.split)}.items():
        rows = csr_rows(indptr, m.shape[0])
        n_rows = indptr.numel() - 1
        bound, by = k2_bound(n_rows, m.shape[0], 256)
        times[name] = {
            "rows": n_rows, "edges": m.shape[0],
            "ms": median_ms(lambda: seg_sum(indptr, m, split=split), reps=30, warmup=3),
            "plain_ms": median_ms(lambda: seg_sum_plain(indptr, m), reps=30, warmup=3),
            "index_add_ms": median_ms(
                lambda: torch.zeros(n_rows, 256, device=ip.device).index_add_(0, rows, m),
                reps=30, warmup=3),
            "bound_ms": bound, "bound_by": by}
    enz = _gc_batch("ENZYMES", False).graph
    k1 = {"molhiv": {256: {"fwd": k1_width("molhiv batch fwd", g, 256, False, gen, plain=True),
                           "bwd": k1_width("molhiv batch adjoint", g.reverse, 256, False, gen,
                                           plain=True, by_eid=True)}},
          "enzymes": {128: {"fwd": k1_width("ENZYMES batch fwd", enz, 128, False, gen, plain=True),
                            "bwd": k1_width("ENZYMES batch bwd", enz.reverse, 128, False, gen,
                                            plain=True)}}}
    k2 = {"graphs": batch.num_graphs, "nodes": g.num_dst_nodes, "edges": g.num_edges, "d": 256,
          "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
          "copy_e_max_abs_err": acc_e[0], "copy_e_max_abs_err_f64": acc_e[1],
          "copy_e_max_bound_used": acc_e[2], "k2_times": times}
    return k2, k1


def gc_step_no_host_sync():
    """One molhiv training step, its batch's copies to the card included,
    under set_sync_debug_mode("error")."""
    from dgl_tpu_torch.benchmarks.graph_classification.main_gcn import make_train_step
    from dgl_tpu_torch.data import load_graph_dataset
    from dgl_tpu_torch.models import GCNMolClassifier
    from dgl_tpu_torch.sampling import GraphBatchLoader

    dev = torch.device("cuda")
    data = load_graph_dataset("ogbg-molhiv", num_graphs=256)
    loader = GraphBatchLoader(data.graphs, data.node_feats, data.labels, 64,
                              edge_feats=data.edge_feats, device=dev)
    model = GCNMolClassifier(256, 1, device=dev, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), "ogbg-molhiv",
                           torch.Generator(device=dev).manual_seed(0))
    it = iter(loader)
    step(*next(it))  # warm-up: lazy allocations and the optimiser's state
    loss = []
    no_host_sync(lambda: loss.append(step(*next(it))),
                 lambda: loss[0].item())
    if not math.isfinite(loss[0].item()):
        raise AssertionError("the molhiv step under the sync check gave a non-finite loss")


def phase_gc_main():
    """main_gcn on ENZYMES (600 graphs), molhiv (41,127 graphs, fused and
    scatter) and ppa (cut to 2,000 graphs), batch 64, every counter set to 0
    before a run and read after it: K1 and K2 launches gc_per_step per
    step, no combine (no batch holds a row over T: _gc_long_rows); losses
    finite and falling. molhiv fused also profiles GC_PROFILE_STEPS further
    steps (the device's idle share). Then gc_kernel_checks and one molhiv
    step under the sync check."""
    from dgl_tpu_torch.benchmarks.graph_classification import main_gcn
    from dgl_tpu_torch.graph.split import SPLIT_T
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.seg_sum import seg_sum

    t_phase = time.perf_counter()
    counters = {"csr_spmm": csr_spmm, "seg_sum": seg_sum}
    res, launches, combines, want_l, longest = {}, {}, {}, {}, {}
    for key, (ds, lowering, num_graphs, epochs) in GC_RUNS.items():
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = fn.combines = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            r = main_gcn.run(ds, batch_size=64, epochs=epochs, runs=1, lowering=lowering,
                             num_graphs=num_graphs, device="cuda",
                             profile_steps=GC_PROFILE_STEPS if key == "molhiv" else 0)
        r["run_s"] = time.perf_counter() - t0
        launches[key] = {k: fn.launches for k, fn in counters.items()}
        combines[key] = {k: fn.combines for k, fn in counters.items()}
        if "Training time/epoch" not in log.getvalue():
            raise AssertionError(f"{key}: no 'Training time/epoch' line")
        res[key] = r
        want_l[key] = {k: n * r["steps"] for k, n in gc_per_step(ds, lowering).items()}
        if ds not in longest:
            longest[ds] = _gc_long_rows(ds, num_graphs)
        torch.cuda.empty_cache()
    if max(longest.values()) > SPLIT_T:
        raise AssertionError(f"a batch could hold a row over T = {SPLIT_T}: {longest}")
    want_c = {key: {k: 0 for k in counters} for key in GC_RUNS}
    if launches != want_l:
        raise AssertionError(f"launches {launches}; want {want_l}")
    if combines != want_c:
        raise AssertionError(f"combine launches {combines}; want {want_c}")
    for key, r in res.items():
        losses = r["losses"][0]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{key} loss did not fall: {losses}")
    gen = torch.Generator(device="cuda").manual_seed(8)
    readout, k1 = gc_kernel_checks(gen)
    gc_step_no_host_sync()
    prof = res["molhiv"]["profile"]
    emit("gc_main", seconds=time.perf_counter() - t_phase, device=res["molhiv"]["device"],
         synthetic=res["molhiv"]["synthetic"],
         **{key: {"run_s": r["run_s"], "load_s": r["load_s"], "graphs": r["num_graphs"],
                  "steps": r["steps"],
                  "epoch_s": r["epoch_s"], "epochs_s": r["epochs_s"], "losses": r["losses"][0],
                  "launches": launches[key], "combines": combines[key]}
            for key, r in res.items()},
         per_step_derived={key: gc_per_step(ds, lw) for key, (ds, lw, _, _) in GC_RUNS.items()},
         longest_row=longest, readout=readout, no_host_sync=True,
         k1_widths={ds: {str(d): w for d, w in v.items()} for ds, v in k1.items()},
         molhiv_profile={k: prof[k] for k in ("steps", "wall_ms_per_step", "device_busy_ms_per_step",
                                              "device_idle_share")},
         molhiv_profile_kernels=prof["kernels"][:12])
    return launches, combines, readout, k1


def _kernel_entry(name, source, replaces, launches, r, **extra):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "max_abs_err_f64": r["max_abs_err_f64"], **extra}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a CUDA card",
              file=sys.stderr)
        return 1
    import dgl_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    phase_random()
    red, red_graph = phase_reddit()
    launches, combines = phase_main()
    phase_gat_random()
    gred, gred_arxiv, gred_arxiv40, gat_graph = phase_gat_reddit()
    floors, rows = phase_row_gather(red, red_graph, gred, gat_graph)
    del red_graph, gat_graph
    glaunch, gcombines = phase_gat_main()
    slaunch, scombines, widths = phase_sage_main()
    claunch, ccombines, readout, gc_k1 = phase_gc_main()
    both = lambda key: red["fwd"][key] + red["bwd"][key]  # noqa: E731
    sage_keys = {"arxiv": "ogbn-arxiv", "products": "ogbn-products"}
    k1_widths = {f"{k}_{ds.removeprefix('ogbn-')}_d{d}_{side}": w[side][k]
                 for ds, by_d in (widths | gc_k1).items() for d, w in by_d.items()
                 for side in ("fwd", "bwd")
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
    k2f, k2r = gred["seg_sum_fwd"], gred["seg_sum_rev"]
    print(json.dumps({"kernels": [
        {
            "name": "csr_spmm",
            "route": "cuda",
            "source": "dgl_tpu_torch/kernels/csrc/csr_spmm.cu",
            "replaces": "dgl_tpu/kernels/lane_spmm.py:418",
            # the unhoisted run is the main path; the hoisted run's count and
            # the pubmed GAT run's (gather_src_rows' adjoint) beside it
            "launches": launches["unhoisted"],
            "launches_hoisted": launches["hoisted"],
            "launches_pubmed_gat": glaunch["pubmed"]["csr_spmm"],
            # the row split: its combine launches on the same runs, T, and
            # the long rows and chunks of reddit's reverse CSR
            "combines": combines["unhoisted"],
            "combines_hoisted": combines["hoisted"],
            "combines_pubmed_gat": gcombines["pubmed"]["csr_spmm"],
            "split_T": red["bwd"]["split_T"],
            "long_rows": red["bwd"]["long_rows"],
            "chunks": red["bwd"]["chunks"],
            "max_abs_err": max(red["fwd"]["max_abs_err"], red["bwd"]["max_abs_err"]),
            "max_abs_err_f64": max(red["fwd"]["max_abs_err_f64"], red["bwd"]["max_abs_err_f64"]),
            # one forward (mean, dst CSR) plus one backward (sum, reverse CSR)
            # launch on reddit at D = 16, as each layer of a training step runs them
            "ms": both("kernel_ms"),
            "plain_ms": both("plain_ms"),
            "bound_ms": both("bound_ms"),
            "bound_by": red["fwd"]["bound_by"],
            "library_ms": both("library_ms"),
            "ms_fwd": red["fwd"]["kernel_ms"],
            "ms_bwd": red["bwd"]["kernel_ms"],
            "library_ms_fwd": red["fwd"]["library_ms"],
            "library_ms_bwd": red["bwd"]["library_ms"],
            # the SAGE driver's runs (unhoisted, hoisted, arxiv's scatter)
            # and the GCN driver's (K1: the GCNConv aggregations and the
            # gsddmm(copy_u) adjoints), with their combines
            **{f"launches_sage_{k}{m}": slaunch[(ds, mode)] for k, ds in sage_keys.items()
               for mode, m in (("unhoisted", ""), ("hoisted", "_hoisted"), ("scatter", "_scatter"))
               if (ds, mode) in slaunch},
            **{f"combines_sage_{k}{m}": scombines[(ds, mode)] for k, ds in sage_keys.items()
               for mode, m in (("unhoisted", ""), ("hoisted", "_hoisted"))},
            **{f"launches_gcn_{k}": v["csr_spmm"] for k, v in claunch.items()},
            **{f"combines_gcn_{k}": v["csr_spmm"] for k, v in ccombines.items()},
            # at each SAGE width: forward (mean, dst CSR) and backward (sum,
            # reverse CSR), plain_ms on arxiv only; on one batch of 64 graphs:
            # molhiv D = 256 (fwd a dst-CSR sum, bwd the gsddmm(copy_u)
            # adjoint by eid) and ENZYMES D = 128 (GCNConv's two sums)
            **k1_widths,
        },
        # K3's two passes on reddit with self-loops, H = 1, D = 16, with
        # dropout, the row split of the CSR each walks (the dst CSR, the
        # reverse CSR); launches and combines from the reddit GAT run of
        # gat_main, arxiv's (H = 4, D = 16; the last layer's D = 40) beside them
        *(_kernel_entry(name, "dgl_tpu_torch/kernels/csrc/gat_attention.cu",
                        "dgl_tpu/kernels/lane_attention.py:234", glaunch["reddit"][name], gred[name],
                        **{"pass": p}, split_T=gred[name]["split_T"],
                        long_rows=gred[name]["long_rows"], chunks=gred[name]["chunks"],
                        combines=gcombines["reddit"][name],
                        launches_arxiv=glaunch["ogbn-arxiv"][name],
                        combines_arxiv=gcombines["ogbn-arxiv"][name],
                        long_rows_arxiv=gred_arxiv[name]["long_rows"],
                        chunks_arxiv=gred_arxiv[name]["chunks"], ms_arxiv=gred_arxiv[name]["ms"],
                        plain_ms_arxiv=gred_arxiv[name]["plain_ms"],
                        bound_ms_arxiv=gred_arxiv[name]["bound_ms"],
                        max_abs_err_arxiv=gred_arxiv[name]["max_abs_err"],
                        ms_arxiv_d40=gred_arxiv40[name]["ms"],
                        plain_ms_arxiv_d40=gred_arxiv40[name]["plain_ms"],
                        bound_ms_arxiv_d40=gred_arxiv40[name]["bound_ms"],
                        max_abs_err_arxiv_d40=gred_arxiv40[name]["max_abs_err"], **extra)
          for name, p, extra in (
              ("gat_attention_fwd", "fwd", {}),
              ("gat_attention_bwd", "b2", {"gather_floor_ms": floors["k3_b2"]["gather_floor_ms"],
                                           "t_sweep": gred["gat_attention_bwd"]["t_sweep"]}))),
        # K2 at (E, 16) on reddit with self-loops over the dst CSR, the only
        # CSR the edge form runs it over (forward sums and spread_dst's
        # adjoint); launches from the pubmed GAT run of gat_main. The
        # reverse CSR, with its long rows split, which no path gives K2 now,
        # beside it
        {
            "name": "seg_sum",
            "route": "cuda",
            "source": "dgl_tpu_torch/kernels/csrc/seg_sum.cu",
            "replaces": "dgl_tpu/kernels/piece_reduce.py:54",
            "launches": glaunch["pubmed"]["seg_sum"],
            "max_abs_err": k2f["max_abs_err"],
            "max_abs_err_f64": k2f["max_abs_err_f64"],
            "ms": k2f["ms"],
            "plain_ms": k2f["plain_ms"],
            "bound_ms": k2f["bound_ms"],
            "bound_by": k2f["bound_by"],
            "library_ms": k2f["library_ms"],
            "index_add_ms": k2f["index_add_ms"],
            "combines": gcombines["pubmed"]["seg_sum"],
            "split_T": k2r["split_T"],
            "long_rows": k2r["long_rows"],
            "chunks": k2r["chunks"],
            "ms_rev": k2r["ms"],
            "library_ms_rev": k2r["library_ms"],
            "index_add_ms_rev": k2r["index_add_ms"],
            "max_abs_err_rev": k2r["max_abs_err"],
            # the GCN driver's runs (gspmm(copy_e, sum) and the readouts)
            **{f"launches_gcn_{k}": v["seg_sum"] for k, v in claunch.items()},
            **{f"combines_gcn_{k}": v["seg_sum"] for k, v in ccombines.items()},
            # the mean and sum readouts and gspmm(copy_e, sum) on a molhiv
            # batch at D = 256
            "max_abs_err_readout": readout["max_abs_err"],
            "max_abs_err_f64_readout": readout["max_abs_err_f64"],
            "max_abs_err_copy_e": readout["copy_e_max_abs_err"],
            "max_abs_err_f64_copy_e": readout["copy_e_max_abs_err_f64"],
            **{f"{k}_{shape}": t[k] for shape, t in readout["k2_times"].items()
               for k in ("ms", "plain_ms", "index_add_ms", "bound_ms")},
        },
        # P1 at the probe's default shape, launches from the probe's default
        # run; P2 where x fits, launches from the probe's run at (2708, 16)
        *({"name": name, "route": "cuda", "source": "dgl_tpu_torch/kernels/csrc/row_gather.cu",
           "replaces": replaces, **rows[name]}
          for name, replaces in (("row_gather_async", "tools/exp_dma_gather.py:34"),
                                 ("row_gather_smem", "tools/exp_dma_gather.py:72"))),
    ]}), flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
