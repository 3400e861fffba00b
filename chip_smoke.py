#!/usr/bin/env python3
"""Smoke run of dgl_tpu_torch on one CUDA card: build, check, train.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for float32 matmuls and convolutions;
  2. build: builds every kernel from the sources in dgl_tpu_torch/kernels/csrc;
  3. random: K1 (csr_spmm) on random CSRs with empty rows and hub rows of
     10^5 edges, D in {1, 16, 41, 602}, sum and mean, with and without edge
     weights, forward and backward through gspmm's autograd, on inputs
     around 1 and on small integers. Every row is held to float64 sums of
     the same inputs within a summation-error bound (integer sums: bit for
     bit), and rows of at most HUB_DEG terms to the plain PyTorch version at
     RTOL/ATOL; two kernel runs must be bitwise equal;
  4. reddit: the same checks on the full reddit graph at D = 16, forward
     and reverse CSR, with CUDA-event times of the kernel, the plain version
     and torch.sparse.mm, and the bytes bound;
  5. main: dgl_tpu_torch.bench.run("reddit") at full size, once unhoisted
     and once hoisted, K1's launch counter set to 0 before each run and read
     after it; the loss must be finite and fall, K1 must launch exactly 4
     times per unhoisted step and 2 per hoisted step plus once for the
     hoisted precompute, and both modes must agree on the first step's loss;
  6. gat_random: K3 (gat_attention_fwd, gat_attention_bwd) and K2 (seg_sum)
     on random CSRs with empty rows and 10^5-edge hub rows in both
     directions, H in {1, 4, 8}, D in {8, 16, 41}, keep in {1.0, 0.82}, on
     v and g around 1. Every output row is held to a float64 run of the
     plain version within the bound (2n + 8 + 4A)·u·Σ|term| (n terms,
     A = |a_src| + |a_dst| + |shift|, which the rounding of each term's
     logit and exp scales with), rows of at most HUB_DEG terms to the
     float32 plain version at RTOL/ATOL; both K3 passes (keep 1 and 0.5,
     see check_k3_exact) and K2 also run on inputs whose sums are exact and
     must match bit for bit on every row, hub rows included; two runs of
     each kernel are bitwise equal;
  7. gat_reddit: K3 forward and b2 on reddit with self-loops (H = 1,
     D = 16, reddit's attention dropout) and K2 at (E, 16) over the dst and
     the reverse CSR: the same checks, CUDA-event medians of the kernel, the
     plain version and, for K2, torch.segment_reduce (K3 has no single
     PyTorch call to compare with), and the bytes bounds; gather_src_rows'
     adjoint timed as one K1 launch and as index_select + K2 (reddit at
     W = 16, pubmed at W = 64); a fused GATConv's forward and backward
     allocate no more on reddit than on its self-loops alone;
  8. gat_main: the GAT driver at full size, reddit (fused form) then pubmed
     (edge form), each run with every launch counter set to 0 before it and
     read after it. reddit: K3 forward and b2 exactly 3 per step each, K2
     and K1 none, the training's peak device memory above the graph and
     data printed and held below one (E, 16) float32 buffer; pubmed: K3
     none, K2 exactly 9 per step plus one per edge-softmax rescue, K1 3 per
     step (see phase_gat_main). Losses finite and falling;
  9. kernels: one line listing every ported kernel with its numbers.
The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
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


def phase_build():
    from dgl_tpu_torch.kernels.build import build

    t0 = time.perf_counter()
    info = build()
    ptxas = {name: [ln.strip() for ln in b["log"].splitlines() if "registers" in ln or "spill" in ln]
             for name, b in info.items()}
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
                        f"{what} weighted {indptr.dtype}", csr_spmm(indptr, g.src, x, w, mean=mean),
                        g.indptr, reference64(g.indptr, g.src, x, w, mean=mean),
                        csr_spmm_plain(indptr, g.src, x, w, mean=mean), exact))
                worst = max([worst] + [e[0] for e in errs])
                worst64 = max([worst64] + [e[1] for e in errs])
                used = max([used] + [e[2] for e in errs])
                cases += len(errs)
    torch.cuda.synchronize()
    emit("random", cases=cases, nodes=n, edges=g.num_edges,
         max_in_degree=int(g.in_degrees().max()), max_out_degree=int(g.out_degrees().max()),
         zero_in_degree_rows=int((g.in_degrees() == 0).sum()), max_abs_err=worst,
         max_abs_err_f64=worst64, max_bound_used=used, rtol=RTOL, atol=ATOL, hub_deg=HUB_DEG,
         deterministic=True)


def phase_reddit():
    from dgl_tpu_torch import from_edges
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
        kern = lambda: csr_spmm(gg.indptr, gg.src, xx, mean=mean)  # noqa: E731
        plain = lambda: csr_spmm_plain(gg.indptr, gg.src, xx, mean=mean)  # noqa: E731
        err, err64, used = check(f"reddit {side}", kern(), gg.indptr,
                           reference64(gg.indptr, gg.src, xx, mean=mean), plain())
        # every edge counted once: integer sums are exact in any order
        check(f"reddit {side} integer", csr_spmm(gg.indptr, gg.src, x_int), gg.indptr,
              reference64(gg.indptr, gg.src, x_int), exact=True)
        a = torch.sparse_csr_tensor(gg.indptr.long(), gg.src.long(),
                                    torch.ones(e, device=dev), size=(n, n),
                                    check_invariants=False)
        lib_err = (torch.sparse.mm(a, xx) - csr_spmm(gg.indptr, gg.src, xx)).abs().max().item()
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
        }
    emit("reddit", nodes=n, edges=e, d=d, load_s=load_s,
         kernel_ms_fwd=res["fwd"]["kernel_ms"], kernel_ms_bwd=res["bwd"]["kernel_ms"],
         plain_ms_fwd=res["fwd"]["plain_ms"], plain_ms_bwd=res["bwd"]["plain_ms"],
         library_ms_fwd=res["fwd"]["library_ms"], library_ms_bwd=res["bwd"]["library_ms"],
         bound_ms_fwd=res["fwd"]["bound_ms"], bound_ms_bwd=res["bwd"]["bound_ms"], detail=res)
    return res


def phase_main():
    """Each mode in a run of its own, its launch count read around it."""
    from dgl_tpu_torch import bench
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm

    res, launches = {}, {}
    for mode in ("unhoisted", "hoisted"):
        csr_spmm.launches = 0
        r = bench.run("reddit", epochs=5, warmup=3, device="cuda",
                      hoisted=mode == "hoisted", unhoisted=mode == "unhoisted")
        launches[mode] = csr_spmm.launches
        res[mode] = dict(r[mode], setup_s=r["setup_s"], device=r["device"], synthetic=r["synthetic"],
                         precompute_s=r.get("precompute_s"))
    steps = {mode: len(res[mode]["losses"]) for mode in res}
    # 2 forward and 2 backward launches a step; hoisted: layer 1's forward
    # launch and its backward are gone, and x_agg is one launch before training
    want = {"unhoisted": 4 * steps["unhoisted"], "hoisted": 2 * steps["hoisted"] + 1}
    if launches != want:
        raise AssertionError(f"K1 launched {launches} times over {steps} steps; want {want}")
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
         steps_unhoisted=steps["unhoisted"], steps_hoisted=steps["hoisted"])
    return launches


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

    got = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, **kw)
    again = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, **kw)
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
    got = gat_attention_bwd(*args, g_out, node, a_s, **kw)
    again = gat_attention_bwd(*args, g_out, node, a_s, **kw)
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
        got = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, **kw)
        want = gat_attention_fwd_plain(g.indptr, g.src, v.double(), a_s.double(), a_d.double(), **kw)
        got += gat_attention_bwd(rev.indptr, rev.src, rev.eid, g_out, node, a_s, **kw)
        want += gat_attention_bwd_plain(rev.indptr, rev.src, rev.eid, g_out.double(), node.double(),
                                        a_s.double(), **kw)
        names = ("out", "w1", "inv_s", "w1s", "shift", "grad_v", "w2", "w3")
        for nm, x, w in zip(names, got, want):
            if not torch.equal(x, w.float()):
                bad = int((x != w.float()).flatten(1).any(1).nonzero()[0])
                raise AssertionError(f"{what} keep={keep} exact {nm}: row {bad} differs from the "
                                     "exact sums")


def check_k2(what, indptr, msg, ints, acc):
    """One K2 launch against float64 sums (the (2n + 8)·u·Σ|term| bound),
    the plain version, and small integers summed bit for bit."""
    from dgl_tpu_torch.kernels.seg_sum import seg_sum, seg_sum_plain

    got = seg_sum(indptr, msg)
    if not torch.equal(got, seg_sum(indptr, msg)):
        raise AssertionError(f"{what}: two K2 runs differ")
    m64 = msg.double()
    _merge(acc, [check(f"{what} K2", got, indptr,
                       (seg_sum_plain(indptr, m64), seg_sum_plain(indptr, m64.abs())),
                       seg_sum_plain(indptr, msg), slack=(2, 8))])
    i64 = ints.double()
    check(f"{what} K2 integer", seg_sum(indptr, ints), indptr,
          (seg_sum_plain(indptr, i64), seg_sum_plain(indptr, i64.abs())), exact=True)
    return got


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
            for side, indptr in (("dst", g.indptr), ("reverse", g.reverse.indptr)):
                msg = 1.0 + torch.randn(g.num_edges, w, device=dev, generator=gen)
                ints = torch.randint(-4, 5, (g.num_edges, w), device=dev, generator=gen).float()
                check_k2(f"{what} {side}", indptr, msg, ints, k2)
    torch.cuda.synchronize()
    emit("gat_random", cases=cases, nodes=n, edges=g.num_edges,
         max_in_degree=int(g.in_degrees().max()), max_out_degree=int(g.out_degrees().max()),
         zero_in_degree_rows=int((g.in_degrees() == 0).sum()),
         k3_fwd_max_abs_err=k3["fwd"][0], k3_fwd_max_abs_err_f64=k3["fwd"][1],
         k3_fwd_max_bound_used=k3["fwd"][2], k3_bwd_max_abs_err=k3["bwd"][0],
         k3_bwd_max_abs_err_f64=k3["bwd"][1], k3_bwd_max_bound_used=k3["bwd"][2],
         k2_max_abs_err=k2[0], k2_max_abs_err_f64=k2[1], k2_max_bound_used=k2[2],
         rtol=RTOL, atol=ATOL, hub_deg=HUB_DEG, deterministic=True)


def _gat_graph(name, dev):
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.data import load_node_dataset
    from dgl_tpu_torch.graph import transforms

    data = load_node_dataset(name)
    src, dst = transforms.add_self_loops(data.src, data.dst, data.num_nodes)
    return from_edges(src, dst, data.num_nodes, device=dev)


def adjoint_times(g, w, gen):
    """gather_src_rows' adjoint on (E, w) cotangents, two ways: the port's
    one K1 launch over the reverse CSR indexed by rev.eid, and the JAX
    package's pairing, a permuting index_select and one K2 launch."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.seg_sum import seg_sum

    rev = g.reverse
    ge = 1.0 + torch.randn(g.num_edges, w, device=g.indptr.device, generator=gen)
    k1 = lambda: csr_spmm(rev.indptr, rev.eid, ge)  # noqa: E731
    k2 = lambda: seg_sum(rev.indptr, ge.index_select(0, rev.eid))  # noqa: E731
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


def phase_gat_reddit():
    from dgl_tpu_torch.kernels.gat_attention import (
        gat_attention_bwd, gat_attention_bwd_plain, gat_attention_fwd, gat_attention_fwd_plain)
    from dgl_tpu_torch.kernels.seg_sum import seg_sum, seg_sum_plain

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = _gat_graph("reddit", dev)
    load_s = time.perf_counter() - t0
    rev = g.reverse
    n, e, h, d = g.num_dst_nodes, g.num_edges, 1, 16
    gen = torch.Generator(device=dev).manual_seed(2)
    check_k3_exact("reddit", g, h, d, gen)
    # v and g around 1 (see _inputs): the reverse hub row's sums stay far from 0
    v, g_out = (1.0 + torch.randn(n, h, d, device=dev, generator=gen) for _ in range(2))
    a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
    seed = torch.tensor([20260], dtype=torch.int32, device=dev)
    kw = dict(negative_slope=0.2, keep=REDDIT_KEEP, seed=seed)
    res = {}

    acc = [0.0, 0.0, 0.0]
    out, w1, inv_s, w1s, shift = check_k3_fwd("reddit", g, v, a_s, a_d, kw, acc)
    fwd_args = (g.indptr, g.src, v, a_s, a_d)
    bound, by = k3_fwd_bound(n, n, e, h, d)
    res["gat_attention_fwd"] = {
        "ms": median_ms(lambda: gat_attention_fwd(*fwd_args, **kw), reps=30, warmup=3),
        "plain_ms": median_ms(lambda: gat_attention_fwd_plain(*fwd_args, **kw), reps=5, warmup=1),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
        "max_row_nnz": int(g.in_degrees().max()),
    }
    acc = [0.0, 0.0, 0.0]
    node = torch.stack([a_d, shift, inv_s, (g_out * out).sum(-1)], -1)
    check_k3_bwd("reddit", g, g_out, node, a_s, kw, acc)
    bwd_args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s)
    bound, by = k3_bwd_bound(n, n, e, h, d, dropout=True)
    res["gat_attention_bwd"] = {
        "ms": median_ms(lambda: gat_attention_bwd(*bwd_args, **kw), reps=20, warmup=2),
        "plain_ms": median_ms(lambda: gat_attention_bwd_plain(*bwd_args, **kw), reps=5, warmup=1),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
        "max_row_nnz": int(rev.in_degrees().max()),
    }
    del v, out, w1, node
    msg = 1.0 + torch.randn(e, d, device=dev, generator=gen)
    ints = torch.randint(-4, 5, (e, d), device=dev, generator=gen).float()
    for side, indptr in (("fwd", g.indptr), ("rev", rev.indptr)):
        acc = [0.0, 0.0, 0.0]
        got = check_k2(f"reddit {side}", indptr, msg, ints, acc)
        offsets = indptr.long()
        lib = torch.segment_reduce(msg, "sum", offsets=offsets)
        bound, by = k2_bound(n, e, d)
        res[f"seg_sum_{side}"] = {
            "ms": median_ms(lambda: seg_sum(indptr, msg), reps=20, warmup=2),
            "plain_ms": median_ms(lambda: seg_sum_plain(indptr, msg), reps=5, warmup=1),
            "library_ms": median_ms(lambda: torch.segment_reduce(msg, "sum", offsets=offsets),
                                    reps=20, warmup=2),
            "library_max_abs_err_vs_kernel": (lib - got).abs().max().item(),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
            "max_row_nnz": int((indptr[1:] - indptr[:-1]).max()),
        }
    del msg, ints
    adjoint = {"reddit": adjoint_times(g, d, gen),
               "pubmed": adjoint_times(_gat_graph("pubmed", dev), 64, gen)}
    memory = fused_memory(g, gen)
    emit("gat_reddit", nodes=n, edges=e, heads=h, d=d, keep=REDDIT_KEEP, load_s=load_s,
         gather_adjoint=adjoint, fused_memory=memory,
         k3_library="none: no single PyTorch call computes the fused attention",
         **{f"{k}_ms": r["ms"] for k, r in res.items()}, detail=res)
    return res


def phase_gat_main():
    """The GAT driver's two paths, each with every counter set to 0 just
    before it and read just after it.

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
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_fwd
    from dgl_tpu_torch.kernels.seg_sum import seg_sum
    from dgl_tpu_torch.ops.softmax import edge_softmax

    counters = {"csr_spmm": csr_spmm, "gat_attention_fwd": gat_attention_fwd,
                "gat_attention_bwd": gat_attention_bwd, "seg_sum": seg_sum}
    steps = {"reddit": 8, "pubmed": 30}
    res, launches, rescues = {}, {}, {}
    for ds in ("reddit", "pubmed"):
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        edge_softmax.rescues = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            r = main_gat.run(ds, epochs=steps[ds], runs=1, device="cuda")
        launches[ds] = {k: fn.launches for k, fn in counters.items()}
        rescues[ds] = edge_softmax.rescues
        res[ds] = r
        if "Training time/epoch" not in log.getvalue():
            raise AssertionError(f"{ds}: the driver printed no 'Training time/epoch' line")
    s = steps["reddit"]
    want_reddit = {"csr_spmm": 0, "gat_attention_fwd": 3 * s, "gat_attention_bwd": 3 * s,
                   "seg_sum": 0}
    s = steps["pubmed"]
    want_pubmed = {"csr_spmm": 3 * s, "gat_attention_fwd": 0, "gat_attention_bwd": 0,
                   "seg_sum": 9 * s + rescues["pubmed"]}
    if launches["reddit"] != want_reddit or launches["pubmed"] != want_pubmed:
        raise AssertionError(f"launches {launches}; want reddit {want_reddit}, pubmed {want_pubmed}")
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
         reddit_epoch_s=res["reddit"]["epoch_s"], pubmed_epoch_s=res["pubmed"]["epoch_s"],
         reddit_epochs_s=res["reddit"]["epochs_s"], pubmed_epochs_s=res["pubmed"]["epochs_s"],
         reddit_setup_s=res["reddit"]["setup_s"], pubmed_setup_s=res["pubmed"]["setup_s"],
         reddit_losses=res["reddit"]["losses"][0], pubmed_losses=res["pubmed"]["losses"][0],
         steps=steps, launches=launches, pubmed_rescues=rescues["pubmed"],
         pubmed_k2_per_step_derived=9, pubmed_k1_per_step_derived=3,
         reddit_setup_bytes=res["reddit"]["setup_bytes"],
         reddit_train_peak_bytes=res["reddit"]["train_peak_bytes"],
         reddit_train_extra_bytes=train_extra["reddit"],
         reddit_train_extra_floats_per_node=train_extra["reddit"] / (4 * n),
         pubmed_setup_bytes=res["pubmed"]["setup_bytes"],
         pubmed_train_peak_bytes=res["pubmed"]["train_peak_bytes"],
         reddit_edge_buffer_bytes=edge_buffer,
         reddit_edges=e, pubmed_edges=res["pubmed"]["num_edges"])
    return launches


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
    red = phase_reddit()
    launches = phase_main()
    phase_gat_random()
    gred = phase_gat_reddit()
    glaunch = phase_gat_main()
    both = lambda key: red["fwd"][key] + red["bwd"][key]  # noqa: E731
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
        },
        # K3's two passes on reddit with self-loops, H = 1, D = 16, with
        # dropout; launches from the reddit GAT run of gat_main
        _kernel_entry("gat_attention_fwd", "dgl_tpu_torch/kernels/csrc/gat_attention.cu",
                      "dgl_tpu/kernels/lane_attention.py:234", glaunch["reddit"]["gat_attention_fwd"],
                      gred["gat_attention_fwd"], **{"pass": "fwd"}),
        _kernel_entry("gat_attention_bwd", "dgl_tpu_torch/kernels/csrc/gat_attention.cu",
                      "dgl_tpu/kernels/lane_attention.py:234", glaunch["reddit"]["gat_attention_bwd"],
                      gred["gat_attention_bwd"], **{"pass": "b2"}),
        # K2 at (E, 16) on reddit with self-loops over the dst CSR, the only
        # CSR the edge form runs it over (forward sums and spread_dst's
        # adjoint); launches from the pubmed GAT run of gat_main. The
        # reverse CSR's hub row, which no GAT path gives K2 now, beside it
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
            "ms_rev": k2r["ms"],
            "max_abs_err_rev": k2r["max_abs_err"],
        },
    ]}), flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
