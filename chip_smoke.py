#!/usr/bin/env python3
"""Smoke run of dgl_tpu_torch on one CUDA card: build, check, train.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off for float32 matmuls and convolutions;
  2. build: builds every kernel from the sources in dgl_tpu_torch/kernels/csrc
     and prints ptxas' registers and spills of every variant; no variant of
     K3 may spill;
  3. random: K1 (csr_spmm) on random CSRs with empty rows and hub rows of
     10^5 edges, D in {1, 16, 41, 602}, sum and mean, with and without edge
     weights, forward and backward through gspmm's autograd, on inputs
     around 1 and on small integers. Every row is held to float64 sums of
     the same inputs within a summation-error bound (integer sums: bit for
     bit), and rows of at most HUB_DEG terms to the plain PyTorch version at
     RTOL/ATOL; two kernel runs must be bitwise equal. The same checks on
     CSRs around the row split T (graph/split.py), D in K1_D = {1, 3, 16,
     40, 41, 47, 100, 602}: rows of T - 1, T, T + 1, 2T and 2T + 1 edges,
     every row long (each folded in the launch), no row long, E = 0, int32
     and int64 indptr, the plan's counters back at 0 after every launch; a
     plan that does not match indptr refused before any launch; the same
     with every chunk warp walking two chunks (check_k1_chunk_pairs); and x at
     bases 4 and 8 bytes off 16-byte alignment (bfloat16 also 2), float32
     and bfloat16, its first and last rows read often and its storage ending
     with x (check_k1_misaligned). bf16 messages (check_bf16_k1_k2): K1 and
     K2 on bfloat16 rows, K1 at D in K1_BF16_D (K1_D and {8, 64}), K2 at D in
     {1, 8, 16, 47, 64, 100}, over the
     random graph's two CSRs and the CSRs around the split, int32 and int64
     indptr, K1 sum, mean and weighted: float32 sums held to float64 sums of
     the same bfloat16 values within the same bound, to the plain version,
     small integers bit for bit, two runs bitwise equal;
  4. reddit: the same checks on the full reddit graph at D = 16, forward
     and reverse CSR (one launch each: the reverse CSR's long rows fold in
     it, its counters back at 0), with CUDA-event times of the kernel and
     torch.sparse.mm in turns, of the kernel at T = 256, 512 and 1024 and of
     the plain version, the bytes bound and the no-reuse gather time
     (spmm_floor, computed); T and each CSR's long
     rows and chunks; gspmm's forward and backward under
     torch.cuda.set_sync_debug_mode("error"), which a host sync fails; K1's
     bfloat16 instantiation on each CSR (k1_bf16_times: the checks, then
     timed in turns with float32 on the same values, beside the plain
     version, torch.sparse.mm on the bfloat16 CSR where torch takes it, in
     turns, the bound and the floor at 2 bytes a feature);
  5. main: dgl_tpu_torch.bench.run("reddit") at full size, once unhoisted
     and once hoisted, K1's launch counter set to 0 before each run and
     read after it; the loss must be finite and fall, K1 must launch
     exactly 4 times per unhoisted step and 2 per hoisted step plus once for
     the hoisted precompute (the reverse CSR's long rows fold inside each
     backward launch), and both modes must agree on the first step's loss;
  6. gat_random: K3 (gat_attention_fwd, gat_attention_bwd, each with the
     row split of the CSR it walks) and K2 (seg_sum) on random CSRs with
     empty rows and 10^5-edge hub rows in both directions, H in {1, 2, 4,
     8}, D in {8, 16, 40, 41, 64}, keep in {1.0, 0.82}, on v and g around 1,
     each K3 launch with no combine launch and the plan's counters back at
     0 after it. Every
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
     plan refused by each before any launch; both K3 passes with bfloat16 v
     (H in {1, 4}, D in {16, 40, 41}, keep in {1, 0.82}): the forward held
     to float64 and the plain version as above, b2's bfloat16 grad_v equal
     bit for bit to its float32 grad_v rounded once (w2 and w3 equal), within
     one bfloat16 ulp of the plain version, and the integer cases exact;
     both K3 passes with v (b2: g) at bases 4 and 8 bytes off 16-byte
     alignment (bfloat16 v also 2), the storage ending with the array, H in
     {1, 4}, D in {16, 41, 64}, over a graph whose edges read the first and
     last rows often (check_k3_misaligned): the same checks;
  7. gat_reddit: K3 forward and b2 on reddit with self-loops (H = 1,
     D = 16, reddit's attention dropout) and K2 at (E, 16) over the dst and
     the reverse CSR: the same checks, CUDA-event medians of the kernel, the
     plain version and, for K2, torch.segment_reduce and index_add_ (its
     row ids made outside the timed calls; K3 has no single PyTorch call to
     compare with), no combine launch in the timed K3 calls, the
     T sweep (256, 512, 1024) of K2 and of each K3 pass whose CSR has a row
     over 256 edges, and the bytes bounds; K3's checks and times also at
     arxiv's shapes (bidirected with self-loops, H = 4, D = 16 and the last
     layer's D = 40, long rows in both CSRs); a fused GATConv's forward and
     backward, and seg_sum_dst's, under set_sync_debug_mode("error");
     gather_src_rows' adjoint timed as
     one K1 launch and as index_select + K2 (reddit at W = 16, pubmed at
     W = 64); a fused GATConv's forward and backward allocate no more on
     reddit than on its self-loops alone; bf16: both K3 passes and K2 (dst
     CSR, W = 16) in bfloat16 at the same shapes (k3_bf16_times,
     k2_bf16_times), each timed in turns with float32; and a
     GATConv(edge_dtype=bfloat16) step on pubmed in both forms beside the
     float32 layer (gatconv_bf16_step: the bfloat16 launches of each form
     counted, the output within 1e-2 and the input gradient within 5e-2 of
     the float32 one's largest entry);
  8. row_gather: P1 in index order (row_gather_async), P1 in source order
     (row_gather_by_source, through gather_plan) and P2 (row_gather_smem)
     held bit for bit to x[idx] in float32 and bfloat16, int32 and int64
     indices, ragged e, rows of 2 B to 40 KB, misaligned x, P2 up to its
     227 KB limit and its refusal above it, two runs bitwise equal; P1 in
     source order also against its plain version, on a row of 120k
     positions (the split), rows with no position, pos=None and no split;
     the row-gather probe (python -m
     dgl_tpu_torch.tools.exp_dma_gather) as its main path, at its default
     shape and at cora's node count at D = 16, each run with the three
     counters set to 0 before it and read after it, every line with maxerr 0
     but P2's refusal at the default shape; CUDA-event medians of P1 in both
     orders, the plan's build, index_select and a write-only fill of the
     same output on the index streams of K1 forward and backward, K3 forward
     and b2 and pubmed's gather_src_rows, and the probe's default, with
     gather_floor_ms (P1 less the fill) beside the kernel that gathers them,
     the profiler's device ms and each stream's bound; P2 against P1 and
     index_select at (2708, 16) on reddit's indices mod 2708;
  9. gat_main: main_gat at full width, reddit and ogbn-arxiv (fused
     form, heads (1, 1, 1) and (4, 4, 4)) then pubmed (edge form), each run
     with every launch and combine counter set to 0 before it and read
     after it. reddit and arxiv: K3 forward and b2 exactly 3 per step each,
     K2 and K1 none, no combine launch (K3 folds its long rows inside its
     launch); both runs' Training time/epoch; reddit's training peak device memory above the graph
     and data held below one (E, 16) float32 buffer, arxiv's below
     fused_gat_memory_bound (derived from the shapes); pubmed: K3 none, K2
     exactly 12 per step plus one per edge-softmax rescue, K1 3 per step,
     no combine launch (K1 and K2 fold long rows inside their launch), P1 in source order 18 per step plus two per rescue
     (gat_edge_per_step); pubmed's profiled steps run no index_select.
     Losses finite and falling. Then, on pubmed's graph, gather_src_rows,
     gather_dst, spread_dst and segment_sum: forwards bit for bit against
     index_select, gradients against float64 sums and the plain versions,
     all four forward and backward under set_sync_debug_mode("error"), no
     index_select in their profile (graph_gather_checks);
  10. sage_main: main_sage at full width on ogbn-arxiv (3 layers, hidden
     256, BN, bidirected; 10 epochs) and the full ogbn-products graph (3
     layers, hidden 64, bidirected; 5 epochs), each hoisted and with
     --no-precompute, arxiv also with lowering="scatter", every counter set
     to 0 before a run and read after it: K1's launches as derived from the
     code (sage_k1_launches), none under scatter (K1 has no combine launch);
     losses finite and falling; the first step's loss equal across the modes.
     Then K1 at every width those runs give it (arxiv D = 40, 128, 256;
     products D = 47, 64, 100), forward on the dst CSR and backward on the
     reverse CSR, held to float64 sums and timed in turns with
     torch.sparse.mm, beside its bound and its computed no-reuse gather time;
     load_s, setup_s, precompute_s, memory and each CSR's split.
     The bf16 path: products unhoisted with bf16 messages (main_sage
     --bf16-messages), 5 epochs: K1's launches equal the
     float32 run's, the forward's on bfloat16 rows, the first step's loss
     within 1e-2 of the float32 run's, its epoch time beside; K1's bfloat16
     instantiation at products' widths each way, timed in turns with float32;
  11. gc_main: main_gcn at full width on ENZYMES (600 graphs, 5 epochs),
     ogbg-molhiv (both lowerings' runs cut to 10,000 of its 41,127 graphs;
     3 epochs) and ogbg-ppa
     (cut to 2,000 graphs, 3 epochs), batch 64, every counter set to 0
     before a run and read after it: K1's, K2's and P1-in-source-order
     launches per step as derived from the code (gc_per_step), no combine; losses finite and
     falling; one molhiv epoch profiled (the device's idle share); K2's mean
     and sum readouts on a molhiv batch at D = 256 against the plain version
     and float64 sums; one molhiv step under set_sync_debug_mode("error");
  12. rgcn_main: RGCN on the full ogbn-proteins graph (132,534 nodes,
     39,561,252 edges, 8 relations, 112 tasks): weighted K1 at every
     (CSR, width) the driver's models launch it at, read from the models
     (rgcn_k1_launches: the dst CSR (mean) at D = 1 and 32, the reverse CSR
     (sum) at D = 32), held to float64 sums, the plain version and integer
     sums bit for bit, timed beside torch.sparse.mm on the weighted CSR and
     the bound; gspmm_rel forward and backward in every (width, form) a
     layer calls it in, held the same way; one training step under
     set_sync_debug_mode("error"); main_rgcn (3 layers, hidden 32) in the
     default form (a layer aggregates first where its input is narrower:
     layers 1 and 3) and with fuse_relations (every layer aggregates
     first), K1's launches against rgcn_k1_launches, the
     training's peak above its inputs below one (E, 32) float32 buffer,
     losses falling and equal on the first step, the device profile (busy,
     idle share, K1's share);
  13. gcmc_main: GCMC on ml-100k at the driver's defaults (seed 123,
     943 users, 1682 movies, 85,000 training ratings, 10 relations): K1 on
     each relation CSR at D = 100 forward (dst CSR) and backward (reverse
     CSR) and on the decoder graph's reverse CSR by eid at D = 75, every
     row held to float64 sums, rows of at most HUB_DEG terms to the plain
     version, small integers bit for bit, timed beside torch.sparse.mm and
     the bound; P1 in source order on the decoder's two gathers bit for bit
     against x[idx]; K2 at W = 75 on the decoder's dst CSR (check_k2); one
     iteration under set_sync_debug_mode("error"); the driver (GCMC_ITERS
     iterations, an RMSE evaluation every 5, then GCMC_PROFILE profiled
     iterations) with every counter set to 0 before it and read after it:
     K1's, K2's and P1-in-source-order launches and K2's combines (0: K2
     folds the decoder's long rows in its launch) as gcmc_per_iter derives
     them; losses finite and falling; the
     reference's two lines and both CSV files; the best test RMSE below
     the test RMSE of predicting the training ratings' mean (printed); the
     profile (busy, idle share, top kernels);
  14. kernel_sweep: dgl_tpu_torch.kernel.bench_kernels at its defaults
     (copy_lhs sum SpMM, add SDDMM, widths 1-128) on reddit, ogbn-arxiv and
     ogbn-proteins as given, each point held to its plain version before it
     is timed (or an OOM row, only for torch.OutOfMemoryError), and
     gsddmm's two gathers in source order beside the index order at each
     width;
  15. ns_main: ns_sage and ns_gat on the full reddit graph at the drivers'
     defaults (fanouts 10,25, batch 1000, hidden 16; ns_gat 8 heads): ns_sage
     with the device sampler for 7 epochs (one evaluation, two epochs in
     "Avg epoch time"), with --host-sampler and with --no-replace for one
     epoch each, ns_gat for 2 epochs with one evaluation; the device-sampler
     runs go on for NS_PROFILE_STEPS profiled steps (busy, idle share, top
     kernels). Every counter set to 0 before a run and read after it: P1 in
     index order once a step, no K1, K2 or K3 in a step, K1 (ns_sage) and
     K3 forward (ns_gat) in the evaluations as ns_launches derives them, no
     combine (reddit's dst CSR has no long row); losses finite and falling;
     the reference's lines; ns_gat's training peak above its graph, data
     and samplers under ns_gat_memory_bound. Then one device-sampler step of
     each model under set_sync_debug_mode("error"), P1 on a real step's
     input_nodes bit for bit against x[idx] and timed beside x[idx],
     index_select and the bound of its distinct rows, and K3 forward at
     both evaluation shapes on reddit as given (H = 8, D = 16 and H = 1,
     D = 41) held by check_k3_fwd and timed;
  16. cluster_main: the full products graph partitioned once (metis,
     k = 15000), alone on the host, into cluster_sage's partition cache:
     its seconds, edge cut and balance, every node's part in
     [0, k) and the parts covering every node once; cluster_sage with
     SAGE and with GAT (fused, K3) on full products at the driver's
     defaults (psize 15000, 32 parts a step, 3 layers of 256, GAT 4 heads
     of 64), 4 epochs with a full-graph evaluation each and 30 profiled
     steps, and cluster_gcn_lp on arxiv (dot predictor, 5 epochs, MRR
     every epoch, --yardsticks), every counter set to 0 before a run and
     read after it: P1 in index order once a batch, K1 / K3 / K2 / P1 in
     source order a step and an evaluation as cluster_launches derives
     them; losses finite and falling; the reference's lines; cluster GAT's
     training peak above its data and graph under
     cluster_gat_memory_bound; each batch's host collation; one step of
     each model under set_sync_debug_mode("error"), and 35 steps of SAGE
     and of GAT on batches collated first, their host enqueue timed
     (cluster_host_split); both K3 passes at
     H = 4, D = 64 and H = 1, D = 47 and K1 at D = 100 and 256 on one
     products cluster batch (k3_shape, k1_width), P1 on its nodes; K3
     forward on the whole products graph at H = 4, D = 64, rows held to
     float64 sums on their sub-CSR; one forward of GATConv's memory-safe
     form on the whole products graph, its peak under
     memsafe_memory_bound, its output against the fused form's; the GAT
     run's trained model on the whole graph and inside one epoch of its own
     batches (cluster_gat_whole_vs_batch: train accuracy on the same nodes,
     the share of in-edges from the destination's own label and each
     layer's attention mass on them), recorded, nothing asserted on it;
  17. distributed: DIST_K = 2 ranks sharing cuda:0 over gloo, started by
     dgl_tpu_torch/parallel/launch.py after the kernels are built (their
     collectives stage through host memory: no time here is a multi-GPU
     time). The drivers' --shard 2 (DIST_RUNS, epochs cut): reddit SAGE at
     full size and width (602 -> 16 -> 41), ogbn-arxiv GAT at its driver
     config (heads 4, 4, 4, bidirected, self-loops) and ogbn-proteins RGCN
     at the driver's defaults (3 layers, hidden 32): partition and plan
     seconds, nodes_per_shard, H and exchange_stats; losses finite and
     falling; every rank's parameters bitwise equal; each rank's launches
     over the run, the payloads' K1 adjoints among them as the exchange
     counts them, equal to halo_sage_launches / halo_gat_launches /
     halo_rgcn_launches times the steps; the trained logits (gathered on
     rank 0, rows in the input order) against one card's forward at rtol
     1e-4, atol 1e-5: SAGE against GraphSAGE over K1 at the converted
     weights, GAT and RGCN against the same halo model over a plan of one
     shard. Then one start of the ranks (checks.in_turn) for: one step's
     gradients of reddit SAGE (dropout 0) and of arxiv GAT at seeded
     weights, summed over the ranks, bitwise equal on both, held with one
     card's (GraphSAGE over K1; HaloGAT over a plan of one shard, K3) to a
     float64 run of the model in plain PyTorch (torch.sparse.mm; index_add_
     with the exact row maximum) within DIST_GRAD_RTOL·|g| +
     DIST_GRAD_ATOL·max|g| a tensor, the losses within 1e-5 relative, the
     payloads' adjoints counted against the derivations; the exchange
     alone on reddit's plan at D = 602 and 16 (each rank's median ms and
     bytes); spmd: reddit's edges split over the ranks, sharded_gspmm mean
     (K1 twice a rank) against one card's K1 and float64 sums (check),
     replicated output and gradient equal on both ranks; dp: two ns_sage
     minibatches of reddit (batch 1000, fanouts 25, 10), one SGD step,
     the new parameters equal on both ranks and to the step of the two
     ranks' mean gradient. At rank 0's part of reddit's and arxiv's plans:
     K1 over the send graph's reverse CSR (the payloads' adjoint; D = 16,
     and 68 and 164), over reddit's bipartite reverse CSR (D = 16), and K3
     forward and b2 on arxiv's bipartite graph (H = 4, D = 16), against
     their plain versions and float64 sums (check). Checkpoint: main_sage
     on reddit, 6 epochs against 3 plus a resume of 3 from --ckpt-dir, the
     losses equal bit for bit;
  18. suite: the suite harness (python -m
     dgl_tpu_torch.benchmarks.generate_result) on the card, its output in a
     temporary directory, each row a driver in its own process: the smoke
     rows SUITE_SMOKE (a row of every driver, GAT fused and in the edge
     form, GCN fused and scatter), those of SUITE_PROFILED with the
     drivers' --profile, and reddit_sage at its full arguments (the main
     path at full width, unhoisted). Every row's status ok, its epoch time
     finite and positive (SUITE_UNTIMED: a smoke row of warm-up epochs
     only has none), its final test score where its driver prints one
     (SUITE_NO_FINAL_TEST: the lines the harness does not parse), its ratio
     to the V100 baseline where the suite has one; each profiled row's
     device profile names the kernels its path must launch;
  19. kernels: one line listing every ported kernel with its numbers, K1's,
     K2's and K3's with T, long rows, chunks and K2's and K3's combine
     launches (0: their launches fold them; K1 counts none), K3's at
     arxiv's shapes (D = 16 and 40) beside reddit's and b2's gather floor,
     K1's at the SAGE widths and K1's and K2's launches on the new paths,
     P1 in source order beside P1 in index order with its plan's build
     time and its launches on the pubmed GAT and GCN runs, K1's launches on
     the RGCN run and its weighted times at proteins' D = 32; the NS runs'
     launches of P1 in index order, K1 and K3 forward, P1's times on a
     step's input_nodes and K3 forward's at H = 8; the cluster runs'
     launches (launches_cluster_*), K1, K3 and P1 at a cluster batch's
     shapes (*_cluster_*) and K3 forward on the whole products graph
     (*_products_h4_d64); the GCMC run's launches of K1, K2 and P1 in
     source order (launches_gcmc; K2's combines_gcmc) and their times at its
     shapes (*_gcmc_*); the distributed phase's
     launches on rank 0 (launches_halo_sage, launches_halo_rgcn,
     launches_spmd, launches_send_adjoint; launches_halo_gat;
     launches_halo_payload); the bfloat16 instantiations (csr_spmm_bf16,
     launched by products SAGE with bf16 messages; seg_sum_bf16 and both K3
     passes' *_bf16, by the bf16 GATConv step), each with its float32
     instantiation's time in the same turns (ms_f32_in_turns).
K2 and P1 at every shape they are timed at (gc_main's readout and copy_e,
gcmc_main's decoder K2 and both gathers, gat_reddit's K2 rows and bf16 K2,
row_gather's streams, ns_main's step gather, cluster_main's batch gather)
also report each call's host time and device time beside the library
call's (host_and_device: "host_device", "library_host_device",
"index_add_host_device"): where the event pair is about the host's time
and above the device's, the call is host-bound.
The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import inspect
import io
import json
import math
import os
import re
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


def in_turns(fa, fb, reps=20, warmup=3):
    """CUDA-event medians of ``fa`` and ``fb`` in turns (a, b, b, a): each
    the mean of its two medians, so a drift of the card's clock within the
    call falls on both."""
    a1 = median_ms(fa, reps, warmup)
    b1 = median_ms(fb, reps, warmup)
    b2 = median_ms(fb, reps, warmup)
    a2 = median_ms(fa, reps, warmup)
    return (a1 + a2) / 2, (b1 + b2) / 2


def bf16_library_ms(make, reps=20, warmup=3):
    """The time of the PyTorch call ``make()`` returns on bfloat16 inputs,
    and a note: None and the error where this build of torch refuses
    bfloat16 there (its result is bfloat16 where the kernel's is float32)."""
    try:
        call = make()
        call()
    except (RuntimeError, NotImplementedError, TypeError) as err:
        return None, f"refused: {type(err).__name__}: {str(err).splitlines()[0][:160]}"
    return median_ms(call, reps, warmup), "returns bfloat16; the kernel returns float32 sums"


def spmm_bound(n_rows, n_src, nnz, d, indptr_bytes, x_bytes=4):
    """Least time (ms) of one CSR SpMM and what sets it: each input read
    once (x at ``x_bytes`` a value: 2 for bfloat16 rows) and the float32
    output written once, or nnz·d FMAs at the float32 peak."""
    moved = nnz * 4 + (n_rows + 1) * indptr_bytes + n_src * d * x_bytes + n_rows * d * 4
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, 2 * nnz * d / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def spmm_floor(n_rows, nnz, d, indptr_bytes, x_bytes=4, weighted=False):
    """K1's no-reuse gather time (ms), computed, not measured: every edge's
    row of x read once from HBM (no row reused from L2), plus the indices
    (and weights), indptr and the float32 output. A floor only where x is
    far beyond L2 (products); where rows are reused from L2 (reddit, arxiv,
    proteins) the kernel can run below it."""
    moved = (nnz * (d * x_bytes + (8 if weighted else 4)) + (n_rows + 1) * indptr_bytes
             + n_rows * d * 4)
    return 1e3 * moved / HBM_BYTES_PER_S


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
    """Every kernel of the package (build: one nvcc a source, all at once);
    no variant of K3 (both libraries) may spill. A library already in
    kernels/_build (a second call in one checkout) prints no ptxas lines:
    the check reads the K3 libraries compiled in this call, which on a
    fresh checkout are both."""
    from dgl_tpu_torch.kernels.build import build

    t0 = time.perf_counter()
    info = build()
    ptxas = {name: _ptxas_lines(b["log"]) for name, b in info.items()}
    fresh = [name for name in ("gat_attention", "gat_attention_bf16") if info[name]["seconds"]]
    k3 = [ln for name in fresh for ln in ptxas[name] if "spill" in ln]
    if fresh and (not k3 or any(" 0 bytes spill stores, 0 bytes spill loads" not in ln
                                for ln in k3)):
        raise AssertionError(f"a K3 variant spills (or ptxas printed no spill line): {k3}")
    emit("build", seconds=time.perf_counter() - t0,
         kernels={name: b["seconds"] for name, b in info.items()}, ptxas=ptxas,
         k3_built=fresh, k3_variants=len(k3), k3_spills=0 if fresh else None)


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


K1_D = (1, 3, 16, 40, 41, 47, 100, 602)  # every vector width, odd widths, two column pieces


def check_split_k1(rng, dev):
    """K1 on CSRs around the split (every row long: each folded in the
    launch; no row long), D in K1_D, int32 and int64 indptr, sum and mean,
    with and without edge weights: float64 bounds, the plain version,
    integer sums bit for bit, a second run bitwise and the plan's counters
    back at 0."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    n_src, cases, acc = 3000, 0, [0.0, 0.0, 0.0]
    for name, degrees in _split_degrees(rng, SPLIT_T).items():
        ip, idx = _csr_of(degrees, n_src, rng, dev)
        plan = row_split(ip)
        for d in K1_D:
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
                        if plan.counters.any():
                            raise AssertionError(f"{what}: the fold left a counter above 0")
                        cases += 1
        _refuses_mismatched_plan(csr_spmm, ip, idx, x)
    return cases, acc


def check_k1_chunk_pairs(rng, dev):
    """K1 with every chunk warp walking two consecutive chunks (the rule of
    plans of k1_geometry.h's kChunkPairsMin = 2048 chunks or more, reached
    here by plans cut at t = 2) on the CSRs around the split, D in {1, 16,
    47, 100}, float32 and bfloat16: float64 bounds, the plain version,
    integer sums bit for bit, two runs bitwise equal, the counters back at
    0."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    n_src, cases, acc = 3000, 0, [0.0, 0.0, 0.0]
    for name in ("around_T", "all_long"):
        ip, idx = _csr_of(_split_degrees(rng, SPLIT_T)[name], n_src, rng, dev)
        plan = row_split(ip, t=2)
        if plan.num_chunks < 2048:
            raise AssertionError(f"chunk pairs {name}: {plan.num_chunks} chunks, fewer than 2048")
        for dtype in (torch.float32, BF16):
            for d in (1, 16, 47, 100):
                x, _, w = _inputs(rng, "normal", n_src, d, idx.numel(), dev)
                xi, _, wi = _inputs(rng, "integer", n_src, d, idx.numel(), dev)
                x, xi = x.to(dtype), xi.to(dtype)
                for mean, ww in ((False, None), (True, None), (False, w)):
                    what = (f"chunk pairs {name} {dtype} D={d} mean={mean} "
                            f"weighted={ww is not None}")
                    got = csr_spmm(ip, idx, x, ww, mean=mean, split=plan)
                    if not torch.equal(got, csr_spmm(ip, idx, x, ww, mean=mean, split=plan)):
                        raise AssertionError(f"{what}: two kernel runs differ")
                    _merge(acc, [check(what, got, ip, reference64(ip, idx, x, ww, mean=mean),
                                       csr_spmm_plain(ip, idx, x, ww, mean=mean))])
                    cases += 1
                check(f"chunk pairs {name} {dtype} D={d} integer",
                      csr_spmm(ip, idx, xi, wi, split=plan), ip,
                      reference64(ip, idx, xi, wi), exact=True)
                if plan.counters.any():
                    raise AssertionError(f"chunk pairs {name}: the fold left a counter above 0")
    return cases, acc


def _x_view(rng, kind, n, d, dtype, shift_bytes, dev):
    """(n, d) rows at ``shift_bytes`` past a 16-byte-aligned allocation that
    ends where x ends, so a span rounded out to 16 bytes at x's first or
    last row would leave the storage."""
    elem = torch.empty((), dtype=dtype).element_size()
    shift = shift_bytes // elem
    a = rng.normal(1.0, 1.0, n * d) if kind == "normal" else rng.integers(-4, 5, n * d)
    flat = torch.empty(shift + n * d, dtype=dtype, device=dev)
    flat[shift:] = torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
    x = flat[shift:].view(n, d)
    if x.data_ptr() % 16 != shift_bytes:
        raise AssertionError(f"x's base is {x.data_ptr() % 16} bytes off 16, not {shift_bytes}")
    return x


def check_k1_misaligned(rng, dev):
    """K1 on x bases 4 and 8 bytes off 16-byte alignment (bfloat16 also 2),
    float32 and bfloat16, D in K1_D, over a CSR around the split whose
    indices read x's first and last rows often, x's storage ending with x:
    float64 bounds, the plain version, integer sums bit for bit, two runs
    bitwise equal, sum, mean and weighted."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    n_src, cases, acc = 700, 0, [0.0, 0.0, 0.0]
    ip, idx = _csr_of(_split_degrees(rng, SPLIT_T)["around_T"] + [40] * 200, n_src, rng, dev)
    ends = torch.rand(idx.shape, device=dev) < 0.25  # a quarter read row 0 or n_src - 1
    idx = torch.where(ends, (torch.rand(idx.shape, device=dev) < 0.5).int() * (n_src - 1), idx)
    plan = row_split(ip)
    e = idx.numel()
    w = torch.from_numpy(rng.uniform(0.5, 1.5, e).astype(np.float32)).to(dev)
    wi = torch.from_numpy(rng.integers(1, 4, e).astype(np.float32)).to(dev)
    for dtype in (torch.float32, BF16):
        for shift in ((4, 8) if dtype == torch.float32 else (2, 4, 8)):
            for d in K1_D:
                x = _x_view(rng, "normal", n_src, d, dtype, shift, dev)
                xi = _x_view(rng, "integer", n_src, d, dtype, shift, dev)
                for mean, ww, wwi in ((False, None, None), (True, None, None), (False, w, wi)):
                    what = (f"misaligned {dtype} +{shift} B D={d} mean={mean} "
                            f"weighted={ww is not None}")
                    got = csr_spmm(ip, idx, x, ww, mean=mean, split=plan)
                    if not torch.equal(got, csr_spmm(ip, idx, x, ww, mean=mean, split=plan)):
                        raise AssertionError(f"{what}: two kernel runs differ")
                    _merge(acc, [check(what, got, ip, reference64(ip, idx, x, ww, mean=mean),
                                       csr_spmm_plain(ip, idx, x, ww, mean=mean))])
                    if not mean:
                        check(f"{what} integer", csr_spmm(ip.int(), idx, xi, wwi, split=plan), ip,
                              reference64(ip, idx, xi, wwi), exact=True)
                    cases += 1
    return cases, acc


# -- bfloat16 rows: K1's and K2's bfloat16 instantiations --------------------

BF16 = torch.bfloat16
BF16_D = (1, 8, 16, 47, 64, 100)  # every load width: 2, 4, 8 and 16 bytes a lane
K1_BF16_D = tuple(sorted(set(BF16_D) | set(K1_D)))  # K1's bfloat16 rows at K1_D too


def _bf16_rows(rng, kind, n, d, dev):
    """(n, d) bfloat16 rows around 1 ("normal") or small integers, which
    bfloat16 holds exactly and whose float32 sums are exact in any order."""
    a = rng.normal(1.0, 1.0, (n, d)) if kind == "normal" else rng.integers(-4, 5, (n, d))
    return torch.from_numpy(a.astype(np.float32)).to(dev).to(BF16)


def check_bf16_k1_k2(rng, dev, g):
    """K1 and K2 on bfloat16 rows, D in K1_BF16_D (K1) and BF16_D (K2), over
    the random graph's dst and reverse CSRs (hub rows of 10^5 edges) and the CSRs around the split,
    int32 and int64 indptr, K1 sum and mean, with and without edge weights:
    against float64 sums of the same bfloat16 values within check's float32
    bound (the values convert exactly; the sums are float32), against the
    plain version, small integers bit for bit, two runs bitwise equal, and
    the bfloat16 launches counted. Returns (cases, K1 errors, K2 errors)."""
    from dgl_tpu_torch.graph.split import SPLIT_T, row_split
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain
    from dgl_tpu_torch.kernels.seg_sum import seg_sum

    csrs = {"dst": (g.indptr, g.src, g.num_src_nodes, g.split),
            "reverse": (g.reverse.indptr, g.reverse.src, g.num_dst_nodes, g.reverse.split)}
    for name, degrees in _split_degrees(rng, SPLIT_T).items():
        ip, idx = _csr_of(degrees, 3000, rng, dev)
        csrs[f"split {name}"] = (ip, idx, 3000, row_split(ip))
    cases, k1, k2 = 0, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    k1_before, k2_before = csr_spmm.launches_bf16, seg_sum.launches_bf16
    for name, (ip, idx, n_src, plan) in csrs.items():
        e = idx.numel()
        w = torch.from_numpy(rng.uniform(0.5, 1.5, e).astype(np.float32)).to(dev)
        wi = torch.from_numpy(rng.integers(1, 4, e).astype(np.float32)).to(dev)
        for d in K1_BF16_D:
            x, xi = (_bf16_rows(rng, k, n_src, d, dev) for k in ("normal", "integer"))
            if d in BF16_D:
                msg, mi = (_bf16_rows(rng, k, e, d, dev) for k in ("normal", "integer"))
            for indptr in (ip.int(), ip.long()):
                for mean, ww, wwi in ((False, None, None), (True, None, None), (False, w, wi)):
                    what = (f"bf16 {name} D={d} {indptr.dtype} mean={mean} "
                            f"weighted={ww is not None}")
                    got = csr_spmm(indptr, idx, x, ww, mean=mean, split=plan)
                    if got.dtype != torch.float32 or not torch.equal(
                            got, csr_spmm(indptr, idx, x, ww, mean=mean, split=plan)):
                        raise AssertionError(f"{what}: not float32, or two kernel runs differ")
                    _merge(k1, [check(what, got, ip, reference64(ip, idx, x, ww, mean=mean),
                                      csr_spmm_plain(ip, idx, x, ww, mean=mean))])
                    if not mean:
                        check(f"{what} integer", csr_spmm(indptr, idx, xi, wwi, split=plan), ip,
                              reference64(ip, idx, xi, wwi), exact=True)
                    cases += 1
                if d in BF16_D:
                    check_k2(f"bf16 {name} W={d} {indptr.dtype}", indptr, msg, mi, k2, plan)
                    cases += 1
    if csr_spmm.launches_bf16 == k1_before or seg_sum.launches_bf16 == k2_before:
        raise AssertionError("bfloat16 rows launched no bfloat16 kernel")
    return cases, k1, k2


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


def t_sweep(fn, indptr, ts=(256, 512, 1024)):
    """``fn(plan)``'s median ms with the plan of each T in ``ts``; None when
    no row is longer than the least T, as every plan is then empty and times
    the same launch."""
    from dgl_tpu_torch.graph.split import row_split

    plans = {t: row_split(indptr, t) for t in ts}
    if plans[min(ts)].num_long == 0:
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
    misaligned_cases, acc_mis = check_k1_misaligned(rng, dev)
    pair_cases, acc_pairs = check_k1_chunk_pairs(rng, dev)
    t_bf16 = time.perf_counter()
    bf16_cases, bf16_k1, bf16_k2 = check_bf16_k1_k2(np.random.default_rng(15), dev, g)
    torch.cuda.synchronize()
    bf16_s = time.perf_counter() - t_bf16
    emit("random", cases=cases, nodes=n, edges=g.num_edges,
         max_in_degree=int(g.in_degrees().max()), max_out_degree=int(g.out_degrees().max()),
         zero_in_degree_rows=int((g.in_degrees() == 0).sum()), max_abs_err=max(worst, acc[0]),
         max_abs_err_f64=max(worst64, acc[1]), max_bound_used=max(used, acc[2]), rtol=RTOL,
         atol=ATOL, hub_deg=HUB_DEG, deterministic=True, split_cases=split_cases,
         split_max_abs_err=acc[0], split_max_bound_used=acc[2], k1_d=K1_D,
         misaligned_cases=misaligned_cases, misaligned_max_abs_err=acc_mis[0],
         misaligned_max_bound_used=acc_mis[2], chunk_pair_cases=pair_cases,
         chunk_pair_max_abs_err=acc_pairs[0], chunk_pair_max_bound_used=acc_pairs[2],
         **_split_fields(g),
         bf16_cases=bf16_cases, bf16_seconds=bf16_s, bf16_d=BF16_D, bf16_k1_d=K1_BF16_D,
         bf16_k1_max_abs_err=bf16_k1[0], bf16_k1_max_abs_err_f64=bf16_k1[1],
         bf16_k1_max_bound_used=bf16_k1[2], bf16_k2_max_abs_err=bf16_k2[0],
         bf16_k2_max_abs_err_f64=bf16_k2[1], bf16_k2_max_bound_used=bf16_k2[2])


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
        launches = csr_spmm.launches
        err, err64, used = check(f"reddit {side}", kern(), gg.indptr,
                           reference64(gg.indptr, gg.src, xx, mean=mean), plain())
        # the long rows' combine is folded into the one launch
        if csr_spmm.launches - launches != 1:
            raise AssertionError(f"reddit {side}: {gg.split.num_long} long rows, "
                                 f"{csr_spmm.launches - launches} launches")
        if gg.split.counters.any():
            raise AssertionError(f"reddit {side}: the fold left a counter above 0")
        # every edge counted once: integer sums are exact in any order
        check(f"reddit {side} integer", csr_spmm(gg.indptr, gg.src, x_int, split=gg.split),
              gg.indptr, reference64(gg.indptr, gg.src, x_int), exact=True)
        a = torch.sparse_csr_tensor(gg.indptr.long(), gg.src.long(),
                                    torch.ones(e, device=dev), size=(n, n),
                                    check_invariants=False)
        lib_err = (torch.sparse.mm(a, xx)
                   - csr_spmm(gg.indptr, gg.src, xx, split=gg.split)).abs().max().item()
        bound_ms, bound_by = spmm_bound(n, n, e, d, 4)
        kernel_ms, library_ms = in_turns(kern, lambda: torch.sparse.mm(a, xx), reps=30)
        res[side] = {
            "kernel_ms": kernel_ms,
            "plain_ms": median_ms(plain, reps=10, warmup=2),
            "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "floor_ms_computed": spmm_floor(n, e, d, 4),
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
        res[side]["bf16"] = k1_bf16_times(f"reddit {side}", gg.indptr, gg.src, xx, x_int, mean,
                                          gg.split, n, reps=30, plain=True)
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
         bound_ms_fwd=res["fwd"]["bound_ms"], bound_ms_bwd=res["bwd"]["bound_ms"],
         floor_ms_computed_fwd=res["fwd"]["floor_ms_computed"],
         floor_ms_computed_bwd=res["bwd"]["floor_ms_computed"],
         **{f"bf16_{k}_{side}": res[side]["bf16"][k] for side in ("fwd", "bwd")
            for k in ("ms", "ms_f32_in_turns", "plain_ms", "library_ms", "bound_ms",
                      "floor_ms_computed")},
         detail=res)
    return res, g


def k1_bf16_times(what, indptr, idx, x, x_int, mean, split, n_src, reps=20, plain=False):
    """K1's bfloat16 instantiation on ``x`` rounded to bfloat16 (x_int, small
    integers, bit for bit): held to float64 sums of the same values and,
    where ``plain``, to the plain version; timed in turns with the float32
    instantiation on the same values widened to float32, and then in turns
    with torch.sparse.mm on the bfloat16 CSR (where this torch takes it; its
    ``ms`` then); the plain version, the bound and the no-reuse gather floor
    at 2 bytes a feature (the output stays float32)."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    xb = x.to(BF16)
    x32 = xb.float()
    kern = lambda: csr_spmm(indptr, idx, xb, mean=mean, split=split)  # noqa: E731
    kern32 = lambda: csr_spmm(indptr, idx, x32, mean=mean, split=split)  # noqa: E731
    got = kern()
    if got.dtype != torch.float32 or not torch.equal(got, kern()):
        raise AssertionError(f"{what} bf16: not float32, or two kernel runs differ")
    p = csr_spmm_plain(indptr, idx, xb, mean=mean) if plain else None
    ref = (reference64(indptr, idx, xb, mean=mean) if plain
           else reference64_sparse(indptr, idx, xb, n_src, mean))
    err, err64, used = check(f"{what} bf16", got, indptr, ref, p)
    del got, p, ref
    if x_int is not None:
        check(f"{what} bf16 integer", csr_spmm(indptr, idx, x_int.to(BF16), split=split), indptr,
              reference64_sparse(indptr, idx, x_int, n_src, False), exact=True)
    ms32, ms = in_turns(kern32, kern, reps=reps, warmup=3)
    e, n_rows, d = idx.numel(), indptr.numel() - 1, x.shape[1]

    def library():
        a = torch.sparse_csr_tensor(indptr.long(), idx.long(),
                                    torch.ones(e, dtype=BF16, device=x.device),
                                    size=(n_rows, n_src), check_invariants=False)
        return lambda: torch.sparse.mm(a, xb)

    lib_ms, lib_note = bf16_library_ms(library, reps=reps)
    if lib_ms is not None:  # K1 and the library in turns, as at every timed K1 shape
        ms, lib_ms = in_turns(kern, library(), reps=reps)
    bound, by = spmm_bound(n_rows, n_src, e, d, indptr.element_size(), x_bytes=2)
    return {"d": d, "mean": mean, "ms": ms, "ms_f32_in_turns": ms32,
            "floor_ms_computed": spmm_floor(n_rows, e, d, indptr.element_size(), x_bytes=2),
            "plain_ms": (median_ms(lambda: csr_spmm_plain(indptr, idx, xb, mean=mean), reps=5,
                                   warmup=1) if plain else None),
            "library_ms": lib_ms, "library_note": lib_note, "bound_ms": bound, "bound_by": by,
            "max_abs_err": err, "max_abs_err_f64": err64, "max_bound_used": used}


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


def k3_fwd_bound(n_dst, n_src, e, h, d, v_bytes=4):
    """Read indptr, src, v (``v_bytes`` a value: 2 in bfloat16), a_src and
    a_dst once; write out and w1 (N, H, D) and inv_s, w1s, shift (N, H),
    float32. About 4·D + 12 operations per edge and head (two FMAs per
    feature, the logit, exp and scalar sums)."""
    moved = (4 * ((n_dst + 1) + e + n_src * h + n_dst * h + 2 * n_dst * h * d + 3 * n_dst * h)
             + v_bytes * n_src * h * d)
    return _bound_ms(moved, e * h * (4 * d + 12))


def k3_bwd_bound(n_src, n_dst, e, h, d, dropout, v_bytes=4):
    """Read the reverse indptr and dst (and eid with dropout), g (N, H, D),
    the packed node float4s and a_src once; write grad_v (``v_bytes`` a
    value: v's type), w2 (N, H, D) and w3 (N, H)."""
    moved = (4 * ((n_src + 1) + e * (2 if dropout else 1) + n_dst * h * d + 4 * n_dst * h
                  + n_src * h + n_src * h * d + n_src * h)
             + v_bytes * n_src * h * d)
    return _bound_ms(moved, e * h * (4 * d + 14))


def k2_bound(n_rows, e, w, msg_bytes=4):
    """Read msg (``msg_bytes`` a value) and indptr once, write the float32
    out once; one add per element."""
    return _bound_ms(msg_bytes * e * w + 4 * (n_rows + 1 + n_rows * w), e * w)


def _merge(acc, errs):
    for e in errs:
        acc[0], acc[1], acc[2] = max(acc[0], e[0]), max(acc[1], e[1]), max(acc[2], e[2])


def k3_folded(what, fn, plan, before):
    """``fn`` launched (one launch a call since ``before``, its launch and
    combine counts) with no combine launch, and ``plan``'s counters back at
    0: the long rows folded inside the launch."""
    torch.cuda.synchronize()
    if fn.combines != before[1]:
        raise AssertionError(f"{what}: {fn.__name__} made a combine launch")
    if plan.counters.any():
        raise AssertionError(f"{what}: {fn.__name__}'s fold left a counter above 0")


def check_k3_fwd(what, g, v, a_s, a_d, kw, acc):
    """One K3 forward launch against its plain version in float32 and
    float64 (no combine launch, the plan's counters back at 0); returns the
    kernel's outputs."""
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_fwd, gat_attention_fwd_plain

    before = gat_attention_fwd.launches, gat_attention_fwd.combines
    got = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)
    k3_folded(what, gat_attention_fwd, g.split, before)
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


def check_k3_bwd(what, g, g_out, node, a_s, v, kw, acc):
    """One K3 b2 launch against its plain version in float32 and float64
    (no combine launch, the plan's counters back at 0). grad_a_src = Σ_D
    v·w2 − w3 is held to the float64 run within the bound of its terms'
    magnitudes: the run with |v|, |g| and −|C|, whose every term adds."""
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_bwd_plain

    rev = g.reverse
    args = (rev.indptr, rev.src, rev.eid)
    before = gat_attention_bwd.launches, gat_attention_bwd.combines
    got = gat_attention_bwd(*args, g_out, node, a_s, v, split=rev.split, **kw)
    k3_folded(what, gat_attention_bwd, rev.split, before)
    again = gat_attention_bwd(*args, g_out, node, a_s, v, split=rev.split, **kw)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{what}: two K3 b2 runs differ")
    plain = gat_attention_bwd_plain(*args, g_out, node, a_s, v, **kw)
    g64, n64, s64, v64 = g_out.double(), node.double(), a_s.double(), v.double()
    want = gat_attention_bwd_plain(*args, g64, n64, s64, v64, **kw)
    n_abs = n64.clone()
    n_abs[..., 3] = -n_abs[..., 3].abs()
    absrun = gat_attention_bwd_plain(*args, g64.abs(), n_abs, s64, v64.abs(), **kw)
    amp = s64.abs() + n64[..., 0].abs().max() + n64[..., 1].abs().max()  # (N_src, H)
    # grad_a_src: D more terms a row (the dot with v)
    slacks = ((2, 8), (2, 8 + v.shape[-1]))
    names = ("grad_v", "grad_a_src")
    _merge(acc, [check(f"{what} b2 {nm}", x.float(), rev.indptr, (w, m), p, slack=sl, amp=amp)
                 for nm, x, w, m, p, sl in zip(names, got, want, absrun, plain, slacks)])
    return got


def check_k3_exact(what, g, h, d, gen, dtype=torch.float32):
    """Both K3 passes on inputs whose every term float32 holds exactly, so a
    dropped, repeated or misrouted edge shows however long its row, unlike
    the float64 bound, which on a hub row is wide.

    Forward: a_src = 1 and a_dst = 0 make every logit 1, the shift 1 and
    each p = exp(0) = 1, so with small-integer v the sums num and s = deg are
    exact, and out = num / s, inv_s = 1 / s are single float32 divisions,
    which the float64 run rounded to float32 reproduces bit for bit (53 ≥
    2·24 + 2 bits: rounding a quotient twice is innocuous). b2: node =
    (a_dst 0, shift 1, inv_s 1, C integer) and a_src = 1 make α = 1 and the
    slope 1, so grad_v, w2 and w3 are integer sums, and so is grad_a_src =
    Σ_D v·w2 − w3. keep = 0.5 scales the
    kept terms by exactly 2, so the dropout hash is held exactly too.
    ``dtype`` bfloat16: v in bfloat16 (exact for these integers) and b2's
    grad_v rounded once to bfloat16, which must equal the exact sum rounded
    so."""
    from dgl_tpu_torch.kernels.gat_attention import (
        gat_attention_bwd, gat_attention_bwd_plain, gat_attention_fwd, gat_attention_fwd_plain)

    dev = g.indptr.device
    n_src, n_dst, rev = g.num_src_nodes, g.num_dst_nodes, g.reverse
    ints = lambda *shape: torch.randint(-4, 5, shape, device=dev, generator=gen).float()  # noqa: E731
    v, g_out, c = ints(n_src, h, d).to(dtype), ints(n_dst, h, d), ints(n_dst, h)
    a_s = torch.ones(n_src, h, device=dev)
    a_d = torch.zeros(n_dst, h, device=dev)
    node = torch.stack([a_d, torch.ones_like(a_d), torch.ones_like(a_d), c], -1)
    seed = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32, device=dev, generator=gen)
    for keep in (1.0, 0.5):
        kw = dict(negative_slope=0.2, keep=keep, seed=seed)
        got = gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)
        want = gat_attention_fwd_plain(g.indptr, g.src, v.double(), a_s.double(), a_d.double(), **kw)
        got += gat_attention_bwd(rev.indptr, rev.src, rev.eid, g_out, node, a_s, v,
                                 split=rev.split, **kw)
        want += gat_attention_bwd_plain(rev.indptr, rev.src, rev.eid, g_out.double(), node.double(),
                                        a_s.double(), v.double(), **kw)
        names = ("out", "w1", "inv_s", "w1s", "shift", "grad_v", "grad_a_src")
        for nm, x, w in zip(names, got, want):
            if nm == "grad_v":
                w = w.to(v.dtype)  # the plain pass rounds only bfloat16 grad_v
            w = w.float().to(x.dtype)  # exact in float32: one rounding to bfloat16 at most
            if not torch.equal(x, w):
                bad = int((x != w).flatten(1).any(1).nonzero()[0])
                raise AssertionError(f"{what} keep={keep} exact {nm}: row {bad} differs from the "
                                     "exact sums")


def check_k3_b2_bf16(what, g, g_out, node, a_s, v, kw, acc):
    """b2's bfloat16 instantiation (v and grad_v in bfloat16): its grad_v
    must be the float32 instantiation's rounded once to bfloat16, bit for
    bit (the same float32 sums in the same order), its grad_a_src the
    float32 one's on v widened; the float32 pass is held to float64 and its
    plain version by check_k3_bwd; grad_v within one bfloat16 ulp of the
    plain version's (float32 sums in another order, then rounded) on rows
    of at most HUB_DEG terms. Returns the largest difference from the plain
    version."""
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_bwd_plain

    rev = g.reverse
    vb = v.to(BF16)
    args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s)
    got = gat_attention_bwd(*args, vb, split=rev.split, **kw)
    if not torch.equal(got[0], gat_attention_bwd(*args, vb, split=rev.split, **kw)[0]):
        raise AssertionError(f"{what}: two K3 b2 bf16 runs differ")
    ref = check_k3_bwd(what, g, g_out, node, a_s, vb.float(), kw, acc)
    if got[0].dtype != BF16 or not torch.equal(got[0], ref[0].to(BF16)):
        raise AssertionError(f"{what}: b2's bf16 grad_v is not its float32 grad_v rounded once")
    if not torch.equal(got[1], ref[1]):
        raise AssertionError(f"{what}: b2's bf16 grad_a_src differs from the float32 pass's")
    plain = gat_attention_bwd_plain(*args, vb, **kw)[0].float()
    short = (rev.indptr[1:] - rev.indptr[:-1]) <= HUB_DEG
    if not torch.allclose(got[0][short].float(), plain[short], rtol=2.0 ** -7, atol=ATOL):
        raise AssertionError(f"{what}: b2's bf16 grad_v is over one bfloat16 ulp off the plain "
                             "version")
    return (got[0].float() - plain).abs().max().item()


def check_k3_bf16(what, g, v, g_out, a_s, a_d, kw, acc):
    """Both K3 passes with bfloat16 v: the forward (float32 out) against
    float64 runs of the same bfloat16 values within check's bound and the
    plain version (check_k3_fwd), b2 by check_k3_b2_bf16. Returns the
    forward's outputs and b2's largest difference from its plain version."""
    out, w1, inv_s, w1s, shift = check_k3_fwd(f"{what} bf16", g, v.to(BF16), a_s, a_d, kw,
                                              acc["fwd"])
    node = torch.stack([a_d, shift, inv_s, (g_out * out).sum(-1)], -1)
    b2_err = check_k3_b2_bf16(f"{what} bf16", g, g_out, node, a_s, v, kw, acc["bwd"])
    return (out, w1, inv_s, w1s, shift), b2_err


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
                        check_k3_bwd(f"{what} keep={keep}", g, g_out, node, a_s, v, kw,
                                     acc["bwd"])
                        cases += 1
        kw = dict(negative_slope=0.2)
        _refuses_mismatched_plan(gat_attention_fwd, g0.indptr, g0.src, v, a_s, a_d, **kw)
        _refuses_mismatched_plan(gat_attention_bwd, g0.reverse.indptr, g0.reverse.src,
                                 g0.reverse.eid, g_out, node, a_s, v, **kw)
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


K3_H = (1, 2, 4, 8)  # heads: one lane a head up to eight heads a lane group
K3_D = (8, 16, 40, 41, 64)  # every vector width, an odd width, two vectors a lane


def check_k3_misaligned(rng, dev, acc):
    """Both K3 passes with v (the forward's gathered rows; float32 and
    bfloat16) and g (b2's; float32) at bases 4 and 8 bytes off 16-byte
    alignment (bfloat16 v also 2), the storage ending with the array
    (_x_view), H in {1, 4}, D in {16, 41, 64}, keep 0.82, over a graph
    whose edges read the first and last rows often and whose two CSRs both
    have a row over T: float64 bounds, the plain version, two runs bitwise
    equal, no combine launch and the counters back at 0. Returns the number
    of cases."""
    from dgl_tpu_torch import from_edges

    n, e, hub = 700, 30_000, 1500
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    for a in (src, dst):  # a quarter read row 0 or n - 1
        ends = rng.random(e) < 0.25
        a[ends] = np.where(rng.random(int(ends.sum())) < 0.5, 0, n - 1)
    src[:hub], dst[hub:2 * hub] = 3, 5  # a long row in the reverse CSR and in the dst CSR
    g = from_edges(src, dst, n, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    seed = torch.tensor([4321], dtype=torch.int32, device=dev)
    kw = dict(negative_slope=0.2, keep=0.82, seed=seed)
    cases = 0
    for h in (1, 4):
        for d in (16, 41, 64):
            a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
            for dtype in (torch.float32, BF16):
                for shift in ((4, 8) if dtype == torch.float32 else (2, 4, 8)):
                    what = f"misaligned {dtype} +{shift} B H={h} D={d}"
                    v = _x_view(rng, "normal", n, h * d, dtype, shift, dev).view(n, h, d)
                    out, _, inv_s, _, sh = check_k3_fwd(what, g, v, a_s, a_d, kw, acc["fwd"])
                    if dtype == torch.float32:
                        g_out = _x_view(rng, "normal", n, h * d, dtype, shift, dev).view(n, h, d)
                        node = torch.stack([a_d, sh, inv_s, (g_out * out).sum(-1)], -1)
                        check_k3_bwd(what, g, g_out, node, a_s, v, kw, acc["bwd"])
                    cases += 1
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
    for h in K3_H:
        for d in K3_D:
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
                check_k3_bwd(what, g, g_out, node, a_s, v, kw, k3["bwd"])
                cases += 1
            # K2 on the same shapes as GAT's edge form: (E, H·D), both CSRs
            w = h * d
            for side, gg in (("dst", g), ("reverse", g.reverse)):
                msg = 1.0 + torch.randn(g.num_edges, w, device=dev, generator=gen)
                ints = torch.randint(-4, 5, (g.num_edges, w), device=dev, generator=gen).float()
                check_k2(f"{what} {side}", gg.indptr, msg, ints, k2, gg.split)
    split_cases = check_split_k2(np.random.default_rng(4), dev, k2)
    k3_split_cases = check_split_k3(np.random.default_rng(6), dev, k3)
    k3_misaligned_cases = check_k3_misaligned(np.random.default_rng(7), dev, k3)
    # bfloat16 v: both K3 passes' bfloat16 instantiations
    t_bf16 = time.perf_counter()
    k3_bf16 = {"fwd": [0.0, 0.0, 0.0], "bwd": [0.0, 0.0, 0.0]}
    bf16_cases, b2_bf16_err = 0, 0.0
    for h in (1, 4):
        for d in (16, 40, 41):
            v, g_out = (1.0 + torch.randn(n, h, d, device=dev, generator=gen) for _ in range(2))
            a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
            check_k3_exact(f"bf16 H={h} D={d}", g, h, d, gen, dtype=BF16)
            for keep in (1.0, 0.82):
                seed = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32, device=dev,
                                     generator=gen)
                kw = dict(negative_slope=0.2, keep=keep, seed=seed)
                _, err = check_k3_bf16(f"H={h} D={d} keep={keep}", g, v, g_out, a_s, a_d, kw,
                                       k3_bf16)
                b2_bf16_err = max(b2_bf16_err, err)
                bf16_cases += 1
    torch.cuda.synchronize()
    bf16_s = time.perf_counter() - t_bf16
    emit("gat_random", cases=cases, nodes=n, edges=g.num_edges,
         max_in_degree=int(g.in_degrees().max()), max_out_degree=int(g.out_degrees().max()),
         zero_in_degree_rows=int((g.in_degrees() == 0).sum()),
         k3_fwd_max_abs_err=k3["fwd"][0], k3_fwd_max_abs_err_f64=k3["fwd"][1],
         k3_fwd_max_bound_used=k3["fwd"][2], k3_bwd_max_abs_err=k3["bwd"][0],
         k3_bwd_max_abs_err_f64=k3["bwd"][1], k3_bwd_max_bound_used=k3["bwd"][2],
         k2_max_abs_err=k2[0], k2_max_abs_err_f64=k2[1], k2_max_bound_used=k2[2],
         k2_split_cases=split_cases, k3_split_cases=k3_split_cases,
         k3_misaligned_cases=k3_misaligned_cases, k3_heads=K3_H, k3_d=K3_D, rtol=RTOL, atol=ATOL,
         hub_deg=HUB_DEG, deterministic=True, **_split_fields(g),
         bf16_cases=bf16_cases, bf16_seconds=bf16_s,
         k3_fwd_bf16_max_abs_err=k3_bf16["fwd"][0], k3_fwd_bf16_max_abs_err_f64=k3_bf16["fwd"][1],
         k3_fwd_bf16_max_bound_used=k3_bf16["fwd"][2], k3_bwd_bf16_grad_v_max_abs_err=b2_bf16_err,
         k3_bwd_bf16_f32_pass_max_bound_used=k3_bf16["bwd"][2])


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


# K3's launch counters: its two edge passes, then its three node passes
K3_COUNTERS = ("gat_attention_fwd", "gat_attention_bwd", "gat_scores", "gat_score_grad",
               "gat_vector_grad")


def zero_counts(counters):
    """Set each wrapper's launch count, and its combine count where it has
    one, to 0 (K1 has none: its launch folds its long rows; K2's stays 0, as
    its launch folds them too)."""
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "combines"):
            fn.combines = 0


def combine_counts(counters):
    """The combine launches of the wrappers that have a combine launch."""
    return {k: fn.combines for k, fn in counters.items() if hasattr(fn, "combines")}


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
    counted (none), the plain versions' times and the bytes bounds; b2's T
    sweep."""
    from dgl_tpu_torch.kernels.gat_attention import (
        gat_attention_bwd, gat_attention_bwd_plain, gat_attention_fwd, gat_attention_fwd_plain)

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
        gat_attention_fwd, lambda: gat_attention_fwd(*fwd_args, split=g.split, **kw), 0,
        reps=30, warmup=3)
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
    check_k3_bwd(name, g, g_out, node, a_s, v, kw, acc)
    bwd_args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s, v)
    bound, by = k3_bwd_bound(n, n, e, h, d, dropout=keep < 1.0)
    ms, combines = timed_combines(
        gat_attention_bwd, lambda: gat_attention_bwd(*bwd_args, split=rev.split, **kw), 0,
        reps=20, warmup=2)
    res["gat_attention_bwd"] = {
        "ms": ms, "combines_timed": combines,
        "plain_ms": median_ms(lambda: gat_attention_bwd_plain(*bwd_args, **kw), reps=5, warmup=1),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
        "max_row_nnz": int(rev.in_degrees().max()),
        "split_T": rev.split.t, "long_rows": rev.split.num_long, "chunks": rev.split.num_chunks,
        "t_sweep": t_sweep(lambda p: gat_attention_bwd(*bwd_args, split=p, **kw), rev.indptr),
    }
    del node, bwd_args
    res["k3_node_passes"] = k3_node_times(name, n, h, d, gen)
    res.update(k3_bf16_times(name, g, v, g_out, a_s, a_d, kw, keep))
    return res


def k3_node_times(name, n, h, d, gen):
    """K3's node passes at N = n, H = h, D = d (z both sides, v = z, as a
    full-graph GATConv runs them): each output against a float64 run of
    its plain version within 1e-4 of its own largest value (at least 1),
    so an N-wide column sum of the attention vectors' gradients is not the
    yardstick of grad_z; two runs bitwise equal, CUDA-event medians and the
    bytes bound (every array read or written once)."""
    from dgl_tpu_torch.kernels.gat_attention import (
        gat_score_grad, gat_score_grad_plain, gat_scores, gat_scores_plain, gat_vector_grad,
        gat_vector_grad_plain)

    dev = torch.device("cuda")
    rows = lambda: torch.randn(n, h, d, device=dev, generator=gen)  # noqa: E731
    heads = lambda: torch.randn(n, h, device=dev, generator=gen)  # noqa: E731
    z, g_out, out, w1, gv = rows(), rows(), rows(), rows(), rows()
    a_dst, shift, inv_s, w1s, ga_s, ga_d = (heads() for _ in range(6))
    att_s, att_d = (torch.randn(1, h, d, device=dev, generator=gen) for _ in range(2))
    d64 = lambda *ts: [t.double() for t in ts]  # noqa: E731
    calls = {
        "gat_scores": (lambda: gat_scores(z, att_s, att_d),
                       lambda: gat_scores_plain(*d64(z, att_s, att_d)), (n * h * d, 2 * n * h)),
        "gat_score_grad": (lambda: gat_score_grad(g_out, out, w1, a_dst, shift, inv_s, w1s),
                           lambda: gat_score_grad_plain(*d64(g_out, out, w1, a_dst, shift, inv_s,
                                                             w1s)),
                           (3 * n * h * d + 4 * n * h, 5 * n * h)),
        # on a copy of grad_v each call (the pass writes grad_z over it)
        "gat_vector_grad": (lambda: gat_vector_grad(z, att_s, att_d, ga_s, ga_d, grad_v=gv.clone()),
                            lambda: gat_vector_grad_plain(*d64(z, att_s, att_d, ga_s, ga_d, gv)),
                            (2 * n * h * d + 2 * n * h, n * h * d)),
    }
    res = {}
    for key, (call, plain, (reads, writes)) in calls.items():
        got, again = call(), call()
        if not all(torch.equal(x, y) for x, y in zip(got, again) if x is not None):
            raise AssertionError(f"{name} {key}: two runs differ")
        errs = []
        for i, (x, y) in enumerate((x, y) for x, y in zip(got, plain()) if x is not None):
            err, limit = float((x - y).abs().max()), 1e-4 * max(1.0, float(y.abs().max()))
            if err > limit:
                raise AssertionError(f"{name} {key} output {i}: {err} off the float64 plain "
                                     f"version, over {limit}")
            errs.append(err)
        del got, again
        copy_ms = median_ms(gv.clone, reps=20, warmup=2) if key == "gat_vector_grad" else 0.0
        res[key] = {"ms": median_ms(call, reps=20, warmup=2) - copy_ms,
                    "bound_ms": 1e3 * 4 * (reads + writes) / HBM_BYTES_PER_S,
                    "max_abs_err": max(errs), "max_abs_err_by_output": errs}
    return res


# A fused GATConv layer's forward and backward (the scores, K3 and every
# gradient around them), timed against another checkout in turns:
# name: (graph, heads, d, in_feats, keep, backward)
GAT_LAYER_TURN_SHAPES = {
    "reddit_h1_d16": ("reddit", 1, 16, 16, REDDIT_KEEP, True),
    "arxiv_h4_d16": ("ogbn-arxiv", 4, 16, 64, REDDIT_KEEP, True),
    "arxiv_h4_d40": ("ogbn-arxiv", 4, 40, 64, REDDIT_KEEP, True),
    "reddit_raw_h1_d41": ("reddit_raw", 1, 41, 128, 1.0, False),
    "cluster_h4_d64": ("cluster", 4, 64, 100, 0.5, True),
    "cluster_h1_d47": ("cluster", 1, 47, 256, 0.5, True),
}


def gat_layer_parent_turns(parent, card, out_path="gat_layer_turns.jsonl", only=None):
    """A fused GATConv layer of this checkout and of ``parent`` (imported
    as k3_parent_turns imports it) at the main paths' shapes
    (GAT_LAYER_TURN_SHAPES: the layer's heads, width, input width and
    attention dropout; ns_gat's evaluation forward only), with the same
    weights, inputs and dropout seed: its output's and every gradient's
    largest difference, and each tree's CUDA-event time of a forward and
    backward in turns (parent, this, this, parent). One JSON line a shape,
    written to out_path after each, the card's line first."""
    import importlib

    from dgl_tpu_torch import GATConv, from_edges
    from dgl_tpu_torch.data import data_root, load_node_dataset
    from dgl_tpu_torch.sampling.cluster import ClusterIter

    name = "parent_dgl_tpu_torch"
    if name not in sys.modules:
        import importlib.util

        pkg = os.path.join(os.path.abspath(parent), "dgl_tpu_torch")
        spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                      submodule_search_locations=[pkg])
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    convs = (("parent", importlib.import_module(name).GATConv), ("new", GATConv))
    dev, lines = torch.device("cuda"), [{"card": card, "parent": os.path.abspath(parent)}]

    def graph_of(kind):
        if kind in ("reddit", "ogbn-arxiv"):
            return _gat_graph(kind, dev)
        data = load_node_dataset("reddit" if kind == "reddit_raw" else "ogbn-products")
        if kind != "cluster":
            return from_edges(data.src, data.dst, data.num_nodes, device=dev)
        return ClusterIter(PRODUCTS_KEY, data.src, data.dst, data.num_nodes, data.features,
                           data.labels, data.train_mask, CLUSTER_PSIZE, 32, method="metis",
                           cache_dir=data_root(), device=dev).first().graph

    kind_now, g = None, None
    for shape in only or GAT_LAYER_TURN_SHAPES:
        kind, h, d, in_feats, keep, backward = GAT_LAYER_TURN_SHAPES[shape]
        if kind != kind_now:
            g = None
            torch.cuda.empty_cache()
            kind_now, g = kind, graph_of(kind)
        gen = torch.Generator(device=dev).manual_seed(19)
        n = g.num_src_nodes
        x = torch.randn(n, in_feats, device=dev, generator=gen)
        cot = torch.randn(g.num_dst_nodes, h, d, device=dev, generator=gen)
        layers = {t: c(in_feats, d, h, attn_drop=1.0 - keep, fused=True, device=dev,
                       generator=torch.Generator().manual_seed(3)).train(backward)
                  for t, c in convs}

        def step(t):
            conv = layers[t]
            out = conv(g, x, generator=torch.Generator(device=dev).manual_seed(7))
            if backward:
                (out * cot).sum().backward()
            return out

        got = {}
        for t, conv in layers.items():
            conv.zero_grad()
            out = step(t)
            got[t] = [out.detach()] + [p.grad.clone() for p in conv.parameters() if backward]
        diff = max(float((a - b).abs().max()) for a, b in zip(got["parent"], got["new"]))
        parent_ms, new_ms = in_turns(lambda: step("parent"), lambda: step("new"), reps=10,
                                     warmup=2)
        row = {"shape": shape, "heads": h, "d": d, "in_feats": in_feats, "keep": keep,
               "backward": backward, "nodes": n, "edges": g.num_edges, "parent_ms": parent_ms,
               "new_ms": new_ms, "new_over_parent": new_ms / parent_ms, "max_abs_diff": diff}
        print(json.dumps(row), flush=True)
        lines.append(row)
        with open(out_path, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
        del layers, got, x, cot
    return lines


def k3_bf16_times(name, g, v, g_out, a_s, a_d, kw, keep):
    """Both K3 passes' bfloat16 instantiations on ``g`` (check_k3_bf16),
    each timed in turns with its float32 instantiation on the same values
    (v rounded to bfloat16, then widened), the plain versions and the bytes
    bounds at 2 bytes a value of v (forward) and of grad_v (b2)."""
    from dgl_tpu_torch.kernels.gat_attention import (
        gat_attention_bwd, gat_attention_bwd_plain, gat_attention_fwd, gat_attention_fwd_plain)

    rev = g.reverse
    n, e, (h, d) = g.num_dst_nodes, g.num_edges, v.shape[1:]
    acc = {"fwd": [0.0, 0.0, 0.0], "bwd": [0.0, 0.0, 0.0]}
    (out, _, inv_s, _, shift), b2_err = check_k3_bf16(name, g, v, g_out, a_s, a_d, kw, acc)
    vb = v.to(BF16)
    v32 = vb.float()
    fwd = lambda vv: lambda: gat_attention_fwd(g.indptr, g.src, vv, a_s, a_d,  # noqa: E731
                                               split=g.split, **kw)
    ms32, ms = in_turns(fwd(v32), fwd(vb), reps=20, warmup=2)
    bound, by = k3_fwd_bound(n, n, e, h, d, v_bytes=2)
    res = {"gat_attention_fwd_bf16": {
        "ms": ms, "ms_f32_in_turns": ms32,
        "plain_ms": median_ms(lambda: gat_attention_fwd_plain(g.indptr, g.src, vb, a_s, a_d, **kw),
                              reps=5, warmup=1),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "max_abs_err": acc["fwd"][0], "max_abs_err_f64": acc["fwd"][1],
        "max_bound_used": acc["fwd"][2]}}
    node = torch.stack([a_d, shift, inv_s, (g_out * out).sum(-1)], -1)
    del out, inv_s, shift
    args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s)
    b2 = lambda vv: lambda: gat_attention_bwd(*args, vv, split=rev.split, **kw)  # noqa: E731
    ms32, ms = in_turns(b2(v32), b2(vb), reps=20, warmup=2)
    bound, by = k3_bwd_bound(n, n, e, h, d, dropout=keep < 1.0, v_bytes=2)
    res["gat_attention_bwd_bf16"] = {
        "ms": ms, "ms_f32_in_turns": ms32,
        "plain_ms": median_ms(lambda: gat_attention_bwd_plain(*args, vb, **kw), reps=5,
                              warmup=1),
        "library_ms": None, "bound_ms": bound, "bound_by": by, "max_abs_err": b2_err,
        "max_abs_err_f64": None, "max_bound_used": acc["bwd"][2],
        "f32_pass_max_abs_err_f64": acc["bwd"][1]}
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


# bf16 layer against the float32 one, of the largest entry: the output, and
# the input gradient, whose sums of bfloat16-rounded products cancel more
# (the JAX package's own bf16 attention test allows 0.05 against float32,
# tests/test_attention_kernel.py:test_lane_gat_bf16_close)
GATCONV_BF16_ATOL = 1e-2
GATCONV_BF16_GRAD_ATOL = 5e-2


def gatconv_bf16_step(g, gen, in_feats=500, heads=8, d=8):
    """The bf16 GAT layer on ``g`` (pubmed with self-loops; its first GAT
    layer's shape): GATConv(edge_dtype=bfloat16) forward and backward in the
    fused form (K3's two bfloat16 passes, one launch each) and the edge form
    (the copy_e sum one bfloat16 K2 launch, gather_src_rows' adjoint one
    bfloat16 K1 launch), each beside the float32 layer with the same
    weights, every kernel's launches and bfloat16 launches counted around
    each: the float32 layer launches no bfloat16 kernel. Output and input
    gradient within GATCONV_BF16_ATOL and GATCONV_BF16_GRAD_ATOL of the
    float32 layer's largest entry.
    Returns each form's launches and errors."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_bwd, gat_attention_fwd
    from dgl_tpu_torch.kernels.seg_sum import seg_sum
    from dgl_tpu_torch.nn import GATConv

    dev = g.indptr.device
    n = g.num_dst_nodes
    counters = {"csr_spmm": csr_spmm, "seg_sum": seg_sum, "gat_attention_fwd": gat_attention_fwd,
                "gat_attention_bwd": gat_attention_bwd}
    x = 1.0 + torch.randn(n, in_feats, device=dev, generator=gen)
    cot = torch.randn(n, heads, d, device=dev, generator=gen)
    want = {"fused": {"gat_attention_fwd": 1, "gat_attention_bwd": 1},
            "edge": {"seg_sum": 1, "csr_spmm": 1}}
    res = {}
    for form in ("fused", "edge"):
        runs = {}
        for dtype in (torch.float32, BF16):
            conv = GATConv(in_feats, d, heads, edge_dtype=None if dtype == torch.float32 else dtype,
                           fused=form == "fused", device=dev,
                           generator=torch.Generator().manual_seed(9))
            xk = x.clone().requires_grad_()
            torch.cuda.synchronize()
            before = {k: (c.launches, c.launches_bf16) for k, c in counters.items()}
            out = conv(g, xk)
            out.backward(cot)
            torch.cuda.synchronize()
            bf16 = {k: c.launches_bf16 - before[k][1] for k, c in counters.items()}
            runs[dtype] = (out.detach(), xk.grad, bf16,
                           {k: c.launches - before[k][0] for k, c in counters.items()})
        (o32, g32, bf32, _), (o16, g16, bf16, l16) = runs[torch.float32], runs[BF16]
        if any(bf32.values()):
            raise AssertionError(f"the float32 {form} GATConv launched bfloat16 kernels: {bf32}")
        if {k: v for k, v in bf16.items() if v} != want[form]:
            raise AssertionError(f"the bf16 {form} GATConv's bfloat16 launches {bf16}; "
                                 f"want {want[form]}")
        err = (o16 - o32).abs().max().item() / o32.abs().max().item()
        gerr = (g16 - g32).abs().max().item() / g32.abs().max().item()
        if not (err <= GATCONV_BF16_ATOL and gerr <= GATCONV_BF16_GRAD_ATOL):
            raise AssertionError(f"the bf16 {form} GATConv is {err} (output) / {gerr} (gradient) "
                                 "off the float32 layer, relative to the largest entry")
        res[form] = {"launches_bf16": bf16, "launches": l16, "out_rel_err": err,
                     "grad_rel_err": gerr}
    return res


def k2_bf16_times(indptr, msg, ints, split):
    """K2's bfloat16 instantiation on ``msg`` rounded to bfloat16 (check_k2:
    float64 sums of the same values within the float32 bound, the plain
    version, integers bit for bit), timed in turns with the float32 one on
    the same values widened, beside the plain version, segment_reduce on the
    bfloat16 messages and the bound at 2 bytes a value."""
    from dgl_tpu_torch.kernels.seg_sum import seg_sum, seg_sum_plain

    mb, acc = msg.to(BF16), [0.0, 0.0, 0.0]
    check_k2("reddit fwd bf16", indptr, mb, ints.to(BF16), acc, split)
    m32 = mb.float()
    kern = lambda: seg_sum(indptr, mb, split=split)  # noqa: E731
    ms32, ms = in_turns(lambda: seg_sum(indptr, m32, split=split), kern, reps=20, warmup=2)
    offsets = indptr.long()
    lib_call = lambda: torch.segment_reduce(mb, "sum", offsets=offsets)  # noqa: E731
    lib, note = bf16_library_ms(lambda: lib_call, reps=20, warmup=2)
    n, (e, w) = indptr.numel() - 1, msg.shape
    bound, by = k2_bound(n, e, w, msg_bytes=2)
    return {"ms": ms, "ms_f32_in_turns": ms32,
            "plain_ms": median_ms(lambda: seg_sum_plain(indptr, mb), reps=5, warmup=1),
            "library_ms": lib, "library_note": note, "bound_ms": bound, "bound_by": by,
            "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
            "host_device": host_and_device(kern),
            "library_host_device": host_and_device(lib_call) if lib is not None else None}


def k2_reddit(g, gen, res):
    """K2 at (E, 16) on reddit with self-loops over the dst and the reverse
    CSR (check_k2: float64 bounds, the plain version, integers bit for bit,
    two runs equal; one launch a call, no combine launch), CUDA-event
    medians of the kernel, the plain version, segment_reduce and index_add_
    (its row ids made outside the timed calls), each call's host and device
    time (host_and_device), the T sweep and the bound; the bfloat16
    instantiation over the dst CSR (k2_bf16_times). Fills
    res["seg_sum_fwd"], res["seg_sum_rev"] and res["seg_sum_bf16"]."""
    from dgl_tpu_torch.kernels.seg_sum import csr_rows, seg_sum, seg_sum_plain

    dev = g.indptr.device
    n, e, d = g.num_dst_nodes, g.num_edges, 16
    msg = 1.0 + torch.randn(e, d, device=dev, generator=gen)
    ints = torch.randint(-4, 5, (e, d), device=dev, generator=gen).float()
    for side, gg in (("fwd", g), ("rev", g.reverse)):
        indptr, acc = gg.indptr, [0.0, 0.0, 0.0]
        launches, combines = seg_sum.launches, seg_sum.combines
        got = check_k2(f"reddit {side}", indptr, msg, ints, acc, gg.split)
        # three runs, three launches: the long rows fold inside each
        if (seg_sum.launches - launches, seg_sum.combines - combines) != (3, 0):
            raise AssertionError(f"reddit {side}: {seg_sum.launches - launches} K2 launches and "
                                 f"{seg_sum.combines - combines} combine launches in three runs; "
                                 "want 3 and 0")
        if gg.split.counters.any():
            raise AssertionError(f"reddit {side}: the plan's counters are not back at 0")
        offsets = indptr.long()
        rows = csr_rows(indptr, e)  # index_add_'s row ids, made outside the timed calls
        lib = torch.segment_reduce(msg, "sum", offsets=offsets)
        bound, by = k2_bound(n, e, d)
        kern = lambda: seg_sum(indptr, msg, split=gg.split)  # noqa: E731
        segment_reduce = lambda: torch.segment_reduce(msg, "sum", offsets=offsets)  # noqa: E731
        r = res[f"seg_sum_{side}"] = {
            "ms": median_ms(kern, reps=20, warmup=2),
            "plain_ms": median_ms(lambda: seg_sum_plain(indptr, msg), reps=5, warmup=1),
            "library_ms": median_ms(segment_reduce, reps=20, warmup=2),
            "index_add_ms": median_ms(lambda: torch.zeros(n, d, device=dev).index_add_(0, rows, msg),
                                      reps=20, warmup=2),
            "library_max_abs_err_vs_kernel": (lib - got).abs().max().item(),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
            "max_row_nnz": int((indptr[1:] - indptr[:-1]).max()),
            "split_T": gg.split.t, "long_rows": gg.split.num_long, "chunks": gg.split.num_chunks,
            "t_sweep": t_sweep(lambda p: seg_sum(indptr, msg, split=p), indptr),
            "host_device": host_and_device(kern),
            "library_host_device": host_and_device(segment_reduce),
        }
        r["at_or_below_segment_reduce"] = r["ms"] <= r["library_ms"]
        r["at_or_below_index_add"] = r["ms"] <= r["index_add_ms"]
        del rows, lib, got
        if side == "fwd":  # the edge form's bf16 copy_e sum runs over the dst CSR
            res["seg_sum_bf16"] = k2_bf16_times(indptr, msg, ints, gg.split)
    return msg


def phase_gat_reddit():
    from dgl_tpu_torch.kernels.seg_sum import seg_sum
    from dgl_tpu_torch.ops import seg_sum_dst

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    g = _gat_graph("reddit", dev)
    load_s = time.perf_counter() - t0
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
    msg = k2_reddit(g, gen, res)
    # seg_sum_dst's forward and backward on the card read nothing back: no host sync
    mk = msg.clone().requires_grad_()
    cot = torch.randn(n, d, device=dev, generator=gen)
    no_host_sync(lambda: seg_sum_dst(g, mk).backward(cot),
                 lambda: seg_sum(g.indptr, msg))  # no plan: built from indptr, a sync
    if mk.grad is None:
        raise AssertionError("seg_sum_dst's backward gave no gradient under the sync check")
    del msg, mk
    pubmed = _gat_graph("pubmed", dev)
    adjoint = {"reddit": adjoint_times(g, d, gen), "pubmed": adjoint_times(pubmed, 64, gen)}
    gatconv_bf16 = gatconv_bf16_step(pubmed, gen)
    del pubmed
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
         arxiv=arxiv_fields, detail=res, detail_arxiv=res_arxiv, detail_arxiv_d40=res_arxiv40,
         gatconv_bf16_pubmed=gatconv_bf16)
    return res, res_arxiv, res_arxiv40, g, gatconv_bf16


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
    """P1 in both orders and P2 against x[idx], bit for bit, on every path
    the kernels have: float32 and bfloat16, int32 and int64 indices, ragged
    e, copies of 16, 8, 4 and 2 bytes (rows of 41 bfloat16 values; x
    shifted off its alignment), P1's staged pieces (1 KB rows) and column
    pieces (40 KB rows), P2 up to and at its shared-memory limit; then P2's
    refusal above the limit, before any launch. P1 in source order takes
    gather_plan(idx, n) and is also held to its plain version, and on a row of more than 100k positions (the
    split), rows with no position, pos=None (a dst CSR's gather) and
    without a split. Returns the number of cases."""
    from dgl_tpu_torch.graph.split import row_split
    from dgl_tpu_torch.kernels.row_gather import (
        SMEM_LIMIT_BYTES, gather_plan, row_gather_async, row_gather_by_source,
        row_gather_by_source_plain, row_gather_plain, row_gather_smem)

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

    def hold_by_source(what, x, indptr, pos, split, want=None):
        nonlocal cases
        got = row_gather_by_source(x, indptr, pos, split)
        plain = row_gather_by_source_plain(x, indptr, pos)
        for name, ref in (("its plain version", plain), ("x[idx]", want)):
            if ref is not None and not torch.equal(got, ref):
                bad = int((got != ref).flatten(1).any(1).nonzero()[0])
                raise AssertionError(f"row_gather_by_source {what}: row {bad} differs from {name}")
        if not torch.equal(got, row_gather_by_source(x, indptr, pos, split)):
            raise AssertionError(f"row_gather_by_source {what}: two runs differ")
        cases += 1

    def inputs(n, d, e, dtype, shift=0):
        base = torch.randn(n * d + shift, device=dev, generator=gen).to(dtype)
        idx = torch.randint(0, n, (e,), device=dev, generator=gen)
        idx[: min(e, 64)] = n - 1  # the last row, and one row read many times
        return base[shift:].view(n, d), idx

    # (n, d, e, tiles) for P1 and P2; every e is ragged against every tile
    # (1682, 75): GCMC's decoder rows, whose last one ends off 16 bytes of x's
    # end in both types (its span cannot be one bulk copy)
    p1 = [(5000, 16, 100_003, (128, 256)), (3000, 41, 77_777, (128, 256)),
          (2000, 256, 10_001, (128, 256)), (300, 10_000, 1_001, (1, 256)),
          (1000, 1, 5_003, (256, 1000)), (1682, 75, 85_000, (128, 256))]
    p2 = [(2708, 16, 100_003, (512, 2048)), (500, 41, 77_777, (512, 100)),
          (227, 256, 10_001, (512, 2048))]  # 227 rows of 1 KB: exactly the limit
    for fn, shapes in ((row_gather_async, p1), (row_gather_smem, p2)):
        for n, d, e, tiles in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x, idx = inputs(n, d, e, dtype)
                for ii in (idx.int(), idx):
                    for tile in tiles:
                        hold(f"{fn.__name__} ({n}, {d}) {dtype} e={e} {ii.dtype}", fn, x, ii, tile)
                    if fn is row_gather_async:
                        hold_by_source(f"({n}, {d}) {dtype} e={e} {ii.dtype}", x,
                                       *gather_plan(ii, n), want=x[ii])
    for fn in (row_gather_async, row_gather_smem):  # x 8 and 4 bytes off 16-byte alignment
        for shift in (2, 1):
            x, idx = inputs(2708, 16, 50_001, torch.float32, shift)
            hold(f"{fn.__name__} x shifted by {shift} floats", fn, x, idx.int(), 512)
            if fn is row_gather_async:
                hold_by_source(f"x shifted by {shift} floats", x, *gather_plan(idx.int(), 2708),
                               want=x[idx])
    # the split: one row of 120k positions (235 chunks of T = 512), rows
    # with no position (idx reads only the lower half), int64 positions
    n = 5000
    x, _ = inputs(n, 16, 1, torch.float32)
    idx = torch.cat([torch.full((120_000,), 7, device=dev),
                     torch.randint(0, n // 2, (30_000,), device=dev, generator=gen)])
    idx = idx[torch.randperm(idx.numel(), device=dev, generator=gen)]
    plan = gather_plan(idx, n)
    if plan.split.num_long == 0 or int(plan.indptr[-1] - plan.indptr[n // 2]) != 0:
        raise AssertionError("the long-row case has no long row or no empty row")
    for what, p in (("a 120k-position row", plan), ("int64 positions",
                                                    plan._replace(pos=plan.pos.long())),
                    ("no split", plan._replace(split=None))):
        hold_by_source(what, x, *p, want=x[idx])
    # pos=None: a dst CSR's v[dst[j]], its rows long, short and empty
    deg = torch.tensor([0, 3, 100_001, 0, 1, 513, 512, 2], device=dev)
    ip = torch.zeros(deg.numel() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=ip[1:])
    for d, dtype in ((16, torch.float32), (8, torch.float32), (1, torch.float32),
                     (41, torch.bfloat16)):
        v, _ = inputs(deg.numel(), d, 1, dtype)
        want = v.repeat_interleave(deg, dim=0)
        hold_by_source(f"pos=None d={d} {dtype}", v, ip, None, row_split(ip), want=want)
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
    """P1 in both orders and P2 checked, the probe run as the path's main
    path, and the gather floor of K1 and K3 measured on their own index
    streams, with P1 in source order and its plan's build beside P1 in
    index order and index_select on each."""
    from dgl_tpu_torch.kernels.row_gather import (
        gather_plan, row_gather_async, row_gather_by_source, row_gather_by_source_plain,
        row_gather_plain, row_gather_smem)
    from dgl_tpu_torch.tools import exp_dma_gather
    from dgl_tpu_torch.train.timing import device_profile

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = check_row_gather(gen)

    # the main path: the probe, each run with the counters set to 0 before it
    counters = {"row_gather_async": row_gather_async, "row_gather_smem": row_gather_smem,
                "row_gather_by_source": row_gather_by_source}
    probe, launches = {}, {}
    for key, argv in (("default", []), ("cora_d16", ["--n", "2708", "--d", "16"])):
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            lines = exp_dma_gather.main(argv)
        launches[key] = {k: fn.launches for k, fn in counters.items()}
        probe[key] = {"stdout": log.getvalue().splitlines(), "lines": lines}
        # only P2's refusal of the default 173 MB x may fail, at both tiles
        failed = [ln for ln in lines if "failed" in ln]
        if len(lines) != 8 or len(failed) != (2 if key == "default" else 0) or not all(
                ln["name"] == "row_gather_smem" and ln["failed"].startswith("ValueError")
                for ln in failed):
            raise AssertionError(f"probe {key}: unexpected lines {lines}")
        if any(ln["maxerr"] != 0.0 for ln in lines if "maxerr" in ln):
            raise AssertionError(f"probe {key}: a gather differs from x[idx]: {lines}")
        torch.cuda.empty_cache()
    # per tile of P1 in index order and of P2: 1 checked call, 2 cold, 6
    # timed; P1 in source order the same for its line, and 1 for the plan line
    want = {"default": {"row_gather_async": 18, "row_gather_smem": 0, "row_gather_by_source": 10},
            "cora_d16": {"row_gather_async": 18, "row_gather_smem": 18,
                         "row_gather_by_source": 10}}
    if launches != want:
        raise AssertionError(f"probe launches {launches}; want {want}")

    # the gather floor on the kernels' own index streams
    pubmed = _gat_graph("pubmed", dev)
    tool_x, tool_idx = exp_dma_gather.make_inputs(169343, 256, 2332486, torch.float32, dev)
    streams = {  # name: (idx, n, d, the kernel that gathers these rows, its ms, the graph's plan)
        "k1_fwd": (red_graph.src, red_graph.num_src_nodes, 16, "K1 forward", red["fwd"]["kernel_ms"],
                   red_graph.reverse),
        "k1_bwd": (red_graph.reverse.src, red_graph.num_dst_nodes, 16, "K1 backward",
                   red["bwd"]["kernel_ms"], None),
        "k3_fwd": (gat_graph.src, gat_graph.num_src_nodes, 16, "K3 forward",
                   gred["gat_attention_fwd"]["ms"], gat_graph.reverse),
        # b2 gathers g's rows by each reverse slot's original dst
        "k3_b2": (gat_graph.reverse.src, gat_graph.num_dst_nodes, 16, "K3 b2",
                  gred["gat_attention_bwd"]["ms"], None),
        "gather_src_rows": (pubmed.src, pubmed.num_src_nodes, 64,
                            "gather_src_rows (P1 in source order)", None, pubmed.reverse),
        "tool_default": (tool_idx, 169343, 256, None, None, None),
    }
    floors = {}
    for key, (idx, n, d, kernel, kernel_ms, rev) in streams.items():
        x = tool_x if key == "tool_default" else torch.randn(n, d, device=dev, generator=gen)
        buf = torch.empty(idx.numel(), d, device=dev)
        want_rows = x.index_select(0, idx)
        plan = gather_plan(idx, n)
        if rev is not None and not (torch.equal(plan.indptr, rev.indptr)
                                    and torch.equal(plan.pos, rev.eid)):
            raise AssertionError(f"{key}: the plan of src is not the graph's reverse CSR")
        for name, got in (("P1", row_gather_async(x, idx)),
                          ("P1 in source order", row_gather_by_source(x, *plan))):
            if not torch.equal(got, want_rows):
                raise AssertionError(f"{key}: {name} differs from index_select")
        del got, want_rows
        p1 = {tile: median_ms(lambda: row_gather_async(x, idx, tile=tile), reps=20, warmup=3)
              for tile in (128, 256)}
        by_source = lambda: row_gather_by_source(x, *plan)  # noqa: E731
        src_ms = median_ms(by_source, reps=20, warmup=3)
        plan_ms = median_ms(lambda: gather_plan(idx, n), reps=10, warmup=2)
        lib = median_ms(lambda: x.index_select(0, idx), reps=20, warmup=3)
        idx64 = idx.long()
        lib64 = median_ms(lambda: x.index_select(0, idx64), reps=20, warmup=3)
        fill = median_ms(lambda: buf.fill_(1.0), reps=20, warmup=3)
        # an event pair around one call also spans the wrapper's host work,
        # which a small gather (pubmed's) does not hide: each call's host
        # time and the profiler's device time beside it (host_and_device)
        split = {name: host_and_device(fn) for name, fn in (
            ("p1", lambda: row_gather_async(x, idx)), ("by_source", by_source),
            ("index_select", lambda: x.index_select(0, idx)))}
        busy = {name: hd["device_ms_a_call"] for name, hd in split.items()}
        busy["fill"] = device_profile(lambda: buf.fill_(1.0), 20, dev)["device_busy_ms_per_epoch"]
        bound, by, bound_rows = gather_bound(idx, 4 * d)
        floors[key] = {
            "rows": idx.numel(), "n": n, "d": d, "p1_ms_tile128": p1[128], "p1_ms_tile256": p1[256],
            "by_source_ms": src_ms, "plan_ms": plan_ms,
            "long_rows": plan.split.num_long, "chunks": plan.split.num_chunks,
            "index_select_ms": lib, "index_select_int64_ms": lib64, "fill_ms": fill,
            # the time to read the indexed rows alone: P1 (its faster tile) less the write
            "gather_floor_ms": min(p1.values()) - fill,
            "p1_device_ms": busy["p1"], "by_source_device_ms": busy["by_source"],
            "index_select_device_ms": busy["index_select"],
            "fill_device_ms": busy["fill"], "gather_floor_device_ms": busy["p1"] - busy["fill"],
            "host_device": split,
            "bound_ms": bound, "bound_ms_e_rows": bound_rows,
            "kernel": kernel, "kernel_ms": src_ms if key == "gather_src_rows" else kernel_ms,
        }
        if key == "tool_default":
            floors[key]["plain_ms"] = median_ms(lambda: row_gather_plain(x, idx), reps=10, warmup=2)
            floors[key]["by_source_plain_ms"] = median_ms(
                lambda: row_gather_by_source_plain(x, plan.indptr, plan.pos), reps=10, warmup=2)
            floors[key]["bound_by"] = by
        del buf, idx64, plan
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
         **{f"gather_floor_ms_{k}": f["gather_floor_ms"] for k, f in floors.items()},
         **{f"by_source_ms_{k}": f["by_source_ms"] for k, f in floors.items()})
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
        "row_gather_by_source": {
            "launches": launches["default"]["row_gather_by_source"], "max_abs_err": max(
                ln["maxerr"] for ln in probe["default"]["lines"]
                if ln["name"] in ("row_gather_by_source", "gather_plan")),
            "ms": default["by_source_ms"], "plain_ms": default["by_source_plain_ms"],
            "library_ms": default["index_select_ms"], "bound_ms": default["bound_ms"],
            "bound_by": default["bound_by"], "plan_ms": default["plan_ms"],
            "index_order_ms": default["p1_ms_tile256"],
            **{f"{k}_{stream}": floors[stream][f] for stream in ("k1_fwd", "gather_src_rows")
               for k, f in (("ms", "by_source_ms"), ("plan_ms", "plan_ms"),
                            ("library_ms", "index_select_ms"), ("bound_ms", "bound_ms"),
                            ("index_order_ms", "p1_ms_tile256"))},
            **{f"{k}_{stream}": floors[stream]["host_device"][order][f]
               for stream in ("k1_fwd", "gather_src_rows", "tool_default")
               for order, pre in (("by_source", ""), ("p1", "index_order_"),
                                  ("index_select", "library_"))
               for k, f in ((f"{pre}host_ms", "host_ms_a_call"),
                            (f"{pre}device_ms", "device_ms_a_call"))},
            "shape": f"x (169343, 256) float32, e = {default['rows']} (the probe's default), "
                     "the plan built beforehand",
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


def gat_edge_per_step(layers=3, lowering="fused"):
    """Launches of one training step of GAT's edge form (pubmed), from the
    code (nn/conv.py:GATConv._edge, ops/gather.py, ops/softmax.py,
    ops/spmm.py, ops/segment.py), per layer:
      P1 in source order, forward: gather_src_rows(z) over the reverse CSR,
        gather_dst(a_dst), and in edge_softmax gather_dst(shift) and
        spread_dst(denominators) over the dst CSR (4);
      P1 in source order, backward: the adjoints of seg_sum_dst in
        edge_softmax and of gspmm(copy_e, sum) (2);
      K2 forward: edge_softmax's seg_sum_dst and gspmm(copy_e, sum) (2);
      K2 backward: the adjoints of spread_dst and gather_dst(a_dst) (2);
      K1 backward: gather_src_rows' adjoint over the reverse CSR (1).
    Under lowering="scatter" gspmm(copy_e, sum) is index_add_ and its
    adjoint index_select: one K2 and one P1 a layer fewer.
    Returns (per step, per edge-softmax rescue): a rescue (every term of a
    row underflowed under the loose bound) runs the exact form's forward as
    well, one seg_sum_dst and two P1 gathers more; its backward replaces
    the loose form's."""
    per_layer = {"csr_spmm": 1, "seg_sum": 4, "row_gather_by_source": 6}
    if lowering == "scatter":
        per_layer = {"csr_spmm": 1, "seg_sum": 3, "row_gather_by_source": 5}
    return ({k: n * layers for k, n in per_layer.items()},
            {"csr_spmm": 0, "seg_sum": 1, "row_gather_by_source": 2})


def _names_index_select(kernels):
    """The profiled kernels that are PyTorch's index_select."""
    return [k["name"] for k in kernels if "indexselect" in k["name"].lower().replace("_", "")]


def graph_gather_checks(g, gen):
    """The four row gathers of the graph ops on pubmed's graph at its
    widths (z: 8 heads × 8, a_dst: 8 heads): gather_src_rows, gather_dst,
    spread_dst and segment_sum's backward. Forwards (and segment_sum's
    gradient, a gather) bit for bit against index_select; the other
    gradients (K1 over the reverse CSR, K2 over the dst CSR) against
    float64 sums within check's bounds and the plain versions at RTOL/ATOL;
    all four forward and backward under set_sync_debug_mode("error"); a
    profile of the same shows P1 in source order and no index_select."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm_plain
    from dgl_tpu_torch.kernels.row_gather import gather_plan
    from dgl_tpu_torch.kernels.seg_sum import seg_sum_plain
    from dgl_tpu_torch.ops import gather_dst, gather_src_rows, segment_sum, spread_dst
    from dgl_tpu_torch.train.timing import device_profile

    dev = g.indptr.device
    n, e, rev = g.num_dst_nodes, g.num_edges, g.reverse
    src, dst = g.src.long(), g.dst.long()
    around1 = lambda *shape: 1.0 + torch.randn(*shape, device=dev, generator=gen)  # noqa: E731
    z, a, b, msg = (around1(*shape).requires_grad_() for shape in ((n, 8, 8), (n, 8), (n, 8), (e, 8)))
    cots = (around1(e, 8, 8), around1(e, 8), around1(e, 8), around1(n, 8))

    def run():
        for t in (z, a, b, msg):
            t.grad = None
        outs = (gather_src_rows(g, z), gather_dst(g, a), spread_dst(g, b),
                segment_sum(msg, g.dst, g.indptr, g.split))
        sum((o * c).sum() for o, c in zip(outs, cots)).backward()
        return outs

    outs = run()
    for what, got, want in (("gather_src_rows", outs[0], z.detach().index_select(0, src)),
                            ("gather_dst", outs[1], a.detach().index_select(0, dst)),
                            ("spread_dst", outs[2], b.detach().index_select(0, dst)),
                            ("segment_sum's gradient", msg.grad, cots[3].index_select(0, dst))):
        if not torch.equal(got, want):
            raise AssertionError(f"pubmed {what} differs from index_select")
    acc = [0.0, 0.0, 0.0]
    cz = cots[0].reshape(e, -1)
    _merge(acc, [check("pubmed gather_src_rows' gradient", z.grad.reshape(n, -1), rev.indptr,
                       (csr_spmm_plain(rev.indptr, rev.eid, cz.double()),
                        csr_spmm_plain(rev.indptr, rev.eid, cz.double().abs())),
                       csr_spmm_plain(rev.indptr, rev.eid, cz))])
    for what, t, c in (("gather_dst", a, cots[1]), ("spread_dst", b, cots[2])):
        _merge(acc, [check(f"pubmed {what}'s gradient", t.grad, g.indptr,
                           (seg_sum_plain(g.indptr, c.double()),
                            seg_sum_plain(g.indptr, c.double().abs())),
                           seg_sum_plain(g.indptr, c), slack=(2, 8))])
    grads = [t.grad.clone() for t in (z, a, b, msg)]
    run()
    if not all(torch.equal(x, t.grad) for x, t in zip(grads, (z, a, b, msg))):
        raise AssertionError("pubmed graph gathers: two runs' gradients differ")
    no_host_sync(run, lambda: gather_plan(g.src, n))  # a plan's build reads indptr back
    kernels = device_profile(run, 3, dev, unit="call")["kernels"]
    if _names_index_select(kernels) or not any(
            "row_gather_by_source" in k["name"] for k in kernels):
        raise AssertionError(f"pubmed graph gathers: profiled kernels {[k['name'] for k in kernels]}")
    return {"max_abs_err": acc[0], "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
            "no_host_sync": True, "deterministic": True,
            "kernels": [{"name": k["name"][:80], "device_ms": k["device_ms_per_call"],
                         "calls": k["calls_per_call"]} for k in kernels[:8]]}


def fused_gat_memory_bound(n, in_feats, hidden, classes, heads):
    """The bytes a full-graph training step of main_gat's fused GAT may add
    above its graph and data, from the code (models/gat.py, nn/conv.py,
    kernels/gat_attention.py, benchmarks/common.py), in float32 elements a
    node: what the forward keeps for the backward, a layer i from width w
    to H·D: dropout's mask and output (2 w, none in layer 0, which has no
    feature dropout), z, K3's out and w1 and elu's output (4 H·D; the last
    layer keeps the head mean's D instead of an elu output, counted as H·D),
    a_src, a_dst, inv_s, w1s and shift (5 H); the loss's log-softmax (the
    classes); and the backward's largest live set beside it, at the widest
    layer: the output cotangent, grad_v, w2 and two products of the closed
    forms (5 H·D). The parameters, Adam's moments and the (N, H) gradients
    are below 1 % of it. An (E, H·D) per-edge tensor at arxiv's first
    layer (2,111,439 edges: 540 MB) on top of the measured peak would pass
    it."""
    per_node, w = classes, in_feats
    for i, h in enumerate(heads):
        d = classes if i == len(heads) - 1 else hidden
        per_node += (2 * w if i else 0) + 4 * h * d + 5 * h
        w = h * d
    widest = max(h * (classes if i == len(heads) - 1 else hidden) for i, h in enumerate(heads))
    return 4 * n * (per_node + 5 * widest)


def phase_gat_main():
    """main_gat's three paths, each with every counter set to 0 just
    before it and read just after it.

    reddit and ogbn-arxiv run the fused form: one K3 forward and one b2 call
    a layer and step, and K3's node passes (scores, score gradients, vector
    gradients) one each a layer and step, no K1 or K2, and no combine
    launch: K3 folds the long rows of both graphs' CSRs inside its launch.

    pubmed runs the edge form: its launches per step are gat_edge_per_step's,
    12 K2, 3 K1 and 18 P1 in source order, and each edge-softmax rescue
    adds one K2 and two P1 launches; its run goes on for PUBMED_PROFILE
    profiled steps, counted with the others, whose kernels hold no
    index_select. Then graph_gather_checks on pubmed's graph.

    The reddit run's device memory is read from the start of training
    (``train_peak_bytes`` above ``setup_bytes``): what the steps add beyond
    the graph and the data must stay below one (E, 16) float32 buffer;
    fused_memory (phase gat_reddit) is the check that sees an (E, 1) one.
    """
    from dgl_tpu_torch.benchmarks.node_classification import main_gat
    from dgl_tpu_torch.data import NODE_DATASET_STATS
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.gat_attention import (
        gat_attention_bwd, gat_attention_fwd, gat_score_grad, gat_scores, gat_vector_grad)
    from dgl_tpu_torch.kernels.row_gather import row_gather_by_source
    from dgl_tpu_torch.kernels.seg_sum import seg_sum
    from dgl_tpu_torch.ops.softmax import edge_softmax

    counters = {"csr_spmm": csr_spmm, "gat_attention_fwd": gat_attention_fwd,
                "gat_attention_bwd": gat_attention_bwd, "gat_scores": gat_scores,
                "gat_score_grad": gat_score_grad, "gat_vector_grad": gat_vector_grad,
                "seg_sum": seg_sum}
    epochs = {"reddit": 8, "ogbn-arxiv": 10, "pubmed": 30}
    profiled = {"reddit": 0, "ogbn-arxiv": 0, "pubmed": PUBMED_PROFILE}
    steps = {ds: epochs[ds] + profiled[ds] for ds in epochs}
    res, launches, rescues, combines = {}, {}, {}, {}
    for ds in steps:
        torch.cuda.synchronize()
        zero_counts(counters)
        row_gather_by_source.launches = 0
        edge_softmax.rescues = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            r = main_gat.run(ds, epochs=epochs[ds], runs=1, device="cuda",
                             profile_epochs=profiled[ds])
        launches[ds] = {k: fn.launches for k, fn in counters.items()}
        launches[ds]["row_gather_by_source"] = row_gather_by_source.launches
        combines[ds] = combine_counts(counters)
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
                      "gat_scores": 3 * s, "gat_score_grad": 3 * s, "gat_vector_grad": 3 * s,
                      "seg_sum": 0, "row_gather_by_source": 0}
        want_c[ds] = {"gat_attention_fwd": 0, "gat_attention_bwd": 0, "seg_sum": 0}
        if not (gg.split.num_long or gg.reverse.split.num_long):
            raise AssertionError(f"{ds}: no long row in either CSR, so no fold is counted")
    s, pub = steps["pubmed"], graphs["pubmed"]
    per_step, per_rescue = gat_edge_per_step()
    want_l["pubmed"] = dict.fromkeys(K3_COUNTERS, 0) | {
        k: n * s + per_rescue[k] * rescues["pubmed"] for k, n in per_step.items()}
    # K2 folds any long rows inside its launch: no combine launch
    want_c["pubmed"] = {"gat_attention_fwd": 0, "gat_attention_bwd": 0, "seg_sum": 0}
    gathers = graph_gather_checks(pub, torch.Generator(device="cuda").manual_seed(4))
    del graphs, pub
    if launches != want_l:
        raise AssertionError(f"launches {launches}; want {want_l}")
    if combines != want_c:
        raise AssertionError(f"combine launches {combines}; want {want_c}")
    prof = res["pubmed"]["profile"]
    if _names_index_select(prof["kernels"]):
        raise AssertionError(f"pubmed's step runs index_select: {_names_index_select(prof['kernels'])}")
    pub_prof = {k: prof[k] for k in ("epochs", "wall_ms_per_epoch", "device_busy_ms_per_epoch",
                                     "device_idle_share")} | {
        "row_gather_by_source_ms_per_epoch": sum(
            k["device_ms_per_epoch"] for k in prof["kernels"] if "row_gather_by_source" in k["name"]),
        "kernels": [{"name": k["name"][:80], "device_ms": k["device_ms_per_epoch"],
                     "calls": k["calls_per_epoch"]} for k in prof["kernels"][:12]]}
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
    cfg, (n_arxiv, _, f_arxiv, c_arxiv) = (main_gat.DATASET_CFG["ogbn-arxiv"],
                                           NODE_DATASET_STATS["ogbn-arxiv"])
    arxiv_bound = fused_gat_memory_bound(n_arxiv, f_arxiv, cfg["hidden"], c_arxiv, cfg["heads"])
    if not train_extra["ogbn-arxiv"] < arxiv_bound:
        raise AssertionError(f"arxiv fused training adds {train_extra['ogbn-arxiv']} B to its "
                             f"graph and data, over fused_gat_memory_bound's {arxiv_bound} B")
    emit("gat_main", device=res["reddit"]["device"], synthetic=res["reddit"]["synthetic"],
         **{f"{k}_epoch_s": res[ds]["epoch_s"] for ds, k in _GAT_KEYS.items()},
         **{f"{k}_epochs_s": res[ds]["epochs_s"] for ds, k in _GAT_KEYS.items()},
         **{f"{k}_setup_s": res[ds]["setup_s"] for ds, k in _GAT_KEYS.items()},
         **{f"{k}_losses": res[ds]["losses"][0] for ds, k in _GAT_KEYS.items()},
         steps=steps, launches=launches, combines=combines, pubmed_rescues=rescues["pubmed"],
         splits=plans, pubmed_k2_per_step_derived=per_step["seg_sum"],
         pubmed_k1_per_step_derived=per_step["csr_spmm"],
         pubmed_by_source_per_step_derived=per_step["row_gather_by_source"],
         pubmed_profile=pub_prof, graph_gathers=gathers,
         reddit_setup_bytes=res["reddit"]["setup_bytes"],
         reddit_train_peak_bytes=res["reddit"]["train_peak_bytes"],
         reddit_train_extra_bytes=train_extra["reddit"],
         reddit_train_extra_floats_per_node=train_extra["reddit"] / (4 * n),
         arxiv_train_extra_bytes=train_extra["ogbn-arxiv"],
         arxiv_train_memory_bound_bytes=arxiv_bound,
         pubmed_setup_bytes=res["pubmed"]["setup_bytes"],
         pubmed_train_peak_bytes=res["pubmed"]["train_peak_bytes"],
         reddit_edge_buffer_bytes=edge_buffer,
         **{f"{k}_edges": res[ds]["num_edges"] for ds, k in _GAT_KEYS.items()})
    return launches, combines


PUBMED_PROFILE = 3  # pubmed's profiled steps after its 30: the step's kernels and idle share
_GAT_KEYS = {"reddit": "reddit", "ogbn-arxiv": "arxiv", "pubmed": "pubmed"}


# -- SAGE on arxiv and products: the suite's driver, K1 at new widths -------

SAGE_EPOCHS = {"ogbn-arxiv": 10, "ogbn-products": 5}
SAGE_LOSS_ATOL = 1e-4  # first-step loss: hoisted vs unhoisted, scatter vs fused
SAGE_BF16_LOSS_RTOL = 1e-2  # first-step loss: --bf16-messages against float32


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


def reference64_sparse(indptr, indices, x, n_src, mean, w=None):
    """Float64 sums of a CSR SpMM (edge weights ``w`` in CSR order, or 1)
    and of its absolute terms through a float64 torch.sparse.mm: no (E, D)
    buffer, so it serves products and proteins."""
    crow, col = indptr.long(), indices.long()
    vals = (torch.ones(col.numel(), dtype=torch.float64, device=x.device) if w is None
            else w.double())

    def csr(v):
        return torch.sparse_csr_tensor(crow, col, v, size=(indptr.numel() - 1, n_src),
                                       check_invariants=False)

    x64 = x.double()
    want, mag = torch.sparse.mm(csr(vals), x64), torch.sparse.mm(csr(vals.abs()), x64.abs())
    if mean:
        inv = 1.0 / (indptr[1:] - indptr[:-1]).clamp(min=1).double().unsqueeze(1)
        want, mag = want * inv, mag * inv
    return want, mag


def k1_width(name, gg, d, mean, gen, plain, by_eid=False, reps=20, diagnose=False):
    """K1 over one CSR at width d: held to float64 sums (and to the plain
    version where ``plain``), CUDA-event medians of the kernel and
    torch.sparse.mm at the same shape in turns, of the plain version, the
    bytes bound and the computed no-reuse gather time.
    ``by_eid``: the CSR's eid is the index into (E, d) rows, as
    gather_src_rows' adjoint launches K1 over the reverse CSR. ``reps``: CUDA
    events a median (10 at products' shapes, whose calls take milliseconds).
    ``diagnose`` (the small CSRs): also K1 with plans cut at each T in
    K1_T_SWEEP (t_sweep), so that no warp walks more than T edges of a row
    (where the time falls with T, a lone warp's walk of the longest row sets
    the launch's time), and K1's and the library's host and device time a
    call (host_and_device)."""
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
    ms, lib_ms = in_turns(kern, lambda: torch.sparse.mm(a, x), reps=reps)
    return {"d": d, "mean": mean, "ms": ms,
            "plain_ms": (median_ms(lambda: csr_spmm_plain(gg.indptr, idx, x, mean=mean),
                                   reps=5, warmup=1) if plain else None),
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "floor_ms_computed": spmm_floor(n_rows, e, d, gg.indptr.element_size()),
            "max_abs_err": err, "max_abs_err_f64": err64, "max_bound_used": used,
            **({"t_sweep": t_sweep(lambda p: csr_spmm(gg.indptr, idx, x, mean=mean, split=p),
                                   gg.indptr, K1_T_SWEEP),
                "host_device": host_and_device(kern),
                "library_host_device": host_and_device(lambda: torch.sparse.mm(a, x))}
               if diagnose else {})}


def host_and_device(fn, calls=100):
    """A call's host time (ms: ``calls`` calls enqueued with no sync between
    them, so the card keeps up where the call is host-bound) and its device
    time (torch.profiler's busy time a call, over 20 calls): where the event
    pair's time is near the host's and above the device's, the call is
    host-bound."""
    from dgl_tpu_torch.train.timing import device_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    prof = device_profile(fn, 20, torch.device("cuda"), unit="call")
    return {"host_ms_a_call": host_ms, "device_ms_a_call": prof["device_busy_ms_per_call"],
            "wall_ms_a_call": prof["wall_ms_per_call"]}


# plans' T for the sweeps at the CSRs where K1 lost time in its redesign
# (GCMC's relations, a cluster batch, proteins' weighted shapes): a warp
# walks at most T edges of a row, against graph/split.py's 512
K1_T_SWEEP = (32, 64, 128, 256, 512)


def phase_sage_main():
    """main_sage on ogbn-arxiv (3 layers, hidden 256, BN, bidirected) and
    full ogbn-products (3 layers, hidden 64, bidirected), each hoisted and
    unhoisted, arxiv also with lowering="scatter", every counter set to 0
    before a run and read after it. K1's launches are sage_k1_launches per
    step (+1 hoisted), scatter's none; no combine launch (each launch folds
    its CSR's long rows). Losses finite and falling; the modes agree on the first
    step's loss. Then K1 at each width the runs launched it, forward (mean,
    dst CSR) and backward (sum, reverse CSR), against float64 sums,
    torch.sparse.mm and its bound (the plain version on arxiv only: on
    products its (E, D) buffer is 32–50 GB).

    bf16 messages (the slice's main path): products unhoisted with
    ``bf16_messages`` (``main_sage --bf16-messages``), as many epochs as the
    float32 run: K1's launches and combines per step equal the float32
    run's, the forward's three on bfloat16 rows (``csr_spmm.launches_bf16``),
    the first step's loss within SAGE_BF16_LOSS_RTOL of the float32 run's,
    losses falling; its epoch time beside the float32 run's. Then K1's
    bfloat16 instantiation at products' widths each way, timed in turns
    with the float32 one (k1_bf16_times)."""
    from dgl_tpu_torch.benchmarks.node_classification import main_sage
    from dgl_tpu_torch.data import NODE_DATASET_STATS
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(7)
    res, launches, want_l, plans, widths = {}, {}, {}, {}, {}
    launches_bf16, want_bf16 = {}, {}
    for ds, epochs in SAGE_EPOCHS.items():
        cfg = main_sage.DATASET_CFG[ds]
        _, _, feat, classes = NODE_DATASET_STATS[ds]
        modes = {"hoisted": (True, "fused", False), "unhoisted": (False, "fused", False)}
        if ds == "ogbn-arxiv":
            modes["scatter"] = (False, "scatter", False)
        else:
            modes["bf16"] = (False, "fused", True)
        for mode, (hoist, lowering, bf16) in modes.items():
            torch.cuda.synchronize()
            csr_spmm.launches = csr_spmm.launches_bf16 = 0
            log = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                r = main_sage.run(ds, epochs=epochs, runs=1, device="cuda", precompute=hoist,
                                  lowering=lowering, bf16_messages=bf16)
            r["run_s"] = time.perf_counter() - t0
            launches[(ds, mode)] = csr_spmm.launches
            launches_bf16[(ds, mode)] = csr_spmm.launches_bf16
            if "Training time/epoch" not in log.getvalue():
                raise AssertionError(f"{ds} {mode}: no 'Training time/epoch' line")
            res[(ds, mode)] = r
            torch.cuda.empty_cache()
        g, _ = _sage_graph(ds, dev)
        plans[ds] = _split_fields(g)
        for mode, (hoist, lowering, bf16) in modes.items():
            steps = len(res[(ds, mode)]["losses"][0])
            per_step = sage_k1_launches(feat, cfg["hidden"], classes, cfg["layers"], hoist)
            n_fwd = sum(side == "fwd" for _, side, _ in per_step) * steps + int(hoist)
            n_bwd = sum(side == "bwd" for _, side, _ in per_step) * steps
            if lowering == "scatter":
                n_fwd = n_bwd = 0
            want_l[(ds, mode)] = n_fwd + n_bwd
            # bf16 messages: the forward reads bfloat16 rows, the backward's
            # cotangent is float32
            want_bf16[(ds, mode)] = n_fwd if bf16 else 0
        ds_widths = sorted({d for _, _, d in sage_k1_launches(feat, cfg["hidden"], classes,
                                                               cfg["layers"], False)}
                           | {feat})
        widths[ds] = {}
        reps = 20 if ds == "ogbn-arxiv" else 10
        for d in ds_widths:
            widths[ds][d] = {
                "fwd": k1_width(f"{ds} fwd", g, d, True, gen, plain=ds == "ogbn-arxiv", reps=reps),
                "bwd": k1_width(f"{ds} bwd", g.reverse, d, False, gen, plain=ds == "ogbn-arxiv",
                                reps=reps),
            }
            if ds == "ogbn-products":  # the bf16 path's widths, each way
                for side, gg, mean in (("fwd", g, True), ("bwd", g.reverse, False)):
                    n_src = gg.num_src_nodes
                    x = 1.0 + torch.randn(n_src, d, device=dev, generator=gen)
                    x_int = torch.randint(-4, 5, (n_src, d), device=dev, generator=gen).float()
                    widths[ds][d][f"{side}_bf16"] = k1_bf16_times(
                        f"{ds} {side} D={d}", gg.indptr, gg.src, x, x_int, mean, gg.split, n_src,
                        reps=reps)
                    del x, x_int
        del g
        torch.cuda.empty_cache()
    if launches != want_l:
        raise AssertionError(f"K1 launches {launches}; want {want_l}")
    if launches_bf16 != want_bf16:
        raise AssertionError(f"K1 bfloat16 launches {launches_bf16}; want {want_bf16}")
    p32, p16 = res[("ogbn-products", "unhoisted")], res[("ogbn-products", "bf16")]
    if len(p16["losses"][0]) != len(p32["losses"][0]):
        raise AssertionError("the bf16 run took another number of steps than the float32 run")
    l32, l16 = p32["losses"][0][0], p16["losses"][0][0]
    if abs(l16 - l32) > SAGE_BF16_LOSS_RTOL * abs(l32):
        raise AssertionError(f"products first-step loss: bf16 messages {l16} vs float32 {l32}")
    for key, r in res.items():
        losses = r["losses"][0]
        if not statistics.mean(losses[-3:]) < losses[0]:
            raise AssertionError(f"{key} loss did not fall: {losses}")
    for ds in SAGE_EPOCHS:
        first = {mode: r["losses"][0][0] for (d, mode), r in res.items()
                 if d == ds and mode != "bf16"}
        if max(abs(v - first["unhoisted"]) for v in first.values()) > SAGE_LOSS_ATOL:
            raise AssertionError(f"{ds}: first-step losses differ: {first}")
    key = lambda ds, mode: f"{ds.removeprefix('ogbn-')}_{mode}"  # noqa: E731
    fields = ("run_s", "load_s", "setup_s", "precompute_s", "epoch_s", "epochs_s", "setup_bytes",
              "train_peak_bytes", "num_edges")
    emit("sage_main", seconds=time.perf_counter() - t_phase, device=res[("ogbn-arxiv", "hoisted")]["device"],
         synthetic=res[("ogbn-arxiv", "hoisted")]["synthetic"], epochs=SAGE_EPOCHS,
         **{key(*k): {f: r[f] for f in fields} | {"losses": r["losses"][0],
                                                  "launches": launches[k],
                                                  "launches_bf16": launches_bf16[k]}
            for k, r in res.items()},
         splits=plans, first_step_atol=SAGE_LOSS_ATOL, first_step_bf16_rtol=SAGE_BF16_LOSS_RTOL,
         products_epoch_s_bf16=p16["epoch_s"], products_epoch_s_f32=p32["epoch_s"],
         products_first_loss_bf16=l16, products_first_loss_f32=l32,
         k1_widths={ds: {str(d): w for d, w in v.items()} for ds, v in widths.items()})
    return launches, widths, launches_bf16


# -- graph classification: GCN on ENZYMES, molhiv and ppa ------------------

GC_RUNS = {  # key: (dataset, lowering, num_graphs, epochs)
    "enzymes": ("ENZYMES", "fused", None, 5),
    "molhiv": ("ogbg-molhiv", "fused", 10000, 3),  # cut to 10,000 graphs (time)
    "molhiv_scatter": ("ogbg-molhiv", "scatter", 10000, 3),
    "ppa": ("ogbg-ppa", "fused", 2000, 3),
}
# molhiv's profiled window: its idle share, not a whole epoch's trace (cut from
# 64 for time: the trace of a ~700-launch step costs ~0.7 s a step to read)
GC_PROFILE_STEPS = 16


def gc_per_step(dataset, lowering):
    """K1, K2 and P1-in-source-order launches in one training step, from the
    code (nn/conv.py, ops/sddmm.py, ops/gather.py, ops/segment.py,
    graph/batch.py). ENZYMES: 4 GCNConv, each a forward K1 and, as W x needs
    a gradient, a backward K1; the mean readout one K2 and its backward one
    P1 gather. molhiv and ppa: 5 GCNConvEdge, each norm = gsddmm(mul, c, c),
    two P1 gathers (c[src] over the reverse CSR, c[dst] over the dst CSR)
    that need no gradient, and gsddmm(copy_u), one P1 gather whose adjoint
    is one K1; fused, one K2 for gspmm(copy_e, sum), whose backward is one
    P1 gather (scatter: index_add_ and its index_select backward, no
    kernel); the readout one K2 and one P1 gather."""
    if dataset == "ENZYMES":
        return {"csr_spmm": 8, "seg_sum": 1, "row_gather_by_source": 1}
    if lowering == "fused":
        return {"csr_spmm": 5, "seg_sum": 6, "row_gather_by_source": 21}
    return {"csr_spmm": 5, "seg_sum": 1, "row_gather_by_source": 16}


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
        kern = lambda: seg_sum(indptr, m, split=split)  # noqa: E731
        lib = lambda: torch.zeros(n_rows, 256, device=ip.device).index_add_(0, rows, m)  # noqa: E731
        times[name] = {
            "rows": n_rows, "edges": m.shape[0],
            "ms": median_ms(kern, reps=30, warmup=3),
            "plain_ms": median_ms(lambda: seg_sum_plain(indptr, m), reps=30, warmup=3),
            "index_add_ms": median_ms(lib, reps=30, warmup=3),
            "bound_ms": bound, "bound_by": by,
            "host_device": host_and_device(kern), "index_add_host_device": host_and_device(lib)}
    enz = _gc_batch("ENZYMES", False).graph
    k1 = {"molhiv": {256: {"fwd": k1_width("molhiv batch fwd", g, 256, False, gen, plain=True,
                                           diagnose=True),
                           "bwd": k1_width("molhiv batch adjoint", g.reverse, 256, False, gen,
                                           plain=True, by_eid=True, diagnose=True)}},
          "enzymes": {128: {"fwd": k1_width("ENZYMES batch fwd", enz, 128, False, gen, plain=True,
                                            diagnose=True),
                            "bwd": k1_width("ENZYMES batch bwd", enz.reverse, 128, False, gen,
                                            plain=True, diagnose=True)}}}
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
    """main_gcn on ENZYMES (600 graphs), molhiv (cut to 10,000 graphs, fused
    and scatter) and ppa (cut to 2,000 graphs), batch 64, every counter set to 0
    before a run and read after it: K1, K2 and P1-in-source-order launches
    gc_per_step per step, no combine (no batch holds a row over T: _gc_long_rows); losses
    finite and falling. molhiv fused also profiles GC_PROFILE_STEPS further
    steps (the device's idle share). Then gc_kernel_checks and one molhiv
    step under the sync check."""
    from dgl_tpu_torch.benchmarks.graph_classification import main_gcn
    from dgl_tpu_torch.graph.split import SPLIT_T
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.row_gather import row_gather_by_source
    from dgl_tpu_torch.kernels.seg_sum import seg_sum

    t_phase = time.perf_counter()
    counters = {"csr_spmm": csr_spmm, "seg_sum": seg_sum}
    res, launches, combines, want_l, longest = {}, {}, {}, {}, {}
    for key, (ds, lowering, num_graphs, epochs) in GC_RUNS.items():
        torch.cuda.synchronize()
        zero_counts(counters)
        row_gather_by_source.launches = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            r = main_gcn.run(ds, batch_size=64, epochs=epochs, runs=1, lowering=lowering,
                             num_graphs=num_graphs, device="cuda",
                             profile_steps=GC_PROFILE_STEPS if key == "molhiv" else 0)
        r["run_s"] = time.perf_counter() - t0
        launches[key] = {k: fn.launches for k, fn in counters.items()}
        launches[key]["row_gather_by_source"] = row_gather_by_source.launches
        combines[key] = combine_counts(counters)
        if "Training time/epoch" not in log.getvalue():
            raise AssertionError(f"{key}: no 'Training time/epoch' line")
        res[key] = r
        want_l[key] = {k: n * r["steps"] for k, n in gc_per_step(ds, lowering).items()}
        if ds not in longest:
            longest[ds] = _gc_long_rows(ds, num_graphs)
        torch.cuda.empty_cache()
    if max(longest.values()) > SPLIT_T:
        raise AssertionError(f"a batch could hold a row over T = {SPLIT_T}: {longest}")
    want_c = {key: {"seg_sum": 0} for key in GC_RUNS}
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


# -- RGCN on ogbn-proteins: weighted K1 passes ------------------------------

RGCN_EPOCHS = 6  # the driver's run on the full graph; epochs 4-6 timed
RGCN_PROFILE = 3  # further epochs under torch.profiler: busy, idle share, K1's share
RGCN_HIDDEN = 32  # the driver's hidden width; K1's widths come from the model (rgcn_k1_launches)


def rgcn_k1_launches(model):
    """K1's launches in one training step of an RGCN, from the code
    (nn/conv.py:RelGraphConv, ops/rel.py) and the model's layers. A layer
    that projects first aggregates y = x @ W at its output width, one
    weighted launch per relation over the dst CSR, and y needs a gradient
    (W is a parameter, also where x is data), so the backward launches one
    per relation over the reverse CSR. A layer that aggregates first
    (conv.aggregate_first) launches at its input width, and backward only
    where x needs a gradient: not in layer 1, whose x is data. Returns
    [(layer, "fwd" | "bwd", r, d), ...]."""
    out = []
    for i, conv in enumerate(model.convs):
        d = conv.in_feats if conv.aggregate_first else conv.out_feats
        sides = ("fwd",) if conv.aggregate_first and i == 0 else ("fwd", "bwd")
        out += [(i, side, r, d) for side in sides for r in range(conv.rel_weights.shape[0])]
    return out


def rgcn_model(n_tasks, n_rel, fuse):
    """The model main_rgcn.run trains, on the CPU: its layers' widths and
    forms are what rgcn_k1_launches reads."""
    from dgl_tpu_torch.models import RGCN

    return RGCN(1, RGCN_HIDDEN, n_tasks, n_rel, 3, fuse_relations=fuse, device="cpu")


def wspmm_bound(n_rows, n_src, nnz, d):
    """spmm_bound of a weighted CSR SpMM: a float32 weight per edge is read
    once too."""
    return _bound_ms(nnz * 8 + (n_rows + 1) * 4 + n_src * d * 4 + n_rows * d * 4, 2 * nnz * d)


def k1_weighted(name, gg, w, x, mean, x_int, w_int):
    """Weighted K1 over one CSR (``w`` in its order): held to float64 sums,
    to the plain version and, on small integers with integer weights, bit
    for bit; two runs bitwise equal; CUDA-event medians of the kernel, the
    plain version, and torch.sparse.mm on the weighted CSR (the mean's 1/deg
    in its values) in turns with the kernel, the bound, the computed
    no-reuse gather time, and the kernel with plans cut at each T in
    K1_T_SWEEP (t_sweep)."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

    n_rows, n_src, e, d = gg.num_dst_nodes, gg.num_src_nodes, gg.num_edges, x.shape[1]
    kern = lambda: csr_spmm(gg.indptr, gg.src, x, w, mean=mean, split=gg.split)  # noqa: E731
    plain = lambda: csr_spmm_plain(gg.indptr, gg.src, x, w, mean=mean)  # noqa: E731
    got = kern()
    if not torch.equal(got, kern()):
        raise AssertionError(f"{name}: two K1 runs differ")
    err, err64, used = check(name, got, gg.indptr,
                             reference64_sparse(gg.indptr, gg.src, x, n_src, mean, w), plain())
    del got
    check(f"{name} integer", csr_spmm(gg.indptr, gg.src, x_int, w_int, split=gg.split), gg.indptr,
          reference64_sparse(gg.indptr, gg.src, x_int, n_src, False, w_int), exact=True)
    vals = w
    if mean:
        deg = gg.in_degrees().long()
        vals = w / deg.clamp(min=1).float().repeat_interleave(deg, output_size=e)
    a = torch.sparse_csr_tensor(gg.indptr.long(), gg.src.long(), vals, size=(n_rows, n_src),
                                check_invariants=False)
    bound, by = wspmm_bound(n_rows, n_src, e, d)
    ms, lib_ms = in_turns(kern, lambda: torch.sparse.mm(a, x))
    return {"d": d, "mean": mean, "ms": ms, "plain_ms": median_ms(plain, reps=5, warmup=1),
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "floor_ms_computed": spmm_floor(n_rows, e, d, gg.indptr.element_size(), weighted=True),
            "max_abs_err": err, "max_abs_err_f64": err64,
            "max_bound_used": used, "max_row_nnz": int(gg.in_degrees().max()),
            "t_sweep": t_sweep(lambda p: csr_spmm(gg.indptr, gg.src, x, w, mean=mean, split=p),
                               gg.indptr, K1_T_SWEEP)}


def rel_checks(g, weights, weights_int, gen, d, per_relation):
    """One gspmm_rel forward (mean, as RelGraphConv runs it) and backward at
    width d, in the form a layer calls it: ``per_relation`` (a layer that
    aggregates first) on x (N, d) expanded along R, whose gradient sums the
    R reverse passes; else (a layer that projects first) on y (R, N, d),
    the forward summing the R aggregations. A sum over the relations is
    held to the float64 sum within (n + 3 + R)·u·Σ|term| (R relation sums
    added after the per-relation bound) and to the sum of the plain
    versions; a result per relation to its float64 run and plain version;
    on small integers (sum, integer weights) every result bit for bit; two
    runs bitwise equal."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm_plain
    from dgl_tpu_torch.ops.rel import gspmm_rel

    dev = g.indptr.device
    n_rel, n, n_dst, rev = weights.num_relations, g.num_src_nodes, g.num_dst_nodes, g.reverse
    src_shape = (n, d) if per_relation else (n_rel, n, d)
    cot_shape = (n_rel, n_dst, d) if per_relation else (n_dst, d)
    inv64 = 1.0 / g.in_degrees().clamp(min=1).double().unsqueeze(1)

    def run(reduce, src, ww, cot):
        sk = src.clone().requires_grad_()
        y = sk.unsqueeze(0).expand(n_rel, -1, -1) if per_relation else sk
        out = gspmm_rel(reduce, g, y, ww, per_relation=per_relation)
        out.backward(cot)
        return out.detach(), sk.grad

    def rel(t, r):  # relation r's rows of a per-relation tensor, or t itself
        return t[r] if t.dim() == 3 else t

    def hold(what, got, indptr, refs, plains, exact, acc):
        if got.dim() == 3:  # relation by relation
            for r in range(n_rel):
                _merge(acc, [check(f"{what} r={r}", got[r], indptr, refs[r],
                                   None if exact else plains[r], exact=exact)])
        else:  # the sum over the relations
            want = (sum(a for a, _ in refs), sum(m for _, m in refs))
            _merge(acc, [check(what, got, indptr, want, None if exact else sum(plains),
                               exact=exact, slack=(1, 3 + n_rel))])

    acc = [0.0, 0.0, 0.0]
    for kind, ww in (("", weights), (" integer", weights_int)):
        exact = bool(kind)
        if exact:
            src = torch.randint(-4, 5, src_shape, device=dev, generator=gen).float()
            cot = torch.randint(-4, 5, cot_shape, device=dev, generator=gen).float()
        else:
            src = 1.0 + torch.randn(src_shape, device=dev, generator=gen)
            cot = 1.0 + torch.randn(cot_shape, device=dev, generator=gen)
        out, grad = run("sum" if exact else "mean", src, ww, cot)
        if not exact:
            out2, grad2 = run("mean", src, ww, cot)
            if not (torch.equal(out, out2) and torch.equal(grad, grad2)):
                raise AssertionError(f"gspmm_rel D={d}: two runs differ")
            del out2, grad2
        refs = [reference64_sparse(g.indptr, g.src, rel(src, r), n, not exact, ww.fwd[r])
                for r in range(n_rel)]
        plains = None if exact else [csr_spmm_plain(g.indptr, g.src, rel(src, r), ww.fwd[r],
                                                    mean=True) for r in range(n_rel)]
        hold(f"gspmm_rel D={d} fwd{kind}", out, g.indptr, refs, plains, exact, acc)
        del refs, plains
        # the backward's cotangent: mean scales it by 1/max(deg, 1) first
        cots = [rel(cot, r) if exact else rel(cot, r) * inv64.float() for r in range(n_rel)]
        refs = [reference64_sparse(rev.indptr, rev.src, rel(cot, r).double() * (1 if exact else inv64),
                                   n_dst, False, ww.rev[r]) for r in range(n_rel)]
        plains = None if exact else [csr_spmm_plain(rev.indptr, rev.src, cots[r], ww.rev[r])
                                     for r in range(n_rel)]
        hold(f"gspmm_rel D={d} bwd{kind}", grad, rev.indptr, refs, plains, exact, acc)
        del refs, plains, cots, out, grad
    return {"d": d, "per_relation": per_relation, "max_abs_err": acc[0],
            "max_abs_err_f64": acc[1], "max_bound_used": acc[2]}


def rgcn_step_no_host_sync(g, weights, data):
    """One RGCN training step on the full graph (make_train_step, as the
    driver runs it) under set_sync_debug_mode("error"), after a warm-up
    step."""
    from dgl_tpu_torch.benchmarks.node_classification.main_rgcn import make_train_step
    from dgl_tpu_torch.models import RGCN

    dev = g.indptr.device
    y = torch.from_numpy(np.asarray(data.labels, np.float32)).to(dev)
    mask = torch.from_numpy(np.asarray(data.train_mask)).to(dev)
    x = torch.ones(g.num_src_nodes, 1, device=dev)
    model = RGCN(1, RGCN_HIDDEN, y.shape[1], weights.num_relations, device=dev,
                 generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=0.01), g, x, weights,
                           y, mask)
    step()
    loss = []
    no_host_sync(lambda: loss.append(step()), lambda: loss[0].item())
    if not math.isfinite(loss[0].item()):
        raise AssertionError("the RGCN step under the sync check gave a non-finite loss")


def phase_rgcn_main():
    """RGCN on the full ogbn-proteins graph (132,534 nodes, 39,561,252 edges,
    8 relations, 112 tasks): the graph's split; weighted K1 through
    k1_weighted at every (CSR, width) that the driver's models launch it at
    (rgcn_k1_launches of the default model and the fuse_relations one: the
    dst CSR (mean) at D = 1 and 32, the reverse CSR (sum) at D = 32),
    relation 0's weights; gspmm_rel forward and backward (rel_checks) in
    every (width, form) that a layer of those models calls it in; then one
    step under the sync check; then main_rgcn.run (3 layers, hidden 32) for
    RGCN_EPOCHS epochs and RGCN_PROFILE profiled ones, in the default form
    and with fuse_relations, each with K1's counters set to 0 before and
    read after: rgcn_k1_launches per step and no combine launch (each
    launch folds its CSR's long rows); the training's peak above its inputs below one
    (E, 32) float32 buffer; the loss falls; the reference's lines; the forms
    agree on the first step's loss. Returns the K1 fields by (side, D), the
    default run's launch counts and the graph."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.benchmarks.node_classification import main_rgcn
    from dgl_tpu_torch.data import NODE_DATASET_STATS, load_node_dataset
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.ops.rel import RelEdgeWeights

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    data = load_node_dataset("ogbn-proteins")
    g = from_edges(data.src, data.dst, data.num_nodes, device=dev)
    graph_s = time.perf_counter() - t_phase  # the data's generation or load, and the graph
    n_nodes, n_edges, n_rel, n_tasks = NODE_DATASET_STATS["ogbn-proteins"]
    if (g.num_dst_nodes, g.num_edges, data.edge_feat.shape[1], data.labels.shape[1]) != (
            n_nodes, n_edges, n_rel, n_tasks):
        raise AssertionError(f"proteins is not full size: {g}, {data.edge_feat.shape}")
    models = {form: rgcn_model(n_tasks, n_rel, fuse) for form, fuse in (("default", False),
                                                                        ("fused", True))}
    per_step = {form: rgcn_k1_launches(m) for form, m in models.items()}
    k1_shapes = sorted({(side, d) for ps in per_step.values() for _, side, _, d in ps})
    rel_forms = sorted({(c.in_feats if c.aggregate_first else c.out_feats, c.aggregate_first)
                        for m in models.values() for c in m.convs})
    ef = torch.from_numpy(np.asarray(data.edge_feat, np.float32)).to(dev).index_select(0, g.eid)
    weights = RelEdgeWeights.build(g, ef)
    gen = torch.Generator(device=dev).manual_seed(9)
    w_int = torch.randint(1, 4, (g.num_edges, n_rel), device=dev, generator=gen).float()
    weights_int = RelEdgeWeights.build(g, w_int)
    del ef, w_int
    inv_deg = 1.0 / g.in_degrees().clamp(min=1).float().unsqueeze(1)
    k1 = {}
    for side, d in k1_shapes:  # the dst CSR forward (mean), the reverse backward (sum)
        fwd = side == "fwd"
        gg, w, w_int = ((g, weights.fwd[0], weights_int.fwd[0]) if fwd
                        else (g.reverse, weights.rev[0], weights_int.rev[0]))
        x = 1.0 + torch.randn(n_nodes, d, device=dev, generator=gen)
        x_int = torch.randint(-4, 5, (n_nodes, d), device=dev, generator=gen).float()
        k1[f"{side}_d{d}"] = k1_weighted(f"proteins weighted {side} D={d}", gg, w,
                                         x if fwd else x * inv_deg, fwd, x_int, w_int)
        del x, x_int
    rel = {f"d{d}_{'per_relation' if pr else 'summed'}": rel_checks(g, weights, weights_int,
                                                                      gen, d, pr)
           for d, pr in rel_forms}
    del weights_int, inv_deg
    torch.cuda.empty_cache()
    rgcn_step_no_host_sync(g, weights, data)
    torch.cuda.synchronize()

    runs, limit = {}, n_edges * RGCN_HIDDEN * 4
    for form, fuse in (("default", False), ("fused", True)):
        torch.cuda.synchronize()
        csr_spmm.launches = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            r = main_rgcn.run(epochs=RGCN_EPOCHS, runs=1, device="cuda", fuse_relations=fuse,
                              profile_epochs=RGCN_PROFILE)
        r["run_s"] = time.perf_counter() - t0
        r["launches"] = csr_spmm.launches
        r["lines"] = [ln for ln in log.getvalue().splitlines()
                      if ln.startswith("Training time/epoch")]
        if len(r["lines"]) != RGCN_EPOCHS - 3:
            raise AssertionError(f"{form}: {len(r['lines'])} 'Training time/epoch' lines in "
                                 f"{RGCN_EPOCHS} epochs")
        r["steps"] = len(r["losses"][0]) + RGCN_PROFILE
        n_fwd = sum(side == "fwd" for _, side, _, _ in per_step[form]) * r["steps"]
        n_bwd = sum(side == "bwd" for _, side, _, _ in per_step[form]) * r["steps"]
        if r["launches"] != n_fwd + n_bwd:
            raise AssertionError(f"{form}: K1 launched {r['launches']} times in {r['steps']} "
                                 f"steps; want {n_fwd + n_bwd}")
        r["per_step_derived"] = len(per_step[form])
        r["train_extra_bytes"] = r["train_peak_bytes"] - r["setup_bytes"]
        if not r["train_extra_bytes"] < limit:
            raise AssertionError(f"{form}: the RGCN training added {r['train_extra_bytes']} B, "
                                 f"one (E, 32) buffer is {limit}")
        losses = r["losses"][0]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{form}: RGCN loss did not fall: {losses}")
        prof = r["profile"]
        k1_ms = sum(k["device_ms_per_epoch"] for k in prof["kernels"]
                    if "csr_spmm_kernel" in k["name"] or "combine_chunks" in k["name"])
        r["profile"] = {k: prof[k] for k in ("epochs", "wall_ms_per_epoch",
                                             "device_busy_ms_per_epoch", "device_idle_share")}
        r["profile"].update(k1_ms_per_epoch=k1_ms,
                            k1_share_of_busy=k1_ms / prof["device_busy_ms_per_epoch"],
                            kernels=prof["kernels"][:8])
        runs[form] = r
        torch.cuda.empty_cache()
    # the same weights and data: the two forms agree on the first step's loss
    first = {form: r["losses"][0][0] for form, r in runs.items()}
    if abs(first["default"] - first["fused"]) > SAGE_LOSS_ATOL:
        raise AssertionError(f"RGCN first-step losses differ between the forms: {first}")
    fields = ("run_s", "device", "synthetic", "load_s", "setup_s", "weights_s", "epoch_s",
              "epochs_s", "setup_bytes", "train_peak_bytes", "train_extra_bytes", "losses",
              "launches", "steps", "per_step_derived", "lines", "profile")
    emit("rgcn_main", seconds=time.perf_counter() - t_phase, nodes=n_nodes, edges=n_edges,
         relations=n_rel, tasks=n_tasks, hidden=RGCN_HIDDEN, graph_s=graph_s, **_split_fields(g),
         k1_weighted=k1, gspmm_rel=rel, no_host_sync=True, e_by_32_bytes=limit,
         **{form: {f: r[f] for f in fields} for form, r in runs.items()})
    del weights
    torch.cuda.empty_cache()
    return k1, runs["default"]["launches"], g


# -- GCMC on ml-100k: K1 on bipartite relation CSRs, P1 and K2 in the decoder

GCMC_SEED = 123  # the driver's --seed
GCMC_BASES = 2  # the driver's --gen_r_num_basis_func
GCMC_REL_D = 100  # a relation's width: --gcn_agg_units 500 stacked over the 5 ratings
GCMC_OUT_D = 75  # --gcn_out_units: the decoder's width
GCMC_PROFILE = 20  # further iterations under torch.profiler after the run
GCMC_ITERS = 500  # the suite's gcmc_ml100k row (the driver's default 2,000, cut for time)


def gcmc_per_iter(enc, dec, train=True, num_basis=GCMC_BASES):
    """K1, K2 and P1-in-source-order launches, and K1's and K2's combine
    launches, of one GCMC training iteration (``train``) or one RMSE
    evaluation on encoder graph ``enc`` and decoder graph ``dec``, from the
    code (nn/gcmc.py, ops/spmm.py, ops/sddmm.py, ops/gather.py): each
    relation's GCMCGraphConv is one K1 over its dst CSR and, as x·W needs a
    gradient, one K1 over its reverse CSR backward; each decoder basis is one
    u_dot_v, two P1 gathers (gather_src_rows over the reverse CSR,
    gather_dst over the dst CSR) whose adjoints are one K1 over the reverse
    CSR by eid and one K2 over the dst CSR. K1 and K2 fold their long rows
    inside their launch, so no launch combines. An
    evaluation runs the forwards only. Returns (launches, combines)."""
    launches = {"csr_spmm": 0, "seg_sum": 0, "row_gather_by_source": 2 * num_basis}
    for _ in enc.relations.values():
        launches["csr_spmm"] += 1 + train
    if train:
        launches["csr_spmm"] += num_basis
        launches["seg_sum"] = num_basis
    return launches, {"seg_sum": 0}


def k1_exact(name, gg, d, gen, by_eid=False):
    """K1 over one CSR on small integers: every row equal to the float64 sum
    bit for bit, hub rows included."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm

    idx, n_src = (gg.eid, gg.num_edges) if by_eid else (gg.src, gg.num_src_nodes)
    x = torch.randint(-4, 5, (n_src, d), device=gg.indptr.device, generator=gen).float()
    check(f"{name} D={d} integer", csr_spmm(gg.indptr, idx, x, split=gg.split), gg.indptr,
          reference64_sparse(gg.indptr, idx, x, n_src, False), exact=True)


def p1_stream(name, x, indptr, pos, split, idx, gen):
    """P1 in source order over one CSR of the decoder graph (``pos`` the
    output positions, None for the dst CSR's own order): bit for bit
    against x[idx] and its plain version, two runs equal, CUDA-event
    medians beside index_select and the bound."""
    from dgl_tpu_torch.kernels.row_gather import row_gather_by_source, row_gather_by_source_plain

    kern = lambda: row_gather_by_source(x, indptr, pos, split)  # noqa: E731
    lib = lambda: x.index_select(0, idx)  # noqa: E731
    got, want = kern(), lib()
    if not (torch.equal(got, want) and torch.equal(got, kern())
            and torch.equal(row_gather_by_source_plain(x, indptr, pos), want)):
        raise AssertionError(f"gcmc {name}: P1 in source order differs from x[idx]")
    bound, by, _ = gather_bound(idx, x.shape[1] * x.element_size())
    return {"rows": idx.numel(), "row_bytes": x.shape[1] * x.element_size(),
            "ms": median_ms(kern, reps=30, warmup=3),
            "plain_ms": median_ms(lambda: row_gather_by_source_plain(x, indptr, pos), reps=10,
                                  warmup=2),
            "library_ms": median_ms(lib, reps=30, warmup=3),
            "bound_ms": bound, "bound_by": by, "max_abs_err": 0.0,
            "host_device": host_and_device(kern), "library_host_device": host_and_device(lib)}


def gcmc_kernel_checks(data, gen):
    """K1, P1 and K2 at GCMC's shapes on the training graphs. K1 on each of
    the 10 relation CSRs at D = 100, forward on the dst CSR and backward on
    the reverse CSR, and at D = 75 on the decoder graph's reverse CSR by eid
    (gather_src_rows' adjoint): every row held to float64 sums, rows of at
    most HUB_DEG terms to the plain version, small integers bit for bit, two
    runs equal, timed beside torch.sparse.mm and the bytes bound (k1_width).
    P1 in source order on the decoder's two gathers at (E, 75): bit for bit
    against x[idx]. K2 at W = 75 on the decoder's dst CSR (gather_dst's
    adjoint) through check_k2, timed beside segment_reduce, index_add_ and
    the bound."""
    from dgl_tpu_torch.kernels.seg_sum import csr_rows, seg_sum, seg_sum_plain

    enc, dec, _ = data.train
    dev = dec.indptr.device
    k1 = {}
    # the relation with the most ratings (the kernels line's gcmc_relation)
    # also gets k1_width's diagnosis
    top = max((kv for kv in enc.relations.items() if not str(kv[0][1]).startswith("rev-")),
              key=lambda kv: kv[1].num_edges)[0][1]
    for (_, rel, _), g in enc.relations.items():
        for side, gg in (("fwd", g), ("bwd", g.reverse)):
            k1[f"{rel}_{side}"] = k1_width(f"gcmc {rel} {side}", gg, GCMC_REL_D, False, gen,
                                           plain=True, diagnose=rel == top)
            k1[f"{rel}_{side}"].update(rows=gg.num_dst_nodes, edges=gg.num_edges,
                                       longest_row=int(gg.in_degrees().max()),
                                       long_rows=gg.split.num_long)
            k1_exact(f"gcmc {rel} {side}", gg, GCMC_REL_D, gen)
    k1["dec_adjoint"] = k1_width("gcmc decoder adjoint", dec.reverse, GCMC_OUT_D, False, gen,
                                 plain=True, by_eid=True, diagnose=True)
    k1_exact("gcmc decoder adjoint", dec.reverse, GCMC_OUT_D, gen, by_eid=True)
    rev = dec.reverse
    u = 1.0 + torch.randn(dec.num_src_nodes, GCMC_OUT_D, device=dev, generator=gen)
    v = 1.0 + torch.randn(dec.num_dst_nodes, GCMC_OUT_D, device=dev, generator=gen)
    p1 = {"src": p1_stream("gather_src_rows", u, rev.indptr, rev.eid, rev.split, dec.src.long(),
                           gen),
          "dst": p1_stream("gather_dst", v, dec.indptr, None, dec.split, dec.dst.long(), gen)}
    n, e, w = dec.num_dst_nodes, dec.num_edges, GCMC_OUT_D
    msg = 1.0 + torch.randn(e, w, device=dev, generator=gen)
    ints = torch.randint(-4, 5, (e, w), device=dev, generator=gen).float()
    acc = [0.0, 0.0, 0.0]
    check_k2("gcmc decoder", dec.indptr, msg, ints, acc, dec.split)
    rows, offsets = csr_rows(dec.indptr, e), dec.indptr.long()
    bound, by = k2_bound(n, e, w)
    kern = lambda: seg_sum(dec.indptr, msg, split=dec.split)  # noqa: E731
    index_add = lambda: torch.zeros(n, w, device=dev).index_add_(0, rows, msg)  # noqa: E731
    k2 = {"rows": n, "edges": e, "w": w, "long_rows": dec.split.num_long,
          "ms": median_ms(kern, reps=30, warmup=3),
          "plain_ms": median_ms(lambda: seg_sum_plain(dec.indptr, msg), reps=10, warmup=2),
          "library_ms": median_ms(lambda: torch.segment_reduce(msg, "sum", offsets=offsets),
                                  reps=30, warmup=3),
          "index_add_ms": median_ms(index_add, reps=30, warmup=3),
          "bound_ms": bound, "bound_by": by, "max_abs_err": acc[0], "max_abs_err_f64": acc[1],
          "max_bound_used": acc[2],
          "host_device": host_and_device(kern), "index_add_host_device": host_and_device(index_add)}
    return k1, p1, k2


def gcmc_step_no_host_sync(data):
    """One training iteration of the driver's model (make_train_step, as the
    driver builds it) under set_sync_debug_mode("error"), after one
    warm-up iteration; its loss read back outside."""
    from dgl_tpu_torch.benchmarks.link_prediction import gcmc
    from dgl_tpu_torch.models import GCMCNet

    dev = torch.device("cuda")
    ufeat, ifeat = (torch.from_numpy(f).to(dev) for f in (data.user_feat, data.movie_feat))
    model = GCMCNet([str(r) for r in data.rating_vals], ufeat.shape[1], ifeat.shape[1],
                    msg_units=len(data.rating_vals) * GCMC_REL_D, out_units=GCMC_OUT_D, device=dev,
                    generator=torch.Generator().manual_seed(GCMC_SEED))
    step = gcmc.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=0.01), 1.0, data.train[:2],
        (ufeat, ifeat, data.norms), torch.from_numpy(data.train[2]).to(dev),
        torch.tensor(data.rating_vals, dtype=torch.float32, device=dev),
        torch.Generator(device=dev).manual_seed(GCMC_SEED))
    step()
    out = []
    no_host_sync(lambda: out.append(step()), lambda: out[0][0].item())
    loss = float(out[0][0])
    if not math.isfinite(loss):
        raise AssertionError(f"the GCMC iteration under the sync check gave loss {loss}")
    return loss


def phase_gcmc_main():
    """GCMC on ml-100k at the driver's defaults (seed 123): the data's
    shapes (943 users, 1682 movies, 85,000 training ratings, 10 relations),
    each relation CSR's longest row and long rows; gcmc_kernel_checks; one
    iteration under the sync check; then the driver (gcmc.run at its
    defaults but GCMC_ITERS iterations, an RMSE evaluation every 5, and
    GCMC_PROFILE profiled iterations) with every counter set to 0 before it
    and read after it: K1's, K2's and P1-in-source-order launches and K1's
    and K2's combines equal gcmc_per_iter's for its iterations and its
    valid and test evaluations; losses finite and falling; the reference's
    two lines and both CSV files; the best test RMSE below the yardstick of
    predicting the training ratings' mean; the profile (busy, idle share,
    top kernels)."""
    import tempfile

    from dgl_tpu_torch.benchmarks.link_prediction import gcmc
    from dgl_tpu_torch.data.movielens import load_movielens
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.row_gather import row_gather_by_source
    from dgl_tpu_torch.kernels.seg_sum import seg_sum

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    data = load_movielens("ml-100k", seed=GCMC_SEED, device=dev)
    load_s = time.perf_counter() - t_phase
    enc, dec, y_tr = data.train
    if (data.num_users, data.num_movies, len(y_tr), len(enc.relations)) != (943, 1682, 85_000, 10):
        raise AssertionError(f"ml-100k is not full size: {data.num_users} users, "
                             f"{data.num_movies} movies, {len(y_tr)} ratings, "
                             f"{len(enc.relations)} relations")
    shapes = {rel: {"edges": g.num_edges, "longest_dst_row": int(g.in_degrees().max()),
                    "long_dst_rows": g.split.num_long,
                    "longest_src_row": int(g.reverse.in_degrees().max()),
                    "long_src_rows": g.reverse.split.num_long}
              for (_, rel, _), g in enc.relations.items()}
    shapes["decoder"] = {"edges": dec.num_edges, "longest_movie_row": int(dec.in_degrees().max()),
                         "long_movie_rows": dec.split.num_long,
                         "longest_user_row": int(dec.reverse.in_degrees().max()),
                         "long_user_rows": dec.reverse.split.num_long}
    ratings = np.asarray(data.rating_vals, np.float64)
    yardstick = float(np.sqrt(np.mean((ratings[data.test[2]] - ratings[y_tr].mean()) ** 2)))
    gen = torch.Generator(device=dev).manual_seed(11)
    k1, p1, k2 = gcmc_kernel_checks(data, gen)
    sync_loss = gcmc_step_no_host_sync(data)
    torch.cuda.empty_cache()

    counters = {"csr_spmm": csr_spmm, "seg_sum": seg_sum}
    torch.cuda.synchronize()
    zero_counts(counters)
    row_gather_by_source.launches = 0
    log = io.StringIO()
    with tempfile.TemporaryDirectory() as save_dir, contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        r = gcmc.run(gcmc.parser().parse_args(["--device", "cuda", "--save_dir", save_dir,
                                               "--train_max_iter", str(GCMC_ITERS),
                                               "--profile", str(GCMC_PROFILE)]))
        run_s = time.perf_counter() - t0
        csv_rows = {}
        for name in ("train_metrics.csv", "valid_metrics.csv"):
            with open(f"{save_dir}/{name}") as f:
                csv_rows[name] = f.read().splitlines()
    launches = {k: fn.launches for k, fn in counters.items()}
    launches["row_gather_by_source"] = row_gather_by_source.launches
    combines = combine_counts(counters)
    per = {"iter": gcmc_per_iter(enc, dec),
           "valid": gcmc_per_iter(*data.valid[:2], train=False),
           "test": gcmc_per_iter(*data.test[:2], train=False)}
    times = {"iter": r["iters"] + GCMC_PROFILE, **r["evals"]}
    want_l = {k: sum(times[s] * per[s][0][k] for s in per) for k in launches}
    want_c = {k: sum(times[s] * per[s][1][k] for s in per) for k in combines}
    if (launches, combines) != (want_l, want_c):
        raise AssertionError(f"GCMC launches {launches}, combines {combines}; want {want_l}, "
                             f"{want_c} ({times})")
    text = log.getvalue()
    lines = [ln for ln in text.splitlines()
             if ln.startswith(("Training time/iter", "Best valid RMSE"))]
    if len(lines) != 2:
        raise AssertionError(f"the GCMC driver printed {lines}")
    if [rows[0].split(",")[0] for rows in csv_rows.values()] != ["iter", "iter"] or min(
            len(rows) for rows in csv_rows.values()) < 2:
        raise AssertionError(f"the GCMC driver's CSV files: {csv_rows}")
    losses = r["losses"]
    if not (all(math.isfinite(v) for v in losses) and statistics.mean(losses[-20:]) < losses[0]):
        raise AssertionError(f"the GCMC loss is not finite or did not fall: {losses[:5]} .. "
                             f"{losses[-5:]}")
    if not r["best_test"] < yardstick:
        raise AssertionError(f"GCMC's best test RMSE {r['best_test']} is not below the "
                             f"mean-rating yardstick {yardstick}")
    prof = r["profile"]
    emit("gcmc_main", seconds=time.perf_counter() - t_phase, device=r["device"],
         synthetic=r["synthetic"], users=data.num_users, movies=data.num_movies,
         train_ratings=len(y_tr),
         train_ratings_by_value={str(v): int((y_tr == i).sum())
                                 for i, v in enumerate(data.rating_vals)},
         load_s=load_s, run_s=run_s, driver_load_s=r["load_s"], shapes=shapes,
         k1=k1, p1_by_source=p1, k2=k2, no_host_sync=True, sync_check_loss=sync_loss,
         iters=r["iters"], evals=r["evals"], profiled_iters=GCMC_PROFILE,
         launches=launches, combines=combines,
         per_iter_derived={s: {"launches": p[0], "combines": p[1]} for s, p in per.items()},
         iter_s=r["iter_s"], lines=lines, best_valid=r["best_valid"], best_test=r["best_test"],
         mean_rating_yardstick=yardstick, losses_head=losses[:10], losses_tail=losses[-10:],
         train_rmse_tail=r["train_rmse"][-5:], valid_rmse=r["valid_rmse"][::20],
         csv_rows={k: len(v) - 1 for k, v in csv_rows.items()},
         profile={k: prof[k] for k in ("iters", "wall_ms_per_iter", "device_busy_ms_per_iter",
                                       "device_idle_share")},
         profile_kernels=[{"name": k["name"][:80], "device_ms": k["device_ms_per_iter"],
                           "calls": k["calls_per_iter"]} for k in prof["kernels"][:12]],
         profile_launches_per_iter=sum(k["calls_per_iter"] for k in prof["kernels"]),
         host_ops=prof["host_ops"][:8])
    print(f"GCMC mean-rating yardstick (test RMSE of the training ratings' mean): {yardstick:.4f}",
          flush=True)
    return {"launches": launches, "combines": combines, "k1": k1, "p1": p1, "k2": k2}


def k2_p1_splits(out_path="k2p1_splits.json"):
    """K2 and P1 at the shapes their main paths give them, each call's event
    pair, host and device time beside the library call's, without the
    drivers: gc_kernel_checks (molhiv's readout and copy_e), gcmc_kernel_checks
    (the decoder's K2 and both gathers), k2_reddit (K2 f32 and bf16),
    phase_row_gather (its streams and the probe), ns_step_gather and
    cluster_batch_checks (after the products partition), one after another;
    written to out_path after each. Run it after phase_device() and
    phase_build(): about 4 minutes on the card."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.data import data_root, load_node_dataset
    from dgl_tpu_torch.data.movielens import load_movielens
    from dgl_tpu_torch.sampling import CSRGraph, DeviceNeighborSampler
    from dgl_tpu_torch.sampling.cluster import ClusterIter

    dev, out = torch.device("cuda"), {}

    def dump():
        with open(out_path, "w") as f:
            json.dump(out, f, default=str)

    out["gc_k2"], _ = gc_kernel_checks(torch.Generator(device=dev).manual_seed(8))
    data = load_movielens("ml-100k", seed=GCMC_SEED, device=dev)
    _, out["gcmc_p1"], out["gcmc_k2"] = gcmc_kernel_checks(
        data, torch.Generator(device=dev).manual_seed(11))
    dump()
    gat_graph, res = _gat_graph("reddit", dev), {}
    k2_reddit(gat_graph, torch.Generator(device=dev).manual_seed(2), res)
    out["k2_reddit"] = res
    rd = load_node_dataset("reddit")
    red_graph = from_edges(rd.src, rd.dst, rd.num_nodes, device=dev)
    kernel_ms = {"fwd": {"kernel_ms": None}, "bwd": {"kernel_ms": None}}  # K1's: not timed here
    k3_ms = {"gat_attention_fwd": {"ms": None}, "gat_attention_bwd": {"ms": None}}
    out["row_gather"], _ = phase_row_gather(kernel_ms, red_graph, k3_ms, gat_graph)
    del red_graph, gat_graph
    dump()
    x = torch.from_numpy(np.asarray(rd.features, np.float32)).to(dev)
    csr = CSRGraph.from_edges(rd.src, rd.dst, rd.num_nodes, device=dev)
    out["ns_p1"] = ns_step_gather(rd, x, DeviceNeighborSampler(csr, NS_FANOUTS, device=dev))
    del x, csr
    torch.cuda.empty_cache()
    dump()
    out["partition"] = partition_checks()
    pd = load_node_dataset("ogbn-products")
    it = ClusterIter(PRODUCTS_KEY, pd.src, pd.dst, pd.num_nodes, pd.features, pd.labels,
                     pd.train_mask, CLUSTER_PSIZE, 32, method="metis", cache_dir=data_root(),
                     device=dev)
    out["cluster_p1"] = cluster_batch_checks(it.first(), it.features,
                                             torch.Generator(device=dev).manual_seed(12))["p1"]
    dump()
    return out


def _b2_call(m, rev, g_out, node, a_s, v, kw):
    """b2 of either checkout's ``gat_attention`` module: one whose b2 takes
    ``v_dtype`` (and returns grad_v, w2, w3) or one that takes v itself
    (and returns grad_v, grad_a_src)."""
    args = (rev.indptr, rev.src, rev.eid, g_out, node, a_s)
    if "v_dtype" in inspect.signature(m.gat_attention_bwd).parameters:
        return m.gat_attention_bwd(*args, split=rev.split, v_dtype=v.dtype, **kw)
    return m.gat_attention_bwd(*args, v, split=rev.split, **kw)


def _b2_outputs(got, v):
    """(grad_v, grad_a_src) of either form of b2's outputs."""
    if len(got) == 3:
        return got[0], (v.float() * got[1]).sum(-1) - got[2]
    return got


# K3's shapes on the main paths, timed against another checkout in turns:
# name: (graph, heads, d, keep, passes, dtypes)
K3_TURN_SHAPES = {
    "reddit_h1_d16": ("reddit", 1, 16, REDDIT_KEEP, ("fwd", "b2"), ("f32", "bf16")),
    "arxiv_h4_d16": ("ogbn-arxiv", 4, 16, REDDIT_KEEP, ("fwd", "b2"), ("f32", "bf16")),
    "arxiv_h4_d40": ("ogbn-arxiv", 4, 40, REDDIT_KEEP, ("fwd", "b2"), ("f32", "bf16")),
    "reddit_raw_h8_d16": ("reddit_raw", 8, 16, 1.0, ("fwd",), ("f32",)),
    "reddit_raw_h1_d41": ("reddit_raw", 1, 41, 1.0, ("fwd",), ("f32",)),
    "cluster_h4_d64": ("cluster", 4, 64, 0.5, ("fwd", "b2"), ("f32",)),
    "cluster_h1_d47": ("cluster", 1, 47, 0.5, ("fwd", "b2"), ("f32",)),
    "products_h4_d64": ("products", 4, 64, 1.0, ("fwd",), ("f32",)),
}


def k3_parent_turns(parent, card, out_path="k3_turns.jsonl", only=None):
    """K3's two passes from this checkout and from ``parent`` (another
    checkout, e.g. ``git archive`` of the parent commit, whose
    ``dgl_tpu_torch`` is imported as ``parent_dgl_tpu_torch`` and builds its
    own kernels) at the main paths' shapes (K3_TURN_SHAPES: gat_reddit's
    reddit and arxiv, ns_gat's evaluation on reddit as given, a products
    cluster batch, the whole products graph), on the same seeded inputs:
    the outputs' largest difference, each tree's launches and combine
    launches a call, and each tree's CUDA-event time in turns (in_turns:
    parent, this, this, parent). One JSON line a shape and pass, written to
    out_path after each, the card's line (phase_device's) first. Run it
    after phase_device() and phase_build(); the cluster batch partitions products on the host unless the data directory
    holds the partition (cluster_main writes it)."""
    import importlib
    import importlib.util

    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.data import data_root, load_node_dataset
    from dgl_tpu_torch.kernels import gat_attention as new_k3
    from dgl_tpu_torch.sampling.cluster import ClusterIter

    name = "parent_dgl_tpu_torch"
    pkg = os.path.join(os.path.abspath(parent), "dgl_tpu_torch")
    spec = importlib.util.spec_from_file_location(name, os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
    old_k3 = importlib.import_module(f"{name}.kernels.gat_attention")
    trees = (("parent", old_k3), ("new", new_k3))
    dev, lines = torch.device("cuda"), [{"card": card, "parent": os.path.abspath(parent)}]

    def graph_of(kind):
        if kind in ("reddit", "ogbn-arxiv"):
            return _gat_graph(kind, dev)
        data = load_node_dataset("reddit" if kind == "reddit_raw" else "ogbn-products")
        if kind != "cluster":
            return from_edges(data.src, data.dst, data.num_nodes, device=dev)
        return ClusterIter(PRODUCTS_KEY, data.src, data.dst, data.num_nodes, data.features,
                           data.labels, data.train_mask, CLUSTER_PSIZE, 32, method="metis",
                           cache_dir=data_root(), device=dev).first().graph

    kind_now, g = None, None
    for shape in only or K3_TURN_SHAPES:
        kind, h, d, keep, passes, dtypes = K3_TURN_SHAPES[shape]
        if kind != kind_now:
            g = None
            torch.cuda.empty_cache()
            kind_now, g = kind, graph_of(kind)
        gen = torch.Generator(device=dev).manual_seed(18)
        n_src, n_dst, rev = g.num_src_nodes, g.num_dst_nodes, g.reverse
        v = 1.0 + torch.randn(n_src, h, d, device=dev, generator=gen)
        g_out = 1.0 + torch.randn(n_dst, h, d, device=dev, generator=gen)
        a_s = torch.randn(n_src, h, device=dev, generator=gen)
        a_d = torch.randn(n_dst, h, device=dev, generator=gen)
        kw = dict(negative_slope=0.2, keep=keep,
                  seed=torch.tensor([20260], dtype=torch.int32, device=dev))
        for dt in dtypes:
            vv = v.to(BF16) if dt == "bf16" else v
            out = new_k3.gat_attention_fwd(g.indptr, g.src, vv, a_s, a_d, split=g.split, **kw)
            node = torch.stack([a_d, out[4], out[2], (g_out * out[0]).sum(-1)], -1)
            calls = {
                "fwd": {t: (lambda m=m: m.gat_attention_fwd(g.indptr, g.src, vv, a_s, a_d,
                                                             split=g.split, **kw))
                        for t, m in trees},
                "b2": {t: (lambda m=m: _b2_call(m, rev, g_out, node, a_s, vv, kw))
                       for t, m in trees}}
            for p in passes:
                got = {t: f() for t, f in calls[p].items()}
                if p == "b2":
                    got = {t: _b2_outputs(x, vv) for t, x in got.items()}
                diff = max(float((x.float() - y.float()).abs().max())
                           for x, y in zip(got["parent"], got["new"]))
                fns = {t: m.gat_attention_fwd if p == "fwd" else m.gat_attention_bwd
                       for t, m in trees}
                before = {t: (f.launches, f.combines) for t, f in fns.items()}
                parent_ms, new_ms = in_turns(calls[p]["parent"], calls[p]["new"])
                made = 2 * (20 + 3)  # in_turns' calls of each: two medians of 20, 3 warm-up
                row = {"shape": shape, "pass": p, "dtype": dt, "heads": h, "d": d, "keep": keep,
                       "nodes": n_dst, "edges": g.num_edges, "parent_ms": parent_ms,
                       "new_ms": new_ms, "new_over_parent": new_ms / parent_ms,
                       "max_abs_diff": diff,
                       "long_rows": (g.split if p == "fwd" else rev.split).num_long}
                for t, f in fns.items():
                    row[f"{t}_launches_a_call"] = (f.launches - before[t][0]) / made
                    row[f"{t}_combines_a_call"] = (f.combines - before[t][1]) / made
                print(json.dumps(row), flush=True)
                lines.append(row)
                with open(out_path, "w") as f:
                    f.writelines(json.dumps(r) + "\n" for r in lines)
            del out, node, calls, got
        del v, g_out, a_s, a_d
    return lines


# -- the SpMM / SDDMM kernel sweep (the suite's L0 tier) --------------------

def gather_orders(g, gen):
    """At each SDDMM width, gsddmm's two graph gathers in source order
    (gather_src_rows, gather_dst: P1 over the graph's CSRs) beside the same
    gathers in index order (row_gather_async over g.src and g.dst), bit for
    bit equal, CUDA-event medians. A measurement for the choice between the
    orders, not an option of the package."""
    from dgl_tpu_torch.kernel.bench_kernels import FEAT_SIZES
    from dgl_tpu_torch.kernels.row_gather import row_gather_async
    from dgl_tpu_torch.ops import gather_dst, gather_src_rows

    out = {}
    for d in FEAT_SIZES:
        u = torch.randn(g.num_src_nodes, d, device=g.src.device, generator=gen)
        by = {"src_source": lambda: gather_src_rows(g, u), "src_index": lambda: row_gather_async(u, g.src),
              "dst_source": lambda: gather_dst(g, u), "dst_index": lambda: row_gather_async(u, g.dst)}
        for side in ("src", "dst"):
            if not torch.equal(by[f"{side}_source"](), by[f"{side}_index"]()):
                raise AssertionError(f"D={d}: the {side} gathers in the two orders differ")
        out[d] = {k: median_ms(f, reps=10, warmup=2) for k, f in by.items()}
        del u
        torch.cuda.empty_cache()
    return out


def _raw_graph(name):
    """The dataset's graph as given, on the card (the sweep's graphs)."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.data import load_node_dataset

    data = load_node_dataset(name)
    return from_edges(data.src, data.dst, data.num_nodes, device="cuda")


def phase_kernel_sweep(graphs):
    """dgl_tpu_torch.kernel.bench_kernels at its defaults (copy_lhs·sum
    SpMM, add SDDMM, widths 1-128) on reddit, ogbn-arxiv and ogbn-proteins
    as given (no bidirecting, no self-loops): every point held to its plain
    version before it is timed (the sweep raises otherwise), or an OOM row,
    which the sweep gives only for torch.OutOfMemoryError; and gather_orders
    on each graph."""
    from dgl_tpu_torch.kernel import bench_kernels

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows, orders, log = [], {}, io.StringIO()
    for name, g in graphs.items():
        with contextlib.redirect_stdout(log):
            rows += bench_kernels.bench_spmm(name, g, "copy_lhs", "sum")
            rows += bench_kernels.bench_sddmm(name, g, "add")
        orders[name] = gather_orders(g, gen)
        torch.cuda.empty_cache()
    want = {(n, k, d) for n in graphs for k in ("spmm", "sddmm") for d in bench_kernels.FEAT_SIZES}
    got = {(r["dataset"], r["kind"], r["hidden"]) for r in rows}
    if got != want or len(rows) != len(want):
        raise AssertionError(f"the sweep gave {len(rows)} rows; want {len(want)}")
    for r in rows:
        if not r["oom"] and not r["bound_used"] <= 1.0:
            raise AssertionError(f"sweep point {r} beyond its bound")
    emit("kernel_sweep", seconds=time.perf_counter() - t_phase, hbm_bytes_per_s=HBM_BYTES_PER_S,
         edges={n: g.num_edges for n, g in graphs.items()}, rows=rows, gather_orders=orders,
         oom=[(r["dataset"], r["kind"], r["hidden"]) for r in rows if r["oom"]])
    return rows, orders


# -- neighbour sampling: ns_sage and ns_gat on full reddit ------------------

NS_RUNS = {  # key: (driver, its flags) at the drivers' defaults (fanouts 10,25, batch 1000, hidden 16)
    # one evaluation (after epoch 5) and epochs 6 and 7 in "Avg epoch time"
    "sage": ("ns_sage", ["--num-epochs", "7"]),
    "sage_host": ("ns_sage", ["--num-epochs", "1", "--host-sampler"]),
    "sage_noreplace": ("ns_sage", ["--num-epochs", "1", "--no-replace"]),
    # 8 heads; one evaluation, after epoch 1
    "gat": ("ns_gat", ["--num-epochs", "2", "--eval-every", "1"]),
}
NS_PROFILE_STEPS = 20  # further steps of the "sage" and "gat" runs under torch.profiler
NS_FANOUTS, NS_BATCH, NS_HEADS, NS_HIDDEN = (10, 25), 1000, 8, 16


def ns_launches(kind, layers, steps, evals):
    """Launches of a run of ns_sage (``kind`` "sage") or ns_gat ("gat"),
    from the code (benchmarks/sampling/pipeline.py, nn/conv.py, ops/spmm.py):
    a step gathers its features with P1 in index order once and runs no K1,
    K2 or K3 (the block forms are reshapes); an evaluation is one full-graph
    forward without gradients, one K1 forward a SAGEConv layer (it
    aggregates once, projected first or not) or one K3 forward and its
    scores a fused GATConv layer."""
    gat = layers * evals if kind == "gat" else 0
    return {"row_gather_async": steps, "row_gather_by_source": 0, "seg_sum": 0,
            "csr_spmm": layers * evals if kind == "sage" else 0} | dict.fromkeys(
        K3_COUNTERS, 0) | {"gat_attention_fwd": gat, "gat_scores": gat}


def ns_gat_memory_bound(blocks, in_feats, heads, hidden):
    """The bytes an ns_gat step may add above its graph, data and samplers,
    from the block sizes and the code: P1's (n0, in) output, which the
    first projection keeps for its weight gradient, and eight float32
    (n0, H·D) buffers, n0 the outermost block's sources: the projection z
    and its gradient, the (nd, f, H, D) product with attn_r and the
    einsum's operand, and their gradients (each at most n0·H·D)."""
    n0 = blocks[0].num_src_nodes
    return 4 * (n0 * in_feats + 8 * n0 * heads * hidden)


def ns_step_no_host_sync(kind, csr, x, y):
    """One device-sampler training step of ns_sage's or ns_gat's model
    (make_train_step, as they run it) under set_sync_debug_mode("error"), sampling
    included, after a warm-up step (the epoch's one upload of its seeds)."""
    from dgl_tpu_torch.benchmarks.sampling.pipeline import make_train_step
    from dgl_tpu_torch.models import GAT, GraphSAGE
    from dgl_tpu_torch.sampling import DeviceNeighborSampler

    dev = x.device
    gen = torch.Generator().manual_seed(1)
    if kind == "sage":
        model = GraphSAGE(x.shape[1], NS_HIDDEN, int(y.max()) + 1, 2, dropout=0.5, device=dev,
                          generator=gen)
    else:
        model = GAT(x.shape[1], NS_HIDDEN, int(y.max()) + 1, (NS_HEADS, 1), feat_drop=0.5,
                    attn_drop=0.5, fused=True, device=dev, generator=gen)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=0.003), x, y,
                           torch.Generator(device=dev).manual_seed(2))
    sampler = DeviceNeighborSampler(csr, NS_FANOUTS, device=dev)
    batches = sampler.batches(np.arange(3 * NS_BATCH), NS_BATCH,
                              torch.Generator(device=dev).manual_seed(3))
    step(next(batches))
    out = []
    no_host_sync(lambda: out.append(step(next(batches))), lambda: out[0][0].item())
    if not math.isfinite(out[0][0].item()):
        raise AssertionError(f"the {kind} step under the sync check gave a non-finite loss")


def ns_step_gather(data, x, sampler):
    """P1 in index order on one real step's indices (the device sampler's
    first batch of a shuffled epoch): bit for bit against x[idx], two runs
    equal, CUDA-event medians beside the plain version, index_select and the
    bound of its distinct rows, and each call's host and device time."""
    from dgl_tpu_torch.kernels.row_gather import row_gather_async, row_gather_plain

    dev = x.device
    perm = np.random.default_rng(0).permutation(np.flatnonzero(data.train_mask))
    idx = next(sampler.batches(perm, NS_BATCH, torch.Generator(device=dev).manual_seed(5))).input_nodes
    got = row_gather_async(x, idx)
    if not (torch.equal(got, x[idx.long()]) and torch.equal(got, row_gather_async(x, idx))):
        raise AssertionError("P1 on a step's input_nodes differs from x[idx] or between runs")
    bound, by, bound_rows = gather_bound(idx, 4 * x.shape[1])
    kern = lambda: row_gather_async(x, idx)  # noqa: E731
    lib = lambda: x.index_select(0, idx)  # noqa: E731
    p1 = {"rows": idx.numel(), "distinct_rows": torch.unique(idx).numel(), "d": x.shape[1],
          "max_abs_err": (got - x[idx.long()]).abs().max().item(),
          "ms": median_ms(kern, reps=30, warmup=3),
          "ms_tile128": median_ms(lambda: row_gather_async(x, idx, tile=128), reps=30, warmup=3),
          "plain_ms": median_ms(lambda: row_gather_plain(x, idx), reps=30, warmup=3),
          "library_ms": median_ms(lib, reps=30, warmup=3),
          "bound_ms": bound, "bound_by": by, "bound_ms_e_rows": bound_rows,
          "host_device": host_and_device(kern), "library_host_device": host_and_device(lib)}
    del got
    return p1


def phase_ns_main():
    """ns_sage and ns_gat on the full reddit graph (NS_RUNS), each run with
    every launch and combine counter set to 0 just before it and read just
    after it: P1 in index order once a step, no K1, K2 or K3 in a step, K1
    (sage) or K3 forward (gat) in the evaluations as ns_launches derives
    them, each launch over a CSR with long rows combining once; losses
    finite and falling; the reference's lines; ns_gat's training memory
    under ns_gat_memory_bound; the profiles of NS_PROFILE_STEPS steps. Then
    one step of each model under the sync check, P1 on a real step's
    input_nodes bit for bit against x[idx] and timed beside index_select and
    its bound (the distinct rows read once), and K3 forward at both of the
    evaluation's layers (reddit without self-loops, H = 8, D = 16 and
    H = 1, D = 41) held by check_k3_fwd and timed."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.benchmarks.sampling import ns_gat, ns_sage
    from dgl_tpu_torch.data import load_node_dataset
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels import gat_attention as k3
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_fwd, gat_attention_fwd_plain
    from dgl_tpu_torch.kernels.row_gather import row_gather_async, row_gather_by_source
    from dgl_tpu_torch.kernels.seg_sum import seg_sum
    from dgl_tpu_torch.sampling import CSRGraph, DeviceNeighborSampler

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    drivers = {"ns_sage": ns_sage, "ns_gat": ns_gat}
    counters = {"row_gather_async": row_gather_async, "row_gather_by_source": row_gather_by_source,
                "csr_spmm": csr_spmm, "seg_sum": seg_sum} | {
        name: getattr(k3, name) for name in K3_COUNTERS}
    res, launches, combines = {}, {}, {}
    for key, (driver, argv) in NS_RUNS.items():
        torch.cuda.synchronize()
        zero_counts(counters)
        flags = argv + (["--profile", str(NS_PROFILE_STEPS)] if key in ("sage", "gat") else [])
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            r = drivers[driver].main(flags + ["--device", "cuda"])
        r["run_s"] = time.perf_counter() - t0
        launches[key] = {k: fn.launches for k, fn in counters.items()}
        combines[key] = combine_counts(counters)
        out = log.getvalue()
        want_lines = ["Epoch 00000 | Step 00000 | Loss", "Speed (samples/sec)", "Epoch Time(s):"]
        want_lines += ["Eval Acc", "Test Acc:"] if r["eval_epochs"] else []
        want_lines += ["Avg epoch time:"] if r["avg_epoch_s"] is not None else []
        missing = [ln for ln in want_lines if ln not in out]
        if missing and device == "cuda":
            raise AssertionError(f"{key}: {driver} printed no {missing} line")
        r["log_tail"] = out.splitlines()[-6:]
        res[key] = r
        torch.cuda.empty_cache()
    data = load_node_dataset("reddit")
    g = from_edges(data.src, data.dst, data.num_nodes, device=dev)
    want_l, want_c = {}, {}
    for key, r in res.items():
        kind = "gat" if NS_RUNS[key][0] == "ns_gat" else "sage"
        steps = r["steps"] + (NS_PROFILE_STEPS if r["profile"] else 0)
        want_l[key] = ns_launches(kind, 2, steps, len(r["eval_epochs"]))
        # K1, K2 and K3 fold long rows in their launch: no combine launch
        want_c[key] = {k: 0 for k in want_l[key] if k in combines[key]}
        losses = r["losses"]
        if not (all(math.isfinite(v) for v in losses)
                and statistics.mean(losses[-10:]) < statistics.mean(losses[:10])):
            raise AssertionError(f"{key}: losses not finite and falling: {losses}")
    if launches != want_l:
        raise AssertionError(f"launches {launches}; want {want_l}")
    if combines != want_c:
        raise AssertionError(f"combine launches {combines}; want {want_c}")

    x = torch.from_numpy(np.asarray(data.features, np.float32)).to(dev)
    y = torch.from_numpy(np.asarray(data.labels)).to(dev)
    csr = CSRGraph.from_edges(data.src, data.dst, data.num_nodes, device=dev)
    sampler = DeviceNeighborSampler(csr, NS_FANOUTS, device=dev)
    blocks = sampler.skeleton_blocks(NS_BATCH)
    mem_bound = ns_gat_memory_bound(blocks, x.shape[1], NS_HEADS, NS_HIDDEN)
    gat_extra = res["gat"]["train_peak_bytes"] - res["gat"]["setup_bytes"]
    if not gat_extra < mem_bound:
        raise AssertionError(f"ns_gat's training adds {gat_extra} B, over its bound {mem_bound} B")
    for kind in ("sage", "gat"):
        ns_step_no_host_sync(kind, csr, x, y)

    p1 = ns_step_gather(data, x, sampler)

    # K3 forward at both of the evaluation's layers on reddit as given:
    # H = 8, D = 16, then H = 1, D = 41
    gen = torch.Generator(device=dev).manual_seed(6)
    n, e = g.num_dst_nodes, g.num_edges
    kw = dict(negative_slope=0.2)
    k3 = {}
    for key, h, d in (("h8", NS_HEADS, NS_HIDDEN), ("h1_d41", 1, data.num_classes)):
        v = 1.0 + torch.randn(n, h, d, device=dev, generator=gen)
        a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
        acc = [0.0, 0.0, 0.0]
        check_k3_fwd(f"reddit H={h} D={d}", g, v, a_s, a_d, kw, acc)
        k3_args = (g.indptr, g.src, v, a_s, a_d)
        bound, by = k3_fwd_bound(n, n, e, h, d)
        k3[key] = {
            "h": h, "d": d, "edges": e, "long_rows": g.split.num_long,
            "ms": median_ms(lambda: gat_attention_fwd(*k3_args, split=g.split, **kw), reps=20,
                            warmup=3),
            "plain_ms": median_ms(lambda: gat_attention_fwd_plain(*k3_args, **kw), reps=3,
                                  warmup=1),
            "bound_ms": bound, "bound_by": by, "max_abs_err": acc[0], "max_abs_err_f64": acc[1],
            "max_bound_used": acc[2]}
        del v, a_s, a_d, k3_args

    def profile_fields(p):
        return {k: p[k] for k in ("steps", "wall_ms_per_step", "device_busy_ms_per_step",
                                  "device_idle_share")} | {
            "kernels": [{"name": k["name"][:80], "device_ms": k["device_ms_per_step"],
                         "calls": k["calls_per_step"]} for k in p["kernels"][:10]]}

    fields = ("run_s", "load_s", "setup_s", "steps", "steps_per_epoch", "eval_epochs",
              "epochs_s", "avg_epoch_s", "samples_per_s", "eval_acc", "test_acc",
              "setup_bytes", "train_peak_bytes", "log_tail")
    n_train = int(np.asarray(data.train_mask).sum())
    emit("ns_main", seconds=time.perf_counter() - t_phase, device=res["sage"]["device"],
         synthetic=res["sage"]["synthetic"], runs={k: NS_RUNS[k][1] for k in NS_RUNS},
         train_nodes=n_train, input_nodes=blocks[0].num_src_nodes,
         **{k: {f: r[f] for f in fields} | {
             "losses_first_last": [r["losses"][:3], r["losses"][-3:]],
             "epoch_samples_per_s": [n_train / t for t in r["epochs_s"]],
             "launches": launches[k], "combines": combines[k],
             "profile": profile_fields(r["profile"]) if r["profile"] else None}
            for k, r in res.items()},
         gat_train_extra_bytes=gat_extra, gat_memory_bound_bytes=mem_bound,
         no_host_sync=True, p1_step=p1, k3_fwd_h8=k3["h8"],
         k3_fwd_h1_d41=k3["h1_d41"])
    return launches, p1, k3


# -- cluster-batched training: cluster_sage (SAGE, GAT) and cluster_gcn_lp --

CLUSTER_RUNS = {  # key: (driver, its flags) at the drivers' defaults
    # full products, psize 15000, 32 parts a step, 3 layers of 256 (GAT: 4
    # heads of 64, the last layer 1 head): a full-graph evaluation every
    # epoch, epoch 4 in "Training time/epoch" (cut from 5 for time), then
    # profiled steps
    "sage": ("cluster_sage", ["--model", "sage", "--n-epochs", "4", "--eval"]),
    "gat": ("cluster_sage", ["--model", "gat", "--n-epochs", "4", "--eval"]),
    # arxiv, psize 2000, the dot predictor: an MRR evaluation every epoch,
    # and the untrained encoder's and the raw features' MRR before training
    "lp": ("cluster_gcn_lp", ["--n-epochs", "5", "--eval", "--yardsticks"]),
}
CLUSTER_PROFILE_STEPS = 30  # further steps of the sage and gat runs, the loader included
CLUSTER_PSIZE, CLUSTER_LAYERS, CLUSTER_HIDDEN, CLUSTER_HEADS = 15000, 3, 256, 4
PRODUCTS_KEY = "ogbn-products_s1.0"  # cluster_sage's partition cache key at --scale 1
_KERNEL_COUNTERS = ("row_gather_async", "row_gather_by_source", "csr_spmm", "seg_sum",
                    *K3_COUNTERS)


def cluster_launches(kind, steps, batches, evals, in_feats, classes, layers=CLUSTER_LAYERS,
                     hidden=CLUSTER_HIDDEN):
    """Launches of a run of cluster_sage ("sage", "gat") or cluster_gcn_lp
    with the dot predictor ("lp"), from the code (sampling/cluster.py,
    nn/conv.py, ops/spmm.py, ops/sddmm.py, ops/gather.py): every batch taken
    from the iterator gathers its features by P1 in index order once;
    a SAGE step launches K1 as sage_k1_launches derives it, a fused GAT step
    one K3 forward and one b2 a layer, and one each of K3's node passes; an
    LP step its SAGE encoder's K1 and, for the scores of the batch's graph
    and of its negative graph, two P1
    gathers in source order each (u_dot_v's gather_src_rows and
    gather_dst), whose adjoints are one K1 and one K2; an evaluation is one
    full-graph forward without gradients, one K1 (SAGE) or K3 forward and
    its scores (GAT) a layer."""
    out = dict.fromkeys(_KERNEL_COUNTERS, 0)
    out["row_gather_async"] = batches
    if kind == "sage":
        out["csr_spmm"] = (steps * len(sage_k1_launches(in_feats, hidden, classes, layers, False))
                           + evals * layers)
    elif kind == "gat":
        out["gat_attention_fwd"] = out["gat_scores"] = layers * (steps + evals)
        out["gat_attention_bwd"] = out["gat_score_grad"] = out["gat_vector_grad"] = layers * steps
    else:
        enc = len(sage_k1_launches(in_feats, hidden, hidden, layers, False))
        out.update(csr_spmm=steps * (enc + 2) + evals * layers, seg_sum=2 * steps,
                   row_gather_by_source=4 * steps)
    return out


def cluster_gat_memory_bound(n, e, in_feats, classes, heads=CLUSTER_HEADS, hidden=CLUSTER_HIDDEN,
                             layers=CLUSTER_LAYERS, n_params=0):
    """The bytes a cluster GAT step may add above the data and the full
    graph, from the code (sampling/cluster.py, models/gat.py, nn/conv.py,
    kernels/gat_attention.py), n and e the largest batch's nodes and edges:
    two batches on the card (the step's and the next one's copies): their
    graphs' CSRs both ways (src, dst, eid, indptr in int32; the row splits
    in int64 at most 2 words an edge) and x, y and the mask; a layer from
    width w to H·D: dropout's mask and output (2 n·w), z, K3's out and w1,
    the elu output and their gradients (8 n·H·D), and 12 (n, H) scalars
    (a_src, a_dst, inv_s, w1s, shift, w3 and their gradients); the
    parameters with their gradients and Adam's two moments (4 copies)."""
    batch = 4 * (6 * e + 2 * n) + 8 * 2 * e + 4 * n * in_feats + 9 * n
    per_layer, w = 0, in_feats
    for i in range(layers):
        h, d = (1, classes) if i == layers - 1 else (heads, hidden // heads)
        per_layer += 4 * n * (2 * w + 8 * h * d + 12 * h)
        w = h * d
    return 2 * batch + per_layer + 16 * n_params


def memsafe_memory_bound(n, e, heads, d):
    """The bytes one forward of GATConv's memory-safe form without gradients
    may add above its graph, x and weights, from the code
    (nn/conv.py:GATConv._memory_safe, ops/softmax.py, ops/rel.py): five
    (E, H) float32 tensors live at once (edge_softmax's logits, exp,
    denominator, its clamp and the quotient; then alpha and its layouts
    in RelEdgeWeights.build), one (E, H) bool (the rescue test); z, its
    head-major copy, the per-head sums and their stack (four (N, H, D)),
    and eight (N, H) scalars."""
    return 4 * 5 * e * heads + e * heads + 4 * 4 * n * heads * d + 4 * 8 * n * heads


def partition_checks():
    """partition_assignment of the full products graph (metis, k = 15000)
    into cluster_sage's cache, timed alone: nothing else runs beside the
    serial host partitioner. Then every node's part in [0, k) and the
    parts' lists covering every node once; seconds, edge cut and balance."""
    from dgl_tpu_torch.data import data_root, load_node_dataset
    from dgl_tpu_torch.graph.partition import (get_partition_list, partition_assignment,
                                               partition_stats)

    t0 = time.perf_counter()
    data = load_node_dataset("ogbn-products")
    t1 = time.perf_counter()
    part = partition_assignment(data.src, data.dst, data.num_nodes, CLUSTER_PSIZE,
                                method="metis", seed=0, cache_dir=data_root(),
                                cache_key=PRODUCTS_KEY)
    r = {"load_s": t1 - t0, "partition_s": time.perf_counter() - t1}
    k = CLUSTER_PSIZE
    if not (part.shape == (data.num_nodes,) and part.min() >= 0 and part.max() < k):
        raise AssertionError(f"products partition out of [0, {k}): {part.min()} .. {part.max()}")
    lists = get_partition_list(part, k)
    cover = np.concatenate(lists)
    if not (len(cover) == data.num_nodes and np.array_equal(np.sort(cover),
                                                            np.arange(data.num_nodes))):
        raise AssertionError("the products parts do not cover every node once")
    sizes = np.array([len(a) for a in lists])
    return r | partition_stats(data.src, data.dst, part, k) | {
        "nodes": data.num_nodes, "edges": len(data.src), "empty_parts": int((sizes == 0).sum()),
        "part_nodes_min_max": [int(sizes.min()), int(sizes.max())]}


def k3_fwd_full(g, h, d, gen, rows_n=20000):
    """K3 forward on the whole graph at H = h, D = d (v is N·H·D float32,
    beyond the L2): two runs bitwise equal, CUDA-event median against the
    bound, and the rows of ``rows_n`` random nodes and of the 50 longest
    rows held to a float64 plain run on their sub-CSR (the plain version
    of the whole graph would gather an (E, H, D) buffer)."""
    from dgl_tpu_torch.kernels.gat_attention import gat_attention_fwd, gat_attention_fwd_plain

    dev = g.indptr.device
    n, e = g.num_dst_nodes, g.num_edges
    v = 1.0 + torch.randn(n, h, d, device=dev, generator=gen)
    a_s, a_d = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
    kw = dict(negative_slope=0.2)
    call = lambda: gat_attention_fwd(g.indptr, g.src, v, a_s, a_d, split=g.split, **kw)  # noqa: E731
    got = call()
    if not all(torch.equal(x, y) for x, y in zip(got, call())):
        raise AssertionError("K3 forward on full products: two runs differ")
    ip = g.indptr.long()
    deg = ip[1:] - ip[:-1]
    rows = torch.unique(torch.cat([torch.randperm(n, device=dev, generator=gen)[:rows_n],
                                   deg.topk(50).indices]))
    rdeg = deg[rows]
    sub_ip = torch.zeros(len(rows) + 1, dtype=torch.int64, device=dev)
    sub_ip[1:] = rdeg.cumsum(0)
    start = torch.repeat_interleave(ip[rows] - sub_ip[:-1], rdeg)
    sub_src = g.src[start + torch.arange(int(sub_ip[-1]), device=dev)]
    v64, s64, d64 = v.double(), a_s.double(), a_d[rows].double()
    want = gat_attention_fwd_plain(sub_ip, sub_src, v64, s64, d64, **kw)
    absrun = gat_attention_fwd_plain(sub_ip, sub_src, v64.abs(), s64, d64, **kw)
    amp = d64.abs() + s64.abs().max() + want[4].abs()
    mags = [absrun[0], absrun[1], want[2].abs(), want[3].abs(), want[4].abs()]
    acc = [0.0, 0.0, 0.0]
    _merge(acc, [check(f"products K3 fwd {nm}", x[rows], sub_ip, (w, m), None, slack=(2, 8),
                       amp=amp)
                 for nm, x, w, m in zip(("out", "w1", "inv_s", "w1s", "shift"), got, want, mags)])
    bound, by = k3_fwd_bound(n, n, e, h, d)
    return {"h": h, "d": d, "nodes": n, "edges": e, "v_bytes": v.numel() * 4,
            "rows_checked": len(rows), "edges_checked": int(sub_ip[-1]),
            "ms": median_ms(call, reps=10, warmup=2),
            # the plain version of the whole graph gathers (E, H, D): 63 GB at H = 4, D = 64
            "plain_ms": None, "library_ms": None, "bound_ms": bound, "bound_by": by,
            "max_abs_err": None, "max_abs_err_f64": acc[1], "max_bound_used": acc[2],
            "long_rows": g.split.num_long, "chunks": g.split.num_chunks}


def memsafe_forward(g, x, heads=CLUSTER_HEADS, d=CLUSTER_HIDDEN // CLUSTER_HEADS):
    """One forward (no gradient) of GATConv's memory-safe edge form on the
    whole graph: its peak device memory above the graph, x and the layer
    against memsafe_memory_bound, its time, and its output against the
    fused form's (K3) with the same weights (rows of at most HUB_DEG
    in-edges at RTOL/ATOL; the largest difference on any row reported)."""
    from dgl_tpu_torch.nn import GATConv
    from dgl_tpu_torch.nn import conv as conv_mod

    dev = x.device
    layer = GATConv(x.shape[1], d, heads, device=dev, generator=torch.Generator().manual_seed(11))
    layer.eval()
    e, n = g.num_edges, g.num_dst_nodes
    edge_msg_bytes = 4 * e * heads * d
    if not edge_msg_bytes > conv_mod._EDGE_MSG_LIMIT_BYTES:
        raise AssertionError("products' edge messages are under the limit: no memory-safe form")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = layer(g, x)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    extra = torch.cuda.max_memory_allocated() - before
    bound = memsafe_memory_bound(n, e, heads, d)
    if not (extra <= bound and torch.isfinite(out).all()):
        raise AssertionError(f"memory-safe GATConv: {extra} B above its inputs (bound {bound} B), "
                             f"finite {bool(torch.isfinite(out).all())}")
    with torch.no_grad():
        ms = median_ms(lambda: layer(g, x), reps=3, warmup=0)
        layer.fused = True
        fused = layer(g, x)
        layer.fused = False
    short = (g.in_degrees() <= HUB_DEG)
    if not torch.allclose(out[short], fused[short], rtol=RTOL, atol=ATOL):
        raise AssertionError("memory-safe GATConv differs from the fused form: max abs err "
                             f"{(out[short] - fused[short]).abs().max().item()}")
    return {"nodes": n, "edges": e, "heads": heads, "d": d, "in_feats": x.shape[1],
            "extra_bytes": extra, "bound_bytes": bound, "edge_message_bytes": edge_msg_bytes,
            "first_s": seconds, "ms": ms,
            "max_abs_err_vs_fused": (out - fused).abs().max().item()}


def cluster_batch_checks(batch, x_full, gen):
    """The kernels at the shapes one products cluster batch gives them:
    both K3 passes at H = 4, D = 64 and H = 1, D = 47 (k3_shape, with the
    driver's attention dropout) and K1 at D = 100 and 256 forward (mean,
    dst CSR) and backward (sum, reverse CSR) (k1_width); P1 in index order
    on the batch's nodes bit for bit against x[idx], timed beside
    index_select and its bound."""
    from dgl_tpu_torch.kernels.row_gather import row_gather_async, row_gather_plain

    g = batch.graph
    out = {"nodes": g.num_dst_nodes, "edges": g.num_edges,
           "max_in_degree": int(g.in_degrees().max()), **_split_fields(g)}
    for h, d in ((CLUSTER_HEADS, CLUSTER_HIDDEN // CLUSTER_HEADS), (1, 47)):
        out[f"k3_h{h}_d{d}"] = k3_shape(f"cluster batch H={h} D={d}", g, h, d, gen, keep=0.5)
    out["k1"] = {d: {"fwd": k1_width("cluster batch fwd", g, d, True, gen, plain=True,
                                     diagnose=True),
                     "bwd": k1_width("cluster batch bwd", g.reverse, d, False, gen, plain=True,
                                     diagnose=True)}
                 for d in (100, CLUSTER_HIDDEN)}
    idx = torch.from_numpy(batch.nodes).cuda()
    got = row_gather_async(x_full, idx)
    if not (torch.equal(got, x_full[idx]) and torch.equal(got, batch.x)):
        raise AssertionError("P1 on a cluster batch's nodes differs from x[idx]")
    bound, by, _ = gather_bound(idx, 4 * x_full.shape[1])
    kern = lambda: row_gather_async(x_full, idx)  # noqa: E731
    lib = lambda: x_full.index_select(0, idx)  # noqa: E731
    out["p1"] = {"rows": idx.numel(), "d": x_full.shape[1], "max_abs_err": 0.0,
                 "ms": median_ms(kern, reps=30, warmup=3),
                 "plain_ms": median_ms(lambda: row_gather_plain(x_full, idx), reps=30, warmup=3),
                 "library_ms": median_ms(lib, reps=30, warmup=3),
                 "bound_ms": bound, "bound_by": by,
                 "host_device": host_and_device(kern), "library_host_device": host_and_device(lib)}
    return out


def cluster_steps_no_host_sync(sage_iter, lp_iter):
    """One training step each of cluster_sage's SAGE and GAT models on a
    products batch and of cluster_gcn_lp's on an arxiv batch with its
    negatives, as the drivers build them (make_model, make_train_step),
    each after a warm-up step, once its batch has arrived, under
    set_sync_debug_mode("error")."""
    from dgl_tpu_torch.benchmarks.link_prediction import cluster_gcn_lp
    from dgl_tpu_torch.benchmarks.sampling import cluster_sage
    from dgl_tpu_torch.models import GraphSAGE

    dev = torch.device("cuda")
    losses = {}
    for kind, it in (("sage", sage_iter), ("gat", sage_iter), ("lp", lp_iter)):
        if kind == "lp":
            args = cluster_gcn_lp.parser().parse_args([])
            model = GraphSAGE(it.features.shape[1], args.n_hidden, args.n_hidden,
                              num_layers=args.n_layers, dropout=args.dropout, device=dev,
                              generator=torch.Generator().manual_seed(0))
            step = cluster_gcn_lp.make_train_step(
                model, None, torch.optim.Adam(model.parameters(), lr=args.lr),
                torch.Generator(device=dev).manual_seed(0))
        else:
            args = cluster_sage.parser().parse_args(["--model", kind])
            model = cluster_sage.make_model(args, it.features.shape[1],
                                            int(it.labels.max()) + 1, dev, 0)
            step = cluster_sage.make_train_step(
                model, torch.optim.Adam(model.parameters(), lr=args.lr),
                torch.Generator(device=dev).manual_seed(0))
        batches = iter(it)
        step(next(batches))  # warm-up: lazy allocations and the optimiser's state
        batch = next(batches)
        torch.cuda.synchronize()
        out = []
        no_host_sync(lambda: out.append(step(batch)), lambda: out[0].item())
        batches.close()
        losses[kind] = out[0].item()
        if not math.isfinite(losses[kind]):
            raise AssertionError(f"the cluster {kind} step under the sync check gave {losses[kind]}")
    return losses


def cluster_host_split(it, kind, steps=35, warmup=5):
    """A cluster step's host time without the loader: ``warmup + steps``
    batches collated first (the prefetch thread has ended when the steps
    run), then the steps of a fresh model of cluster_sage's, each timed on
    the host without a sync (its enqueue) and together with one (their
    wall). Beside the driver's per-step phases it says how much of a step is
    its own enqueue and how much the loader's thread adds."""
    import itertools

    from dgl_tpu_torch.benchmarks.sampling import cluster_sage

    dev = torch.device("cuda")
    args = cluster_sage.parser().parse_args(["--model", kind])
    model = cluster_sage.make_model(args, it.features.shape[1], int(it.labels.max()) + 1, dev, 0)
    step = cluster_sage.make_train_step(model, torch.optim.Adam(model.parameters(), lr=args.lr),
                                        torch.Generator(device=dev).manual_seed(0))
    batches = list(itertools.islice(iter(it), warmup + steps))
    for b in batches[:warmup]:
        step(b)
    torch.cuda.synchronize()
    host = []
    t0 = time.perf_counter()
    for b in batches[warmup:]:
        t1 = time.perf_counter()
        step(b)
        host.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    return {"steps": steps, "enqueue_ms_median": 1e3 * statistics.median(host),
            "wall_ms_per_step": 1e3 * (time.perf_counter() - t0) / steps}


def _gat_label_attention(model, g, x, y):
    """cluster_sage's GAT ``model`` (eval mode) on graph ``g``, layer by
    layer, reading each layer's attention off its logits with the exact
    edge softmax: over the destinations with in-edges, the sum of the
    attention mass on in-neighbours of the destination's own label (the
    heads' mean) a layer, and the sum of the plain share of such in-edges
    (the weights of a mean aggregation). Returns (logits, mass sums a
    layer, destinations with in-edges, plain share sum)."""
    import torch.nn.functional as F

    from dgl_tpu_torch.ops import edge_softmax

    src, dst = g.src.long(), g.dst.long()
    same = (y[src] == y[dst]).float()
    deg = g.in_degrees().float()
    live = deg > 0
    plain = torch.zeros(g.num_dst_nodes, device=x.device).index_add_(0, dst, same)
    h, mass = x, []
    for i, conv in enumerate(model.convs):
        z = conv.fc(h).view(-1, conv.num_heads, conv.out_feats)
        logits = F.leaky_relu((z * conv.attn_r).sum(-1)[src] + (z * conv.attn_l).sum(-1)[dst],
                              conv.negative_slope)
        alpha = edge_softmax(g, logits)
        on_label = torch.zeros(g.num_dst_nodes, conv.num_heads, device=x.device)
        on_label.index_add_(0, dst, alpha * same.unsqueeze(1))
        mass.append(float(on_label[live].mean(1).sum()))
        del z, logits, alpha, on_label
        h = conv(g, h)
        h = h.mean(1) if i == len(model.convs) - 1 else h.flatten(1)
    return h, mass, int(live.sum()), float((plain[live] / deg[live]).sum())


def cluster_gat_whole_vs_batch(model, it, g, train_mask):
    """cluster_sage's trained GAT on the whole products graph ``g`` and
    inside one epoch of its own batches (``it``, every node in one batch):
    the train accuracy of the same nodes, the share of the whole graph's
    train predictions in the three most predicted classes, the mean share
    of a node's in-edges that come from its own label, and each layer's
    mean attention mass on those in-edges (_gat_label_attention). It says
    where the whole-graph score falls away from the batches' and which
    layer's attention leaves the node's label."""
    t0 = time.perf_counter()
    dev = g.src.device
    y = it.labels
    train = torch.from_numpy(np.asarray(train_mask)).to(dev)
    model.eval()
    with torch.no_grad():
        logits, mass, rows, plain = _gat_label_attention(model, g, it.features, y)
        pred = logits.argmax(-1)
        del logits
        in_batch = torch.full_like(pred, -1)
        b_mass, b_rows, b_plain, batches = [0.0] * len(mass), 0, 0.0, 0
        for b in it:
            lg, m, r, p = _gat_label_attention(model, b.graph, b.x, b.y)
            in_batch[torch.from_numpy(b.nodes).to(dev)] = lg.argmax(-1)
            b_mass = [a + c for a, c in zip(b_mass, m)]
            b_rows, b_plain, batches = b_rows + r, b_plain + p, batches + 1
    share = torch.bincount(pred[train], minlength=int(y.max()) + 1).float() / train.sum()

    def acc(p):
        return float((p[train] == y[train]).float().mean())

    return {"seconds": time.perf_counter() - t0, "batches": batches,
            "train_nodes": int(train.sum()),
            "whole": {"train_acc": acc(pred), "top3_pred_share": float(share.topk(3).values.sum()),
                      "own_label_in_edge_share": plain / rows,
                      "attention_on_own_label": [m / rows for m in mass]},
            "batch": {"train_acc": acc(in_batch),
                      "own_label_in_edge_share": b_plain / b_rows,
                      "attention_on_own_label": [m / b_rows for m in b_mass]},
            "agree_train": float((pred[train] == in_batch[train]).float().mean())}


def phase_cluster_main():
    """Slice F on the card. The products partition (cached for the drivers)
    made and checked by partition_checks; cluster_sage with SAGE and
    with GAT on full products and cluster_gcn_lp on arxiv (CLUSTER_RUNS),
    each run with every counter set to 0 just before it and read just
    after it: launches as cluster_launches derives them, the reference's
    lines, losses finite and falling; GAT's training peak above its data
    and graph under cluster_gat_memory_bound; the profiles. Then one step
    of each model under the sync check, a step's host time without the
    loader (cluster_host_split), the kernels at one batch's shapes
    (cluster_batch_checks), K3 forward on the whole products graph
    (k3_fwd_full) and one forward of GATConv's memory-safe form there
    (memsafe_forward)."""
    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.benchmarks.link_prediction import cluster_gcn_lp
    from dgl_tpu_torch.benchmarks.sampling import cluster_sage
    from dgl_tpu_torch.data import NODE_DATASET_STATS, data_root, load_node_dataset
    from dgl_tpu_torch.kernels import gat_attention as k3
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm
    from dgl_tpu_torch.kernels.row_gather import row_gather_async, row_gather_by_source
    from dgl_tpu_torch.kernels.seg_sum import seg_sum
    from dgl_tpu_torch.sampling.cluster import ClusterIter

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    part = partition_checks()
    drivers = {"cluster_sage": cluster_sage, "cluster_gcn_lp": cluster_gcn_lp}
    counters = {"row_gather_async": row_gather_async, "row_gather_by_source": row_gather_by_source,
                "csr_spmm": csr_spmm, "seg_sum": seg_sum} | {
        name: getattr(k3, name) for name in K3_COUNTERS}
    res, launches, want = {}, {}, {}
    # the models the drivers build, kept for cluster_gat_whole_vs_batch
    models, make_model = [], cluster_sage.make_model
    cluster_sage.make_model = lambda *a, **kw: models.append(make_model(*a, **kw)) or models[-1]
    for key, (driver, argv) in CLUSTER_RUNS.items():
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        flags = argv + (["--profile", str(CLUSTER_PROFILE_STEPS)] if key != "lp" else [])
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            r = drivers[driver].main(flags + ["--device", "cuda"])
        r["run_s"] = time.perf_counter() - t0
        launches[key] = {k: fn.launches for k, fn in counters.items()}
        out = log.getvalue()
        lines = ["Training time/epoch"] + (["Run: 01, Epoch: 00, Loss:", "Train MRR:", "Yardsticks"]
                                           if key == "lp" else ["Run 00 | Epoch 00000 | Loss"])
        lines += ["Final Train", "Final Test", "partition[metis]"]
        missing = [ln for ln in lines if ln not in out]
        if missing and device == "cuda":
            raise AssertionError(f"{key}: {driver} printed no {missing} line")
        r["log_tail"] = out.splitlines()[-8:]
        losses = r["losses"][0] if key != "lp" else r["losses"]
        if not (all(math.isfinite(v) for v in losses)
                and statistics.mean(losses[-20:]) < statistics.mean(losses[:20])):
            raise AssertionError(f"{key}: losses not finite and falling: {losses}")
        ds = "ogbn-arxiv" if key == "lp" else "ogbn-products"
        _, _, feat, classes = NODE_DATASET_STATS[ds]
        evals = len(r["mrr"]) + 1 if key == "lp" else len(r["accs"])
        steps = r["steps"] + (r["profile"]["steps"] if r["profile"] else 0)
        want[key] = cluster_launches(key, steps, r["batches"], evals, feat, classes)
        res[key] = r
        if key == "gat":
            gat_model = models[-1]
        torch.cuda.empty_cache()
    cluster_sage.make_model = make_model
    del models
    if launches != want:
        raise AssertionError(f"cluster launches {launches}; want {want}")
    gat = res["gat"]
    n_params = sum(p.numel() for p in cluster_sage.make_model(
        cluster_sage.parser().parse_args(["--model", "gat"]), 100, 47, torch.device("cpu"),
        0).parameters())
    gat_bound = cluster_gat_memory_bound(gat["max_batch_nodes"], gat["max_batch_edges"], 100, 47,
                                         n_params=n_params)
    gat_extra = gat["train_peak_bytes"] - gat["setup_bytes"]
    if not gat_extra < gat_bound:
        raise AssertionError(f"cluster GAT's training adds {gat_extra} B, over its bound "
                             f"{gat_bound} B")

    data = load_node_dataset("ogbn-products")
    sage_iter = ClusterIter(PRODUCTS_KEY, data.src, data.dst, data.num_nodes, data.features,
                            data.labels, data.train_mask, CLUSTER_PSIZE, 32, method="metis",
                            cache_dir=data_root(), device=dev)
    arxiv = load_node_dataset("ogbn-arxiv")
    lp_iter = ClusterIter("ogbn-arxiv_lp_sync", arxiv.src, arxiv.dst, arxiv.num_nodes,
                          arxiv.features, arxiv.labels, np.ones(arxiv.num_nodes, bool), 2000, 32,
                          method="metis", cache_dir=data_root(), with_negatives=True, device=dev)
    sync_losses = cluster_steps_no_host_sync(sage_iter, lp_iter)
    del lp_iter
    host_split = {kind: cluster_host_split(sage_iter, kind) for kind in ("sage", "gat")}
    gen = torch.Generator(device=dev).manual_seed(12)
    batch = sage_iter.first()
    batch_checks = cluster_batch_checks(batch, sage_iter.features, gen)
    del batch
    g = from_edges(data.src, data.dst, data.num_nodes, device=dev)
    k3_full = k3_fwd_full(g, CLUSTER_HEADS, CLUSTER_HIDDEN // CLUSTER_HEADS, gen)
    torch.cuda.empty_cache()
    memsafe = memsafe_forward(g, sage_iter.features)
    torch.cuda.empty_cache()
    whole_vs_batch = cluster_gat_whole_vs_batch(gat_model, sage_iter, g, data.train_mask)
    del g, sage_iter, gat_model
    torch.cuda.empty_cache()

    def profile_fields(p):
        return {k: p[k] for k in ("steps", "wall_ms_per_step", "device_busy_ms_per_step",
                                  "device_idle_share")} | {
            "kernels": [{"name": k["name"][:80], "device_ms": k["device_ms_per_step"],
                         "calls": k["calls_per_step"]} for k in p["kernels"][:10]],
            "host_ops": [{"name": k["name"][:60], "self_cpu_ms": k["self_cpu_ms_per_step"],
                          "calls": k["calls_per_step"]} for k in p["host_ops"][:10]]}

    fields = ("run_s", "load_s", "setup_s", "partition", "steps", "batches", "steps_per_epoch",
              "epochs_s", "epoch_s", "log_tail")
    runs = {}
    for key, r in res.items():
        c = np.asarray(r["collate_ms"])
        runs[key] = {f: r[f] for f in fields} | {
            "launches": launches[key], "losses_first_last": [
                (r["losses"][0] if key != "lp" else r["losses"])[:3],
                (r["losses"][0] if key != "lp" else r["losses"])[-3:]],
            "collate_ms_median_p90_max": [float(np.median(c)), float(np.percentile(c, 90)),
                                          float(c.max())],
            "profile": profile_fields(r["profile"]) if r["profile"] else None}
        if key == "lp":
            runs[key] |= {"mrr": r["mrr"], "yardsticks": r["yardsticks"]}
        else:
            runs[key] |= {f: r[f] for f in ("accs", "max_batch_nodes", "max_batch_edges",
                                            "setup_bytes", "train_peak_bytes", "eval_peak_bytes")}
            runs[key]["phases_s_last_epoch"] = r["phases_s"][-1]
    emit("cluster_main", seconds=time.perf_counter() - t_phase, device=res["sage"]["device"],
         synthetic=res["sage"]["synthetic"], runs_flags={k: v[1] for k, v in CLUSTER_RUNS.items()},
         partition=part, **runs, gat_train_extra_bytes=gat_extra, gat_memory_bound_bytes=gat_bound,
         no_host_sync=sync_losses, host_split=host_split, batch=batch_checks,
         k3_fwd_products=k3_full,
         memory_safe=memsafe, gat_whole_vs_batch=whole_vs_batch)
    return launches, batch_checks, k3_full


# -- distributed: the halo exchange on ranks sharing the card ---------------

def halo_sage_launches(layers):
    """K1's and P1-in-source-order's launches on one rank in one HaloSAGE
    step, from the code (parallel/halo.py, parallel/halo_train.py): a layer
    gathers its payload (P1 over the send graph) and aggregates (K1 over
    the rank's bipartite CSR); layer 1's input is data, so it has no
    backward; every later layer runs K1 backward over the reverse CSR and
    the payload's adjoint (K1 over the send graph's reverse CSR), which
    ``exchange.send_adjoint_launches`` also counts (``send_adjoint``)."""
    return {"csr_spmm": layers + 2 * (layers - 1), "row_gather_by_source": layers,
            "send_adjoint": layers - 1}


def halo_gat_launches(layers):
    """K3's, K1's and P1's launches on one rank in one HaloGAT step: each
    layer's projection needs a gradient, so each runs K3 forward and b2
    with their node passes (the scores, their gradients and the vectors'),
    its payload's P1 and the payload's adjoint (K1, ``send_adjoint``)."""
    return {"gat_attention_fwd": layers, "gat_attention_bwd": layers, "gat_scores": layers,
            "gat_score_grad": layers, "gat_vector_grad": layers,
            "row_gather_by_source": layers, "csr_spmm": layers, "send_adjoint": layers}


def halo_rgcn_launches(layers, n_rel):
    """Weighted K1's and P1's launches on one rank in one HaloRGCN step:
    each layer's projections need a gradient, so each runs R weighted K1
    passes forward (the rank's dst CSR) and R backward (its reverse CSR),
    one P1 payload gather and the payload's adjoint (one K1,
    ``send_adjoint``)."""
    return {"csr_spmm": layers * (2 * n_rel + 1), "row_gather_by_source": layers,
            "send_adjoint": layers}


DIST_K = 2  # ranks sharing cuda:0 over gloo
DIST_TIMEOUT = 600.0  # a start of the ranks' limit, the ranks killed past it
DIST_RUNS = {  # key: (driver, its dataset, epochs): the drivers' configs, epochs cut
    "sage": ("main_sage", "reddit", 5),
    "gat": ("main_gat", "ogbn-arxiv", 5),
    "rgcn": ("main_rgcn", "ogbn-proteins", 4),
}
DIST_DP_BATCH, DIST_DP_FANOUTS = 1000, (25, 10)  # ns_sage's defaults (outermost first)
DIST_SAGE_LAYERS, DIST_GAT_LAYERS, DIST_RGCN_LAYERS = 2, 3, 3  # reddit's, arxiv's, proteins'
# one step's gradients against a float64 run of the same model (dist_grads):
# RTOL·|g64| + ATOL·max|g64| of its tensor is the CPU tests' gradient
# tolerance against JAX; the sharded gradient may add NOISE times one card's
# own distance from the float64 run; one card's is held at ONE_ATOL
DIST_GRAD_RTOL, DIST_GRAD_ATOL, DIST_GRAD_NOISE, DIST_GRAD_ONE_ATOL = 1e-3, 1e-5, 4.0, 1e-4


def _expect_launches(what, got, per_step, steps):
    want = {name: per_step.get(name, 0) * steps for name in got}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, derived {want}")


def _dist_forward_check(what, got, want):
    """A sharded run's logits (input order) against one card's, rtol/atol
    1e-4/1e-5: the rows' sums run in another order (local edges before
    halo edges in each row)."""
    got, want = torch.from_numpy(got), want.detach().cpu()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise AssertionError(f"{what}: sharded logits differ from one card's, max abs err {err}")
    return err


def _dist_run(kind, res, per_step, epochs):
    """The common checks of a sharded run: finite, falling losses, the
    parameters bitwise equal across the ranks, each rank's launches."""
    (losses,) = res["losses"]
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"sharded {kind}: losses not finite and falling: {losses}")
    for r, params in enumerate(res["params"][1:], 1):
        for key, v in params.items():
            if not np.array_equal(v, res["params"][0][key]):
                raise AssertionError(f"sharded {kind}: rank {r}'s {key} differs from rank 0's")
    for r, got in enumerate(res["launches"]):
        _expect_launches(f"sharded {kind} rank {r}", got, per_step, epochs)
    return {key: res[key] for key in ("partition_s", "build_s", "write_s", "ranks_s",
                                      "nodes_per_shard", "rows_per_pair", "exchange_stats",
                                      "epoch_s", "epochs_s", "num_edges", "synthetic")} | {
        "losses": losses, "launches": res["launches"]}


def _halo_sage_as_graphsage(params):
    """HaloSAGE's (JAX-layout) weights as GraphSAGE's state dict."""
    sd = {}
    for i in range(len(params) // 3):
        sd[f"convs.{i}.fc_self.weight"] = torch.from_numpy(params[f"layers.{i}.w_self"].T.copy())
        sd[f"convs.{i}.fc_neigh.weight"] = torch.from_numpy(params[f"layers.{i}.w_neigh"].T.copy())
        sd[f"convs.{i}.fc_neigh_bias"] = torch.from_numpy(params[f"layers.{i}.bias"])
    return sd


def _gat_edges(data):
    """The graph main_gat shards on arxiv: bidirected, then self-loops
    (numpy, input ids)."""
    from dgl_tpu_torch.graph import transforms

    n = data.num_nodes
    s, d = transforms.to_bidirected(torch.from_numpy(np.asarray(data.src, np.int64)),
                                    torch.from_numpy(np.asarray(data.dst, np.int64)), n)
    return tuple(t.numpy() for t in transforms.add_self_loops(s, d, n))


def _k1_halo_model(kind, data, params, dev, heads=None):
    """The halo model ``kind`` at ``params`` over a plan of one shard (no
    exchange: the whole graph in one CSR) and its forward's arguments,
    rows in input order."""
    from dgl_tpu_torch.parallel import halo
    from dgl_tpu_torch.parallel.halo_train import HaloGAT, HaloRGCN

    n = data.num_nodes
    sd = {key: torch.from_numpy(v) for key, v in params.items()}
    if kind == "gat":
        plan, n_pad = halo.shard_fullgraph_boundary(*_gat_edges(data), n, 1)
        shard = halo.place(plan, 0, dev)
        w0, wl = sd["layers.0.w"], sd[f"layers.{len(heads) - 1}.w"]
        model = HaloGAT(w0.shape[0], w0.shape[1] // heads[0], wl.shape[1] // heads[-1], heads,
                        device=dev)
        model.load_state_dict(sd)
        x = torch.zeros(n_pad, w0.shape[0], device=dev)
        x[:n] = torch.from_numpy(np.asarray(data.features, np.float32)).to(dev)
        return model, (shard, x)
    plan, n_pad, leids, heids = halo.shard_fullgraph_boundary(
        np.asarray(data.src, np.int64), np.asarray(data.dst, np.int64), n, 1, return_eids=True)
    shard = halo.place(plan, 0, dev)
    w_loc, w_hal = halo.plan_layout_edata_boundary(plan, leids, heids,
                                                   np.asarray(data.edge_feat, np.float32))
    weights = shard.edge_weights(w_loc[0], w_hal[0])
    del w_loc, w_hal
    wr, wlast = sd["layers.0.w_rel"], sd[f"layers.{len(sd) // 3 - 1}.w_rel"]
    model = HaloRGCN(wr.shape[1], wr.shape[2], wlast.shape[2], wr.shape[0], len(sd) // 3,
                     device=dev)
    model.load_state_dict(sd)
    return model, (shard, torch.ones(n_pad, 1, device=dev), weights)


def _k1_halo(kind, data, params, dev, heads=None):
    """One card's forward of the same halo model (``_k1_halo_model``)."""
    model, args = _k1_halo_model(kind, data, params, dev, heads)
    with torch.no_grad():
        return model.eval()(*args)[:data.num_nodes]


def _node_inputs(data, dev):
    """x, the labels and the training rows (float) on ``dev``."""
    return (torch.from_numpy(np.asarray(data.features, np.float32)).to(dev),
            torch.from_numpy(np.asarray(data.labels, np.int64)).to(dev),
            torch.from_numpy(np.asarray(data.train_mask, bool)).to(dev).float())


def _masked_ce(logits, y, m):
    """The sharded train steps' loss on one card: the masked mean."""
    ce = torch.nn.functional.cross_entropy(logits, y, reduction="none")
    return (ce * m.to(ce.dtype)).sum() / m.sum().clamp(min=1.0).to(ce.dtype)


class _Mean64(torch.autograd.Function):
    """Float64 mean aggregation through torch.sparse.mm both ways (a plain
    reference that shares no code with K1): ``a`` the dst CSR weighted
    1/deg, ``at`` its transpose."""

    @staticmethod
    def forward(ctx, x, a, at):
        ctx.at = at
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g_out):
        return (torch.sparse.mm(ctx.at, g_out) if ctx.needs_input_grad[0] else None), None, None


def _mean64_operands(g):
    from dgl_tpu_torch.kernels.seg_sum import csr_rows

    inv = 1.0 / (g.indptr[1:] - g.indptr[:-1]).clamp(min=1).double()
    rev = g.reverse
    a = torch.sparse_csr_tensor(g.indptr.long(), g.src.long(), inv[csr_rows(g.indptr, g.num_edges)],
                                size=(g.num_dst_nodes, g.num_src_nodes), check_invariants=False)
    at = torch.sparse_csr_tensor(rev.indptr.long(), rev.src.long(), inv[rev.src.long()],
                                 size=(g.num_src_nodes, g.num_dst_nodes), check_invariants=False)
    return a, at


def _params64(params, dev):
    return {key: torch.from_numpy(v).to(dev).double().requires_grad_() for key, v in params.items()}


def sage_grads_f64(g, data, params, dev):
    """HaloSAGE's loss and gradients at ``params`` in float64 (plain
    PyTorch, _Mean64), on one card, rows in input order."""
    p = _params64(params, dev)
    x, y, m = _node_inputs(data, dev)
    a, at = _mean64_operands(g)
    h, layers = x.double(), len(p) // 3
    for i in range(layers):
        agg = _Mean64.apply(h, a, at)
        h = h @ p[f"layers.{i}.w_self"] + agg @ p[f"layers.{i}.w_neigh"] + p[f"layers.{i}.bias"]
        if i < layers - 1:
            h = torch.relu(h)
    loss = _masked_ce(h, y, m)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def sage_grads_one_card(g, data, params, dev):
    """GraphSAGE over K1 (the main path) at HaloSAGE's weights, dropout 0:
    the loss and its gradients under HaloSAGE's names and layouts."""
    from dgl_tpu_torch.models import GraphSAGE

    layers = len(params) // 3
    w0, wl = params["layers.0.w_self"], params[f"layers.{layers - 1}.w_self"]
    model = GraphSAGE(w0.shape[0], w0.shape[1], wl.shape[1], layers, dropout=0.0, device=dev)
    model.load_state_dict(_halo_sage_as_graphsage(params))
    x, y, m = _node_inputs(data, dev)
    loss = _masked_ce(model.eval()(g, x), y, m)
    loss.backward()
    grads = {}
    for i, conv in enumerate(model.convs):
        grads[f"layers.{i}.w_self"] = conv.fc_self.weight.grad.T
        grads[f"layers.{i}.w_neigh"] = conv.fc_neigh.weight.grad.T
        grads[f"layers.{i}.bias"] = conv.fc_neigh_bias.grad
    return float(loss.detach()), grads


def gat_grads_f64(src, dst, data, params, heads, dev, negative_slope=0.2):
    """HaloGAT's loss and gradients at ``params`` in float64 (plain
    PyTorch: index_add_ sums, the softmax shifted by each row's exact
    maximum), on one card, over the edges ``src``, ``dst`` (every row has
    a self-loop)."""
    p = _params64(params, dev)
    x, y, m = _node_inputs(data, dev)
    n = data.num_nodes
    src, dst = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    h = x.double()
    for i, nh in enumerate(heads):
        z = (h @ p[f"layers.{i}.w"]).reshape(n, nh, -1)
        a_src = (z * p[f"layers.{i}.attn_r"]).sum(-1)
        a_dst = (z * p[f"layers.{i}.attn_l"]).sum(-1)
        e = torch.nn.functional.leaky_relu(a_src[src] + a_dst[dst], negative_slope)
        shift = torch.full((n, nh), -math.inf, dtype=e.dtype, device=dev).scatter_reduce(
            0, dst.unsqueeze(1).expand(-1, nh), e.detach(), "amax")
        w = torch.exp(e - shift[dst])
        s = torch.zeros(n, nh, dtype=e.dtype, device=dev).index_add(0, dst, w)
        num = torch.zeros(n, nh, z.shape[2], dtype=e.dtype, device=dev).index_add(
            0, dst, w.unsqueeze(-1) * z[src])
        agg = num / s.unsqueeze(-1)
        h = torch.nn.functional.elu(agg.reshape(n, -1)) if i < len(heads) - 1 else agg.mean(1)
    loss = _masked_ce(h, y, m)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def gat_grads_one_card(data, params, heads, dev):
    """HaloGAT over a plan of one shard (K3, no exchange) at ``params``:
    the loss and its gradients."""
    model, args = _k1_halo_model("gat", data, params, dev, heads)
    x, y, m = _node_inputs(data, dev)
    loss = _masked_ce(model(*args)[:data.num_nodes], y, m)
    loss.backward()
    return float(loss.detach()), {name: p.grad for name, p in model.named_parameters()}


def dist_grads(what, ranks, one, want):
    """One sharded step's gradients, summed over the ranks (``ranks``: each
    rank's halo_grads), against one card's (``one``: loss, grads), each
    measured from a float64 run (``want``: loss, grads): the ranks'
    gradients bitwise equal; every entry g of the sharded gradient within
    DIST_GRAD_RTOL·|g64| + DIST_GRAD_ATOL·max|g64| + DIST_GRAD_NOISE·e1 of
    its tensor, e1 the largest distance of one card's gradient from the
    float64 run (the float32 rounding of this computation on the main
    path: a gradient whose rows cancel, as a_dst's do, keeps more of it);
    one card's within DIST_GRAD_RTOL·|g64| + DIST_GRAD_ONE_ATOL·max|g64|;
    both losses within 1e-5 relative of the float64 loss."""
    for r, o in enumerate(ranks[1:], 1):
        for key, v in o.items():
            if key.startswith("grad.") and not np.array_equal(v, ranks[0][key]):
                raise AssertionError(f"{what}: rank {r}'s summed {key} differs from rank 0's")
    loss64, want = want
    losses = {"sharded": float(ranks[0]["loss"]), "one_card": one[0]}
    res = {"loss_f64": loss64, **{f"loss_{k}": v for k, v in losses.items()}}
    bad = [f"{label} loss {v}, float64 {loss64}" for label, v in losses.items()
           if abs(v - loss64) > 1e-5 * abs(loss64)]
    used = 0.0
    for key, w in want.items():
        w = w.detach().cpu()
        g_s = torch.from_numpy(ranks[0][f"grad.{key}"]).double()
        g_1 = one[1][key].detach().cpu().double()
        err_s, err_1 = (g_s - w).abs(), (g_1 - w).abs()
        base = DIST_GRAD_RTOL * w.abs()
        tol_1 = base + DIST_GRAD_ONE_ATOL * w.abs().max()
        tol_s = base + DIST_GRAD_ATOL * w.abs().max() + DIST_GRAD_NOISE * err_1.max()
        for label, err, tol in (("sharded", err_s, tol_s), ("one card", err_1, tol_1)):
            if (err > tol).any():
                i = int((err - tol).argmax())
                bad.append(f"{label} gradient of {key} is {err.flatten()[i].item()} off the "
                           f"float64 run at entry {i}, tolerance {tol.flatten()[i].item()}")
        used = max(used, (err_s / tol_s.clamp(min=1e-300)).max().item())
        res[key] = {"sharded_max_abs_err_f64": err_s.max().item(),
                    "one_card_max_abs_err_f64": err_1.max().item(),
                    "sharded_vs_one_card": (g_s - g_1).abs().max().item(),
                    "max_abs_f64": w.abs().max().item()}
    res["max_tolerance_used"] = used
    if bad:
        print(json.dumps({"failed": what, **res}), file=sys.stderr, flush=True)
        raise AssertionError(f"{what}: " + "; ".join(bad))
    return res


def dist_plan_kernels(what, src, dst, n, dev, send_widths, rev_width=None, k3=None, seed=0):
    """Kernels against their plain versions and float64 sums (check) on
    rank 0's part of the drivers' plan of a graph (``lp`` relabel at
    seed 0, k = DIST_K), inputs around 1: K1 over the send graph's reverse
    CSR (the payloads' adjoint) at each of ``send_widths``; K1 over the
    bipartite graph's reverse CSR (the aggregation's backward) at
    ``rev_width``; with ``k3`` = (H, D) K3 forward and b2 on the
    bipartite graph."""
    from dgl_tpu_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain
    from dgl_tpu_torch.parallel import halo

    s, d, _ = halo.relabel(src, dst, n, DIST_K, seed)
    shard = halo.place(halo.shard_fullgraph_boundary(s, d, n, DIST_K)[0], 0, dev)
    del s, d
    gen = torch.Generator(device=dev).manual_seed(seed)
    res = {"rows": shard.nodes_per_shard, "slots": shard.send.num_edges,
           "edges": shard.graph.num_edges}

    def fields(errs):
        return dict(zip(("max_abs_err", "max_abs_err_f64", "max_bound_used"), errs))

    rev = shard.send.reverse
    for w in send_widths:
        cot = 1.0 + torch.randn(shard.send.num_edges, w, device=dev, generator=gen)
        got = csr_spmm(rev.indptr, rev.eid, cot, split=rev.split)
        res[f"send_adjoint_d{w}"] = fields(check(
            f"{what} send adjoint D={w}", got, rev.indptr, reference64(rev.indptr, rev.eid, cot),
            plain=csr_spmm_plain(rev.indptr, rev.eid, cot)))
    g = shard.graph
    if rev_width:
        grev = g.reverse
        cot = 1.0 + torch.randn(g.num_dst_nodes, rev_width, device=dev, generator=gen)
        got = csr_spmm(grev.indptr, grev.src, cot, split=grev.split)
        ref = reference64_sparse(grev.indptr, grev.src, cot, g.num_dst_nodes, mean=False)
        res[f"bipartite_reverse_d{rev_width}"] = fields(check(
            f"{what} bipartite reverse D={rev_width}", got, grev.indptr, ref,
            plain=csr_spmm_plain(grev.indptr, grev.src, cot)))
        del got, ref, cot
    if k3:
        h, dd = k3
        v, g_out = (1.0 + torch.randn(m, h, dd, device=dev, generator=gen)
                    for m in (g.num_src_nodes, g.num_dst_nodes))
        a_s = torch.randn(g.num_src_nodes, h, device=dev, generator=gen)
        a_d = torch.randn(g.num_dst_nodes, h, device=dev, generator=gen)
        kw, acc_f, acc_b = dict(negative_slope=0.2), [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
        out, _, inv_s, _, shift = check_k3_fwd(f"{what} bipartite", g, v, a_s, a_d, kw, acc_f)
        node = torch.stack([a_d, shift, inv_s, (g_out * out).sum(-1)], -1)
        check_k3_bwd(f"{what} bipartite", g, g_out, node, a_s, v, kw, acc_b)
        res[f"k3_fwd_h{h}_d{dd}"], res[f"k3_b2_h{h}_d{dd}"] = fields(acc_f), fields(acc_b)
    return res


def _spmd_inputs(data, seed, d=16):
    gen = np.random.default_rng(seed)
    return {"dataset": "reddit", "x": gen.normal(1.0, 1.0, (data.num_nodes, d)).astype(np.float32),
            "cot": gen.normal(1.0, 1.0, (data.num_nodes, d)).astype(np.float32)}


def dist_spmd(g, ranks, inputs, dev):
    """reddit's edges split across the ranks: ``sharded_gspmm`` mean,
    all-reduced, against one card's K1 and float64 sums (``check``); the
    replicated output and gradient equal on both ranks; K1 forward and
    backward once each on every rank."""
    from dgl_tpu_torch.ops import gspmm

    for o in ranks[1:]:
        if not (np.array_equal(o["out"], ranks[0]["out"])
                and np.array_equal(o["grad"], ranks[0]["grad"])):
            raise AssertionError("spmd: the replicated output or gradient differs across ranks")
    xt = torch.from_numpy(inputs["x"]).to(dev)
    one = gspmm(g, "copy_u", "mean", x=xt)
    got = torch.from_numpy(ranks[0]["out"]).to(dev)
    err, err64, used = check("spmd mean", got, g.indptr, reference64(g.indptr, g.src, xt, mean=True),
                             plain=one)
    launches = [int(o["launches"]) for o in ranks]
    for r, n in enumerate(launches):
        _expect_launches(f"spmd rank {r}", {"csr_spmm": n}, {"csr_spmm": 2}, 1)
    return {"launches": launches, "max_abs_err": err, "max_abs_err_f64": err64,
            "max_bound_used": used, "grad_finite": bool(np.isfinite(ranks[0]["grad"]).all())}


def _dp_inputs(data, seed, lr=0.1):
    import json

    from dgl_tpu_torch.models import GraphSAGE

    model = GraphSAGE(data.features.shape[1], 16, data.num_classes, 2, dropout=0.0,
                      device="cpu", generator=torch.Generator().manual_seed(seed))
    inputs = {f"sage.{k}": v.numpy() for k, v in model.state_dict().items()}
    for r in range(DIST_K):
        rng = np.random.default_rng(seed + r)
        inputs[f"seeds_{r}"] = rng.choice(data.num_nodes, DIST_DP_BATCH, replace=False)
        inputs[f"rng_{r}"] = np.array(json.dumps(rng.bit_generator.state))
    return {"dataset": "reddit", "fanouts": np.array(DIST_DP_FANOUTS), "b_pad": DIST_DP_BATCH,
            "k": DIST_K, "lr": lr, **inputs}


def dist_dp(ranks, inputs):
    """Two ranks, each its own ns_sage minibatch on reddit (P1 in index
    order gathers its features), one SGD step of GraphSAGE (602, 16, 41):
    the mean loss of the ranks' own losses, the new parameters bitwise
    equal on both ranks and equal to the weights less lr times the mean of
    the two single-rank gradients."""
    lr = float(inputs["lr"])
    mean_loss = sum(float(o["own_loss"]) for o in ranks) / DIST_K
    if abs(float(ranks[0]["loss"]) - mean_loss) > 1e-6 * abs(mean_loss):
        raise AssertionError(f"dp: loss {float(ranks[0]['loss'])} is not the ranks' mean {mean_loss}")
    err = 0.0
    for key in (k[len("sage."):] for k in inputs if k.startswith("sage.")):
        for o in ranks[1:]:
            if not np.array_equal(o[f"sage.{key}"], ranks[0][f"sage.{key}"]):
                raise AssertionError(f"dp: rank parameters differ: {key}")
        want = inputs[f"sage.{key}"] - lr * sum(o[f"grad.{key}"] for o in ranks) / DIST_K
        err = max(err, float(np.abs(ranks[0][f"sage.{key}"] - want).max()))
        if not np.allclose(ranks[0][f"sage.{key}"], want, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"dp: {key} is not the step of the mean gradient")
    return {"loss": float(ranks[0]["loss"]), "own_losses": [float(o["own_loss"]) for o in ranks],
            "max_abs_err": err}


def _grad_inputs(kind, data, seed):
    """halo_grads' inputs: the driver's model on ``data`` (reddit SAGE or
    arxiv GAT) at weights from ``seed``."""
    from dgl_tpu_torch.benchmarks.node_classification import main_gat, main_sage
    from dgl_tpu_torch.parallel.halo_train import HaloGAT, HaloSAGE

    gen, d_in = torch.Generator().manual_seed(seed), data.features.shape[1]
    if kind == "sage":
        cfg = main_sage.DATASET_CFG["reddit"]
        model = HaloSAGE(d_in, cfg["hidden"], data.num_classes, cfg["layers"], generator=gen,
                         device="cpu")
        extra = {"dataset": "reddit"}
    else:
        cfg = main_gat.DATASET_CFG["ogbn-arxiv"]
        model = HaloGAT(d_in, cfg["hidden"], data.num_classes, cfg["heads"], generator=gen,
                        device="cpu")
        extra = {"dataset": "ogbn-arxiv", "heads": np.array(cfg["heads"])}
    return {"kind": kind, "bidirect": cfg["bidirect"], **extra,
            **{f"p.{k}": v.numpy() for k, v in model.state_dict().items()}}


def dist_rank_checks(tmp, reddit, arxiv, seed=0, device="cuda"):
    """One start of the DIST_K ranks (checks.in_turn) for the ranks' side
    of five checks: halo_grads of reddit SAGE, the exchange alone on
    reddit's plan at layer 1's width and the hidden width, spmd_gspmm and
    dp_step on reddit, halo_grads of arxiv GAT. Returns each check's
    per-rank results, its inputs and the seconds."""
    from dgl_tpu_torch.benchmarks.node_classification.main_sage import DATASET_CFG
    from dgl_tpu_torch.parallel import checks, launch

    hidden = DATASET_CFG["reddit"]["hidden"]
    inputs = {"sage_grads": _grad_inputs("sage", reddit, seed),
              "exchange": {"dataset": "reddit", "reps": 5,
                           "widths": np.array((reddit.features.shape[1], hidden))},
              "spmd": _spmd_inputs(reddit, seed), "dp": _dp_inputs(reddit, seed),
              "gat_grads": _grad_inputs("gat", arxiv, seed)}
    fns = {"sage_grads": "halo_grads", "exchange": "exchange_times", "spmd": "spmd_gspmm",
           "dp": "dp_step", "gat_grads": "halo_grads"}
    calls = []
    for key, a in inputs.items():
        path = os.path.join(tmp, f"{key}.npz")
        np.savez(path, **a)
        calls.append((key, fns[key], path))
    t0 = time.perf_counter()
    out = launch.spawn(checks.in_turn, DIST_K, (calls,), backend="gloo", device=device,
                       timeout=DIST_TIMEOUT)
    return {key: [o[key] for o in out] for key in inputs}, inputs, time.perf_counter() - t0


def dist_checkpoint_check(tmp_dir, dev):
    """main_sage on reddit on one card: 6 epochs straight against 3, then a
    resume of 3 from --ckpt-dir (every epoch saved): the losses equal bit
    for bit (K1 is deterministic)."""
    from dgl_tpu_torch.benchmarks.node_classification import main_sage

    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        straight = main_sage.run("reddit", epochs=6, device=dev)["losses"][0]
        first = main_sage.run("reddit", epochs=3, device=dev, ckpt_dir=tmp_dir,
                              ckpt_every=1)["losses"][0]
        resumed = main_sage.run("reddit", epochs=6, device=dev, ckpt_dir=tmp_dir,
                                ckpt_every=1)["losses"][0]
    if "resumed from checkpoint at epoch 3" not in log.getvalue():
        raise AssertionError("checkpoint: the second run did not resume at epoch 3")
    got = first + resumed
    if got != straight:
        raise AssertionError(f"checkpoint: 3 + 3 epochs {got} differ from 6 {straight}")
    return {"straight": straight, "three_plus_three": got, "bitwise": True}


def phase_distributed(device="cuda"):
    """Sharded SAGE, GAT and RGCN through the drivers' --shard on DIST_K
    ranks sharing the card, one step's gradients, spmd, dp, the kernels at
    the plans' shapes and a checkpoint resume (``device`` "cpu": a
    rehearsal on the plain versions, which launch nothing)."""
    import tempfile

    from dgl_tpu_torch import from_edges
    from dgl_tpu_torch.benchmarks.node_classification import main_gat, main_rgcn, main_sage
    from dgl_tpu_torch.data import load_node_dataset
    from dgl_tpu_torch.models import GraphSAGE

    print(f"distributed: {DIST_K} ranks share cuda:0 over gloo; their collectives stage through "
          "host memory, so these times measure no multi-GPU speed", flush=True)
    t_phase, dev, out = time.perf_counter(), torch.device(device), {}
    log = io.StringIO()

    # reddit SAGE at full size and width (602 -> 16 -> 41), the driver's run
    _, ds, epochs = DIST_RUNS["sage"]
    with contextlib.redirect_stdout(log):
        res = main_sage.run_sharded(ds, DIST_K, dist_backend="gloo", epochs=epochs, device=device)
    cfg = main_sage.DATASET_CFG[ds]
    out["sage"] = _dist_run("sage", res, halo_sage_launches(DIST_SAGE_LAYERS), epochs)
    g, data = _sage_graph(ds, dev)
    model = GraphSAGE(data.features.shape[1], cfg["hidden"], data.num_classes, cfg["layers"],
                      device=dev)
    model.load_state_dict(_halo_sage_as_graphsage(res["params"][0]))
    with torch.no_grad():
        want = model.eval()(g, torch.from_numpy(np.asarray(data.features, np.float32)).to(dev))
    out["sage"]["forward_max_abs_err"] = _dist_forward_check("sharded sage", res["logits"], want)
    del g, model, want, res, data
    torch.cuda.empty_cache()

    # arxiv GAT (bidirected, self-loops, heads 4, 4, 4), the driver's run
    _, ds, epochs = DIST_RUNS["gat"]
    with contextlib.redirect_stdout(log):
        res = main_gat.run_sharded(ds, DIST_K, dist_backend="gloo", epochs=epochs, device=device)
    heads = main_gat.DATASET_CFG[ds]["heads"]
    out["gat"] = _dist_run("gat", res, halo_gat_launches(DIST_GAT_LAYERS), epochs)
    want = _k1_halo("gat", load_node_dataset(ds), res["params"][0], dev, heads)
    out["gat"]["forward_max_abs_err"] = _dist_forward_check("sharded gat", res["logits"], want)
    del want, res
    torch.cuda.empty_cache()

    # proteins RGCN at the driver's defaults (3 layers, hidden 32)
    _, ds, epochs = DIST_RUNS["rgcn"]
    with contextlib.redirect_stdout(log):
        res = main_rgcn.run_sharded(DIST_K, dist_backend="gloo", epochs=epochs, runs=1,
                                    device=device)
    data = load_node_dataset(ds)
    out["rgcn"] = _dist_run("rgcn", res, halo_rgcn_launches(DIST_RGCN_LAYERS,
                                                             data.edge_feat.shape[1]), epochs)
    want = _k1_halo("rgcn", data, res["params"][0], dev)
    out["rgcn"]["forward_max_abs_err"] = _dist_forward_check("sharded rgcn", res["logits"], want)
    del want, res, data
    torch.cuda.empty_cache()

    # one start of the ranks for the rank checks, then each held on one card
    reddit, arxiv = load_node_dataset("reddit"), load_node_dataset("ogbn-arxiv")
    with tempfile.TemporaryDirectory() as tmp:
        ranks, inputs, out["rank_checks_s"] = dist_rank_checks(tmp, reddit, arxiv, device=device)
    out["sage"]["exchange"] = {key: [float(o[key]) for o in ranks["exchange"]]
                               for key in ranks["exchange"][0]}
    params = {k[2:]: v for k, v in inputs["sage_grads"].items() if k.startswith("p.")}
    g = from_edges(reddit.src, reddit.dst, reddit.num_nodes, device=dev)  # reddit: not bidirected
    out["sage"]["grads"] = dist_grads("sharded sage", ranks["sage_grads"],
                                      sage_grads_one_card(g, reddit, params, dev),
                                      sage_grads_f64(g, reddit, params, dev))
    out["spmd"] = dist_spmd(g, ranks["spmd"], inputs["spmd"], dev)
    out["dp"] = dist_dp(ranks["dp"], inputs["dp"])
    del g
    torch.cuda.empty_cache()
    hidden = main_sage.DATASET_CFG["reddit"]["hidden"]
    out["sage"]["plan_kernels"] = dist_plan_kernels(
        "reddit plan", np.asarray(reddit.src, np.int64), np.asarray(reddit.dst, np.int64),
        reddit.num_nodes, dev, send_widths=(hidden,), rev_width=hidden)
    del reddit
    torch.cuda.empty_cache()
    params = {k[2:]: v for k, v in inputs["gat_grads"].items() if k.startswith("p.")}
    gcfg = main_gat.DATASET_CFG["ogbn-arxiv"]
    src, dst = _gat_edges(arxiv)
    out["gat"]["grads"] = dist_grads(
        "sharded gat", ranks["gat_grads"], gat_grads_one_card(arxiv, params, heads, dev),
        gat_grads_f64(src, dst, arxiv, params, heads, dev))
    torch.cuda.empty_cache()
    widths = sorted({h * d for h, d in zip(gcfg["heads"], (gcfg["hidden"],) * (
        len(gcfg["heads"]) - 1) + (arxiv.num_classes,))})  # the payloads: z's rows
    out["gat"]["plan_kernels"] = dist_plan_kernels(
        "arxiv plan", src, dst, arxiv.num_nodes, dev, send_widths=widths,
        k3=(gcfg["heads"][0], gcfg["hidden"]))
    for kind, layers in (("sage", DIST_SAGE_LAYERS), ("gat", DIST_GAT_LAYERS)):
        per_step = (halo_sage_launches if kind == "sage" else halo_gat_launches)(layers)
        for r, o in enumerate(ranks[f"{kind}_grads"]):
            _expect_launches(f"{kind} gradient step rank {r}",
                             {"send_adjoint": int(o["send_adjoint"])}, per_step, 1)
        out[kind]["grads"]["send_adjoint"] = [int(o["send_adjoint"]) for o in ranks[f"{kind}_grads"]]
    del arxiv, src, dst
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        out["checkpoint"] = dist_checkpoint_check(tmp, dev)
    emit("distributed", seconds=time.perf_counter() - t_phase, ranks=DIST_K, backend="gloo",
         shared_card=True, **out,
         plan_lines=[ln for ln in log.getvalue().splitlines() if ln.startswith("shard plan:")])
    return out


# -- the suite harness on the card ------------------------------------------

# the smoke rows in groups that run side by side, each group's rows one
# process at a time (~20 s a process on the card's host); no two groups
# generate the same synthetic dataset (its cache file is written in place)
SUITE_GROUPS = (("reddit_sage", "reddit_gat", "ns_sage_reddit", "ns_gat_reddit"),
                ("pubmed_gat", "molhiv_gcn", "molhiv_gcn_scatter"),
                ("proteins_rgcn", "gcmc_ml100k", "cluster_sage_products", "cluster_lp_arxiv"))
SUITE_SMOKE = sum(SUITE_GROUPS, ())
SUITE_PROFILED = {  # row: the kernels its profile must name (reddit_gat fused: K3)
    "reddit_sage": ("csr_spmm_kernel",),
    "reddit_gat": ("gat_fwd_kernel", "gat_b2_kernel"),
    "pubmed_gat": ("seg_sum_kernel", "row_gather_by_source_kernel"),
    "ns_sage_reddit": ("row_gather_async_kernel",),
}
SUITE_PROFILE = 3  # --profile: epochs, or steps of the sampling drivers
SUITE_FULL = ("reddit_sage",)  # a fourth group, beside the smoke groups
SUITE_TIMEOUT_S = 300  # a row's limit
# rows whose drivers print no line the harness reads a test score from (the
# NS drivers' "Test Acc:"), as in the JAX harness
SUITE_NO_FINAL_TEST = ("ns_sage_reddit", "ns_gat_reddit")
# smoke rows whose epochs are all warm-up: cluster LP's 3 (the JAX smoke
# row's --n-epochs 3; the driver times from the fourth), so no epoch time
SUITE_UNTIMED = ("cluster_lp_arxiv",)


def _suite_run(generate_result, out, suite, names, device, profile=0):
    rows = generate_result.main(["--suite", suite, "--only", ",".join(names), "--out", out,
                                 "--retries", "0", "--timeout", str(SUITE_TIMEOUT_S),
                                 "--device", device, "--profile", str(profile)])
    for r in rows:
        if r["status"] != "ok":
            raise AssertionError(f"suite {suite} row {r['workload']}: {r['status']}\n"
                                 f"{r.get('stderr_tail')}")
    if not os.path.exists(os.path.join(out, "results.json")):
        raise AssertionError(f"suite {suite}: no results.json")
    return rows


def check_suite_row(row, baselines, untimed=()):
    """One row of the harness: ok, an epoch time finite and positive (none
    for a row of ``untimed``), a test score where its driver prints one, the
    V100 ratio where there is a baseline."""
    name, t = row["workload"], row.get("time_per_epoch")
    if name in untimed:
        if t is not None:
            raise AssertionError(f"suite row {name}: timed {t} in its warm-up epochs")
    elif not (t is not None and math.isfinite(t) and t > 0):
        raise AssertionError(f"suite row {name}: time_per_epoch {t}")
    if name not in SUITE_NO_FINAL_TEST and row.get("final_test") is None:
        raise AssertionError(f"suite row {name}: no final test score")
    if (name in baselines) != (row.get("vs_dgl_v100") is not None):
        raise AssertionError(f"suite row {name}: vs_dgl_v100 {row.get('vs_dgl_v100')}")


def _suite_group(generate_result, out, names, device):
    """A smoke group: its SUITE_PROFILED rows with --profile, then the rest."""
    profiled = [w for w in names if w in SUITE_PROFILED]
    rest = [w for w in names if w not in SUITE_PROFILED]
    rows = []
    if profiled:
        rows += _suite_run(generate_result, out + "_profiled", "smoke", profiled, device,
                           SUITE_PROFILE)
    if rest:
        rows += _suite_run(generate_result, out, "smoke", rest, device)
    return rows


def phase_suite(device="cuda"):
    """SUITE_GROUPS through the harness side by side (SUITE_PROFILED with
    the drivers' --profile), SUITE_FULL at the full arguments beside them;
    every row held by check_suite_row, the profiled rows' kernels named
    (``device`` "cpu": a rehearsal, whose profiles name no kernel)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from dgl_tpu_torch.benchmarks import generate_result

    if device == "cuda":
        torch.cuda.empty_cache()  # this process keeps its memory while the rows run
    t_phase = time.perf_counter()
    log = io.StringIO()  # the harness's lines; a failed row raises with its stderr
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(log), \
            ThreadPoolExecutor(len(SUITE_GROUPS) + 1) as pool:
        groups = [pool.submit(_suite_group, generate_result, os.path.join(tmp, f"group{i}"),
                              names, device) for i, names in enumerate(SUITE_GROUPS)]
        full = pool.submit(_suite_run, generate_result, os.path.join(tmp, "full"), "full",
                           SUITE_FULL, device)
        rows = [r for g in groups for r in g.result()]
        full = full.result()
    if sorted(r["workload"] for r in rows) != sorted(SUITE_SMOKE):
        raise AssertionError(f"suite rows {[r['workload'] for r in rows]}")
    for r in rows:
        check_suite_row(r, generate_result.BASELINE_EPOCH_S, SUITE_UNTIMED)
    for r in full:
        check_suite_row(r, generate_result.BASELINE_EPOCH_S)
    named = {}
    for r in rows:
        if r["workload"] not in SUITE_PROFILED:
            continue
        names = [k["name"] for k in (r.get("profile") or {}).get("kernels", [])]
        missing = [k for k in SUITE_PROFILED[r["workload"]] if not any(k in n for n in names)]
        if missing and device == "cuda":
            raise AssertionError(f"suite row {r['workload']}: its profile names no {missing}: "
                                 f"{names}")
        named[r["workload"]] = {k: sorted({re.search(rf"{k}(<[^>]*>)?", n).group(0)
                                          for n in names if k in n})
                                for k in SUITE_PROFILED[r["workload"]]}
    keep = ("status", "time_per_epoch", "vs_dgl_v100", "final_train", "final_test",
            "samples_per_s", "wall_s")
    emit("suite", seconds=time.perf_counter() - t_phase,
         smoke={r["workload"]: {k: r.get(k) for k in keep} for r in rows},
         full={r["workload"]: {k: r.get(k) for k in keep + ("note",)} for r in full},
         profiled_kernels=named,
         profiles={r["workload"]: {k: r["profile"][k] for k in r["profile"]
                                   if k.startswith(("wall_ms", "device_busy", "device_idle"))}
                   for r in rows if r.get("profile")})
    return rows, full


def _host_device_fields(suffix, r, lib_key="library_host_device"):
    """A timed shape's host and device ms a call (host_and_device), the
    kernel's and its library call's, as kernels-line fields."""
    out = {f"host_ms_{suffix}": r["host_device"]["host_ms_a_call"],
           f"device_ms_{suffix}": r["host_device"]["device_ms_a_call"]}
    if r.get(lib_key):
        out |= {f"library_host_ms_{suffix}": r[lib_key]["host_ms_a_call"],
                f"library_device_ms_{suffix}": r[lib_key]["device_ms_a_call"]}
    return out


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
    launches = phase_main()
    phase_gat_random()
    gred, gred_arxiv, gred_arxiv40, gat_graph, gatconv_bf16 = phase_gat_reddit()
    floors, rows = phase_row_gather(red, red_graph, gred, gat_graph)
    del gat_graph
    glaunch, gcombines = phase_gat_main()
    slaunch, widths, slaunch_bf16 = phase_sage_main()
    claunch, ccombines, readout, gc_k1 = phase_gc_main()
    rk1, rlaunch, prot_graph = phase_rgcn_main()
    torch.cuda.empty_cache()
    gcmc = phase_gcmc_main()
    phase_kernel_sweep({"reddit": red_graph, "ogbn-arxiv": _raw_graph("ogbn-arxiv"),
                        "ogbn-proteins": prot_graph})
    del red_graph, prot_graph
    torch.cuda.empty_cache()
    nlaunch, ns_p1, ns_k3 = phase_ns_main()
    torch.cuda.empty_cache()
    cl_launch, cl_batch, cl_k3 = phase_cluster_main()
    torch.cuda.empty_cache()
    dist = phase_distributed()
    phase_suite()
    # rank 0's launches in each sharded run (every rank's equal the derivations)
    dl = {kind: dist[kind]["launches"][0] for kind in ("sage", "gat", "rgcn")}
    rows["row_gather_async"].update(
        **{f"launches_cluster_{k}": v["row_gather_async"] for k, v in cl_launch.items()},
        **{f"{f}_cluster_batch": cl_batch["p1"][f] for f in ("ms", "plain_ms", "library_ms",
                                                              "bound_ms", "max_abs_err", "rows")})
    rows["row_gather_by_source"]["launches_cluster_lp"] = cl_launch["lp"]["row_gather_by_source"]
    # the exchange's payload gathers on rank 0 over the three sharded runs
    rows["row_gather_by_source"]["launches_halo_payload"] = sum(
        v["row_gather_by_source"] for v in dl.values())
    cluster_k3 = {name: {f"{f}_cluster_{shape}": cl_batch[f"k3_{shape}"][name][f]
                         for shape in ("h4_d64", "h1_d47")
                         for f in ("ms", "plain_ms", "bound_ms", "max_abs_err", "max_abs_err_f64",
                                   "max_bound_used")}
                  for name in ("gat_attention_fwd", "gat_attention_bwd")}
    rows["row_gather_async"].update(
        **{f"launches_ns_{k}": nlaunch[k]["row_gather_async"] for k in nlaunch},
        **{f"{f}_ns_step": ns_p1[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                "max_abs_err", "rows", "distinct_rows")},
        **_host_device_fields("ns_step", ns_p1), **_host_device_fields("cluster_batch", cl_batch["p1"]))
    # GCMC: K1 at D = 100 on the training relation with the most ratings,
    # each way, and the decoder's gather_src_rows adjoint at D = 75; P1 in
    # source order on the decoder's two gathers; K2 at W = 75
    gk1 = gcmc["k1"]
    top = max((k[:-4] for k in gk1 if k.endswith("_fwd") and not k.startswith("rev-")),
              key=lambda rel: gk1[f"{rel}_fwd"]["edges"])
    gcmc_k1 = {"gcmc_relation": top,
               **{f"{k}_gcmc_d100_{side}": gk1[f"{top}_{side}"][k] for side in ("fwd", "bwd")
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
               **{f"{k}_gcmc_dec_d75_adjoint": gk1["dec_adjoint"][k]
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}}
    rows["row_gather_by_source"].update(
        launches_gcmc=gcmc["launches"]["row_gather_by_source"],
        **{f"{k}_gcmc_{side}": gcmc["p1"][side][k] for side in ("src", "dst")
           for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
        **_host_device_fields("gcmc_src", gcmc["p1"]["src"]),
        **_host_device_fields("gcmc_dst", gcmc["p1"]["dst"]))
    rows["row_gather_by_source"].update(
        launches_pubmed_gat=glaunch["pubmed"]["row_gather_by_source"],
        **{f"launches_gcn_{k}": v["row_gather_by_source"] for k, v in claunch.items()})
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
            # the row split (each launch folds its long rows): T, and the
            # long rows and chunks of reddit's reverse CSR
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
            # gsddmm(copy_u) adjoints)
            **{f"launches_sage_{k}{m}": slaunch[(ds, mode)] for k, ds in sage_keys.items()
               for mode, m in (("unhoisted", ""), ("hoisted", "_hoisted"), ("scatter", "_scatter"))
               if (ds, mode) in slaunch},
            **{f"launches_gcn_{k}": v["csr_spmm"] for k, v in claunch.items()},
            # the RGCN run on full proteins (40 a step: 8 relations, layer 1
            # forward at D = 1, layers 2 and 3 each way at D = 32), and the
            # weighted launches at every (CSR, width) the run launches: fwd
            # the dst CSR (mean), bwd the reverse CSR (sum)
            "launches_rgcn": rlaunch,
            # the NS runs: only their evaluations launch K1 (ns_sage: 2 a
            # full-graph forward at D = 16), none in a step
            **{f"launches_ns_{k}": v["csr_spmm"] for k, v in nlaunch.items()},
            # the cluster runs (SAGE on products: 5 a step; LP on arxiv: 7 a
            # step, the encoder's and u_dot_v's two adjoints), and K1 at D =
            # 100 and 256 on one products cluster batch each way
            "launches_cluster_sage": cl_launch["sage"]["csr_spmm"],
            "launches_cluster_lp": cl_launch["lp"]["csr_spmm"],
            **{f"{k}_cluster_d{d}_{side}": cl_batch["k1"][d][side][k]
               for d in cl_batch["k1"] for side in ("fwd", "bwd")
               for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
            # the sharded runs on two ranks sharing the card (rank 0; per
            # step: halo_sage_launches, halo_rgcn_launches), the spmd check
            # (forward and backward a rank) and the payloads' adjoints over
            # the send graphs in the three sharded runs, as the exchange
            # counted them on rank 0 (exchange.send_adjoint_launches)
            "launches_halo_sage": dl["sage"]["csr_spmm"],
            "launches_halo_rgcn": dl["rgcn"]["csr_spmm"],
            "launches_spmd": dist["spmd"]["launches"][0],
            "launches_send_adjoint": sum(v["send_adjoint"] for v in dl.values()),
            # the GCMC run on ml-100k (22 a training iteration: the 10
            # relations each way and the decoder's 2 adjoints; 10 an
            # evaluation) and K1 at its shapes
            "launches_gcmc": gcmc["launches"]["csr_spmm"],
            **gcmc_k1,
            **{f"{k}_proteins_{shape.split('_')[1]}_weighted_{shape.split('_')[0]}": r[k]
               for shape, r in rk1.items()
               for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")},
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
                        max_abs_err_arxiv_d40=gred_arxiv40[name]["max_abs_err"],
                        **extra)
          for name, p, extra in (
              # the NS runs (ns_gat's evaluations: H = 8, D = 16, then
              # H = 1, D = 41) and the forward at both shapes on reddit as given
              ("gat_attention_fwd", "fwd", {
                  "launches_halo_gat": dl["gat"]["gat_attention_fwd"],
                  **{f"launches_ns_{k}": v["gat_attention_fwd"] for k, v in nlaunch.items()},
                  # cluster GAT (3 a step and 3 an evaluation), the batch's
                  # shapes, and the whole products graph at H = 4, D = 64
                  "launches_cluster_gat": cl_launch["gat"]["gat_attention_fwd"],
                  **cluster_k3["gat_attention_fwd"],
                  **{f"{f}_products_h4_d64": cl_k3[f] for f in ("ms", "plain_ms", "bound_ms",
                                                                 "max_abs_err_f64",
                                                                 "max_bound_used")},
                  **{f"{f}_{key}": ns_k3[key][f] for key in ("h8", "h1_d41")
                     for f in ("ms", "plain_ms", "bound_ms", "max_abs_err", "max_abs_err_f64",
                               "max_bound_used")}}),
              ("gat_attention_bwd", "b2", {"launches_halo_gat": dl["gat"]["gat_attention_bwd"],
                                           "gather_floor_ms": floors["k3_b2"]["gather_floor_ms"],
                                           "t_sweep": gred["gat_attention_bwd"]["t_sweep"],
                                           "launches_cluster_gat":
                                               cl_launch["gat"]["gat_attention_bwd"],
                                           **cluster_k3["gat_attention_bwd"]}))),
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
            # cluster LP: u_dot_v's gather_dst adjoints, 2 a step
            "launches_cluster_lp": cl_launch["lp"]["seg_sum"],
            # GCMC: the decoder's gather_dst adjoints, 2 an iteration, and
            # K2 at W = 75 on the decoder's dst CSR
            "launches_gcmc": gcmc["launches"]["seg_sum"],
            "combines_gcmc": gcmc["combines"]["seg_sum"],
            **{f"{k}_gcmc_d75": gcmc["k2"][k] for k in ("ms", "plain_ms", "library_ms",
                                                       "index_add_ms", "bound_ms", "max_abs_err")},
            **{f"combines_gcn_{k}": v["seg_sum"] for k, v in ccombines.items()},
            # the mean and sum readouts and gspmm(copy_e, sum) on a molhiv
            # batch at D = 256
            "max_abs_err_readout": readout["max_abs_err"],
            "max_abs_err_f64_readout": readout["max_abs_err_f64"],
            "max_abs_err_copy_e": readout["copy_e_max_abs_err"],
            "max_abs_err_f64_copy_e": readout["copy_e_max_abs_err_f64"],
            **{f"{k}_{shape}": t[k] for shape, t in readout["k2_times"].items()
               for k in ("ms", "plain_ms", "index_add_ms", "bound_ms")},
            # each call's host and device time, the kernel's and the library call's
            **{k: v for shape, t in readout["k2_times"].items()
               for k, v in _host_device_fields(shape, t, "index_add_host_device").items()},
            **_host_device_fields("gcmc_d75", gcmc["k2"], "index_add_host_device"),
            **_host_device_fields("fwd", k2f), **_host_device_fields("rev", k2r),
        },
        # P1 in both orders at the probe's default shape, launches from the
        # probe's default run (in source order also its launches on the
        # pubmed GAT and GCN runs, and its times on reddit's and pubmed's
        # src streams); P2 where x fits, launches from the probe's run at
        # (2708, 16)
        *({"name": name, "route": "cuda", "source": "dgl_tpu_torch/kernels/csrc/row_gather.cu",
           "replaces": replaces, **rows[name]}
          for name, replaces in (("row_gather_async", "tools/exp_dma_gather.py:34"),
                                 ("row_gather_by_source", "tools/exp_dma_gather.py:34"),
                                 ("row_gather_smem", "tools/exp_dma_gather.py:72"))),
        # bf16 messages: K1's bfloat16 instantiation, launched by products
        # SAGE with --bf16-messages (its forward's three a step); times at
        # reddit's D = 16 forward (mean, dst CSR), the reverse CSR and
        # products' widths beside them, each with the float32 one's time in
        # the same turns
        _kernel_entry(
            "csr_spmm_bf16", "dgl_tpu_torch/kernels/csrc/csr_spmm.cu",
            "dgl_tpu/kernels/lane_spmm.py:418", slaunch_bf16[("ogbn-products", "bf16")],
            red["fwd"]["bf16"], library_note=red["fwd"]["bf16"]["library_note"],
            ms_f32_in_turns=red["fwd"]["bf16"]["ms_f32_in_turns"],
            launches_all_products_bf16=slaunch[("ogbn-products", "bf16")],
            **{f"{k}_rev": red["bwd"]["bf16"][k] for k in ("ms", "ms_f32_in_turns", "plain_ms",
                                                          "library_ms", "bound_ms", "max_abs_err")},
            **{f"{k}_products_d{d}_{side}": widths["ogbn-products"][d][f"{side}_bf16"][k]
               for d in widths["ogbn-products"] for side in ("fwd", "bwd")
               for k in ("ms", "ms_f32_in_turns", "library_ms", "bound_ms", "max_abs_err")}),
        # K2's bfloat16 instantiation: the copy_e sum of GATConv's edge form
        # under edge_dtype (launches: the bf16 GATConv step on pubmed), timed
        # at (E, 16) on reddit with self-loops over the dst CSR
        _kernel_entry(
            "seg_sum_bf16", "dgl_tpu_torch/kernels/csrc/seg_sum.cu",
            "dgl_tpu/kernels/piece_reduce.py:54", gatconv_bf16["edge"]["launches_bf16"]["seg_sum"],
            gred["seg_sum_bf16"], library_note=gred["seg_sum_bf16"]["library_note"],
            ms_f32_in_turns=gred["seg_sum_bf16"]["ms_f32_in_turns"],
            gatconv_edge_out_rel_err=gatconv_bf16["edge"]["out_rel_err"],
            **_host_device_fields("fwd", gred["seg_sum_bf16"])),
        # K3's bfloat16 passes (v in bfloat16; b2's grad_v in bfloat16):
        # launches from the bf16 fused GATConv step on pubmed; times on
        # reddit with self-loops (H = 1, D = 16) and at arxiv's shapes
        *(_kernel_entry(
            f"{name}_bf16", "dgl_tpu_torch/kernels/csrc/gat_attention.cu",
            "dgl_tpu/kernels/lane_attention.py:234",
            gatconv_bf16["fused"]["launches_bf16"][name], gred[f"{name}_bf16"], **{"pass": p},
            ms_f32_in_turns=gred[f"{name}_bf16"]["ms_f32_in_turns"],
            gatconv_fused_out_rel_err=gatconv_bf16["fused"]["out_rel_err"],
            **{f"{k}_{key}": r[f"{name}_bf16"][k] for key, r in (("arxiv", gred_arxiv),
                                                                 ("arxiv_d40", gred_arxiv40))
               for k in ("ms", "ms_f32_in_turns", "plain_ms", "bound_ms", "max_abs_err")})
          for name, p in (("gat_attention_fwd", "fwd"), ("gat_attention_bwd", "b2"))),
    ]}), flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
