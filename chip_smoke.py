#!/usr/bin/env python3
"""Smoke test of graphmat_tpu_torch on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``graphmat_tpu_torch/csrc`` and
drives the port's main paths on the card: PageRank (K1, K2), then SGD
collaborative filtering and LDA (K3), then the scalar frontier apps (BFS,
SSSP, connected components, topological sort, incremental PageRank,
delta-stepping) on both kernel routes: K1 with its receiver-finality skip
(``GRAPHMAT_KERNEL=v2u``) and the push kernel for K6/K7
(``GRAPHMAT_KERNEL=v2``), then ACTIVE_ONLY K-wide programs on K3's sparse
mode (K4, with K5's got count fused in).  Phases, in order; any failure
raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the software;
2. the kernel build, timed;
3. each kernel against its plain PyTorch version on a seeded RMAT graph
   of about 1M edges: K1 (the SpMV) for sum, min and max, for each ⊗,
   dense, sparse and sparse with the got count; K2 (the compaction
   gather) for float32 and uint8;
4. the golden file: the PageRank CLI on ``data/test.bin.mtx`` against the
   reference binary's output in ``tests/golden/pagerank_test.txt``;
5. the slice at full size: RMAT scale 22, edge factor 16, seed 1, built
   and deduplicated on the card, a degree-permuted Graph with compaction
   on, ``run_pagerank`` to convergence; the launch counts of both kernels
   over that run; the result against a float64 PageRank computed on the
   host with ``scipy.sparse`` for the same number of iterations;
6. timings on that graph, from CUDA events: a dense PageRank step on the
   kernel path (and its torch.profiler breakdown), on the plain path and
   with compaction off; each kernel alone at the slice's shapes beside
   its plain version; GTEPS and peak device memory;
7. K3 (the K-wide three-operand SpMV) against its plain version on a
   seeded bipartite graph of 1M ratings, for every op at K = 1, 20 and
   40; rows without edges must be exactly 0;
8. the SGD and LDA CLIs on ``data/ratings7.bin.mtx`` against the
   reference binary's outputs in ``tests/golden``;
9. SGD at MovieLens-25M shape (162,541 users, 59,047 rated items,
   25,000,095 half-star ratings, drawn uniformly on the card): ``run_sgd``
   at K = 20 (init RMSE, 10 iterations, RMSE) with K3's launch count,
   against a float64 oracle run on the card in edge chunks;
10. LDA at the shape of the UCI NYTimes bag of words (300,000 documents,
    102,660 terms, 69,679,427 document-term counts, min(zipf(2), 50)):
    ``run_lda`` at K = 20 for 10 iterations with K3's launch count,
    against a chunked float64 oracle on the card;
11. timings from CUDA events: an SGD and an LDA iteration on the kernel
    path and on the plain path, K3 alone at those shapes beside its plain
    version, M edge-updates/s and M token-updates/s, peak device memory;
12. K1's recv_final skip (0, 50 and 100% of rows final, sparse min and
    sum with got) and packed-key ⊗, and the push kernel (sum with got,
    min, max, every ⊗; dense and frontiers of 0.01%, 1% and 50% of
    senders), against their plain versions on phase 3's graph; K1 against
    the push, bitwise; then, on a hub graph (RMAT-16 plus a sender and a
    receiver of 2^20 edges, rows at each lane group's length limit and
    one past it, C and C + 1 edges, and empty rows), both kernels in
    every reduce x ⊗ x mode against their plain versions, K1's dense sum
    bitwise over two launches, and K1 against the push at a BFS level;
13. the BFS, SSSP, IncPR, DeltaStepping and TopoSort CLIs against the
    reference binary's outputs in ``tests/golden``, under both routes;
14. the slice at full size, both routes, counted per run: on phase 5's
    RMAT-22 graph BFS from 8 sources (depths equal to scipy's BFS, each
    parent an in-neighbour one level up), connected components (equal to
    scipy's weak components), TopoSort of its DAG (equal to a host Kahn
    oracle) and IncPR (against the float64 PageRank fixed point); on an
    RMAT-20 with bench.py's weights SSSP and DeltaStepping (equal to
    scipy's Dijkstra) and ``run_bfs_fast`` (equal to the classic BFS);
15. timings from CUDA events: BFS per source on each route (ms, GTEPS
    over the input edges within the reached component), one dense and one
    sparse BFS level on K1 beside the push, the SSSP dense sweep of
    bench.py:318-334 (GTEPS), the push kernel alone beside its plain
    version and cuSPARSE, where the hubs sit and what they cost each
    kernel (K1 without the first 32 or 1024 rows, the push without the
    first 32 senders and without its atomics, beside cuSPARSE), peak
    device memory;
16. K3's sparse mode against its plain version on phase 7's graph, every
    op at K = 1, 20, 40 with 100%, 10%, 1% and 0.01% of senders sent (the
    got count exact, at 100% bitwise the dense mode), and K5's function
    through K1's op x (sum, min, max) against ``ops/spmv.py``;
17. ACTIVE_ONLY subclasses of SGDProgram and RMSEProgram at MovieLens-25M
    shape, K = 20, through ``Engine.step_once``: one SGD step from seeded
    frontiers of 100%, 10% and 1% of the vertices against a float64
    oracle of the masked step (at 100%, bitwise the ALL_VERTICES step);
    RMSE from a 10% frontier against a float64 oracle (no term from a
    sender that did not send, ROADMAP R4); five SGD steps in lock-step
    with the plain route (sums, counts, next frontier); the sparse mode's
    launch count over those runs; timings from CUDA events: the sparse
    mode alone at each share beside dense K3 and its plain version, the
    ACTIVE_ONLY step at each frontier, K5's function alone beside its
    plain version and cuSPARSE, peak device memory.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Phase numbers given as arguments run
phases 1-2 and those only, without the result lines.
"""

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances, with their reasons
SUM_RTOL = 1e-5    # of sum(|term|) of the row: the kernel sums in another
                   # order than scatter_reduce_, and a hub row can cancel
GOLDEN_ATOL = 2e-5  # the golden file prints 6 decimals
ORACLE_RTOL = 1e-4  # float32 PageRank against the float64 oracle
F32_UNIT = 2.0 ** -24  # float32 unit roundoff
# lda_init's terms are positive: bitwise the same rand_r draws, normalised
# by a K-term sum of another order, then summed over the row's edges in
# another order (the plain version by index_add_, whose order changes from
# run to run on CUDA).  Its bound is the worst case of those two sums,
# (2 (deg - 1) + 2 K) units of the row's sum; a fixed 1e-6 of it, used
# before, was crossed on the card at 50-edge rows.
SGD_LV_ATOL = 1e-5  # float32 factors in [0, 1] (storage 6e-8) after 10
                    # steps whose float32 gradient sums err by ~1e-6 of
                    # updates that are themselves ~1e-4
SGD_RMSE_RTOL = 1e-5  # float32 per-vertex sums of squared errors, then a
                      # float32 sum over vertices on the host
LDA_N_RTOL = 1e-3   # of max(1, |N|): float32 through 10 multiplicative
                    # iterations; 2.1e-5 measured on the CPU at 1% of
                    # the NYTimes shape with the same degrees
LDA_LL_RTOL = 1e-5  # total log-likelihood, float32 per-vertex sums of
                    # val * log(dot), then a float32 sum over vertices
TOKEN_RTOL = 1e-5   # a vertex's N sums to its tokens: each edge adds
                    # val * sum(gamma / sum gamma) = val (1 +- K ulps)
MOVIELENS_25M = dict(users=162_541, items=59_047, ratings=25_000_095)
NYTIMES = dict(docs=300_000, terms=102_660, entries=69_679_427)
RAND_MAX = 2 ** 31 - 1
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
K3_OPS = ("sgd", "sgd_sqerr", "lda_init", "lda", "lda_loglik")


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_spmv_case(csr, x, val, sent, kind, op, mode, device):
    """K1 against its plain version on one input; returns max |error|."""
    import torch
    from graphmat_tpu_torch.ops.spmv2u import (PROCESS_OPS, spmv_csr,
                                               spmv_csr_reference)
    s = None if mode == "dense" else sent
    got = mode == "sparse_got"
    args = (csr.rowptr, csr.col, x, kind, op)
    out = spmv_csr(*args, val=val, sent=s, want_got=got, row=csr.row)
    sync(device)
    ref = spmv_csr_reference(*args, val=val, sent=s, want_got=got,
                             row=csr.row)
    if got:
        (out, cnt), (ref, cnt_ref) = out, ref
        if not torch.equal(cnt, cnt_ref):
            raise AssertionError(f"K1 got count differs ({kind}, {op})")
    what = f"K1 {kind} {op} {mode}"
    if kind != "sum":
        if not torch.equal(out, ref):
            raise AssertionError(f"{what}: min/max must be bitwise equal")
        return 0.0
    # the row's sum of |terms| bounds the reordering error
    colx, rowx = csr.col.long(), csr.row.long()
    terms = PROCESS_OPS[op](x[colx], val).abs()
    if s is not None:
        terms = terms * s[colx].to(terms.dtype)
    bound = torch.zeros_like(out).index_add_(0, rowx, terms) * SUM_RTOL
    err = (out - ref).abs()
    if not bool((err <= bound).all()):
        i = int(torch.argmax(err - bound))
        raise AssertionError(f"{what}: row {i} off by {float(err[i])}, "
                             f"bound {float(bound[i])}")
    return float(err.max())


def phase_kernels(device, scale=16, edge_factor=16, seed=7):
    """Phase 3: each kernel against its plain version."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.ops.compact import (aux_gather,
                                                aux_gather_reference,
                                                divert_stragglers)
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    g = Graph(e, device=device, build_in_edges=False, compact=False)
    csr = g.csr("dst")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(g.n_pad, generator=gen, device=device)
    val = torch.randn(csr.nnz, generator=gen, device=device)
    sent = (torch.rand(g.n_pad, generator=gen, device=device)
            < 0.3).to(torch.uint8)
    log(f"phase 3: RMAT-{scale} x{edge_factor}: n={g.n} nnz={csr.nnz} "
        f"max in-degree {int(csr.rowptr.diff().max())}")
    k1_err = 0.0
    for kind in ("sum", "min", "max"):
        for op in ("x", "x_mul_val", "x_add_val"):
            for mode in ("dense", "sparse", "sparse_got"):
                if mode == "sparse_got" and kind != "sum":
                    continue
                k1_err = max(k1_err, check_spmv_case(
                    csr, x, val, sent, kind, op, mode, device))
    # K2 on a real position map: every edge from a sender >= 64 diverts
    _, src_of_pos = divert_stragglers(csr.col, csr.row, g.n_pad, wr=1024,
                                      hub=64, divert_min=1 << 30, bpsb=4,
                                      w_div=16)
    if src_of_pos.numel() == 0:
        raise AssertionError("phase 3: nothing diverted")
    for t in (x, sent):
        out = torch.empty(src_of_pos.numel(), dtype=t.dtype, device=device)
        aux_gather(t, src_of_pos, out)
        sync(device)
        if not torch.equal(out, aux_gather_reference(t, src_of_pos)):
            raise AssertionError(f"K2 differs for {t.dtype}")
    log(f"phase 3: K1 agrees in 21 cases (max |err| {k1_err:.3e}); "
        f"K2 bitwise equal on {src_of_pos.numel()} positions")
    return k1_err


def phase_golden(device_env="cuda"):
    """Phase 4: the CLI on data/test.bin.mtx against the golden file."""
    from graphmat_tpu_torch.apps import pagerank
    os.environ["GRAPHMAT_PLATFORM"] = device_env
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pagerank._main([os.path.join(ROOT, "data", "test.bin.mtx")])
    ours = buf.getvalue()
    with open(os.path.join(ROOT, "tests", "golden",
                           "pagerank_test.txt")) as f:
        ref = f.read()
    ref_vals = {int(m[0]): float(m[2]) for m in re.findall(
        r"^(\d+) : (\d+) ([\d.]+)$", ref, re.M)}
    our_vals = {int(m[0]): float(m[1]) for m in re.findall(
        r"^(\d+) : ([\d.]+)$", ours, re.M)}
    if "Completed 6 iterations" not in ours:
        raise AssertionError(f"golden: expected 6 iterations:\n{ours}")
    if len(ref_vals) != 8 or set(our_vals) != set(ref_vals):
        raise AssertionError(f"golden: vertex sets differ:\n{ours}")
    worst = max(abs(our_vals[v] - p) for v, p in ref_vals.items())
    if worst >= GOLDEN_ATOL:
        raise AssertionError(f"golden: off by {worst}:\n{ours}")
    log(f"phase 4: golden PageRank matches (6 iterations, max |err| "
        f"{worst:.1e})")


def pagerank_oracle(src0, dst0, n, niter, alpha=0.3):
    """Float64 PageRank with scipy.sparse, the reference's formula, for
    a fixed number of iterations (0-based COO, original ids)."""
    import scipy.sparse as sp
    a = sp.csr_matrix((np.ones(len(src0)), (dst0, src0)), shape=(n, n))
    deg = np.bincount(src0, minlength=n)
    got = np.bincount(dst0, minlength=n) > 0
    pr = np.full(n, 0.3)
    for _ in range(niter):
        msg = np.where(deg == 0, 0.0, pr / np.maximum(deg, 1))
        pr = np.where(got, alpha + (1 - alpha) * (a @ msg), pr)
    return pr, deg


def phase_slice(device, scale=22, edge_factor=16, seed=1, graph_kw=None):
    """Phase 5: the main path at full size, counted and checked.
    ``graph_kw`` goes to the Graph (a smaller rehearsal forces
    compaction with it)."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.pagerank import run_pagerank
    from graphmat_tpu_torch.ops import compact, spmv2u
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e = rmat_edgelist(scale, edge_factor, a=0.57, b=0.19, c=0.19,
                      seed=seed, device=device)
    sync(device)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = Graph(e, device=device, permute="degree", **(graph_kw or {}))
    sync(device)
    t_build = time.perf_counter() - t0
    compacted = {r: g.csr(r).src_of_pos is not None for r in ("dst", "src")}
    if not all(compacted.values()):
        raise AssertionError(f"compaction expected on at n={g.n}: "
                             f"{compacted}")
    n_aux = {r: int(g.csr(r).src_of_pos.numel()) for r in ("dst", "src")}

    for k in spmv2u.LAUNCHES:
        spmv2u.LAUNCHES[k] = 0
    compact.LAUNCHES["aux_gather"] = 0
    t0 = time.perf_counter()
    pr, niter = run_pagerank(g, alpha=0.3)
    sync(device)
    t_run = time.perf_counter() - t0
    k1 = dict(spmv2u.LAUNCHES)
    k2 = dict(compact.LAUNCHES)
    log(f"phase 5: launches over run_pagerank: K1 {k1}, K2 {k2}")
    if torch.device(device).type == "cuda" and (
            k1["dense"] < niter or k1["sparse_got"] < 1
            or k2["aux_gather"] < 1):
        raise AssertionError("phase 5: the main path missed a kernel")

    # the degree pass alone, timed apart (PageRank = total - degree)
    from graphmat_tpu_torch.apps.pagerank import (DegreeProgram,
                                                  init_pagerank_graph)
    from graphmat_tpu_torch.core.runtime import Engine
    init_pagerank_graph(g)
    g.set_all_active()
    t0 = time.perf_counter()
    Engine(DegreeProgram(), g).run(iterations=1)
    sync(device)
    t_deg = time.perf_counter() - t0

    t0 = time.perf_counter()
    src0 = e.src.cpu().numpy().astype(np.int64) - 1
    dst0 = e.dst.cpu().numpy().astype(np.int64) - 1
    ref, deg = pagerank_oracle(src0, dst0, g.n, niter)
    t_oracle = time.perf_counter() - t0
    if not np.array_equal(g.vp_numpy()["degree"], deg):
        raise AssertionError("phase 5: degrees differ from the oracle")
    if pr.shape != (g.n,) or not np.isfinite(pr).all():
        raise AssertionError("phase 5: PageRank not finite or misshapen")
    rel = float(np.max(np.abs(pr - ref) / np.maximum(1.0, np.abs(ref))))
    if rel > ORACLE_RTOL:
        raise AssertionError(f"phase 5: off the f64 oracle by {rel}")
    log(f"phase 5: RMAT-{scale} x{edge_factor}: n={g.n} nnz={g.nnz} "
        f"niter={niter}; operand extension {n_aux}; seconds: generate "
        f"{t_gen:.3f}, graph build {t_build:.3f}, run_pagerank "
        f"{t_run:.3f} (degree pass {t_deg:.3f}, PageRank "
        f"{t_run - t_deg:.3f}); oracle {t_oracle:.1f} s on the host; "
        f"max |err|/max(1,|ref|) {rel:.3e}")
    return e, g, niter, k1, k2


def event_ms(fn, reps, warm=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timings(e, g, card):
    """Phase 6: step and kernel times on the slice's graph."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.pagerank import (PageRankProgram,
                                                  run_pagerank)
    from graphmat_tpu_torch.core import runtime
    from graphmat_tpu_torch.ops import spmv2u
    from graphmat_tpu_torch.ops.compact import (aux_gather,
                                                aux_gather_reference)
    from graphmat_tpu_torch.ops.spmv2u import spmv_csr, spmv_csr_reference

    g_off = Graph(e, device=g.device, permute="degree", compact=False)
    run_pagerank(g_off, iterations=1)   # degrees and a live pagerank
    eng = runtime.Engine(PageRankProgram(), g)
    eng_off = runtime.Engine(PageRankProgram(), g_off)

    def plain_step():
        kernel_spmv = runtime.spmv
        runtime.spmv = spmv2u.spmv_reference
        try:
            eng.step_once()
        finally:
            runtime.spmv = kernel_spmv

    step = {"kernel": [], "plain": [], "kernel_compact_off": []}
    for _ in range(2):   # two interleaved rounds, median of 5 steps each
        step["kernel"].append(event_ms(eng.step_once, 5))
        step["plain"].append(event_ms(plain_step, 5))
        step["kernel_compact_off"].append(event_ms(eng_off.step_once, 5))

    # each kernel alone at the slice's shapes
    csr = g.csr("dst")
    gen = torch.Generator(device=g.device)
    gen.manual_seed(3)
    x = torch.rand(g.n_pad, generator=gen, device=g.device)
    ns = csr.n_send
    aux_out = csr.x_ext[ns:]
    k2_ms = event_ms(lambda: aux_gather(x, csr.src_of_pos, aux_out), 20)
    k2_plain_ms = event_ms(
        lambda: aux_gather_reference(x, csr.src_of_pos), 20)
    csr.x_ext[:ns].copy_(x)
    k2_out = aux_gather(x, csr.src_of_pos, aux_out)
    if not torch.equal(k2_out, aux_gather_reference(x, csr.src_of_pos)):
        raise AssertionError("phase 6: K2 differs at the slice's shape")
    dense_args = (csr.rowptr, csr.col_ext, csr.x_ext, "sum", "x")
    k1_plan = spmv2u.plan_for(csr)
    k1_ms = event_ms(lambda: spmv_csr(*dense_args, plan=k1_plan), 20)
    k1_plain_ms = event_ms(
        lambda: spmv_csr_reference(*dense_args, row=csr.row), 5)
    k1_err = check_spmv_case(
        type(csr)(csr.rowptr, csr.col_ext, csr.row, csr.val, ns),
        csr.x_ext, None, None, "sum", "x", "dense", g.device)
    # yardsticks, never called by the package: cuSPARSE for K1's dense
    # sum, index_select for K2; and the bounds (each input read once,
    # each output written once, at the H100's 3.35 TB/s)
    k1_lib_ms = cusparse_ms(csr.rowptr, csr.col, x)
    pos = csr.src_of_pos.long()
    k2_lib_ms = event_ms(lambda: torch.index_select(x, 0, pos), 20)
    k1_bytes = 4 * (csr.rowptr.numel() + csr.nnz + csr.x_ext.numel()
                    + csr.n_rows)
    n_pos = csr.src_of_pos.numel()
    k2_bytes = 4 * (2 * n_pos + min(n_pos, ns))
    csr_in = g.csr("src")
    sent = (torch.rand(csr_in.x_ext.numel(), generator=gen,
                       device=g.device) < 0.5).to(torch.uint8)
    got_args = (csr_in.rowptr, csr_in.col_ext, csr_in.x_ext, "sum", "x")
    got_plan = spmv2u.plan_for(csr_in)
    k1_got_ms = event_ms(lambda: spmv_csr(
        *got_args, sent=sent, want_got=True, plan=got_plan), 20)
    k1_got_plain_ms = event_ms(
        lambda: spmv_csr_reference(*got_args, sent=sent, want_got=True,
                                   row=csr_in.row), 5)

    step_ms = min(step["kernel"])
    profile = profile_run(eng.step_once)
    out = {
        "step_profile": profile,
        "card": card,
        "step_ms": step,
        "gteps_kernel": g.nnz / (step_ms * 1e-3) / 1e9,
        "gteps_kernel_compact_off":
            g.nnz / (min(step["kernel_compact_off"]) * 1e-3) / 1e9,
        "gteps_plain": g.nnz / (min(step["plain"]) * 1e-3) / 1e9,
        "k1_dense_sum_ms": k1_ms, "k1_dense_sum_plain_ms": k1_plain_ms,
        "k1_sparse_got_ms": k1_got_ms,
        "k1_sparse_got_plain_ms": k1_got_plain_ms,
        "k2_ms": k2_ms, "k2_plain_ms": k2_plain_ms,
        "k2_positions": int(csr.src_of_pos.numel()),
        "k1_cusparse_ms": k1_lib_ms, "k1_bound_ms": hbm_ms(k1_bytes),
        "k2_index_select_ms": k2_lib_ms, "k2_bound_ms": hbm_ms(k2_bytes),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log("phase 6 (" + card + "): " + json.dumps(out))
    return out, k1_err

# ---------------------------------------------------------------- K3


def k3_inputs(op, k, n, gen, device):
    """x, vp, extra for one K3 op: ``k`` components (for ``lda``, k
    topics plus the is_doc column); LDA counts are drawn from [0.5, 5),
    clear of the float32 cancellation of (N + alpha - 1) near 0."""
    import torch
    w = k + 1 if op == "lda" else k

    def rnd(*shape):
        return torch.rand(*shape, generator=gen, device=device)
    if op in ("sgd", "sgd_sqerr"):
        return (0.3 * torch.randn(n, w, generator=gen, device=device),
                0.3 * torch.randn(n, w, generator=gen, device=device), None)
    if op == "lda_init":
        return torch.zeros(n, w, device=device), None, None
    x, vp = 0.5 + 4.5 * rnd(n, w), 0.5 + 4.5 * rnd(n, w)
    if op == "lda":
        x[:, k] = 0.0
        vp[:, k] = (rnd(n) < 0.5).float()
        return x, vp, 50.0 + 50.0 * rnd(k)
    return x, vp, 100.0 + 100.0 * rnd(k)


def k3_row_scale(csr, op, x, vp, extra, params, sent=None):
    """The scale of each row's float32 rounding, in edge chunks: Σ|terms|
    over the row's edges (those whose sender sent, where ``sent`` is
    given), plus, for the SGD ops, each term's sensitivity to its K-term
    dot product <x, vp_r> times that product's Σ|x_k vp_k|: the kernel
    and the plain version sum the dot in other orders, which moves a term
    by up to K units of that sum, more than 1e-5 of the term where the
    error val - <x, vp_r> nearly cancels."""
    import torch
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    total = torch.zeros((csr.n_rows, sv.out_width(op, x.shape[1])),
                        dtype=torch.float32, device=x.device)
    for c in chunked(csr.nnz):
        colx, rowx = csr.col[c].long(), csr.row[c].long()
        xe, vpe = x[colx], vp[rowx] if vp is not None else None
        terms = sv.VEC_PROCESS_OPS[op](xe, csr.val_f32[c], vpe, extra,
                                       params).abs()
        if op in ("sgd", "sgd_sqerr"):
            prod = xe * vpe
            dot = prod.abs().sum(1, keepdim=True)
            if op == "sgd":
                terms += xe.abs() * dot
            else:
                err = csr.val_f32[c][:, None] - prod.sum(1, keepdim=True)
                terms += 2 * err.abs() * dot
        if sent is not None:
            terms = terms * sent[colx][:, None].to(terms.dtype)
        total.index_add_(0, rowx, terms)
    return total


def check_k3_case(csr, op, x, vp, extra, params, device, sent=None):
    """K3 against its plain version on one input; returns max |error|.
    With ``sent`` (uint8 per sender), K3's sparse mode: the got count
    exactly, a row without a sent edge exactly 0, and with every sender
    sent the dense mode's bits."""
    import torch
    from graphmat_tpu_torch.ops import spmv_vec as ss
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    args = (csr.rowptr, csr.col, csr.val_f32, x, op, vp, extra, params)
    what = f"K3 {op} K={x.shape[1]}"
    counter = sv.LAUNCHES if sent is None else ss.LAUNCHES
    before = counter[op]
    if sent is None:
        out = sv.spmv_vec_csr(*args, row=csr.row)
    else:
        what += f" sparse, {float(sent.float().mean()):.2%} sent"
        sargs = args[:5] + (sent,) + args[5:]
        out, got = ss.spmv_vec_sparse_csr(*sargs, row=csr.row)
    sync(device)
    if torch.device(device).type == "cuda" and counter[op] != before + 1:
        raise AssertionError(f"{what}: the kernel did not launch")
    if sent is None:
        ref = sv.spmv_vec_csr_reference(*args, row=csr.row)
        deg = csr.rowptr.diff()
    else:
        ref, got_ref = ss.spmv_vec_sparse_csr_reference(*sargs, row=csr.row)
        if not torch.equal(got, got_ref):
            raise AssertionError(f"{what}: got counts differ")
        # the kernels' contract; the plain versions on the CPU were seen to
        # differ in the last bits between two calls on the same input
        if (torch.device(device).type == "cuda" and bool(sent.all())
                and not torch.equal(out, sv.spmv_vec_csr(*args,
                                                         row=csr.row))):
            raise AssertionError(f"{what}: every sender sent, but the "
                                 "sparse mode differs from the dense one")
        deg = got
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: shape {tuple(out.shape)} or not "
                             "finite")
    if not bool((out[deg == 0] == 0).all()):
        raise AssertionError(f"{what}: a row without edges is not 0")
    # the row's sum of |terms| bounds the reordering error
    bound = k3_row_scale(csr, op, x, vp, extra, params, sent)
    if op == "lda_init":
        degf = deg.to(out.dtype)[:, None]
        bound *= (2 * (degf - 1).clamp(min=0) + 2 * x.shape[1]) * F32_UNIT
    else:
        bound *= SUM_RTOL
    err = (out - ref).abs()
    if not bool((err <= bound).all()):
        i = int(torch.argmax(err - bound))
        raise AssertionError(f"{what}: element {i} off by "
                             f"{float(err.flatten()[i])}, bound "
                             f"{float(bound.flatten()[i])}")
    return float(err.max())


def ratings_edgelist(users, items, ratings, seed, device):
    """A rating matrix drawn uniformly on the device: user u -> item
    (users + i), 1-based, half-star ratings 0.5..5.0, duplicates kept."""
    import torch
    from graphmat_tpu_torch import EdgeList
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = users + items
    src = torch.randint(1, users + 1, (ratings,), generator=gen,
                        device=device, dtype=torch.int32)
    dst = users + torch.randint(1, items + 1, (ratings,), generator=gen,
                                device=device, dtype=torch.int32)
    val = 0.5 * torch.randint(1, 11, (ratings,), generator=gen,
                              device=device).float()
    return EdgeList(n, n, src, dst, val)


def phase_k3(device, users=60_000, items=20_000, ratings=1_000_000,
             seed=17):
    """Phase 7: K3 against its plain version, every op at K = 1, 20, 40,
    on a bipartite graph: the receiver=dst rows of the users have no
    edges."""
    import torch
    from graphmat_tpu_torch import Graph
    e = ratings_edgelist(users, items, ratings, seed, device)
    e.val = torch.ceil(e.val)   # integer counts, which lda_init needs
    g = Graph(e, device=device, build_in_edges=False, compact=False)
    csr = g.csr("dst")
    n_empty = int((csr.rowptr.diff() == 0).sum())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"alpha": 1.0, "eta": 5.0, "vocab_size": items}
    worst = 0.0
    for k in (1, 20, 40):
        for op in K3_OPS:
            x, vp, extra = k3_inputs(op, k, g.n_pad, gen, device)
            worst = max(worst, check_k3_case(csr, op, x, vp, extra, params,
                                             device))
    log(f"phase 7: K3 agrees in {3 * len(K3_OPS)} cases on n={g.n} "
        f"nnz={csr.nnz} ({n_empty} rows without edges; max in-degree "
        f"{int(csr.rowptr.diff().max())}); max |err| {worst:.3e}")
    return worst


def phase_golden_ml(device_env="cuda"):
    """Phase 8: the SGD and LDA CLIs against the golden files."""
    from graphmat_tpu_torch.apps import lda, sgd
    os.environ["GRAPHMAT_PLATFORM"] = device_env
    mtx = os.path.join(ROOT, "data", "ratings7.bin.mtx")
    gold = os.path.join(ROOT, "tests", "golden")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sgd._main([mtx])
    ours = buf.getvalue()
    with open(os.path.join(gold, "sgd_ratings7.txt")) as f:
        ref = f.read()
    pat = r"RMSE error = ([\d.]+) per edge"
    our_rmse = [float(x) for x in re.findall(pat, ours)]
    ref_rmse = [float(x) for x in re.findall(pat, ref)]
    if (len(our_rmse) != 2 or abs(our_rmse[0] - ref_rmse[0]) >= 1e-5
            or abs(our_rmse[1] - ref_rmse[1]) >= 1e-3):
        raise AssertionError(f"golden SGD RMSE {our_rmse} vs {ref_rmse}")
    row = r"^(\d+) : ((?: +[\d.]+)+)"
    ref_tab = {int(v): np.array(r.split(), float)
               for v, r in re.findall(row, ref, re.M)}
    our_tab = {int(v): np.array(r.split(), float)
               for v, r in re.findall(row, ours, re.M)}
    worst = max(float(np.abs(our_tab[v] - r).max())
                for v, r in ref_tab.items())
    if len(ref_tab) != 7 or worst >= 0.015:
        raise AssertionError(f"golden SGD factors off by {worst}:\n{ours}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lda._main([mtx, "3", "4", "10"])
    pat = r"Total Loglikelihood = (-?[\d.]+)"
    with open(os.path.join(gold, "lda_ratings7.txt")) as f:
        ll_ref = float(re.search(pat, f.read())[1])
    m = re.search(pat, buf.getvalue())
    if not m or abs(float(m[1]) - ll_ref) >= 2e-3:
        raise AssertionError(f"golden LDA: {buf.getvalue()}")
    log(f"phase 8: golden SGD (RMSE {our_rmse}, factors within "
        f"{worst:.3f}) and LDA (log-likelihood {float(m[1])}) match")


def rand_r_uniform_f32(seeds, count):
    """glibc rand_r / RAND_MAX in float64, stored as float32 (the
    reference's init), written here independently of the package."""
    import torch
    nxt = seeds.to(torch.int64) & 0xFFFFFFFF
    out = []
    for _ in range(count):
        r = 0
        for bits in (11, 10, 10):
            nxt = (nxt * 1103515245 + 12345) & 0xFFFFFFFF
            r = (r << bits) ^ ((nxt >> 16) & ((1 << bits) - 1))
        out.append(r)
    return (torch.stack(out, 1).double() / RAND_MAX).float()


def chunked(n, size=1 << 22):
    return [slice(a, min(a + size, n)) for a in range(0, n, size)]


def sgd_oracle(src0, dst0, val, n, lv0, iters, lambda_=0.001, step=3.5e-7,
               sent=None):
    """Float64 SGD after tests/test_ml_apps.py:43-67, on the device, in
    edge chunks: (lv after iters, rmse before, rmse after).  With
    ``sent`` (bool per vertex) the steps are ACTIVE_ONLY ones from that
    frontier, held fixed: only the edges whose sender is in it carry a
    gradient, and only their receivers move."""
    import torch
    lv = lv0.double()
    v = val.double()
    got = torch.zeros(n, dtype=torch.bool, device=lv.device)
    for s, r in ((src0, dst0), (dst0, src0)):
        got[r if sent is None else r[sent[s]]] = True

    def rmse(lv):
        tot = 0.0
        for c in chunked(len(v)):
            est = (lv[src0[c]] * lv[dst0[c]]).sum(1)
            tot += float(((v[c] - est) ** 2).sum())
        return float(np.sqrt(tot / len(v)))
    r0 = rmse(lv)
    for _ in range(iters):
        grad = torch.zeros_like(lv)
        for s, r in ((src0, dst0), (dst0, src0)):
            for c in chunked(len(v)):
                xs, xr = lv[s[c]], lv[r[c]]
                err = v[c] - (xs * xr).sum(1)
                terms = xs * err[:, None]
                if sent is not None:
                    terms = terms * sent[s[c]][:, None]
                grad.index_add_(0, r[c], terms)
        lv = torch.where(got[:, None], lv + step * (-lambda_ * lv + grad),
                         lv)
    return lv, r0, rmse(lv)


def phase_sgd(device, users, items, ratings, k=20, seed=25,
              iterations=10):
    """Phase 9: run_sgd at MovieLens-25M shape, counted and checked."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.sgd import init_sgd_graph, run_sgd
    from graphmat_tpu_torch.ops import spmv_vec2
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e = ratings_edgelist(users, items, ratings, seed, device)
    sync(device)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = Graph(e, device=device, permute=False)
    sync(device)
    t_build = time.perf_counter() - t0
    init_sgd_graph(g, k)
    lv_init = g.vp["lv"][: g.n].clone()

    for op in spmv_vec2.LAUNCHES:
        spmv_vec2.LAUNCHES[op] = 0
    t0 = time.perf_counter()
    lv, rmse0, rmse1 = run_sgd(g, k=k, iterations=iterations)
    sync(device)
    t_run = time.perf_counter() - t0
    k3 = dict(spmv_vec2.LAUNCHES)
    log(f"phase 9: launches over run_sgd: K3 {k3}")
    if cuda and (k3["sgd"] < 2 * iterations or k3["sgd_sqerr"] < 2):
        raise AssertionError("phase 9: the main path missed K3")
    peak = torch.cuda.max_memory_allocated() if cuda else None

    t0 = time.perf_counter()
    src0, dst0 = e.src.long() - 1, e.dst.long() - 1
    seeds = torch.arange(1, g.n + 1, device=device)
    lv0 = rand_r_uniform_f32(seeds, k)
    if not torch.equal(lv0, lv_init):
        raise AssertionError("phase 9: initial factors differ from rand_r")
    lv_o, r0_o, r1_o = sgd_oracle(src0, dst0, e.val, g.n, lv0, iterations)
    sync(device)
    t_oracle = time.perf_counter() - t0
    if lv.shape != (g.n, k) or not np.isfinite(lv).all():
        raise AssertionError("phase 9: factors not finite or misshapen")
    lv_err = float(np.abs(lv - lv_o.cpu().numpy()).max())
    r_err = max(abs(rmse0 - r0_o) / r0_o, abs(rmse1 - r1_o) / r1_o)
    if lv_err > SGD_LV_ATOL or r_err > SGD_RMSE_RTOL or not rmse1 < rmse0:
        raise AssertionError(f"phase 9: off the f64 oracle: factors by "
                             f"{lv_err}, RMSE by {r_err} (ours {rmse0} -> "
                             f"{rmse1}, oracle {r0_o} -> {r1_o})")
    log(f"phase 9: SGD n={g.n} nnz={g.nnz} K={k}: RMSE {rmse0:.6f} -> "
        f"{rmse1:.6f} (oracle {r0_o:.6f} -> {r1_o:.6f}, max rel err "
        f"{r_err:.2e}); factors max |err| {lv_err:.2e}, initial factors "
        f"bitwise equal; seconds: generate {t_gen:.3f}, graph build "
        f"{t_build:.3f}, run_sgd {t_run:.3f}, oracle {t_oracle:.1f}; "
        f"peak device memory {peak}")
    return e, g, k3, dict(build_s=t_build, run_s=t_run, peak_bytes=peak)


def nytimes_edgelist(docs, terms, entries, seed, device):
    """A doc-term matrix drawn uniformly on the device (doc d -> term
    docs + t, 1-based), counts min(zipf(2), 50) by the inverse CDF."""
    import torch
    from graphmat_tpu_torch import EdgeList
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = docs + terms
    src = torch.randint(1, docs + 1, (entries,), generator=gen,
                        device=device, dtype=torch.int32)
    dst = docs + torch.randint(1, terms + 1, (entries,), generator=gen,
                               device=device, dtype=torch.int32)
    # P(count = c) = c^-2 / zeta(2) for c < 50; the tail from 50 on is 50
    c = np.arange(1, 50, dtype=np.float64)
    cdf = torch.as_tensor(np.cumsum(c ** -2) / (np.pi ** 2 / 6),
                          device=device)
    u = torch.rand(entries, generator=gen, device=device,
                   dtype=torch.float64)
    val = (torch.searchsorted(cdf, u, right=True) + 1).float()
    return EdgeList(n, n, src, dst, val)


def lda_oracle(src0, dst0, val, n, ndoc, nterms, k, iters, alpha=1.0,
               eta=5.0):
    """Float64 LDA after tests/test_ml_apps.py:90-116 (plus the
    log-likelihood pass), on the device, in edge chunks:
    (N, total log-likelihood)."""
    import torch
    dev = src0.device
    v = val.double()
    is_doc = torch.arange(n, device=dev) < ndoc
    got = torch.zeros(n, dtype=torch.bool, device=dev)
    got[src0] = True
    got[dst0] = True
    N = torch.zeros(n, k, dtype=torch.float64, device=dev)
    for c in chunked(len(v)):
        gam = rand_r_uniform_f32(val[c].long(), k).double()
        gam = gam / gam.sum(1, keepdim=True) * v[c, None]
        N.index_add_(0, dst0[c], gam)
        N.index_add_(0, src0[c], gam)
    for _ in range(iters):
        gn = N[~is_doc].sum(0)
        new = torch.zeros_like(N)
        for s, r in ((src0, dst0), (dst0, src0)):
            for c in chunked(len(v)):
                doc = is_doc[r[c]][:, None]
                my = torch.where(doc, alpha, eta)
                ot = torch.where(doc, eta, alpha)
                gam = ((N[r[c]] + my - 1) * (N[s[c]] + ot - 1)
                       / (gn + nterms * (eta - 1)))
                gam = gam / gam.sum(1, keepdim=True) * v[c, None]
                new.index_add_(0, r[c], gam)
        N = torch.where(got[:, None], new, N)
    nks = N[~is_doc].sum(0) + nterms * (eta - 1)
    ll = 0.0
    for c in chunked(len(v)):
        phi = (N[dst0[c]] + eta - 1) / nks
        theta = N[src0[c]] + eta - 1
        theta = theta / theta.sum(1, keepdim=True)
        ll += float((v[c] * torch.log((phi * theta).sum(1))).sum())
    return N, ll


def phase_lda(device, docs, terms, entries, k=20, seed=29, iterations=10):
    """Phase 10: run_lda at NYTimes shape, counted and checked."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.lda import run_lda
    from graphmat_tpu_torch.ops import spmv_vec2
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    e = nytimes_edgelist(docs, terms, entries, seed, device)
    sync(device)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = Graph(e, device=device, permute=False)
    sync(device)
    t_build = time.perf_counter() - t0

    for op in spmv_vec2.LAUNCHES:
        spmv_vec2.LAUNCHES[op] = 0
    t0 = time.perf_counter()
    N, gn, ll = run_lda(g, docs, terms, k=k, iterations=iterations)
    sync(device)
    t_run = time.perf_counter() - t0
    k3 = dict(spmv_vec2.LAUNCHES)
    log(f"phase 10: launches over run_lda: K3 {k3}")
    if cuda and (k3["lda_init"] < 2 or k3["lda"] < 2 * iterations
                 or k3["lda_loglik"] < 1):
        raise AssertionError("phase 10: the main path missed K3")
    peak = torch.cuda.max_memory_allocated() if cuda else None

    t0 = time.perf_counter()
    src0, dst0 = e.src.long() - 1, e.dst.long() - 1
    n_o, ll_o = lda_oracle(src0, dst0, e.val, g.n, docs, terms, k,
                           iterations)
    tok = torch.zeros(g.n, dtype=torch.float64, device=device)
    tok.index_add_(0, src0, e.val.double()).index_add_(0, dst0,
                                                        e.val.double())
    sync(device)
    t_oracle = time.perf_counter() - t0
    n_o, tok = n_o.cpu().numpy(), tok.cpu().numpy()
    if N.shape != (g.n, k) or not np.isfinite(N).all() or \
            not np.isfinite(ll):
        raise AssertionError("phase 10: N or the log-likelihood is not "
                             "finite, or N is misshapen")
    tok_err = float(np.max(np.abs(N.sum(1) - tok) / np.maximum(1.0, tok)))
    n_err = float(np.max(np.abs(N - n_o) / np.maximum(1.0, np.abs(n_o))))
    ll_err = abs(ll - ll_o) / abs(ll_o)
    if tok_err > TOKEN_RTOL or n_err > LDA_N_RTOL or ll_err > LDA_LL_RTOL:
        raise AssertionError(f"phase 10: tokens off by {tok_err}, N off "
                             f"the f64 oracle by {n_err}, log-likelihood "
                             f"{ll} vs {ll_o}")
    log(f"phase 10: LDA n={g.n} nnz={g.nnz} tokens={int(tok.sum()) // 2} "
        f"K={k}: log-likelihood {ll:.6e} (oracle {ll_o:.6e}, rel err "
        f"{ll_err:.2e}); N max err/max(1,|N|) {n_err:.2e}; tokens "
        f"conserved within {tok_err:.2e}; seconds: generate {t_gen:.3f}, "
        f"graph build {t_build:.3f}, run_lda {t_run:.3f}, oracle "
        f"{t_oracle:.1f}; peak device memory {peak}")
    return e, g, gn, k3, dict(build_s=t_build, run_s=t_run,
                              peak_bytes=peak)


def phase_ml_timings(g_sgd, g_lda, gn_lda, card, k=20):
    """Phase 11: SGD and LDA iteration and K3 times at the slices'
    shapes, kernel beside plain."""
    import torch
    from graphmat_tpu_torch.apps import lda, sgd
    from graphmat_tpu_torch.core import runtime
    from graphmat_tpu_torch.ops import spmv_vec2 as sv

    def plain(fn):
        def run():
            kernel = runtime.spmv_vec
            runtime.spmv_vec = sv.spmv_vec_reference
            try:
                fn()
            finally:
                runtime.spmv_vec = kernel
        return run

    nterms = g_lda.n - int(g_lda.vp["is_doc"].sum())
    eng_sgd = runtime.Engine(sgd.SGDProgram(k=k), g_sgd)
    prog_lda = lda.LDAProgram(k, vocab_size=nterms, ndoc=g_lda.n - nterms)
    eng_lda = runtime.Engine(prog_lda, g_lda)
    gn = torch.as_tensor(gn_lda, device=g_lda.device)

    def sgd_step():
        eng_sgd.step_once()

    def lda_step():
        eng_lda.step_once(state=gn)

    step = {"sgd_kernel": [], "sgd_plain": [], "lda_kernel": [],
            "lda_plain": []}
    for _ in range(2):   # two interleaved rounds
        step["sgd_kernel"].append(event_ms(sgd_step, 5))
        step["sgd_plain"].append(event_ms(plain(sgd_step), 3, warm=1))
        step["lda_kernel"].append(event_ms(lda_step, 5))
        step["lda_plain"].append(event_ms(plain(lda_step), 3, warm=1))

    # K3 alone, one direction, at each slice's shape
    params = prog_lda.params
    c_sgd, c_lda = g_sgd.csr("dst"), g_lda.csr("dst")
    lv = g_sgd.vp["lv"]
    x_lda = prog_lda._encode_msg(gn, g_lda.vp)
    vp_lda = prog_lda._encode_vp(gn, g_lda.vp)
    k3 = {}
    err = 0.0
    for name, csr, op, x, vp, extra in (
            ("sgd", c_sgd, "sgd", lv, lv, None),
            ("lda", c_lda, "lda", x_lda, vp_lda, gn)):
        args = (csr, x, op, vp, extra, params)
        k3[name + "_ms"] = event_ms(lambda: sv.spmv_vec(*args), 10)
        k3[name + "_plain_ms"] = event_ms(
            lambda: sv.spmv_vec_reference(*args), 3, warm=1)
        err = max(err, check_k3_case(csr, op, x, vp, extra, params,
                                     g_sgd.device))
    sgd_ms, lda_ms = min(step["sgd_kernel"]), min(step["lda_kernel"])
    # K3 sgd's bound: rowptr, col, val, x, vp and y once; 4K flops a edge
    k3_bytes = 4 * (c_sgd.rowptr.numel() + 2 * c_sgd.nnz
                    + 3 * k * c_sgd.n_rows)
    k3_ops_ms = 4 * k * c_sgd.nnz / FP32_FLOPS * 1e3
    k3["sgd_bound_ms"] = max(hbm_ms(k3_bytes), k3_ops_ms)
    k3["sgd_bound_by"] = ("bytes" if hbm_ms(k3_bytes) >= k3_ops_ms
                          else "operations")
    # K3 lda's: rowptr, col, val, x and vp (K + 1 columns), extra and y
    # (K columns) once; 8K operations an edge (two offsets, a product, a
    # division and a sum for gamma, then a division, a product and a sum)
    lda_bytes = 4 * (c_lda.rowptr.numel() + 2 * c_lda.nnz
                     + (k + 1) * (c_lda.n_send + c_lda.n_rows) + k
                     + k * c_lda.n_rows)
    lda_ops_ms = 8 * k * c_lda.nnz / FP32_FLOPS * 1e3
    k3["lda_bound_ms"] = max(hbm_ms(lda_bytes), lda_ops_ms)
    k3["lda_bound_by"] = ("bytes" if hbm_ms(lda_bytes) >= lda_ops_ms
                          else "operations")
    out = {
        "card": card,
        "step_ms": step,
        "k3_ms": k3,
        "sgd_medges_per_s": 2 * g_sgd.nnz / (sgd_ms * 1e-3) / 1e6,
        "sgd_medges_per_s_plain":
            2 * g_sgd.nnz / (min(step["sgd_plain"]) * 1e-3) / 1e6,
        "lda_mtokens_per_s": 2 * g_lda.nnz / (lda_ms * 1e-3) / 1e6,
        "lda_mtokens_per_s_plain":
            2 * g_lda.nnz / (min(step["lda_plain"]) * 1e-3) / 1e6,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log("phase 11 (" + card + "): " + json.dumps(out))
    return out, err


# ------------------------------------------------- scalar frontier apps

FRONTIERS = (1e-4, 1e-2, 0.5)   # shares of senders in a sparse push
FINAL_SHARES = (0.0, 0.5, 1.0)  # shares of receiver rows marked final
DELTA = 64          # delta-stepping bucket width for weights 1..255
SSSP_ITERS = 200    # bench.py:54, dense relaxation sweeps per timed run
# of max(1, |pr|): float32 delta-PageRank (deltas under 1e-8 are never
# propagated) against the float64 fixed point.  K1 sums a row in a fixed
# order, 32 lanes then a shuffle tree: 9.8e-7 measured at RMAT-22.  The
# push kernel sums by atomics, one float32 accumulator per receiver in
# arbitrary order, whose error grows with the in-degree (hub rows of
# RMAT-22 hold ~10^5 terms): 6.0e-5 to 7.4e-5 measured (NVIDIA H100 80GB
# HBM3, 700 W; PERF.md section 6)
INCPR_RTOL = {"v2u": 1e-5, "v2": 1e-3}
N_SOURCES = 8


def sum_bound(col_recv, send_of_edge, terms, n_recv, sent=None):
    """SUM_RTOL times each receiver's Σ|terms| over contributing edges."""
    import torch
    t = terms.abs()
    if sent is not None:
        t = t * sent[send_of_edge].to(t.dtype)
    return torch.zeros(n_recv, dtype=t.dtype, device=t.device).index_add_(
        0, col_recv, t) * SUM_RTOL


def compare_out(what, out, ref, kind, bound=None):
    """min/max bitwise; a sum within ``bound``; returns max |error|."""
    import torch
    if kind != "sum":
        if not torch.equal(out, ref):
            bad = int((out != ref).sum())
            raise AssertionError(f"{what}: min/max must be bitwise equal "
                                 f"({bad} rows differ)")
        return 0.0
    err = (out - ref).abs()
    if not bool((err <= bound).all()):
        i = int(torch.argmax(err - bound))
        raise AssertionError(f"{what}: row {i} off by {float(err[i])}, "
                             f"bound {float(bound[i])}")
    return float(err.max())


def packed_keys(n, bits, gen, device):
    """Packed BFS keys KEY_BIAS + (depth << bits | id) as float32 patterns,
    one in ten the +inf fill; integer weights 1..7 for them."""
    import torch
    from graphmat_tpu_torch.ops.spmv2u import KEY_BIAS
    depth = torch.randint(0, 60, (n,), generator=gen, device=device)
    ids = torch.randint(0, 1 << bits, (n,), generator=gen, device=device)
    keys = (KEY_BIAS + ((depth << bits) | ids)).to(torch.int32)
    x = keys.view(torch.float32).clone()
    x[torch.rand(n, generator=gen, device=device) < 0.1] = float("inf")
    return x


def phase_new_kernels(device, scale=16, edge_factor=16, seed=7):
    """Phase 12: K1's recv_final and packed-key cases and the push kernel
    (K6/K7) against their plain versions."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.ops.spmv2 import spmv_push, spmv_push_reference
    from graphmat_tpu_torch.ops.spmv2u import (PROCESS_OPS, spmv,
                                               spmv_reference)
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    g = Graph(e, device=device, compact=False)
    rc, sc = g.csr("dst"), g.sender_csr("dst")   # receiver-, sender-major
    n = g.n_pad
    bits = max(int(np.ceil(np.log2(n))), 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn(n, generator=gen, device=device)
    val_r = torch.randn(rc.nnz, generator=gen, device=device)
    val_s = torch.randn(sc.nnz, generator=gen, device=device)
    w_r = torch.randint(1, 8, (rc.nnz,), generator=gen,
                        device=device).float()
    w_s = torch.randint(1, 8, (sc.nnz,), generator=gen,
                        device=device).float()
    xk = packed_keys(n, bits, gen, device)
    sent30 = (torch.rand(n, generator=gen, device=device) < 0.3).to(
        torch.uint8)
    k1_err, k1_cases = 0.0, 0
    # K1: sparse min / sum with got, recv_final at 0, 50 and 100% of rows
    for share in FINAL_SHARES:
        rf = (torch.rand(n, generator=gen, device=device) < share).to(
            torch.uint8)
        for kind, op, xx, vv in (
                [(k, o, x, val_r) for k in ("min", "sum")
                 for o in ("x", "x_mul_val", "x_add_val")]
                + [("min", "key_add_val", xk, w_r)]):
            got = kind == "sum"
            args = (rc, xx, kind, op)
            kw = dict(val=vv, sent=sent30, want_got=got, recv_final=rf,
                      bits=bits)
            out = spmv(*args, **kw)
            sync(device)
            ref = spmv_reference(*args, **kw)
            what = f"K1 {kind} {op} recv_final {share:.0%}"
            if got:
                (out, cnt), (ref, cnt_ref) = out, ref
                if not torch.equal(cnt, cnt_ref):
                    raise AssertionError(f"{what}: got counts differ")
                if share == 1.0 and bool(cnt.any()):
                    raise AssertionError(f"{what}: a final row counted")
            fin = rf.bool()
            if bool((out[fin] != {"sum": 0.0, "min": float("inf")}[kind])
                    .any()):
                raise AssertionError(f"{what}: a final row is not the "
                                     "identity")
            bound = None
            if kind == "sum":
                bound = sum_bound(rc.row.long(), rc.col.long(),
                                  PROCESS_OPS[op](xx[rc.col.long()], vv,
                                                  bits), n, sent30)
            k1_err = max(k1_err, compare_out(what, out, ref, kind, bound))
            k1_cases += 1
    out = spmv(rc, xk, "min", "key_add_val", val=w_r, bits=bits)
    sync(device)
    compare_out("K1 min key_add_val dense", out,
                spmv_reference(rc, xk, "min", "key_add_val", val=w_r,
                               bits=bits), "min")
    k1_cases += 1

    # the push kernel: dense and frontiers of 0.01%, 1% and 50% of senders
    push_err, push_cases = 0.0, 0
    frontiers = [None] + [
        (torch.rand(n, generator=gen, device=device) < f).to(torch.uint8)
        for f in FRONTIERS]
    cases = ([(k, o, x, val_s) for k in ("sum", "min", "max")
              for o in ("x", "x_mul_val", "x_add_val")]
             + [("min", "key_add_val", xk, w_s)])
    for kind, op, xx, vv in cases:
        for sent in frontiers:
            got = kind == "sum" and sent is not None
            kw = dict(val=vv, sent=sent, want_got=got, bits=bits)
            out = spmv_push(sc, xx, kind, op, **kw)
            sync(device)
            ref = spmv_push_reference(sc, xx, kind, op, **kw)
            what = (f"push {kind} {op} "
                    + ("dense" if sent is None
                       else f"{float(sent.float().mean()):.2%} sent"))
            if got:
                (out, cnt), (ref, cnt_ref) = out, ref
                if not torch.equal(cnt, cnt_ref):
                    raise AssertionError(f"{what}: got counts differ")
            bound = None
            if kind == "sum":
                bound = sum_bound(sc.col.long(), sc.row.long(),
                                  PROCESS_OPS[op](xx[sc.row.long()], vv,
                                                  bits), n, sent)
            push_err = max(push_err, compare_out(what, out, ref, kind,
                                                 bound))
            push_cases += 1
    # the two kernels compute one function: K1 equals the push, bitwise
    for kind in ("min", "max"):
        for sent in (None, sent30):
            a = spmv(rc, x, kind, "x", sent=sent)
            b = spmv_push(sc, x, kind, "x", sent=sent)
            sync(device)
            compare_out(f"K1 against the push, {kind}", a, b, kind)
    log(f"phase 12: RMAT-{scale} x{edge_factor}: n={g.n} nnz={rc.nnz}; K1 "
        f"agrees in {k1_cases} recv_final/packed-key cases (max |err| "
        f"{k1_err:.3e}); the push kernel agrees in {push_cases} cases "
        f"(max |err| {push_err:.3e}); min/max and counts bitwise")
    return k1_err, push_err


HUB_EDGES = 1 << 20   # the hub sender's out- and hub receiver's in-degree


def hub_edgelist(device, scale=16, edge_factor=16, seed=7):
    """A graph where the kernels' split paths really run: RMAT-``scale``
    (ids below 2^scale), one sender with HUB_EDGES out-edges and one
    receiver with HUB_EDGES in-edges, receivers and senders of exactly 16,
    17, 32, 33, 64, 65, C and C + 1 edges (each width's limit and one
    past it; C the kernels' chunk), and empty rows above them.  Returns
    (EdgeList, hub sender, hub receiver), the hubs 0-based."""
    import torch
    from graphmat_tpu_torch import EdgeList
    from graphmat_tpu_torch.ops.spmv2u import CHUNK_EDGES
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    base = HUB_EDGES
    hub_s, hub_r = base + 1, base + 2
    span = torch.arange(HUB_EDGES, device=device)
    src = [e.src.long() - 1, torch.full_like(span, hub_s), span]
    dst = [e.dst.long() - 1, span, torch.full_like(span, hub_r)]
    for i, ln in enumerate((16, 17, 32, 33, 64, 65, CHUNK_EDGES,
                            CHUNK_EDGES + 1)):
        peers = torch.randperm(HUB_EDGES, generator=gen, device=device)[:ln]
        src += [peers, torch.full_like(peers, base + 16 + i)]
        dst += [torch.full_like(peers, base + 32 + i), peers]
    n = base + 4096
    src, dst = torch.cat(src) + 1, torch.cat(dst) + 1
    return (EdgeList(n, n, src.to(torch.int32), dst.to(torch.int32),
                     torch.ones(src.numel(), device=device)), hub_s, hub_r)


def phase_hub_kernels(device, scale=16, seed=7):
    """Phase 12, on the hub graph: K1 and the push against their plain
    versions in every reduce x op x mode (K1 with and without recv_final,
    the hub receiver's row live in one mask and final in the other); K1's
    dense sum bitwise the same over two launches; K1 and the push equal in
    min and max at BFS level 1 from the hub sender."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.ops.spmv2 import spmv_push, spmv_push_reference
    from graphmat_tpu_torch.ops.spmv2u import (PROCESS_OPS, spmv,
                                               spmv_reference)
    e, hub_s, hub_r = hub_edgelist(device, scale, seed=seed)
    g = Graph(e, device=device, compact=False)
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    n = g.n_pad
    bits = max(int(np.ceil(np.log2(n))), 1)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rand(size):
        return torch.rand(size, generator=gen, device=device)
    x = torch.randn(n, generator=gen, device=device)
    xk = packed_keys(n, bits, gen, device)
    # a sum over keys: half finite keys, half signed values that the op
    # passes through, so the hub row's sum does not grow one-signed
    xk_sum = torch.where(rand(n) < 0.5, xk.nan_to_num(posinf=0.0), x)
    vals = {}
    for name, c in (("recv", rc), ("send", sc)):
        vals[name] = (torch.randn(c.nnz, generator=gen, device=device),
                      torch.randint(1, 8, (c.nnz,), generator=gen,
                                    device=device).float())
    f1 = (rand(n) < 0.01).to(torch.uint8)
    f1[hub_s] = 1
    frontiers = {"dense": None, "1%+hub": f1,
                 "50%": (rand(n) < 0.5).to(torch.uint8)}
    finals = {}
    for live in (True, False):
        rf = (rand(n) < 0.5).to(torch.uint8)
        rf[hub_r] = 0 if live else 1
        finals["hub row " + ("live" if live else "final")] = rf

    def operand(kind, op, name):
        val, w = vals[name]
        if op != "key_add_val":
            return x, val
        return (xk_sum if kind == "sum" else xk), w

    err = {"k1": 0.0, "push": 0.0}
    cases = {"k1": 0, "push": 0}
    for kind in ("sum", "min", "max"):
        for op in PROCESS_OPS:
            for fname, sent in frontiers.items():
                got = kind == "sum" and sent is not None
                xx, vv = operand(kind, op, "recv")
                masks = {"": None} if sent is None else {"": None, **finals}
                for mname, rf in masks.items():
                    kw = dict(val=vv, sent=sent, want_got=got,
                              recv_final=rf, bits=bits)
                    out = spmv(rc, xx, kind, op, **kw)
                    sync(device)
                    ref = spmv_reference(rc, xx, kind, op, **kw)
                    what = f"hub graph K1 {kind} {op} {fname} {mname}"
                    if got:
                        (out, cnt), (ref, cnt_ref) = out, ref
                        if not torch.equal(cnt, cnt_ref):
                            raise AssertionError(f"{what}: counts differ")
                    bound = None
                    if kind == "sum":
                        terms = PROCESS_OPS[op](xx[rc.col.long()], vv, bits)
                        bound = sum_bound(rc.row.long(), rc.col.long(),
                                          terms, n, sent)
                    err["k1"] = max(err["k1"], compare_out(
                        what, out, ref, kind, bound))
                    cases["k1"] += 1
                xx, vv = operand(kind, op, "send")
                kw = dict(val=vv, sent=sent, want_got=got, bits=bits)
                out = spmv_push(sc, xx, kind, op, **kw)
                sync(device)
                ref = spmv_push_reference(sc, xx, kind, op, **kw)
                what = f"hub graph push {kind} {op} {fname}"
                if got:
                    (out, cnt), (ref, cnt_ref) = out, ref
                    if not torch.equal(cnt, cnt_ref):
                        raise AssertionError(f"{what}: counts differ")
                bound = None
                if kind == "sum":
                    terms = PROCESS_OPS[op](xx[sc.row.long()], vv, bits)
                    bound = sum_bound(sc.col.long(), sc.row.long(), terms, n,
                                      sent)
                err["push"] = max(err["push"], compare_out(
                    what, out, ref, kind, bound))
                cases["push"] += 1
    val = vals["recv"][0]
    a = spmv(rc, x, "sum", "x_mul_val", val=val)
    b = spmv(rc, x, "sum", "x_mul_val", val=val)
    sync(device)
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("hub graph: K1's dense sum differs between "
                             "two launches")
    # BFS level 1 from the hub sender: its out-neighbours send their ids
    depth1 = torch.zeros(n, dtype=torch.bool, device=device)
    depth1[sc.col[sc.rowptr[hub_s]:sc.rowptr[hub_s + 1]].long()] = True
    sent = depth1.to(torch.uint8)
    rf = (depth1 | ~g.valid_vertex).to(torch.uint8)
    rf[hub_s] = 1
    ids = torch.arange(1, n + 1, device=device).float()
    live = rf == 0
    for kind, fill in (("min", float("inf")), ("max", float("-inf"))):
        xs = ids.masked_fill(sent == 0, fill)
        a = spmv(rc, xs, kind, "x", sent=sent, recv_final=rf)
        b = spmv_push(sc, xs, kind, "x", sent=sent)
        sync(device)
        compare_out(f"hub graph BFS level 1, K1 against the push ({kind})",
                    a[live], b[live], kind)
    log(f"phase 12: hub graph n={g.n} nnz={rc.nnz} (max in-degree "
        f"{int(rc.rowptr.diff().max())}, max out-degree "
        f"{int(sc.rowptr.diff().max())}): K1 agrees in {cases['k1']} cases "
        f"(max |err| {err['k1']:.3e}), the push in {cases['push']} (max "
        f"|err| {err['push']:.3e}); min/max and counts bitwise; K1's dense "
        f"sum bitwise over two launches; K1 equals the push at BFS level 1 "
        f"({int(sent.sum())} senders)")
    return err["k1"], err["push"]


def run_cli(module, args):
    import importlib
    m = importlib.import_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m._main(args)
    return buf.getvalue()


def golden(name):
    with open(os.path.join(ROOT, "tests", "golden", name)) as f:
        return f.read()


def reset_counts():
    from graphmat_tpu_torch.ops import compact, spmv2, spmv2u
    for d in (spmv2u.LAUNCHES, spmv2.LAUNCHES, compact.LAUNCHES):
        for k in d:
            d[k] = 0


def read_counts():
    """The launches since :func:`reset_counts` that are not 0, as
    ``{"kernel.mode": n}`` (k1, push, k2)."""
    from graphmat_tpu_torch.ops import compact, spmv2, spmv2u
    return {f"{name}.{mode}": n for name, d in (
        ("k1", spmv2u.LAUNCHES), ("push", spmv2.LAUNCHES),
        ("k2", compact.LAUNCHES)) for mode, n in d.items() if n}


def launches(counts, kernel):
    return sum(n for k, n in counts.items() if k.startswith(kernel + "."))


def check_route(what, counts, route, cuda, need_final=False):
    """The run went through its route's kernel: K1 under v2u (with the
    recv_final skip where the program gives one), the push under v2."""
    if not cuda:
        return
    k1, push = launches(counts, "k1"), launches(counts, "push")
    fin = sum(n for k, n in counts.items() if k.endswith("_final"))
    ok = (k1 > 0 and push == 0 and (fin > 0 or not need_final)
          if route == "v2u" else push > 0 and k1 == 0)
    if not ok:
        raise AssertionError(f"{what} under GRAPHMAT_KERNEL={route}: "
                             f"launches {counts}")


def phase_golden_traversal(cuda=True):
    """Phase 13: the BFS, SSSP, IncPR, DeltaStepping and TopoSort CLIs
    against the reference binary's outputs, under both kernel routes."""
    os.environ["GRAPHMAT_PLATFORM"] = "cuda" if cuda else "cpu"
    mtx = os.path.join(ROOT, "data", "test.bin.mtx")
    tri = os.path.join(ROOT, "data", "2_10_upper_triangle.bin.mtx")
    apps = "graphmat_tpu_torch.apps."
    dist = r"^(\d+) : distance = (\d+)$"
    out = {}
    for route in ("v2u", "v2"):
        os.environ["GRAPHMAT_KERNEL"] = route
        reset_counts()
        ours = run_cli(apps + "bfs", [mtx, "1"])
        depth = r"^Depth (\d+) : (\d+) parent"
        if (re.findall(depth, ours, re.M)
                != re.findall(depth, golden("bfs_test_s1.txt"), re.M)
                or "Reachable vertices = 8" not in ours):
            raise AssertionError(f"golden BFS ({route}):\n{ours}")
        for name, args, gold in (
                ("sssp", [mtx, "1"], "sssp_test_s1.txt"),
                ("delta_stepping", [mtx, "3", "1"],
                 "deltastepping_test_d3_s1.txt")):
            ours = run_cli(apps + name, args)
            ref = golden(gold)
            if re.findall(dist, ours, re.M) != re.findall(dist, ref, re.M):
                raise AssertionError(f"golden {name} ({route}):\n{ours}")
        m = re.search(r"Number of buckets processed = (\d+)",
                      golden("deltastepping_test_d3_s1.txt"))
        if f"Number of buckets processed = {m[1]}" not in ours:
            raise AssertionError(f"golden buckets ({route}):\n{ours}")
        ours = run_cli(apps + "incremental_pagerank", [mtx])
        pat = r"^(\d+) : (\d+) ([\d.]+)$"
        ref_v = {int(a): (int(b), float(c)) for a, b, c in
                 re.findall(pat, golden("incpr_test.txt"), re.M)}
        our_v = {int(a): (int(b), float(c)) for a, b, c in
                 re.findall(pat, ours, re.M)}
        if len(ref_v) != 8 or set(our_v) != set(ref_v) or any(
                our_v[v][0] != d or abs(our_v[v][1] - p) >= 5e-5
                for v, (d, p) in ref_v.items()):
            raise AssertionError(f"golden IncPR ({route}):\n{ours}")
        ours = run_cli(apps + "topological_sort", [tri])
        pat = r"^Top Sort order (\d+) : (\d+)$"
        if (re.findall(pat, ours, re.M)
                != re.findall(pat, golden("toposort_2_10.txt"), re.M)):
            raise AssertionError(f"golden TopoSort ({route}):\n{ours}")
        out[route] = read_counts()
        check_route("goldens", out[route], route, cuda)
    os.environ["GRAPHMAT_KERNEL"] = "v2u"
    log(f"phase 13: golden BFS, SSSP, IncPR (5e-5), DeltaStepping and "
        f"TopoSort match under both routes; launches {out}")


def host_csr(src0, dst0, n, w=None):
    import scipy.sparse as sp
    v = np.ones(len(src0)) if w is None else w
    return sp.csr_matrix((v, (src0, dst0)), shape=(n, n))


def bfs_oracle(a, s0):
    """Depths (-1 unreached) from scipy's BFS: its predecessor forest,
    walked level by level."""
    from scipy.sparse.csgraph import breadth_first_order
    _, pred = breadth_first_order(a, s0, directed=True,
                                  return_predecessors=True)
    n = a.shape[0]
    reached = pred >= 0
    reached[s0] = True
    depth = np.full(n, -1, np.int64)
    depth[s0] = 0
    todo = reached.copy()
    todo[s0] = False
    while todo.any():
        p = pred[todo]
        ready = depth[p] >= 0
        idx = np.flatnonzero(todo)[ready]
        depth[idx] = depth[pred[idx]] + 1
        todo[idx] = False
    return np.where(reached, depth, -1)


def check_bfs(what, depth, parent, ref_depth, edge_keys, n, source):
    """Depths exactly the host BFS's; every parent an in-neighbour one
    level up (edge membership by binary search in the sorted edge keys)."""
    import torch
    from graphmat_tpu_torch.apps.bfs import INF_DEPTH
    ours = np.where(depth == INF_DEPTH, -1, depth.astype(np.int64))
    if not np.array_equal(ours, ref_depth):
        bad = np.flatnonzero(ours != ref_depth)
        raise AssertionError(f"{what}: {bad.size} depths differ from the "
                             f"host BFS, e.g. vertex {bad[0] + 1}")
    v = np.flatnonzero(ours > 0)
    p = parent[v].astype(np.int64) - 1
    if (p < 0).any() or not np.array_equal(ours[p], ours[v] - 1):
        raise AssertionError(f"{what}: a parent is not one level up")
    keys = torch.as_tensor(p * n + v, device=edge_keys.device)
    at = torch.searchsorted(edge_keys, keys).clamp_(max=edge_keys.numel() - 1)
    if not bool((edge_keys[at] == keys).all()):
        raise AssertionError(f"{what}: a parent is not an in-neighbour")
    if parent[source - 1] != -1:
        raise AssertionError(f"{what}: the source has a parent")


def kahn_levels(src0, dst0, n):
    """Host Kahn oracle, level by level: a vertex's order is its level
    (sources 0); INF_ORDER where a cycle blocks it.  Each level costs its
    frontier's out-edges (np.unique of their heads), not a pass over n."""
    from graphmat_tpu_torch.apps.topological_sort import INF_ORDER
    order = np.argsort(src0, kind="stable")
    col = dst0[order]
    rowptr = np.zeros(n + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(src0, minlength=n))
    indeg = np.bincount(dst0, minlength=n)
    out = np.full(n, INF_ORDER, np.int64)
    f = np.flatnonzero(indeg == 0)
    level = 0
    while f.size:
        out[f] = level
        lens = rowptr[f + 1] - rowptr[f]
        starts = rowptr[f] - np.concatenate([[0], np.cumsum(lens)[:-1]])
        heads, cnt = np.unique(col[np.repeat(starts, lens)
                                   + np.arange(lens.sum())],
                               return_counts=True)
        indeg[heads] -= cnt
        f = heads[indeg[heads] == 0]
        level += 1
    return out


def pagerank_fixed_point(src0, dst0, n, alpha=0.3, tol=1e-13, max_iter=400):
    """Float64 PageRank to its fixed point (a step moves no value by more
    than ``tol`` of max(1, |pr|)), on the device with index_add_ (plain
    PyTorch, none of the port): the limit of delta-PageRank."""
    import torch
    deg = torch.bincount(src0, minlength=n).double()
    got = torch.bincount(dst0, minlength=n) > 0
    pr = torch.full((n,), 0.3, dtype=torch.float64, device=src0.device)
    for it in range(max_iter):
        msg = torch.where(deg == 0, 0.0, pr / deg.clamp(min=1))
        acc = torch.zeros_like(pr).index_add_(0, dst0, msg[src0])
        new = torch.where(got, alpha + (1 - alpha) * acc, pr)
        if float(((new - pr).abs() / new.abs().clamp(min=1)).max()) < tol:
            return new, it + 1
        pr = new
    return pr, max_iter


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def run_routes(what, fn, device, need_final=False):
    """``fn()`` under GRAPHMAT_KERNEL=v2u and =v2, counts reset before
    and read after each: {route: (result, seconds, counts)}."""
    import torch
    cuda = torch.device(device).type == "cuda"
    out = {}
    for route in ("v2u", "v2"):
        os.environ["GRAPHMAT_KERNEL"] = route
        reset_counts()
        res, sec = timed(fn, device)
        out[route] = (res, sec, read_counts())
        check_route(what, out[route][2], route, cuda, need_final)
    os.environ["GRAPHMAT_KERNEL"] = "v2u"
    return out


def phase_traversal(device, scale=22, small_scale=20, edge_factor=16,
                    seed=1, graph_kw=None):
    """Phase 14: the slice at full size on both kernel routes, checked
    against host oracles.  RMAT-``scale`` (phase 5's graph): BFS from
    N_SOURCES sources, CC, TopoSort on its DAG, IncPR.  RMAT-``small_scale``
    (scipy's Dijkstra on 65M edges would take minutes): SSSP and
    DeltaStepping with bench.py's weights, and run_bfs_fast."""
    import torch
    from scipy.sparse.csgraph import connected_components, dijkstra
    from graphmat_tpu_torch import EdgeList, Graph, transforms
    from graphmat_tpu_torch.apps import (bfs, connected_components as cc,
                                         delta_stepping as ds,
                                         incremental_pagerank as ipr,
                                         sssp, topological_sort as ts)
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    gkw = graph_kw or {}
    report = {"runs_s": {}, "iterations": {}, "launches": {}}

    def note(name, routes, iters=None):
        report["runs_s"][name] = {r: v[1] for r, v in routes.items()}
        report["launches"][name] = {r: v[2] for r, v in routes.items()}
        if iters is not None:
            report["iterations"][name] = {r: iters(v[0])
                                          for r, v in routes.items()}

    e = rmat_edgelist(scale, edge_factor, a=0.57, b=0.19, c=0.19,
                      seed=seed, device=device)
    g = Graph(e, device=device, permute="degree", **gkw)
    n = g.n
    src0_d, dst0_d = e.src.long() - 1, e.dst.long() - 1
    src0, dst0 = src0_d.cpu().numpy(), dst0_d.cpu().numpy()
    edge_keys = torch.sort(src0_d * n + dst0_d)[0]
    a = host_csr(src0, dst0, n)
    outdeg = np.bincount(src0, minlength=n)
    rng = np.random.default_rng(2)
    sources = (rng.choice(np.flatnonzero(outdeg > 0), N_SOURCES,
                          replace=False) + 1).tolist()
    report["sources"] = sources

    # BFS from each source, both routes, against scipy's BFS
    t0 = time.perf_counter()
    ref = {s: bfs_oracle(a, s - 1) for s in sources}
    t_oracle = time.perf_counter() - t0
    reached_edges = {}
    for s in sources:
        routes = run_routes(f"BFS from {s}", lambda: bfs.run_bfs(g, s),
                            device, need_final=True)
        for route, ((depth, parent, niter), _, _) in routes.items():
            check_bfs(f"BFS from {s} ({route})", depth, parent, ref[s],
                      edge_keys, n, s)
        note(f"bfs_{s}", routes, lambda r: r[2])
        reached_edges[s] = int(outdeg[ref[s] >= 0].sum())
    report["bfs_reached_edges"] = reached_edges
    log(f"phase 14: BFS from {N_SOURCES} sources on RMAT-{scale} (n={n}, "
        f"nnz={g.nnz}) equals the host BFS on both routes (oracle "
        f"{t_oracle:.1f} s); levels {report['iterations']}")

    # connected components against scipy's weak components
    routes = run_routes("CC", lambda: cc.run_connected_components(g),
                        device)
    _, lab = connected_components(a, directed=True, connection="weak")
    minid = np.full(lab.max() + 1, n, np.int64)
    np.minimum.at(minid, lab, np.arange(n))
    want = minid[lab] + 1
    for route, ((labels, ncomp, _), _, _) in routes.items():
        if not np.array_equal(labels, want) or ncomp != minid.size:
            raise AssertionError(f"CC ({route}): labels differ from scipy")
    note("cc", routes, lambda r: r[2])

    # incremental PageRank against the float64 fixed point
    routes = run_routes("IncPR", lambda: ipr.run_incremental_pagerank(g),
                        device)
    fp, fp_it = pagerank_fixed_point(src0_d, dst0_d, n)
    fp = fp.cpu().numpy()
    incpr_err = {}
    for route, ((pr, _), _, _) in routes.items():
        if pr.shape != (n,) or not np.isfinite(pr).all():
            raise AssertionError(f"IncPR ({route}): not finite")
        incpr_err[route] = float(np.max(np.abs(pr - fp)
                                        / np.maximum(1.0, np.abs(fp))))
        if incpr_err[route] > INCPR_RTOL[route]:
            raise AssertionError(f"IncPR ({route}): off the float64 fixed "
                                 f"point by {incpr_err[route]}")
    note("incpr", routes, lambda r: r[1])
    report["incpr_rel_err"] = incpr_err
    del g, a, edge_keys

    # topological sort of the graph's DAG against a host Kahn oracle
    e_dag = transforms.convert_to_dag(e)
    g_dag = Graph(e_dag, device=device, permute="degree", **gkw)
    routes = run_routes("TopoSort", lambda: ts.run_topological_sort(g_dag),
                        device, need_final=True)
    t0 = time.perf_counter()
    want = kahn_levels(e_dag.src.cpu().numpy().astype(np.int64) - 1,
                       e_dag.dst.cpu().numpy().astype(np.int64) - 1, n)
    t_kahn = time.perf_counter() - t0
    for route, ((order, cyc, _), _, _) in routes.items():
        if cyc or not np.array_equal(order, want):
            raise AssertionError(f"TopoSort ({route}): orders differ from "
                                 "Kahn's")
    note("toposort", routes, lambda r: r[2])
    del g_dag, e_dag, e
    log(f"phase 14: CC ({minid.size} components) equals scipy; IncPR "
        f"within {incpr_err} of the float64 fixed point ({fp_it} "
        f"iterations); TopoSort equals Kahn's levels (oracle {t_kahn:.1f} "
        f"s) on both routes")

    # RMAT-small: SSSP and DeltaStepping against Dijkstra, fast BFS
    e2 = rmat_edgelist(small_scale, edge_factor, a=0.57, b=0.19, c=0.19,
                       seed=seed, device=device)
    w = np.random.default_rng(3).integers(1, 256, e2.nnz)
    ew = EdgeList(e2.m, e2.n, e2.src, e2.dst,
                  torch.as_tensor(w, dtype=torch.float32, device=device))
    n2 = max(e2.m, e2.n)
    s2, d2 = (e2.src.cpu().numpy().astype(np.int64) - 1,
              e2.dst.cpu().numpy().astype(np.int64) - 1)
    gw = Graph(ew, device=device, build_in_edges=False, permute="degree",
               **gkw)
    routes = run_routes("SSSP", lambda: sssp.run_sssp(gw, 1), device)
    t0 = time.perf_counter()
    dref = dijkstra(host_csr(s2, d2, n2, w.astype(np.float64)),
                    directed=True, indices=0)
    t_dij = time.perf_counter() - t0
    dref = np.where(np.isfinite(dref), dref, sssp.INF_DIST).astype(np.int64)
    for route, ((dist, _), _, _) in routes.items():
        if not np.array_equal(dist.astype(np.int64), dref):
            raise AssertionError(f"SSSP ({route}): differs from Dijkstra")
    note("sssp", routes, lambda r: r[1])
    routes = run_routes("DeltaStepping", lambda: ds.run_delta_stepping(
        ew, DELTA, 1, device=device), device, need_final=True)
    for route, ((dist, _), _, _) in routes.items():
        if not np.array_equal(dist.astype(np.int64), dref):
            raise AssertionError(f"DeltaStepping ({route}): differs from "
                                 "Dijkstra")
    note("delta_stepping", routes, lambda r: r[1])

    e2n = EdgeList(e2.m, e2.n, e2.src.cpu().numpy(), e2.dst.cpu().numpy(),
                   e2.val.cpu().numpy())
    e_aug, pred0, ind1 = bfs.build_bfs_shortcuts(e2n)
    g_aug = Graph(e_aug, device=device, build_in_edges=False,
                  permute="degree", **gkw)
    fast_keys = torch.sort(torch.as_tensor(s2 * n2 + d2, device=device))[0]
    a2 = host_csr(s2, d2, n2)
    for s in sources[:2]:
        if s > n2:
            continue
        ref2 = bfs_oracle(a2, s - 1)
        routes = run_routes(f"fast BFS from {s}", lambda: bfs.run_bfs_fast(
            g_aug, s, pred0, ind1), device, need_final=True)
        classic = bfs.run_bfs(gw, s)
        check_bfs(f"classic BFS from {s} at RMAT-{small_scale}",
                  classic[0], classic[1], ref2, fast_keys, n2, s)
        for route, ((depth, parent, _), _, _) in routes.items():
            if not np.array_equal(depth, classic[0]):
                raise AssertionError(f"fast BFS from {s} ({route}): depths "
                                     "differ from the classic BFS")
            check_bfs(f"fast BFS from {s} ({route})", depth, parent, ref2,
                      fast_keys, n2, s)
        note(f"bfs_fast_{s}", routes, lambda r: r[2])
    log(f"phase 14: RMAT-{small_scale} (n={n2}, nnz={e2.nnz}): SSSP and "
        f"DeltaStepping (delta {DELTA}) equal Dijkstra (oracle {t_dij:.1f} "
        f"s) on both routes; run_bfs_fast (bits "
        f"{max(int(np.ceil(np.log2(g_aug.n_pad))), 1)}, "
        f"{e_aug.nnz - e2.nnz} shortcut edges) equals the classic BFS")
    log("phase 14: " + json.dumps(report))
    return report, gw


def hbm_ms(nbytes):
    """The least time to move ``nbytes`` at the H100's 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def cusparse_ms(rowptr, col, x, reps=20):
    """One PyTorch call that computes a dense sum SpMV (cuSPARSE through
    a CSR tensor): a yardstick only, never called by the package."""
    import warnings
    import torch
    with warnings.catch_warnings():   # "beta state" notices
        warnings.simplefilter("ignore")
        a = torch.sparse_csr_tensor(rowptr, col, torch.ones(
            col.numel(), dtype=torch.float32, device=x.device),
            size=(rowptr.numel() - 1, x.numel()))
    xc = x[:, None]
    return event_ms(lambda: torch.sparse.mm(a, xc), reps)


def profile_run(fn, top=6):
    """One run of ``fn`` under torch.profiler after a warm-up: wall ms,
    device ms (the sum of the device events' times: kernels, copies,
    fills), the idle share of the device, and the ``top`` device events
    by time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue   # host ops: their kernels are listed themselves
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key[:70]))
    rows.sort(reverse=True)
    dev = sum(r[0] for r in rows)
    if dev == 0:
        return {"wall_ms": wall, "device_ms": "not measured"}
    return {"wall_ms": wall, "device_ms": dev,
            "device_idle_share": max(0.0, 1 - dev / wall),
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for ms, c, k in rows[:top]]}


def hub_diagnosis(g, x, reps=20):
    """Where the hubs sit and what they cost each kernel: the longest
    receiver row and the out-degree of senders 0-31 (one push tile); K1's
    dense sum on rows k and up (``rowptr[k:]`` rebased, ``col`` from its
    first edge: views, no copies) for k in 0, 32, 1024; the push's dense
    sum with and without senders 0-31, and its walk without atomics;
    cuSPARSE on the whole CSR; and how many rows and senders fall in each
    length class of K1's lane groups."""
    import torch
    from graphmat_tpu_torch.core.graph import CSR
    from graphmat_tpu_torch.ops.spmv2 import spmv_push
    from graphmat_tpu_torch.ops.spmv2u import spmv
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    in_len, out_len = rc.rowptr.diff(), sc.rowptr.diff()
    edges = torch.tensor([0, 16, 32, 64, 1024, 1 << 31], device=x.device)

    def classes(lens):
        return torch.bincount(torch.bucketize(lens.long(), edges[1:]),
                              minlength=5).tolist()

    def tail(c, k):
        e0 = int(c.rowptr[k])
        return CSR(c.rowptr[k:] - e0, c.col[e0:], c.row[e0:] - k,
                   c.val[e0:], c.n_send)
    out = {"max_in_degree": int(in_len.max()),
           "max_out_degree": int(out_len.max()),
           "tile0_out_edges": int(out_len[:32].sum()),
           "rows_by_length_le_16_32_64_1024_more": classes(in_len),
           "senders_by_length_le_16_32_64_1024_more": classes(out_len),
           "k1_dense_sum_ms_from_row": {}}
    for k in (0, 32, 1024):
        view = tail(rc, k)
        spmv(view, x, "sum", "x")   # plans, if any, are built here
        out["k1_dense_sum_ms_from_row"][k] = event_ms(
            lambda: spmv(view, x, "sum", "x"), reps)
    push_tail = tail(sc, 32)
    out["push_dense_sum_ms"] = event_ms(
        lambda: spmv_push(sc, x, "sum", "x"), reps)
    out["push_dense_sum_ms_without_tile0"] = event_ms(
        lambda: spmv_push(push_tail, x[32:], "sum", "x"), reps)
    # the same walk without atomics: max of -inf reads y at every edge
    # and never finds it can improve it
    no_gain = torch.full_like(x, float("-inf"))
    out["push_dense_max_no_atomics_ms"] = event_ms(
        lambda: spmv_push(sc, no_gain, "max", "x"), reps)
    out["cusparse_ms"] = cusparse_ms(rc.rowptr, rc.col, x, reps)
    return out


def phase_traversal_timings(card, report, gw, scale=22, edge_factor=16,
                            seed=1):
    """Phase 15: BFS per source on each route, one dense and one sparse
    BFS level on K1 and on the push kernel, the SSSP dense sweep of
    bench.py:318-334, each new kernel alone beside its plain version and
    cuSPARSE, and the bounds; from CUDA events."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import bfs, sssp
    from graphmat_tpu_torch.core.runtime import Engine
    from graphmat_tpu_torch.core.types import Activity
    from graphmat_tpu_torch.ops.spmv2 import spmv_push, spmv_push_reference
    from graphmat_tpu_torch.ops.spmv2u import spmv, spmv_reference
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    torch.cuda.reset_peak_memory_stats()
    e = rmat_edgelist(scale, edge_factor, a=0.57, b=0.19, c=0.19,
                      seed=seed, device="cuda")
    g = Graph(e, device="cuda", permute="degree")
    del e
    out = {"card": card, "bfs_ms": {}, "bfs_gteps": {}}
    sources = report["sources"]
    for route in ("v2u", "v2"):
        os.environ["GRAPHMAT_KERNEL"] = route
        eng = Engine(bfs.BFSProgram(), g)
        ms = []
        for s in sources:
            def one():
                bfs.init_bfs_graph(g, s)
                eng.run()
            one()   # warm
            ms.append(event_ms(one, 1, warm=0))
        out["bfs_ms"][route] = ms
        out["bfs_gteps"][route] = [
            report["bfs_reached_edges"][s] / (t * 1e-3) / 1e9
            for s, t in zip(sources, ms)]
    os.environ["GRAPHMAT_KERNEL"] = "v2u"

    # one dense and one sparse level of the last BFS, on each kernel
    depth = g.vp["depth"]
    levels = torch.bincount(depth[depth != bfs.INF_DEPTH].long())
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    fr_edges = torch.zeros_like(levels)
    outdeg = sc.rowptr.diff()
    for lv in range(levels.numel()):
        fr_edges[lv] = outdeg[depth == lv].sum()
    dense_lv = int(torch.argmax(fr_edges))
    sparse_lv = int(levels.numel() - 2 if levels.numel() > 2 else 0)
    x_ids = torch.arange(1, g.n_pad + 1, device="cuda").float()
    lv_out = {}
    for name, lv in (("dense", dense_lv), ("sparse", sparse_lv)):
        sent = (depth == lv).to(torch.uint8)
        x = x_ids.masked_fill(sent == 0, float("inf"))
        rf = ((depth <= lv) | ~g.valid_vertex).to(torch.uint8)
        k1 = lambda: spmv(rc, x, "min", "x", sent=sent, recv_final=rf)
        push = lambda: spmv_push(sc, x, "min", "x", sent=sent)
        a, b = k1(), push()
        live = rf == 0
        if not torch.equal(a[live], b[live]):
            raise AssertionError(f"BFS level {lv}: K1 and push differ")
        senders = int(sent.sum())
        # the level's least bytes: each frontier edge's receiver, the sent
        # mask, each sender's rowptr pair and x, y written once
        nbytes = (4 * int(fr_edges[lv]) + g.n_pad + 12 * senders
                  + 4 * g.n_pad)
        lv_out[name] = {
            "level": lv, "senders": senders,
            "frontier_edges": int(fr_edges[lv]),
            "final_rows": int(rf.sum()), "bound_ms": hbm_ms(nbytes),
            "k1_recv_final_ms": event_ms(k1, 20),
            "k1_no_recv_final_ms": event_ms(
                lambda: spmv(rc, x, "min", "x", sent=sent), 20),
            "push_ms": event_ms(push, 20),
            "k1_plain_ms": event_ms(lambda: spmv_reference(
                rc, x, "min", "x", sent=sent, recv_final=rf), 3, warm=1),
            "push_plain_ms": event_ms(lambda: spmv_push_reference(
                sc, x, "min", "x", sent=sent), 3, warm=1)}
    out["bfs_level"] = lv_out
    for route in ("v2u", "v2"):
        os.environ["GRAPHMAT_KERNEL"] = route
        eng = Engine(bfs.BFSProgram(), g)

        def one_bfs():
            bfs.init_bfs_graph(g, sources[0])
            eng.run()
        out[f"bfs_profile_{route}"] = profile_run(one_bfs)
    os.environ["GRAPHMAT_KERNEL"] = "v2u"

    # the push kernel alone: dense sum at the slice's shape, its plain
    # version, cuSPARSE, and its bound (rowptr, col, x, y once)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = torch.rand(g.n_pad, generator=gen, device="cuda")
    out["hub_diagnosis"] = hub_diagnosis(g, x)
    push_dense = lambda: spmv_push(sc, x, "sum", "x")
    push_ms = event_ms(push_dense, 20)
    push_plain_ms = event_ms(lambda: spmv_push_reference(sc, x, "sum", "x"),
                             3, warm=1)
    ref = spmv_push_reference(sc, x, "sum", "x")
    err = compare_out("push dense sum at the slice's shape", push_dense(),
                      ref, "sum", sum_bound(sc.col.long(), sc.row.long(), x[
                          sc.row.long()], g.n_pad))
    push_bytes = 4 * (sc.rowptr.numel() + sc.nnz + 2 * g.n_pad)
    out["push_dense_sum"] = {
        "ms": push_ms, "plain_ms": push_plain_ms,
        "cusparse_ms": cusparse_ms(rc.rowptr, rc.col, x),
        "bound_ms": hbm_ms(push_bytes), "bytes": push_bytes,
        "max_abs_err": err}
    sent = (torch.rand(g.n_pad, generator=gen, device="cuda") < 0.01).to(
        torch.uint8)
    out["push_sparse_min_1pct_ms"] = event_ms(
        lambda: spmv_push(sc, x, "min", "x", sent=sent), 20)
    out["k1_sparse_min_1pct_ms"] = event_ms(
        lambda: spmv(rc, x, "min", "x", sent=sent), 20)
    del g, rc, sc

    # SSSP dense sweeps (bench.py:318-334) on the RMAT-20 weighted graph
    class DenseSSSP(sssp.SSSPProgram):
        activity = Activity.ALL_VERTICES
    sweeps = {}
    for route in ("v2u", "v2"):
        os.environ["GRAPHMAT_KERNEL"] = route
        eng = Engine(DenseSSSP(), gw)

        def run():
            sssp.init_sssp_graph(gw, 1)
            gw.set_all_active()
            eng.run(iterations=SSSP_ITERS)
        sweeps[route] = event_ms(run, 3, warm=1)
    os.environ["GRAPHMAT_KERNEL"] = "v2u"
    out["sssp_dense_ms"] = sweeps
    out["sssp_gteps"] = {r: gw.nnz * SSSP_ITERS / (t * 1e-3) / 1e9
                         for r, t in sweeps.items()}
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log("phase 15 (" + card + "): " + json.dumps(out))
    return out


# ------------------------------------------ the ACTIVE_ONLY K-wide route

SPARSE_SHARES = (1.0, 0.1, 0.01, 1e-4)   # shares of senders sent (phase 16)
ACTIVE_SHARES = (1.0, 0.1, 0.01)         # frontiers of phase 17
LOCKSTEP_ITERS = 5
CHANGED_TOL = 1e-7   # SGDProgram.changed's threshold


def phase_sparse_kernels(device, users=60_000, items=20_000,
                         ratings=1_000_000, seed=17):
    """Phase 16: K3's sparse mode (K4 with K5's got count) against its
    plain version, every op at K = 1, 20 and 40 with 100%, 10%, 1% and
    0.01% of senders sent, on phase 7's graph: counts exact, rows without
    a sent edge exactly 0, at 100% the dense mode's bits; K5's function
    through K1's op ``x`` against ``ops/spmv.py``'s plain version (min
    and max bitwise, the sum within the row bound)."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.ops import spmv as k5
    e = ratings_edgelist(users, items, ratings, seed, device)
    e.val = torch.ceil(e.val)   # integer counts, which lda_init needs
    g = Graph(e, device=device, build_in_edges=False, compact=False)
    csr = g.csr("dst")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"alpha": 1.0, "eta": 5.0, "vocab_size": items}
    worst, cases = 0.0, 0
    for k in (1, 20, 40):
        for op in K3_OPS:
            x, vp, extra = k3_inputs(op, k, g.n_pad, gen, device)
            for share in SPARSE_SHARES:
                sent = (torch.rand(g.n_pad, generator=gen, device=device)
                        < share).to(torch.uint8)
                worst = max(worst, check_k3_case(csr, op, x, vp, extra,
                                                 params, device, sent=sent))
                cases += 1
    colx, rowx = csr.col.long(), csr.row.long()
    k5_err = 0.0
    for kind in ("sum", "min", "max"):
        x = (torch.rand(g.n_pad, generator=gen, device=device) < 0.1).float()
        if kind != "sum":
            x = torch.randn(g.n_pad, generator=gen, device=device)
        out = k5.spmv(csr, x, kind)
        sync(device)
        k5_err = max(k5_err, compare_out(
            f"K5 {kind} through K1 op x", out,
            k5.spmv_reference(csr, x, kind), kind,
            sum_bound(rowx, colx, x[colx], csr.n_rows)))
    log(f"phase 16: K3's sparse mode agrees in {cases} cases on n={g.n} "
        f"nnz={csr.nnz} (max |err| {worst:.3e}; counts exact, 100% sent "
        f"bitwise the dense mode); K5 through K1 op x in sum, min, max "
        f"(max |err| {k5_err:.3e})")
    return worst, k5_err


def active_only(cls):
    """``cls`` with ``activity = ACTIVE_ONLY`` (the JAX tests' pattern)."""
    return type(f"ActiveOnly{cls.__name__}", (cls,),
                {"activity": type(cls.activity).ACTIVE_ONLY})


def sqerr_oracle(src0, dst0, val, n, lv, sent):
    """Float64 ACTIVE_ONLY RMSE (IN_EDGES: a user receives from the items
    it rated) from the frontier ``sent``: (per-vertex squared error, the
    scale of its float32 rounding, got)."""
    import torch
    v = val.double()
    sq = torch.zeros(n, dtype=torch.float64, device=lv.device)
    scale = torch.zeros_like(sq)
    got = torch.zeros(n, dtype=torch.bool, device=lv.device)
    for c in chunked(len(v)):
        ok = sent[dst0[c]]
        s, r = dst0[c][ok], src0[c][ok]
        prod = lv[s] * lv[r]
        err = v[c][ok] - prod.sum(1)
        sq.index_add_(0, r, err * err)
        # err^2 and the dot product's rounding carried through it
        scale.index_add_(0, r, err * err + err.abs() * prod.abs().sum(1))
        got[r] = True
    return sq, scale, got


def sparse_bound(csr, sent, k, out_cols, ops_per_edge):
    """The least time of one sparse-mode call: the bytes the function must
    move (rowptr and every col, to find the sent edges; the sent flags;
    the sent edges' values; each sent sender's row of x and each receiving
    row of vp once; y and the count) against its operations on the sent
    edges at the float32 rate.  Returns (ms, bound_by, sent edges)."""
    import torch
    colx = csr.col.long()
    on = sent[colx].bool()
    n_edges = int(on.sum())
    senders = int(torch.unique(colx[on]).numel())
    rows = int((torch.zeros(csr.n_rows, dtype=torch.int32,
                            device=sent.device)
                .index_add_(0, csr.row.long(), on.int()) > 0).sum())
    nbytes = (4 * (csr.rowptr.numel() + csr.nnz + n_edges)
              + sent.numel() + 4 * k * (senders + rows)
              + 4 * (out_cols + 1) * csr.n_rows)
    ops_ms = ops_per_edge * n_edges / FP32_FLOPS * 1e3
    by = "bytes" if hbm_ms(nbytes) >= ops_ms else "operations"
    return max(hbm_ms(nbytes), ops_ms), by, n_edges


def phase_active_vec(device, card, users, items, ratings, k=20, seed=31,
                     timings=None):
    """Phase 17: ACTIVE_ONLY SGD and RMSE at MovieLens-25M shape on K3's
    sparse mode, through ``Engine.step_once``: (a) one SGD step from
    seeded frontiers of 100%, 10% and 1% of the vertices against the
    float64 oracle (at 100%, the ALL_VERTICES step's bits); (b) RMSE from
    a 10% frontier against a float64 oracle; (c) five SGD steps in
    lock-step with the plain route; (d) timings (by default on the card
    only: they need CUDA events).  Returns the main path's launch counts,
    the worst kernel error and the results."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import sgd
    from graphmat_tpu_torch.core import runtime
    from graphmat_tpu_torch.ops import spmv as k5
    from graphmat_tpu_torch.ops import spmv_vec as ss
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    e = ratings_edgelist(users, items, ratings, seed, device)
    g = Graph(e, device=device, permute=False)
    n = g.n
    src0, dst0 = e.src.long() - 1, e.dst.long() - 1
    sgd.init_sgd_graph(g, k)
    vp0 = g.vp
    lv0 = vp0["lv"][:n].clone()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    frontier = {p: torch.rand(n, generator=gen, device=device) < p
                for p in ACTIVE_SHARES}
    eng = runtime.Engine(active_only(sgd.SGDProgram)(k=k), g)
    eng_rmse = runtime.Engine(active_only(sgd.RMSEProgram)(k=k), g)

    def start(mask):
        g.vp = vp0
        g.set_active_mask(mask)

    for d in (ss.LAUNCHES, sv.LAUNCHES):
        for op in d:
            d[op] = 0
    # (a) one SGD step from each frontier against the float64 oracle
    res = {"card": card, "a": {}}
    for p in ACTIVE_SHARES:
        start(frontier[p])
        eng.step_once()
        lv = g.vp["lv"][:n]
        lv_o, _, _ = sgd_oracle(src0, dst0, e.val, n, lv0, 1,
                                sent=frontier[p])
        err = float((lv.double() - lv_o).abs().max())
        still = (lv_o == lv0.double()).all(1)
        if err > SGD_LV_ATOL or not torch.equal(lv[still], lv0[still]):
            raise AssertionError(f"phase 17a ({p:.0%} active): factors off "
                                 f"the f64 oracle by {err}, or a vertex "
                                 "without a message moved")
        res["a"][f"{p:g}"] = {"active": int(frontier[p].sum()),
                              "moved": int((~still).sum()),
                              "max_abs_err": err}
        if p == 1.0:
            lv_all = lv.clone()

    # (b) RMSE from a 10% frontier (ROADMAP R4: K4 would add val^2 for
    # every item that did not send)
    start(frontier[0.1])
    eng_rmse.step_once()
    sq = g.vp["sqerr"][:n].double()
    sq_o, scale, got_o = sqerr_oracle(src0, dst0, e.val, n, lv0.double(),
                                      frontier[0.1])
    bad = (sq - sq_o).abs() > SUM_RTOL * scale
    if bool(bad.any()) or bool((sq[~got_o] != 0).any()):
        i = int(torch.argmax((sq - sq_o).abs() - SUM_RTOL * scale))
        raise AssertionError(f"phase 17b: RMSE at vertex {i} is "
                             f"{float(sq[i])}, oracle {float(sq_o[i])}")
    n_sent = int(frontier[0.1][dst0].sum())
    rmse, rmse_o = (float(torch.sqrt(t.sum() / n_sent)) for t in (sq, sq_o))
    if abs(rmse - rmse_o) > SGD_RMSE_RTOL * rmse_o:
        raise AssertionError(f"phase 17b: RMSE {rmse}, oracle {rmse_o}")
    res["b"] = {"rmse": rmse, "rmse_oracle": rmse_o, "sent_edges": n_sent,
                "receivers": int(got_o.sum())}

    # (c) five SGD steps, each from the kernel route's state on both
    # routes: the per-direction sums, the counts and the next frontier
    def recording(fn, log):
        def run(*a, **kw):
            out = fn(*a, **kw)
            log.append(out)
            return out
        return run
    kernel_fn = runtime.spmv_vec_sparse
    start(frontier[0.1])
    lock = []
    try:
        for it in range(LOCKSTEP_ITERS):
            vp_in, act_in = g.vp, g.active.clone()
            rec_k, rec_p = [], []
            runtime.spmv_vec_sparse = recording(kernel_fn, rec_k)
            eng.step_once()
            vp_k, act_k = g.vp, g.active
            g.vp, g.active = vp_in, act_in.clone()
            runtime.spmv_vec_sparse = recording(
                ss.spmv_vec_sparse_reference, rec_p)
            eng.step_once()
            vp_p, act_p = g.vp, g.active
            sent = (act_in & g.valid_vertex).to(torch.uint8)
            err = 0.0
            for recv, (yk, ck), (yp, cp) in zip(eng._receivers, rec_k,
                                                rec_p):
                what = f"phase 17c step {it} ({recv})"
                if not torch.equal(ck, cp):
                    raise AssertionError(f"{what}: got counts differ")
                bound = k3_row_scale(g.csr(recv), "sgd", vp_in["lv"],
                                    vp_in["lv"], None, {}, sent) * SUM_RTOL
                d = (yk - yp).abs()
                if not bool((d <= bound).all()):
                    raise AssertionError(f"{what}: a sum is off by "
                                         f"{float((d - bound).max())} past "
                                         "its bound")
                err = max(err, float(d.max()))
            lv_in, lv_k, lv_p = vp_in["lv"], vp_k["lv"], vp_p["lv"]
            # a frontier may differ only where the routes' factors differ
            # and the change lies within two float32 ulps of the threshold
            near = (((lv_p - lv_in).abs().amax(1) - CHANGED_TOL).abs()
                    <= 2 * 2.0 ** -23 * lv_in.abs().amax(1).clamp(min=1.0))
            free = near & (lv_k != lv_p).any(1)
            flips = act_k != act_p
            if bool((flips & ~free).any()):
                raise AssertionError(f"phase 17c step {it}: the next "
                                     f"frontiers differ at "
                                     f"{int((flips & ~free).sum())} "
                                     "vertices clear of the threshold")
            lock.append({"active": int(sent.sum()),
                         "next_active": int(act_k.sum()),
                         "frontier_flips_at_threshold": int(flips.sum()),
                         "max_abs_err": err})
            g.vp, g.active = vp_k, act_k
    finally:
        runtime.spmv_vec_sparse = kernel_fn
    res["c"] = lock
    path = dict(ss.LAUNCHES)
    log(f"phase 17: launches over (a)-(c): sparse mode {path}, dense K3 "
        f"{dict(sv.LAUNCHES)}")
    if cuda and (path["sgd"] < 2 * (len(ACTIVE_SHARES) + LOCKSTEP_ITERS)
                 or path["sgd_sqerr"] < 1 or any(sv.LAUNCHES.values())):
        raise AssertionError("phase 17: the main path missed the sparse "
                             "mode, or ran dense K3")
    worst = max([r["max_abs_err"] for r in lock])
    # (a) at 100%: the ALL_VERTICES step on dense K3 gives the same bits
    start(frontier[1.0])
    runtime.Engine(sgd.SGDProgram(k=k), g).step_once()
    if not torch.equal(g.vp["lv"][:n], lv_all):
        raise AssertionError("phase 17a: with every vertex active the "
                             "ACTIVE_ONLY step differs from the "
                             "ALL_VERTICES one")
    if not (cuda if timings is None else timings):
        return path, worst, res

    # (d) timings, one direction (users -> items), from CUDA events
    csr = g.csr("dst")
    lv = g.vp["lv"]
    t = {"dense_k3_ms": event_ms(lambda: sv.spmv_vec(csr, lv, "sgd",
                                                     vp=lv), 10)}
    for p in SPARSE_SHARES:
        sent = (torch.rand(g.n_pad, generator=gen, device=device)
                < p).to(torch.uint8)
        bound, by, n_edges = sparse_bound(csr, sent, k, k, 4 * k)
        t[f"sparse_{p:g}"] = {
            "sent_edges": n_edges,
            "ms": event_ms(lambda: ss.spmv_vec_sparse(csr, lv, "sgd", sent,
                                                      vp=lv), 10),
            "plain_ms": event_ms(lambda: ss.spmv_vec_sparse_reference(
                csr, lv, "sgd", sent, vp=lv), 3, warm=1),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": check_k3_case(csr, "sgd", lv, lv, None, {},
                                         device, sent=sent)}
    worst = max([worst] + [t[f"sparse_{p:g}"]["max_abs_err"]
                           for p in SPARSE_SHARES])
    step = {}
    for p in ACTIVE_SHARES:
        def one():
            start(frontier[p])
            eng.step_once()

        def plain():
            runtime.spmv_vec_sparse = ss.spmv_vec_sparse_reference
            try:
                one()
            finally:
                runtime.spmv_vec_sparse = kernel_fn
        step[f"{p:g}"] = {"kernel_ms": event_ms(one, 5),
                          "plain_ms": event_ms(plain, 3, warm=1)}
    t["step"] = step
    # K5's function alone (the got count of a 10% frontier) through K1's
    # op x, its plain version and cuSPARSE, a yardstick never called
    sentf = (torch.rand(g.n_pad, generator=gen, device=device)
             < 0.1).float()
    rowx, colx = csr.row.long(), csr.col.long()
    got_err = compare_out("K5 got count at the slice's shape",
                          k5.spmv(csr, sentf, "sum"),
                          k5.spmv_reference(csr, sentf, "sum"), "sum",
                          sum_bound(rowx, colx, sentf[colx], csr.n_rows))
    t["k5"] = {
        "ms": event_ms(lambda: k5.spmv(csr, sentf, "sum"), 20),
        "plain_ms": event_ms(lambda: k5.spmv_reference(csr, sentf, "sum"),
                             5),
        "cusparse_ms": cusparse_ms(csr.rowptr, csr.col, sentf),
        "bound_ms": hbm_ms(4 * (csr.rowptr.numel() + csr.nnz + csr.n_send
                                + csr.n_rows)),
        "max_abs_err": got_err}
    t["max_memory_allocated_bytes"] = (torch.cuda.max_memory_allocated()
                                       if cuda else None)
    res["d"] = t
    log("phase 17 (" + card + "): " + json.dumps(res))
    return path, worst, res


def kernel_record(name, source, replaces, launches, err, ms, plain_ms,
                  bound_ms, bound_by, library_ms):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main(argv=None):
    """With no arguments, every phase and the two result lines.  Phase
    numbers as arguments run phases 1-2 and those (with the phases they
    need) and print no result lines: a shorter call for finding faults."""
    import torch
    only = {int(a) for a in (sys.argv[1:] if argv is None else argv)}
    needs = {6: {5}, 11: {9, 10}, 15: {14}}

    def want(ph):
        return not only or ph in only or any(
            ph in needs.get(o, ()) for o in only)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    from graphmat_tpu_torch.ops import _lib
    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.load()
    log(f"phase 2: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({lib_path.name})")
    log(lib_path.with_suffix(".log").read_text().strip())

    k1_err = k3_err = push_err = 0.0
    if want(3):
        k1_err = phase_kernels("cuda")
    if want(4):
        phase_golden("cuda")
    if want(5):
        e, g, niter, k1, k2 = phase_slice("cuda")
    if want(6):
        t, k1_err_slice = phase_timings(e, g, card)
        k1_err = max(k1_err, k1_err_slice)
    if want(5):
        del e, g

    if want(7):
        k3_err = phase_k3("cuda")
    if want(8):
        phase_golden_ml("cuda")
    if want(9):
        _, g_sgd, k3_sgd, sgd_run = phase_sgd(
            "cuda", MOVIELENS_25M["users"], MOVIELENS_25M["items"],
            MOVIELENS_25M["ratings"])
    if want(10):
        _, g_lda, gn_lda, k3_lda, lda_run = phase_lda(
            "cuda", NYTIMES["docs"], NYTIMES["terms"], NYTIMES["entries"])
    if want(11):
        t3, k3_err_slice = phase_ml_timings(g_sgd, g_lda, gn_lda, card)
        k3_err = max(k3_err, k3_err_slice)
        log("phase 11: " + json.dumps({"card": card, "sgd": sgd_run,
                                       "lda": lda_run}))
    if want(9):
        del g_sgd
    if want(10):
        del g_lda

    if want(12):
        k1_err_new, push_err = phase_new_kernels("cuda")
        k1_err_hub, push_err_hub = phase_hub_kernels("cuda")
        k1_err = max(k1_err, k1_err_new, k1_err_hub)
        push_err = max(push_err, push_err_hub)
    if want(13):
        phase_golden_traversal()
    if want(14):
        trav, gw = phase_traversal("cuda")
    if want(15):
        t4 = phase_traversal_timings(card, trav, gw)
        push_err = max(push_err, t4["push_dense_sum"]["max_abs_err"])
    if want(14):
        del gw

    k4_err = k5_err = 0.0
    if want(16):
        k4_err, k5_err = phase_sparse_kernels("cuda")
    if want(17):
        k4_path, k4_err_slice, t5 = phase_active_vec(
            "cuda", card, MOVIELENS_25M["users"], MOVIELENS_25M["items"],
            MOVIELENS_25M["ratings"])
        k4_err = max(k4_err, k4_err_slice)
        k5_err = max(k5_err, t5["d"]["k5"]["max_abs_err"])
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    if only:
        return

    def total(kernel):
        """Launches of ``kernel`` over phase 14's runs."""
        return sum(launches(c, kernel) for routes in
                   trav["launches"].values() for c in routes.values())
    k1_path = sum(k1.values()) + total("k1")
    k2_path = k2["aux_gather"] + total("k2")
    log(card)
    pd = t4["push_dense_sum"]
    sp, k5t = t5["d"]["sparse_0.1"], t5["d"]["k5"]
    kernels = {"kernels": [
        kernel_record(
            "spmv2u", "graphmat_tpu_torch/csrc/spmv2u.cu",
            "graphmat_tpu/ops/pallas_spmv2u.py:918", k1_path, k1_err,
            t["k1_dense_sum_ms"], t["k1_dense_sum_plain_ms"],
            t["k1_bound_ms"], "bytes", t["k1_cusparse_ms"]),
        kernel_record(
            "aux_gather", "graphmat_tpu_torch/csrc/compact.cu",
            "graphmat_tpu/ops/pallas_compact.py:408", k2_path, 0.0,
            t["k2_ms"], t["k2_plain_ms"], t["k2_bound_ms"], "bytes",
            t["k2_index_select_ms"]),
        kernel_record(
            "spmv_vec2", "graphmat_tpu_torch/csrc/spmv_vec2.cu",
            "graphmat_tpu/ops/pallas_spmv_vec2.py:510",
            sum(k3_sgd.values()) + sum(k3_lda.values()), k3_err,
            t3["k3_ms"]["sgd_ms"], t3["k3_ms"]["sgd_plain_ms"],
            t3["k3_ms"]["sgd_bound_ms"], t3["k3_ms"]["sgd_bound_by"], None),
        kernel_record(
            "spmv2", "graphmat_tpu_torch/csrc/spmv2.cu",
            "graphmat_tpu/ops/pallas_spmv2.py:388 and :1154",
            total("push"), push_err, pd["ms"],
            pd["plain_ms"], pd["bound_ms"], "bytes", pd["cusparse_ms"]),
        # K4: the sparse mode, sgd, one direction, 10% of senders sent
        kernel_record(
            "spmv_vec2_sparse", "graphmat_tpu_torch/csrc/spmv_vec2.cu",
            "graphmat_tpu/ops/pallas_spmv_vec.py:65",
            sum(k4_path.values()), k4_err, sp["ms"], sp["plain_ms"],
            sp["bound_ms"], sp["bound_by"], None),
        # K5: fused into every sparse-mode launch as its got count; timed
        # alone as K1 with op x over the sent bits of a 10% frontier
        kernel_record(
            "spmv_vec2_sparse got count (alone: spmv2u op x)",
            "graphmat_tpu_torch/csrc/spmv_vec2.cu and "
            "graphmat_tpu_torch/csrc/spmv2u.cu",
            "graphmat_tpu/ops/pallas_spmv.py:254",
            sum(k4_path.values()), k5_err, k5t["ms"], k5t["plain_ms"],
            k5t["bound_ms"], "bytes", k5t["cusparse_ms"]),
    ]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
