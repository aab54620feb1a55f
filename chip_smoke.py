#!/usr/bin/env python3
"""Smoke test of graphmat_tpu_torch on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``graphmat_tpu_torch/csrc`` and
drives the port's apps at full size on the card against float64 or host
oracles: PageRank (K1, K2), SGD and LDA (K3), the scalar frontier apps
(BFS, SSSP, connected components, topological sort, incremental
PageRank, delta-stepping) on both kernel routes (K1 with its
receiver-finality skip, ``GRAPHMAT_KERNEL=v2u``, and the push kernel for
K6/K7, ``GRAPHMAT_KERNEL=v2``), ACTIVE_ONLY K-wide programs on K3's
sparse mode, TriangleCounting and GetNeighbors, the 2D-sharded engine,
the push's sums in K1's fixed order, the converter and the last modules
(the generic ⊕, the native text parser, the twin of the entry points,
the debug validators); each app's launches are counted.  Then it times
every kernel alone (the ``kernels`` line).  Each kernel against its
plain version on crafted inputs is ``tests/test_torch_cuda.py``'s job,
and peaks and bounds come from ``perfbench/roofline.py``.
Phases, in this order but for 17 and 24, which run after 10 (phase 24
times the kernels on the graphs of phases 5, 9, 10 and 17, which are
then freed, so that phases 13 on run without them); any failure raises
and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the software;
2. the kernel build and the host library's (``g++``), timed;
4. the golden file: the PageRank CLI on ``data/test.bin.mtx`` against the
   reference binary's output in ``tests/golden/pagerank_test.txt``;
5. the slice at full size: RMAT scale 22, edge factor 16, seed 1, drawn
   and deduplicated on the card in the JAX package's stream (the RMAT
   kernel, counted; the edge count and a hash against RMAT_GOLDEN, taken
   from the JAX package's ``gm_rmat_gen``), a degree-permuted Graph with
   compaction on (``compact=True``), ``run_pagerank`` to convergence; the
   launch counts of both kernels over that run (one K2 launch for each K1
   call); the result against a float64 PageRank computed on the host
   with ``scipy.sparse`` for the same number of iterations;
8. the SGD and LDA CLIs on ``data/ratings7.bin.mtx`` against the
   reference binary's outputs in ``tests/golden``;
9. SGD at MovieLens-25M shape (162,541 users, 59,047 rated items,
   25,000,095 half-star ratings, drawn uniformly on the card): ``run_sgd``
   at K = 20 (init RMSE, 10 iterations, RMSE) with K3's and the rand_r
   draw's launch counts, the initial factors bitwise glibc ``rand_r``'s,
   against a float64 oracle run on the card in edge chunks;
10. LDA at the shape of the UCI NYTimes bag of words (300,000 documents,
    102,660 terms, 69,679,427 document-term counts, min(zipf(2), 50)):
    ``run_lda`` at K = 20 for 10 iterations with K3's launch count,
    against a chunked float64 oracle on the card;
13. the BFS, SSSP, IncPR, DeltaStepping and TopoSort CLIs against the
    reference binary's outputs in ``tests/golden``, under both routes;
14. the slice at full size, both routes, counted per run: on phase 5's
    RMAT-22 graph BFS from 8 sources (depths equal to scipy's BFS, each
    parent an in-neighbour one level up), connected components (equal to
    scipy's weak components), TopoSort of its DAG (equal to a host Kahn
    oracle) and IncPR (against the float64 PageRank fixed point); on an
    RMAT-20 with bench.py's weights SSSP and DeltaStepping (equal to
    scipy's Dijkstra) and ``run_bfs_fast`` (equal to the classic BFS);
17. ACTIVE_ONLY subclasses of SGDProgram and RMSEProgram at MovieLens-25M
    shape, K = 20, through ``Engine.step_once``: one SGD step from seeded
    frontiers of 100%, 10% and 1% of the vertices against a float64
    oracle of the masked step (at 100%, bitwise the ALL_VERTICES step);
    RMSE from a 10% frontier against a float64 oracle (no term from a
    sender that did not send, ROADMAP R4); five SGD steps in lock-step
    with the plain route (sums, counts, next frontier); the sparse mode's
    launch count over those runs;
19. TriangleCounting and GetNeighbors: (b) the TC CLI on
    ``data/2_10_upper_triangle.bin.mtx`` on the engine and the bucketed
    route against ``tests/golden/tc_2_10.txt``; (c) RMAT-22 x 16, seed 1,
    upper-triangular on the card: ``run_triangle_counting`` with "auto"
    (the bucketed route, T1 and T2 launched, counted over the run), its
    total and per-vertex counts exactly the host route's (numpy prep),
    RMAT-16's total equal to scipy's; on a uniform graph of 2^20
    vertices (undirected average degree 16) ``run_get_neighbors``
    against a numpy oracle and the engine route's total against the
    bucketed one;
20. the 2D-sharded engine (``graphmat_tpu_torch.parallel``), its tiles
    on this one card: (a) on RMAT-16 x 16, LocalMeshes of 2x2 and 2x4
    tiles, each route against the one-device Engine on the card: K1's
    dense sum and sparse sum with got (PageRank, 1e-5), its sparse min
    with recv_final (BFS from 4 sources, SSSP, CC, DeltaStepping:
    exact), the push (``GRAPHMAT_KERNEL=v2``: BFS exact, PageRank to
    convergence in K1's count of steps with K1's vector bit for bit), K3
    (SGD at 1M ratings, LDA at 100k entries) and its sparse mode
    (ACTIVE_ONLY SGD from a 10% frontier: the got counts and the frontier
    exact), the segment route (CC under P4's rule) and the concat route
    (GetNeighbors), K2 (compacted tiles bitwise the uncompacted ones),
    each run's launches counted; (b) phase 5's RMAT-22 edge list: Degree
    + PageRank to convergence on a LocalMesh 2x2 of the card and on a
    ProcessMesh 1x1 over NCCL (a world of one process, started in this
    one), each within 1e-4 of the one-device Engine's; (c) BFS from 8
    sources on the 2x2 mesh, depths and parents equal to the one-device
    run's;
21. the push's sums in a fixed order (ROADMAP P6) and the converter:
    (a) on phase 5's RMAT-22 edge list, the push's dense sum and its
    sparse sums with and without the got count at 0.01%, 1% and 10% of
    senders: the same bits over 10 launches, K1's bits on the same CSR
    and sent mask, within SUM_RTOL of a float64 ``index_add_``, the
    counts exact; PageRank on the push route to convergence at RMAT-16
    and RMAT-22, on one device (K1's steps and vector bit for bit) and
    on a 2x4 LocalMesh (K1's steps and vector on the same tiles, within
    DIST_PR_RTOL of one device); IncPR on the push (K1's vector bit for
    bit, within INCPR_RTOL of the float64 fixed point);
    ``scripts/torch_push_convergence.py --check``; (b) RMAT-20 x 16,
    seed 1, written as a binary mtx and converted with ``python -m
    graphmat_tpu_torch.io.converter --bidirectional --randomizeID`` (a
    subprocess, timed); the C id mapping against the numpy one at
    m = 2^16 and the converter's m; ``read_mtx`` onto the card, its
    edges those of the same transform chain in memory; PageRank on the
    converted graph through K1 and the push within CONVERT_RTOL of
    PageRank on the unconverted bidirectional graph mapped through the
    permutation; the steps of a float64 PageRank (the port's program,
    plain PyTorch) on the converted file's edges equal to those on the
    unconverted graph (the float32 steps logged: ROADMAP H1);
23. the last modules: (a) the generic ⊕ at full width: on phase 5's
    RMAT-22 edge list a min-plus SSSP whose reduce is
    ``Monoid("generic", torch.minimum, int32 max)`` gives K1's min
    route's distances (and steps) exactly and a PageRank whose reduce is
    ``Monoid("generic", torch.add, 0)`` K1's vector within 1e-5 after 10
    steps; on RMAT-20 over 2x2 LocalMesh tiles each gives the one-device
    result; step times of both routes, the generic runs' peak memory;
    (b) RMAT-20 x 16 with weights 1..255 written once as text (RMAT-18
    where the write takes more than 30 s) and read by the native parser
    (``load_edgelist(binaryformat=False)``) and by ``np.loadtxt``: equal
    arrays, both host times; (c) ``graft_entry.entry()``'s step against
    its plain version (1e-6) and ``dryrun_multichip(4)`` and ``(8)`` on
    tiles of the card, their launches counted with the main path's; (d)
    ``GRAPHMAT_DEBUG=1`` on the RMAT-22 graph (both directions,
    uncompacted and compacted, and 2x2 tiles): every CSR and K1/push
    split validated as it is built, then ``validate_graph``, timed;
24. every kernel timed alone (CUDA events, median) beside its plain
    version and, where PyTorch has one, a library call, each timed output
    held against the plain version's (:func:`phase_kernel_times`): K1's
    dense sum and K2 on phase 5's compacted graph, K3 ``sgd`` on phase
    9's graph and on the benchmark's skewed MovieLens draw, K3 ``lda`` on
    phase 10's, the push's dense max and its mark pass at 1% on phase
    5's edges uncompacted, the sparse mode at 10% and K5's count alone on
    phase 17's graph, T1 and T2 on RMAT-22's TriangleCounting arguments,
    the RMAT keys of RMAT-22 (and the weights kernel on its kept keys,
    checked only) and SGD's initial factors.

The last two lines are the kernels' JSON record (phase 24's times, the
launches of the phases above) and ``{"ok": true, "device": {...}}``.
Phase numbers given as arguments run phases 1-2 and those only (24 with
5, 9, 10 and 17), without the result lines.
"""

import contextlib
import functools
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

from perfbench.roofline import FP32_FLOPS, HBM_BYTES_PER_S, bound_s

ROOT = os.path.dirname(os.path.abspath(__file__))

# tolerances, with their reasons
SUM_RTOL = 1e-5    # of sum(|term|) of the row: the kernel sums in another
                   # order than scatter_reduce_, and a hub row can cancel
GOLDEN_ATOL = 2e-5  # the golden file prints 6 decimals
ORACLE_RTOL = 1e-4  # float32 PageRank against the float64 oracle
F32_UNIT = 2.0 ** -24  # float32 unit roundoff
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
    """Phase 5: the main path at full size, counted and checked.  The
    graph is compacted (``compact=True``), so that K2 is driven, counted
    and checked at full size; ``graph_kw`` goes to the Graph (a smaller
    rehearsal forces diversion with it)."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.pagerank import run_pagerank
    from graphmat_tpu_torch.ops import compact, spmv2u
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    from graphmat_tpu_torch.ops import rmat
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in rmat.LAUNCHES:
        rmat.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    e = rmat_edgelist(scale, edge_factor, a=0.57, b=0.19, c=0.19,
                      seed=seed, device=device)
    sync(device)
    t_gen = time.perf_counter() - t0
    krm = dict(rmat.LAUNCHES)
    if torch.device(device).type == "cuda" and krm["keys"] != 1:
        raise AssertionError(f"phase 5: the draw launched {krm}")
    golden = check_rmat_golden(e, scale, edge_factor, seed)
    t0 = time.perf_counter()
    g = Graph(e, device=device, permute="degree",
              **{"compact": True, **(graph_kw or {})})
    sync(device)
    t_build = time.perf_counter() - t0
    compacted = {r: g.csr(r).src_of_pos is not None for r in ("dst", "src")}
    if not all(compacted.values()):
        raise AssertionError(f"compaction expected on at n={g.n}: "
                             f"{compacted}")
    n_aux = {r: g.csr(r).n_aux for r in ("dst", "src")}

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
    # one K2 launch for each K1 call on a compacted CSR, dense or sparse
    if torch.device(device).type == "cuda" and (
            k1["dense"] < niter or k1["sparse_got"] < 1
            or k2["aux_gather"] != sum(k1.values())):
        raise AssertionError("phase 5: the main path missed a kernel, or "
                             "K2 did not launch once per K1 call")

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
        f"max |err|/max(1,|ref|) {rel:.3e}; the draw's launches {krm}, "
        f"{golden}")
    return e, g, niter, k1, k2, krm


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
    from graphmat_tpu_torch.ops import rand_r, spmv_vec2
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
    rand_r.LAUNCHES["uniform"] = 0
    init_sgd_graph(g, k)
    lv_init = g.vp["lv"][: g.n].clone()
    if cuda and rand_r.LAUNCHES["uniform"] != 1:
        raise AssertionError("phase 9: init_sgd_graph did not launch the "
                             "rand_r kernel once")

    for op in spmv_vec2.LAUNCHES:
        spmv_vec2.LAUNCHES[op] = 0
    t0 = time.perf_counter()
    lv, rmse0, rmse1 = run_sgd(g, k=k, iterations=iterations)
    sync(device)
    t_run = time.perf_counter() - t0
    k3 = dict(spmv_vec2.LAUNCHES)
    krr = rand_r.LAUNCHES["uniform"]   # run_sgd draws its own init again
    log(f"phase 9: launches over run_sgd: K3 {k3}; rand_r over the init "
        f"and run_sgd {krr}")
    if cuda and (k3["sgd"] < 2 * iterations or k3["sgd_sqerr"] < 2):
        raise AssertionError("phase 9: the main path missed K3")
    if cuda and krr != 2:
        raise AssertionError("phase 9: the main path missed the rand_r "
                             "kernel")
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
    return e, g, k3, krr


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
    return e, g, gn, k3


# ------------------------------------------------- scalar frontier apps

DELTA = 64          # delta-stepping bucket width for weights 1..255
# of max(1, |pr|): float32 delta-PageRank (deltas under 1e-8 are never
# propagated) against the float64 fixed point.  K1 sums a row in a fixed
# order, 32 lanes then a shuffle tree: 9.8e-7 measured at RMAT-22.  The
# push's sums are K1's over the receiver CSR (ROADMAP P6), so it is held
# to the same bound
INCPR_RTOL = {"v2u": 1e-5, "v2": 1e-5}
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
    from graphmat_tpu_torch.ops import compact, rmat, spmv2, spmv2u, triangles
    for d in (spmv2u.LAUNCHES, spmv2.LAUNCHES, compact.LAUNCHES,
              triangles.LAUNCHES, rmat.LAUNCHES):
        for k in d:
            d[k] = 0


def read_counts():
    """The launches since :func:`reset_counts` that are not 0, as
    ``{"kernel.mode": n}`` (k1, push, k2, tc: T1 and T2, and rmat: the
    RMAT stream's keys and weights)."""
    from graphmat_tpu_torch.ops import compact, rmat, spmv2, spmv2u, triangles
    return {f"{name}.{mode}": n for name, d in (
        ("k1", spmv2u.LAUNCHES), ("push", spmv2.LAUNCHES),
        ("k2", compact.LAUNCHES), ("tc", triangles.LAUNCHES),
        ("rmat", rmat.LAUNCHES))
        for mode, n in d.items() if n}


def launches(counts, kernel):
    """The launches of ``kernel`` (a name, or name.mode) in ``counts``."""
    return sum(n for k, n in counts.items()
               if k == kernel or k.startswith(kernel + "."))


def push_sum_launches_ok(counts):
    """Every K1 launch of a run under v2 is a push sum's: a sparse one
    carries the mark pass's final rows and follows one mark pass each."""
    c = counts.get
    return (c("k1.sparse", 0) == c("k1.sparse_got", 0) == 0
            and c("k1.sparse_final", 0) + c("k1.sparse_got_final", 0)
            == c("push.mark", 0))


def check_route(what, counts, route, cuda, need_final=False, sums=False):
    """The run went through its route's kernel: K1 under v2u (with the
    recv_final skip where the program gives one), the push under v2: its
    own kernel for min and max, and for a program that sums (``sums``)
    the mark pass and K1 (a dense sum K1 alone), no K1 launch otherwise."""
    if not cuda:
        return
    k1, push = launches(counts, "k1"), launches(counts, "push")
    fin = sum(n for k, n in counts.items() if k.endswith("_final"))
    ok = (k1 > 0 and push == 0 and (fin > 0 or not need_final)
          if route == "v2u" else
          push_sum_launches_ok(counts) and (k1 + push > 0) and (
              sums or k1 == 0))
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
        check_route("goldens", out[route], route, cuda, sums=True)
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


def run_routes(what, fn, device, need_final=False, sums=False):
    """``fn()`` under GRAPHMAT_KERNEL=v2u and =v2, counts reset before
    and read after each: {route: (result, seconds, counts)}; ``sums``:
    the program sums (its push route launches K1 too)."""
    import torch
    cuda = torch.device(device).type == "cuda"
    out = {}
    for route in ("v2u", "v2"):
        os.environ["GRAPHMAT_KERNEL"] = route
        reset_counts()
        res, sec = timed(fn, device)
        out[route] = (res, sec, read_counts())
        check_route(what, out[route][2], route, cuda, need_final, sums)
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
                        device, sums=True)
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
                        device, need_final=True, sums=True)
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
    return report


# ------------------------------------------ the ACTIVE_ONLY K-wide route

ACTIVE_SHARES = (1.0, 0.1, 0.01)         # frontiers of phase 17
LOCKSTEP_ITERS = 5
CHANGED_TOL = 1e-7   # SGDProgram.changed's threshold


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


def phase_active_vec(device, card, users, items, ratings, k=20, seed=31):
    """Phase 17: ACTIVE_ONLY SGD and RMSE at MovieLens-25M shape on K3's
    sparse mode, through ``Engine.step_once``: (a) one SGD step from
    seeded frontiers of 100%, 10% and 1% of the vertices against the
    float64 oracle (at 100%, the ALL_VERTICES step's bits); (b) RMSE from
    a 10% frontier against a float64 oracle; (c) five SGD steps in
    lock-step with the plain route.  Returns the main path's launch
    counts, the results and the graph."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import sgd
    from graphmat_tpu_torch.core import runtime
    from graphmat_tpu_torch.ops import spmv_vec as ss
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    cuda = torch.device(device).type == "cuda"
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
    # (a) at 100%: the ALL_VERTICES step on dense K3 gives the same bits
    start(frontier[1.0])
    runtime.Engine(sgd.SGDProgram(k=k), g).step_once()
    if not torch.equal(g.vp["lv"][:n], lv_all):
        raise AssertionError("phase 17a: with every vertex active the "
                             "ACTIVE_ONLY step differs from the "
                             "ALL_VERTICES one")
    log("phase 17: " + json.dumps(res))
    return path, res, g


def tc_pairs(e):
    """0-based int64 pairs of an upper-triangular edge list, on its
    device."""
    import torch
    return (torch.as_tensor(e.src).long() - 1,
            torch.as_tensor(e.dst).long() - 1)


def phase_tc_golden(cuda=True):
    """Phase 19 (b): the TriangleCounting CLI on the fixture against the
    reference binary's total (tests/golden/tc_2_10.txt), on the engine
    route (what "auto" picks there) and on the bucketed one."""
    from graphmat_tpu_torch.apps import triangle_counting as tc
    want = re.search(r"Total triangles = (\d+)", golden("tc_2_10.txt"))[1]
    fixture = os.path.join(ROOT, "data", "2_10_upper_triangle.bin.mtx")
    old_env = os.environ.get("GRAPHMAT_PLATFORM")
    os.environ["GRAPHMAT_PLATFORM"] = "cuda" if cuda else "cpu"
    run = tc.run_triangle_counting
    try:
        for method in ("engine", "bucketed"):
            tc.run_triangle_counting = functools.partial(run, method=method)
            out = run_cli("graphmat_tpu_torch.apps.triangle_counting",
                          [fixture])
            if f"Total triangles = {want}\n" not in out:
                raise AssertionError(f"TC CLI ({method}): no total {want} "
                                     f"in {out!r}")
    finally:
        tc.run_triangle_counting = run
        if old_env is None:
            os.environ.pop("GRAPHMAT_PLATFORM", None)
        else:
            os.environ["GRAPHMAT_PLATFORM"] = old_env
    log(f"phase 19 (b): the TC CLI prints the golden total {want} on the "
        "engine and the bucketed route")


def neighbors_oracle(src1, dst1, n, width):
    """Sorted out-neighbour ids of each vertex (1-based edge arrays on the
    host), padded with INT32_MAX to ``width``."""
    order = np.lexsort((dst1, src1))
    s, d = src1[order].astype(np.int64) - 1, dst1[order]
    start = np.searchsorted(s, np.arange(n))
    out = np.full((n, width), 2 ** 31 - 1, np.int32)
    out[s, np.arange(len(s)) - start[s]] = d
    return out


def scipy_triangles(e):
    """The triangles of an upper-triangular edge list by scipy on the
    host: sum((A @ A) .* A), independent of both preps."""
    from scipy.sparse import coo_matrix
    src = np.asarray(torch_cpu(e.src), np.int64) - 1
    dst = np.asarray(torch_cpu(e.dst), np.int64) - 1
    a = coo_matrix((np.ones(len(src), np.int64), (src, dst)),
                   shape=(e.n, e.n)).tocsr()
    return int((a @ a).multiply(a).sum())


def torch_cpu(a):
    import torch
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


def phase_tc_slice(device, scale=22, small_scale=16, uniform_scale=20,
                   uniform_degree=8):
    """Phase 19 (c): TriangleCounting at full size.  RMAT-``scale`` x 16,
    seed 1, made upper-triangular and deduplicated on the card:
    ``run_triangle_counting`` with "auto", which must take the bucketed
    route, launching T1 and T2 (counted over that run), its total and
    every per-vertex count exactly the host route's (numpy prep) on the
    same edges; RMAT-``small_scale``'s total against scipy's.  Then, on a
    uniform random graph of 2^``uniform_scale`` vertices and
    ``uniform_degree`` edges a vertex (undirected average degree 16),
    upper-triangular: ``run_get_neighbors`` against a numpy oracle, and
    TriangleCounting's engine route against its bucketed total."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.get_neighbors import run_get_neighbors
    from graphmat_tpu_torch.apps.triangle_counting import \
        run_triangle_counting
    from graphmat_tpu_torch.io.transforms import convert_to_upper_triangular
    from graphmat_tpu_torch.ops import triangles as tri
    from graphmat_tpu_torch.ops.neighbors import max_degree
    from graphmat_tpu_torch.utils.generators import (random_edgelist,
                                                      rmat_edgelist)
    cuda = torch.device(device).type == "cuda"
    res = {}
    t0 = time.perf_counter()
    e = convert_to_upper_triangular(rmat_edgelist(scale, 16, seed=1,
                                                  device=device))
    g = Graph(e, device=device)
    sync(device)
    dmax = max_degree(g, "src")
    t1 = time.perf_counter()
    reset_counts()
    tri_v, total = run_triangle_counting(g)
    sync(device)
    counts = read_counts()
    t2 = time.perf_counter()
    if cuda and (counts.get("tc.core_count", 0) < 1
                 or counts.get("tc.tail_count", 0) < 1):
        raise AssertionError(f"RMAT-{scale} TC: T1 and T2 must launch, "
                             f"launches {counts}")
    if dmax <= 1024:
        raise AssertionError(f"RMAT-{scale}: max out-degree {dmax} would "
                             "take the engine route")
    pv_h, total_h = tri.count_triangles_bucketed(*tc_pairs(e), e.n,
                                                 impl="host")
    t3 = time.perf_counter()
    if total != total_h or not np.array_equal(tri_v, pv_h.cpu().numpy()):
        raise AssertionError(f"RMAT-{scale} TC: {total} differs from the "
                             f"host route's {total_h}")
    res[f"rmat{scale}"] = {
        "n": e.n, "edges": e.nnz, "max_out_degree": dmax,
        "triangles": total, "launches": counts,
        "build_s": t1 - t0, "run_s": t2 - t1, "host_route_s": t3 - t2}
    del g, e, pv_h, tri_v

    e16 = convert_to_upper_triangular(rmat_edgelist(
        small_scale, 16, seed=1, device=device))
    _, t16 = run_triangle_counting(Graph(e16, device=device))
    want16 = scipy_triangles(e16)
    if t16 != want16:
        raise AssertionError(f"RMAT-{small_scale} TC: {t16}, scipy "
                             f"{want16}")
    res[f"rmat{small_scale}"] = {"triangles": t16, "scipy": want16}

    n = 1 << uniform_scale
    eu = convert_to_upper_triangular(random_edgelist(n, uniform_degree,
                                                     seed=1))
    t4 = time.perf_counter()
    gu = Graph(eu, device=device)
    nb = run_get_neighbors(gu)
    t5 = time.perf_counter()
    ref = neighbors_oracle(eu.src, eu.dst, n, nb.shape[1])
    if not np.array_equal(nb, ref):
        raise AssertionError("GetNeighbors differs from its numpy oracle")
    _, t_eng = run_triangle_counting(gu, method="engine")
    t6 = time.perf_counter()
    _, t_bkt = run_triangle_counting(gu, method="bucketed")
    if t_eng != t_bkt:
        raise AssertionError(f"uniform TC: engine {t_eng}, bucketed {t_bkt}")
    res[f"uniform{uniform_scale}"] = {
        "edges": eu.nnz, "width": int(nb.shape[1]), "triangles": t_eng,
        "get_neighbors_s": t5 - t4, "engine_s": t6 - t5}
    log("phase 19 (c): " + json.dumps(res))
    return res


def exact_err(what, got, ref):
    """The largest absolute difference of two outputs of one shape, which
    must be 0: raises otherwise."""
    err = float((got.double() - ref.double()).abs().max()) \
        if got.numel() else 0.0
    if err:
        raise AssertionError(f"{what} differs from its plain version by "
                             f"up to {err}")
    return err


# ----------------------------------------------------- the sharded engine

DIST_SHAPES = ((2, 2), (2, 4))   # phase 20 (a)'s LocalMesh grids
# of max(1, |pr|): each tile sums its part of a row and the reduce-scatter
# sums the C partials, float32 sums in another order (ROADMAP H1); the
# one-device run is taken to the same iteration count
DIST_PR_RTOL = 1e-5
DIST_SGD_ATOL = 1e-5   # float32 factors in [0, 1], sums in another order
DIST_SOURCES = 4       # BFS sources of phase 20 (a), per mesh


def reset_all_counts():
    """:func:`reset_counts`, and K3's and its sparse mode's counts."""
    from graphmat_tpu_torch.ops import spmv_vec, spmv_vec2
    reset_counts()
    for d in (spmv_vec2.LAUNCHES, spmv_vec.LAUNCHES):
        for k in d:
            d[k] = 0


def read_all_counts():
    """:func:`read_counts`, with K3 (``k3.<op>``) and its sparse mode
    (``k3s.<op>``)."""
    from graphmat_tpu_torch.ops import spmv_vec, spmv_vec2
    out = read_counts()
    for name, d in (("k3", spmv_vec2.LAUNCHES), ("k3s", spmv_vec.LAUNCHES)):
        out.update({f"{name}.{op}": n for op, n in d.items() if n})
    return out


def need_launch(what, counts, *kernels, none_of=()):
    """The run launched each of ``kernels`` (names or name.mode) and none
    of ``none_of``."""
    def n(k):
        return sum(v for key, v in counts.items()
                   if key == k or key.startswith(k + "."))
    if any(n(k) == 0 for k in kernels) or any(n(k) for k in none_of):
        raise AssertionError(f"{what}: launches {counts} (needed "
                             f"{kernels}, none of {none_of})")


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))) \
        if a.size else 0.0


def check_equal(what, a, b):
    if np.shape(a) != np.shape(b) or not np.array_equal(a, b):
        raise AssertionError(f"{what}: differs from the one-device run")


def check_close(what, a, b, tol):
    err = rel_err(a, b)
    if np.shape(a) != np.shape(b) or not np.isfinite(a).all() or err > tol:
        raise AssertionError(f"{what}: off the one-device run by {err} "
                             f"(tolerance {tol})")
    return err


def sparse_counts_one_device(g, prog, state):
    """The one-device K3 sparse mode's count per receiver (original
    order) for ``prog``'s message from ``g``'s frontier."""
    import torch
    from graphmat_tpu_torch.ops.spmv_vec import spmv_vec_sparse
    sem = prog.vec_semiring()
    msg, _ = prog.send_message(state, g.vp)
    sent = (g.active & g.valid_vertex).to(torch.uint8)
    x = sem.encode(state, msg).to(torch.float32).contiguous()
    vp = sem.encode_vp(state, g.vp).to(torch.float32).contiguous()
    cnt = 0
    for recv in ("dst", "src"):
        cnt = cnt + spmv_vec_sparse(g.csr(recv), x, sem.process_op, sent,
                                    vp=vp, params=sem.params)[1]
    return (cnt[g.perm] if g.perm is not None else cnt[: g.n]).cpu().numpy()


def sparse_counts_dist(gd, prog, state):
    """The same count over the mesh: each tile's sparse-mode count,
    reduce-scattered, through the engine (original order)."""
    from graphmat_tpu_torch.parallel.dist_runtime import DistEngine
    eng = DistEngine(prog, gd)
    msgs = [prog.send_message(state, vp)[0] for vp in gd.vp]
    sents = [a & v for a, v in zip(gd.active, gd.valid_vertex)]
    _, counts = eng.vec_partials([state] * len(gd.local), msgs, sents,
                                 gd.vp)
    return gd._to_original(gd._full(counts).cpu().numpy())


def phase_dist_routes(device, scale=16, edge_factor=16, seed=7,
                      shapes=DIST_SHAPES, users=60_000, items=20_000,
                      ratings=1_000_000, docs=3_000, terms=1_000,
                      entries=100_000, k=20):
    """Phase 20 (a): every route of the sharded engine on LocalMeshes of
    ``[device] * R * C`` tiles, held against the one-device Engine on the
    same device.  Returns the launches of each kernel over these runs."""
    import torch
    from graphmat_tpu_torch import EdgeList, Graph
    from graphmat_tpu_torch.apps import (bfs, connected_components as cc,
                                         delta_stepping as ds,
                                         get_neighbors as gn, lda, pagerank,
                                         sgd, sssp)
    from graphmat_tpu_torch.core.runtime import Engine
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.dist_runtime import DistEngine
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    cuda = torch.device(device).type == "cuda"
    t_start = time.perf_counter()
    e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ew = EdgeList(e.m, e.n, e.src, e.dst, torch.randint(
        1, 256, (e.nnz,), generator=gen, device=device, dtype=torch.int32))
    er = ratings_edgelist(users, items, ratings, seed, device)
    el = nytimes_edgelist(docs, terms, entries, seed, device)
    n = max(e.m, e.n)
    rng = np.random.default_rng(seed)
    outdeg = np.bincount(e.src.cpu().numpy() - 1, minlength=n)
    sources = (rng.choice(np.flatnonzero(outdeg > 0), DIST_SOURCES,
                          replace=False) + 1).tolist()
    frontier = rng.random(users + items) < 0.1
    seg_cc = type("SegmentCC", (cc.ConnectedComponentsProgram,),
                  {"process_requires_vertexprop": True})   # P4's rule
    a_sgd = active_only(sgd.SGDProgram)

    # the one-device references, once
    g1 = Graph(e, device=device, permute="degree")
    g1w = Graph(ew, device=device, permute="degree", build_in_edges=False)
    ref = {"bfs": {s: bfs.run_bfs(g1, s)[:2] for s in sources},
           "sssp": sssp.run_sssp(g1w, sources[0])[0],
           "cc": cc.run_connected_components(g1)[0],
           "ds": ds.run_delta_stepping(ew, DELTA, sources[0],
                                       device=device)[0],
           "gn": gn.run_get_neighbors(g1)}
    g1s = Graph(er, device=device)
    ref["sgd"] = sgd.run_sgd(g1s, k=k, iterations=3)
    sgd.init_sgd_graph(g1s, k)
    g1s.set_active_mask(frontier)
    ref["sgd_counts"] = sparse_counts_one_device(g1s, a_sgd(k=k), 0)
    Engine(a_sgd(k=k), g1s).run(iterations=1)
    ref["sgd_active"] = (g1s.vp_numpy()["lv"], g1s.active_numpy())
    ref["lda"] = lda.run_lda(Graph(el, device=device), docs, terms, k=k,
                             iterations=3)

    launches = {}
    report = {"sources": sources, "errors": {}, "iterations": {}}

    def counted(what, fn, *kernels, none_of=()):
        reset_all_counts()
        out = fn()
        sync(device)
        c = read_all_counts()
        if cuda:
            need_launch(what, c, *kernels, none_of=none_of)
        for key, v in c.items():
            launches[key] = launches.get(key, 0) + v
        return out

    for shape in shapes:
        tag = f"{shape[0]}x{shape[1]}"
        mesh = LocalMesh([device] * (shape[0] * shape[1]), shape)
        gd = DistGraph(e, mesh)
        # K1: the dense sum, and the degree pass's sparse sum with got
        pr_d, it_d = counted(f"{tag} PageRank",
                             lambda: pagerank.run_pagerank(gd),
                             "k1.dense", "k1.sparse_got", none_of=("push",))
        pr_1, _ = pagerank.run_pagerank(g1, iterations=it_d)
        report["errors"][f"{tag} pagerank"] = check_close(
            f"{tag} PageRank", pr_d, pr_1, DIST_PR_RTOL)
        report["iterations"][f"{tag} pagerank"] = it_d
        # K1's sparse min with recv_final: BFS, SSSP, CC, DeltaStepping
        for s in sources:
            out = counted(f"{tag} BFS {s}", lambda: bfs.run_bfs(gd, s),
                          "k1.sparse_final")
            check_equal(f"{tag} BFS from {s} depths", out[0],
                        ref["bfs"][s][0])
            check_equal(f"{tag} BFS from {s} parents", out[1],
                        ref["bfs"][s][1])
        gdw = DistGraph(ew, mesh, build_in_edges=False)
        check_equal(f"{tag} SSSP", counted(
            f"{tag} SSSP", lambda: sssp.run_sssp(gdw, sources[0]),
            "k1.sparse")[0], ref["sssp"])
        check_equal(f"{tag} CC", counted(
            f"{tag} CC", lambda: cc.run_connected_components(gd),
            "k1")[0], ref["cc"])
        check_equal(f"{tag} DeltaStepping", counted(
            f"{tag} DeltaStepping", lambda: ds.run_delta_stepping_dist(
                ew, DELTA, sources[0], mesh), "k1.sparse_final")[0],
            ref["ds"])
        # the push (GRAPHMAT_KERNEL=v2), on each tile's sender-major
        # index: BFS on its own kernel; PageRank's sums on K1 over the
        # tile's receiver CSR (the dense sum K1's alone, the degree pass's
        # sparse sum after the mark pass), so run to convergence it takes
        # K1's steps and gives K1's vector on the same tiles (ROADMAP P6)
        os.environ["GRAPHMAT_KERNEL"] = "v2"
        try:
            out = counted(f"{tag} BFS {sources[0]} (push)",
                          lambda: bfs.run_bfs(gd, sources[0]),
                          "push.sparse", none_of=("k1",))
            check_equal(f"{tag} BFS (push)", out[0],
                        ref["bfs"][sources[0]][0])
            pr_p, it_p = counted(f"{tag} PageRank (push)",
                                 lambda: pagerank.run_pagerank(gd),
                                 "push.mark", "k1.dense",
                                 "k1.sparse_got_final",
                                 none_of=("push.dense", "push.sparse",
                                          "k1.sparse_got"))
        finally:
            os.environ["GRAPHMAT_KERNEL"] = "v2u"
        if it_p != it_d:
            raise AssertionError(f"{tag} PageRank (push): {it_p} "
                                 f"iterations, K1 {it_d}")
        check_equal(f"{tag} PageRank (push) against K1 on the tiles", pr_p,
                    pr_d)
        report["iterations"][f"{tag} pagerank push"] = it_p
        # K3 (SGD, LDA) and its sparse mode (ACTIVE_ONLY SGD, 10% sent)
        gds = DistGraph(er, mesh)
        lv, r0, r1 = counted(f"{tag} SGD", lambda: sgd.run_sgd(
            gds, k=k, iterations=3), "k3.sgd", "k3.sgd_sqerr")
        err = float(np.max(np.abs(lv - ref["sgd"][0])))
        if err > DIST_SGD_ATOL or rel_err([r0, r1], ref["sgd"][1:]) > \
                SGD_RMSE_RTOL:
            raise AssertionError(f"{tag} SGD: off the one-device run by "
                                 f"{err}")
        report["errors"][f"{tag} sgd"] = err
        sgd.init_sgd_graph(gds, k)
        gds.set_active_mask(frontier)
        check_equal(f"{tag} ACTIVE_ONLY SGD got counts", counted(
            f"{tag} sparse counts", lambda: sparse_counts_dist(
                gds, a_sgd(k=k), 0), "k3s.sgd"), ref["sgd_counts"])
        counted(f"{tag} ACTIVE_ONLY SGD", lambda: DistEngine(
            a_sgd(k=k), gds).run(iterations=1), "k3s.sgd")
        err = float(np.max(np.abs(gds.vp_numpy()["lv"]
                                  - ref["sgd_active"][0])))
        if err > DIST_SGD_ATOL:
            raise AssertionError(f"{tag} ACTIVE_ONLY SGD: off by {err}")
        check_equal(f"{tag} ACTIVE_ONLY SGD frontier", gds.active_numpy(),
                    ref["sgd_active"][1])
        n_d, _, ll_d = counted(f"{tag} LDA", lambda: lda.run_lda(
            DistGraph(el, mesh), docs, terms, k=k, iterations=3),
            "k3.lda", "k3.lda_init", "k3.lda_loglik")
        report["errors"][f"{tag} lda"] = check_close(
            f"{tag} LDA N", n_d, ref["lda"][0], LDA_N_RTOL)
        check_close(f"{tag} LDA log-likelihood", [ll_d], [ref["lda"][2]],
                    LDA_LL_RTOL)
        # the segment route (P4's rule) and the concat route
        check_equal(f"{tag} segment-route CC", counted(
            f"{tag} segment CC", lambda: engine_run_labels(gd, seg_cc),
            none_of=("k1", "push")), ref["cc"])
        nb = counted(f"{tag} GetNeighbors",
                     lambda: gn.run_get_neighbors(gd),
                     none_of=("k1", "push"))
        w = ref["gn"].shape[1]
        check_equal(f"{tag} GetNeighbors", nb[:, :w], ref["gn"])
        if not (nb[:, w:] == gn.PAD_ID).all():
            raise AssertionError(f"{tag} GetNeighbors: extra ids past the "
                                 "one-device width")
        # K2: compacted tiles give the uncompacted tiles' results bitwise
        gdc = DistGraph(e, mesh, compact=True,
                        compact_kw=dict(hub=0, divert_min=1 << 30, w_div=1))
        pr_c, it_c = counted(f"{tag} PageRank (compacted)",
                             lambda: pagerank.run_pagerank(gdc),
                             "k2", "k1.dense")
        if it_c != it_d:
            raise AssertionError(f"{tag} compacted PageRank: {it_c} "
                                 f"iterations, uncompacted {it_d}")
        check_equal(f"{tag} compacted PageRank", pr_c, pr_d)
        out = counted(f"{tag} BFS (compacted)",
                      lambda: bfs.run_bfs(gdc, sources[0]), "k2")
        check_equal(f"{tag} compacted BFS", out[0],
                    ref["bfs"][sources[0]][0])
        del gd, gdw, gds, gdc
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t_start
    log("phase 20 (a): " + json.dumps(report))
    return launches


def engine_run_labels(g, prog_cls):
    """CC's labels from ``prog_cls`` (another route for the same
    program)."""
    from graphmat_tpu_torch.core.runtime import engine_for
    g.init_vertexproperty(label=np.arange(1, g.n + 1, dtype=np.int32))
    g.set_all_active()
    engine_for(prog_cls(), g).run()
    return g.vp_numpy()["label"]


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist_slice(device, card, e=None, scale=22, edge_factor=16, seed=1,
                     n_sources=N_SOURCES):
    """Phase 20 (b)-(c): the main path at full width on a LocalMesh 2x2 of
    the one card and on a ProcessMesh 1x1 over NCCL (a world of one
    process, started here), each against the one-device Engine's
    PageRank; BFS from ``n_sources`` sources on the 2x2 mesh against the
    one-device BFS; build and run times, peak memory.  ``e`` is phase 5's
    edge list (made here when phase 5 did not run).  Returns the K1
    launches of the main-path runs."""
    import torch
    import torch.distributed as dist
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import bfs, pagerank
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh, ProcessMesh
    from graphmat_tpu_torch.parallel.multihost import initialize
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    if e is None:
        e = rmat_edgelist(scale, edge_factor, a=0.57, b=0.19, c=0.19,
                          seed=seed, device=device)
    out = {"card": card, "nnz": e.nnz}
    g1 = Graph(e, device=device, permute="degree")
    pr_1, it_1 = pagerank.run_pagerank(g1)
    out["iterations"] = {"one_device": it_1}
    k1 = {}

    def main_path(name, g):
        reset_all_counts()
        t0 = time.perf_counter()
        pr, it = pagerank.run_pagerank(g)
        sync(device)
        out.setdefault("run_pagerank_s", {})[name] = \
            time.perf_counter() - t0
        c = read_all_counts()
        if cuda:
            need_launch(f"{name} PageRank", c, "k1.dense", "k1.sparse_got",
                        none_of=("push",))
        for key, v in c.items():
            k1[key] = k1.get(key, 0) + v
        out["iterations"][name] = it
        out.setdefault("rel_err", {})[name] = check_close(
            f"{name} PageRank", pr, pr_1, ORACLE_RTOL)

    cuda = torch.device(device).type == "cuda"   # else a CPU rehearsal
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        out["bytes_before_2x2"] = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mesh = LocalMesh([device] * 4, (2, 2))
    g22 = DistGraph(e, mesh)
    sync(device)
    out["build_s"] = {"2x2": time.perf_counter() - t0}
    main_path("2x2", g22)
    if cuda:
        out["peak_bytes_2x2"] = torch.cuda.max_memory_allocated()

    # (c) BFS on the 2x2 mesh against the one-device BFS
    rng = np.random.default_rng(2)
    outdeg = np.bincount(e.src.cpu().numpy() - 1, minlength=g1.n)
    sources = (rng.choice(np.flatnonzero(outdeg > 0), n_sources,
                          replace=False) + 1).tolist()
    levels = {}
    for s in sources:
        reset_all_counts()
        d, p, it = bfs.run_bfs(g22, s)
        if cuda:
            need_launch(f"2x2 BFS {s}", read_all_counts(),
                        "k1.sparse_final")
        d1, p1, it1 = bfs.run_bfs(g1, s)
        check_equal(f"2x2 BFS from {s} depths", d, d1)
        check_equal(f"2x2 BFS from {s} parents", p, p1)
        levels[s] = (it, it1)
    out["bfs_levels_dist_one_device"] = levels

    # the ProcessMesh over NCCL, a world of one
    initialize(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
               device=device)
    try:
        pmesh = ProcessMesh((1, 1), device=torch.device(device))
        t0 = time.perf_counter()
        g11 = DistGraph(e, pmesh)
        sync(device)
        out["build_s"]["1x1 nccl"] = time.perf_counter() - t0
        main_path("1x1 nccl", g11)
    finally:
        dist.destroy_process_group()
    out["launches"] = k1
    log(f"phase 20 (b-c) ({card}): " + json.dumps(out))
    return k1


# ----------------------------- the push's sums in a fixed order; converter

PUSH_SHARES = (1e-4, 1e-2, 0.1)   # phase 21 (a): shares of senders sent
PUSH_REPEATS = 10                 # launches that must give the same bits
PUSH_MESH = (2, 4)                # phase 21 (a)'s LocalMesh
CONVERT_RTOL = 1e-5   # of max(1, |pr|): the converted graph's PageRank


def pagerank_f64(src0, dst0, n, alpha=0.3, tol=1e-5, max_iter=1000):
    """PageRank's run to convergence in float64 with index_add_ on the
    device of the 0-based int64 edges (plain PyTorch, none of the port):
    the port's program (start 0.3, a vertex with an in-edge changes
    while |delta| > ``tol``, a last step that changes none counted).
    Returns (steps, each step's largest change)."""
    import torch
    deg = torch.bincount(src0, minlength=n).double()
    got = torch.bincount(dst0, minlength=n) > 0
    pr = torch.full((n,), 0.3, dtype=torch.float64, device=src0.device)
    big = []
    for it in range(max_iter):
        msg = torch.where(deg == 0, 0.0, pr / deg.clamp(min=1))
        acc = torch.zeros_like(pr).index_add_(0, dst0, msg[src0])
        new = torch.where(got, alpha + (1 - alpha) * acc, pr)
        big.append(float((new - pr).abs().max()))
        pr = new
        if big[-1] <= tol:
            return it + 1, big
    return max_iter, big


def edges0(a, device):
    """The 0-based int64 (src, dst) of an edge list on ``device``."""
    import torch
    return (torch.as_tensor(np.asarray(a.src), device=device).long() - 1,
            torch.as_tensor(np.asarray(a.dst), device=device).long() - 1)


def pagerank_routes(what, g, iterations=None, cuda=True):
    """PageRank on ``g`` under GRAPHMAT_KERNEL=v2u and =v2: {route: (pr,
    niter)}; the push's run must launch the mark pass and K1 (the dense
    sum, the degree pass's sparse sum with the mark's rows final) and no
    min/max push or unmarked sparse K1."""
    from graphmat_tpu_torch.apps import pagerank
    out = {}
    try:
        for route in ("v2u", "v2"):
            os.environ["GRAPHMAT_KERNEL"] = route
            reset_counts()
            out[route] = pagerank.run_pagerank(g, iterations=iterations) \
                if iterations else pagerank.run_pagerank(g)
            c = read_counts()
            if cuda and route == "v2":
                need_launch(f"{what} PageRank (push)", c, "push.mark",
                            "k1.dense", "k1.sparse_got_final",
                            none_of=("push.dense", "push.sparse",
                                     "k1.sparse_got"))
    finally:
        os.environ["GRAPHMAT_KERNEL"] = "v2u"
    return out


def check_push_pagerank(what, routes):
    """The push's PageRank took K1's steps and gave K1's vector, bit for
    bit; returns the step count."""
    (pr_k, it_k), (pr_p, it_p) = routes["v2u"], routes["v2"]
    if it_p != it_k:
        raise AssertionError(f"{what}: the push took {it_p} steps, K1 "
                             f"{it_k}")
    if not np.array_equal(pr_p.view(np.int32), pr_k.view(np.int32)):
        raise AssertionError(f"{what}: the push's PageRank is not K1's bit "
                             "for bit")
    return it_k


def phase_push_sums(device, card, e=None, scale=22, edge_factor=16, seed=1,
                    small_scale=16, mesh_shape=PUSH_MESH,
                    convergence_check=True):
    """Phase 21 (a): the push's sums on K1's fixed order (ROADMAP P6),
    on ``e`` (phase 5's RMAT-``scale`` edge list; drawn when None)."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import incremental_pagerank as ipr
    from graphmat_tpu_torch.apps import pagerank
    from graphmat_tpu_torch.ops.spmv2 import spmv_push
    from graphmat_tpu_torch.ops.spmv2u import spmv
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    cuda = torch.device(device).type == "cuda"
    t_start = time.perf_counter()
    if e is None:
        e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    g = Graph(e, device=device, permute="degree")
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    n = g.n_pad
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 20)
    x = torch.rand(n, generator=gen, device=device)
    send, recv = sc.row.long(), sc.col.long()
    report = {"card": card, "scale": scale, "n": g.n, "nnz": sc.nnz}
    err = 0.0
    cases = [("dense", None, False)]
    for share in PUSH_SHARES:
        sent = (torch.rand(n, generator=gen, device=device) < share).to(
            torch.uint8)
        cases += [(f"sparse {share:g}", sent, False),
                  (f"sparse_got {share:g}", sent, True)]
    for name, sent, got in cases:
        def push():
            return spmv_push(sc, x, "sum", "x", sent=sent, want_got=got,
                             recv_csr=rc)

        def k1():
            return spmv(rc, x, "sum", "x", sent=sent, want_got=got)
        runs = [push() for _ in range(PUSH_REPEATS)]
        ref_k1 = k1()
        sync(device)
        y_k1, c_k1 = ref_k1 if got else (ref_k1, None)
        for r in runs:
            y, c = r if got else (r, None)
            if not torch.equal(y.view(torch.int32), y_k1.view(torch.int32)):
                raise AssertionError(f"push {name} sum: not K1's bits, or "
                                     "not the same bits in every launch")
            if got and not torch.equal(c, c_k1):
                raise AssertionError(f"push {name} sum: counts differ from "
                                     "K1's")
        w = x if sent is None else x * sent.float()
        exact = torch.zeros(n, dtype=torch.float64, device=device
                            ).index_add_(0, recv, w[send].double())
        err = max(err, compare_out(
            f"push {name} sum against float64", y_k1.double(), exact, "sum",
            sum_bound(recv, send, x[send], n, sent).double()))
        if got:
            cnt = torch.zeros(n, dtype=torch.int32, device=device
                              ).index_add_(0, recv, sent[send].int())
            if not torch.equal(c_k1, cnt):
                raise AssertionError(f"push {name} sum: counts are not the "
                                     "exact in-edge counts")
    report["max_abs_err"] = err
    del rc, sc, send, recv, x
    log(f"phase 21 (a): RMAT-{scale} (n={g.n}, nnz={g.nnz}): the push's "
        f"dense, sparse and sparse-got sums at {PUSH_SHARES} of senders "
        f"equal K1's bits in {PUSH_REPEATS} launches each, within SUM_RTOL "
        f"of float64 (max |err| {err:.3e})")

    # PageRank to convergence on the push route: one device and tiles
    report["pagerank_iterations"] = {}
    mesh = LocalMesh([device] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    tag = f"{mesh_shape[0]}x{mesh_shape[1]}"
    for sc_name, edges in ((f"RMAT-{scale}", e),
                           (f"RMAT-{small_scale}", None)):
        if edges is None:
            edges = rmat_edgelist(small_scale, edge_factor, seed=seed,
                                  device=device)
            g = Graph(edges, device=device, permute="degree")
        it_1 = check_push_pagerank(f"{sc_name} one device", pagerank_routes(
            sc_name, g, cuda=cuda))
        pr_1 = g.vp_numpy()["pagerank"]
        gd = DistGraph(edges, mesh)
        it_t = check_push_pagerank(f"{sc_name} {tag}", pagerank_routes(
            f"{sc_name} {tag}", gd, cuda=cuda))
        pr_t = gd.vp_numpy()["pagerank"]
        if it_t != it_1:   # the one-device run to the tiles' step count
            pr_1, _ = pagerank.run_pagerank(g, iterations=it_t)
        report["pagerank_iterations"][sc_name] = {"one_device": it_1,
                                                  tag: it_t}
        report[f"{sc_name} {tag} pagerank_rel_err"] = check_close(
            f"{sc_name} {tag} PageRank (push)", pr_t, pr_1, DIST_PR_RTOL)
        del gd
    # IncPR on the push, RMAT-small: K1's vector, the float64 fixed point
    ipr_out = {}
    try:
        for route in ("v2u", "v2"):
            os.environ["GRAPHMAT_KERNEL"] = route
            ipr_out[route] = ipr.run_incremental_pagerank(g)[0]
    finally:
        os.environ["GRAPHMAT_KERNEL"] = "v2u"
    if not np.array_equal(ipr_out["v2"].view(np.int32),
                          ipr_out["v2u"].view(np.int32)):
        raise AssertionError("IncPR (push): not K1's vector bit for bit")
    fp, _ = pagerank_fixed_point(edges.src.long() - 1, edges.dst.long() - 1,
                                 g.n)
    fp = fp.cpu().numpy()
    report["incpr_rel_err"] = float(np.max(np.abs(ipr_out["v2"] - fp)
                                           / np.maximum(1.0, np.abs(fp))))
    if report["incpr_rel_err"] > INCPR_RTOL["v2"]:
        raise AssertionError(f"IncPR (push): off the float64 fixed point by "
                             f"{report['incpr_rel_err']}")
    if convergence_check:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.join("scripts",
                                          "torch_push_convergence.py"),
             "--scale", str(small_scale), "--reps", "2", "--check"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError("torch_push_convergence.py --check failed:"
                                 f"\n{res.stdout}\n{res.stderr[-2000:]}")
        report["convergence_script"] = json.loads(
            res.stdout.strip().splitlines()[-1])
        report["convergence_script_s"] = time.perf_counter() - t0
    report["seconds"] = time.perf_counter() - t_start
    log("phase 21 (a): " + json.dumps(report))
    return report


def phase_converter(device, card, scale=20, edge_factor=16, seed=1,
                    small_m=1 << 16):
    """Phase 21 (b): the converter on an RMAT-``scale`` binary mtx."""
    import tempfile
    import torch
    from graphmat_tpu_torch import EdgeList, Graph, read_mtx
    from graphmat_tpu_torch.io import transforms as tf
    from graphmat_tpu_torch.io.edgelist import load_edgelist, write_edgelist
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    from graphmat_tpu_torch.utils.reference_rng import glibc_square_mapping
    cuda = torch.device(device).type == "cuda"
    t_start = time.perf_counter()
    ed = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    e = EdgeList(ed.m, ed.n, ed.src.cpu().numpy(), ed.dst.cpu().numpy(),
                 ed.val.cpu().numpy())
    del ed
    report = {"card": card, "scale": scale, "input_nnz": e.nnz,
              "mapping_s": {}}
    for m in (small_m, max(e.m, e.n)):
        t0 = time.perf_counter()
        c = glibc_square_mapping(m, 5)
        t1 = time.perf_counter()
        p = glibc_square_mapping(m, 5, native=False)
        t2 = time.perf_counter()
        if not np.array_equal(c, p):
            raise AssertionError(f"glibc mapping at m={m}: C and numpy "
                                 "differ")
        report["mapping_s"][m] = {"c": t1 - t0, "numpy": t2 - t1}
    with tempfile.TemporaryDirectory() as tmp:
        src_path = os.path.join(tmp, "rmat.bin.mtx")
        dst_path = os.path.join(tmp, "rmat_converted.bin.mtx")
        write_edgelist(e, src_path)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "graphmat_tpu_torch.io.converter",
             src_path, dst_path, "--inputformat", "0", "--bidirectional",
             "--randomizeID"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        report["converter_s"] = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"converter failed:\n{res.stdout}\n"
                                 f"{res.stderr[-2000:]}")
        # the same chain in memory, and its file
        e_bi = tf.remove_duplicate_edges(tf.create_bidirectional_edges(
            tf.remove_selfedges(load_edgelist(src_path))))
        n = max(e_bi.m, e_bi.n)
        e_bi.m = e_bi.n = n
        e_conv, perm = tf.randomize_vertex_ids(e_bi, seed=5)
        want_out = (f"Read {e.nnz} edges, {max(e.m, e.n)} vertices\n"
                    f"Writing {e_conv.nnz} edges\n")
        if res.stdout != want_out:
            raise AssertionError(f"converter printed {res.stdout!r}, not "
                                 f"{want_out!r}")
        ref_path = os.path.join(tmp, "chain.bin.mtx")
        write_edgelist(e_conv, ref_path)
        with open(dst_path, "rb") as f1, open(ref_path, "rb") as f2:
            if f1.read() != f2.read():
                raise AssertionError("converter output differs from the "
                                     "transform chain's file")
        g_conv = read_mtx(dst_path, device=device)
    report["output_nnz"] = e_conv.nnz
    if g_conv.device.type != torch.device(device).type:
        raise AssertionError(f"read_mtx built the graph on {g_conv.device}")
    ge = g_conv.get_edges()

    def keyed(a):
        sd = edges0(a, device)
        key, order = torch.sort(sd[0] * n + sd[1])
        return key, torch.as_tensor(np.asarray(a.val), device=device)[order]
    (k1_, v1), (k2_, v2) = keyed(ge), keyed(e_conv)
    if not (torch.equal(k1_, k2_) and torch.equal(v1.long(), v2.long())):
        raise AssertionError("read_mtx's edges differ from the transform "
                             "chain's")
    del k1_, v1, k2_, v2
    # PageRank on the converted file's graph against the unconverted
    # graph: the float32 vector through the permutation, the steps in
    # float64 (the float32 steps move with each row's sum order, ROADMAP
    # H1: logged)
    conv = pagerank_routes("converted", g_conv, cuda=cuda)
    del g_conv
    g_un = Graph(e_bi, device=device)
    unconv = pagerank_routes("unconverted", g_un, cuda=cuda)
    del g_un
    report["pagerank_iterations"] = {}
    report["pagerank_rel_err"] = {}
    for route in ("v2u", "v2"):
        pr_c, it_c = conv[route]
        pr_u, it_u = unconv[route]
        rel = rel_err(pr_c[perm - 1], pr_u)
        if not np.isfinite(pr_c).all() or rel > CONVERT_RTOL:
            raise AssertionError(f"converted PageRank ({route}): off the "
                                 f"unconverted one by {rel}")
        report["pagerank_iterations"][route] = {"converted": it_c,
                                                "unconverted": it_u}
        report["pagerank_rel_err"][route] = rel
    f64 = {"converted": pagerank_f64(*edges0(ge, device), n),
           "unconverted": pagerank_f64(*edges0(e_bi, device), n)}
    report["pagerank_f64"] = {k: {"steps": it, "last_largest_changes":
                                  big[-3:]} for k, (it, big) in f64.items()}
    if f64["converted"][0] != f64["unconverted"][0]:
        raise AssertionError(
            f"float64 PageRank: {f64['converted'][0]} steps on the "
            f"converted graph, {f64['unconverted'][0]} on the unconverted")
    check_push_pagerank("converted graph", conv)
    report["seconds"] = time.perf_counter() - t_start
    log("phase 21 (b): " + json.dumps(report))
    return report


# ----------------------------------------------------- the RMAT stream

# (scale, edge factor, seed) -> (edges, hash) of the deduplicated draw,
# the hash sum(src * (n + 1) + dst) mod 2^61 over the 1-based ids: taken
# on the host from the JAX package's gm_rmat_gen
# (graphmat_tpu/native/planner.cpp:1627) through
# graphmat_tpu.utils.generators.rmat_edgelist(22, 16, seed=1,
# native=True), the graph bench.py draws
RMAT_GOLDEN = {(22, 16, 1): (65_243_295, 263_620_767_749_746_564)}


def rmat_hash(e):
    """sum(src * (n + 1) + dst) mod 2^61 of an edge list on its device
    (int64 sums wrap mod 2^64, which 2^61 divides)."""
    import torch
    src = torch.as_tensor(e.src).long()
    dst = torch.as_tensor(e.dst).long()
    return int((src * (e.n + 1) + dst).sum()) % (1 << 61)


def check_rmat_golden(e, scale, edge_factor, seed):
    """The draw against gm_rmat_gen's edge count and hash, where
    RMAT_GOLDEN holds them; a note for the log."""
    want = RMAT_GOLDEN.get((scale, edge_factor, seed))
    if want is None:
        return "no golden for this draw"
    got = (e.nnz, rmat_hash(e))
    if got != want:
        raise AssertionError(f"RMAT-{scale} x{edge_factor} seed {seed}: "
                             f"(edges, hash) {got}, gm_rmat_gen's {want}")
    return f"edges and hash equal gm_rmat_gen's {want}"


# ------------------------------------------- phase 23: the last modules

GENERIC_STEPS = 10    # phase 23 (a): fixed PageRank steps, each route
GENERIC_MESH = (2, 2)  # phase 23 (a) and (d)'s LocalMesh of the card
GENERIC_RTOL = 1e-5   # of max(1, |pr|): the scan's pairwise sums against
                      # K1's, and the tiles' against one device's
ENTRY_RTOL = 1e-6     # entry()'s step against its plain version
TEXT_WEIGHTS = 255    # phase 23 (b)'s weights, 1..255
TEXT_WRITE_S = 30     # past this, phase 23 (b) writes RMAT-18 instead


def generic_programs():
    """SSSP with its min, and PageRank with its sum, as generic Monoids
    (torch.minimum with the int32 infinity, torch.add with 0): both
    still declare the kernel's semiring, and the router must take the
    segment route."""
    import torch
    from graphmat_tpu_torch import Monoid
    from graphmat_tpu_torch.apps import pagerank, sssp

    class GenericMinPlus(sssp.SSSPProgram):
        reduce = Monoid("generic", torch.minimum,
                        lambda dt: torch.iinfo(dt).max)

    class GenericPageRank(pagerank.PageRankProgram):
        reduce = Monoid("generic", torch.add, lambda dt: 0)
    return GenericMinPlus, GenericPageRank


def generic_runs(g, device, generic, steps=GENERIC_STEPS):
    """SSSP from vertex 1 to convergence and ``steps`` PageRank steps on
    ``g`` through K1 (``generic=False``) or the generic ⊕'s segment route:
    {"dist", "sssp_steps", "sssp_s", "pr", "pr_step_ms"}.  The times are
    of a second run of each (the first built the work splits): the SSSP
    run again from the start, ``steps`` more PageRank steps."""
    from graphmat_tpu_torch.apps import pagerank, sssp
    from graphmat_tpu_torch.core.runtime import engine_for
    min_plus, pr_prog = (generic_programs() if generic else
                         (sssp.SSSPProgram, pagerank.PageRankProgram))
    sssp.init_sssp_graph(g, 1)
    eng = engine_for(min_plus(), g)
    if generic and (eng._semiring is not None or eng._vec is not None):
        raise AssertionError("a generic ⊕ was routed to a kernel")
    out = {"sssp_steps": eng.run(), "dist": g.vp_numpy()["distance"]}
    sssp.init_sssp_graph(g, 1)
    _, out["sssp_s"] = timed(eng.run, device)
    pagerank.init_pagerank_graph(g)
    g.set_all_active()
    engine_for(pagerank.DegreeProgram(), g).run(iterations=1)
    eng = engine_for(pr_prog(), g)
    eng.run(iterations=steps)
    out["pr"] = g.vp_numpy()["pagerank"]
    _, sec = timed(lambda: eng.run(iterations=steps), device)
    out["pr_step_ms"] = sec / steps * 1e3
    return out


def phase_generic(device, card, e=None, scale=22, mesh_scale=20,
                  edge_factor=16, seed=1):
    """Phase 23 (a): the generic ⊕ at full width.  On RMAT-``scale`` (phase
    5's edge list, or a new draw) a min-plus SSSP whose reduce is
    ``Monoid("generic", torch.minimum, int32 max)`` gives K1's min
    route's distances exactly, and a PageRank whose reduce is
    ``Monoid("generic", torch.add, 0)`` K1's vector within GENERIC_RTOL
    after GENERIC_STEPS steps; on RMAT-``mesh_scale`` over GENERIC_MESH
    tiles of ``device`` each gives the one-device result (min exactly,
    the sum within GENERIC_RTOL).  The step times of both routes and the
    generic runs' peak device memory are logged.  The K1 runs are the
    reference: their launches count in no record."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    cuda = torch.device(device).type == "cuda"
    res = {"card": card}
    if e is None:
        e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    g = Graph(e, device=device)
    k1 = generic_runs(g, device, generic=False)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    gen = generic_runs(g, device, generic=True)
    check_equal(f"RMAT-{scale} generic min-plus", gen["dist"], k1["dist"])
    if gen["sssp_steps"] != k1["sssp_steps"]:
        raise AssertionError(f"RMAT-{scale} generic min-plus: "
                             f"{gen['sssp_steps']} steps, K1 "
                             f"{k1['sssp_steps']}")
    res[f"rmat{scale}"] = {
        "edges": e.nnz, "sssp_steps": k1["sssp_steps"],
        "pr_max_rel_err": check_close(f"RMAT-{scale} generic PageRank",
                                      gen["pr"], k1["pr"], GENERIC_RTOL),
        "k1": {k: k1[k] for k in ("sssp_s", "pr_step_ms")},
        "generic": {k: gen[k] for k in ("sssp_s", "pr_step_ms")},
        "generic_peak_bytes": (torch.cuda.max_memory_allocated()
                               if cuda else None)}
    del g, k1, gen
    if cuda:
        torch.cuda.empty_cache()
    em = rmat_edgelist(mesh_scale, edge_factor, seed=seed, device=device)
    one = generic_runs(Graph(em, device=device), device, generic=True)
    nt = GENERIC_MESH[0] * GENERIC_MESH[1]
    tiles = generic_runs(DistGraph(em, LocalMesh([device] * nt,
                                                 GENERIC_MESH)),
                         device, generic=True)
    check_equal(f"RMAT-{mesh_scale} generic min-plus on tiles",
                tiles["dist"], one["dist"])
    res[f"rmat{mesh_scale}_mesh"] = {
        "edges": em.nnz, "mesh": list(GENERIC_MESH),
        "sssp_steps": tiles["sssp_steps"],
        "pr_max_rel_err": check_close(
            f"RMAT-{mesh_scale} generic PageRank on tiles", tiles["pr"],
            one["pr"], GENERIC_RTOL),
        "one_device": {k: one[k] for k in ("sssp_s", "pr_step_ms")},
        "tiles": {k: tiles[k] for k in ("sssp_s", "pr_step_ms")}}
    log("phase 23 (a): the generic ⊕ gives K1's results: "
        + json.dumps(res))
    return res


def write_text_edges(e, path):
    """``e`` as the text format ``write_edgelist`` writes (an "m n nnz"
    header, then "src dst val" rows), built from lists."""
    cols = [np.asarray(a.cpu() if hasattr(a, "cpu") else a).tolist()
            for a in (e.src, e.dst, e.val)]
    with open(path, "w") as f:
        f.write(f"{e.m} {e.n} {e.nnz}\n")
        f.write("\n".join(map("{} {} {}".format, *cols)))
        f.write("\n")


def phase_text_loader(device, card, scale=20, edge_factor=16, seed=1,
                      small_scale=18):
    """Phase 23 (b): RMAT-``scale`` x 16 with weights 1..TEXT_WEIGHTS,
    written once as text (RMAT-``small_scale`` where that write takes more
    than TEXT_WRITE_S), drawn on ``device``, read back by
    ``load_edgelist(binaryformat=False)``
    through the port's native parser and by ``np.loadtxt``: the arrays
    equal each other and the edges written.  Both host times logged."""
    from graphmat_tpu_torch import load_edgelist
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    out_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "phase23_edges.txt")
    res = {"card": card}
    try:
        for sc in (scale, small_scale):
            e = rmat_edgelist(sc, edge_factor, seed=seed,
                              weight_range=TEXT_WEIGHTS, device=device)
            t0 = time.perf_counter()
            write_text_edges(e, path)
            res.update(scale=sc, edges=e.nnz, bytes=os.path.getsize(path),
                       write_s=time.perf_counter() - t0)
            if res["write_s"] <= TEXT_WRITE_S:
                break
            log(f"phase 23 (b): writing RMAT-{sc} took "
                f"{res['write_s']:.1f} s; RMAT-{small_scale} instead")
        t0 = time.perf_counter()
        got = load_edgelist(path, binaryformat=False)
        res["native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        data = np.loadtxt(path, skiprows=1, ndmin=2, dtype=np.int64)
        res["loadtxt_s"] = time.perf_counter() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    want = [data[:, i].astype(np.int32) for i in range(3)]
    written = [a.cpu().numpy() for a in (e.src, e.dst, e.val)]
    for name, a, b, c in zip(("src", "dst", "val"), got.astuple(), want,
                             written):
        if not (np.array_equal(a, b) and np.array_equal(a, c)
                and a.dtype == np.int32):
            raise AssertionError(f"phase 23 (b): the native parser's {name} "
                                 "differs from np.loadtxt's")
    if (got.m, got.n) != (e.m, e.n):
        raise AssertionError("phase 23 (b): the header's dims differ")
    log("phase 23 (b): the native text parser gives np.loadtxt's arrays: "
        + json.dumps(res))
    return res


def phase_graft(device, card):
    """Phase 23 (c): ``graft_entry.entry()``'s step (one K1 dense launch)
    against its plain version within ENTRY_RTOL, then
    ``dryrun_multichip(4)`` and ``(8)`` on tiles of ``device``, their
    launches counted (the entry points' main path)."""
    import torch
    from graphmat_tpu_torch import graft_entry
    res = {"card": card}
    fn, args = graft_entry.entry(device)
    reset_all_counts()
    out, sec = timed(lambda: fn(*args), device)
    res["entry"] = {"launches": read_all_counts(), "s": sec,
                    "max_rel_err": check_close(
                        "entry() step", out.cpu().numpy(),
                        graft_entry.pagerank_step_reference(*args)
                        .cpu().numpy(), ENTRY_RTOL)}
    counts = {}
    for n in (4, 8):
        reset_all_counts()
        _, res[f"dryrun{n}_s"] = timed(
            lambda n=n: graft_entry.dryrun_multichip(n, device), device)
        for k, v in read_all_counts().items():
            counts[k] = counts.get(k, 0) + v
    if torch.device(device).type == "cuda":
        need_launch("dryrun_multichip", counts, "k1", "k2", "k3", "push")
    for k, v in res["entry"]["launches"].items():
        counts[k] = counts.get(k, 0) + v
    res["launches"] = counts
    log("phase 23 (c): entry() and dryrun_multichip(4), (8): "
        + json.dumps(res))
    return res


def phase_validators(device, card, e=None, scale=22, edge_factor=16,
                     seed=1):
    """Phase 23 (d): ``GRAPHMAT_DEBUG=1`` on RMAT-``scale`` (phase 5's
    edge list, or a new draw): a Graph with both directions uncompacted
    and one compacted (``compact=True``), and the same edges on
    GENERIC_MESH tiles, built with the validators on (each CSR and each
    K1 and push split checked as it is built), then ``validate_graph``
    on each, timed."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.ops import spmv2, spmv2u
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    from graphmat_tpu_torch.utils.debug import validate_graph
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    if e is None:
        e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    nt = GENERIC_MESH[0] * GENERIC_MESH[1]
    builds = {
        "uncompacted": lambda: Graph(e, device=device, compact=False),
        "compacted": lambda: Graph(e, device=device, compact=True),
        "tiles": lambda: DistGraph(e, LocalMesh([device] * nt,
                                                GENERIC_MESH))}
    res = {"card": card, "edges": e.nnz}
    old = os.environ.get("GRAPHMAT_DEBUG")
    os.environ["GRAPHMAT_DEBUG"] = "1"
    try:
        for name, build in builds.items():
            def built():
                g = build()
                for cs in (g._tiles.values() if isinstance(g, DistGraph)
                           else ([c] for c in g._csr.values())):
                    for c in cs:
                        spmv2u.plan_for(c)
                        spmv2.plan_for(c)
                return g
            g, build_s = timed(built, device)
            _, check_s = timed(lambda: validate_graph(g), device)
            res[name] = {"build_and_check_s": build_s,
                         "validate_graph_s": check_s}
            del g
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if old is None:
            del os.environ["GRAPHMAT_DEBUG"]
        else:
            os.environ["GRAPHMAT_DEBUG"] = old
    log("phase 23 (d): the debug validators pass: " + json.dumps(res))
    return res


# ------------------------------------------------ phase 24: the kernels


def bound_ms(nbytes, flops=0.0):
    """(ms, "bytes" or "operations"): the least time of a call that moves
    ``nbytes`` and does ``flops`` float32 operations, at the card's peaks
    (``perfbench/roofline.py``), and which of the two sets it."""
    by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS
          else "operations")
    return bound_s(nbytes, flops) * 1e3, by


def timed_pair(kernel, plain, reps, plain_reps, plain_warm=1):
    """Median ms of ``kernel()`` over ``reps`` runs and of ``plain()``
    over ``plain_reps`` (CUDA events), and the last output of each."""
    out = {}

    def keep(name, fn):
        def run():
            out[name] = fn()
        return run
    ms = event_ms(keep("kernel", kernel), reps)
    plain_ms = event_ms(keep("plain", plain), plain_reps, warm=plain_warm)
    return ms, plain_ms, out["kernel"], out["plain"]


def k3_err(what, csr, op, x, vp, extra, params, out, ref, sent=None,
           long_rows=False):
    """The largest |out - ref| of a K3 output and its plain version, each
    row within SUM_RTOL of :func:`k3_row_scale`; on ``long_rows`` within
    float32 summation's own 2 (deg - 1) units where that is larger (the
    kernel and index_add_ sum a row of deg terms in other orders)."""
    import torch
    scale = k3_row_scale(csr, op, x, vp, extra, params, sent)
    rtol = SUM_RTOL
    if long_rows:
        deg = csr.rowptr.diff().to(scale.dtype)[:, None]
        rtol = torch.clamp(2 * (deg - 1) * F32_UNIT, min=SUM_RTOL)
    return compare_out(what, out.flatten(), ref.flatten(), "sum",
                       (scale * rtol).flatten())


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


def sparse_bound(csr, sent, k, out_cols, ops_per_edge):
    """The least time of one sparse-mode call: the bytes the function must
    move (rowptr and every col, to find the sent edges; the sent flags;
    the sent edges' values; each sent sender's row of x and each receiving
    row of vp once; y and the count) against its operations on the sent
    edges.  Returns (ms, bound_by, sent edges)."""
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
    return (*bound_ms(nbytes, ops_per_edge * n_edges), n_edges)


def k3_skewed(device, k=20, seed=7400000019):
    """K3 ``sgd`` and ``sgd_sqerr`` alone on the benchmark's own skewed
    MovieLens-25M draw (``perfbench/gen/ratings.py`` with
    ``perfbench/configs/movielens25m-k20.json``, the graph as
    ``perfbench/port.py`` builds it), each direction: ``dst`` the film
    rows (the most rated film about 81,500 ratings, cut into chunks of
    1024), ``src`` the user rows; each timed output against its plain
    version.  Returns ({each time in ms, ``chunks``: each direction's
    count}, max |error|)."""
    import torch
    from graphmat_tpu_torch.ops import spmv2u
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    from perfbench import harness, port
    cfg = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                      "movielens25m-k20.json")))
    inp = harness.generator(cfg).make(cfg, seed, device)
    g = port.graph(inp, device, val=inp["val"])
    del inp
    gen = torch.Generator(device=device)
    gen.manual_seed(47)
    x, vp, _ = k3_inputs("sgd", k, g.n_pad, gen, device)
    out, chunks, err = {}, {}, 0.0
    for recv in ("dst", "src"):
        csr = g.csr(recv)
        chunks[recv] = spmv2u.plan_for(csr).chunk_row.numel()
        for op in ("sgd", "sgd_sqerr"):
            ms, _, y, ref = timed_pair(
                lambda: sv.spmv_vec(csr, x, op, vp),
                lambda: sv.spmv_vec_reference(csr, x, op, vp), 10, 1,
                plain_warm=0)
            out[f"{op}_skewed_{recv}_ms"] = ms
            err = max(err, k3_err(f"K3 {op} skewed {recv}", csr, op, x, vp,
                                  None, None, y, ref, long_rows=True))
    out["chunks"] = chunks
    return out, err


def phase_kernel_times(card, e, g, g_sgd, g_lda, gn_lda, g_act, k=20,
                       scale=22):
    """Phase 24: each kernel of the ``kernels`` line timed alone (CUDA
    events, median) beside its plain version and, where PyTorch has one,
    a library call, on the app phases' inputs: phase 5's RMAT-22 edge list
    ``e`` and its compacted graph ``g`` (K1, K2; the push's dense max and
    the mark pass on the uncompacted graph the card's ``compact="auto"``
    builds), phase 9's MovieLens-25M graph ``g_sgd`` (K3 ``sgd``, the
    rand_r draw), phase 10's NYTimes graph ``g_lda`` (K3 ``lda``), phase
    17's ``g_act`` (the sparse mode at 10% of senders sent, K5's count
    alone), the benchmark's skewed MovieLens draw (K3), and
    RMAT-``scale``'s TriangleCounting arguments (T1, T2) and RMAT keys
    (the weights kernel checked on the kept keys).
    Each timed output is held against its plain version's
    (``max_abs_err``); each bound is the call's least bytes, or
    operations, at the card's peaks.  Returns {record name: its
    numbers}."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import lda
    from graphmat_tpu_torch.io.transforms import convert_to_upper_triangular
    from graphmat_tpu_torch.ops import (compact, rand_r, rmat, spmv2,
                                        spmv2u, triangles as tri)
    from graphmat_tpu_torch.ops import spmv as k5
    from graphmat_tpu_torch.ops import spmv_vec as ss
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    from graphmat_tpu_torch.utils.reference_rng import rand_r_uniform_np
    dev = g.device
    rows = {}
    if dev.type == "cuda":
        log(f"phase 24: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
            f"allocated as it starts")

    def record(name, ms, plain_ms, bound, err, library_ms=None, **extra):
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                          bound_by=bound[1], max_abs_err=err,
                          library_ms=library_ms, **extra)

    # K1's dense sum and K2 on phase 5's compacted graph, one direction
    csr = g.csr("dst")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    x = torch.rand(g.n_pad, generator=gen, device=dev)
    # K1 alone: K2 writes the extension here, once
    col, x_aux, _ = spmv2u._operand(csr, x, None)
    args, kw = (csr.rowptr, col, x), {"x_aux": x_aux}
    plan = spmv2u.plan_for(csr)
    ms, plain_ms, y, ref = timed_pair(
        lambda: spmv2u.spmv_csr(*args, "sum", "x", plan=plan, **kw),
        lambda: spmv2u.spmv_csr_reference(*args, "sum", "x", row=csr.row,
                                          **kw), 20, 5, plain_warm=2)
    colx = csr.col.long()
    record("spmv2u", ms, plain_ms, bound_ms(4 * (
        csr.rowptr.numel() + csr.nnz + x.numel() + csr.n_aux + csr.n_rows)),
        compare_out("K1 dense sum", y, ref, "sum", sum_bound(
            csr.row.long(), colx, x[colx], csr.n_rows)),
        cusparse_ms(csr.rowptr, csr.col, x))
    src, n_aux = csr.src_of_pos, csr.n_aux
    pos = src[:n_aux].long()
    ms, plain_ms, y, ref = timed_pair(
        lambda: compact.aux_gather(x, src, csr.x_ext),
        lambda: compact.aux_gather_reference(x, src), 20, 20, plain_warm=2)
    # src_of_pos read, the values written, each 32-byte sector of x that
    # the senders touch read once
    record("aux_gather", ms, plain_ms, bound_ms(
        8 * n_aux + 32 * torch.unique(pos >> 3).numel()),
        exact_err("K2", y[:n_aux].view(torch.int32),
                  ref[:n_aux].view(torch.int32)),
        event_ms(lambda: torch.index_select(x, 0, pos), 20),
        positions=n_aux)
    del col, x_aux, args, kw, y, ref, pos

    # K3 at phase 9's and phase 10's shapes, one direction
    c_sgd, lv = g_sgd.csr("dst"), g_sgd.vp["lv"]
    ms, plain_ms, y, ref = timed_pair(
        lambda: sv.spmv_vec(c_sgd, lv, "sgd", lv),
        lambda: sv.spmv_vec_reference(c_sgd, lv, "sgd", lv), 10, 3)
    # rowptr, col, val, x, vp and y once; 4K operations an edge
    record("spmv_vec2", ms, plain_ms, bound_ms(
        4 * (c_sgd.rowptr.numel() + 2 * c_sgd.nnz + 3 * k * c_sgd.n_rows),
        4 * k * c_sgd.nnz),
        k3_err("K3 sgd", c_sgd, "sgd", lv, lv, None, None, y, ref))
    skewed, err = k3_skewed(dev, k)
    record("spmv_vec2 (skewed)", skewed["sgd_skewed_dst_ms"], None,
           (rows["spmv_vec2"]["bound_ms"], rows["spmv_vec2"]["bound_by"]),
           err, skewed=skewed)
    nterms = g_lda.n - int(g_lda.vp["is_doc"].sum())
    prog = lda.LDAProgram(k, vocab_size=nterms, ndoc=g_lda.n - nterms)
    gn = torch.as_tensor(gn_lda, device=dev)
    c_lda = g_lda.csr("dst")
    x_lda, vp_lda = prog._encode_msg(gn, g_lda.vp), prog._encode_vp(
        gn, g_lda.vp)
    lda_args = (c_lda, x_lda, "lda", vp_lda, gn, prog.params)
    ms, plain_ms, y, ref = timed_pair(
        lambda: sv.spmv_vec(*lda_args),
        lambda: sv.spmv_vec_reference(*lda_args), 10, 3)
    # rowptr, col, val, x and vp (K + 1 columns), extra and y (K columns)
    # once; 8K operations an edge (two offsets, a product, a division and
    # a sum for gamma, then a division, a product and a sum)
    record("spmv_vec2 (lda)", ms, plain_ms, bound_ms(
        4 * (c_lda.rowptr.numel() + 2 * c_lda.nnz
             + (k + 1) * (c_lda.n_send + c_lda.n_rows) + k
             + k * c_lda.n_rows), 8 * k * c_lda.nnz),
        k3_err("K3 lda", c_lda, "lda", x_lda, vp_lda, gn, prog.params, y,
               ref))
    del x_lda, vp_lda, lda_args, y, ref

    # the push's own dense max and its mark pass at 1% of senders, on
    # phase 5's edges as the card builds them by default (uncompacted)
    g_off = Graph(e, device=dev, permute="degree", compact="auto")
    if any(g_off.csr(r).src_of_pos is not None for r in ("dst", "src")):
        raise AssertionError("phase 24: compact='auto' compacted RMAT-22 "
                             "on the card")
    sc = g_off.sender_csr("dst")
    n = g_off.n_pad
    gen.manual_seed(5)
    x = torch.rand(n, generator=gen, device=dev)
    ms, plain_ms, y, ref = timed_pair(
        lambda: spmv2.spmv_push(sc, x, "max", "x"),
        lambda: spmv2.spmv_push_reference(sc, x, "max", "x"), 20, 3)
    record("spmv2", ms, plain_ms, bound_ms(
        4 * (sc.rowptr.numel() + sc.nnz + 2 * n)),
        compare_out("push dense max", y, ref, "max"))
    sent = (torch.rand(n, generator=gen, device=dev) < 0.01).to(torch.uint8)
    senders = int(sent.sum())
    pushed = int(sc.rowptr.diff()[sent.bool()].sum())
    mark_plan = spmv2.plan_for(sc)
    ms, plain_ms, y, ref = timed_pair(
        lambda: spmv2.push_mark(sc.rowptr, sc.col, sent, n, plan=mark_plan),
        lambda: spmv2.push_mark_reference(sc.rowptr, sc.col, sent, n,
                                          sc.row), 20, 3)
    # the sent mask, each sender's rowptr pair, each pushed edge's
    # receiver once, the marks written
    record("spmv2 mark pass", ms, plain_ms, bound_ms(
        n + 8 * senders + 4 * pushed + n),
        exact_err("the mark pass", y, ref), senders=senders,
        pushed_edges=pushed)
    del g_off, sc, x, sent, y, ref

    # the sparse mode (10% of senders sent) and K5's count alone on
    # phase 17's graph
    csr, lv = g_act.csr("dst"), g_act.vp["lv"]
    gen.manual_seed(31)
    sent = (torch.rand(g_act.n_pad, generator=gen, device=dev) < 0.1).to(
        torch.uint8)
    ms, plain_ms, (y, got), (ref, got_ref) = timed_pair(
        lambda: ss.spmv_vec_sparse(csr, lv, "sgd", sent, vp=lv),
        lambda: ss.spmv_vec_sparse_reference(csr, lv, "sgd", sent, vp=lv),
        10, 3)
    exact_err("the sparse mode's got count", got, got_ref)
    ms_b, by, n_edges = sparse_bound(csr, sent, k, k, 4 * k)
    record("spmv_vec2_sparse", ms, plain_ms, (ms_b, by), k3_err(
        "K3 sgd sparse 10%", csr, "sgd", lv, lv, None, None, y, ref,
        sent=sent), sent_edges=n_edges)
    sentf = (torch.rand(g_act.n_pad, generator=gen, device=dev)
             < 0.1).float()
    ms, plain_ms, y, ref = timed_pair(
        lambda: k5.spmv(csr, sentf, "sum"),
        lambda: k5.spmv_reference(csr, sentf, "sum"), 20, 5, plain_warm=2)
    colx = csr.col.long()
    record("spmv_vec2_sparse got count (alone: spmv2u op x)", ms, plain_ms,
           bound_ms(4 * (csr.rowptr.numel() + csr.nnz + csr.n_send
                         + csr.n_rows)),
           compare_out("K5's count", y, ref, "sum", sum_bound(
               csr.row.long(), colx, sentf[colx], csr.n_rows)),
           cusparse_ms(csr.rowptr, csr.col, sentf))
    del sent, sentf, y, ref, got, got_ref

    # T1 and T2 on RMAT-22's TriangleCounting arguments; each plain
    # version once (T2's takes tens of seconds there)
    et = convert_to_upper_triangular(rmat_edgelist(scale, 16, seed=1,
                                                   device=dev))
    u, v = tc_pairs(et)
    nacc = et.n + 1
    t1, *rest = tri._kernel_args(u, v, et.n, canonical=True)
    del et, u, v
    pv = torch.zeros(nacc, dtype=torch.int32, device=dev)
    bm, sm, iu = t1[0], t1[1], t1[2]
    planes = 3 * iu.numel() * 4 + nacc * 4
    ms, plain_ms, y, ref = timed_pair(
        lambda: tri.core_count(*t1, pv.zero_()),
        lambda: tri.core_count_reference(*t1, torch.zeros_like(pv)),
        10, 1, plain_warm=0)
    # the summaries, the bitmap's nonzero words and three planes, once
    record("tc_core_count", ms, plain_ms, bound_ms(
        sm.numel() * 4 + int((bm != 0).sum()) * 4 + planes),
        exact_err(f"RMAT-{scale} T1", y, ref), edges=iu.numel())
    for t2 in rest:   # T2's arguments, when some edge probes
        mats, gk = t2[0], t2[2]
        ms, plain_ms, y, ref = timed_pair(
            lambda: tri.tail_count(*t2, pv.zero_()),
            lambda: tri.tail_count_reference(*t2, torch.zeros_like(pv)),
            10, 1, plain_warm=0)
        # the tail lists, four planes and the counts, once
        record("tc_tail_count", ms, plain_ms, bound_ms(
            mats.numel() * 4 + 4 * gk.numel() * 4 + nacc * 4),
            exact_err(f"RMAT-{scale} T2", y, ref), probes=gk.numel())
    del t1, rest, bm, sm, iu, pv, y, ref

    # the RMAT keys of RMAT-22 x 16 (8 B a key written)
    nnz = (1 << scale) * 16
    rmat_args = (scale, nnz, 0.57, 0.19, 0.19, 1)
    ms, plain_ms, y, ref = timed_pair(
        lambda: rmat.rmat_keys(*rmat_args, dev),
        lambda: rmat.rmat_keys_reference(*rmat_args, dev), 10, 1)
    kerr = exact_err(f"RMAT-{scale} keys", y, ref)
    # the weights kernel on the kept keys (sorted, distinct, no self
    # loops), as phase 23 (b)'s draw calls it
    kept = torch.unique(y)
    kept = kept[(kept >> 32) != (kept & 0xFFFFFFFF)]
    del y, ref
    verr = exact_err(f"RMAT-{scale} weights",
                     rmat.rmat_weights(kept, 1, TEXT_WEIGHTS),
                     rmat.rmat_weights_reference(kept, 1, TEXT_WEIGHTS))
    record("rmat", ms, plain_ms, bound_ms(8 * nnz), max(kerr, verr),
           keys=nnz)
    del kept
    torch.cuda.empty_cache()

    # SGD's initial factors at phase 9's shape, beside the host route the
    # kernel replaced (numpy draw, cast, upload; host clock)
    nv = g_sgd.n
    seeds = np.arange(1, nv + 1, dtype=np.uint32)
    host = []
    for _ in range(3):
        sync(dev)
        t0 = time.perf_counter()
        torch.as_tensor(rand_r_uniform_np(seeds, k).astype(np.float32),
                        device=dev)
        sync(dev)
        host.append((time.perf_counter() - t0) * 1e3)
    ms, plain_ms, y, ref = timed_pair(
        lambda: rand_r.rand_r_uniform(1, nv, k, torch.float32, dev),
        lambda: rand_r.rand_r_uniform_reference(1, nv, k, torch.float32,
                                                dev), 50, 5)
    record("rand_r", ms, plain_ms, bound_ms(nv * k * 4),
           exact_err("the rand_r draw", y, ref),
           host_route_ms=statistics.median(host))
    log(f"phase 24 ({card}): " + json.dumps(rows))
    return rows


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
    needs = {24: {5, 9, 10, 17}}

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

    from graphmat_tpu_torch import native
    from graphmat_tpu_torch.ops import _lib
    t0 = time.perf_counter()
    lib_path = _lib.build()
    _lib.load()
    log(f"phase 2: kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({lib_path.name})")
    log(lib_path.with_suffix(".log").read_text().strip())
    t0 = time.perf_counter()
    host_path = native.build()
    native.load()
    log(f"phase 2: host library built and loaded in "
        f"{time.perf_counter() - t0:.1f} s ({host_path.name})")

    e = g = None   # phase 5's RMAT-22 edge list and compacted graph
    if want(4):
        phase_golden("cuda")
    if want(5):
        e, g, _, k1, k2, krm = phase_slice("cuda")
    if want(8):
        phase_golden_ml("cuda")
    if want(9):
        _, g_sgd, k3_sgd, krr = phase_sgd(
            "cuda", MOVIELENS_25M["users"], MOVIELENS_25M["items"],
            MOVIELENS_25M["ratings"])
    if want(10):
        _, g_lda, gn_lda, k3_lda = phase_lda(
            "cuda", NYTIMES["docs"], NYTIMES["terms"], NYTIMES["entries"])
    if want(17):
        k4_path, _, g_act = phase_active_vec(
            "cuda", card, MOVIELENS_25M["users"], MOVIELENS_25M["items"],
            MOVIELENS_25M["ratings"])
    if want(24):
        t = phase_kernel_times(card, e, g, g_sgd, g_lda, gn_lda, g_act)
    # the later phases run with none of these graphs held
    g = g_sgd = g_lda = gn_lda = g_act = None
    torch.cuda.empty_cache()
    if want(13):
        phase_golden_traversal()
    if want(14):
        trav = phase_traversal("cuda")
    if want(19):
        phase_tc_golden()
        tc_run = phase_tc_slice("cuda")
    dist_b = {}
    if want(20):
        phase_dist_routes("cuda")
        dist_b = phase_dist_slice("cuda", card, e=e)
    if want(21):
        phase_push_sums("cuda", card, e=e)
        phase_converter("cuda", card)
    if want(23):
        t23 = time.perf_counter()
        phase_generic("cuda", card, e=e)
        phase_text_loader("cuda", card)
        p23 = phase_graft("cuda", card)
        phase_validators("cuda", card, e=e)
        log(f"phase 23: {time.perf_counter() - t23:.1f} s")
    del e
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    if only:
        return

    def total(kernel):
        """Launches of ``kernel`` over phase 14's runs."""
        return sum(launches(c, kernel) for routes in
                   trav["launches"].values() for c in routes.values())
    # phase 20 (b): the sharded main path's runs launch K1 on tiles; the
    # checks of phase 20 (a) are not the main path and count nowhere here
    # phase 23 (c): the entry points' runs (entry() and the dry runs)
    graft = p23["launches"]

    def row(name, source, replaces, n, *extra):
        """``name``'s record of phase 24's numbers, with the fields
        ``extra`` of its own."""
        r = t[name]
        return dict(kernel_record(
            name, source, replaces, n, r["max_abs_err"], r["ms"],
            r["plain_ms"], r["bound_ms"], r["bound_by"], r["library_ms"]),
            **{k: r[k] for k in extra})
    k3_src = "graphmat_tpu_torch/csrc/spmv_vec2.cu"
    k3_tpu = "graphmat_tpu/ops/pallas_spmv_vec2.py:510"
    kernels = {"kernels": [
        row("spmv2u", "graphmat_tpu_torch/csrc/spmv2u.cu",
            "graphmat_tpu/ops/pallas_spmv2u.py:918",
            sum(k1.values()) + total("k1") + launches(dist_b, "k1")
            + launches(graft, "k1")),
        row("aux_gather", "graphmat_tpu_torch/csrc/compact.cu",
            "graphmat_tpu/ops/pallas_compact.py:408",
            k2["aux_gather"] + total("k2") + launches(graft, "k2")),
        row("spmv_vec2", k3_src, k3_tpu,
            sum(k3_sgd.values()) + sum(k3_lda.values())
            + launches(graft, "k3")),
        # the same kernel's sgd and sgd_sqerr on the benchmark's skewed
        # MovieLens-25M draw, each direction, beside the record above's
        # uniform draw
        row("spmv_vec2 (skewed)", k3_src, k3_tpu, sum(k3_sgd.values()),
            "skewed"),
        # the same kernel's lda op at NYTimes shape (its launches are
        # counted in the record above too)
        row("spmv_vec2 (lda)", k3_src, k3_tpu, sum(k3_lda.values())),
        # the push kernel (K7, its min/max modes): its dense max at
        # RMAT-22; a push sum is K1's sweep and counts there
        row("spmv2", "graphmat_tpu_torch/csrc/spmv2.cu",
            "graphmat_tpu/ops/pallas_spmv2.py:1154",
            total("push") - total("push.mark") + launches(graft, "push")
            - launches(graft, "push.mark")),
        # K6's own part, the mark pass of a sparse push sum, 1% of senders
        # sent at RMAT-22; no PyTorch call computes it
        row("spmv2 mark pass", "graphmat_tpu_torch/csrc/spmv2.cu",
            "graphmat_tpu/ops/pallas_spmv2.py:388", total("push.mark")),
        # K4: the sparse mode, sgd, one direction, 10% of senders sent
        row("spmv_vec2_sparse", k3_src,
            "graphmat_tpu/ops/pallas_spmv_vec.py:65",
            sum(k4_path.values())),
        # K5: fused into every sparse-mode launch as its got count; timed
        # alone as K1 with op x over the sent bits of a 10% frontier
        row("spmv_vec2_sparse got count (alone: spmv2u op x)",
            f"{k3_src} and graphmat_tpu_torch/csrc/spmv2u.cu",
            "graphmat_tpu/ops/pallas_spmv.py:254", sum(k4_path.values())),
        # T1 and T2 at RMAT-22: TriangleCounting's two hot loops, which
        # the JAX package runs as XLA ops; no PyTorch call computes either
        # (torch has no popcount)
        row("tc_core_count", "graphmat_tpu_torch/csrc/triangles.cu",
            "graphmat_tpu/ops/triangles.py:439 (XLA loop, no Pallas "
            "kernel)", tc_run["rmat22"]["launches"].get("tc.core_count", 0)),
        row("tc_tail_count", "graphmat_tpu_torch/csrc/triangles.cu",
            "graphmat_tpu/ops/triangles.py:485 (XLA loop, no Pallas "
            "kernel)", tc_run["rmat22"]["launches"].get("tc.tail_count", 0)),
        # the RMAT stream's keys at RMAT-22, launched by phase 5's draw; no
        # PyTorch call computes splitmix64
        row("rmat", "graphmat_tpu_torch/csrc/rmat.cu",
            "graphmat_tpu/native/planner.cpp:1627 (gm_rmat_gen, C++/OpenMP; "
            "no Pallas kernel)", sum(krm.values())),
        # SGD's initial factors at MovieLens-25M shape: launched by phase
        # 9's init and run_sgd
        row("rand_r", "graphmat_tpu_torch/csrc/rand_r.cu",
            "graphmat_tpu/utils/reference_rng.py:54 (rand_r_uniform_np, "
            "numpy on the host; no Pallas kernel)", krr, "host_route_ms"),
    ]}
    idle = [r["name"] for r in kernels["kernels"] if r["launches"] == 0]
    if idle:
        raise AssertionError(f"the main path launched no {idle}")
    log(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
