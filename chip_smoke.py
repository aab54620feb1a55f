#!/usr/bin/env python3
"""Smoke test of graphmat_tpu_torch on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``graphmat_tpu_torch/csrc`` and
drives the port's main paths on the card: PageRank (K1, K2), then SGD
collaborative filtering and LDA (K3).  Phases, in order; any failure
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
   kernel path, on the plain path and with compaction off; each kernel
   alone at the slice's shapes beside its plain version; GTEPS and peak
   device memory;
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
    version, M edge-updates/s and M token-updates/s, peak device memory.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
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
LDA_INIT_RTOL = 1e-6  # of the row's sum: the terms are bitwise the same
                      # rand_r draws, normalised by a sum of another order
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
    k1_ms = event_ms(lambda: spmv_csr(*dense_args), 20)
    k1_plain_ms = event_ms(
        lambda: spmv_csr_reference(*dense_args, row=csr.row), 5)
    k1_err = check_spmv_case(
        type(csr)(csr.rowptr, csr.col_ext, csr.row, csr.val, ns),
        csr.x_ext, None, None, "sum", "x", "dense", g.device)
    csr_in = g.csr("src")
    sent = (torch.rand(csr_in.x_ext.numel(), generator=gen,
                       device=g.device) < 0.5).to(torch.uint8)
    got_args = (csr_in.rowptr, csr_in.col_ext, csr_in.x_ext, "sum", "x")
    k1_got_ms = event_ms(
        lambda: spmv_csr(*got_args, sent=sent, want_got=True), 20)
    k1_got_plain_ms = event_ms(
        lambda: spmv_csr_reference(*got_args, sent=sent, want_got=True,
                                   row=csr_in.row), 5)

    step_ms = min(step["kernel"])
    out = {
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


def check_k3_case(csr, op, x, vp, extra, params, device):
    """K3 against its plain version on one input; returns max |error|."""
    import torch
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    args = (csr.rowptr, csr.col, csr.val_f32, x, op, vp, extra, params)
    before = sv.LAUNCHES[op]
    out = sv.spmv_vec_csr(*args, row=csr.row)
    sync(device)
    if torch.device(device).type == "cuda" and sv.LAUNCHES[op] != before + 1:
        raise AssertionError(f"K3 {op}: the kernel did not launch")
    ref = sv.spmv_vec_csr_reference(*args, row=csr.row)
    what = f"K3 {op} K={x.shape[1]}"
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: shape {tuple(out.shape)} or not "
                             "finite")
    empty = csr.rowptr.diff() == 0
    if not bool((out[empty] == 0).all()):
        raise AssertionError(f"{what}: a row without edges is not 0")
    # the row's sum of |terms| bounds the reordering error
    rtol = LDA_INIT_RTOL if op == "lda_init" else SUM_RTOL
    bound = torch.zeros_like(out)
    for c in chunked(csr.nnz):
        colx, rowx = csr.col[c].long(), csr.row[c].long()
        terms = sv.VEC_PROCESS_OPS[op](
            x[colx], csr.val_f32[c], vp[rowx] if vp is not None else None,
            extra, params)
        bound.index_add_(0, rowx, terms.abs())
    bound *= rtol
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


def sgd_oracle(src0, dst0, val, n, lv0, iters, lambda_=0.001, step=3.5e-7):
    """Float64 SGD after tests/test_ml_apps.py:43-67, on the device, in
    edge chunks: (lv after iters, rmse before, rmse after)."""
    import torch
    lv = lv0.double()
    v = val.double()
    got = torch.zeros(n, dtype=torch.bool, device=lv.device)
    got[src0] = True
    got[dst0] = True

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
                grad.index_add_(0, r[c], xs * err[:, None])
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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this smoke test needs a CUDA GPU")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    k1_err = phase_kernels("cuda")
    phase_golden("cuda")
    e, g, niter, k1, k2 = phase_slice("cuda")
    t, k1_err_slice = phase_timings(e, g, card)
    k1_err = max(k1_err, k1_err_slice)
    del e, g

    k3_err = phase_k3("cuda")
    phase_golden_ml("cuda")
    _, g_sgd, k3_sgd, sgd_run = phase_sgd(
        "cuda", MOVIELENS_25M["users"], MOVIELENS_25M["items"],
        MOVIELENS_25M["ratings"])
    _, g_lda, gn_lda, k3_lda, lda_run = phase_lda(
        "cuda", NYTIMES["docs"], NYTIMES["terms"], NYTIMES["entries"])
    t3, k3_err_slice = phase_ml_timings(g_sgd, g_lda, gn_lda, card)
    k3_err = max(k3_err, k3_err_slice)
    log("phase 11: " + json.dumps({"card": card, "sgd": sgd_run,
                                   "lda": lda_run}))

    log(card)
    kernels = {"kernels": [
        {"name": "spmv2u", "route": "cuda",
         "source": "graphmat_tpu_torch/csrc/spmv2u.cu",
         "replaces": "graphmat_tpu/ops/pallas_spmv2u.py:918",
         "launches": sum(k1.values()), "max_abs_err": k1_err,
         "ms": t["k1_dense_sum_ms"], "plain_ms": t["k1_dense_sum_plain_ms"]},
        {"name": "aux_gather", "route": "cuda",
         "source": "graphmat_tpu_torch/csrc/compact.cu",
         "replaces": "graphmat_tpu/ops/pallas_compact.py:408",
         "launches": k2["aux_gather"], "max_abs_err": 0.0,
         "ms": t["k2_ms"], "plain_ms": t["k2_plain_ms"]},
        {"name": "spmv_vec2", "route": "cuda",
         "source": "graphmat_tpu_torch/csrc/spmv_vec2.cu",
         "replaces": "graphmat_tpu/ops/pallas_spmv_vec2.py:510",
         "launches": sum(k3_sgd.values()) + sum(k3_lda.values()),
         "max_abs_err": k3_err, "ms": t3["k3_ms"]["sgd_ms"],
         "plain_ms": t3["k3_ms"]["sgd_plain_ms"]},
    ]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
