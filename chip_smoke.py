#!/usr/bin/env python3
"""Smoke test of graphmat_tpu_torch on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

It builds the package's CUDA kernels from ``graphmat_tpu_torch/csrc`` and
drives PageRank, the port's main path, on the card.  Phases, in order;
any failure raises and the script exits non-zero:

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
   device memory.

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
    ]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
