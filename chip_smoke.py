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
mode (K4, with K5's got count fused in), then TriangleCounting (its two
hot loops, T1 and T2) and GetNeighbors, the 2D-sharded engine, the push's
sums in K1's fixed order, the converter, the RMAT stream's kernels, and
the last modules: the generic ⊕, the native text parser, the twin of the
entry points and the debug validators.
Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the software;
2. the kernel build and the host library's (``g++``), timed;
3. each kernel against its plain PyTorch version on a seeded RMAT graph
   of about 1M edges: K1 (the SpMV) for sum, min and max, for each ⊗,
   dense, sparse and sparse with the got count; K2 (the compaction
   gather), value-only and fused with the sent flags, bitwise, on a real
   position map and at 1, 3, 4, 5 and 2^20 + 3 positions over an operand
   with NaN payloads, -0.0 and +-inf;
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
6. timings on that graph, from CUDA events: a dense PageRank step on the
   kernel path (and its torch.profiler breakdown, with its device
   copies), on the plain path and with compaction off, in interleaved
   rounds; each kernel alone at the slice's shapes beside its plain
   version (K2 value-only and fused); GTEPS and peak device memory; and
   ``k2_diagnosis``: K2's and ``index_select``'s spread within the call
   (single launches and a burst), and what compaction costs one SpMV
   (the operand's preparation, K1 alone and the whole ``spmv`` on the
   compacted and the uncompacted CSR, dense and sparse with got);
7. K3 (the K-wide three-operand SpMV) against its plain version on a
   seeded bipartite graph of 1M ratings, for every op at K = 1, 4, 20,
   40, 96, 161, 200 and 513 (past 256 columns the slab kernel), and at
   K = 4, 20 and 161 on a row-length graph (empty rows, rows of 1, 31,
   32, 33, 1024 and 1025 edges, one row of 2^16 edges and one of
   81,491, the last three cut into chunks); rows without edges must be
   exactly 0, and each dense sum bitwise the same over two launches;
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
    version (every op), M edge-updates/s and M token-updates/s, peak
    device memory, each iteration's torch.profiler breakdown; and
    ``k3_diagnosis``: K3 at several K, ``sgd`` with vp = 0 at the LDA
    shape (the gather's floor), ``lda`` on the term rows against the doc
    rows; and K3 ``sgd`` and ``sgd_sqerr`` on the benchmark's skewed
    MovieLens-25M draw (``perfbench/gen/ratings.py``), each direction,
    against their plain versions (the ``spmv_vec2 (skewed)`` record);
12. K1's recv_final skip (0, 50 and 100% of rows final, sparse min and
    sum with got) and packed-key ⊗, and the push (sum with got: the mark
    pass and K1; min, max, every ⊗; dense and frontiers of 0.01%, 1% and
    50% of senders), against their plain versions on phase 3's graph
    (edge values drawn on the graph: a push sum reads the receiver CSR's
    copy of them); K1 against the push, bitwise; then, on a hub graph (RMAT-16 plus a sender and a
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
    bench.py:318-334 (GTEPS), the push kernel's own dense max alone
    beside its plain version (a push sum is K1's sweep: phase 21), its
    sparse min at 1% of senders beside K1's, where the hubs sit and what
    they cost each kernel (K1 without the first 32 or 1024 rows, the push
    without the first 32 senders and without its atomics, beside
    cuSPARSE), peak device memory;
16. K3's sparse mode against its plain version on phase 7's graphs, every
    op at phase 7's widths with 100%, 10%, 1% and 0.01% of senders sent
    (100% and 10% on the row-length graph; the got count exact, at 100%
    bitwise the dense mode), and K5's function through K1's op x (sum,
    min, max) against ``ops/spmv.py``;
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
    plain version and cuSPARSE, peak device memory;
18. compaction above L2: RMAT scale 24, edge factor 16, seed 1 (about
    263M edges, a 67 MB operand against the card's 50 MB L2), built on
    the card and degree-permuted, its dst direction once compacted
    (``compact=True``) and once as the card's ``compact="auto"`` leaves
    it (uncompacted, at this scale and at RMAT-22; phase 6 builds
    RMAT-22 so too); PageRank to convergence on both (the same
    iteration count, the vectors bitwise equal), K1 on both bitwise
    equal (dense sum, sparse with got); timings in interleaved rounds:
    the PageRank step (and its torch.profiler breakdown, on and off),
    what compaction costs one SpMV (as phase 6), K2 alone; peak device
    memory;
19. TriangleCounting and GetNeighbors: (a) T1 (the core count) and T2
    (the tail count) against their plain versions, exactly, on RMAT-16
    upper-triangular at h = 64, 128 and 4096, a graph whose every edge
    is core (RMAT-12 at h = 4096) and one whose every edge is tail
    (h = 0), a tail-hub graph whose tail lists reach class 8192, a
    graph of 90 vertices (W = 3 words), and the empty graph, each count
    also against the host route's; (b) the TC CLI on
    ``data/2_10_upper_triangle.bin.mtx`` on the engine and the bucketed
    route against ``tests/golden/tc_2_10.txt``; (c) RMAT-22 x 16, seed 1,
    upper-triangular on the card: ``run_triangle_counting`` with "auto"
    (the bucketed route, T1 and T2 launched, counted over the run), its
    total and per-vertex counts exactly the host route's (numpy prep),
    RMAT-16's total equal to scipy's; on a uniform graph of 2^20
    vertices (undirected average degree 16) ``run_get_neighbors``
    against a numpy oracle and the engine route's total against the
    bucketed one; (d) timings from CUDA events: a cold count from the
    edge tensors at RMAT-20 and RMAT-22 (bench.py:492-525's protocol, 5
    reps, M edges/s), its torch.profiler breakdown and idle share, peak
    device memory, T1 and T2 alone beside their bounds and plain
    versions, and ``tc_diagnosis``: the bitmap rows' popcounts, what T1
    reads an edge, T2's probes and time by class pair.

20. the 2D-sharded engine (``graphmat_tpu_torch.parallel``), its tiles
    on this one card: (a) on RMAT-16 x 16, LocalMeshes of 2x2 and 2x4
    tiles, each route against the one-device Engine on the card: K1's
    dense sum and sparse sum with got (PageRank, 1e-5), its sparse min
    with recv_final (BFS from 4 sources, SSSP, CC, DeltaStepping:
    exact), the push (``GRAPHMAT_KERNEL=v2``: BFS exact, PageRank to
    convergence in K1's count of steps with K1's vector bit for bit), K3 (SGD at 1M ratings, LDA at 100k entries) and its
    sparse mode (ACTIVE_ONLY SGD from a 10% frontier: the got counts and
    the frontier exact), the segment route (CC under P4's rule) and the
    concat route (GetNeighbors), K2 (compacted tiles bitwise the
    uncompacted ones), each run's launches counted; (b) phase 5's RMAT-22
    edge list: Degree + PageRank to convergence on a LocalMesh 2x2 of the
    card and on a ProcessMesh 1x1 over NCCL (a world of one process,
    started in this one), each within 1e-4 of the one-device Engine's;
    (c) BFS from 8 sources on the 2x2 mesh, depths and parents equal to
    the one-device run's; (d) the PageRank step on the 2x2 LocalMesh, the
    1x1 ProcessMesh and one device (CUDA events, median of 5, three
    interleaved rounds), the collectives' share of device time
    (torch.profiler ranges around the mesh's collectives), peak device
    memory.
21. the push's sums in a fixed order (ROADMAP P6) and the converter:
    (a) on phase 5's RMAT-22 edge list, the push's dense sum and its
    sparse sums with and without the got count at 0.01%, 1% and 10% of
    senders: the same bits over 10 launches, K1's bits on the same CSR
    and sent mask, within SUM_RTOL of a float64 ``index_add_``; each
    timed beside K1 alone, the mark pass alone (its bytes against its
    plain version's, max |err| recorded), the plain version and cuSPARSE
    (dense); PageRank on the push route to convergence at
    RMAT-16 and RMAT-22, on one device (K1's steps and vector bit for
    bit) and on a 2x4 LocalMesh (K1's steps and vector on the same
    tiles, within DIST_PR_RTOL of one device); IncPR on the push (K1's
    vector bit for bit, within INCPR_RTOL of the float64 fixed point);
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
    unconverted graph; the float32 steps of both graphs logged with
    their last steps' largest change (ROADMAP H1); (c) H1's diagnosis
    on the graph of ``tests/test_torch_cuda.py::
    test_pagerank_on_cuda_matches_cpu``: PageRank's steps on the card
    and on the CPU, their last steps' largest change, the float64
    steps.
22. the RMAT stream (``csrc/rmat.cu``): its keys at RMAT-16 and RMAT-20
    and the weights of the kept keys against their plain versions,
    exactly; phase 5's edge list (or a new RMAT-22 draw) against
    RMAT_GOLDEN; the keys kernel timed at RMAT-22 beside its plain
    version and its bound.
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
    split validated as it is built, then ``validate_graph``, timed.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Phase numbers given as arguments run
phases 1-2 and those only, without the result lines.
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
# K2's odd counts (phase 3), and the bit patterns of x's senders 0-7
# there: quiet and signalling NaNs with payloads, -0.0, +-inf, a denormal
K2_COUNTS = (1, 3, 4, 5, (1 << 20) + 3)
K2_SPECIALS = (0x7FC00001, 0xFFC12345, 0x7F800001, 0x80000000, 0x7F800000,
               0xFF800000, 0x00000001, 0x3F800000)
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
K3_OPS = ("sgd", "sgd_sqerr", "lda_init", "lda", "lda_loglik")
# K3's widths in phases 7 and 16: one lane an edge (K = 1, 4), lane groups
# of 4 to 32 (K = 20 to 200; 160 was the parent kernel's bound), and the
# slab kernel past 256 columns
K3_WIDTHS = (1, 4, 20, 40, 96, 161, 200, 513)
# rows of the row-length graph: empty, one edge, a warp's batch of 32 edges
# and one either side of it, a warp's most (C = 1024) and one more, one row
# of 2^16 edges and one of MovieLens-25M's most rated film's 81,491
ROW_LENGTHS = ((0, 64), (1, 512), (31, 64), (32, 64), (33, 64), (1024, 4),
               (1025, 4), (1 << 16, 1), (81_491, 1))


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
    from graphmat_tpu_torch.ops.compact import divert_stragglers
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
    # K2 on a real position map (every edge from a sender >= 64 diverts)
    # and at odd counts, over an operand that holds NaN payloads, -0.0
    # and +-inf at senders 0-7
    _, src_of_pos = divert_stragglers(csr.col, csr.row, g.n_pad, wr=1024,
                                      hub=64, divert_min=1 << 30, bpsb=4,
                                      w_div=16)
    if src_of_pos.numel() == 0:
        raise AssertionError("phase 3: nothing diverted")
    xs = x.clone()
    xs[:len(K2_SPECIALS)] = torch.tensor(
        K2_SPECIALS, dtype=torch.int64).to(torch.int32).view(
            torch.float32).to(device)
    maps = [src_of_pos]
    for n in K2_COUNTS:
        idx = torch.randint(0, g.n_pad, (n,), generator=gen, device=device)
        idx[:min(n, len(K2_SPECIALS))] = torch.arange(
            min(n, len(K2_SPECIALS)), device=device)
        maps.append(idx.to(torch.int32))
    for pos in maps:
        check_k2(xs, sent, pos, device)
    log(f"phase 3: K1 agrees in 21 cases (max |err| {k1_err:.3e}); "
        f"K2 bitwise equal, value and fused with the flags, on "
        f"{src_of_pos.numel()} positions and at {list(K2_COUNTS)}")
    return k1_err


def check_k2(x, sent, src_of_pos, device):
    """K2 against its plain version on one position map, value-only and
    fused with the sent flags, bitwise (NaN payloads included)."""
    import torch
    from graphmat_tpu_torch.ops.compact import (aux_gather,
                                                aux_gather_reference)
    n = src_of_pos.numel()
    out = aux_gather(x, src_of_pos, torch.empty(n, device=device))
    vals, flags = aux_gather(
        x, src_of_pos, torch.empty(n, device=device), sent,
        torch.empty(n, dtype=torch.uint8, device=device))
    sync(device)
    ref, ref_flags = aux_gather_reference(x, src_of_pos, sent)
    for a in (out, vals):
        if not torch.equal(a.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"K2 differs at {n} positions")
    if not torch.equal(flags, ref_flags):
        raise AssertionError(f"K2's flags differ at {n} positions")


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


def phase_timings(e, g, card):
    """Phase 6: step and kernel times on the slice's graph."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.pagerank import (PageRankProgram,
                                                  run_pagerank)
    from graphmat_tpu_torch.core import runtime
    from graphmat_tpu_torch.ops import spmv2u
    from graphmat_tpu_torch.ops.spmv2u import spmv_csr, spmv_csr_reference

    # the card's "auto" leaves RMAT-22 uncompacted (ops/compact.py:
    # compact_auto)
    g_off = Graph(e, device=g.device, permute="degree", compact="auto")
    if any(g_off.csr(r).src_of_pos is not None for r in ("dst", "src")):
        raise AssertionError("phase 6: compact='auto' compacted RMAT-22 "
                             "on the card")
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
    for _ in range(3):   # interleaved rounds, median of 5 steps each
        step["kernel"].append(event_ms(eng.step_once, 5))
        step["plain"].append(event_ms(plain_step, 5))
        step["kernel_compact_off"].append(event_ms(eng_off.step_once, 5))

    # each kernel alone at the slice's shapes
    csr = g.csr("dst")
    gen = torch.Generator(device=g.device)
    gen.manual_seed(3)
    x = torch.rand(g.n_pad, generator=gen, device=g.device)
    sent_all = (torch.rand(g.n_pad, generator=gen, device=g.device)
                < 0.5).to(torch.uint8)
    k2 = k2_times(csr, x, sent_all)
    (k1_args, k1_kw), k1_plan = (k1_operand(csr, x, None),
                                 spmv2u.plan_for(csr))
    k1_ms = event_ms(lambda: spmv_csr(*k1_args, "sum", "x", plan=k1_plan,
                                      **k1_kw), 20)
    k1_plain_ms = event_ms(lambda: spmv_csr_reference(
        *k1_args, "sum", "x", row=csr.row, **k1_kw), 5)
    k1_err = check_spmv_case(g_off.csr("dst"), x, None, None, "sum", "x",
                             "dense", g.device)
    # the yardstick, never called by the package (cuSPARSE), and the
    # bound (each input read once, the output written once, at the
    # H100's 3.35 TB/s)
    k1_lib_ms = cusparse_ms(csr.rowptr, csr.col, x)
    k1_bytes = 4 * (csr.rowptr.numel() + csr.nnz + x.numel() + csr.n_aux
                    + csr.n_rows)
    csr_in = g.csr("src")
    (got_args, got_kw), got_plan = (k1_operand(csr_in, x, sent_all),
                                    spmv2u.plan_for(csr_in))
    k1_got_ms = event_ms(lambda: spmv_csr(
        *got_args, "sum", "x", want_got=True, plan=got_plan, **got_kw), 20)
    k1_got_plain_ms = event_ms(
        lambda: spmv_csr_reference(*got_args, "sum", "x", want_got=True,
                                   row=csr_in.row, **got_kw), 5)

    step_ms = min(step["kernel"])
    profile = profile_run(eng.step_once)
    diagnosis = k2_diagnosis(g, g_off, x)
    out = {
        "step_profile": profile,
        "step_profile_compact_off": profile_run(eng_off.step_once),
        "card": card,
        "step_ms": step,
        "gteps_kernel": g.nnz / (step_ms * 1e-3) / 1e9,
        "gteps_kernel_compact_off":
            g.nnz / (min(step["kernel_compact_off"]) * 1e-3) / 1e9,
        "gteps_plain": g.nnz / (min(step["plain"]) * 1e-3) / 1e9,
        "k1_dense_sum_ms": k1_ms, "k1_dense_sum_plain_ms": k1_plain_ms,
        "k1_sparse_got_ms": k1_got_ms,
        "k1_sparse_got_plain_ms": k1_got_plain_ms,
        "k2": k2,
        "k1_cusparse_ms": k1_lib_ms, "k1_bound_ms": hbm_ms(k1_bytes),
        "k2_diagnosis": diagnosis,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log("phase 6 (" + card + "): " + json.dumps(out))
    return out, k1_err

def k2_times(csr, x, sent, reps=20):
    """K2 alone on one compacted direction, checked bitwise: value-only
    and fused with the sent flags, beside their plain versions and one
    ``index_select`` (a yardstick, never called by the package), and
    their bounds: src_of_pos read, the values (and flags) written, and
    the 32-byte sectors of x (and sent) that the senders touch read
    once, at the H100's 3.35 TB/s."""
    import torch
    from graphmat_tpu_torch.ops.compact import (aux_gather,
                                                aux_gather_reference)
    src, n = csr.src_of_pos, csr.n_aux
    pos = src[:n].long()
    check_k2(x, sent, src, x.device)
    value_bytes = 8 * n + 32 * torch.unique(pos >> 3).numel()
    fused_bytes = value_bytes + n + 32 * torch.unique(pos >> 5).numel()
    return {
        "positions": n,
        "ms": event_ms(lambda: aux_gather(x, src, csr.x_ext), reps),
        "plain_ms": event_ms(lambda: aux_gather_reference(x, src), reps),
        "fused_ms": event_ms(lambda: aux_gather(
            x, src, csr.x_ext, sent, csr.sent_ext), reps),
        "fused_plain_ms": event_ms(
            lambda: aux_gather_reference(x, src, sent), reps),
        "index_select_ms": event_ms(
            lambda: torch.index_select(x, 0, pos), reps),
        "bound_ms": hbm_ms(value_bytes),
        "fused_bound_ms": hbm_ms(fused_bytes)}


def spread_ms(fn, singles=20, burst=200, warm=3):
    """One function's times within one call: ``singles`` launches each
    between its own CUDA events (median, min, max), then ``burst``
    back-to-back launches between one pair (the mean per launch)."""
    import torch
    for _ in range(warm):
        fn()
    one = [event_ms(fn, 1, warm=0) for _ in range(singles)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(burst):
        fn()
    end.record()
    end.synchronize()
    return {"single_median_ms": statistics.median(one),
            "single_min_ms": min(one), "single_max_ms": max(one),
            "burst_mean_ms": start.elapsed_time(end) / burst}


def k1_operand(csr, x, sent):
    """The arguments K1 takes for one direction's operand: K2 runs here
    when the CSR is compacted."""
    from graphmat_tpu_torch.ops import spmv2u
    col, x_aux, sent_aux = spmv2u._operand(csr, x, sent)
    return (csr.rowptr, col, x), {"sent": sent, "x_aux": x_aux,
                                  "sent_aux": sent_aux}


def compaction_costs(csr, off, x, sent, rounds=2, reps=20):
    """What compaction costs and saves one SpMV on one direction: the
    operand's preparation alone (``_operand``: copies and K2), K1 alone
    on the compacted and on the uncompacted CSR, and the whole ``spmv``
    on each, for a dense sum and a sparse sum with got, in interleaved
    rounds; the compacted results must equal the uncompacted bitwise."""
    import torch
    from graphmat_tpu_torch.ops import spmv2u
    plans = {"on": spmv2u.plan_for(csr), "off": spmv2u.plan_for(off)}
    out = {}
    for mode, s in (("dense", None), ("sparse_got", sent)):
        got = s is not None
        a_on, kw_on = k1_operand(csr, x, s)
        a_off = (off.rowptr, off.col, x)
        runs = {
            "operand_ms": lambda: spmv2u._operand(csr, x, s),
            "k1_on_ms": lambda: spmv2u.spmv_csr(
                *a_on, "sum", "x", want_got=got, plan=plans["on"], **kw_on),
            "k1_off_ms": lambda: spmv2u.spmv_csr(
                *a_off, "sum", "x", sent=s, want_got=got,
                plan=plans["off"]),
            "spmv_on_ms": lambda: spmv2u.spmv(csr, x, "sum", "x", sent=s,
                                              want_got=got),
            "spmv_off_ms": lambda: spmv2u.spmv(off, x, "sum", "x", sent=s,
                                               want_got=got)}
        r_on, r_off = runs["spmv_on_ms"](), runs["spmv_off_ms"]()
        for a, b in zip(*((r_on, r_off) if got else ((r_on,), (r_off,)))):
            if not torch.equal(a, b):
                raise AssertionError(f"K1 {mode}: the compacted CSR's "
                                     "result differs from the uncompacted")
        res = {k: [] for k in runs}
        for _ in range(rounds):
            for k, fn in runs.items():
                res[k].append(event_ms(fn, reps))
        out[mode] = res
    return out


def k2_diagnosis(g, g_off, x, seed=43):
    """K2's spread within one call beside ``index_select``'s, and what
    compaction costs one SpMV (:func:`compaction_costs`) on the dst
    direction of a compacted graph and of its ``compact=False`` twin."""
    import torch
    from graphmat_tpu_torch.ops.compact import aux_gather
    csr, off = g.csr("dst"), g_off.csr("dst")
    src = csr.src_of_pos
    pos = src[:csr.n_aux].long()
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    sent = (torch.rand(csr.n_send, generator=gen, device=x.device)
            < 0.5).to(torch.uint8)
    return {
        "k2_value": spread_ms(lambda: aux_gather(x, src, csr.x_ext)),
        "k2_fused": spread_ms(lambda: aux_gather(x, src, csr.x_ext, sent,
                                                 csr.sent_ext)),
        "index_select": spread_ms(lambda: torch.index_select(x, 0, pos)),
        "costs": compaction_costs(csr, off, x, sent)}


def phase_above_l2(card, scale=24, edge_factor=16, seed=1, rounds=3,
                   device="cuda", graph_kw=None):
    """Phase 18: compaction above L2.  RMAT-``scale`` built on the card,
    degree-permuted, its dst direction once compacted and once with the
    card's ``compact="auto"``, which leaves it uncompacted; K1 dense sum
    and sparse with got, the PageRank step and K2, in interleaved rounds;
    PageRank to convergence on both must give the same iteration count
    and a bitwise equal vector, and K1 bitwise equal results.
    ``graph_kw`` goes to the compacted Graph (a smaller rehearsal forces
    diversion with it)."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.pagerank import PageRankProgram
    from graphmat_tpu_torch.core.runtime import Engine
    from graphmat_tpu_torch.ops.compact import compact_auto, compact_enabled
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        # the card's "auto" compacts neither RMAT-22 nor RMAT-24, where
        # the JAX rule compacts both (PERF.md §6: it pays at neither)
        for n in (1 << 22, 1 << scale):
            if compact_auto(n, device) or not compact_enabled(n):
                raise AssertionError(f"phase 18: compact='auto' at {n} "
                                     "senders is not the card's rule")
    t0 = time.perf_counter()
    e = rmat_edgelist(scale, edge_factor, a=0.57, b=0.19, c=0.19,
                      seed=seed, device=device)
    sync(device)
    secs = {"generate": time.perf_counter() - t0}
    graphs = {}
    for name, kw in (("on", dict(compact=True, **(graph_kw or {}))),
                     ("off", dict(compact="auto" if cuda else False))):
        t0 = time.perf_counter()
        graphs[name] = Graph(e, device=device, permute="degree",
                             build_in_edges=False, **kw)
        sync(device)
        secs[f"build_{name}"] = time.perf_counter() - t0
        if cuda:
            torch.cuda.empty_cache()
    del e
    on, off = graphs["on"], graphs["off"]
    c_on, c_off = on.csr("dst"), off.csr("dst")
    if c_on.src_of_pos is None or c_off.src_of_pos is not None:
        raise AssertionError("phase 18: expected the compacted graph and "
                             "an uncompacted one from compact='auto'")
    # the degree pass, as a count of each sender's edges
    deg = torch.bincount(c_off.col.long(), minlength=off.n_pad).to(
        torch.int32)
    runs = {}
    for name, g in graphs.items():
        g.vp = {"pagerank": torch.full((g.n_pad,), 0.3, device=device),
                "degree": deg.clone()}
        g.set_all_active()
        eng = Engine(PageRankProgram(alpha=0.3), g)
        t0 = time.perf_counter()
        niter = eng.run()
        sync(device)
        runs[name] = (niter, g.vp["pagerank"].clone(), eng,
                      time.perf_counter() - t0)
    if runs["on"][0] != runs["off"][0] or not torch.equal(
            runs["on"][1], runs["off"][1]):
        raise AssertionError(
            f"phase 18: PageRank differs with compaction on ({runs['on'][0]}"
            f" iterations) and off ({runs['off'][0]})")
    pr = runs["on"][1]
    if not bool(torch.isfinite(pr).all()):
        raise AssertionError("phase 18: PageRank not finite")
    out = {"card": card, "scale": scale, "n": on.n, "nnz": on.nnz,
           "operand_bytes": 4 * c_on.n_send, "positions": c_on.n_aux,
           "pagerank_iterations": runs["on"][0],
           "run_s": {k: v[3] for k, v in runs.items()}, "seconds": secs}
    if cuda:
        out["l2_bytes"] = torch.cuda.get_device_properties(
            0).L2_cache_size
        step = {"on": [], "off": []}
        for _ in range(rounds):
            for name in ("on", "off"):
                step[name].append(event_ms(runs[name][2].step_once, 5))
        out["step_ms"] = step
        out["step_profile"] = {name: profile_run(runs[name][2].step_once)
                               for name in ("on", "off")}
        gen = torch.Generator(device=device)
        gen.manual_seed(17)
        x = torch.rand(on.n_pad, generator=gen, device=device)
        sent = (torch.rand(on.n_pad, generator=gen, device=device)
                < 0.5).to(torch.uint8)
        out["costs"] = compaction_costs(c_on, c_off, x, sent)
        out["k2"] = k2_times(c_on, x, sent)
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    log(f"phase 18 ({card}): " + json.dumps(out))
    return out


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


def check_k3_case(csr, op, x, vp, extra, params, device, sent=None,
                  long_rows=False):
    """K3 against its plain version on one input; returns max |error|.
    Each sum is bitwise the same over two launches.  With ``sent`` (uint8
    per sender), K3's sparse mode: the got count exactly, a row without a
    sent edge exactly 0, and with every sender sent the dense mode's bits.
    ``long_rows`` (the row-length graph) bounds a row of deg terms by the
    float32 summation error of deg terms where that passes SUM_RTOL."""
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
    if torch.device(device).type == "cuda":
        again = (sv.spmv_vec_csr(*args, row=csr.row) if sent is None else
                 ss.spmv_vec_sparse_csr(*sargs, row=csr.row))
        if not (torch.equal(out, again) if sent is None else
                torch.equal(out, again[0]) and torch.equal(got, again[1])):
            raise AssertionError(f"{what}: two launches differ")
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
    elif long_rows:
        # a row's float32 sum of deg terms, in the kernel's order and in
        # index_add_'s (which changes from run to run on CUDA), errs by up
        # to (deg - 1) units of the row's sum each: past SUM_RTOL only
        # from 85 edges on (the row-length graph's row of 2^16 edges)
        degf = deg.to(out.dtype)[:, None]
        bound *= torch.clamp(2 * (degf - 1) * F32_UNIT, min=SUM_RTOL)
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


def rowlen_edgelist(device, n=1 << 17, seed=19):
    """A graph whose receiver rows have the lengths of ``ROW_LENGTHS``
    (distinct senders drawn at random, integer counts 1..5), among rows
    without edges."""
    import torch
    from graphmat_tpu_torch import EdgeList
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    src, dst = [], []
    recv = 1
    for length, count in ROW_LENGTHS:
        for _ in range(count):
            src.append(1 + torch.randperm(n, generator=gen,
                                          device=device)[:length])
            dst.append(torch.full((length,), recv, device=device))
            recv += 2   # a row without edges between any two
    src = torch.cat(src).to(torch.int32)
    dst = torch.cat(dst).to(torch.int32)
    val = torch.randint(1, 6, (src.numel(),), generator=gen,
                        device=device).float()
    return EdgeList(n, n, src, dst, val)


def phase_k3(device, users=60_000, items=20_000, ratings=1_000_000,
             seed=17, widths=K3_WIDTHS):
    """Phase 7: K3 against its plain version, every op at each of
    ``widths`` on a bipartite graph (the receiver=dst rows of the users
    have no edges), then at K = 4, 20 and 161 on the row-length graph;
    each dense sum bitwise the same over two launches."""
    import torch
    from graphmat_tpu_torch import Graph
    e = ratings_edgelist(users, items, ratings, seed, device)
    e.val = torch.ceil(e.val)   # integer counts, which lda_init needs
    g = Graph(e, device=device, build_in_edges=False, compact=False)
    gr = Graph(rowlen_edgelist(device), device=device, build_in_edges=False,
               compact=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"alpha": 1.0, "eta": 5.0, "vocab_size": items}
    worst, cases = 0.0, 0
    for graph, ks in ((g, widths), (gr, (4, 20, 161))):
        csr = graph.csr("dst")
        for k in ks:
            for op in K3_OPS:
                x, vp, extra = k3_inputs(op, k, graph.n_pad, gen, device)
                worst = max(worst, check_k3_case(
                    csr, op, x, vp, extra, params, device,
                    long_rows=graph is gr))
                cases += 1
    csr = g.csr("dst")
    log(f"phase 7: K3 agrees in {cases} cases, K in {list(widths)}, on "
        f"n={g.n} nnz={csr.nnz} ({int((csr.rowptr.diff() == 0).sum())} "
        f"rows without edges; max in-degree {int(csr.rowptr.diff().max())})"
        f" and on the row-length graph (nnz={gr.nnz}); each dense sum "
        f"bitwise over two launches; max |err| {worst:.3e}")
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
    run = dict(build_s=t_build, run_s=t_run, peak_bytes=peak)
    if cuda:
        run["rand_r"] = dict(rand_r_timings(g.n, k, device), launches=krr)
        log("phase 9: the rand_r draw: " + json.dumps(run["rand_r"]))
    return e, g, k3, run


def rand_r_timings(n, k, device, reps=3):
    """SGD's initial factors, n x k float32: the rand_r kernel and its
    plain version on the card (CUDA events), the host route the kernel
    replaced (numpy draw, cast, upload; host clock, synchronised) and the
    store bound.  Launches the kernel 52 times."""
    import torch
    from graphmat_tpu_torch.ops import rand_r
    from graphmat_tpu_torch.utils.reference_rng import rand_r_uniform_np
    seeds = np.arange(1, n + 1, dtype=np.uint32)
    host = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        torch.as_tensor(rand_r_uniform_np(seeds, k).astype(np.float32),
                        device=device)
        sync(device)
        host.append((time.perf_counter() - t0) * 1e3)
    return {
        "ms": event_ms(lambda: rand_r.rand_r_uniform(
            1, n, k, torch.float32, device), 50),
        "plain_ms": event_ms(lambda: rand_r.rand_r_uniform_reference(
            1, n, k, torch.float32, device), 5, warm=1),
        "bound_ms": hbm_ms(n * k * 4),
        "host_route_ms": statistics.median(host)}


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


DIAG_KS = {"sgd": (4, 20, 40, 96, 128), "lda": (4, 20, 40)}


def rows_view(c, a, b):
    """Rows [a, b) of CSR ``c`` as a CSR of its own (views, no copies)."""
    from graphmat_tpu_torch.core.graph import CSR
    e0, e1 = int(c.rowptr[a]), int(c.rowptr[b])
    return CSR(c.rowptr[a:b + 1] - e0, c.col[e0:e1], c.row[e0:e1] - a,
               c.val[e0:e1], c.n_send)


def k3_diagnosis(g_sgd, g_lda, params, reps=10, seed=41):
    """Where K3's time goes, on random operands at each slice's shape, one
    direction: (a) ``sgd`` on MovieLens-25M's item rows and ``lda`` on
    NYTimes' term rows at several K (how time scales with components);
    (b) ``sgd`` with vp = 0 on the term rows at K = 20: the gather of x's
    row and one FMA a component, a proxy for the per-edge gather floor;
    (c) ``lda`` at K = 20 on the term rows alone (679 edges on average)
    against the doc rows alone (232), each through a view without the
    other kind's empty rows."""
    import torch
    from graphmat_tpu_torch.ops import spmv2u
    from graphmat_tpu_torch.ops import spmv_vec2 as sv
    dev = g_sgd.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ndoc = int(g_lda.vp["is_doc"].sum())
    n_lda = g_lda.n
    terms = rows_view(g_lda.csr("dst"), ndoc, n_lda)
    docs = rows_view(g_lda.csr("src"), 0, ndoc)
    items = g_sgd.csr("dst")

    def time(csr, op, x, vp, extra, rows=slice(None)):
        vr = vp[rows] if vp is not None else None
        plan = spmv2u.plan_for(csr)
        return event_ms(lambda: sv.spmv_vec_csr(
            csr.rowptr, csr.col, csr.val_f32, x, op, vr, extra, params,
            plan=plan), reps)
    out = {"a": {}}
    for op, csr, n, rows in (("sgd", items, g_sgd.n_pad, slice(None)),
                             ("lda", terms, g_lda.n_pad,
                              slice(ndoc, n_lda))):
        for k in DIAG_KS[op]:
            x, vp, extra = k3_inputs(op, k, n, gen, dev)
            out["a"][f"{op}_k{k}_ms"] = time(csr, op, x, vp, extra, rows)
            del x, vp
    x, _, _ = k3_inputs("sgd", 20, g_lda.n_pad, gen, dev)
    out["b_sgd_vp0_lda_shape_ms"] = time(terms, "sgd", x,
                                         torch.zeros_like(x), None,
                                         slice(ndoc, n_lda))
    x, vp, extra = k3_inputs("lda", 20, g_lda.n_pad, gen, dev)
    out["c_lda_term_rows_ms"] = time(terms, "lda", x, vp, extra,
                                     slice(ndoc, n_lda))
    out["c_lda_doc_rows_ms"] = time(docs, "lda", x, vp, extra,
                                    slice(0, ndoc))
    out["edges"] = {"items": items.nnz, "terms": terms.nnz,
                    "docs": docs.nnz}
    return out


def k3_skewed(device, k=20, seed=7400000019):
    """K3 ``sgd`` and ``sgd_sqerr`` alone on the benchmark's own skewed
    MovieLens-25M draw (``perfbench/gen/ratings.py`` with
    ``perfbench/configs/movielens25m-k20.json``, the graph as
    ``perfbench/port.py`` builds it), each direction: ``dst`` the film
    rows (the most rated film about 81,500 ratings, cut into chunks of
    1024), ``src`` the user rows; each against its plain version.
    Returns ({each time in ms, ``chunks``: each direction's count}, max
    |error|)."""
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
            out[f"{op}_skewed_{recv}_ms"] = event_ms(
                lambda: sv.spmv_vec(csr, x, op, vp), 10)
            err = max(err, check_k3_case(csr, op, x, vp, None, None, device,
                                         long_rows=True))
    out["chunks"] = chunks
    return out, err


def phase_ml_timings(g_sgd, g_lda, gn_lda, card, k=20):
    """Phase 11: SGD and LDA iteration and K3 times at the slices'
    shapes, kernel beside plain; K3 on the benchmark's skewed MovieLens
    draw (:func:`k3_skewed`)."""
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
    # the other ops once each, on random operands at the slices' shapes
    gen = torch.Generator(device=g_sgd.device)
    gen.manual_seed(43)
    for name, csr, op, n in (("sgd_sqerr", c_sgd, "sgd_sqerr", g_sgd.n_pad),
                             ("lda_init", c_lda, "lda_init", g_lda.n_pad),
                             ("lda_loglik", c_lda, "lda_loglik",
                              g_lda.n_pad)):
        x, vp, extra = k3_inputs(op, k, n, gen, g_sgd.device)
        k3[name + "_ms"] = event_ms(lambda: sv.spmv_vec(
            csr, x, op, vp, extra, params), 5)
    # sgd and sgd_sqerr on the benchmark's skewed draw, each direction
    k3["skewed"], err_skewed = k3_skewed(g_sgd.device, k)
    err = max(err, err_skewed)
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
        "k3_diagnosis": k3_diagnosis(g_sgd, g_lda, params),
        "sgd_profile": profile_run(sgd_step),
        "lda_profile": profile_run(lda_step),
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
    from graphmat_tpu_torch import EdgeList, Graph
    from graphmat_tpu_torch.ops.spmv2 import spmv_push, spmv_push_reference
    from graphmat_tpu_torch.ops.spmv2u import (PROCESS_OPS, spmv,
                                               spmv_reference)
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    e = rmat_edgelist(scale, edge_factor, seed=seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # normal edge values on the graph: a push sum reads the receiver
    # CSR's copy of the sender index's values
    g = Graph(EdgeList(e.m, e.n, e.src, e.dst, torch.randn(
        e.nnz, generator=gen, device=device)), device=device, compact=False)
    rc, sc = g.csr("dst"), g.sender_csr("dst")   # receiver-, sender-major
    n = g.n_pad
    bits = max(int(np.ceil(np.log2(n))), 1)
    x = torch.randn(n, generator=gen, device=device)
    val_r, val_s = rc.val_f32, sc.val_f32
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
            # a push sum is K1's sweep: its error is K1's
            e_case = compare_out(what, out, ref, kind, bound)
            if kind == "sum":
                k1_err = max(k1_err, e_case)
            else:
                push_err = max(push_err, e_case)
            push_cases += 1
    # the two routes compute one function: K1 equals the push, bitwise,
    # the sums (and counts) too: the push sums by K1
    for kind in ("sum", "min", "max"):
        for sent in (None, sent30):
            got = kind == "sum" and sent is not None
            a = spmv(rc, x, kind, "x_mul_val", val=val_r, sent=sent,
                     want_got=got)
            b = spmv_push(sc, x, kind, "x_mul_val", val=val_s, sent=sent,
                          want_got=got)
            sync(device)
            for u, w in zip(a if got else (a,), b if got else (b,)):
                if not torch.equal(u.view(torch.int32), w.view(torch.int32)):
                    raise AssertionError(f"K1 against the push, {kind}: "
                                         "not bitwise equal")
    log(f"phase 12: RMAT-{scale} x{edge_factor}: n={g.n} nnz={rc.nnz}; K1 "
        f"agrees in {k1_cases} recv_final/packed-key cases (max |err| "
        f"{k1_err:.3e}); the push kernel agrees in {push_cases} cases "
        f"(max |err| {push_err:.3e}); min/max and counts bitwise; the push "
        f"equals K1 bitwise, sums included")
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
    from graphmat_tpu_torch import EdgeList, Graph
    from graphmat_tpu_torch.ops.spmv2 import spmv_push, spmv_push_reference
    from graphmat_tpu_torch.ops.spmv2u import (PROCESS_OPS, spmv,
                                               spmv_reference)
    e, hub_s, hub_r = hub_edgelist(device, scale, seed=seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # a push sum reads the graph's own values: normal ones, and integer
    # weights 1..7 on a second copy for the packed keys
    g, gk = (Graph(EdgeList(e.m, e.n, e.src, e.dst, v), device=device,
                   compact=False) for v in (
        torch.randn(e.nnz, generator=gen, device=device),
        torch.randint(1, 8, (e.nnz,), generator=gen,
                      device=device).float()))
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    n = g.n_pad
    bits = max(int(np.ceil(np.log2(n))), 1)

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
                s_csr = sc
                if kind == "sum":   # the push sums the graph's own values
                    s_csr = (gk if op == "key_add_val" else g).sender_csr(
                        "dst")
                    vv = s_csr.val_f32
                kw = dict(val=vv, sent=sent, want_got=got, bits=bits)
                out = spmv_push(s_csr, xx, kind, op, **kw)
                sync(device)
                ref = spmv_push_reference(s_csr, xx, kind, op, **kw)
                what = f"hub graph push {kind} {op} {fname}"
                if got:
                    (out, cnt), (ref, cnt_ref) = out, ref
                    if not torch.equal(cnt, cnt_ref):
                        raise AssertionError(f"{what}: counts differ")
                bound = None
                if kind == "sum":
                    terms = PROCESS_OPS[op](xx[s_csr.row.long()], vv, bits)
                    bound = sum_bound(s_csr.col.long(), s_csr.row.long(),
                                      terms, n, sent)
                # a push sum is K1's sweep: its error is K1's
                route = "k1" if kind == "sum" else "push"
                err[route] = max(err[route], compare_out(
                    what, out, ref, kind, bound))
                cases["push"] += 1
    # the integer weights' x_add_val sum, whose hub row holds 2^20 mostly
    # positive terms: K1 and the push within SUM_RTOL of the float64 sum
    # of the same float32 terms; the float32 plain version's share of
    # that bound is logged, not required (on the CPU K1 and the push are
    # that plain version, and exceed it)
    on_card = torch.device(device).type == "cuda"
    rk, sk = gk.csr("dst"), gk.sender_csr("dst")
    share = {}
    for fname in ("dense", "1%+hub"):
        sent = frontiers[fname]
        got = sent is not None
        kw = dict(val=rk.val_f32, sent=sent, want_got=got)
        terms = PROCESS_OPS["x_add_val"](x[rk.col.long()], rk.val_f32)
        if sent is not None:
            terms = terms * sent[rk.col.long()].float()
        row = rk.row.long()
        exact = torch.zeros(n, dtype=torch.float64, device=device
                            ).index_add_(0, row, terms.double())
        bound = torch.zeros_like(exact).index_add_(
            0, row, terms.double().abs()) * SUM_RTOL
        for name, out in (
                ("k1", spmv(rk, x, "sum", "x_add_val", **kw)),
                ("push", spmv_push(sk, x, "sum", "x_add_val",
                                   val=sk.val_f32, sent=sent,
                                   want_got=got)),
                ("plain", spmv_reference(rk, x, "sum", "x_add_val", **kw))):
            y = (out[0] if got else out).double()
            r = float(((y - exact).abs() / bound.clamp(min=1e-30)).max())
            share[f"{name} {fname}"] = r
            if on_card and name != "plain" and r > 1.0:
                raise AssertionError(f"hub graph, integer weights: {name} "
                                     f"x_add_val sum {fname} off float64 by "
                                     f"{r} of its bound")
    log("phase 12: hub graph, integer weights, x_add_val sum against "
        "float64, the largest |err| as a share of SUM_RTOL * sum|t|: "
        + json.dumps(share))
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
            "device_launches": sum(r[1] for r in rows),
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for ms, c, k in rows[:top]],
            "memcpy": [{"kernel": k, "ms": ms, "count": c}
                       for ms, c, k in rows if "Memcpy" in k]}


def hub_diagnosis(g, x, reps=20):
    """Where the hubs sit and what they cost each kernel: the longest
    receiver row and the out-degree of senders 0-31 (one push tile); K1's
    dense sum on rows k and up (``rowptr[k:]`` rebased, ``col`` from its
    first edge: views, no copies) for k in 0, 32, 1024; the push's dense
    max (its own kernel: a push sum is K1's) with and without senders
    0-31, and its walk without atomics; cuSPARSE on the whole CSR; and how
    many rows and senders fall in each length class of K1's lane
    groups."""
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
    out["push_dense_max_ms"] = event_ms(
        lambda: spmv_push(sc, x, "max", "x"), reps)
    out["push_dense_max_ms_without_tile0"] = event_ms(
        lambda: spmv_push(push_tail, x[32:], "max", "x"), reps)
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

    # the push kernel's own dense max at the slice's shape (a push sum is
    # K1's sweep, timed in phase 21), beside its plain version on the same
    # inputs, and its bound (rowptr, col, x, y once); hub_diagnosis times
    # it
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    x = torch.rand(g.n_pad, generator=gen, device="cuda")
    out["hub_diagnosis"] = hub_diagnosis(g, x)
    err = compare_out("push dense max at the slice's shape",
                      spmv_push(sc, x, "max", "x"),
                      spmv_push_reference(sc, x, "max", "x"), "max")
    push_bytes = 4 * (sc.rowptr.numel() + sc.nnz + 2 * g.n_pad)
    out["push_dense_max"] = {
        "ms": out["hub_diagnosis"]["push_dense_max_ms"],
        "plain_ms": event_ms(lambda: spmv_push_reference(
            sc, x, "max", "x"), 3, warm=1),
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
                         ratings=1_000_000, seed=17, widths=K3_WIDTHS):
    """Phase 16: K3's sparse mode (K4 with K5's got count) against its
    plain version, every op at each of ``widths`` with 100%, 10%, 1% and
    0.01% of senders sent, on phase 7's graph, and at K = 4, 20 and 161
    with 100% and 10% on the row-length graph: counts exact, rows without
    a sent edge exactly 0, at 100% the dense mode's bits; K5's function
    through K1's op ``x`` against ``ops/spmv.py``'s plain version (min
    and max bitwise, the sum within the row bound)."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.ops import spmv as k5
    e = ratings_edgelist(users, items, ratings, seed, device)
    e.val = torch.ceil(e.val)   # integer counts, which lda_init needs
    g = Graph(e, device=device, build_in_edges=False, compact=False)
    gr = Graph(rowlen_edgelist(device), device=device, build_in_edges=False,
               compact=False)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = {"alpha": 1.0, "eta": 5.0, "vocab_size": items}
    worst, cases = 0.0, 0
    for graph, ks, shares in ((g, widths, SPARSE_SHARES),
                              (gr, (4, 20, 161), (1.0, 0.1))):
        csr = graph.csr("dst")
        for k in ks:
            for op in K3_OPS:
                x, vp, extra = k3_inputs(op, k, graph.n_pad, gen, device)
                for share in shares:
                    sent = (torch.rand(graph.n_pad, generator=gen,
                                       device=device) < share).to(torch.uint8)
                    worst = max(worst, check_k3_case(
                        csr, op, x, vp, extra, params, device, sent=sent,
                        long_rows=graph is gr))
                    cases += 1
    csr = g.csr("dst")
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


TC_HS = (64, 128, 4096)        # core sizes of phase 19's RMAT-16 checks
TAIL_HUB = dict(L=5000, k=8)   # tail lists of 5008 ids: ladder class 8192
TC_REPS = 5                    # bench.py's reps for the timed counts


def tc_pairs(e):
    """0-based int64 pairs of an upper-triangular edge list, on its
    device."""
    import torch
    return (torch.as_tensor(e.src).long() - 1,
            torch.as_tensor(e.dst).long() - 1)


def tail_hub_pairs(device, L, k):
    """A graph whose tail lists reach a large ladder class at h = 64: the
    complete bipartite graph between Y and Z (L vertices each), and k
    senders S, a clique, each joined to all of Y.  A vertex of Y has
    degree L + k and outranks S (degree L + k - 1), which outranks Z, so
    each sender's tail list holds Y below the core and the senders ranked
    above it (L + k - 64 ids and fewer), and the clique's edges are the
    probes.  Returns ``(u, v, n, triangles)``."""
    import torch
    ar = functools.partial(torch.arange, device=device)
    Y, Z, S = ar(L), L + ar(L), 2 * L + ar(k)
    i, j = torch.triu_indices(k, k, 1, device=device)
    u = torch.cat((Y.repeat_interleave(L), S.repeat_interleave(L), S[i]))
    v = torch.cat((Z.repeat(L), Y.repeat(k), S[j]))
    return u, v, 2 * L + k, k * (k - 1) // 2 * L + k * (k - 1) * (k - 2) // 6


def check_tc_kernels(what, u, v, n, h, device, canonical=False):
    """T1 and T2 against their plain versions on the device prep's
    arguments for one edge list, exactly; then the whole count against
    the host route's.  Returns a summary of the shapes."""
    import torch
    from graphmat_tpu_torch.ops import triangles as tri
    t1, *t2 = tri._kernel_args(u, v, n, h, canonical)
    t2 = t2[0] if t2 else None
    nacc = n + 1
    got = tri.core_count(*t1, torch.zeros(nacc, dtype=torch.int32,
                                          device=device))
    sync(device)
    ref = tri.core_count_reference(*t1, torch.zeros(
        nacc, dtype=torch.int32, device=device))
    if not torch.equal(got, ref):
        raise AssertionError(f"{what}: T1 differs from its plain version")
    info = {"edges": int(u.numel()), "bitmap": list(t1[0].shape),
            "t1_sum": int(ref.sum(dtype=torch.int64)), "probes": 0}
    if t2 is not None:
        got = tri.tail_count(*t2, torch.zeros(nacc, dtype=torch.int32,
                                              device=device))
        sync(device)
        ref = tri.tail_count_reference(*t2, torch.zeros(
            nacc, dtype=torch.int32, device=device))
        if not torch.equal(got, ref):
            raise AssertionError(f"{what}: T2 differs from its plain version")
        gk = t2[2]
        info.update(probes=int(gk.numel()),
                    t2_sum=int(ref.sum(dtype=torch.int64)),
                    widest=tri._LADDER[int(torch.maximum(
                        gk // tri._NC, gk % tri._NC).max())])
    pv, total = tri.count_triangles_bucketed(u, v, n, h=h,
                                             assume_canonical=canonical)
    pv_h, total_h = tri.count_triangles_bucketed(
        u, v, n, h=h, assume_canonical=canonical, impl="host")
    if total != total_h or not torch.equal(pv, pv_h):
        raise AssertionError(f"{what}: the device prep's count differs from "
                             f"the host route's ({total} != {total_h})")
    info["triangles"] = total
    return info


def phase_tc_kernels(device, scale=16, tail_hub=TAIL_HUB):
    """Phase 19 (a): T1 and T2 against their plain versions, exactly, on
    RMAT-``scale`` upper-triangular at each core size of TC_HS; on a graph
    whose every edge is core (RMAT-12, n = h = 4096) and one whose every
    edge is tail (h = 0: no core); on the tail-hub graph; on a graph of
    90 vertices (W = 3 words, padded to 4); on the empty graph."""
    import torch
    from graphmat_tpu_torch.io.transforms import convert_to_upper_triangular
    from graphmat_tpu_torch.ops import triangles as tri
    from graphmat_tpu_torch.utils.generators import (random_edgelist,
                                                      rmat_edgelist)
    res = {}
    e = convert_to_upper_triangular(rmat_edgelist(scale, 16, seed=1,
                                                  device=device))
    u, v = tc_pairs(e)
    for h in TC_HS:
        res[f"rmat{scale}_h{h}"] = check_tc_kernels(
            f"RMAT-{scale} h={h}", u, v, e.n, h, device, canonical=True)
    res[f"rmat{scale}_h0_all_tail"] = check_tc_kernels(
        f"RMAT-{scale} h=0", u, v, e.n, 0, device, canonical=True)
    if res[f"rmat{scale}_h0_all_tail"]["bitmap"][1] != 0:
        raise AssertionError("h = 0 must leave no core")
    e12 = convert_to_upper_triangular(rmat_edgelist(12, 16, seed=1,
                                                    device=device))
    u12, v12 = tc_pairs(e12)
    r12 = check_tc_kernels("RMAT-12 all core", u12, v12, e12.n, 4096,
                           device, canonical=True)
    if r12["probes"]:
        raise AssertionError("RMAT-12 at h = 4096 must have no tail")
    res["rmat12_all_core"] = r12
    hu, hv, hn, want = tail_hub_pairs(device, **tail_hub)
    rh = check_tc_kernels("tail hub", hu, hv, hn, 64, device, canonical=True)
    if rh["triangles"] != want or rh["widest"] < tail_hub["L"]:
        raise AssertionError(f"tail hub: {rh}, want {want} triangles")
    res["tail_hub"] = rh
    e90 = random_edgelist(90, 8, seed=1)
    u90 = torch.as_tensor(e90.src, device=device).long() - 1
    v90 = torch.as_tensor(e90.dst, device=device).long() - 1
    r90 = check_tc_kernels("n=90", u90, v90, 90, 4096, device)
    if r90["bitmap"][1] != 4:
        raise AssertionError(f"n=90: W4 {r90['bitmap'][1]}, want 4")
    res["n90_w3"] = r90
    empty = torch.zeros(0, dtype=torch.int64, device=device)
    pv, total = tri.count_triangles_bucketed(empty, empty, 1000)
    z = torch.zeros(0, dtype=torch.int32, device=device)
    before = dict(tri.LAUNCHES)
    tri.core_count(torch.zeros((1, 4), dtype=torch.int32, device=device),
                   torch.zeros((1, 1), dtype=torch.int32, device=device), z,
                   z, z, pv)
    tri.tail_count(z, tri._LADDER, z, z, z, z, pv)
    sync(device)
    if total or bool(pv.any()) or tri.LAUNCHES != before:
        raise AssertionError("the empty graph must count 0 and launch "
                             "nothing")
    res["empty"] = {"triangles": 0}
    log("phase 19 (a): T1 and T2 equal their plain versions exactly, and "
        "the device prep the host route: " + json.dumps(res))
    return res


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


def tc_profile(fn):
    """One run of ``fn`` under torch.profiler: wall ms, and device ms by
    part (T1, T2, device-to-host copies: the stats and the total; the
    rest is the prep's PyTorch ops), and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    parts = {"t1": 0.0, "t2": 0.0, "reads": 0.0, "prep": 0.0}
    top = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if ms <= 0:
            continue
        key = ("t1" if "core_count_kernel" in ev.key else
               "t2" if "tail_count_kernel" in ev.key else
               "reads" if "DtoH" in ev.key else "prep")
        parts[key] += ms
        top.append((ms, ev.count, ev.key[:70]))
    dev = sum(parts.values())
    if dev == 0:
        return {"wall_ms": wall, "device_ms": "not measured"}
    top.sort(reverse=True)
    return {"wall_ms": wall, "device_ms": dev,
            "device_idle_share": max(0.0, 1 - dev / wall),
            "parts_ms": parts,
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for ms, c, k in top[:8]]}


def tc_diagnosis(t1, t2, chunk=1 << 16):
    """Where T1's and T2's time goes on one count's arguments: the
    bitmap rows' popcounts (mean, quantiles, largest), the edges whose
    two rows are both real, the popcounts and nonzero words of the two
    rows over those edges (and the 32-byte sectors of a row that hold the
    words nonzero in both), the share of those edges whose receiver is
    one of the 25,000 busiest rows, the edges that share the previous
    edge's receiver row, T1's bytes an edge (16-byte quads of both rows) and
    what a two-level read would move (two 16-byte summaries and the
    words nonzero in both rows, from both); T2's probes and time by
    class pair, largest first (CUDA events, each pair's probes a slice of
    the sorted planes)."""
    import torch
    from graphmat_tpu_torch.ops import triangles as tri
    bm, iu, iv = t1[0], t1[-3], t1[-2]
    rows, w4 = bm.shape
    zero_row = rows - 1
    lut = tri._POPCOUNT8.to(bm.device)
    pop = torch.empty(rows, dtype=torch.int32, device=bm.device)
    nzw = torch.empty(rows, dtype=torch.int32, device=bm.device)
    for r0 in range(0, rows, chunk):
        b = bm[r0:r0 + chunk]
        pop[r0:r0 + chunk] = lut[b.contiguous().view(torch.uint8).int()].sum(
            1, dtype=torch.int32)
        nzw[r0:r0 + chunk] = (b != 0).sum(1, dtype=torch.int32)
    q = torch.quantile(pop[:-1].double(), torch.tensor(
        [0.5, 0.9, 0.99], dtype=torch.float64, device=bm.device)).tolist()
    real = (iu != zero_row) & (iv != zero_row)
    nreal = int(real.sum())
    a, b = iu[real].long(), iv[real].long()
    summ = t1[1]   # T1's summaries: a bit per word, a byte per sector
    both = torch.zeros(nreal, dtype=torch.int64, device=bm.device)
    for c0 in range(0, nreal, 1 << 22):
        x = summ[a[c0:c0 + (1 << 22)]] & summ[b[c0:c0 + (1 << 22)]]
        both[c0:c0 + (1 << 22)] = lut[x.contiguous().view(
            torch.uint8).int()].sum(1)
    # a summary byte covers 8 words, one 32-byte sector of a row
    sectors = torch.zeros(nreal, dtype=torch.int64, device=bm.device)
    for c0 in range(0, nreal, 1 << 22):
        x = summ[a[c0:c0 + (1 << 22)]] & summ[b[c0:c0 + (1 << 22)]]
        sectors[c0:c0 + (1 << 22)] = (x.contiguous().view(torch.uint8)
                                      != 0).sum(1)
    recv = torch.sort(torch.bincount(b, minlength=rows),
                      descending=True).values
    recv_top = float(recv[:25_000].sum()) / max(nreal, 1)
    e = iu.numel()
    same_recv = float((iv[1:] == iv[:-1]).double().mean()) if e > 1 else 0.0
    pmin = torch.minimum(pop[a], pop[b]).double()
    res = {
        "rows": rows, "words": w4,
        "row_popcount": {"mean": float(pop[:-1].double().mean()),
                         "median": q[0], "p90": q[1], "p99": q[2],
                         "max": int(pop.max())},
        "edges": e, "both_rows_real_share": nreal / max(e, 1),
        "over_both_real": {
            "sender_popcount_mean": float(pop[a].double().mean()),
            "receiver_popcount_mean": float(pop[b].double().mean()),
            "min_popcount_mean": float(pmin.mean()),
            "sender_nonzero_words_mean": float(nzw[a].double().mean()),
            "words_nonzero_in_both_mean": float(both.double().mean()),
            "words_nonzero_in_both_max": int(both.max()) if nreal else 0,
            "sectors_nonzero_in_both_mean": float(sectors.double().mean()),
            "top_25k_receiver_rows_edge_share": recv_top},
        "same_receiver_row_as_previous_edge": same_recv,
        "t1_bytes_an_edge_quads": 12 + nreal / max(e, 1) * 2 * 4 * w4,
        "t1_bytes_an_edge_two_level": 12 + (
            nreal * 2 * 16 + int(both.sum()) * 2 * 4) / max(e, 1)}
    del a, b, both, sectors, recv, pmin, summ, pop, nzw
    if t2 is not None:
        gk = t2[2]
        bounds = torch.cumsum(torch.bincount(gk.long()), 0).tolist()
        pairs, p0 = [], 0
        for g, p1 in enumerate(bounds):
            if p1 > p0:
                pairs.append((p1 - p0, g, p0, p1))
            p0 = p1
        pairs.sort(reverse=True)
        by_pair = []
        pv = torch.zeros(int(t2[-1].max()) + 1, dtype=torch.int32,
                         device=gk.device)
        for cnt, g, p0, p1 in pairs[:8]:
            sl = (*t2[:2], *(x[p0:p1] for x in t2[2:]))
            ms = event_ms(lambda: tri.tail_count(*sl, pv), 3, warm=1)
            by_pair.append({"pair": [tri._LADDER[g // tri._NC],
                                     tri._LADDER[g % tri._NC]],
                            "probes": cnt, "ms": ms})
        res["t2"] = {"probes": gk.numel(), "pairs": len(pairs),
                     "by_pair": by_pair}
    return res


def phase_tc_timings(card, scales=(20, 22)):
    """Phase 19 (d): TriangleCounting timed on the card, CUDA events.  At
    each RMAT scale (x 16, seed 1): undirected unique pairs made on the
    card, counted with ``assume_canonical=True``, each rep a cold count
    from the edge tensors (bench.py:492-525), ``TC_REPS`` reps, median,
    list and M edges/s; one count's torch.profiler breakdown and idle
    share; peak device memory over a count; T1 and T2 alone on that
    count's arguments beside their bounds (bytes read once at 3.35 TB/s)
    and their plain versions (one run each), whose outputs must equal the
    kernels' exactly."""
    import torch
    from graphmat_tpu_torch.io.transforms import convert_to_upper_triangular
    from graphmat_tpu_torch.ops import triangles as tri
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    res = {"card": card}
    for scale in scales:
        e = convert_to_upper_triangular(rmat_edgelist(scale, 16, seed=1,
                                                      device="cuda"))
        u, v = tc_pairs(e)
        n = e.n
        del e
        _, total = tri.count_triangles_bucketed(u, v, n,
                                                assume_canonical=True)
        times = []
        for _ in range(TC_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, tot = tri.count_triangles_bucketed(u, v, n,
                                                  assume_canonical=True)
            end.record()
            end.synchronize()
            if tot != total:
                raise AssertionError(f"RMAT-{scale} TC: rep gave {tot}, "
                                     f"first {total}")
            times.append(start.elapsed_time(end))
        med = statistics.median(times)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tri.count_triangles_bucketed(u, v, n, assume_canonical=True)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        prof = tc_profile(lambda: tri.count_triangles_bucketed(
            u, v, n, assume_canonical=True))

        t1, *rest = tri._kernel_args(u, v, n, canonical=True)
        nacc = n + 1
        pv = torch.zeros(nacc, dtype=torch.int32, device="cuda")
        ref = torch.zeros_like(pv)
        bm, sm, iu = t1[0], t1[1], t1[2]
        planes = 3 * iu.numel() * 4 + nacc * 4
        # each kernel timed, then its plain version once on the same
        # arguments (T2's takes tens of seconds here); the outputs of the
        # last launch and of the plain run must be equal.  T1's bound: the
        # bytes it may read, each once (the summaries, the bitmap's
        # nonzero words, three planes); the first design read all of it
        k = {"t1_ms": event_ms(lambda: tri.core_count(*t1, pv.zero_()), 10),
             "t1_plain_ms": event_ms(lambda: tri.core_count_reference(
                 *t1, ref.zero_()), 1, warm=0),
             "t1_max_abs_err": exact_err(f"RMAT-{scale} T1", pv, ref),
             "t1_bound_ms": hbm_ms(sm.numel() * 4 + int((bm != 0).sum()) * 4
                                   + planes),
             "t1_bound_ms_whole_bitmap": hbm_ms(bm.numel() * 4 + planes),
             "bitmap_rows": bm.shape[0], "edges": iu.numel()}
        for t2 in rest:   # T2's arguments, when some edge probes
            mats, gk = t2[0], t2[2]
            k.update(t2_ms=event_ms(lambda: tri.tail_count(
                *t2, pv.zero_()), 10),
                t2_plain_ms=event_ms(lambda: tri.tail_count_reference(
                    *t2, ref.zero_()), 1, warm=0),
                t2_max_abs_err=exact_err(f"RMAT-{scale} T2", pv, ref),
                t2_bound_ms=hbm_ms(mats.numel() * 4 + 4 * gk.numel() * 4
                                   + nacc * 4),
                probes=gk.numel(), tail_entries=mats.numel())
            pairs = torch.bincount(gk.long())
            top = torch.argsort(pairs, descending=True)[:6].tolist()
            k["probe_pairs"] = [[tri._LADDER[g // tri._NC],
                                 tri._LADDER[g % tri._NC], int(pairs[g])]
                                for g in top if int(pairs[g])]
            del t2, mats, gk
        k["diagnosis"] = tc_diagnosis(t1, rest[0] if rest else None)
        del t1, rest, bm, sm, iu, pv, ref
        res[f"rmat{scale}"] = {
            "m_undirected": u.numel(), "triangles": total,
            "ms": med, "reps_ms": times,
            "m_edges_per_s": u.numel() / med / 1e3,
            "peak_bytes": peak, "base_bytes": base,
            "profile": prof, "kernels": k}
        del u, v
        torch.cuda.empty_cache()
    log("phase 19 (d) (" + card + "): " + json.dumps(res))
    return res


def exact_err(what, got, ref):
    """The largest absolute difference of two integer outputs of one
    shape, which must be 0: raises otherwise."""
    err = float((got.long() - ref.long()).abs().max()) if got.numel() else 0.0
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


def annotate_mesh(mesh):
    """Wrap ``mesh``'s collectives in profiler ranges ``mesh.<name>``, so
    that a trace can sum the device time spent in them."""
    from torch.profiler import record_function
    for name in ("all_gather", "reduce_scatter", "all_to_all",
                 "all_reduce"):
        def wrapped(*a, _fn=getattr(mesh, name), _name=name, **kw):
            with record_function(f"mesh.{_name}"):
                return _fn(*a, **kw)
        setattr(mesh, name, wrapped)


def profile_steps(fn, steps=5, warm=2):
    """``fn`` under torch.profiler, ``warm`` traced steps discarded (the
    first steps of a window lost device events in two of three phase-20
    runs) and then ``steps`` kept, each ended by a synchronize; per kept
    step: wall ms, device ms (kernels, copies, fills), the device's idle
    share, the device time in the annotated mesh collectives
    (:func:`annotate_mesh`: the copies between tiles and the partial sums
    of a LocalMesh, the NCCL kernels of a ProcessMesh) and its share, and
    the top device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warm, active=steps,
                                   repeat=1)) as prof:
        for i in range(warm + steps):
            if i == warm:
                t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof.step()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows, mesh_ms = [], {}
    for ev in prof.key_averages():
        cuda = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.key.startswith("ProfilerStep"):
            continue   # the schedule's step range, not a kernel
        if ev.key.startswith("mesh."):
            if not cuda:   # its kernels' time; on the card, its span
                mesh_ms[ev.key] = getattr(ev, "device_time_total", getattr(
                    ev, "cuda_time_total", 0)) / 1e3 / steps
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0)) if cuda else 0
        if us > 0:
            rows.append((us / 1e3 / steps, ev.count / steps, ev.key[:70]))
    rows.sort(reverse=True)
    dev = sum(r[0] for r in rows)
    if dev == 0:
        return {"wall_ms": wall, "device_ms": "not measured"}
    return {"wall_ms": wall, "device_ms": dev,
            "device_idle_share": max(0.0, 1 - dev / wall),
            "collectives_ms": mesh_ms,
            "collectives_share": sum(mesh_ms.values()) / dev,
            "top": [{"kernel": k, "ms": ms, "count": c}
                    for ms, c, k in rows[:6]]}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist_slice(device, card, e=None, scale=22, edge_factor=16, seed=1,
                     n_sources=N_SOURCES, rounds=3):
    """Phase 20 (b)-(d): the main path at full width on a LocalMesh 2x2 of
    the one card and on a ProcessMesh 1x1 over NCCL (a world of one
    process, started here), each against the one-device Engine's
    PageRank; BFS from ``n_sources`` sources on the 2x2 mesh against the
    one-device BFS; step times, the collectives' share, peak memory.
    ``e`` is phase 5's edge list (made here when phase 5 did not run).
    Returns the K1 launches of the main-path runs."""
    import torch
    import torch.distributed as dist
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import bfs, pagerank
    from graphmat_tpu_torch.core.runtime import Engine
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.dist_runtime import DistEngine
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
        if not cuda:
            return k1

        # (d) the PageRank step on each, CUDA events, interleaved rounds;
        # degrees and a live pagerank first (the BFS runs replaced them)
        for g in (g1, g22, g11):
            pagerank.run_pagerank(g, iterations=1)
        engines = {"one_device": Engine(pagerank.PageRankProgram(), g1),
                   "2x2": DistEngine(pagerank.PageRankProgram(), g22),
                   "1x1 nccl": DistEngine(pagerank.PageRankProgram(), g11)}
        step = {name: [] for name in engines}
        for _ in range(rounds):
            for name, eng in engines.items():
                step[name].append(event_ms(eng.step_once, 5))
        out["step_ms"] = step
        out["gteps"] = {name: e.nnz / (min(v) * 1e-3) / 1e9
                        for name, v in step.items()}
        annotate_mesh(mesh)
        annotate_mesh(pmesh)
        out["profile"] = {name: profile_steps(eng.step_once)
                          for name, eng in engines.items()}
        out["peak_bytes_all"] = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    out["launches"] = k1
    log(f"phase 20 (b-d) ({card}): " + json.dumps(out))
    return k1


# ----------------------------- the push's sums in a fixed order; converter

PUSH_SHARES = (1e-4, 1e-2, 0.1)   # phase 21 (a): shares of senders sent
PUSH_REPEATS = 10                 # launches that must give the same bits
PUSH_MESH = (2, 4)                # phase 21 (a)'s LocalMesh
CONVERT_RTOL = 1e-5   # of max(1, |pr|): the converted graph's PageRank
# against the unconverted one's, the same edges relabelled: K1 then sums a
# row's terms in another order, and the float32 steps to convergence move
# (ROADMAP H1), so the steps are held equal in float64
H1_TAIL = 5   # last steps whose largest change H1's diagnoses log


def push_bound_bytes(n, senders, pushed_edges, got, mark=False):
    """The least bytes of a sparse push sum (or of its mark pass alone):
    the sent mask, each sender's rowptr pair and x, each pushed edge's
    receiver once, y (and the count, or the mark bytes) written once."""
    if mark:
        return n + 8 * senders + 4 * pushed_edges + n
    return (n + 12 * senders + 4 * pushed_edges + 4 * n
            + (4 * n if got else 0))


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


def pagerank_trace(g):
    """PageRank on ``g`` to convergence through the engine's current
    route, each step's largest change kept: (steps, [[step, largest
    |delta|, the pagerank where it fell, |delta| in float32 ulps of that
    value]] of the last H1_TAIL steps)."""
    import torch
    from graphmat_tpu_torch.apps import pagerank
    from graphmat_tpu_torch.core.runtime import engine_for
    rec = []

    class Traced(pagerank.PageRankProgram):
        def changed(self, old, new):
            d = (old["pagerank"] - new["pagerank"]).abs()
            i = d.argmax()
            rec.append(torch.stack((d[i], new["pagerank"][i])))
            return super().changed(old, new)
    pagerank.init_pagerank_graph(g)
    g.set_all_active()
    engine_for(pagerank.DegreeProgram(), g).run(iterations=1)
    steps = engine_for(Traced(), g).run()
    tail = torch.stack(rec).double().cpu().numpy()[-H1_TAIL:]
    first = steps - len(tail) + 1
    return steps, [[first + k, float(d), float(v),
                    float(d / np.spacing(np.float32(v)))]
                   for k, (d, v) in enumerate(tail)]


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
                    small_scale=16, mesh_shape=PUSH_MESH, reps=20,
                    convergence_check=True):
    """Phase 21 (a): the push's sums on K1's fixed order (ROADMAP P6),
    on ``e`` (phase 5's RMAT-``scale`` edge list; drawn when None)."""
    import torch
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps import incremental_pagerank as ipr
    from graphmat_tpu_torch.apps import pagerank
    from graphmat_tpu_torch.ops.spmv2 import (plan_for, push_mark,
                                              push_mark_reference,
                                              spmv_push, spmv_push_reference)
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
    outdeg = sc.rowptr.diff().long()
    report = {"card": card, "scale": scale, "n": g.n, "nnz": sc.nnz,
              "sums": {}}
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
        rec = {}
        if got:
            cnt = torch.zeros(n, dtype=torch.int32, device=device
                              ).index_add_(0, recv, sent[send].int())
            if not torch.equal(c_k1, cnt):
                raise AssertionError(f"push {name} sum: counts are not the "
                                     "exact in-edge counts")
        if sent is not None:
            mark = push_mark(sc.rowptr, sc.col, sent, n,
                             plan=plan_for(sc) if cuda else None)
            mark_err = float((mark.int() - push_mark_reference(
                sc.rowptr, sc.col, sent, n, sc.row).int()).abs().max())
            report["mark_max_abs_err"] = max(
                report.get("mark_max_abs_err", 0.0), mark_err)
            if mark_err:
                raise AssertionError(f"push {name}: the mark pass differs "
                                     "from its plain version")
            rec["senders"] = int(sent.sum())
            rec["pushed_edges"] = int(outdeg[sent.bool()].sum())
            rec["bound_ms"] = hbm_ms(push_bound_bytes(
                n, rec["senders"], rec["pushed_edges"], got))
            rec["mark_bound_ms"] = hbm_ms(push_bound_bytes(
                n, rec["senders"], rec["pushed_edges"], got, mark=True))
        else:
            rec["bound_ms"] = hbm_ms(4 * (rc.rowptr.numel() + rc.nnz + 2 * n))
        if cuda:
            rec["push_ms"] = event_ms(push, reps)
            rec["k1_ms"] = event_ms(k1, reps)
            if sent is not None:
                rec["mark_ms"] = event_ms(lambda: push_mark(
                    sc.rowptr, sc.col, sent, n, plan=plan_for(sc)), reps)
            if sent is None:
                rec["cusparse_ms"] = cusparse_ms(rc.rowptr, rc.col, x, reps)
            if sent is None or name == "sparse_got 0.01":
                rec["plain_ms"] = event_ms(lambda: spmv_push_reference(
                    sc, x, "sum", "x", sent=sent, want_got=got,
                    recv_csr=rc), 3, warm=1)
            if name == "sparse 0.01":
                rec["mark_plain_ms"] = event_ms(lambda: push_mark_reference(
                    sc.rowptr, sc.col, sent, n, sc.row), 3, warm=1)
        report["sums"][name] = rec
    report["max_abs_err"] = err
    del rc, sc, send, recv, outdeg, x
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
    # H1: logged, with the last steps' largest change on each graph)
    conv = pagerank_routes("converted", g_conv, cuda=cuda)
    trace_c = pagerank_trace(g_conv)
    del g_conv
    g_un = Graph(e_bi, device=device)
    unconv = pagerank_routes("unconverted", g_un, cuda=cuda)
    trace_u = pagerank_trace(g_un)
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
    report["pagerank_last_steps"] = {"converted": trace_c,
                                     "unconverted": trace_u}
    check_push_pagerank("converted graph", conv)
    report["seconds"] = time.perf_counter() - t_start
    log("phase 21 (b): " + json.dumps(report))
    return report


def phase_h1_steps(device, card):
    """Phase 21 (c): H1's diagnosis on the graph of ``tests/
    test_torch_cuda.py::test_pagerank_on_cuda_matches_cpu`` (RMAT-11 x
    16, seed 4, degree-permuted, compacted and not): PageRank's steps on
    ``device`` and on the CPU, with the last steps' largest change, and
    the steps in float64.  It checks nothing (the test does)."""
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    e = rmat_edgelist(11, 16, seed=4, device="cpu")
    steps, big = pagerank_f64(*edges0(e, "cpu"), e.n)
    report = {"card": card, "f64": {"steps": steps,
                                    "last_largest_changes": big[-3:]}}
    for compacted in (False, True):
        kw = dict(permute="degree", compact=compacted,
                  compact_kw=dict(wr=256, hub=16, divert_min=40, bpsb=2,
                                  w_div=1) if compacted else None)
        report[f"compacted={compacted}"] = {
            dev: pagerank_trace(Graph(e, device=dev, **kw))
            for dev in (device, "cpu")}
    log("phase 21 (c): " + json.dumps(report))
    return report


# ----------------------------------------------------- the RMAT stream

# (scale, edge factor, seed) -> (edges, hash) of the deduplicated draw,
# the hash sum(src * (n + 1) + dst) mod 2^61 over the 1-based ids: taken
# on the host from the JAX package's gm_rmat_gen
# (graphmat_tpu/native/planner.cpp:1627) through
# graphmat_tpu.utils.generators.rmat_edgelist(22, 16, seed=1,
# native=True), the graph bench.py draws
RMAT_GOLDEN = {(22, 16, 1): (65_243_295, 263_620_767_749_746_564)}
RMAT_SCALES = (16, 20)   # phase 22's kernel checks
RMAT_WEIGHTS = 255       # the weight range those checks draw


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


def phase_rmat(device, card, e=None, scales=RMAT_SCALES, time_scale=22,
               edge_factor=16, seed=1):
    """Phase 22: the RMAT stream's kernels (``csrc/rmat.cu``) against
    their plain versions, exactly: the keys of RMAT-``scale`` x 16 for
    each of ``scales`` and the weights (range RMAT_WEIGHTS) of its kept
    keys; then, on the card, RMAT-``time_scale``'s edge list (phase 5's
    ``e``, or a new draw) against its golden count and hash, and the
    keys kernel timed there beside its plain version and its bound (8 B
    a key written at 3.35 TB/s), the last timed call of each compared
    exactly."""
    import torch
    from graphmat_tpu_torch.ops import rmat
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    cuda = torch.device(device).type == "cuda"
    res = {"card": card}
    for scale in scales:
        nnz = (1 << scale) * edge_factor
        args = (scale, nnz, 0.57, 0.19, 0.19, seed)
        keys = rmat.rmat_keys(*args, device)
        sync(device)
        ref = rmat.rmat_keys_reference(*args, device)
        kerr = exact_err(f"RMAT-{scale} keys", keys, ref)
        kept = torch.unique(keys)
        val = rmat.rmat_weights(kept, seed, RMAT_WEIGHTS)
        sync(device)
        verr = exact_err(f"RMAT-{scale} weights", val,
                         rmat.rmat_weights_reference(kept, seed,
                                                     RMAT_WEIGHTS))
        res[f"rmat{scale}"] = {"keys": nnz, "distinct": kept.numel(),
                               "max_abs_err": max(kerr, verr)}
        del keys, ref, kept, val
    if cuda:
        if e is None:
            e = rmat_edgelist(time_scale, edge_factor, seed=seed,
                              device=device)
        res["golden"] = check_rmat_golden(e, time_scale, edge_factor, seed)
        del e
        nnz = (1 << time_scale) * edge_factor
        args = (time_scale, nnz, 0.57, 0.19, 0.19, seed)
        out = {}   # the last timed call's keys of each, compared below

        def kernel():
            out["kernel"] = rmat.rmat_keys(*args, device)

        def plain():
            out["plain"] = rmat.rmat_keys_reference(*args, device)
        res["timed"] = {
            "scale": time_scale, "keys": nnz, "ms": event_ms(kernel, 10),
            "plain_ms": event_ms(plain, 1, warm=1),
            "bound_ms": hbm_ms(8 * nnz),
            "max_abs_err": exact_err(f"RMAT-{time_scale} keys",
                                     out["kernel"], out["plain"])}
        del out
        torch.cuda.empty_cache()
    log("phase 22: the RMAT kernels equal their plain versions: "
        + json.dumps(res))
    return res


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

    k1_err = k3_err = push_err = 0.0
    if want(3):
        k1_err = phase_kernels("cuda")
    if want(4):
        phase_golden("cuda")
    if want(5):
        e, g, niter, k1, k2, krm = phase_slice("cuda")
    if want(6):
        t, k1_err_slice = phase_timings(e, g, card)
        k1_err = max(k1_err, k1_err_slice)
    e_slice = None   # phase 5's RMAT-22 edge list, kept for phase 20
    if want(5):
        e_slice = e
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
        push_err = max(push_err, t4["push_dense_max"]["max_abs_err"])
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
    if want(18):
        phase_above_l2(card)
    if want(19):
        phase_tc_kernels("cuda")
        phase_tc_golden()
        tc_run = phase_tc_slice("cuda")
        t6 = phase_tc_timings(card)
    dist_b = {}
    if want(20):
        phase_dist_routes("cuda")
        dist_b = phase_dist_slice("cuda", card, e=e_slice)
    if want(21):
        p21 = phase_push_sums("cuda", card, e=e_slice)
        k1_err = max(k1_err, p21["max_abs_err"])   # a push sum is K1's
        phase_converter("cuda", card)
        phase_h1_steps("cuda", card)
    if want(22):
        p22 = phase_rmat("cuda", card, e=e_slice)
    if want(23):
        t23 = time.perf_counter()
        phase_generic("cuda", card, e=e_slice)
        phase_text_loader("cuda", card)
        p23 = phase_graft("cuda", card)
        phase_validators("cuda", card, e=e_slice)
        log(f"phase 23: {time.perf_counter() - t23:.1f} s")
    del e_slice
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
    k1_path = (sum(k1.values()) + total("k1") + launches(dist_b, "k1")
               + launches(graft, "k1"))
    k2_path = k2["aux_gather"] + total("k2") + launches(graft, "k2")
    log(card)
    pmax, pm = t4["push_dense_max"], p21["sums"]["sparse 0.01"]
    # the push kernel's launches (min/max) apart from its mark pass's
    push_path = (total("push") - total("push.mark") + launches(graft, "push")
                 - launches(graft, "push.mark"))
    mark_path = total("push.mark")
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
            t["k2"]["ms"], t["k2"]["plain_ms"], t["k2"]["bound_ms"],
            "bytes", t["k2"]["index_select_ms"]),
        kernel_record(
            "spmv_vec2", "graphmat_tpu_torch/csrc/spmv_vec2.cu",
            "graphmat_tpu/ops/pallas_spmv_vec2.py:510",
            sum(k3_sgd.values()) + sum(k3_lda.values())
            + launches(graft, "k3"), k3_err,
            t3["k3_ms"]["sgd_ms"], t3["k3_ms"]["sgd_plain_ms"],
            t3["k3_ms"]["sgd_bound_ms"], t3["k3_ms"]["sgd_bound_by"], None),
        # the same kernel's sgd and sgd_sqerr on the benchmark's skewed
        # MovieLens-25M draw, each direction (phase 11), beside the record
        # above's uniform draw
        dict(kernel_record(
            "spmv_vec2 (skewed)", "graphmat_tpu_torch/csrc/spmv_vec2.cu",
            "graphmat_tpu/ops/pallas_spmv_vec2.py:510",
            sum(k3_sgd.values()), k3_err,
            t3["k3_ms"]["skewed"]["sgd_skewed_dst_ms"], None,
            t3["k3_ms"]["sgd_bound_ms"], t3["k3_ms"]["sgd_bound_by"], None),
            skewed=t3["k3_ms"]["skewed"]),
        # the same kernel's lda op at NYTimes shape (its launches are
        # counted in the record above too)
        kernel_record(
            "spmv_vec2 (lda)", "graphmat_tpu_torch/csrc/spmv_vec2.cu",
            "graphmat_tpu/ops/pallas_spmv_vec2.py:510",
            sum(k3_lda.values()), k3_err, t3["k3_ms"]["lda_ms"],
            t3["k3_ms"]["lda_plain_ms"], t3["k3_ms"]["lda_bound_ms"],
            t3["k3_ms"]["lda_bound_by"], None),
        # the push kernel (K7, its min/max modes): its dense max at
        # RMAT-22 (phase 15); a push sum is K1's sweep and counts there
        kernel_record(
            "spmv2", "graphmat_tpu_torch/csrc/spmv2.cu",
            "graphmat_tpu/ops/pallas_spmv2.py:1154", push_path, push_err,
            pmax["ms"], pmax["plain_ms"], pmax["bound_ms"], "bytes", None),
        # K6's own part, the mark pass of a sparse push sum, 1% of senders
        # sent at RMAT-22 (phase 21); no PyTorch call computes it
        kernel_record(
            "spmv2 mark pass", "graphmat_tpu_torch/csrc/spmv2.cu",
            "graphmat_tpu/ops/pallas_spmv2.py:388", mark_path,
            p21["mark_max_abs_err"], pm["mark_ms"], pm["mark_plain_ms"],
            pm["mark_bound_ms"], "bytes", None),
        # K4: the sparse mode, sgd, one direction, 10% of senders sent
        kernel_record(
            "spmv_vec2_sparse", "graphmat_tpu_torch/csrc/spmv_vec2.cu",
            "graphmat_tpu/ops/pallas_spmv_vec.py:65",
            sum(k4_path.values()), k4_err,
            sp["ms"], sp["plain_ms"],
            sp["bound_ms"], sp["bound_by"], None),
        # K5: fused into every sparse-mode launch as its got count; timed
        # alone as K1 with op x over the sent bits of a 10% frontier
        kernel_record(
            "spmv_vec2_sparse got count (alone: spmv2u op x)",
            "graphmat_tpu_torch/csrc/spmv_vec2.cu and "
            "graphmat_tpu_torch/csrc/spmv2u.cu",
            "graphmat_tpu/ops/pallas_spmv.py:254",
            sum(k4_path.values()), k5_err,
            k5t["ms"], k5t["plain_ms"],
            k5t["bound_ms"], "bytes", k5t["cusparse_ms"]),
        # T1 and T2 at RMAT-22: TriangleCounting's two hot loops, which
        # the JAX package runs as XLA ops; no PyTorch call computes either
        # (torch has no popcount)
        kernel_record(
            "tc_core_count", "graphmat_tpu_torch/csrc/triangles.cu",
            "graphmat_tpu/ops/triangles.py:439 (XLA loop, no Pallas kernel)",
            tc_run["rmat22"]["launches"].get("tc.core_count", 0),
            t6["rmat22"]["kernels"]["t1_max_abs_err"],
            t6["rmat22"]["kernels"]["t1_ms"],
            t6["rmat22"]["kernels"]["t1_plain_ms"],
            t6["rmat22"]["kernels"]["t1_bound_ms"], "bytes", None),
        kernel_record(
            "tc_tail_count", "graphmat_tpu_torch/csrc/triangles.cu",
            "graphmat_tpu/ops/triangles.py:485 (XLA loop, no Pallas kernel)",
            tc_run["rmat22"]["launches"].get("tc.tail_count", 0),
            t6["rmat22"]["kernels"]["t2_max_abs_err"],
            t6["rmat22"]["kernels"]["t2_ms"],
            t6["rmat22"]["kernels"]["t2_plain_ms"],
            t6["rmat22"]["kernels"]["t2_bound_ms"], "bytes", None),
    ]}
    # the RMAT stream's keys at RMAT-22 (phase 22), launched by phase 5's
    # draw; no PyTorch call computes splitmix64
    rt = p22["timed"]
    kernels["kernels"].append(kernel_record(
        "rmat", "graphmat_tpu_torch/csrc/rmat.cu",
        "graphmat_tpu/native/planner.cpp:1627 (gm_rmat_gen, C++/OpenMP; "
        "no Pallas kernel)", sum(krm.values()),
        max(r["max_abs_err"] for r in p22.values()
            if isinstance(r, dict) and "max_abs_err" in r),
        rt["ms"], rt["plain_ms"],
        rt["bound_ms"], "bytes", None))
    # SGD's initial factors at MovieLens-25M shape (phase 9): bitwise the
    # numpy draw there, so no error; launches are phase 9's init and
    # run_sgd's
    rr = sgd_run["rand_r"]
    kernels["kernels"].append(dict(kernel_record(
        "rand_r", "graphmat_tpu_torch/csrc/rand_r.cu",
        "graphmat_tpu/utils/reference_rng.py:54 (rand_r_uniform_np, numpy "
        "on the host; no Pallas kernel)", rr["launches"], 0.0, rr["ms"],
        rr["plain_ms"], rr["bound_ms"], "bytes", None),
        host_route_ms=rr["host_route_ms"]))
    idle = [r["name"] for r in kernels["kernels"] if r["launches"] == 0]
    if idle:
        raise AssertionError(f"the main path launched no {idle}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
