"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and ``nvcc``, and skips without them.
On a machine with a GPU (and without JAX, which ``tests/conftest.py``
imports), run::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: min, max, the got count and the gather are bitwise; a sum
is within 1e-5 of the row's Σ|terms| (the kernel's shuffle tree sums in
another order than ``scatter_reduce_``), and K3's ``lda_init`` within
1e-6 (its terms are the same rand_r draws); PageRank on the card is
within 1e-5 of max(1, |pr|) of PageRank on the CPU at the same step
count, each run stopping no earlier than the float64 run allows (ROADMAP
H1); SGD and LDA on the
card within 1e-6 (RMSE, factors) or 1e-5 relative (LDA's N, global_N and
log-likelihood, and factors after K = 40 steps) of the CPU port.  The
frontier apps on the card equal their CPU runs exactly (depths, parents,
distances, labels, orders), on both kernel routes; incremental PageRank
within 1e-5 of max(1, |pr|) (K1 sums in another order than the CPU).  The
push's sums are K1's over the receiver CSR: bitwise K1's and the same
over repeated launches.  T1 and T2
(TriangleCounting's core and tail counts) equal their plain versions
exactly, and TriangleCounting and GetNeighbors on the card their CPU
runs.  The RMAT stream's kernels equal their plain versions bit for bit,
and the rand_r draw (SGD's initial factors) the host's numpy draw.  The
readbacks of ``Graph`` and ``DistGraph`` return the state bitwise, in
writable arrays of page-locked blocks that a later readback reuses.
"""

import functools
import os

import numpy as np
import pytest
import torch

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import pagerank as tpr
from graphmat_tpu_torch.apps import sssp as tsssp
from graphmat_tpu_torch.core.runtime import engine_for
from graphmat_tpu_torch.ops import (compact, spmv2, spmv2u, spmv_vec,
                                    spmv_vec2, triangles)
from graphmat_tpu_torch.utils.generators import rmat_edgelist

pytestmark = pytest.mark.cuda

TEST_MTX = os.path.join(os.path.dirname(__file__), "..", "data",
                        "test.bin.mtx")
RATINGS7 = os.path.join(os.path.dirname(__file__), "..", "data",
                        "ratings7.bin.mtx")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_got"])
@pytest.mark.parametrize("op", ["x", "x_mul_val", "x_add_val"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_spmv_kernel_matches_plain(cuda, kind, op, mode):
    if mode == "sparse_got" and kind != "sum":
        pytest.skip("the got count rides the sum")
    g = gt.Graph(rmat_edgelist(12, 16, seed=3, device=cuda), device=cuda,
                 build_in_edges=False, compact=False)
    c = g.csr("dst")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn(g.n_pad, generator=gen, device=cuda)
    val = torch.randn(c.nnz, generator=gen, device=cuda)
    sent = None if mode == "dense" else (
        torch.rand(g.n_pad, generator=gen, device=cuda) < 0.4).to(
            torch.uint8)
    want_got = mode == "sparse_got"
    before = spmv2u.LAUNCHES[mode]
    out = spmv2u.spmv(c, x, kind, op, val=val, sent=sent, want_got=want_got)
    torch.cuda.synchronize()
    assert spmv2u.LAUNCHES[mode] == before + 1
    ref = spmv2u.spmv_reference(c, x, kind, op, val=val, sent=sent,
                                want_got=want_got)
    if want_got:
        (out, cnt), (ref, cnt_ref) = out, ref
        assert torch.equal(cnt, cnt_ref)
    if kind != "sum":
        assert torch.equal(out, ref)
        return
    terms = spmv2u.PROCESS_OPS[op](x[c.col.long()], val).abs()
    if sent is not None:
        terms = terms * sent[c.col.long()].float()
    bound = torch.zeros_like(out).index_add_(0, c.row.long(), terms) * 1e-5
    assert bool(((out - ref).abs() <= bound).all())


# bit patterns of x's senders 0-7: NaNs with payloads (quiet and
# signalling), -0.0, +-inf, a denormal, 1.0
K2_SPECIALS = [0x7FC00001, 0xFFC12345, 0x7F800001, 0x80000000, 0x7F800000,
               0xFF800000, 0x00000001, 0x3F800000]


@pytest.mark.parametrize("n", [1, 3, 4, 5, (1 << 20) + 3, 300_001,
                               "compacted"])
@pytest.mark.parametrize("fused", [False, True])
def test_aux_gather_kernel_matches_plain(cuda, fused, n):
    """K2, value-only and fused with the sent flags, bitwise its plain
    version at counts on and off whole quads and on a compacted CSR's own
    position map, in one launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    x = torch.randn(100_000, generator=gen, device=cuda)
    x[:8] = torch.tensor(K2_SPECIALS, dtype=torch.int64).to(
        torch.int32).view(torch.float32).to(cuda)
    sent = (torch.rand(x.numel(), generator=gen, device=cuda) < 0.5).to(
        torch.uint8)
    if n == "compacted":
        src = _compacted_pair()[0].src_of_pos
        n = src.numel()
    else:
        src = torch.randint(0, x.numel(), (n,), generator=gen, device=cuda,
                            dtype=torch.int32)
        src[:min(n, 8)] = torch.arange(min(n, 8), device=cuda,
                                       dtype=torch.int32)
    out = torch.empty(n, device=cuda)
    flags = torch.empty(n, dtype=torch.uint8, device=cuda)
    before = compact.LAUNCHES["aux_gather"]
    if fused:
        compact.aux_gather(x, src, out, sent, flags)
    else:
        compact.aux_gather(x, src, out)
    torch.cuda.synchronize()
    assert compact.LAUNCHES["aux_gather"] == before + 1
    ref, ref_flags = compact.aux_gather_reference(x, src, sent)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    if fused:
        assert torch.equal(flags, ref_flags)


# K1 on a compacted CSR: every reduce x ⊗ x mode, with and without
# recv_final (sparse modes), and packed keys
K1_COMPACT_CASES = [(k, op, m, f) for k in ("sum", "min", "max")
                    for op in ("x", "x_mul_val", "x_add_val", "key_add_val")
                    for m in ("dense", "sparse", "sparse_got")
                    for f in ((False,) if m == "dense" else (False, True))
                    if (m != "sparse_got" or k == "sum")
                    and (op != "key_add_val" or k == "min")]


@functools.lru_cache(maxsize=None)
def _compacted_pair():
    e = rmat_edgelist(11, 16, seed=4, device="cpu")
    kw = dict(permute="degree", build_in_edges=False, device="cuda")
    on = gt.Graph(e, compact=True, compact_kw=dict(
        wr=256, hub=16, divert_min=40, bpsb=2, w_div=1), **kw).csr("dst")
    off = gt.Graph(e, compact=False, **kw).csr("dst")
    return on, off


@pytest.mark.parametrize("kind,op,mode,final", K1_COMPACT_CASES)
def test_k1_on_compacted_csr_equals_uncompacted(cuda, kind, op, mode,
                                                final):
    """K1 reads the operand where it stands and a diverted edge's value
    from K2's extension: bitwise the uncompacted CSR's result, with one
    K2 launch a call."""
    on, off = _compacted_pair()
    assert on.src_of_pos is not None and off.src_of_pos is None
    gen = torch.Generator(device=cuda)
    gen.manual_seed(8)
    n = on.n_send
    if op == "key_add_val":
        x = (spmv2u.KEY_BIAS + torch.randint(
            0, 1 << 20, (n,), generator=gen, device=cuda)).to(
                torch.int32).view(torch.float32).clone()
        val = torch.randint(1, 8, (on.nnz,), generator=gen,
                            device=cuda).float()
    else:
        x = torch.randn(n, generator=gen, device=cuda)
        val = torch.randn(on.nnz, generator=gen, device=cuda)
    kw = dict(val=val, bits=13)
    if mode != "dense":
        kw["sent"] = (torch.rand(n, generator=gen, device=cuda)
                      < 0.4).to(torch.uint8)
        kw["want_got"] = mode == "sparse_got"
        if final:
            kw["recv_final"] = (torch.rand(on.n_rows, generator=gen,
                                           device=cuda) < 0.3).to(
                                               torch.uint8)
    k2 = compact.LAUNCHES["aux_gather"]
    a = spmv2u.spmv(on, x, kind, op, **kw)
    torch.cuda.synchronize()
    assert compact.LAUNCHES["aux_gather"] == k2 + 1
    b = spmv2u.spmv(off, x, kind, op, **kw)
    for u, v in zip(a if mode == "sparse_got" else (a,),
                    b if mode == "sparse_got" else (b,)):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))


def first_f64_stop(e, tol=1e-5, alpha=0.3, max_iter=1000):
    """The first step at which a float32 PageRank of ``e`` may stop: the
    float64 run (plain PyTorch, the port's program: start 0.3, a vertex
    with an in-edge takes alpha + (1 - alpha) * its sum) has a largest
    change within 2 float32 ulps of its largest value of ``tol``."""
    src0, dst0 = e.src.long() - 1, e.dst.long() - 1
    deg = torch.bincount(src0, minlength=e.n).double()
    got = torch.bincount(dst0, minlength=e.n) > 0
    pr = torch.full((e.n,), 0.3, dtype=torch.float64)
    for step in range(1, max_iter + 1):
        msg = torch.where(deg == 0, 0.0, pr / deg.clamp(min=1))
        acc = torch.zeros_like(pr).index_add_(0, dst0, msg[src0])
        new = torch.where(got, alpha + (1 - alpha) * acc, pr)
        big = float((new - pr).abs().max())
        pr = new
        if big <= tol + 2 * float(np.spacing(np.float32(pr.max()))):
            return step
    raise AssertionError("the float64 PageRank did not converge")


@pytest.mark.parametrize("compacted", [False, True])
def test_pagerank_on_cuda_matches_cpu(cuda, compacted):
    """Steps compared through the float64 run of the same graph, not with
    each other (ROADMAP H1): the card and the CPU sum in other orders, and
    near convergence a float32 change of 1-2 ulps decides the stop.  Each
    float32 run stops no earlier than the float64 run allows; run for the
    same steps, the two vectors agree within 1e-5 of max(1, |pr|)."""
    e = rmat_edgelist(11, 16, seed=4, device="cpu")
    kw = dict(permute="degree", compact=compacted,
              compact_kw=dict(wr=256, hub=16, divert_min=40, bpsb=2,
                              w_div=1) if compacted else None)
    k0 = first_f64_stop(e)
    _, it_c = tpr.run_pagerank(gt.Graph(e, device=cuda, **kw))
    _, it_h = tpr.run_pagerank(gt.Graph(e, device="cpu", **kw))
    assert it_c >= k0 and it_h >= k0
    k = max(it_c, it_h)
    pr_c, _ = tpr.run_pagerank(gt.Graph(e, device=cuda, **kw), iterations=k)
    pr_h, _ = tpr.run_pagerank(gt.Graph(e, device="cpu", **kw),
                               iterations=k)
    # float32 sums in other orders: 1e-5 of max(1, |pr|), as the oracle
    assert (abs(pr_c - pr_h) / np.maximum(1.0, abs(pr_h))).max() <= 1e-5


def test_pagerank_test_mtx_on_cuda(cuda):
    pr, it = tpr.run_pagerank(gt.Graph(gt.load_edgelist(TEST_MTX),
                                       device=cuda))
    assert it == 6 and abs(float(pr[6]) - 0.931978) < 2e-5


# ------------------------------------------------------------------ K3

K3_OPS = ["sgd", "sgd_sqerr", "lda_init", "lda", "lda_loglik"]
K3_PARAMS = {"alpha": 1.0, "eta": 5.0, "vocab_size": 300}


def _ratings_graph(device, users=500, items=300, ratings=20_000, seed=6,
                   **kw):
    """A bipartite graph (user -> item, integer ratings 1..5): the users'
    receiver=dst rows have no edges."""
    rng = np.random.default_rng(seed)
    n = users + items
    e = gt.edgelist_from_arrays(
        rng.integers(1, users + 1, ratings),
        users + rng.integers(1, items + 1, ratings),
        rng.integers(1, 6, ratings).astype(np.float32), m=n, n=n)
    return gt.Graph(e, device=device, **kw)


def _k3_inputs(op, k, n, device, seed=3):
    rng = np.random.default_rng(seed)
    w = k + 1 if op == "lda" else k

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    if op in ("sgd", "sgd_sqerr"):
        return (t(0.3 * rng.standard_normal((n, w))),
                t(0.3 * rng.standard_normal((n, w))), None)
    if op == "lda_init":
        return t(np.zeros((n, w))), None, None
    x, vp = rng.uniform(0.5, 5, (n, w)), rng.uniform(0.5, 5, (n, w))
    if op == "lda":
        x[:, k] = 0.0
        vp[:, k] = rng.random(n) < 0.5
        return t(x), t(vp), t(rng.uniform(50, 100, k))
    return t(x), t(vp), t(rng.uniform(100, 200, k))


def _row_rtol(op, k, deg, long_rows):
    """The sum bound's share of Σ|terms|: 1e-5, and 1e-6 for lda_init at
    the widths of up to 40 (its terms are the same rand_r draws).  Where
    rows are long (the row-length graph), or lda_init's normaliser sums
    more than 40 terms, float32 summation itself: a row's sum of deg terms
    in the kernel's order and in index_add_'s (which changes from run to
    run on CUDA) errs by up to (deg - 1) units each, and lda_init's K-term
    normaliser by up to K units each."""
    u = 2.0 ** -24
    rtol = 1e-6 if op == "lda_init" else 1e-5
    sums = 2 * (deg.float()[:, None] - 1).clamp(min=0) * u
    if op == "lda_init" and k > 40:
        return torch.clamp(sums + 2 * k * u, min=rtol)
    return torch.clamp(sums, min=rtol) if long_rows else rtol


def _dot_sensitivity(op, xe, vpe, val):
    """The K-term dot <x, vp_r> is summed in other orders too: a term moves
    by its sensitivity to the dot times K units of Σ|x vp|, beyond 1e-5 of
    the term where val - <x, vp_r> nearly cancels (held so at the widths
    past 40 and on the row-length graph, as in the sparse mode's test)."""
    dot = (xe * vpe).abs().sum(1, keepdim=True)
    err = (val - (xe * vpe).sum(1)).abs()[:, None]
    return dot * (xe.abs() if op == "sgd" else 2 * err)


def _check_k3(csr, op, k, device, init_rtol=None, long_rows=False):
    x, vp, extra = _k3_inputs(op, k, csr.n_send, device)
    before = spmv_vec2.LAUNCHES[op]
    out = spmv_vec2.spmv_vec(csr, x, op, vp=vp, extra=extra,
                             params=K3_PARAMS)
    torch.cuda.synchronize()
    assert spmv_vec2.LAUNCHES[op] == before + 1
    # no atomics, edge order per lane, a fixed tree: the same bits again
    assert torch.equal(out, spmv_vec2.spmv_vec(csr, x, op, vp=vp,
                                               extra=extra, params=K3_PARAMS))
    ref = spmv_vec2.spmv_vec_reference(csr, x, op, vp=vp, extra=extra,
                                       params=K3_PARAMS)
    assert out.shape == ref.shape
    assert bool((out[csr.rowptr.diff() == 0] == 0).all())
    col, row = csr.col.long(), csr.row.long()
    vpe = vp[row] if vp is not None else None
    terms = spmv_vec2.VEC_PROCESS_OPS[op](x[col], csr.val_f32, vpe, extra,
                                          K3_PARAMS).abs()
    if op in ("sgd", "sgd_sqerr") and (long_rows or k > 40):
        terms += _dot_sensitivity(op, x[col], vpe, csr.val_f32)
    rtol = _row_rtol(op, k, csr.rowptr.diff(), long_rows)
    if op == "lda_init" and init_rtol is not None:
        rtol = init_rtol
    bound = torch.zeros_like(out).index_add_(0, row, terms) * rtol
    assert bool(((out - ref).abs() <= bound).all())
    return out


# one lane an edge (K = 1, 4), lane groups of 4 to 32 (K = 20 to 200; 160
# was the parent kernel's bound), and the slab kernel past 256 columns
K3_WIDTHS = [1, 4, 20, 40, 96, 161, 200, 513]


@pytest.mark.parametrize("k", K3_WIDTHS)
@pytest.mark.parametrize("op", K3_OPS)
def test_spmv_vec2_kernel_matches_plain(cuda, op, k):
    _check_k3(_ratings_graph(cuda, build_in_edges=False).csr("dst"), op, k,
              cuda)


@functools.lru_cache(maxsize=None)
def _row_length_csr():
    """Receiver rows of 0, 1, 31, 32, 33, C and C + 1 edges, 2^16 edges
    and 81,491 (MovieLens-25M's most rated film), 64 and 80 chunks of C
    (distinct random senders, integer counts), with empty rows between
    them."""
    rng = np.random.default_rng(8)
    c = spmv2u.CHUNK_EDGES
    n, src, dst, recv = 1 << 17, [], [], 1
    for length, count in ((1, 300), (31, 40), (32, 40), (33, 40), (c, 3),
                          (c + 1, 3), (1 << 16, 1), (81_491, 1)):
        for _ in range(count):
            src.append(1 + rng.permutation(n)[:length])
            dst.append(np.full(length, recv))
            recv += 2
    src, dst = np.concatenate(src), np.concatenate(dst)
    e = gt.edgelist_from_arrays(src, dst, rng.integers(1, 6, len(src)).astype(
        np.float32), m=n, n=n)
    return gt.Graph(e, device="cuda", build_in_edges=False).csr("dst")


@pytest.mark.parametrize("k", [4, 20, 161])
@pytest.mark.parametrize("op", K3_OPS)
def test_spmv_vec2_kernel_on_row_lengths(cuda, op, k):
    """Row ends inside and at a warp's batch of 32 edges, a row of C edges
    on one warp, rows of C + 1, 2^16 and 81,491 edges cut into chunks;
    empty rows exactly 0."""
    _check_k3(_row_length_csr(), op, k, cuda, long_rows=True)


def test_spmv_vec2_kernel_without_edges(cuda):
    """A graph with no edges at all: every row is 0."""
    e = gt.edgelist_from_arrays(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                np.zeros(0, np.float32), m=40, n=40)
    c = gt.Graph(e, device=cuda, build_in_edges=False).csr("dst")
    for op in K3_OPS:
        out = _check_k3(c, op, 20, cuda)
        assert not bool(out.any())


def test_spmv_vec2_kernel_on_compacted_csr(cuda):
    """K3 reads the CSR's own senders: on a CSR compacted for K1 it gives
    the same answer, bit for bit."""
    kw = dict(permute="degree",
              compact_kw=dict(wr=256, hub=16, divert_min=40, bpsb=2,
                              w_div=1))
    e = rmat_edgelist(11, 16, seed=4, device="cpu")
    e.val = torch.randint(1, 6, (e.nnz,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    on = gt.Graph(e, device=cuda, compact=True, **kw).csr("dst")
    off = gt.Graph(e, device=cuda, compact=False, **kw).csr("dst")
    assert on.src_of_pos is not None and off.src_of_pos is None
    # RMAT hub rows sum thousands of positive lda_init terms: two float32
    # orders drift past 1e-6 there (1.3e-6 measured on an H100)
    for op in K3_OPS:
        assert torch.equal(_check_k3(on, op, 20, cuda, init_rtol=1e-5),
                           _check_k3(off, op, 20, cuda, init_rtol=1e-5))


def test_sgd_on_cuda_matches_cpu(cuda):
    from graphmat_tpu_torch.apps import sgd as tsgd
    before = spmv_vec2.LAUNCHES["sgd"]
    lv_c, r0_c, r1_c = tsgd.run_sgd(gt.Graph(gt.load_edgelist(RATINGS7),
                                             device=cuda))
    assert spmv_vec2.LAUNCHES["sgd"] == before + 20
    lv_h, r0_h, r1_h = tsgd.run_sgd(gt.Graph(gt.load_edgelist(RATINGS7),
                                             device="cpu"))
    assert abs(r0_c - r0_h) <= 1e-6 * r0_h and abs(r1_c - r1_h) <= 1e-6 * r1_h
    np.testing.assert_allclose(lv_c, lv_h, rtol=0, atol=1e-6)
    g_c = _ratings_graph(cuda, permute="degree")
    g_h = _ratings_graph("cpu", permute="degree")
    lv_c, r0_c, r1_c = tsgd.run_sgd(g_c, k=40, step=1e-4, iterations=3)
    lv_h, r0_h, r1_h = tsgd.run_sgd(g_h, k=40, step=1e-4, iterations=3)
    assert abs(r1_c - r1_h) <= 1e-6 * r1_h
    np.testing.assert_allclose(lv_c, lv_h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("first_seed", [1, 2 ** 32 - 300])
@pytest.mark.parametrize("k", [1, 3, 20, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rand_r_uniform_kernel_matches_numpy(cuda, dtype, k, first_seed):
    """The rand_r draw bitwise ``rand_r_uniform_np(...).astype(...)``, one
    launch a call: n not a multiple of the kernel's 128 rows a block; k
    = 40 takes two column chunks; from 2^32 - 300 the seeds wrap to 0."""
    from graphmat_tpu_torch.ops import rand_r
    from graphmat_tpu_torch.utils.reference_rng import rand_r_uniform_np
    n = 1000
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    seeds = ((np.arange(n, dtype=np.uint64) + first_seed) % 2 ** 32).astype(
        np.uint32)
    before = rand_r.LAUNCHES["uniform"]
    got = rand_r.rand_r_uniform(first_seed, n, k, dtype, cuda)
    torch.cuda.synchronize()
    assert rand_r.LAUNCHES["uniform"] == before + 1
    assert got.dtype == dtype and got.shape == (n, k)
    want = rand_r_uniform_np(seeds, k).astype(np_dtype)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint8),
                                  want.view(np.uint8))


@pytest.mark.parametrize("permute", [False, "degree"])
def test_init_sgd_graph_on_cuda_matches_cpu(cuda, permute):
    """SGD's initial factors drawn on the card equal the CPU's bitwise, in
    one launch; with the recorder on, ``Graph`` counts only the 4-byte
    ``sqerr`` fill as copied up, and BFS's init only its two fills."""
    from torch.profiler import ProfilerActivity, profile
    from graphmat_tpu_torch.apps import bfs as tbfs
    from graphmat_tpu_torch.apps import sgd as tsgd
    from graphmat_tpu_torch.ops import rand_r
    from graphmat_tpu_torch.utils import timing
    g_c = _ratings_graph(cuda, permute=permute)
    g_h = _ratings_graph("cpu", permute=permute)
    before = rand_r.LAUNCHES["uniform"]
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tsgd.init_sgd_graph(g_c, 20)
    c = timing.snapshot()["counters"]
    assert rand_r.LAUNCHES["uniform"] == before + 1
    assert c["copy.htod.bytes"] == 4
    tsgd.init_sgd_graph(g_h, 20)
    np.testing.assert_array_equal(g_c.vp_numpy()["lv"].view(np.uint32),
                                  g_h.vp_numpy()["lv"].view(np.uint32))
    timing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        tbfs.init_bfs_graph(g_c, 2)
    assert timing.snapshot()["counters"]["copy.htod.bytes"] == 8
    timing.reset()
    tbfs.init_bfs_graph(g_h, 2)
    for name, v in g_c.vp_numpy().items():
        np.testing.assert_array_equal(v, g_h.vp_numpy()[name])


def _bipartite_edges(ndoc, nterms, seed=0, maxcount=5):
    """tests/test_ml_apps.py's doc-term generator (no JAX here)."""
    rng = np.random.default_rng(seed)
    src, dst, val = [], [], []
    for d in range(1, ndoc + 1):
        terms = rng.choice(nterms, size=rng.integers(1, nterms + 1),
                           replace=False)
        for t in terms:
            src.append(d)
            dst.append(ndoc + 1 + int(t))
            val.append(int(rng.integers(1, maxcount + 1)))
    n = ndoc + nterms
    return gt.edgelist_from_arrays(src, dst, val, m=n, n=n)


@pytest.mark.parametrize("k,permute", [(4, False), (40, "degree")])
def test_lda_on_cuda_matches_cpu(cuda, k, permute):
    from graphmat_tpu_torch.apps import lda as tlda
    e = _bipartite_edges(9, 14, seed=11)
    before = spmv_vec2.LAUNCHES["lda"]
    n_c, gn_c, ll_c = tlda.run_lda(gt.Graph(e, device=cuda, permute=permute),
                                   9, 14, k=k, iterations=4)
    assert spmv_vec2.LAUNCHES["lda"] == before + 8
    n_h, gn_h, ll_h = tlda.run_lda(gt.Graph(e, permute=permute,
                                            device="cpu"), 9, 14, k=k,
                                   iterations=4)
    np.testing.assert_allclose(n_c, n_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gn_c, gn_h, rtol=1e-5)
    assert abs(ll_c - ll_h) <= 1e-5 * abs(ll_h)


# ---------------------------- K3's sparse mode (K4 with K5's got count)


@pytest.mark.parametrize("share", [1.0, 0.1, 0.01, 0.0])
@pytest.mark.parametrize("k", K3_WIDTHS)
@pytest.mark.parametrize("op", K3_OPS)
def test_spmv_vec_sparse_kernel_matches_plain(cuda, op, k, share):
    """The sparse mode against its plain version: the count exactly, a
    row without a sent edge exactly 0, sums within 1e-5 of the row's
    Σ|terms| over sent edges (1e-6 for lda_init); with every sender sent,
    the dense mode's bits."""
    _check_k3_sparse(_ratings_graph(cuda, build_in_edges=False).csr("dst"),
                     op, k, share, cuda)


@pytest.mark.parametrize("share", [1.0, 0.1])
@pytest.mark.parametrize("k", [4, 20, 161])
@pytest.mark.parametrize("op", K3_OPS)
def test_spmv_vec_sparse_kernel_on_row_lengths(cuda, op, k, share):
    _check_k3_sparse(_row_length_csr(), op, k, share, cuda, long_rows=True)


def _check_k3_sparse(csr, op, k, share, cuda, long_rows=False):
    x, vp, extra = _k3_inputs(op, k, csr.n_send, cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    sent = (torch.rand(csr.n_send, generator=gen, device=cuda)
            < share).to(torch.uint8)
    kw = dict(vp=vp, extra=extra, params=K3_PARAMS)
    before = spmv_vec.LAUNCHES[op]
    out, got = spmv_vec.spmv_vec_sparse(csr, x, op, sent, **kw)
    torch.cuda.synchronize()
    assert spmv_vec.LAUNCHES[op] == before + 1
    # sent edges handed out by rank, no atomics: the same bits again
    again, got_again = spmv_vec.spmv_vec_sparse(csr, x, op, sent, **kw)
    assert torch.equal(out, again) and torch.equal(got, got_again)
    ref, got_ref = spmv_vec.spmv_vec_sparse_reference(csr, x, op, sent, **kw)
    assert torch.equal(got, got_ref)
    assert bool((out[got == 0] == 0).all())
    col, row = csr.col.long(), csr.row.long()
    vpe = vp[row] if vp is not None else None
    terms = spmv_vec2.VEC_PROCESS_OPS[op](x[col], csr.val_f32, vpe, extra,
                                          K3_PARAMS).abs()
    if op in ("sgd", "sgd_sqerr"):
        terms += _dot_sensitivity(op, x[col], vpe, csr.val_f32)
    terms = terms * sent[col][:, None]
    rtol = _row_rtol(op, k, got, long_rows)
    bound = torch.zeros_like(out).index_add_(0, row, terms) * rtol
    assert bool(((out - ref).abs() <= bound).all())
    if share == 1.0:
        assert torch.equal(out, spmv_vec2.spmv_vec(csr, x, op, **kw))


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_k5_through_k1_matches_plain(cuda, kind):
    """K5's function is K1 with op x: min and max bitwise, the sum of the
    sent bits exactly (integers)."""
    from graphmat_tpu_torch.ops import spmv as k5
    csr = _ratings_graph(cuda, build_in_edges=False).csr("dst")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(6)
    x = (torch.rand(csr.n_send, generator=gen, device=cuda) < 0.1).float()
    if kind != "sum":
        x = torch.randn(csr.n_send, generator=gen, device=cuda)
    assert torch.equal(k5.spmv(csr, x, kind), k5.spmv_reference(csr, x, kind))


@pytest.mark.parametrize("program", ["sgd", "rmse"])
def test_active_only_vec_on_cuda_matches_cpu(cuda, program):
    """An ACTIVE_ONLY K-wide program from a seeded frontier of 20% of the
    vertices, three iterations, on the card's sparse mode against the
    CPU: factors within 1e-6, squared errors within 1e-5 relative, the
    frontiers equal."""
    from graphmat_tpu_torch.apps import sgd as tsgd
    base = tsgd.SGDProgram if program == "sgd" else tsgd.RMSEProgram
    prog = type("ActiveOnly", (base,),
                {"activity": gt.Activity.ACTIVE_ONLY})(k=20)
    if program == "sgd":
        prog.step = 1e-4
    mask = np.random.default_rng(9).random(800) < 0.2
    out = {}
    for dev in (cuda, "cpu"):
        g = _ratings_graph(dev)
        tsgd.init_sgd_graph(g, 20)
        g.set_active_mask(mask)
        before = sum(spmv_vec.LAUNCHES.values())
        gt.Engine(prog, g).run(iterations=3)
        launched = sum(spmv_vec.LAUNCHES.values()) - before
        assert launched == (0 if dev == "cpu" else
                            3 * (2 if program == "sgd" else 1))
        out[str(dev)] = (g.vp_numpy(), g.active.cpu().numpy())
    (vc, ac), (vh, ah) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(vc["lv"], vh["lv"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(vc["sqerr"], vh["sqerr"], rtol=1e-5)
    np.testing.assert_array_equal(ac, ah)


# ------------------------------------------- the frontier apps' kernels


def _rmat_graph(device, scale=12, **kw):
    return gt.Graph(rmat_edgelist(scale, 16, seed=3, device=device),
                    device=device, compact=False, **kw)


def _weighted_graph(device, scale=12):
    """The RMAT graph with normal edge values, its sender-major index
    built: a push sum reads the values of the graph's own edges."""
    e = rmat_edgelist(scale, 16, seed=3, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    val = torch.randn(e.nnz, generator=gen, device=device)
    return gt.Graph(gt.EdgeList(e.m, e.n, e.src, e.dst, val), device=device,
                    compact=False, build_in_edges=False)


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kind,op", [("min", "x_add_val"), ("sum", "x"),
                                     ("min", "key_add_val"), ("min", "x"),
                                     ("min", "x_mul_val"),
                                     ("sum", "x_mul_val"),
                                     ("sum", "x_add_val")])
def test_spmv_recv_final_and_keys_match_plain(cuda, kind, op, share):
    g = _rmat_graph(cuda, build_in_edges=False)
    c = g.csr("dst")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(2)
    bits = 13
    if op == "key_add_val":
        keys = spmv2u.KEY_BIAS + torch.randint(
            0, 1 << 20, (g.n_pad,), generator=gen, device=cuda)
        x = keys.to(torch.int32).view(torch.float32).clone()
        val = torch.randint(1, 8, (c.nnz,), generator=gen,
                            device=cuda).float()
    else:
        x = torch.randn(g.n_pad, generator=gen, device=cuda)
        val = torch.randn(c.nnz, generator=gen, device=cuda)
    sent = (torch.rand(g.n_pad, generator=gen, device=cuda) < 0.4).to(
        torch.uint8)
    rf = (torch.rand(g.n_pad, generator=gen, device=cuda) < share).to(
        torch.uint8)
    got = kind == "sum"
    mode = "sparse_got_final" if got else "sparse_final"
    before = spmv2u.LAUNCHES[mode]
    kw = dict(val=val, sent=sent, want_got=got, recv_final=rf, bits=bits)
    out = spmv2u.spmv(c, x, kind, op, **kw)
    torch.cuda.synchronize()
    assert spmv2u.LAUNCHES[mode] == before + 1
    ref = spmv2u.spmv_reference(c, x, kind, op, **kw)
    if got:
        (out, cnt), (ref, cnt_ref) = out, ref
        assert torch.equal(cnt, cnt_ref)
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    else:
        assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert bool((out[rf.bool()] == spmv2u.IDENTITY[kind]).all())


@pytest.mark.parametrize("frontier", [None, 1e-4, 1e-2, 0.5])
@pytest.mark.parametrize("kind,op", [
    (k, o) for k in ("sum", "min", "max")
    for o in ("x", "x_mul_val", "x_add_val")]
    + [("min", "key_add_val"), ("max", "key_add_val")])
def test_push_kernel_matches_plain(cuda, kind, op, frontier):
    """The push against its plain version: min and max launch the push
    kernel; a dense sum K1 alone; a sparse sum the mark pass, then K1 with
    the unmarked rows final.  Packed keys (one in ten the +inf fill) take
    integer weights 1..7."""
    g = _weighted_graph(cuda)
    sc = g.sender_csr("dst")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    x = torch.randn(g.n_pad, generator=gen, device=cuda)
    val = sc.val_f32
    sent = None if frontier is None else (
        torch.rand(g.n_pad, generator=gen, device=cuda) < frontier).to(
            torch.uint8)
    if op == "key_add_val":
        keys = spmv2u.KEY_BIAS + torch.randint(
            0, 1 << 20, (g.n_pad,), generator=gen, device=cuda)
        x = keys.to(torch.int32).view(torch.float32).clone()
        x[torch.rand(g.n_pad, generator=gen, device=cuda) < 0.1] = \
            float("inf")
        val = torch.randint(1, 8, (sc.nnz,), generator=gen,
                            device=cuda).float()
    got = kind == "sum" and sent is not None
    mode = "dense" if sent is None else "sparse"
    if kind != "sum":
        want = {("push", mode): 1}
    elif sent is None:
        want = {("k1", "dense"): 1}
    else:
        want = {("push", "mark"): 1, ("k1", "sparse_got_final"): 1}
    tables = {"push": spmv2.LAUNCHES, "k1": spmv2u.LAUNCHES}
    before = {k: dict(t) for k, t in tables.items()}
    out = spmv2.spmv_push(sc, x, kind, op, val=val, sent=sent,
                          want_got=got, bits=20)
    torch.cuda.synchronize()
    launched = {(k, m): n - before[k][m] for k, t in tables.items()
                for m, n in t.items() if n != before[k][m]}
    assert launched == want
    ref = spmv2.spmv_push_reference(sc, x, kind, op, val=val, sent=sent,
                                    want_got=got, bits=20)
    if got:
        (out, cnt), (ref, cnt_ref) = out, ref
        assert torch.equal(cnt, cnt_ref)
    if kind != "sum":
        assert torch.equal(out, ref)
        return
    terms = spmv2u.PROCESS_OPS[op](x[sc.row.long()], val).abs()
    if sent is not None:
        terms = terms * sent[sc.row.long()].float()
    bound = torch.zeros_like(out).index_add_(0, sc.col.long(), terms) * 1e-5
    assert bool(((out - ref).abs() <= bound).all())


def _app_runs(device):
    """Every frontier app on one graph family, as numpy results."""
    from graphmat_tpu_torch.apps import (bfs, connected_components as cc,
                                         delta_stepping as ds,
                                         incremental_pagerank as ipr,
                                         sssp, topological_sort as ts)
    e = rmat_edgelist(11, 16, seed=8, device="cpu")
    w = np.random.default_rng(3).integers(1, 256, e.nnz)
    ew = gt.EdgeList(e.m, e.n, e.src, e.dst, torch.as_tensor(
        w, dtype=torch.float32))
    g = gt.Graph(e, device=device, permute="degree")
    gw = gt.Graph(ew, device=device, build_in_edges=False,
                  permute="degree")
    e_aug, pred0, ind1 = bfs.build_bfs_shortcuts(e)
    out = {"bfs": bfs.run_bfs(g, 5), "cc": cc.run_connected_components(g),
           "incpr": ipr.run_incremental_pagerank(g),
           "sssp": sssp.run_sssp(gw, 5),
           "delta": ds.run_delta_stepping(ew, 32, 5, device=device),
           "bfs_fast": bfs.run_bfs_fast(gt.Graph(
               e_aug, device=device, build_in_edges=False), 5, pred0, ind1),
           "toposort": ts.run_topological_sort(gt.Graph(
               gt.transforms.convert_to_dag(e), device=device,
               permute="degree"))}
    return out


@pytest.mark.parametrize("route", ["v2u", "v2"])
def test_frontier_apps_on_cuda_match_cpu(cuda, route, monkeypatch):
    monkeypatch.setenv("GRAPHMAT_KERNEL", route)
    before = (dict(spmv2u.LAUNCHES), dict(spmv2.LAUNCHES))
    on_card = _app_runs(cuda)
    k1, push = ({m: n - b[m] for m, n in t.items()} for t, b in
                zip((spmv2u.LAUNCHES, spmv2.LAUNCHES), before))
    if route == "v2u":
        assert sum(k1.values()) > 0 and sum(push.values()) == 0
    else:
        # the push's min/max, and its sums: a sparse sum is the mark pass
        # and one K1 sweep with the unmarked rows final
        assert push["dense"] + push["sparse"] > 0 and push["mark"] > 0
        assert k1["sparse"] == k1["sparse_got"] == 0
        assert k1["sparse_final"] + k1["sparse_got_final"] == push["mark"]
    on_host = _app_runs("cpu")
    for app, res in on_card.items():
        if app == "incpr":   # the pagerank; thresholds may move niter
            a, b = res[0], on_host[app][0]
            assert (abs(a - b) / np.maximum(1.0, abs(b))).max() <= 1e-5
            continue
        for a, b in zip(res, on_host[app]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------- the split paths: hub senders, hub rows, group limits

HUB = 1 << 20


@functools.lru_cache(maxsize=None)
def _hub_graph(int_weights=False):
    """RMAT-12 plus a sender with 2^20 out-edges (0-based id HUB + 1), a
    receiver with 2^20 in-edges (HUB + 2), receivers and senders of
    exactly 16, 17, 32, 33, 64, 65, C and C + 1 edges, and empty rows;
    normal edge values, or integer weights 1..7 for the packed keys (the
    push's sums read the graph's own values)."""
    rng = np.random.default_rng(12)
    e = rmat_edgelist(12, 16, seed=3, device="cpu")
    c = spmv2u.CHUNK_EDGES
    span = np.arange(HUB)
    src = [e.src.numpy().astype(np.int64) - 1, np.full(HUB, HUB + 1), span]
    dst = [e.dst.numpy().astype(np.int64) - 1, span, np.full(HUB, HUB + 2)]
    for i, ln in enumerate((16, 17, 32, 33, 64, 65, c, c + 1)):
        peers = rng.choice(HUB, ln, replace=False)
        src += [peers, np.full(ln, HUB + 16 + i)]
        dst += [np.full(ln, HUB + 32 + i), peers]
    src, dst = np.concatenate(src) + 1, np.concatenate(dst) + 1
    n = HUB + 4096
    val = (rng.integers(1, 8, len(src)) if int_weights
           else rng.standard_normal(len(src))).astype(np.float32)
    return gt.Graph(gt.edgelist_from_arrays(src, dst, val, m=n, n=n),
                    device="cuda", compact=False)


def _hub_inputs(g, kind, op, nnz, seed):
    """x (for a sum of keys: half keys, half signed values the op passes
    through), val, the 1% frontier with the hub sender, a 50% final mask
    with the hub receiver's row final."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = g.n_pad
    x = torch.randn(n, generator=gen, device="cuda")
    val = torch.randn(nnz, generator=gen, device="cuda")
    if op == "key_add_val":
        keys = spmv2u.KEY_BIAS + torch.randint(
            0, 1 << 20, (n,), generator=gen, device="cuda")
        xk = keys.to(torch.int32).view(torch.float32).clone()
        half = torch.rand(n, generator=gen, device="cuda") < 0.5
        x = torch.where(half, xk, x if kind == "sum" else float("inf"))
        val = torch.randint(1, 8, (nnz,), generator=gen, device="cuda").float()
    sent = (torch.rand(n, generator=gen, device="cuda") < 0.01).to(
        torch.uint8)
    sent[HUB + 1] = 1
    rf = (torch.rand(n, generator=gen, device="cuda") < 0.5).to(torch.uint8)
    rf[HUB + 2] = 1
    return x, val, sent, rf


def _check_against_plain(out, ref, kind, got, terms, recv_of_edge, sent_e):
    if got:
        (out, cnt), (ref, cnt_ref) = out, ref
        assert torch.equal(cnt, cnt_ref)
    if kind != "sum":
        assert torch.equal(out, ref)
        return
    if sent_e is not None:
        terms = terms * sent_e
    bound = torch.zeros_like(out).index_add_(0, recv_of_edge,
                                             terms.abs()) * 1e-5
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_final",
                                  "sparse_final_live", "sparse_half"])
@pytest.mark.parametrize("op", ["x", "x_mul_val", "x_add_val",
                                "key_add_val"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_hub_graph_kernels_match_plain(cuda, kind, op, mode):
    """K1 and the push on the hub graph, where hub rows are chunked and
    combined, hub senders spread over many warps and every lane-group
    width runs: min, max and counts bitwise, sums within 1e-5 of Σ|terms|.
    The sparse modes send 1% of senders and the hub sender, a sum with
    its got count; K1 with half the rows final, the hub receiver's row
    final or live; ``sparse_half`` sends half the senders, a sum without
    the count."""
    g = _hub_graph(op == "key_add_val")
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    x, val, sent, rf = _hub_inputs(g, kind, op, rc.nnz, 7)
    if mode == "sparse_half":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(13)
        sent = (torch.rand(g.n_pad, generator=gen, device="cuda")
                < 0.5).to(torch.uint8)
    if mode == "sparse_final_live":
        rf[HUB + 2] = 0
    sent = None if mode == "dense" else sent
    got = kind == "sum" and sent is not None and mode != "sparse_half"
    final = mode.startswith("sparse_final")
    kw = dict(val=val, sent=sent, want_got=got,
              recv_final=rf if final else None, bits=20)
    _check_against_plain(
        spmv2u.spmv(rc, x, kind, op, **kw),
        spmv2u.spmv_reference(rc, x, kind, op, **kw), kind, got,
        spmv2u.PROCESS_OPS[op](x[rc.col.long()], val, 20), rc.row.long(),
        None if sent is None else sent[rc.col.long()].float())
    if final:
        return
    x, val, _, _ = _hub_inputs(g, kind, op, sc.nnz, 8)
    if kind == "sum":   # a push sum reads the graph's own values
        val = sc.val_f32
    kw = dict(val=val, sent=sent, want_got=got, bits=20)
    _check_against_plain(
        spmv2.spmv_push(sc, x, kind, op, **kw),
        spmv2.spmv_push_reference(sc, x, kind, op, **kw), kind, got,
        spmv2u.PROCESS_OPS[op](x[sc.row.long()], val, 20), sc.col.long(),
        None if sent is None else sent[sc.row.long()].float())


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("mode", ["dense", "sparse"])
@pytest.mark.parametrize("route", ["k1", "push"])
def test_hub_integer_weight_sums_match_float64(cuda, route, mode, seed):
    """The hub graph with integer weights 1..7: an x_add_val sum, whose
    hub row holds 2^20 mostly positive terms, through K1 and through the
    push, within 1e-5 of Σ|terms| of the float64 sum of the same float32
    terms (held against float64, not the float32 plain version, whose
    own rounding is the larger)."""
    g = _hub_graph(True)
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    x, _, sent, _ = _hub_inputs(g, "sum", "x_add_val", rc.nnz, seed)
    sent = None if mode == "dense" else sent
    got = sent is not None
    if route == "k1":
        out = spmv2u.spmv(rc, x, "sum", "x_add_val", val=rc.val_f32,
                          sent=sent, want_got=got)
    else:
        out = spmv2.spmv_push(sc, x, "sum", "x_add_val", val=sc.val_f32,
                              sent=sent, want_got=got)
    y = out[0] if got else out
    terms = spmv2u.PROCESS_OPS["x_add_val"](
        x[rc.col.long()], rc.val_f32, 0).double()
    if sent is not None:
        terms = terms * sent[rc.col.long()].double()
    row = rc.row.long()
    exact = torch.zeros(g.n_pad, dtype=torch.float64,
                        device=cuda).index_add_(0, row, terms)
    bound = torch.zeros_like(exact).index_add_(0, row, terms.abs()) * 1e-5
    assert bool(((y.double() - exact).abs() <= bound).all())


def test_k1_dense_sum_is_bitwise_repeatable(cuda):
    """No atomics in K1: two launches give the same bits, hub rows too."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    for g in (_hub_graph(), _rmat_graph(cuda, build_in_edges=False)):
        c = g.csr("dst")
        x = torch.randn(g.n_pad, generator=gen, device=cuda)
        val = torch.randn(c.nnz, generator=gen, device=cuda)
        a = spmv2u.spmv(c, x, "sum", "x_mul_val", val=val)
        b = spmv2u.spmv(c, x, "sum", "x_mul_val", val=val)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_push_equals_k1_at_a_bfs_level_of_the_hub_graph(cuda):
    """BFS level 1 from the hub sender: its 2^20 out-neighbours send their
    ids; K1 (with the visited rows final) and the push agree in min and
    max on every live row."""
    g = _hub_graph()
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    front = torch.zeros(g.n_pad, dtype=torch.bool, device="cuda")
    front[sc.col[sc.rowptr[HUB + 1]:sc.rowptr[HUB + 2]].long()] = True
    sent = front.to(torch.uint8)
    rf = (front | ~g.valid_vertex).to(torch.uint8)
    rf[HUB + 1] = 1
    live = rf == 0
    ids = torch.arange(1, g.n_pad + 1, device="cuda").float()
    for kind, fill in (("min", float("inf")), ("max", float("-inf"))):
        xs = ids.masked_fill(~front, fill)
        a = spmv2u.spmv(rc, xs, kind, "x", sent=sent, recv_final=rf)
        b = spmv2.spmv_push(sc, xs, kind, "x", sent=sent)
        assert torch.equal(a[live], b[live])
        assert float(a[HUB + 2]) == (1.0 if kind == "min" else float(HUB))


PUSH_SHARES = (1e-4, 1e-2, 0.1, 1.0)   # frontier shares of the push's sums


def _push_frontiers(g, seed, hub=False):
    """A sent mask at each of PUSH_SHARES (the hub sender in each on the
    hub graph)."""
    gen = torch.Generator(device=g.device)
    gen.manual_seed(seed)
    out = []
    for share in PUSH_SHARES:
        sent = (torch.rand(g.n_pad, generator=gen, device=g.device)
                < share).to(torch.uint8)
        if hub:
            sent[HUB + 1] = 1
        out.append(sent)
    return out


@pytest.mark.parametrize("graph", ["rmat", "hub"])
def test_push_sums_repeat_and_equal_k1(cuda, graph):
    """P6: the push's dense sum and its sparse sums, with and without the
    got count, at four frontier shares: the same bits over 4 launches,
    and K1's sweep of the graph's receiver CSR bit for bit."""
    hub = graph == "hub"
    g = _hub_graph() if hub else _weighted_graph(cuda)
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(10)
    x = torch.randn(g.n_pad, generator=gen, device=cuda)
    for sent in [None] + _push_frontiers(g, 11, hub):
        for got in ((False,) if sent is None else (False, True)):
            runs = [spmv2.spmv_push(sc, x, "sum", "x_mul_val",
                                    val=sc.val_f32, sent=sent,
                                    want_got=got) for _ in range(4)]
            runs.append(spmv2.spmv_push(sc, x, "sum", "x_mul_val",
                                        val=sc.val_f32, sent=sent,
                                        want_got=got, recv_csr=rc))
            k1 = spmv2u.spmv(rc, x, "sum", "x_mul_val", val=rc.val_f32,
                             sent=sent, want_got=got)
            torch.cuda.synchronize()
            for out in runs:
                if got:
                    assert torch.equal(out[1], k1[1])
                    out = out[0]
                y = k1[0] if got else k1
                assert torch.equal(out.view(torch.int32),
                                   y.view(torch.int32))


def test_push_mark_kernel_matches_plain(cuda):
    """The mark pass bitwise its plain version at four frontier shares,
    one launch each; a sparse sum leaves the rows it marks unreached at
    the identity with a count of 0, and counts every reached row."""
    g = _weighted_graph(cuda)
    sc = g.sender_csr("dst")
    x = torch.ones(g.n_pad, device=cuda)
    for sent in _push_frontiers(g, 12):
        before = spmv2.LAUNCHES["mark"]
        mark = spmv2.push_mark(sc.rowptr, sc.col, sent, sc.n_send)
        torch.cuda.synchronize()
        assert spmv2.LAUNCHES["mark"] == before + 1
        assert torch.equal(mark, spmv2.push_mark_reference(
            sc.rowptr, sc.col, sent, sc.n_send, sc.row))
        y, cnt = spmv2.spmv_push(sc, x, "sum", "x", sent=sent,
                                 want_got=True)
        unreached = mark.bool()
        assert bool((y[unreached] == 0).all())
        assert bool((cnt[unreached] == 0).all())
        assert bool((cnt[~unreached] > 0).all())


@pytest.mark.parametrize("scale,weight_range", [(10, 0), (14, 255),
                                                (16, 5), (20, 255)])
def test_rmat_kernels_match_plain(cuda, scale, weight_range):
    """The RMAT keys and weights kernels bitwise their plain versions, one
    launch each; the edge list drawn on the card that drawn on the CPU."""
    from graphmat_tpu_torch.ops import rmat
    nnz = (1 << scale) * 16
    args = (scale, nnz, 0.57, 0.19, 0.19, 2 ** 40 + 3)
    before = dict(rmat.LAUNCHES)
    keys = rmat.rmat_keys(*args, cuda)
    torch.cuda.synchronize()
    assert rmat.LAUNCHES["keys"] == before["keys"] + 1
    assert torch.equal(keys.cpu(), rmat.rmat_keys_reference(*args))
    val = rmat.rmat_weights(keys, 7, 1000)
    torch.cuda.synchronize()
    assert rmat.LAUNCHES["weights"] == before["weights"] + 1
    assert torch.equal(val.cpu(), rmat.rmat_weights_reference(
        keys.cpu(), 7, 1000))
    for dedup in (True, False):
        kw = dict(seed=3, dedup=dedup, weight_range=weight_range)
        got = rmat_edgelist(scale, 16, device=cuda, **kw)
        want = rmat_edgelist(scale, 16, device="cpu", **kw)
        for a, b in zip(got.astuple(), want.astuple()):
            assert torch.equal(a.cpu(), b)


def _tail_hub_pairs(device, L, k):
    """K_{Y,Z} (L + L vertices) and a k-clique S joined to all of Y: at
    h = 64 each sender's tail list holds about L ids."""
    ar = functools.partial(torch.arange, device=device)
    Y, Z, S = ar(L), L + ar(L), 2 * L + ar(k)
    i, j = torch.triu_indices(k, k, 1, device=device)
    return (torch.cat((Y.repeat_interleave(L), S.repeat_interleave(L),
                       S[i])),
            torch.cat((Z.repeat(L), Y.repeat(k), S[j])), 2 * L + k)


def _tc_pairs(cuda, case):
    """(u, v, n, h, canonical) of a TriangleCounting check on the card."""
    from graphmat_tpu_torch.io.transforms import convert_to_upper_triangular
    if case.startswith("rmat14_h"):
        e = convert_to_upper_triangular(rmat_edgelist(14, 16, seed=1,
                                                      device=cuda))
        return (e.src.long() - 1, e.dst.long() - 1, e.n,
                int(case[len("rmat14_h"):]), True)
    if case == "rmat12_all_core":
        e = convert_to_upper_triangular(rmat_edgelist(12, 16, seed=1,
                                                      device=cuda))
        return e.src.long() - 1, e.dst.long() - 1, e.n, 4096, True
    if case == "tail_hub":
        return (*_tail_hub_pairs(cuda, 2100, 6), 64, True)
    if case == "tail_hub_8192":   # tail lists of 5008 ids
        return (*_tail_hub_pairs(cuda, 5000, 8), 64, True)
    rng = np.random.default_rng(6)
    u = torch.as_tensor(rng.integers(0, 90, 700), device=cuda)
    v = torch.as_tensor(rng.integers(0, 90, 700), device=cuda)
    return u, v, 90, None, False   # "n90_w3": W = 3 words, padded to 4


@pytest.mark.parametrize("case", ["rmat14_h0", "rmat14_h64", "rmat14_h128",
                                  "rmat14_h4096", "rmat12_all_core",
                                  "tail_hub", "tail_hub_8192", "n90_w3"])
def test_triangle_kernels_match_plain(cuda, case):
    """T1 and T2 on the device prep's arguments against their plain
    versions, exactly; the count against the host route's."""
    u, v, n, h, canon = _tc_pairs(cuda, case)
    t1, *t2 = triangles._kernel_args(u, v, n, h, canon)
    t2 = t2[0] if t2 else None
    zeros = functools.partial(torch.zeros, n + 1, dtype=torch.int32,
                              device=cuda)
    before = dict(triangles.LAUNCHES)
    got = triangles.core_count(*t1, zeros())
    torch.cuda.synchronize()
    assert torch.equal(got, triangles.core_count_reference(*t1, zeros()))
    assert (triangles.LAUNCHES["core_count"] - before["core_count"]
            == (t1[0].shape[1] > 0))   # h = 0 leaves no core to count
    if case == "rmat12_all_core":   # n = h: every edge is core
        assert t2 is None
    if case == "rmat14_h0":
        assert t1[0].shape[1] == 0
    if case == "n90_w3":   # the bitmap's 3 words a row padded to 4
        assert t1[0].shape[1] == 4
    if t2 is not None:
        got = triangles.tail_count(*t2, zeros())
        torch.cuda.synchronize()
        assert torch.equal(got, triangles.tail_count_reference(*t2, zeros()))
        assert triangles.LAUNCHES["tail_count"] == before["tail_count"] + 1
    pv, total = triangles.count_triangles_bucketed(u, v, n, h=h,
                                                   assume_canonical=canon)
    pv_h, total_h = triangles.count_triangles_bucketed(
        u, v, n, h=h, assume_canonical=canon, impl="host")
    assert total == total_h and torch.equal(pv, pv_h)
    if case == "tail_hub":
        assert total == 15 * 2100 + 20
    if case == "tail_hub_8192":   # the widest class pair reaches 8192
        ladder, gk = t2[1], t2[2].long()
        assert total == 28 * 5000 + 56
        assert ladder[int(torch.maximum(gk // len(ladder),
                                        gk % len(ladder)).max())] == 8192


def _summary(bm):
    from graphmat_tpu_torch.ops.triangles import _tc_summary_host
    return torch.as_tensor(_tc_summary_host(bm))


@pytest.mark.parametrize("w4", [4, 36, 128])
def test_core_count_kernel_two_level_matches_plain(cuda, w4):
    """T1 on crafted rows (empty, sparse, a hub row of all ones, the
    row's last word only) with true summaries, all-zero summaries and
    summaries that mark some nonzero words only, exactly its plain
    version."""
    rng = np.random.default_rng(w4)
    rows, e = 300, 50_000
    bm = np.zeros((rows, w4), np.uint32)
    for r in range(rows - 1):
        bits = rng.choice(32 * w4, int(rng.integers(0, 40)), replace=False)
        np.bitwise_or.at(bm[r], bits >> 5,
                         np.uint32(1) << (bits & 31).astype(np.uint32))
    bm[3] = 0xFFFFFFFF
    bm[4, -1] = np.uint32(1 << 31)
    iu = torch.as_tensor(rng.integers(0, rows, e).astype(np.int32))
    iv = torch.as_tensor(rng.integers(0, rows, e).astype(np.int32))
    s = torch.as_tensor(rng.integers(0, 1000, e).astype(np.int32))
    sm = _summary(bm)
    bmt = torch.as_tensor(bm.view(np.int32))
    for sums in (sm, torch.zeros_like(sm),
                 sm & torch.as_tensor(rng.integers(0, 2 ** 31, sm.shape,
                                                   dtype=np.int32))):
        want = triangles.core_count_reference(
            bmt, sums, iu, iv, s, torch.zeros(1000, dtype=torch.int32))
        got = triangles.core_count(*(x.to(cuda) for x in (bmt, sums, iu, iv,
                                                         s)),
                                   torch.zeros(1000, dtype=torch.int32,
                                               device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("order", ["pair", "narrow_first", "shuffled"])
@pytest.mark.parametrize("ladder", [(1, 2, 8, 16), (8, 64, 256, 512, 4096)])
def test_tail_count_kernel_on_edge_lists_matches_plain(cuda, ladder, order):
    """T2 on lists at full class width, empty lists, hub lists wider than
    the staged cap, runs of probes on one list and widths that are not
    multiples of 4, exactly its plain version; with the probes by class
    pair, narrow pairs first (as the preps give them: 4 lanes a probe,
    then 8) and shuffled (the kernel's split falls anywhere)."""
    rng = np.random.default_rng(len(ladder))
    L = len(ladder)
    flat, starts, cls, off = [], [], [], 0
    for i in range(200):
        c = i % L
        k = (ladder[c] if i % 3 == 0 else 0 if i % 7 == 1
             else int(rng.integers(1, ladder[c] + 1)))
        row = np.full(ladder[c], 2 ** 31 - 1, np.int32)
        row[:k] = np.sort(rng.choice(3 * ladder[-1], k, replace=False))
        flat.append(row)
        starts.append(off)
        off += ladder[c]
        cls.append(c)
    cls, starts = np.asarray(cls), np.asarray(starts, np.int32)
    a = rng.integers(0, 200, 20_000)
    b = np.repeat(rng.integers(0, 200, 2_000), 10)
    gk = cls[a] * L + cls[b]
    key = {"pair": gk, "shuffled": rng.permutation(gk.size),
           "narrow_first": [triangles._tail_order(ladder, cs, cr)
                            for cs, cr in zip(cls[a], cls[b])]}[order]
    order = np.argsort(key, kind="stable")
    args = [torch.as_tensor(np.concatenate(flat)), ladder] + [
        torch.as_tensor(x[order].astype(np.int32)) for x in
        (gk, starts[a], starts[b], rng.integers(0, 500, 20_000))]
    want = triangles.tail_count_reference(
        *args, torch.zeros(500, dtype=torch.int32))
    got = triangles.tail_count(
        *(x.to(cuda) if torch.is_tensor(x) else x for x in args),
        torch.zeros(500, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_triangle_kernels_on_the_empty_graph(cuda):
    """No edge, no core edge, no probe: a count of 0, and no launch."""
    before = dict(triangles.LAUNCHES)
    e = torch.zeros(0, dtype=torch.int64, device=cuda)
    pv, total = triangles.count_triangles_bucketed(e, e, 100)
    assert total == 0 and pv.shape == (100,) and not bool(pv.any())
    z = torch.zeros(0, dtype=torch.int32, device=cuda)
    triangles.core_count(torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                         torch.zeros((1, 1), dtype=torch.int32, device=cuda),
                         z, z, z, pv)
    triangles.tail_count(z, triangles._LADDER, z, z, z, z, pv)
    torch.cuda.synchronize()
    assert triangles.LAUNCHES == before and not bool(pv.any())


@pytest.mark.parametrize("permute", [False, "degree"])
@pytest.mark.parametrize("method", ["engine", "bucketed", "auto"])
def test_triangle_counting_on_cuda_matches_cpu(cuda, method, permute):
    e = gt.load_edgelist(os.path.join(os.path.dirname(__file__), "..",
                                      "data", "2_10_upper_triangle.bin.mtx"))
    from graphmat_tpu_torch.apps import triangle_counting as tc
    want, total = tc.run_triangle_counting(
        gt.Graph(e, permute=permute, device="cpu"), method=method)
    got, total_c = tc.run_triangle_counting(
        gt.Graph(e, permute=permute, device=cuda), method=method)
    assert total_c == total == 17158
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("permute", [False, "degree"])
def test_get_neighbors_on_cuda_matches_cpu(cuda, permute):
    from graphmat_tpu_torch.apps.get_neighbors import run_get_neighbors
    from graphmat_tpu_torch.utils.generators import random_edgelist
    e = random_edgelist(3000, 6, seed=5)
    want = run_get_neighbors(gt.Graph(e, permute=permute, device="cpu"))
    got = run_get_neighbors(gt.Graph(e, permute=permute, device=cuda))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------ the sharded engine's tiles

@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("route", ["v2u", "v2"])
def test_dist_engine_on_cuda_tiles_matches_cpu_tiles(cuda, route, shape,
                                                     monkeypatch):
    """A LocalMesh of card tiles against the same mesh of CPU tiles:
    BFS exactly, 20 PageRank steps within 1e-5 of max(1, |pr|) (the
    kernels sum in another order than the CPU), the kernels launched on
    the tiles."""
    from graphmat_tpu_torch.apps import bfs as tbfs
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    monkeypatch.setenv("GRAPHMAT_KERNEL", route)
    e = rmat_edgelist(12, 16, seed=3, device="cpu")
    nt = shape[0] * shape[1]
    out = {}
    counts = spmv2.LAUNCHES if route == "v2" else spmv2u.LAUNCHES
    for dev in ("cpu", cuda):
        before = sum(counts.values())
        g = DistGraph(e, LocalMesh([dev] * nt, shape), seg_align=8)
        pr, it = tpr.run_pagerank(g, iterations=20)
        depth, parent, _ = tbfs.run_bfs(g, 1)
        torch.cuda.synchronize()
        launched = sum(counts.values()) - before
        assert (launched > 0) == (dev != "cpu")
        out[str(dev)] = (pr, it, depth, parent)
    (pr_c, it_c, d_c, p_c), (pr_g, it_g, d_g, p_g) = out.values()
    assert it_g == it_c
    np.testing.assert_array_equal(d_g, d_c)
    np.testing.assert_array_equal(p_g, p_c)
    np.testing.assert_allclose(pr_g, pr_c, rtol=1e-5, atol=1e-5)


def test_dist_compacted_cuda_tiles_equal_uncompacted(cuda):
    """K2 on compacted card tiles: PageRank and BFS bitwise the
    uncompacted tiles', one K2 launch for each K1 call."""
    from graphmat_tpu_torch.apps import bfs as tbfs
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    e = rmat_edgelist(12, 16, seed=5, device=cuda)
    mesh = LocalMesh([cuda] * 4, (2, 2))
    on = DistGraph(e, mesh, compact=True,
                   compact_kw=dict(hub=0, divert_min=1 << 30, w_div=1))
    off = DistGraph(e, mesh, compact=False)
    k1, k2 = sum(spmv2u.LAUNCHES.values()), compact.LAUNCHES["aux_gather"]
    pr_on, it_on = tpr.run_pagerank(on)
    torch.cuda.synchronize()
    k1_on = sum(spmv2u.LAUNCHES.values()) - k1
    assert compact.LAUNCHES["aux_gather"] - k2 == k1_on > 0
    pr_off, it_off = tpr.run_pagerank(off)
    assert it_on == it_off
    np.testing.assert_array_equal(pr_on, pr_off)
    for a, b in zip(tbfs.run_bfs(on, 1), tbfs.run_bfs(off, 1)):
        np.testing.assert_array_equal(a, b)


class _GenericMinPlus(tsssp.SSSPProgram):
    """SSSP with its min as a generic ⊕: the segment route."""
    reduce = gt.Monoid("generic", torch.minimum,
                       lambda dt: torch.iinfo(dt).max)


class _GenericPageRank(tpr.PageRankProgram):
    reduce = gt.Monoid("generic", torch.add, lambda dt: 0)


def _generic_runs(g):
    """Generic min-plus SSSP from vertex 1 to convergence and 10 steps of
    generic-sum PageRank on ``g``: (distances, pagerank)."""
    tsssp.init_sssp_graph(g, 1)
    engine_for(_GenericMinPlus(), g).run()
    dist = g.vp_numpy()["distance"]
    tpr.init_pagerank_graph(g)
    g.set_all_active()
    engine_for(tpr.DegreeProgram(), g).run(iterations=1)
    engine_for(_GenericPageRank(), g).run(iterations=10)
    return dist, g.vp_numpy()["pagerank"]


def test_generic_monoid_on_cuda_matches_cpu(cuda):
    """The generic ⊕ on the card: the segment reduce (gcd exactly, a sum
    within 1e-5) and the Engine's segment route on one device and on 2x2
    LocalMesh tiles of the card, against the CPU (min exactly, PageRank
    within 1e-5 of max(1, |pr|)) and against K1's routes on the card."""
    from graphmat_tpu_torch.ops.segment import segment_reduce
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    rng = np.random.default_rng(11)
    ids = torch.as_tensor(np.sort(rng.integers(0, 5000, 200_000)))
    vals = torch.as_tensor(rng.integers(1, 1000, 200_000) * 6)
    x = torch.as_tensor(rng.standard_normal(200_000).astype(np.float32))
    for m, data, exact in ((gt.Monoid("generic", torch.gcd, lambda dt: 0),
                            vals, True),
                           (gt.Monoid("generic", torch.add, lambda dt: 0),
                            x, False)):
        got = segment_reduce(m, data.to(cuda), ids.to(cuda), 6000).cpu()
        want = segment_reduce(m, data, ids, 6000)
        if exact:
            assert torch.equal(got, want)
        else:
            assert ((got - want).abs() / want.abs().clamp(min=1)).max() \
                <= 1e-5
    e = rmat_edgelist(12, 16, seed=5, weight_range=20, device="cpu")
    d_h, pr_h = _generic_runs(gt.Graph(e, device="cpu"))
    d_k1, _ = tsssp.run_sssp(gt.Graph(e, device=cuda), 1)
    pr_k1, _ = tpr.run_pagerank(gt.Graph(e, device=cuda), iterations=10)
    for g in (gt.Graph(e, device=cuda),
              DistGraph(e, LocalMesh([cuda] * 4, (2, 2)))):
        d_c, pr_c = _generic_runs(g)
        np.testing.assert_array_equal(d_c, d_h)
        np.testing.assert_array_equal(d_c, d_k1)
        for ref in (pr_h, pr_k1):
            assert (abs(pr_c - ref) / np.maximum(1.0, abs(ref))).max() \
                <= 1e-5


def test_graft_entry_on_cuda(cuda):
    """``entry()``'s step on the card is one K1 dense launch, within 1e-6
    of max(1, |pr|) of its plain version and of the CPU's step; the dry
    run on 4 tiles of the card launches K1, K2, K3 and the push."""
    from graphmat_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    before = spmv2u.LAUNCHES["dense"]
    out = fn(*args)
    torch.cuda.synchronize()
    assert spmv2u.LAUNCHES["dense"] == before + 1
    fn_h, args_h = graft_entry.entry(device="cpu")
    for ref in (graft_entry.pagerank_step_reference(*args).cpu(),
                fn_h(*args_h)):
        assert ((out.cpu() - ref).abs() / ref.abs().clamp(min=1)).max() \
            <= 1e-6
    counts = (sum(spmv2u.LAUNCHES.values()), compact.LAUNCHES["aux_gather"],
              sum(spmv_vec2.LAUNCHES.values()),
              spmv2.LAUNCHES["dense"] + spmv2.LAUNCHES["sparse"])
    graft_entry.dryrun_multichip(4)
    after = (sum(spmv2u.LAUNCHES.values()), compact.LAUNCHES["aux_gather"],
             sum(spmv_vec2.LAUNCHES.values()),
             spmv2.LAUNCHES["dense"] + spmv2.LAUNCHES["sparse"])
    assert all(a > b for a, b in zip(after, counts)), (counts, after)


# ------------------------------------------- readbacks into pinned memory

def _fields(n, seed):
    """Vertex fields of each dtype a program keeps, in original order."""
    gen = torch.Generator().manual_seed(seed)
    return {"i": torch.randint(-2 ** 31, 2 ** 31 - 1, (n,),
                               dtype=torch.int32, generator=gen),
            "f": torch.randn(n, generator=gen),
            "d": torch.randn(n, dtype=torch.float64, generator=gen),
            "b": torch.rand(n, generator=gen) < 0.5,
            "k": torch.randn(n, 20, generator=gen)}


def _bits(a):
    return np.ascontiguousarray(a).tobytes()


def _check_readbacks(g, monkeypatch):
    """``vp_numpy`` and ``active_numpy`` of a card graph: each field
    bitwise what was set, in original order, with its dtype and shape, in
    a writable array; an array held across a second readback, after the
    state changed on the card, keeps its values; and once the earlier
    results are dropped, a third readback of the same shapes takes every
    destination from the pinned pool and page-locks no new block."""
    from graphmat_tpu_torch.utils import timing
    want, mask = _fields(g.n, 9), _fields(g.n, 11)["b"]
    g.init_vertexproperty(**want)
    g.set_active_mask(mask)
    first, act = g.vp_numpy(), g.active_numpy()
    assert list(first) == list(want)
    for k, v in want.items():
        assert (first[k].dtype, first[k].shape) == (v.numpy().dtype,
                                                   tuple(v.shape))
        assert _bits(first[k]) == _bits(v.numpy()), k
        assert first[k].flags.writeable
    assert _bits(act) == _bits(mask.numpy()) and act.flags.writeable
    kept = {k: a.copy() for k, a in first.items()}
    other = _fields(g.n, 10)
    g.init_vertexproperty(**other)
    g.set_active_mask(~mask)
    second, act2 = g.vp_numpy(), g.active_numpy()
    for k, v in other.items():
        assert _bits(second[k]) == _bits(v.numpy()), k
        assert _bits(first[k]) == _bits(kept[k]), k
        assert not np.shares_memory(first[k], second[k])
        first[k][...] = 0
    assert _bits(act) == _bits(mask.numpy())
    assert _bits(act2) == _bits((~mask).numpy())
    assert _bits(g.vp_numpy()["f"]) == _bits(other["f"].numpy())
    del first, second, act, act2
    monkeypatch.setenv("GRAPHMAT_TPU_TIMING", "1")
    timing.reset()
    try:
        third, act3 = g.vp_numpy(), g.active_numpy()
        c = timing.snapshot()["counters"]
    finally:
        monkeypatch.delenv("GRAPHMAT_TPU_TIMING")
        timing.reset()
    for k, v in other.items():
        assert _bits(third[k]) == _bits(v.numpy()), k
    assert _bits(act3) == _bits((~mask).numpy())
    assert c["copy.pinned.n"] == c["copy.dtoh.n"] > 0
    assert c["copy.pinned.new"] == 0


@pytest.mark.parametrize("permute", [False, "degree"])
def test_readbacks_land_in_reused_pinned_blocks(cuda, permute, monkeypatch):
    g = gt.Graph(rmat_edgelist(12, 8, seed=5, device="cpu"), device=cuda,
                 permute=permute)
    assert (g.perm is None) == (permute is False)
    _check_readbacks(g, monkeypatch)


# ------------------------------------------------- four cards, one process

@pytest.fixture
def four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    return [torch.device("cuda", i) for i in range(4)]


# each kernel wrapper's check above, given a card that is not current
OTHER_CARD = {
    "k1": lambda d: test_spmv_kernel_matches_plain(d, "sum", "x_mul_val",
                                                   "sparse_got"),
    "k1_min": lambda d: test_spmv_kernel_matches_plain(d, "min", "x_add_val",
                                                       "sparse"),
    "k2": lambda d: test_aux_gather_kernel_matches_plain(d, True, 300_001),
    "k3": lambda d: test_spmv_vec2_kernel_matches_plain(d, "sgd", 20),
    "k3_sparse": lambda d: test_spmv_vec_sparse_kernel_matches_plain(
        d, "sgd", 20, 0.1),
    "push": lambda d: test_push_kernel_matches_plain(d, "max", "x_add_val",
                                                     1e-2),
    "push_mark": test_push_mark_kernel_matches_plain,
    "rmat": lambda d: test_rmat_kernels_match_plain(d, 14, 255),
    "rand_r": lambda d: test_rand_r_uniform_kernel_matches_numpy(
        d, torch.float32, 20, 1),
    "triangles": lambda d: test_triangle_kernels_match_plain(d, "rmat14_h64"),
}


@pytest.mark.parametrize("kernel", sorted(OTHER_CARD))
def test_kernel_launches_on_a_card_that_is_not_current(four_cards, kernel):
    """Each wrapper called with cuda:1 tensors while cuda:0 is current
    equals its plain twin: the launch runs on the tensors' card and
    leaves the thread's card as it was."""
    torch.cuda.set_device(0)
    OTHER_CARD[kernel](four_cards[1])
    torch.cuda.synchronize(four_cards[1])
    assert torch.cuda.current_device() == 0


def test_pagerank_over_four_cards_matches_one_card(four_cards):
    """PageRank on a 2x2 LocalMesh over cuda:0-3 at RMAT-20 against the
    one-card Graph: each stops no earlier than the float64 run allows
    (steps compared through it, ROADMAP H1); run for the same steps, the
    two within 1e-5 of max(1, |pr|); every tile's K1 on its own card."""
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    e = rmat_edgelist(20, 16, seed=3, device="cpu")
    k0 = first_f64_stop(e)
    one = gt.Graph(e, device=four_cards[0])
    mesh = DistGraph(e, LocalMesh(four_cards, (2, 2)))
    assert [c.rowptr.device for c in mesh.csrs("dst")] == four_cards
    _, it_1 = tpr.run_pagerank(one)
    before = spmv2u.LAUNCHES["dense"]
    _, it_4 = tpr.run_pagerank(mesh)
    assert spmv2u.LAUNCHES["dense"] - before == 4 * it_4
    for it in (it_1, it_4):
        assert k0 <= it <= k0 + 40
    k = max(it_1, it_4)
    pr_1, _ = tpr.run_pagerank(one, iterations=k)
    pr_4, _ = tpr.run_pagerank(mesh, iterations=k)
    assert (abs(pr_4 - pr_1) / np.maximum(1.0, abs(pr_1))).max() <= 1e-5


@pytest.mark.parametrize("permute", [False, "degree"])
def test_mesh_readbacks_land_in_reused_pinned_blocks(four_cards, permute,
                                                     monkeypatch):
    """``DistGraph``'s readbacks on a 2x2 LocalMesh over cuda:0-3, as
    ``test_readbacks_land_in_reused_pinned_blocks`` checks ``Graph``'s."""
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    e = rmat_edgelist(12, 8, seed=5, device="cpu")
    g = DistGraph(e, LocalMesh(four_cards, (2, 2)), seg_align=8,
                  permute=permute)
    assert (g.perm is None) == (permute is False)
    _check_readbacks(g, monkeypatch)
