"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and ``nvcc``, and skips without them.
On a machine with a GPU (and without JAX, which ``tests/conftest.py``
imports), run::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: min, max, the got count and the gather are bitwise; a sum
is within 1e-5 of the row's Σ|terms| (the kernel's shuffle tree sums in
another order than ``scatter_reduce_``), and K3's ``lda_init`` within
1e-6 (its terms are the same rand_r draws); PageRank on the card is
within 1e-5 of max(1, |pr|) of PageRank on the CPU; SGD and LDA on the
card within 1e-6 (RMSE, factors) or 1e-5 relative (LDA's N, global_N and
log-likelihood, and factors after K = 40 steps) of the CPU port.  The
frontier apps on the card equal their CPU runs exactly (depths, parents,
distances, labels, orders), on both kernel routes; incremental PageRank
within 1e-5 of max(1, |pr|) (the push route sums by atomics).
"""

import functools
import os

import numpy as np
import pytest
import torch

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import pagerank as tpr
from graphmat_tpu_torch.ops import compact, spmv2, spmv2u, spmv_vec, spmv_vec2
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_aux_gather_kernel_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    x = (torch.rand(100_000, generator=gen, device=cuda) * 200).to(dtype)
    src = torch.randint(0, x.numel(), (300_001,), generator=gen,
                        device=cuda, dtype=torch.int32)
    out = torch.empty(src.numel(), dtype=dtype, device=cuda)
    before = compact.LAUNCHES["aux_gather"]
    compact.aux_gather(x, src, out)
    torch.cuda.synchronize()
    assert compact.LAUNCHES["aux_gather"] == before + 1
    assert torch.equal(out, compact.aux_gather_reference(x, src))


@pytest.mark.parametrize("compacted", [False, True])
def test_pagerank_on_cuda_matches_cpu(cuda, compacted):
    e = rmat_edgelist(11, 16, seed=4, device="cpu")
    kw = dict(permute="degree", compact=compacted,
              compact_kw=dict(wr=256, hub=16, divert_min=40, bpsb=2,
                              w_div=1) if compacted else None)
    pr_c, it_c = tpr.run_pagerank(gt.Graph(e, device=cuda, **kw))
    pr_h, it_h = tpr.run_pagerank(gt.Graph(e, device="cpu", **kw))
    assert it_c == it_h
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


def _check_k3(csr, op, k, device, init_rtol=1e-6):
    x, vp, extra = _k3_inputs(op, k, csr.n_send, device)
    before = spmv_vec2.LAUNCHES[op]
    out = spmv_vec2.spmv_vec(csr, x, op, vp=vp, extra=extra,
                             params=K3_PARAMS)
    torch.cuda.synchronize()
    assert spmv_vec2.LAUNCHES[op] == before + 1
    ref = spmv_vec2.spmv_vec_reference(csr, x, op, vp=vp, extra=extra,
                                       params=K3_PARAMS)
    assert out.shape == ref.shape
    assert bool((out[csr.rowptr.diff() == 0] == 0).all())
    col, row = csr.col.long(), csr.row.long()
    terms = spmv_vec2.VEC_PROCESS_OPS[op](
        x[col], csr.val_f32, vp[row] if vp is not None else None, extra,
        K3_PARAMS).abs()
    rtol = init_rtol if op == "lda_init" else 1e-5
    bound = torch.zeros_like(out).index_add_(0, row, terms) * rtol
    assert bool(((out - ref).abs() <= bound).all())
    return out


@pytest.mark.parametrize("k", [1, 20, 40])
@pytest.mark.parametrize("op", K3_OPS)
def test_spmv_vec2_kernel_matches_plain(cuda, op, k):
    _check_k3(_ratings_graph(cuda, build_in_edges=False).csr("dst"), op, k,
              cuda)


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
@pytest.mark.parametrize("k", [1, 20, 40])
@pytest.mark.parametrize("op", K3_OPS)
def test_spmv_vec_sparse_kernel_matches_plain(cuda, op, k, share):
    """The sparse mode against its plain version: the count exactly, a
    row without a sent edge exactly 0, sums within 1e-5 of the row's
    Σ|terms| over sent edges (1e-6 for lda_init); with every sender sent,
    the dense mode's bits."""
    csr = _ratings_graph(cuda, build_in_edges=False).csr("dst")
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
    ref, got_ref = spmv_vec.spmv_vec_sparse_reference(csr, x, op, sent, **kw)
    assert torch.equal(got, got_ref)
    assert bool((out[got == 0] == 0).all())
    col, row = csr.col.long(), csr.row.long()
    vpe = vp[row] if vp is not None else None
    terms = spmv_vec2.VEC_PROCESS_OPS[op](x[col], csr.val_f32, vpe, extra,
                                          K3_PARAMS).abs()
    if op in ("sgd", "sgd_sqerr"):
        # the K-term dot <x, vp_r> is summed in other orders too: a term
        # moves by its sensitivity to the dot times K units of Σ|x vp|,
        # beyond 1e-5 of the term where val - <x, vp_r> nearly cancels
        dot = (x[col] * vpe).abs().sum(1, keepdim=True)
        err = (csr.val_f32 - (x[col] * vpe).sum(1)).abs()[:, None]
        terms += dot * (x[col].abs() if op == "sgd" else 2 * err)
    terms = terms * sent[col][:, None]
    rtol = 1e-6 if op == "lda_init" else 1e-5
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


@pytest.mark.parametrize("share", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kind,op", [("min", "x_add_val"), ("sum", "x"),
                                     ("min", "key_add_val")])
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
@pytest.mark.parametrize("op", ["x", "x_mul_val", "x_add_val"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_push_kernel_matches_plain(cuda, kind, op, frontier):
    g = _rmat_graph(cuda, build_in_edges=False)
    sc = g.sender_csr("dst")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    x = torch.randn(g.n_pad, generator=gen, device=cuda)
    val = torch.randn(sc.nnz, generator=gen, device=cuda)
    sent = None if frontier is None else (
        torch.rand(g.n_pad, generator=gen, device=cuda) < frontier).to(
            torch.uint8)
    got = kind == "sum" and sent is not None
    mode = "dense" if sent is None else ("sparse_got" if got else "sparse")
    before = spmv2.LAUNCHES[mode]
    out = spmv2.spmv_push(sc, x, kind, op, val=val, sent=sent,
                          want_got=got)
    torch.cuda.synchronize()
    assert spmv2.LAUNCHES[mode] == before + 1
    ref = spmv2.spmv_push_reference(sc, x, kind, op, val=val, sent=sent,
                                    want_got=got)
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
    before = (sum(spmv2u.LAUNCHES.values()), sum(spmv2.LAUNCHES.values()))
    on_card = _app_runs(cuda)
    after = (sum(spmv2u.LAUNCHES.values()), sum(spmv2.LAUNCHES.values()))
    launched = [a - b for a, b in zip(after, before)]
    assert launched[0 if route == "v2u" else 1] > 0
    assert launched[1 if route == "v2u" else 0] == 0
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
def _hub_graph():
    """RMAT-12 plus a sender with 2^20 out-edges (0-based id HUB + 1), a
    receiver with 2^20 in-edges (HUB + 2), receivers and senders of
    exactly 16, 17, 32, 33, 64, 65, C and C + 1 edges, and empty rows."""
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
    return gt.Graph(gt.edgelist_from_arrays(
        src, dst, np.ones(len(src), np.float32), m=n, n=n),
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


@pytest.mark.parametrize("mode", ["dense", "sparse", "sparse_final"])
@pytest.mark.parametrize("op", ["x", "x_mul_val", "x_add_val",
                                "key_add_val"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_hub_graph_kernels_match_plain(cuda, kind, op, mode):
    """K1 and the push on the hub graph, where hub rows are chunked and
    combined, hub senders spread over many warps and every lane-group
    width runs: min, max and counts bitwise, sums within 1e-5 of Σ|terms|."""
    g = _hub_graph()
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    x, val, sent, rf = _hub_inputs(g, kind, op, rc.nnz, 7)
    sent = None if mode == "dense" else sent
    got = kind == "sum" and sent is not None
    kw = dict(val=val, sent=sent, want_got=got,
              recv_final=rf if mode == "sparse_final" else None, bits=20)
    _check_against_plain(
        spmv2u.spmv(rc, x, kind, op, **kw),
        spmv2u.spmv_reference(rc, x, kind, op, **kw), kind, got,
        spmv2u.PROCESS_OPS[op](x[rc.col.long()], val, 20), rc.row.long(),
        None if sent is None else sent[rc.col.long()].float())
    if mode == "sparse_final":
        return
    x, val, _, _ = _hub_inputs(g, kind, op, sc.nnz, 8)
    kw = dict(val=val, sent=sent, want_got=got, bits=20)
    _check_against_plain(
        spmv2.spmv_push(sc, x, kind, op, **kw),
        spmv2.spmv_push_reference(sc, x, kind, op, **kw), kind, got,
        spmv2u.PROCESS_OPS[op](x[sc.row.long()], val, 20), sc.col.long(),
        None if sent is None else sent[sc.row.long()].float())


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
