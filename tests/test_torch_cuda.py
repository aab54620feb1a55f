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
log-likelihood, and factors after K = 40 steps) of the CPU port.
"""

import os

import numpy as np
import pytest
import torch

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import pagerank as tpr
from graphmat_tpu_torch.ops import compact, spmv2u, spmv_vec2
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
    e = rmat_edgelist(11, 16, seed=4)
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
    e = rmat_edgelist(11, 16, seed=4)
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
    lv_h, r0_h, r1_h = tsgd.run_sgd(gt.Graph(gt.load_edgelist(RATINGS7)))
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
    n_h, gn_h, ll_h = tlda.run_lda(gt.Graph(e, permute=permute), 9, 14, k=k,
                                   iterations=4)
    np.testing.assert_allclose(n_c, n_h, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gn_c, gn_h, rtol=1e-5)
    assert abs(ll_c - ll_h) <= 1e-5 * abs(ll_h)
