"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU and ``nvcc``, and skips without them.
On a machine with a GPU (and without JAX, which ``tests/conftest.py``
imports), run::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: min, max, the got count and the gather are bitwise; a sum
is within 1e-5 of the row's Σ|terms| (the kernel's shuffle tree sums in
another order than ``scatter_reduce_``); PageRank on the card is within
1e-5 of max(1, |pr|) of PageRank on the CPU.
"""

import os

import numpy as np
import pytest
import torch

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import pagerank as tpr
from graphmat_tpu_torch.ops import compact, spmv2u
from graphmat_tpu_torch.utils.generators import rmat_edgelist

pytestmark = pytest.mark.cuda

TEST_MTX = os.path.join(os.path.dirname(__file__), "..", "data",
                        "test.bin.mtx")


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
