"""P6: the push's sums (``GRAPHMAT_KERNEL=v2``) in a fixed order.

A push sum is K1's over the direction's receiver CSR, after the push's
mark pass on a sparse sweep, so on the CPU its plain version equals K1's
plain version bit for bit, and PageRank on the push route equals K1's:
the same vector and the same number of steps to convergence, on one
device and on 2x2 CPU tiles.  Against the JAX XLA Engine the PageRank
vector is held within 1e-6 of max(1, |pr|) after 1 and 5 steps (float32
sums in another order).  Min and max are the push kernel's own, and
exact.
"""

import functools

import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import pagerank as jpr

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import pagerank as tpr
from graphmat_tpu_torch.ops import spmv2 as push
from graphmat_tpu_torch.ops.spmv2u import (IDENTITY, PROCESS_OPS,
                                           spmv_reference)
from graphmat_tpu_torch.parallel.dist_graph import DistGraph
from graphmat_tpu_torch.parallel.mesh import LocalMesh
from graphmat_tpu_torch.utils.generators import rmat_edgelist

N, E = 1500, 12000
PR_RTOL = 1e-6


@functools.lru_cache(maxsize=None)
def hub_graph(both=False):
    """A third of the edges leave 20 hub senders and a tenth enter one hub
    receiver; normal edge values; the receiver=dst direction (and the
    sender-major index built from it, or with ``both`` the src
    direction)."""
    rng = np.random.default_rng(21)
    s = rng.integers(0, N, E)
    r = rng.integers(0, N, E)
    s[: E // 3] = rng.integers(0, 20, E // 3)
    r[-E // 10:] = 7
    v = rng.standard_normal(E).astype(np.float32)
    return gt.Graph(gt.edgelist_from_arrays(s + 1, r + 1, v, m=N, n=N),
                    build_in_edges=both, compact=False, device="cpu")


def frontiers(n, seed=3):
    rng = np.random.default_rng(seed)
    out = [None]
    for share in (0.001, 0.05, 0.5, 1.0):
        sent = torch.from_numpy(rng.random(n) < share).to(torch.uint8)
        sent[0] = 1   # a hub sender
        out.append(sent)
    return out


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("both", [False, True])
@pytest.mark.parametrize("op", ["x", "x_mul_val", "x_add_val"])
def test_plain_push_sums_equal_k1_bitwise_and_repeat(op, both):
    g = hub_graph(both)
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        g.n_pad).astype(np.float32))
    val = sc.val_f32 if op != "x" else None
    for sent in frontiers(g.n_pad):
        for got in ((False,) if sent is None else (False, True)):
            k1 = spmv_reference(rc, x, "sum", op,
                                val=rc.val_f32 if op != "x" else None,
                                sent=sent, want_got=got)
            runs = [push.spmv_push(sc, x, "sum", op, val=val, sent=sent,
                                   want_got=got) for _ in range(2)]
            runs.append(push.spmv_push_reference(sc, x, "sum", op, val=val,
                                                 sent=sent, want_got=got))
            runs.append(push.spmv_push(sc, x, "sum", op, val=val, sent=sent,
                                       want_got=got, recv_csr=rc))
            for out in runs:
                for a, b in zip(out if got else (out,),
                                k1 if got else (k1,)):
                    assert torch.equal(bits(a), bits(b))


def test_push_sum_honours_recv_final_as_k1():
    """A program's finality mask ORs into the mark: K1's rows with the
    same mask, bit for bit."""
    g = hub_graph()
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(g.n_pad).astype(np.float32))
    rf = torch.from_numpy(rng.random(g.n_pad) < 0.3).to(torch.uint8)
    for sent in frontiers(g.n_pad)[1:]:
        a = push.spmv_push(sc, x, "sum", "x", sent=sent, want_got=True,
                           recv_final=rf)
        b = spmv_reference(rc, x, "sum", "x", sent=sent, want_got=True,
                           recv_final=rf)
        assert torch.equal(bits(a[0]), bits(b[0]))
        assert torch.equal(a[1], b[1])


def test_mark_pass_plain_version():
    g = hub_graph()
    sc = g.sender_csr("dst")
    for sent in frontiers(g.n_pad)[1:]:
        mark = push.push_mark(sc.rowptr, sc.col, sent, sc.n_send)
        reached = torch.zeros(sc.n_send, dtype=torch.bool)
        for s in torch.nonzero(sent).flatten().tolist():
            reached[sc.col[sc.rowptr[s]:sc.rowptr[s + 1]].long()] = True
        assert torch.equal(mark, (~reached).to(torch.uint8))


def test_push_sum_arguments():
    g = hub_graph()
    sc = g.sender_csr("dst")
    x = torch.zeros(g.n_pad)
    with pytest.raises(ValueError, match="val=sender_csr.val_f32"):
        push.spmv_push(sc, x, "sum", "x_mul_val", val=sc.val_f32.clone())
    with pytest.raises(ValueError, match="sparse modes"):
        push.spmv_push(sc, x, "sum", "x",
                       recv_final=torch.zeros(g.n_pad, dtype=torch.uint8))
    with pytest.raises(ValueError, match="sums only"):
        push.spmv_push(sc, x, "min", "x", recv_csr=g.csr("dst"))
    other = gt.Graph(gt.edgelist_from_arrays([1], [2], m=N, n=N),
                     device="cpu")
    with pytest.raises(ValueError, match="recv_csr"):
        push.spmv_push(sc, x, "sum", "x", recv_csr=other.csr("dst"))
    with pytest.raises(ValueError, match="spmv_push"):
        push.spmv_push_csr(sc.rowptr, sc.col, x, sc.n_send, "sum", "x")


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("op", ["x", "x_add_val"])
def test_push_minmax_unchanged(kind, op):
    """Min and max still run the push's own plain version: a
    ``scatter_reduce_`` over the sender-major edges, equal to K1's."""
    g = hub_graph()
    rc, sc = g.csr("dst"), g.sender_csr("dst")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        g.n_pad).astype(np.float32))
    for sent in frontiers(g.n_pad):
        y = push.spmv_push(sc, x, kind, op, val=sc.val_f32, sent=sent)
        src, col = sc.row.long(), sc.col.long()
        u = PROCESS_OPS[op](x[src], sc.val_f32)
        if sent is not None:
            ok = sent[src].bool()
            u, col = u[ok], col[ok]
        want = torch.full((g.n_pad,), IDENTITY[kind]).scatter_reduce_(
            0, col, u, "amin" if kind == "min" else "amax",
            include_self=False)
        assert torch.equal(y, want)
        assert torch.equal(y, spmv_reference(rc, x, kind, op,
                                             val=rc.val_f32, sent=sent))


def rmat(scale=10):
    e = rmat_edgelist(scale, 16, seed=5, device="cpu")
    return gt.EdgeList(e.m, e.n, e.src.numpy(), e.dst.numpy(),
                       e.val.numpy())


def _pagerank(graph_fn, route, monkeypatch, **kw):
    monkeypatch.setenv("GRAPHMAT_KERNEL", route)
    return tpr.run_pagerank(graph_fn(), **kw)


@pytest.mark.parametrize("permute", [False, "degree"])
def test_push_pagerank_equals_k1_and_jax(permute, monkeypatch):
    e = rmat()
    for steps in (1, 5):
        pr_p, it_p = _pagerank(lambda: gt.Graph(e, permute=permute,
                                                device="cpu"),
                               "v2", monkeypatch, iterations=steps)
        pr_k, _ = _pagerank(lambda: gt.Graph(e, permute=permute,
                                             device="cpu"),
                            "v2u", monkeypatch, iterations=steps)
        assert it_p == steps
        np.testing.assert_array_equal(pr_p.view(np.int32),
                                      pr_k.view(np.int32))
        pr_j = np.asarray(jpr.run_pagerank(gj.Graph(e, permute=permute),
                                           iterations=steps)[0])
        err = np.abs(pr_p - pr_j) / np.maximum(1.0, np.abs(pr_j))
        assert err.max() <= PR_RTOL


@pytest.mark.parametrize("mesh", [None, (2, 2)])
def test_push_pagerank_converges_in_k1_steps(mesh, monkeypatch):
    """Run to convergence, the push takes K1's count of steps and gives
    K1's vector bit for bit, on one device and on 2x2 CPU tiles."""
    e = rmat()
    if mesh is None:
        make = lambda: gt.Graph(e, permute="degree", device="cpu")  # noqa
    else:
        make = lambda: DistGraph(e, LocalMesh(["cpu"] * 4, mesh))  # noqa
    pr_k, it_k = _pagerank(make, "v2u", monkeypatch)
    pr_p, it_p = _pagerank(make, "v2", monkeypatch)
    assert it_p == it_k < 200
    np.testing.assert_array_equal(pr_p.view(np.int32), pr_k.view(np.int32))


def test_push_sum_on_a_compacted_receiver_csr(monkeypatch):
    """A push sum runs K1's route over the Engine's receiver CSR, K2's
    extension included where that CSR is compacted: the same bits as the
    uncompacted graph on both routes."""
    e = rmat()
    kw = dict(wr=256, hub=16, divert_min=40, bpsb=2, w_div=1)
    on = gt.Graph(e, compact=True, compact_kw=kw, device="cpu")
    assert on.csr("dst").src_of_pos is not None
    off = gt.Graph(e, compact=False, device="cpu")
    prs = [_pagerank(lambda: g, route, monkeypatch, iterations=5)[0]
           for g in (on, off) for route in ("v2", "v2u")]
    for pr in prs[1:]:
        np.testing.assert_array_equal(pr.view(np.int32),
                                      prs[0].view(np.int32))
