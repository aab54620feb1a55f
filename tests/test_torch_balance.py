"""The work splits of the SpMV kernels (K1's row groups and hub chunks,
``ops/spmv2u.py: k1_plan``, which K3 walks too, a row or a chunk a warp;
the push kernel's chunks of sender tiles, ``ops/spmv2.py: push_plan``),
and the plain versions against the JAX package's XLA path on a star
graph, whose hub sender and hub receiver each hold more than one chunk of
edges.

Each plan must cover every edge exactly once, in order, give no warp more
than ``CHUNK_EDGES`` edges and put every row or sender in one group: on a
star graph, on RMAT-10 with and without the degree permutation, on a
graph with empty rows and rows at each group's length limit (C and C + 1
among them), and on a small draw of the benchmark's MovieLens law, whose
most rated films span up to three chunks.

Tolerances: BFS depths and parents exact; PageRank within 1e-6 of max(1,
|pr|) (float32 sums in other orders).
"""

import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import bfs as jbfs
from graphmat_tpu.apps import pagerank as jpr

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import bfs, pagerank
from graphmat_tpu_torch.ops import spmv2, spmv2u
from graphmat_tpu_torch.utils.generators import rmat_edgelist
from perfbench.gen import ratings

C = spmv2u.CHUNK_EDGES
STAR_N = 2600   # the hub's in- and out-degree, 2599, span three chunks


def star_edges(n=STAR_N, seed=0):
    """Vertex 1 sends to every other vertex and hears from every other
    vertex, plus a sprinkle of random edges (1-based)."""
    rng = np.random.default_rng(seed)
    leaves = np.arange(2, n + 1)
    s = np.concatenate([np.ones(n - 1, np.int64), leaves,
                        rng.integers(2, n + 1, 300)])
    d = np.concatenate([leaves, np.ones(n - 1, np.int64),
                        rng.integers(2, n + 1, 300)])
    keep = s != d
    s, d = s[keep], d[keep]
    key = np.unique(s * (n + 1) + d)
    s, d = key // (n + 1), key % (n + 1)
    return gt.edgelist_from_arrays(s, d, np.ones(len(s), np.float32), m=n,
                                   n=n)


def limit_edges(seed=1):
    """Rows whose lengths sit on each group's limit and one past it (16,
    17, 32, 33, 64, 65, C, C + 1, 2C + 1), among many empty rows."""
    rng = np.random.default_rng(seed)
    lengths = [16, 17, 32, 33, 64, 65, C, C + 1, 2 * C + 1]
    n = 4 * C
    s, d = [], []
    for i, ln in enumerate(lengths):
        recv = 3 * C + 7 * i + 1
        senders = rng.choice(3 * C, ln, replace=False) + 1
        s.append(senders)
        d.append(np.full(ln, recv))
        s.append(np.full(ln, recv))         # the same length as a sender
        d.append(senders)
    s, d = np.concatenate(s), np.concatenate(d)
    return gt.edgelist_from_arrays(s, d, np.ones(len(s), np.float32), m=n,
                                   n=n)


def rating_edges(users=6000, items=600, count=400_000, seed=7):
    """A rating graph drawn by the benchmark's generator with the laws of
    ``movielens25m-k20`` at a small size (1-based, user -> film): 130
    films above C ratings, 19 above 2C, the most rated 2342."""
    cfg = {"users": users, "items": items, "ratings": count,
           "assumed": {"user_floor": 20, "user_top": items,
                       "film_q": 263.84, "film_exponent": 2.7052}}
    r = ratings.make(cfg, seed, "cpu")
    return gt.edgelist_from_arrays(r["src"].numpy() + 1, r["dst"].numpy() + 1,
                                   r["val"].numpy(), m=r["n"], n=r["n"])


GRAPHS = {
    "star": lambda: gt.Graph(star_edges(), device="cpu", compact=False),
    "rmat10": lambda: gt.Graph(rmat_edgelist(10, 16, seed=2, device="cpu"),
                               device="cpu", compact=False),
    "rmat10_degree": lambda: gt.Graph(
        rmat_edgelist(10, 16, seed=2, device="cpu"), device="cpu",
        compact=False, permute="degree"),
    "limits": lambda: gt.Graph(limit_edges(), device="cpu", compact=False),
    "ratings": lambda: gt.Graph(rating_edges(), device="cpu", compact=False),
}


def edge_ranges(starts, ends):
    """The concatenation of the ranges [starts[i], ends[i])."""
    lens = (ends - starts).clamp(min=0)
    first = torch.cumsum(lens, 0) - lens
    i = torch.repeat_interleave(torch.arange(lens.numel()), lens)
    return starts[i] + torch.arange(int(lens.sum())) - first[i]


def check_k1_plan(rowptr, plan):
    rp = rowptr.long()
    n_rows, nnz = rp.numel() - 1, int(rp[-1])
    lens = rp.diff()
    rows, long_rows = plan.rows.long(), plan.long_rows.long()
    # every row in exactly one group
    assert torch.equal(torch.sort(torch.cat([rows, long_rows]))[0],
                       torch.arange(n_rows))
    # each width's rows fit it, and a warp of them holds at most C edges
    lo = 0
    for w, (width, count) in enumerate(zip(spmv2u.WIDTHS, plan.counts)):
        seg = lens[rows[lo:lo + count]]
        floor = spmv2u.MAX_LEN[w - 1] if w else -1
        assert bool(((seg > floor) & (seg <= spmv2u.MAX_LEN[w])).all())
        per_warp = 32 // width
        pad = torch.zeros((-count) % per_warp, dtype=seg.dtype)
        warps = torch.cat([seg, pad]).view(-1, per_warp).sum(1)
        assert bool((warps <= C).all())
        lo += count
    assert lo == rows.numel()
    # hub rows: chunks of at most C edges that cover the row in order
    assert bool((lens[long_rows] > C).all())
    first = plan.long_first.long()
    assert int(first[0]) == 0 and bool((first.diff() > 0).all())
    assert first[-1] == plan.chunk_row.numel()
    h = torch.repeat_interleave(torch.arange(long_rows.numel()),
                                first.diff())
    assert torch.equal(plan.chunk_row.long(), long_rows[h])
    c_start = plan.chunk_start.long()
    c_end = torch.minimum(c_start + C, rp[long_rows[h] + 1])
    assert bool((c_end > c_start).all())
    for r in long_rows.tolist():
        mine = plan.chunk_row.long() == r
        assert torch.equal(edge_ranges(c_start[mine], c_end[mine]),
                           torch.arange(int(rp[r]), int(rp[r + 1])))
    # every edge once: the short rows' and the chunks'
    covered = torch.cat([edge_ranges(rp[rows], rp[rows + 1]),
                         edge_ranges(c_start, c_end)])
    assert torch.equal(torch.sort(covered)[0], torch.arange(nnz))


def check_k3_split(rowptr, plan):
    """K3's walk (``csrc/spmv_vec2.cu: k3_lanes``): item i is chunk i of
    K1's plan below n_chunks, then row i - n_chunks, skipped when it holds
    more than C edges; a chunk stops at C edges or its row's end.  Every
    row of at most C edges is an item (an empty row too, so that its 0 is
    written), a longer row is the plan's ``long_rows`` (its chunks' row
    and the combine's), no item holds more than C edges, and a row's
    items hold its edges once, in order."""
    rp = rowptr.long()
    n_rows, nnz = rp.numel() - 1, int(rp[-1])
    lens = rp.diff()
    chunk_row = plan.chunk_row.long()
    start = plan.chunk_start.long()
    end = torch.minimum(start + C, rp[chunk_row + 1])
    short = torch.nonzero(lens <= C).flatten()
    long_rows = torch.nonzero(lens > C).flatten()
    assert torch.equal(torch.sort(plan.long_rows.long())[0], long_rows)
    assert torch.equal(torch.unique(chunk_row), long_rows)
    row = torch.cat([chunk_row, short])
    lo = torch.cat([start, rp[short]])
    hi = torch.cat([end, rp[short + 1]])
    assert bool(((hi - lo) <= C).all())
    assert torch.equal(torch.unique(row), torch.arange(n_rows))
    order = torch.argsort(row * (nnz + 1) + lo)
    assert torch.equal(edge_ranges(lo[order], hi[order]), torch.arange(nnz))
    # the combine sums a row's chunks in chunk order, which is edge order
    assert bool((start.diff()[chunk_row.diff() == 0] == C).all())


def push_chunks(rowptr, plan):
    """(tile, first edge, end) of every chunk, in the kernel's warp order:
    chunk 0 of each tile, then the plan's further chunks."""
    rp = rowptr.long()
    n_send = rp.numel() - 1
    n_tiles = (n_send + spmv2.TILE - 1) // spmv2.TILE
    tile = torch.cat([torch.arange(n_tiles), plan.extra_tile.long()])
    k = torch.cat([torch.zeros(n_tiles, dtype=torch.int64),
                   plan.extra_k.long()])
    lo = rp[tile * spmv2.TILE] + k * C
    hi = torch.minimum(lo + C, rp[torch.clamp((tile + 1) * spmv2.TILE,
                                              max=n_send)])
    return tile, lo, hi


def check_push_plan(rowptr, plan):
    rp = rowptr.long()
    n_send, nnz = rp.numel() - 1, int(rp[-1])
    tile, lo, hi = push_chunks(rowptr, plan)
    n_tiles = (n_send + spmv2.TILE - 1) // spmv2.TILE
    # a further chunk holds an edge; none holds more than C
    assert bool((hi[n_tiles:] > lo[n_tiles:]).all())
    assert bool(((hi - lo) <= C).all())
    # the chunks cover every edge once, a tile's chunks its edges in order
    order = torch.argsort(tile * (nnz + 1) + lo)
    assert torch.equal(edge_ranges(lo[order], hi[order]), torch.arange(nnz))
    sender = torch.repeat_interleave(torch.arange(n_send), rp.diff())
    chunk_of_edge = torch.repeat_interleave(order, (hi - lo).clamp(min=0)[
        order])
    assert torch.equal(tile[chunk_of_edge], sender // spmv2.TILE)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_plans_cover_every_edge_once(name):
    g = GRAPHS[name]()
    for recv in ("dst", "src"):
        rowptr = g.csr(recv).rowptr
        k1 = spmv2u.k1_plan(rowptr)
        check_k1_plan(rowptr, k1)
        check_k3_split(rowptr, k1)
        check_push_plan(rowptr, spmv2.push_plan(rowptr))
    if name in ("star", "limits", "ratings"):   # hub rows exist
        plan = spmv2u.k1_plan(g.csr("dst").rowptr)
        assert plan.long_rows.numel() > 0
        assert spmv2.push_plan(g.csr("src").rowptr).extra_tile.numel() > 0
    if name == "ratings":   # films of up to three chunks; users of none
        lens = g.csr("dst").rowptr.diff()
        assert int((lens > C).sum()) == 130 and int(lens.max()) == 2342
        assert spmv2u.k1_plan(g.csr("src").rowptr).long_rows.numel() == 0


def test_plans_are_kept_on_the_csr():
    g = GRAPHS["star"]()
    c = g.csr("dst")
    assert spmv2u.plan_for(c) is spmv2u.plan_for(c)
    assert spmv2.plan_for(c) is spmv2.plan_for(c)
    assert spmv2u.plan_for(c) is not spmv2.plan_for(c)


def test_plans_of_an_empty_graph():
    e = gt.edgelist_from_arrays(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                np.zeros(0, np.float32), m=40, n=40)
    rowptr = gt.Graph(e, device="cpu").csr("dst").rowptr
    k1 = spmv2u.k1_plan(rowptr)
    check_k1_plan(rowptr, k1)
    assert k1.counts[0] == rowptr.numel() - 1
    assert spmv2.push_plan(rowptr).extra_tile.numel() == 0


@pytest.mark.parametrize("route", ["v2u", "v2"])
def test_star_graph_matches_jax_xla(route, monkeypatch):
    """BFS from the hub and from a leaf, and PageRank, on the port's plain
    versions (both kernel routes) against the JAX XLA Engine."""
    monkeypatch.setenv("GRAPHMAT_KERNEL", route)
    e = star_edges()
    for src in (1, 7):
        want = jbfs.run_bfs(gj.Graph(e, build_in_edges=False), src)
        got = bfs.run_bfs(gt.Graph(e, build_in_edges=False, device="cpu"),
                          src)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pr_j, it_j = jpr.run_pagerank(gj.Graph(e), iterations=10)
    pr_t, it_t = pagerank.run_pagerank(gt.Graph(e, device="cpu"),
                                       iterations=10)
    assert it_t == it_j
    assert (np.abs(pr_t - pr_j) / np.maximum(1.0, np.abs(pr_j))).max() <= 1e-6
