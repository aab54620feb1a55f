"""The 2D-sharded graph's build, chunk by chunk, and the mesh's own
count of what it exchanges.

* ``DistGraph`` read in chunks of a few hundred edges equals a build
  from the whole list at once (a plain copy of that build, below), bit
  for bit: every tile's ``rowptr``, ``col``, ``row`` and ``val`` in both
  directions, ``perm`` and ``valid_vertex``; on 1x1, 2x2 and 2x4 CPU
  meshes, with ``permute`` False, "degree" and "auto", on a list with
  duplicate pairs of distinct values (so the order the build keeps
  shows);
* ``mesh.bytes`` and ``mesh.n`` equal the layout's count for one dense
  PageRank step on a 2x2 CPU mesh, 4·((R−1)+(C−1))·S·4 bytes and the
  count's all-reduce, and each collective's count its definition; the
  ``mesh.*`` spans are recorded.
"""

import numpy as np
import pytest
import torch

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps.pagerank import (DegreeProgram,
                                              PageRankProgram,
                                              init_pagerank_graph)
from graphmat_tpu_torch.core.graph import _build_csr, round_up
from graphmat_tpu_torch.parallel import dist_graph
from graphmat_tpu_torch.parallel.dist_graph import DistGraph, _tile_edges
from graphmat_tpu_torch.parallel.dist_runtime import DistEngine
from graphmat_tpu_torch.parallel.mesh import LocalMesh
from graphmat_tpu_torch.utils import timing
from graphmat_tpu_torch.utils.generators import rmat_edgelist


def _edges(scale=10):
    """R-MAT pairs with their duplicates kept, each edge its own value."""
    e = rmat_edgelist(scale, 8, seed=3, dedup=False, device="cpu")
    val = torch.arange(e.nnz, dtype=torch.float32)
    return gt.EdgeList(e.m, e.n, e.src.numpy(), e.dst.numpy(), val.numpy())


def _mesh(shape):
    return LocalMesh(["cpu"] * (shape[0] * shape[1]), shape)


def _one_shot(e, shape, permute, seg_align=8):
    """The build from the whole list at once: ``(perm, valid_vertex,
    {recv: [CSR per tile]})``."""
    R, C = shape
    n = max(e.m, e.n)
    S = max(round_up(-(-n // (R * C)), seg_align), seg_align)
    src0 = torch.as_tensor(e.src).long() - 1
    dst0 = torch.as_tensor(e.dst).long() - 1
    vals = torch.as_tensor(e.val)
    if permute == "auto":
        tile = ((dst0 // S) // C) * C + (src0 // S) % C
        cnt = torch.bincount(tile, minlength=R * C).double()
        skewed = R * C > 1 and float(cnt.max()) > 2.0 * max(
            float(cnt.mean()), 1.0)
        permute = "degree" if skewed else False
    perm = None
    if permute == "degree":
        deg = torch.bincount(src0, minlength=n)
        order = torch.argsort(-deg, stable=True)
        k = torch.arange(n)
        perm = torch.empty(n, dtype=torch.int64)
        perm[order] = (k % (R * C)) * S + k // (R * C)
        src0, dst0 = perm[src0], perm[dst0]
    tiles = {}
    for recv, (s, r) in (("dst", (src0, dst0)), ("src", (dst0, src0))):
        tile, s_loc, r_loc = _tile_edges(s, r, R, C, S)
        order = torch.argsort(tile, stable=True)
        bounds = [0] + torch.cumsum(torch.bincount(
            tile, minlength=R * C), 0).tolist()
        tiles[recv] = []
        for t in range(R * C):
            sel = order[bounds[t]:bounds[t + 1]]
            tiles[recv].append(_build_csr(s_loc[sel], r_loc[sel], vals[sel],
                                          C * S, R * S, False, None))
    vv = torch.zeros(R * C * S, dtype=torch.bool)
    if perm is None:
        vv[:n] = True
    else:
        vv[perm] = True
    return perm, [vv[t * S:(t + 1) * S] for t in range(R * C)], tiles


@pytest.mark.parametrize("permute", [False, "degree", "auto"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)])
def test_chunked_build_equals_the_one_shot_build(shape, permute,
                                                 monkeypatch):
    e = _edges()
    monkeypatch.setattr(dist_graph, "BUILD_CHUNK", 777)
    assert e.nnz > 10 * 777            # several chunks run
    g = DistGraph(e, _mesh(shape), seg_align=8, permute=permute,
                  compact=False)
    perm, vv, tiles = _one_shot(e, shape, permute)
    if perm is None:
        assert g.perm is None
    else:
        assert torch.equal(g.perm, perm)
    for a, b in zip(g.valid_vertex, vv, strict=True):
        assert torch.equal(a, b)
    for recv in ("dst", "src"):
        for ours, theirs in zip(g.csrs(recv), tiles[recv], strict=True):
            for f in ("rowptr", "col", "row", "val"):
                a, b = getattr(ours, f), getattr(theirs, f)
                assert a.dtype == b.dtype and torch.equal(a, b), (recv, f)
            assert ours.n_send == theirs.n_send


def test_auto_permutes_the_skewed_natural_layout(monkeypatch):
    """Unpermuted R-MAT ids put the hubs in few tiles: "auto" takes the
    degree permute, counted chunk by chunk."""
    monkeypatch.setattr(dist_graph, "BUILD_CHUNK", 500)
    g = DistGraph(_edges(), _mesh((2, 2)), seg_align=8)
    perm, _, _ = _one_shot(_edges(), (2, 2), "auto")
    assert perm is not None and torch.equal(g.perm, perm)


@pytest.mark.parametrize("bad", [0, (1 << 10) + 1])
def test_chunked_build_rejects_ids_outside_the_graph(bad, monkeypatch):
    monkeypatch.setattr(dist_graph, "BUILD_CHUNK", 500)
    e = _edges()
    src = e.src.copy()
    src[-3] = bad
    with pytest.raises(ValueError, match="outside"):
        DistGraph(gt.EdgeList(e.m, e.n, src, e.dst, e.val), _mesh((2, 2)),
                  seg_align=8)


def test_chunked_build_of_an_empty_list():
    e = gt.EdgeList(50, 50, np.zeros(0, np.int32), np.zeros(0, np.int32),
                    np.zeros(0, np.float32))
    g = DistGraph(e, _mesh((2, 2)), seg_align=8, permute="degree")
    assert [c.nnz for c in g.csrs("dst")] == [0] * 4
    assert sum(int(v.sum()) for v in g.valid_vertex) == 50


# ----------------------------------------------------------- the exchange

@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setenv("GRAPHMAT_TPU_TIMING", "1")
    timing.reset()
    yield timing
    monkeypatch.delenv("GRAPHMAT_TPU_TIMING")
    timing.reset()


def test_a_dense_pagerank_step_exchanges_the_layouts_count(recorder):
    R, C = 2, 2
    g = DistGraph(_edges(), _mesh((R, C)), seg_align=8, permute=False)
    init_pagerank_graph(g)
    g.set_all_active()
    DistEngine(DegreeProgram(), g).run(iterations=1)
    eng = DistEngine(PageRankProgram(), g)
    eng.run(iterations=1)          # the dense got, made once per graph
    recorder.reset()
    eng.run(iterations=1)
    snap = recorder.snapshot()
    c, S = snap["counters"], g.S
    # x gathered along 'r', y reduce-scattered along 'c' (float32), and
    # the changed count all-reduced (one int32 from each other tile)
    want = 4 * ((R - 1) + (C - 1)) * S * 4 + R * C * (R * C - 1) * 4
    assert c["mesh.bytes"] == want
    assert c["mesh.n"] == R * C * ((R - 1) + (C - 1) + (R * C - 1))
    assert c["engine.steps"] == 1
    names = {s[0] for s in snap["spans"]}
    assert {"engine.run", "engine.step", "mesh.all_gather",
            "mesh.reduce_scatter", "mesh.all_reduce"} <= names


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (1, 3)])
def test_each_collective_counts_what_the_tiles_receive(shape, recorder):
    R, C = shape
    mesh = _mesh(shape)
    T = R * C
    ts = [torch.full((12,), float(t)) for t in range(T)]
    cases = [
        (lambda: mesh.all_gather(ts, "r"), "all_gather", T * (R - 1) * 48),
        (lambda: mesh.all_gather(ts, "c"), "all_gather", T * (C - 1) * 48),
        (lambda: mesh.reduce_scatter(ts, "c", "sum"), "reduce_scatter",
         T * (C - 1) * 48 // C),
        (lambda: mesh.all_to_all(ts, "c"), "all_to_all",
         T * (C - 1) * 48 // C),
        (lambda: mesh.all_reduce(ts, "max"), "all_reduce", T * (T - 1) * 48),
        (lambda: mesh.gather_segments(ts), "gather_segments", (T - 1) * 48),
    ]
    for run, name, want in cases:
        recorder.reset()
        run()
        snap = recorder.snapshot()
        assert snap["counters"].get("mesh.bytes", 0.0) == want, name
        assert [s[0] for s in snap["spans"]] == [f"mesh.{name}"]


def test_reduce_scatter_folds_each_chunk_in_group_order():
    """Each tile's segment is the fold of its chunk of the group's
    partials, in column order: the same numbers as folding whole rows."""
    mesh = _mesh((2, 4))
    gen = torch.Generator().manual_seed(4)
    ts = [torch.randn(4 * 10, generator=gen) for _ in range(8)]
    out = mesh.reduce_scatter(ts, "c", "sum")
    for t in range(8):
        i, j = divmod(t, 4)
        row = ts[i * 4] + ts[i * 4 + 1] + ts[i * 4 + 2] + ts[i * 4 + 3]
        assert torch.equal(out[t], row[j * 10:(j + 1) * 10])
