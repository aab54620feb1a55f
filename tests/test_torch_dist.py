"""The port's 2D-sharded engine (``graphmat_tpu_torch.parallel``) against
the JAX package's ``DistEngine`` on its XLA path, over the 8 virtual CPU
devices that ``conftest.py`` provides: the layout (``S``, ``n_pad``,
``perm`` and every tile's edges, bit for bit), and the apps on a
``LocalMesh`` of 2x4 CPU tiles against the JAX 2x4 mesh, under both
kernel routes (``GRAPHMAT_KERNEL=v2u``: K1's plain version; ``=v2``: the
push kernel's); 1x1 and 2x2 meshes for a sum and a min program;
rectangular tiles with an empty tile; compacted tiles (K2's route).

Tolerances: depths, parents, distances, labels, neighbour lists, got
counts and frontiers exactly; PageRank within 1e-5 relative (float32 sums
in other orders: each tile sums its part and the reduce-scatter sums the
tiles, ROADMAP H1); SGD and ACTIVE_ONLY SGD 1e-5; LDA as
``test_torch_lda.py`` (N 1e-5 relative, 1e-6 absolute).
"""

import numpy as np
import pytest

import jax
from graphmat_tpu.apps import bfs as jbfs
from graphmat_tpu.apps import connected_components as jcc
from graphmat_tpu.apps import delta_stepping as jds
from graphmat_tpu.apps import get_neighbors as jgn
from graphmat_tpu.apps import lda as jlda
from graphmat_tpu.apps import pagerank as jpr
from graphmat_tpu.apps import sgd as jsgd
from graphmat_tpu.apps import sssp as jsssp
from graphmat_tpu.parallel.dist_graph import DistGraph as JDistGraph
from graphmat_tpu.parallel.dist_runtime import DistEngine as JDistEngine
from graphmat_tpu.parallel.mesh import factor2d as jfactor2d
from graphmat_tpu.parallel.mesh import make_mesh as jmake_mesh
from graphmat_tpu.utils.generators import random_edgelist, rmat_edgelist

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import bfs, connected_components as cc
from graphmat_tpu_torch.apps import delta_stepping as ds
from graphmat_tpu_torch.apps import get_neighbors as gn
from graphmat_tpu_torch.apps import lda, pagerank, sgd, sssp
from graphmat_tpu_torch.apps.triangle_counting import run_triangle_counting
from graphmat_tpu_torch.core.runtime import engine_for
from graphmat_tpu_torch.ops import compact, spmv2u
from graphmat_tpu_torch.parallel.dist_graph import DistGraph
from graphmat_tpu_torch.parallel.dist_runtime import DistEngine
from graphmat_tpu_torch.parallel.mesh import LocalMesh, factor2d

from test_ml_apps import bipartite_edges

K = 8
NDOC, NTERMS = 9, 14
_JAX = {}


def jax_once(key, fn):
    """The JAX run for ``key``, computed once per test process."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def jmesh(shape):
    return jmake_mesh(jax.devices()[: shape[0] * shape[1]], shape)


def tmesh(shape):
    return LocalMesh(["cpu"] * (shape[0] * shape[1]), shape)


def port_edges(e):
    return gt.EdgeList(e.m, e.n, np.asarray(e.src), np.asarray(e.dst),
                       np.asarray(e.val))


@pytest.fixture(params=["v2u", "v2"])
def route(request, monkeypatch):
    monkeypatch.setenv("GRAPHMAT_KERNEL", request.param)
    return request.param


def test_factor2d_matches_jax():
    for n in range(1, 65):
        assert factor2d(n) == jfactor2d(n)


# ------------------------------------------------------------------ layout

def _layout_edges(kind):
    return (rmat_edgelist(10, 8, seed=3) if kind == "rmat"
            else random_edgelist(300, 5, seed=9))


@pytest.mark.parametrize("shape", [(2, 4), (1, 1), (2, 2)])
@pytest.mark.parametrize("permute", [False, True, "degree", "auto"])
@pytest.mark.parametrize("kind", ["rmat", "random"])
def test_layout_matches_jax(kind, permute, shape):
    """S, n_pad and perm bit for bit, and each tile's edges (both
    directions) equal to JAX's ``_localize``."""
    e = _layout_edges(kind)
    jg = JDistGraph(e, jmesh(shape), seg_align=8, permute=permute)
    tg = DistGraph(port_edges(e), tmesh(shape), seg_align=8,
                   permute=permute)
    assert (tg.S, tg.n_pad) == (jg.S, jg.n_pad)
    if jg.perm is None:
        assert tg.perm is None
    else:
        np.testing.assert_array_equal(tg.perm.numpy(), jg.perm)
    for recv in ("dst", "src"):
        for t, (s_loc, r_loc, v) in enumerate(jg._host_tiles[recv]):
            c = tg.csrs(recv)[t]
            assert (c.n_rows, c.n_send) == (shape[1] * tg.S,
                                            shape[0] * tg.S)
            ours = sorted(zip(c.row.tolist(), c.col.tolist(),
                              c.val.tolist()))
            theirs = sorted(zip(r_loc.tolist(), s_loc.tolist(), v.tolist()))
            assert ours == theirs, (recv, t)


def test_auto_permute_triggers_on_rmat():
    e = rmat_edgelist(11, 8, seed=3)
    tg = DistGraph(port_edges(e), tmesh((2, 4)))
    assert tg.perm is not None
    cnt = np.array([c.nnz for c in tg.csrs("dst")], float)
    assert cnt.max() <= 2.0 * cnt.mean()


# -------------------------------------------------------------------- apps

def _pair(e, shape, **kw):
    return (JDistGraph(e, jmesh(shape), seg_align=8, **kw),
            DistGraph(port_edges(e), tmesh(shape), seg_align=8, **kw))


def _pagerank_case(shape, permute):
    e = random_edgelist(200, 5, seed=17)

    def jrun():
        jg, _ = _pair(e, shape, permute=permute)
        return jpr.run_pagerank(jg)
    pr_j, it_j = jax_once(("pr", shape, permute), jrun)
    _, tg = _pair(e, shape, permute=permute)
    pr_t, it_t = pagerank.run_pagerank(tg)
    return pr_t, it_t, pr_j, it_j


@pytest.mark.parametrize("permute", [False, True])
def test_pagerank_2x4(route, permute):
    pr_t, it_t, pr_j, it_j = _pagerank_case((2, 4), permute)
    assert it_t == it_j
    np.testing.assert_allclose(pr_t, pr_j, rtol=1e-5, atol=1e-6)


def _bfs_edges():
    return random_edgelist(150, 3, seed=23)


def test_bfs_2x4(route):
    e = _bfs_edges()

    def jrun():
        jg, _ = _pair(e, (2, 4), build_in_edges=False)
        return jbfs.run_bfs(jg, 1)
    d_j, p_j, it_j = jax_once("bfs", jrun)
    _, tg = _pair(e, (2, 4), build_in_edges=False)
    before = dict(spmv2u.LAUNCHES)
    d_t, p_t, it_t = bfs.run_bfs(tg, 1)
    assert spmv2u.LAUNCHES == before   # CPU tiles: the plain versions
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(p_t, p_j)
    assert it_t == it_j


@pytest.mark.parametrize("shape", [(2, 4), (1, 1), (2, 2)])
def test_sssp(route, shape):
    e = random_edgelist(120, 4, seed=29, weight_range=9)

    def jrun():
        jg, _ = _pair(e, shape, build_in_edges=False)
        return jsssp.run_sssp(jg, 1)
    d_j, it_j = jax_once(("sssp", shape), jrun)
    _, tg = _pair(e, shape, build_in_edges=False)
    d_t, it_t = sssp.run_sssp(tg, 1)
    np.testing.assert_array_equal(d_t, d_j)
    assert it_t == it_j


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_pagerank_small_meshes(shape):
    pr_t, it_t, pr_j, it_j = _pagerank_case(shape, False)
    assert it_t == it_j
    np.testing.assert_allclose(pr_t, pr_j, rtol=1e-5, atol=1e-6)


def test_connected_components_2x4(route):
    e = random_edgelist(120, 2, seed=8)

    def jrun():
        jg, _ = _pair(e, (2, 4))
        return jcc.run_connected_components(jg)
    l_j, n_j, it_j = jax_once("cc", jrun)
    _, tg = _pair(e, (2, 4))
    l_t, n_t, it_t = cc.run_connected_components(tg)
    np.testing.assert_array_equal(l_t, l_j)
    assert (n_t, it_t) == (n_j, it_j)


def test_delta_stepping_2x4(route):
    e = random_edgelist(100, 4, seed=11, weight_range=9)
    d_j, b_j = jax_once("ds", lambda: jds.run_delta_stepping_dist(
        e, 3, 1, jmesh((2, 4)), seg_align=8))
    d_t, b_t = ds.run_delta_stepping_dist(port_edges(e), 3, 1, tmesh((2, 4)),
                                          seg_align=8)
    np.testing.assert_array_equal(d_t, d_j)
    assert b_t == b_j


def test_sgd_2x4():
    e = random_edgelist(120, 6, seed=12, weight_range=5)

    def jrun():
        jg, _ = _pair(e, (2, 4))
        return jsgd.run_sgd(jg, k=K, iterations=5)
    lv_j, r0_j, r1_j = jax_once("sgd", jrun)
    _, tg = _pair(e, (2, 4))
    lv_t, r0_t, r1_t = sgd.run_sgd(tg, k=K, iterations=5)
    np.testing.assert_allclose(lv_t, lv_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([r0_t, r1_t], [r0_j, r1_j], rtol=1e-5)


def _active_only(cls):
    return type(f"ActiveOnly{cls.__name__}", (cls,),
                {"activity": type(cls.activity).ACTIVE_ONLY})


def test_active_only_sgd_2x4():
    """Three ACTIVE_ONLY SGD steps from a seeded third of the vertices
    (K3's sparse mode per tile); values 1e-5, next frontier exact."""
    e = random_edgelist(120, 6, seed=12, weight_range=5)
    mask = np.random.default_rng(3).random(max(e.m, e.n)) < 0.35

    def jrun():
        jg, _ = _pair(e, (2, 4))
        jsgd.init_sgd_graph(jg, K)
        jg.set_active_mask(mask)
        JDistEngine(_active_only(jsgd.SGDProgram)(step=1e-3, k=K),
                    jg).run(iterations=3)
        act = np.asarray(jg.active)
        act = act[jg.perm] if jg.perm is not None else act[: jg.n]
        return jg.vp_numpy()["lv"], act
    lv_j, act_j = jax_once("asgd", jrun)
    _, tg = _pair(e, (2, 4))
    sgd.init_sgd_graph(tg, K)
    tg.set_active_mask(mask)
    eng = DistEngine(_active_only(sgd.SGDProgram)(step=1e-3, k=K), tg)
    assert eng._vec is not None
    eng.run(iterations=3)
    np.testing.assert_allclose(tg.vp_numpy()["lv"], lv_j, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tg.active_numpy(), act_j)


def test_active_only_got_counts_exact():
    """The sparse mode's counts, reduce-scattered over the 2x4 tiles, are
    each receiver's number of in-edges from senders that sent."""
    e = random_edgelist(120, 6, seed=12, weight_range=5)
    n = max(e.m, e.n)
    mask = np.random.default_rng(4).random(n) < 0.3
    _, tg = _pair(e, (2, 4))
    sgd.init_sgd_graph(tg, K)
    tg.set_active_mask(mask)
    eng = DistEngine(_active_only(sgd.SGDProgram)(k=K), tg)
    sts = [0] * len(tg.local)
    msgs = [vp["lv"] for vp in tg.vp]
    sents = [a & v for a, v in zip(tg.active, tg.valid_vertex)]
    _, counts = eng.vec_partials(sts, msgs, sents, tg.vp)
    # the program runs ALL_EDGES: a vertex hears from both endpoints
    src, dst = np.asarray(e.src) - 1, np.asarray(e.dst) - 1
    want = np.zeros(n, np.int64)
    np.add.at(want, dst, mask[src])
    np.add.at(want, src, mask[dst])
    np.testing.assert_array_equal(
        tg._to_original(tg._full(counts).numpy()), want)


def test_lda_2x4():
    e = bipartite_edges(NDOC, NTERMS, seed=31)

    def jrun():
        jg, _ = _pair(e, (2, 4))
        return jlda.run_lda(jg, NDOC, NTERMS, k=K, iterations=3)
    n_j, gn_j, ll_j = jax_once("lda", jrun)
    _, tg = _pair(e, (2, 4))
    n_t, gn_t, ll_t = lda.run_lda(tg, NDOC, NTERMS, k=K, iterations=3)
    np.testing.assert_allclose(n_t, n_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gn_t, gn_j, rtol=1e-5)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5)


def test_get_neighbors_2x4():
    e = random_edgelist(60, 3, seed=4)

    def jrun():
        jg, _ = _pair(e, (2, 4))
        return np.asarray(jgn.run_get_neighbors(jg))
    nb_j = jax_once("gn", jrun)
    _, tg = _pair(e, (2, 4))
    nb_t = gn.run_get_neighbors(tg)
    np.testing.assert_array_equal(nb_t, nb_j)


# ------------------------------------------------------- tiles and routes

def _clustered_edges():
    """Edges among vertices 1-40 of 400 only, so that on a 2x4 mesh of
    S = 56 most tiles hold no edge."""
    rng = np.random.default_rng(2)
    src = rng.integers(1, 41, 300)
    dst = rng.integers(1, 41, 300)
    keep = src != dst
    return gt.edgelist_from_arrays(src[keep], dst[keep],
                                   rng.integers(1, 9, keep.sum()),
                                   m=400, n=400)


def test_empty_tiles_2x4(route):
    """Rectangular tiles (C * S rows over R * S senders) where most tiles
    are empty in both directions: PageRank and SSSP equal the one-device
    Engine."""
    e = _clustered_edges()
    tg = DistGraph(e, tmesh((2, 4)), seg_align=8, permute=False)
    counts = [c.nnz for c in tg.csrs("dst")]
    assert counts.count(0) >= 4, counts
    pr_t, it_t = pagerank.run_pagerank(tg)
    pr_1, it_1 = pagerank.run_pagerank(gt.Graph(e, device="cpu"))
    assert it_t == it_1
    np.testing.assert_allclose(pr_t, pr_1, rtol=1e-5, atol=1e-6)
    tg = DistGraph(e, tmesh((2, 4)), seg_align=8, permute=False,
                   build_in_edges=False)
    d_t, _ = sssp.run_sssp(tg, 3)
    d_1, _ = sssp.run_sssp(gt.Graph(e, device="cpu", build_in_edges=False),
                           3)
    np.testing.assert_array_equal(d_t, d_1)


def test_compacted_tiles_equal_uncompacted(route):
    """Compacted tiles (K2's operand extension, forced at this size) give
    the uncompacted tiles' results bitwise: BFS, and PageRank's sums."""
    e = port_edges(rmat_edgelist(11, 8, seed=5))
    kw = dict(hub=0, divert_min=1 << 30, w_div=1)
    on = DistGraph(e, tmesh((2, 2)), seg_align=8, compact=True,
                   compact_kw=kw)
    off = DistGraph(e, tmesh((2, 2)), seg_align=8, compact=False)
    assert all(c.src_of_pos is not None for c in on.csrs("dst") if c.nnz)
    before = compact.LAUNCHES["aux_gather"]
    pr_on, it_on = pagerank.run_pagerank(on)
    pr_off, it_off = pagerank.run_pagerank(off)
    assert compact.LAUNCHES["aux_gather"] == before   # CPU: the plain one
    assert it_on == it_off
    np.testing.assert_array_equal(pr_on, pr_off)
    d_on = bfs.run_bfs(on, 1)
    d_off = bfs.run_bfs(off, 1)
    for a, b in zip(d_on, d_off):
        np.testing.assert_array_equal(a, b)


def test_push_route_reads_tile_sender_index(monkeypatch):
    """Under GRAPHMAT_KERNEL=v2 each tile's push reads its own
    sender-major index: R * S sender rows over C * S receivers."""
    monkeypatch.setenv("GRAPHMAT_KERNEL", "v2")
    e = port_edges(random_edgelist(150, 3, seed=23))
    tg = DistGraph(e, tmesh((2, 4)), seg_align=8, build_in_edges=False)
    bfs.run_bfs(tg, 1)
    for c, s in zip(tg.csrs("dst"), tg.sender_csrs("dst")):
        assert (s.n_rows, s.n_send, s.nnz) == (c.n_send, c.n_rows, c.nnz)


def test_engine_for_and_routing():
    e = port_edges(random_edgelist(60, 3, seed=1))
    tg = DistGraph(e, tmesh((2, 2)), seg_align=8)
    eng = engine_for(pagerank.PageRankProgram(), tg)
    assert isinstance(eng, DistEngine) and eng._semiring is not None
    assert engine_for(sgd.SGDProgram(k=4), tg)._vec is not None
    assert engine_for(gn.GetNeighborsProgram(), tg)._vecmsg
    with pytest.raises(TypeError):
        engine_for(pagerank.PageRankProgram(), object())
    with pytest.raises(TypeError):
        bfs.run_bfs_fast(tg, 1, None, None)
    with pytest.raises(TypeError, match="one-device Graph"):
        run_triangle_counting(tg)


def test_lda_do_every_iteration_reduces_over_the_mesh():
    """LDA's global topic totals (``ctx.all_reduce_sum`` in
    ``do_every_iteration``) over the 2x4 tiles equal the one-device
    Engine's."""
    e = port_edges(bipartite_edges(NDOC, NTERMS, seed=31))
    _, gn_t, _ = lda.run_lda(DistGraph(e, tmesh((2, 4)), seg_align=8),
                             NDOC, NTERMS, k=K, iterations=2)
    _, gn_1, _ = lda.run_lda(gt.Graph(e, device="cpu"), NDOC, NTERMS, k=K,
                             iterations=2)
    np.testing.assert_allclose(gn_t, gn_1, rtol=1e-5)
