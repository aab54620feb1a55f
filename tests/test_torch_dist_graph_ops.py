"""Whole-graph operations on the port's DistGraph
(``graphmat_tpu_torch.parallel.dist_graph_ops``) against the JAX
package's, on the same inputs as ``tests/test_dist_graph_ops.py``, over a
``LocalMesh`` of 2x4 CPU tiles beside the JAX 2x4 mesh of virtual CPU
devices; and the app runners that take a DistGraph through ``engine_for``.

Everything here is exact, except incremental PageRank (5e-4 absolute
against the one-device JAX run, the JAX test's bound).
"""

import itertools

import numpy as np
import pytest

import jax
from graphmat_tpu import Graph as JGraph
from graphmat_tpu.apps.incremental_pagerank import \
    run_incremental_pagerank as jrun_incremental_pagerank
from graphmat_tpu.apps.pagerank import run_pagerank as jrun_pagerank
from graphmat_tpu.apps.topological_sort import \
    run_topological_sort as jrun_topological_sort
from graphmat_tpu.parallel.dist_graph import DistGraph as JDistGraph
from graphmat_tpu.parallel.dist_graph_ops import (
    apply_reduce_all_vertices as japply_reduce,
    apply_to_all_edges as japply_edges,
    apply_to_all_vertices as japply_vertices)
from graphmat_tpu.parallel.mesh import make_mesh as jmake_mesh
from graphmat_tpu.utils.generators import (random_edgelist,
                                           upper_triangular_edgelist)

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps.connected_components import \
    run_connected_components
from graphmat_tpu_torch.apps.delta_stepping import (INF_DIST,
                                                    run_delta_stepping_dist)
from graphmat_tpu_torch.apps.incremental_pagerank import \
    run_incremental_pagerank
from graphmat_tpu_torch.apps.topological_sort import run_topological_sort
from graphmat_tpu_torch.core.types import Monoid
from graphmat_tpu_torch.parallel.dist_graph import DistGraph
from graphmat_tpu_torch.parallel.dist_graph_ops import (
    apply_reduce_all_vertices, apply_to_all_edges, apply_to_all_vertices)
from graphmat_tpu_torch.parallel.mesh import LocalMesh


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(jax.devices()[:8], (2, 4))


@pytest.fixture(scope="module")
def mesh():
    return LocalMesh(["cpu"] * 8, (2, 4))


def port_edges(e):
    return gt.EdgeList(e.m, e.n, np.asarray(e.src), np.asarray(e.dst),
                       np.asarray(e.val))


def make_pair(jmesh, mesh, n=60, deg=4, seed=5):
    e = random_edgelist(n, deg, seed=seed)
    jg = JDistGraph(e, jmesh, seg_align=8)
    tg = DistGraph(port_edges(e), mesh, seg_align=8)
    ids = np.arange(1, jg.n + 1, dtype=np.int32)
    jg.init_vertexproperty(val=ids)
    tg.init_vertexproperty(val=ids)
    return jg, tg, e


def test_apply_to_all_vertices(jmesh, mesh):
    jg, tg, _ = make_pair(jmesh, mesh)
    japply_vertices(jg, lambda vp: {"val": vp["val"] * 2})
    apply_to_all_vertices(tg, lambda vp: {"val": vp["val"] * 2})
    np.testing.assert_array_equal(tg.vp_numpy()["val"], jg.vp_numpy()["val"])
    np.testing.assert_array_equal(tg.vp_numpy()["val"],
                                  2 * np.arange(1, tg.n + 1))


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_apply_reduce(jmesh, mesh, kind):
    jg, tg, _ = make_pair(jmesh, mesh)
    out_j = japply_reduce(jg, lambda vp: {"v": vp["val"]}, kind)
    out_t = apply_reduce_all_vertices(tg, lambda vp: {"v": vp["val"]}, kind)
    assert int(out_t["v"]) == int(out_j["v"])
    n = tg.n
    assert int(out_t["v"]) == {"sum": n * (n + 1) // 2, "min": 1,
                               "max": n}[kind]


def test_apply_reduce_monoid_and_callable(mesh):
    e = port_edges(random_edgelist(60, 4, seed=5))
    tg = DistGraph(e, mesh, seg_align=8)
    tg.init_vertexproperty(val=np.arange(1, tg.n + 1, dtype=np.int32))
    assert int(apply_reduce_all_vertices(
        tg, lambda vp: vp["val"], Monoid("max"))) == tg.n
    assert int(apply_reduce_all_vertices(
        tg, lambda vp: vp["val"], lambda a, b: a + b)) == \
        tg.n * (tg.n + 1) // 2


def _edge_values(tg):
    """{(src1, dst1): val} of every CSR of the graph, per CSR kind."""
    out = {}
    for recv, cs in list(tg._tiles.items()) + [
            ("sender " + r, cs) for r, cs in tg._sender.items()]:
        vals = {}
        for t, c in zip(tg.local, cs):
            if recv.startswith("sender"):
                s_loc, r_loc = c.row.long(), c.col.long()
            else:
                s_loc, r_loc = c.col.long(), c.row.long()
            s, r = tg.to_global(t, s_loc, r_loc)
            src, dst = (s, r) if recv.endswith("dst") else (r, s)
            inv = np.empty(tg.n, np.int64)
            perm = (tg.perm.numpy() if tg.perm is not None
                    else np.arange(tg.n))
            inv[perm] = np.arange(tg.n)
            for a, b, v in zip(inv[src.numpy()], inv[dst.numpy()],
                               c.val.tolist()):
                vals[(int(a) + 1, int(b) + 1)] = v
        out[recv] = vals
    return out


def test_apply_to_all_edges(jmesh, mesh):
    """``val == src + 5 * dst`` on every tile CSR, both directions and the
    push kernel's sender-major index (the reference's
    test_apply_edges.cpp)."""
    jg, tg, e = make_pair(jmesh, mesh)
    tg.sender_csrs("dst")   # built before the rewrite: it must follow
    fn = lambda vs, vd, val: vs["val"] + 5 * vd["val"]   # noqa: E731
    japply_edges(jg, fn)
    apply_to_all_edges(tg, fn)
    expect = {(s, d): s + 5 * d
              for s, d in zip(e.src.astype(int), e.dst.astype(int))}
    got = _edge_values(tg)
    assert set(got) == {"dst", "src", "sender dst"}
    for vals in got.values():
        assert vals == expect
    assert all(c._val_f32 is None for c in tg.csrs("dst"))
    # and the JAX host tiles agree
    back = jg.get_edges()
    assert sorted(zip(back.src.tolist(), back.dst.tolist(),
                      back.val.tolist())) == sorted(
        (s, d, v) for (s, d), v in expect.items())


def test_share_vertex_property(mesh):
    """Two DistGraphs over one mesh alias one property store
    (DeltaStepping's light/heavy split, Graph.h:301-305)."""
    e1 = port_edges(random_edgelist(60, 4, seed=5))
    e2 = port_edges(random_edgelist(60, 4, seed=6))
    g1 = DistGraph(e1, mesh, seg_align=8, permute=False)
    g2 = DistGraph(e2, mesh, seg_align=8, permute=False)
    g1.init_vertexproperty(val=np.arange(1, g1.n + 1, dtype=np.int32))
    g2.share_vertex_property(g1)
    apply_to_all_vertices(g2, lambda vp: {"val": vp["val"] + 7})
    np.testing.assert_array_equal(g1.vp_numpy()["val"],
                                  np.arange(1, g1.n + 1) + 7)
    g1.set_vertexproperty(3, val=999)
    assert g2.get_vertexproperty(3)["val"] == 999
    g3 = DistGraph(e2, mesh, seg_align=8, permute=True)
    with pytest.raises(ValueError, match="permutation"):
        g3.share_vertex_property(g1)
    g4 = DistGraph(e2, LocalMesh(["cpu"] * 8, (2, 4)), seg_align=8,
                   permute=False)
    with pytest.raises(ValueError, match="mesh"):
        g4.share_vertex_property(g1)


@pytest.mark.parametrize("permute", [False, True])
def test_get_edges_roundtrip(jmesh, mesh, permute):
    """SpMat::get_edges: the DistGraph exports its edge list exactly
    (order-insensitive), as the JAX DistGraph does."""
    e = random_edgelist(45, 3, seed=4)
    tg = DistGraph(port_edges(e), mesh, seg_align=8, permute=permute)
    jg = JDistGraph(e, jmesh, seg_align=8, permute=permute)
    out = tg.get_edges()
    ours = sorted(zip(out.src.tolist(), out.dst.tolist(), out.val.tolist()))
    assert ours == sorted(e.as_records()) == \
        sorted(jg.get_edges().as_records())


def test_delta_stepping_matches_dijkstra(mesh):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra
    e = random_edgelist(50, 4, seed=11, weight_range=9)
    dist, _ = run_delta_stepping_dist(port_edges(e), 3, 1, mesh, seg_align=8)
    n = max(e.m, e.n)
    a = coo_matrix((e.val, (e.src - 1, e.dst - 1)), shape=(n, n)).tocsr()
    ref = dijkstra(a, directed=True, indices=0)
    ref_i = np.where(np.isfinite(ref), ref, INF_DIST).astype(np.int64)
    np.testing.assert_array_equal(dist[:n], ref_i)


def test_toposort_via_polymorphic_runner(jmesh, mesh):
    """run_topological_sort takes a DistGraph (engine_for)."""
    e = upper_triangular_edgelist(20)
    order_t, cyc_t, it_t = run_topological_sort(
        DistGraph(port_edges(e), mesh, seg_align=8))
    order_j, cyc_j, it_j = jrun_topological_sort(JGraph(e))
    np.testing.assert_array_equal(order_t, np.asarray(order_j)[:e.n])
    assert (cyc_t, it_t) == (bool(cyc_j), it_j)


def test_incremental_pagerank_runner(mesh):
    e = random_edgelist(50, 4, seed=2)
    pr, _ = jrun_pagerank(JGraph(e))
    dpr, _ = run_incremental_pagerank(DistGraph(port_edges(e), mesh,
                                                seg_align=8))
    jdpr, _ = jrun_incremental_pagerank(JGraph(e))
    n = max(e.m, e.n)
    np.testing.assert_allclose(np.asarray(dpr[:n], np.float64),
                               np.asarray(pr[:n], np.float64), atol=5e-4)
    np.testing.assert_allclose(dpr, np.asarray(jdpr), rtol=1e-5, atol=1e-6)


def test_connected_components_runner(mesh):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as scipy_cc
    e = random_edgelist(40, 2, seed=8)
    labels, ncomp, _ = run_connected_components(
        DistGraph(port_edges(e), mesh, seg_align=8))
    n = max(e.m, e.n)
    a = coo_matrix((np.ones(e.nnz), (e.src - 1, e.dst - 1)), shape=(n, n))
    nref, ref = scipy_cc(a, directed=True, connection="weak")
    assert ncomp == nref
    for i, j in itertools.combinations(range(n), 2):
        assert (labels[i] == labels[j]) == (ref[i] == ref[j])
