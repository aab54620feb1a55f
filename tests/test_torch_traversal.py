"""The scalar frontier apps of the port (BFS, packed-key BFS, SSSP,
connected components, topological sort, incremental PageRank,
delta-stepping) against the JAX package's CPU Engine (its XLA path) on the
same numpy inputs, under both kernel routes (``GRAPHMAT_KERNEL=v2u``: K1's
plain version; ``=v2``: the push kernel's), with and without
``permute="degree"``; the goldens through the port's CLIs; the exactness
of the receiver-finality skip; and the Graph, transform and graph-op API
the apps use.

Tolerances: depths, parents, distances, labels, orders, bucket and
iteration counts are exact; incremental PageRank within 1e-6 of max(1,
|pr|) (float32 sums in other orders, ROADMAP H1; 2e-7 measured).
"""

import re

import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import bfs as jbfs
from graphmat_tpu.apps import connected_components as jcc
from graphmat_tpu.apps import delta_stepping as jds
from graphmat_tpu.apps import incremental_pagerank as jipr
from graphmat_tpu.apps import sssp as jsssp
from graphmat_tpu.apps import topological_sort as jts
from graphmat_tpu.core import graph_ops as jops
from graphmat_tpu.io import transforms as jtr
from graphmat_tpu.utils.generators import random_edgelist

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import bfs, connected_components as cc
from graphmat_tpu_torch.apps import delta_stepping as ds
from graphmat_tpu_torch.apps import incremental_pagerank as ipr
from graphmat_tpu_torch.apps import sssp, topological_sort as ts
from graphmat_tpu_torch.core import graph_ops
from graphmat_tpu_torch.core.runtime import Engine, legacy_kernel_env
from graphmat_tpu_torch.io import transforms as ttr

from test_golden import fixture, gold, run_cli
from test_traversal import _early_delivery_edgelist, _whiskered_edgelist

INCPR_ATOL = 1e-6
PERMUTES = [False, "degree"]
_JAX = {}


@pytest.fixture(params=["v2u", "v2"])
def route(request, monkeypatch):
    monkeypatch.setenv("GRAPHMAT_KERNEL", request.param)
    return request.param


def jax_once(key, fn):
    """The JAX run for ``key``, computed once per test process."""
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def weighted():
    return random_edgelist(300, 4, seed=21, weight_range=20)


def dag():
    return jtr.convert_to_upper_triangular(random_edgelist(300, 4, seed=4))


def tgraph(e, **kw):
    return gt.Graph(e, device="cpu", **kw)


@pytest.mark.parametrize("permute", PERMUTES)
def test_bfs_matches_jax(route, permute):
    e = weighted()
    want = jax_once(("bfs", permute), lambda: jbfs.run_bfs(
        gj.Graph(e, build_in_edges=False, permute=permute), 3))
    g = tgraph(e, build_in_edges=False, permute=permute)
    got = bfs.run_bfs(g, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert bfs.reachable_count(g) == int((got[0] < bfs.INF_DEPTH).sum())


@pytest.mark.parametrize("permute", PERMUTES)
def test_sssp_matches_jax(route, permute):
    e = weighted()
    want = jax_once(("sssp", permute), lambda: jsssp.run_sssp(
        gj.Graph(e, build_in_edges=False, permute=permute), 7))
    g = tgraph(e, build_in_edges=False, permute=permute)
    dist, niter = sssp.run_sssp(g, 7)
    np.testing.assert_array_equal(dist, np.asarray(want[0]))
    assert niter == want[1]
    assert sssp.reachable_count(g) == int((dist < sssp.INF_DIST).sum())


@pytest.mark.parametrize("permute", PERMUTES)
def test_connected_components_match_jax(route, permute):
    e = random_edgelist(400, 1, seed=33)
    want = jax_once(("cc", permute), lambda: jcc.run_connected_components(
        gj.Graph(e, permute=permute)))
    labels, ncomp, niter = cc.run_connected_components(
        tgraph(e, permute=permute))
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    assert (ncomp, niter) == (want[1], want[2])


@pytest.mark.parametrize("permute", PERMUTES)
def test_toposort_matches_jax(route, permute):
    """Against the JAX run on the unpermuted graph: JAX seeds the sort
    with original ids into permuted arrays (ROADMAP R3), the port does
    not, so its order must not depend on the permutation."""
    e = dag()
    want = jax_once(("toposort", False), lambda: jts.run_topological_sort(
        gj.Graph(e)))
    order, cyc, niter = ts.run_topological_sort(tgraph(e, permute=permute))
    np.testing.assert_array_equal(order, np.asarray(want[0]))
    assert (cyc, niter) == (want[1], want[2]) and not cyc
    assert (order[e.src - 1] < order[e.dst - 1]).all()


def test_toposort_detects_cycle(route):
    from graphmat_tpu_torch.utils.generators import chain_edgelist
    e = chain_edgelist(8)
    cyc = gt.EdgeList(8, 8, np.append(e.src, 8).astype(np.int32),
                      np.append(e.dst, 1).astype(np.int32),
                      np.ones(8, np.int32))
    order, has_cycle, _ = ts.run_topological_sort(tgraph(cyc))
    assert has_cycle and (order == ts.INF_ORDER).all()


@pytest.mark.parametrize("permute", PERMUTES)
def test_incremental_pagerank_matches_jax(route, permute):
    e = random_edgelist(300, 5, seed=9)
    want = jax_once(("incpr", permute), lambda: jipr.run_incremental_pagerank(
        gj.Graph(e, permute=permute)))
    pr, niter = ipr.run_incremental_pagerank(tgraph(e, permute=permute))
    err = np.abs(pr - np.asarray(want[0])) / np.maximum(1.0, np.abs(pr))
    assert err.max() <= INCPR_ATOL
    assert niter == want[1]


@pytest.mark.parametrize("delta", [1, 4, 100])
def test_delta_stepping_matches_jax(route, delta):
    e = weighted()
    want = jax_once(("ds", delta), lambda: jds.run_delta_stepping(
        e, delta, 1))
    dist, nb = ds.run_delta_stepping(e, delta, 1, device="cpu")
    np.testing.assert_array_equal(dist, np.asarray(want[0]))
    assert nb == want[1]


def test_delta_stepping_runs_its_semiring():
    """ROADMAP R1 is not copied: the program declares its min semiring,
    so the Engine runs a kernel and its receiver_final reaches K1."""
    prog = ds.DeltaSteppingProgram(3)
    sem = prog.semiring()
    assert (sem.reduce_kind, sem.process_op) == ("min", "x_add_val")
    assert jds.DeltaSteppingProgram(3).pallas_semiring() is None


@pytest.mark.parametrize("permute", PERMUTES)
def test_bfs_fast_matches_jax(route, permute):
    e = _whiskered_edgelist()
    e_aug, pred0, ind1 = jbfs.build_bfs_shortcuts(e)
    t_aug, t_pred0, t_ind1 = bfs.build_bfs_shortcuts(e)
    for a, b in zip((t_aug.src, t_aug.dst, t_aug.val, t_pred0, t_ind1),
                    (e_aug.src, e_aug.dst, e_aug.val, pred0, ind1)):
        np.testing.assert_array_equal(a, b)
    want = jax_once(("bfs_fast", permute), lambda: jbfs.run_bfs_fast(
        gj.Graph(e_aug, build_in_edges=False, permute=permute), 43, pred0,
        ind1))
    got = bfs.run_bfs_fast(tgraph(e_aug, build_in_edges=False,
                                  permute=permute), 43, pred0, ind1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    classic = bfs.run_bfs(tgraph(e, build_in_edges=False), 43)
    np.testing.assert_array_equal(got[0], classic[0])


def test_bfs_fast_bits_bound():
    with pytest.raises(ValueError, match="run_bfs"):
        bfs.BFSFastProgram(22)


# ------------------------------------------------- receiver finality

def _run_bfs(hook, monkeypatch):
    if hook is not None:
        monkeypatch.setattr(bfs.BFSProgram, "receiver_final", hook)
    return bfs.run_bfs(tgraph(weighted(), build_in_edges=False), 3)


def _run_bfs_fast(hook, monkeypatch):
    if hook is not None:
        monkeypatch.setattr(bfs.BFSFastProgram, "receiver_final", hook)
    e_aug, pred0, ind1 = bfs.build_bfs_shortcuts(_early_delivery_edgelist())
    return bfs.run_bfs_fast(tgraph(e_aug, build_in_edges=False), 1, pred0,
                            ind1)


def _run_toposort(hook, monkeypatch):
    if hook is not None:
        monkeypatch.setattr(ts.TopSortProgram, "receiver_final", hook)
    return ts.run_topological_sort(tgraph(dag(), permute="degree"))


def _run_ds(hook, monkeypatch):
    if hook is not None:
        monkeypatch.setattr(ds.DeltaSteppingProgram, "receiver_final", hook)
    return ds.run_delta_stepping(weighted(), 4, 1, device="cpu")


@pytest.mark.parametrize("run", [_run_bfs, _run_bfs_fast, _run_toposort,
                                 _run_ds],
                         ids=["bfs", "bfs_fast", "toposort", "delta"])
def test_receiver_final_is_exact(run, monkeypatch):
    """Each app with its mask equals the app without it, bitwise (the mask
    reaches K1's sparse sweeps, the default route)."""
    monkeypatch.setenv("GRAPHMAT_KERNEL", "v2u")
    with_mask = run(None, monkeypatch)
    monkeypatch.undo()
    monkeypatch.setenv("GRAPHMAT_KERNEL", "v2u")
    without = run(lambda self, state, vp, it: None, monkeypatch)
    for a, b in zip(with_mask, without):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_receiver_final_reaches_the_kernel(monkeypatch):
    """An inexact mask changes the result (so the skip really runs): on
    the early-delivery graph 'visited' leaves z at depth 4, not 3."""
    monkeypatch.setenv("GRAPHMAT_KERNEL", "v2u")
    d_vis, _, _ = _run_bfs_fast(
        lambda self, state, vp, it: vp["key"] < bfs.INF_KEY, monkeypatch)
    assert d_vis[6] == 4
    monkeypatch.undo()
    monkeypatch.setenv("GRAPHMAT_KERNEL", "v2")   # the push ignores it
    d_push, _, _ = _run_bfs_fast(
        lambda self, state, vp, it: vp["key"] < bfs.INF_KEY, monkeypatch)
    assert d_push[6] == 3


# ------------------------------------------------------------ goldens

DIST = r"^(\d+) : distance = (\d+)$"


@pytest.mark.parametrize("app", ["bfs", "sssp", "incremental_pagerank",
                                 "delta_stepping", "topological_sort"])
def test_cli_matches_golden(app, route, monkeypatch):
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "cpu")
    mtx = fixture("test.bin.mtx")
    mod = "graphmat_tpu_torch.apps." + app
    if app == "bfs":
        ours = run_cli(mod, [mtx, "1"])
        pat = r"^Depth (\d+) : (\d+) parent"
        assert (re.findall(pat, ours, re.M)
                == re.findall(pat, gold("bfs_test_s1.txt"), re.M))
        assert "Reachable vertices = 8" in ours
    elif app == "sssp":
        assert (re.findall(DIST, run_cli(mod, [mtx, "1"]), re.M)
                == re.findall(DIST, gold("sssp_test_s1.txt"), re.M))
    elif app == "delta_stepping":
        ours = run_cli(mod, [mtx, "3", "1"])
        ref = gold("deltastepping_test_d3_s1.txt")
        assert re.findall(DIST, ours, re.M) == re.findall(DIST, ref, re.M)
        m = re.search(r"Number of buckets processed = (\d+)", ref)
        assert f"Number of buckets processed = {m[1]}" in ours
    elif app == "incremental_pagerank":
        pat = r"^(\d+) : (\d+) ([\d.]+)$"
        ref = {int(v): (int(d), float(p)) for v, d, p in
               re.findall(pat, gold("incpr_test.txt"), re.M)}
        ours = {int(v): (int(d), float(p)) for v, d, p in
                re.findall(pat, run_cli(mod, [mtx]), re.M)}
        assert len(ref) == 8 and set(ours) == set(ref)
        for v, (d, p) in ref.items():
            assert ours[v][0] == d and abs(ours[v][1] - p) < 5e-5
    else:
        pat = r"^Top Sort order (\d+) : (\d+)$"
        ours = run_cli(mod, [fixture("2_10_upper_triangle.bin.mtx")])
        assert (re.findall(pat, ours, re.M)
                == re.findall(pat, gold("toposort_2_10.txt"), re.M))


# ------------------------------------------- Graph, transforms, graph ops

def test_kernel_selector_validates(monkeypatch):
    monkeypatch.setenv("GRAPHMAT_KERNEL", "v2")
    assert legacy_kernel_env()
    monkeypatch.delenv("GRAPHMAT_KERNEL")
    assert not legacy_kernel_env()
    monkeypatch.setenv("GRAPHMAT_KERNEL", "v3u")
    with pytest.raises(ValueError, match="GRAPHMAT_KERNEL"):
        Engine(bfs.BFSProgram(), tgraph(weighted()))


def test_graph_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = weighted()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.Graph(e)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.Graph.from_numpy_state(e, None, {}, np.zeros(384, bool))
    assert gt.Graph(e, device="cpu").device.type == "cpu"


def test_apply_to_all_edges_refreshes_kernel_values(route, monkeypatch):
    """New edge values reach both kernels: every CSR the graph holds,
    the sender-major index the push built included, and their cached
    float32 copies."""
    e = weighted()
    g = tgraph(e, build_in_edges=False)
    sssp.run_sssp(g, 7)          # builds val_f32 (and, under v2, the index)
    g.init_vertexproperty(scale=np.arange(1, g.n + 1, dtype=np.int32) % 3)
    graph_ops.apply_to_all_edges(
        g, lambda s, d, v: v * (1 + s["scale"]) + d["scale"])
    scale = np.arange(1, g.n + 1) % 3
    e2 = gt.EdgeList(e.m, e.n, e.src, e.dst, (
        e.val * (1 + scale[e.src - 1]) + scale[e.dst - 1]).astype(e.val.dtype))
    want = sssp.run_sssp(tgraph(e2, build_in_edges=False), 7)
    for r in ("v2u", "v2"):
        monkeypatch.setenv("GRAPHMAT_KERNEL", r)
        np.testing.assert_array_equal(sssp.run_sssp(g, 7)[0], want[0])
    want_j = gj.Graph(e, permute="degree")
    want_j.init_vertexproperty(scale=scale.astype(np.int32))
    jops.apply_to_all_edges(
        want_j, lambda s, d, v: v * (1 + s["scale"]) + d["scale"])
    gb = tgraph(e, permute="degree")
    gb.init_vertexproperty(scale=scale.astype(np.int32))
    graph_ops.apply_to_all_edges(
        gb, lambda s, d, v: v * (1 + s["scale"]) + d["scale"])
    a, b = gb.get_edges(), want_j.get_edges()
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.val, b.val)):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_vertex_ops_match_jax():
    e = weighted()
    gjx, gtx = gj.Graph(e, permute="degree"), tgraph(e, permute="degree")
    vals = np.arange(gjx.n, dtype=np.float32) - 100
    for g, ops in ((gjx, jops), (gtx, graph_ops)):
        g.init_vertexproperty(a=vals, b=np.int32(2))
        ops.apply_to_all_vertices(g, lambda vp: {"a": vp["a"] * 2,
                                                 "b": vp["b"] + 1})
    for k in ("a", "b"):
        np.testing.assert_array_equal(gtx.vp_numpy()[k], gjx.vp_numpy()[k])
    for red in ("sum", "min", "max"):
        np.testing.assert_array_equal(
            graph_ops.apply_reduce_all_vertices(gtx, lambda vp: vp["a"], red),
            jops.apply_reduce_all_vertices(gjx, lambda vp: vp["a"], red))
    both = graph_ops.apply_reduce_all_vertices(
        gtx, lambda vp: vp, {"a": "max", "b": "sum"})
    assert both["a"] == vals.max() * 2 and both["b"] == 3 * gtx.n
    assert graph_ops.apply_reduce_all_vertices(
        gtx, lambda vp: vp["b"], lambda x, y: np.maximum(x, y)) == 3


def test_graph_api_matches_jax():
    e = weighted()
    gjx, gtx = gj.Graph(e, permute="degree"), tgraph(e, permute="degree")
    assert gtx.nvertices == gjx.nvertices
    rng = np.random.default_rng(1)
    mask = rng.random(gjx.n) < 0.3
    for g in (gjx, gtx):
        g.set_active_mask(mask)
        g.set_inactive(int(np.flatnonzero(mask)[0]) + 1)
    np.testing.assert_array_equal(gtx.active.numpy(), np.asarray(gjx.active))
    gtx.set_all_inactive()
    assert not bool(gtx.active.any())
    a, b = gtx.get_edges(), gjx.get_edges()
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.val, b.val)):
        np.testing.assert_array_equal(x, y)
    # two graphs over one store, as DeltaStepping's light and heavy
    heavy = tgraph(ttr.filter_edges(e, lambda s, d, v: v > 10),
                   permute=gtx.perm.numpy())
    heavy.share_vertex_property(gtx)
    gtx.set_all_vertexproperty(d=np.int32(5))
    heavy.set_vertexproperty(3, d=7)
    assert gtx.get_vertexproperty(3)["d"] == 7
    with pytest.raises(ValueError, match="permutation"):
        tgraph(e).share_vertex_property(gtx)
    with pytest.raises(ValueError, match="entries"):
        gtx.set_active_mask(mask[:-1])


@pytest.mark.parametrize("as_torch", [False, True])
def test_transforms_match_jax(as_torch):
    e = random_edgelist(200, 3, seed=12, weight_range=9)
    te = (gt.EdgeList(e.m, e.n, torch.from_numpy(e.src),
                      torch.from_numpy(e.dst), torch.from_numpy(e.val))
          if as_torch else e)
    cases = [
        (ttr.create_bidirectional_edges(te),
         jtr.create_bidirectional_edges(e)),
        (ttr.convert_to_dag(te), jtr.convert_to_dag(e)),
        (ttr.convert_to_upper_triangular(te),
         jtr.convert_to_upper_triangular(e)),
        (ttr.random_edge_weights(te, 7, seed=2),
         jtr.random_edge_weights(e, 7, seed=2)),
        (ttr.unit_edge_weights(te), jtr.unit_edge_weights(e)),
        (ttr.filter_edges(te, lambda s, d, v: v <= 4),
         jtr.filter_edges(e, lambda s, d, v: v <= 4)),
    ]
    for ours, want in cases:
        assert (ours.m, ours.n) == (want.m, want.n)
        for a, b in ((ours.src, want.src), (ours.dst, want.dst),
                     (ours.val, want.val)):
            a = a.numpy() if as_torch else a
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
