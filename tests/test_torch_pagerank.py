"""The port's main path, PageRank from an edge list, against the JAX
package (its CPU Engine, the XLA path) and the reference binary's golden
output.  Tolerances: 2e-5 on data/test.bin.mtx (the golden file prints 6
decimals), 1e-5 after 20 iterations on RMAT (float32 sums in other
orders), 1e-6 for one step from a carried-over state."""

import os
import re

import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import pagerank as jpr
from graphmat_tpu.core.runtime import Engine as JEngine

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import pagerank as tpr
from graphmat_tpu_torch.apps import _cli
from graphmat_tpu_torch.core.runtime import Engine as TEngine
from graphmat_tpu_torch.utils.generators import rmat_edgelist

from test_golden import fixture, gold, run_cli

TEST_MTX = fixture("test.bin.mtx")
# compaction forced on at scale 10: no sender reaches the default hub
SMALL_COMPACT = dict(wr=256, hub=16, divert_min=40, bpsb=2, w_div=1)


def rmat_numpy(scale=10):
    """A seeded RMAT, built once as a numpy EdgeList for both packages."""
    e = rmat_edgelist(scale, 16, seed=5, device="cpu")
    return gt.EdgeList(e.m, e.n, e.src.numpy(), e.dst.numpy(),
                       e.val.numpy())


def test_pagerank_matches_jax_on_test_mtx():
    e = gt.load_edgelist(TEST_MTX)
    pr_t, it_t = tpr.run_pagerank(gt.Graph(e, device="cpu"))
    pr_j, it_j = jpr.run_pagerank(gj.Graph(gj.load_edgelist(TEST_MTX)))
    assert it_t == it_j == 6
    np.testing.assert_allclose(pr_t, np.asarray(pr_j), rtol=0, atol=2e-5)


def test_cli_matches_golden(monkeypatch):
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "cpu")
    monkeypatch.delenv("GRAPHMAT_MESH", raising=False)
    ours = run_cli("graphmat_tpu_torch.apps.pagerank", [TEST_MTX])
    ref = gold("pagerank_test.txt")
    ref_vals = {int(m[0]): float(m[2]) for m in re.findall(
        r"^(\d+) : (\d+) ([\d.]+)$", ref, re.M)}
    our_vals = {int(m[0]): float(m[1]) for m in re.findall(
        r"^(\d+) : ([\d.]+)$", ours, re.M)}
    assert len(ref_vals) == 8 and set(our_vals) == set(ref_vals)
    for v, pr in ref_vals.items():
        assert abs(our_vals[v] - pr) < 2e-5, (v, our_vals[v], pr)
    assert "Completed 6 iterations" in ours
    assert re.search(r"^Time = [\d.]+ ms$", ours, re.M)


_JAX_RMAT = {}


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("permute", [False, "degree"])
def test_pagerank_matches_jax_on_rmat(permute, compact):
    e = rmat_numpy()
    if permute not in _JAX_RMAT:
        _JAX_RMAT[permute] = np.asarray(jpr.run_pagerank(
            gj.Graph(e, permute=permute), iterations=20)[0])
    g = gt.Graph(e, permute=permute, compact=compact,
                 compact_kw=SMALL_COMPACT if compact else None,
                 device="cpu")
    assert all((g.csr(r).src_of_pos is not None) == compact
               for r in ("dst", "src"))
    pr, it = tpr.run_pagerank(g, iterations=20)
    assert it == 20
    np.testing.assert_allclose(pr, _JAX_RMAT[permute], rtol=0, atol=1e-5)


def _degree_done_jax_graph(e, permute):
    g = gj.Graph(e, permute=permute)
    jpr.init_pagerank_graph(g)
    g.set_all_active()
    JEngine(jpr.DegreeProgram(), g).run(iterations=1)
    return g


def _carry_over(gjx, e):
    return gt.Graph.from_numpy_state(
        e, gjx.perm, gjx.vp_numpy(), np.asarray(gjx.active), device="cpu")


@pytest.mark.parametrize("permute", [False, "degree"])
def test_from_numpy_state_then_pagerank_step_matches_jax(permute):
    e = rmat_numpy()
    gjx = _degree_done_jax_graph(e, permute)
    JEngine(jpr.PageRankProgram(), gjx).step_once()   # a live pagerank
    gtx = _carry_over(gjx, e)
    for k, v in gjx.vp_numpy().items():
        np.testing.assert_array_equal(gtx.vp_numpy()[k], v)
    _, conv_t = TEngine(tpr.PageRankProgram(), gtx).step_once()
    _, conv_j = JEngine(jpr.PageRankProgram(), gjx).step_once()
    assert conv_t == conv_j
    np.testing.assert_allclose(gtx.vp_numpy()["pagerank"],
                               gjx.vp_numpy()["pagerank"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gtx.active.numpy(),
                                  np.asarray(gjx.active))


def test_from_numpy_state_then_sparse_step_matches_jax():
    """ACTIVE_ONLY sum from a partial frontier: the sparse-with-got SpMV
    against JAX's XLA path, active mask included."""
    e = rmat_numpy()
    gjx = gj.Graph(e, permute="degree")
    gjx.init_vertexproperty(degree=np.array(-1, np.int32))
    mask = np.random.default_rng(3).random(gjx.n) < 0.2
    gjx.set_active_mask(mask)
    gtx = _carry_over(gjx, e)
    TEngine(tpr.DegreeProgram(), gtx).step_once()
    JEngine(jpr.DegreeProgram(), gjx).step_once()
    np.testing.assert_array_equal(gtx.vp_numpy()["degree"],
                                  gjx.vp_numpy()["degree"])
    np.testing.assert_array_equal(gtx.active.numpy(),
                                  np.asarray(gjx.active))


class _SegmentDegree(tpr.DegreeProgram):
    def semiring(self):
        return None


class _SegmentPageRank(tpr.PageRankProgram):
    def semiring(self):
        return None


@pytest.mark.parametrize("permute", [False, "degree"])
def test_segment_path_equals_semiring_path(permute):
    e = rmat_numpy()
    out = {}
    for name, (deg, pr) in {
            "kernel": (tpr.DegreeProgram, tpr.PageRankProgram),
            "segment": (_SegmentDegree, _SegmentPageRank)}.items():
        g = gt.Graph(e, permute=permute, device="cpu")
        tpr.init_pagerank_graph(g)
        g.set_all_active()
        TEngine(deg(), g).run(iterations=1)
        it = TEngine(pr(), g).run()
        out[name] = (it, g.vp_numpy())
    assert out["kernel"][0] == out["segment"][0]
    np.testing.assert_array_equal(out["kernel"][1]["degree"],
                                  out["segment"][1]["degree"])
    np.testing.assert_allclose(out["kernel"][1]["pagerank"],
                               out["segment"][1]["pagerank"], rtol=0,
                               atol=1e-5)


def test_vertex_api_matches_jax():
    e = rmat_numpy(8)
    gjx = gj.Graph(e, permute="degree")
    gtx = gt.Graph(e, permute="degree", device="cpu")
    np.testing.assert_array_equal(gtx.perm.numpy(), gjx.perm)
    assert (gtx.n, gtx.n_pad) == (gjx.n, gjx.n_pad)
    np.testing.assert_array_equal(gtx.valid_vertex.numpy(),
                                  np.asarray(gjx.valid_vertex))
    vals = np.arange(gjx.n, dtype=np.float32)
    for g in (gjx, gtx):
        g.init_vertexproperty(a=vals, b=np.array(7, np.int32))
        g.set_vertexproperty(5, a=-1.0)
        g.set_active(5)
    assert float(gtx.get_vertexproperty(5)["a"]) == -1.0
    for k in ("a", "b"):
        np.testing.assert_array_equal(gtx.vp_numpy()[k], gjx.vp_numpy()[k])
    np.testing.assert_array_equal(gtx.active.numpy(), np.asarray(gjx.active))
    g_rand_t = gt.Graph(e, permute=True, device="cpu")
    np.testing.assert_array_equal(g_rand_t.perm.numpy(),
                                  gj.Graph(e, permute=True).perm)


def test_engine_for_rejects_other_graphs():
    # a Graph gets an Engine and a DistGraph a DistEngine
    # (tests/test_torch_dist.py); anything else raises
    with pytest.raises(TypeError, match="a Graph or a DistGraph"):
        gt.engine_for(tpr.PageRankProgram(), object())


def test_cli_platform_and_mesh(monkeypatch):
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "cpu")
    assert _cli.device_from_env() == torch.device("cpu")
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        _cli.device_from_env()
    monkeypatch.delenv("GRAPHMAT_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GRAPHMAT_PLATFORM=cpu"):
        _cli.device_from_env()
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "cpu")
    monkeypatch.setenv("GRAPHMAT_MESH", "2x4")
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    g = _cli.build_graph(gt.load_edgelist(TEST_MTX))
    assert isinstance(g, DistGraph) and g.mesh.shape == (2, 4)
    assert all(d.type == "cpu" for d in g.devices)
    monkeypatch.setenv("GRAPHMAT_MESH", "2by4")
    with pytest.raises(ValueError, match="GRAPHMAT_MESH"):
        _cli.build_graph(gt.load_edgelist(TEST_MTX))
