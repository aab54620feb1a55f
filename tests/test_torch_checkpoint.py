"""Checkpoints of the port (``graphmat_tpu_torch.utils.checkpoint`` and
``checkpoint_dist``): the npz format is the JAX package's, so a file
written by either package loads into the other; a state saved on a 2x4
``LocalMesh`` restores onto 1x1, 2x2 and a one-device Graph; the
``torch.distributed.checkpoint`` round trip works across mesh shapes and
vertex permutations.  Everything is exact.
"""

import numpy as np
import pytest

from graphmat_tpu import Graph as JGraph
from graphmat_tpu.apps.pagerank import run_pagerank as jrun_pagerank
from graphmat_tpu.utils import checkpoint as jck
from graphmat_tpu.utils.generators import random_edgelist

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps.pagerank import run_pagerank
from graphmat_tpu_torch.apps.sgd import init_sgd_graph
from graphmat_tpu_torch.parallel.dist_graph import DistGraph
from graphmat_tpu_torch.parallel.mesh import LocalMesh
from graphmat_tpu_torch.utils import checkpoint as ck
from graphmat_tpu_torch.utils.checkpoint_dist import (load_sharded_state,
                                                      save_sharded_state)


def port_edges(e):
    return gt.EdgeList(e.m, e.n, np.asarray(e.src), np.asarray(e.dst),
                       np.asarray(e.val))


def _dist(e, shape, **kw):
    return DistGraph(port_edges(e), LocalMesh(["cpu"] * (shape[0] * shape[1]),
                                              shape), seg_align=8, **kw)


def _target(e, name):
    if name == "graph":
        return gt.Graph(port_edges(e), device="cpu")
    if name == "graph_degree":
        return gt.Graph(port_edges(e), device="cpu", permute="degree")
    r, c, *perm = name.split("x")
    return _dist(e, (int(r), int(c)),
                 permute=perm[0] if perm else False)


@pytest.fixture(scope="module")
def source():
    """A 2x4 permuted DistGraph after PageRank, with vector properties
    and a frontier of every third vertex."""
    e = random_edgelist(150, 4, seed=21)
    g = _dist(e, (2, 4), permute=True)
    pr, _ = run_pagerank(g)
    init_sgd_graph(g, k=3)
    g.init_vertexproperty(pagerank=pr, lv=g.vp_numpy()["lv"])
    mask = np.arange(g.n) % 3 == 0
    g.set_active_mask(mask)
    return e, g, {"pagerank": pr, "lv": g.vp_numpy()["lv"]}, mask


def _check(g, vp, mask):
    got = g.vp_numpy()
    assert set(got) == set(vp)
    for k in vp:
        np.testing.assert_array_equal(got[k], vp[k], err_msg=k)
    np.testing.assert_array_equal(g.active_numpy(), mask)


@pytest.mark.parametrize("target", ["graph", "graph_degree", "1x1", "2x2",
                                    "2x4xTrue"])
def test_npz_state_across_meshes(source, target, tmp_path):
    e, g, vp, mask = source
    ck.save_graph_state(g, str(tmp_path / "st"))
    t = _target(e, target)
    ck.load_graph_state(t, str(tmp_path / "st"))
    _check(t, vp, mask)


@pytest.mark.parametrize("target", ["graph", "graph_degree", "1x1", "2x2",
                                    "2x4xTrue", "2x4xdegree"])
def test_dcp_state_across_meshes(source, target, tmp_path):
    """The sharded checkpoint restores onto another mesh or permutation
    (through original order) and onto its own layout (segment by
    segment)."""
    e, g, vp, mask = source
    save_sharded_state(g, str(tmp_path / "ck"))
    t = _target(e, target)
    load_sharded_state(t, str(tmp_path / "ck"))
    _check(t, vp, mask)


def test_dcp_same_layout_reads_segments(source, tmp_path):
    e, g, vp, mask = source
    save_sharded_state(g, str(tmp_path / "ck"))
    t = _target(e, "2x4xTrue")
    load_sharded_state(t, str(tmp_path / "ck"))
    for a, b in zip(t.vp, g.vp):   # pads restored as saved
        for k in b:
            assert a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())


def test_dcp_one_device_graph_round_trip(tmp_path):
    e = random_edgelist(80, 3, seed=2)
    g = gt.Graph(port_edges(e), device="cpu", permute="degree")
    pr, _ = run_pagerank(g)
    save_sharded_state(g, str(tmp_path / "ck"))
    for target in ("graph", "2x2"):
        t = _target(e, target)
        load_sharded_state(t, str(tmp_path / "ck"))
        np.testing.assert_array_equal(t.vp_numpy()["pagerank"], pr)


def test_jax_npz_loads_into_port(tmp_path):
    e = random_edgelist(70, 4, seed=8)
    jg = JGraph(e)
    pr, _ = jrun_pagerank(jg)
    jg.set_active_mask(np.arange(jg.n) % 2 == 1)
    jck.save_graph_state(jg, str(tmp_path / "st"))
    jck.save_edgelist_checkpoint(e, str(tmp_path / "el"))
    e2 = ck.load_edgelist_checkpoint(str(tmp_path / "el"))
    assert sorted(zip(e2.src.tolist(), e2.dst.tolist(), e2.val.tolist())) \
        == sorted(e.as_records())
    for target in ("graph", "2x4xTrue"):
        t = _target(e, target)
        ck.load_graph_state(t, str(tmp_path / "st"))
        np.testing.assert_array_equal(t.vp_numpy()["pagerank"],
                                      np.asarray(pr))
        np.testing.assert_array_equal(t.active_numpy(),
                                      np.arange(jg.n) % 2 == 1)


def test_port_npz_loads_into_jax(source, tmp_path):
    e, g, vp, mask = source
    ck.save_graph_state(g, str(tmp_path / "st"))
    ck.save_edgelist_checkpoint(port_edges(e), str(tmp_path / "el"))
    assert jck.load_edgelist_checkpoint(str(tmp_path / "el")).as_records() \
        == e.as_records()
    jg = JGraph(e)
    jck.load_graph_state(jg, str(tmp_path / "st"))
    np.testing.assert_array_equal(jg.vp_numpy()["pagerank"], vp["pagerank"])
    np.testing.assert_array_equal(jg.vp_numpy()["lv"], vp["lv"])
    np.testing.assert_array_equal(np.asarray(jg.active)[: jg.n], mask)


def test_save_vertexproperty_matches_jax(source, tmp_path):
    e, g, vp, _ = source
    jg = JGraph(e)
    jg.init_vertexproperty(pagerank=vp["pagerank"], lv=vp["lv"])
    for field in ("pagerank", "lv"):
        ck.save_vertexproperty(g, str(tmp_path / "ours.txt"), field)
        jck.save_vertexproperty(jg, str(tmp_path / "theirs.txt"), field)
        assert (tmp_path / "ours.txt").read_text() == \
            (tmp_path / "theirs.txt").read_text()


def test_wrong_vertex_count_raises(source, tmp_path):
    e, g, _, _ = source
    ck.save_graph_state(g, str(tmp_path / "st"))
    save_sharded_state(g, str(tmp_path / "ck"))
    other = gt.Graph(port_edges(random_edgelist(90, 3, seed=1)),
                     device="cpu")
    with pytest.raises(ValueError, match="vertices"):
        ck.load_graph_state(other, str(tmp_path / "st"))
    with pytest.raises(ValueError, match="vertices"):
        load_sharded_state(other, str(tmp_path / "ck"))
