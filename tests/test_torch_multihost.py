"""The port's ``ProcessMesh`` across 4 gloo processes (the reference CI's
``mpirun -np 4``), started once for the file by the environment
``torchrun`` sets, against a ``LocalMesh`` of 2x2 CPU tiles in this
process on the same edges: PageRank (1e-6: float32 sums, the tiles'
partials reduced in another order), BFS (exact), a generic ⊕ (min-plus
SSSP and a gcd map-reduce, exact), SGD (1e-6), the
rank-strided ingest and its all-gather, the CLI's ``build_graph`` under
``GRAPHMAT_MESH=2x2``, and the sharded checkpoints the ranks wrote,
restored here onto other meshes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps.bfs import run_bfs
from graphmat_tpu_torch.apps.pagerank import run_pagerank
from graphmat_tpu_torch.apps.sgd import run_sgd
from graphmat_tpu_torch.parallel.dist_graph import DistGraph
from graphmat_tpu_torch.parallel.mesh import LocalMesh
from graphmat_tpu_torch.utils.checkpoint import load_graph_state
from graphmat_tpu_torch.utils.checkpoint_dist import load_sharded_state
from graphmat_tpu_torch.utils.generators import rmat_edgelist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATINGS = os.path.join(ROOT, "data", "ratings7.bin.mtx")
WORLD = 4
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the 4 ranks once; their results and output directory."""
    tmp = tmp_path_factory.mktemp("torch_multihost")
    e = rmat_edgelist(9, 8, seed=3, device="cpu")
    prefix = str(tmp / "edges")
    gt.write_edgelist(e, prefix, binaryformat=False, nshards=6)
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank % 2), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        env.pop("GRAPHMAT_MESH", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "torch_multihost_worker.py"),
             prefix, RATINGS, str(tmp)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        assert p.returncode == 0, f"rank {rank}:\n{logs[rank][-4000:]}"
    return dict(np.load(tmp / "results.npz")), tmp, e


def _local(e, **kw):
    return DistGraph(e, LocalMesh(["cpu"] * 4, (2, 2)), seg_align=8, **kw)


def test_ingest_strided_and_gathered(ranks):
    out, _, e = ranks
    # 6 shards over 4 ranks: ranks 0 and 1 read two each
    assert out["mine_nnz"].sum() == e.nnz
    assert sorted(zip(out["e_src"].tolist(), out["e_dst"].tolist(),
                      out["e_val"].tolist())) == sorted(zip(
                          e.src.tolist(), e.dst.tolist(), e.val.tolist()))
    # DistGraph.get_edges on a ProcessMesh: every rank gets every edge
    assert out["edges"].tolist() == sorted(
        [s, d] for s, d in zip(e.src.tolist(), e.dst.tolist()))


def test_pagerank_equals_local_mesh(ranks):
    out, _, e = ranks
    g = _local(e, permute="degree")
    np.testing.assert_array_equal(out["perm"], g.perm.numpy())
    pr, it = run_pagerank(g)
    assert int(out["pr_iters"]) == it
    np.testing.assert_allclose(out["pr"], pr, rtol=1e-6, atol=1e-7)


def test_bfs_equals_local_mesh(ranks):
    out, _, e = ranks
    d, p, it = run_bfs(_local(e, build_in_edges=False), 1)
    np.testing.assert_array_equal(out["bfs_depth"], d)
    np.testing.assert_array_equal(out["bfs_parent"], p)
    assert int(out["bfs_iters"]) == it


def test_generic_monoid_equals_local_mesh(ranks):
    """A generic ⊕ on the ProcessMesh (min-plus SSSP, a gcd map-reduce)
    gives the LocalMesh's results exactly, and the kernel route's
    distances (BFS depths: every weight is 1)."""
    from torch_multihost_worker import run_generic
    out, _, e = ranks
    it, dist, gcd = run_generic(_local(e, build_in_edges=False))
    assert int(out["generic_iters"]) == it
    np.testing.assert_array_equal(out["generic_dist"], dist)
    np.testing.assert_array_equal(out["generic_dist"], out["bfs_depth"])
    assert int(out["generic_gcd"]) == int(gcd) == 6


def test_sgd_equals_local_mesh(ranks):
    out, _, _ = ranks
    lv, r0, r1 = run_sgd(_local(gt.load_edgelist(RATINGS)), k=8,
                         iterations=5)
    np.testing.assert_allclose(out["sgd_lv"], lv, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose([out["sgd_r0"], out["sgd_r1"]], [r0, r1],
                               rtol=1e-6)


def test_cli_mesh_env_builds_process_mesh(ranks):
    out, _, e = ranks
    pr, it = run_pagerank(_local(e))
    assert int(out["cli_iters"]) == it
    np.testing.assert_allclose(out["cli_pr"], pr, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("target", ["graph", "1x1", "2x2", "2x4"])
def test_checkpoints_restore_on_other_meshes(ranks, target):
    """The sharded checkpoint (each rank wrote its segment) and the npz
    state restore onto one device and onto other meshes."""
    out, tmp, e = ranks
    for load, name in ((load_sharded_state, "ckpt"),
                       (load_graph_state, "state")):
        if target == "graph":
            g = gt.Graph(e, device="cpu")
        else:
            r, c = (int(x) for x in target.split("x"))
            g = DistGraph(e, LocalMesh(["cpu"] * (r * c), (r, c)),
                          seg_align=8)
        load(g, str(tmp / name))
        np.testing.assert_array_equal(g.vp_numpy()["pagerank"], out["pr"])
        assert g.active_numpy().all()
