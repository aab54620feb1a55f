"""One rank of ``test_torch_multihost.py``: a process of a 2x2
``ProcessMesh`` over gloo, started with the environment ``torchrun``
sets (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
MASTER_PORT).  It never imports JAX.

Usage: torch_multihost_worker.py <shard prefix> <ratings file> <outdir>

Rank 0 writes ``<outdir>/results.npz``; every rank writes its share of a
sharded checkpoint under ``<outdir>/ckpt`` and rank 0 an npz state.
"""

import os
import sys

import numpy as np


def run_generic(g):
    """SSSP from vertex 1 with its min as a generic Monoid, and the gcd of
    6 * (distance + 1), both over ``g``: (steps, distances, gcd)."""
    import torch
    from graphmat_tpu_torch.apps.sssp import SSSPProgram, init_sssp_graph
    from graphmat_tpu_torch.core.runtime import engine_for
    from graphmat_tpu_torch.core.types import Monoid
    from graphmat_tpu_torch.parallel.dist_graph_ops import \
        apply_reduce_all_vertices

    class GenericSSSP(SSSPProgram):
        reduce = Monoid("generic", torch.minimum,
                        lambda dt: torch.iinfo(dt).max)
    init_sssp_graph(g, 1)
    it = engine_for(GenericSSSP(), g).run()
    gcd = apply_reduce_all_vertices(
        g, lambda vp: (vp["distance"].clamp(max=999) + 1) * 6,
        Monoid("generic", torch.gcd, lambda dt: 0))
    return it, g.vp_numpy()["distance"], gcd


def main() -> int:
    prefix, ratings, outdir = sys.argv[1:4]
    import graphmat_tpu_torch as gt
    from graphmat_tpu_torch.apps._cli import build_graph
    from graphmat_tpu_torch.apps.bfs import run_bfs
    from graphmat_tpu_torch.apps.pagerank import run_pagerank
    from graphmat_tpu_torch.apps.sgd import run_sgd
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import ProcessMesh
    from graphmat_tpu_torch.parallel.multihost import (allgather_edgelist,
                                                       hosts_mesh,
                                                       initialize,
                                                       load_edgelist_sharded)
    from graphmat_tpu_torch.utils.checkpoint import save_graph_state
    from graphmat_tpu_torch.utils.checkpoint_dist import save_sharded_state

    dev = initialize(device="cpu")
    import torch.distributed as dist
    rank = dist.get_rank()
    mesh = hosts_mesh(device=dev)   # 2 hosts of 2 processes: 2x2
    assert isinstance(mesh, ProcessMesh) and mesh.shape == (2, 2)
    out = {}

    # rank-strided ingest, then the union on every rank
    mine = load_edgelist_sharded(prefix, binaryformat=False)
    e = allgather_edgelist(mine)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, mine.nnz)
    out["mine_nnz"] = np.array(counts)
    out["e_src"], out["e_dst"], out["e_val"] = e.src, e.dst, e.val

    g = DistGraph(e, mesh, seg_align=8, permute="degree")
    out["pr"], out["pr_iters"] = run_pagerank(g)
    save_sharded_state(g, os.path.join(outdir, "ckpt"))
    save_graph_state(g, os.path.join(outdir, "state"))
    out["perm"] = g.perm.numpy()
    out["edges"] = np.array(sorted(zip(*(a.tolist() for a in (
        g.get_edges().src, g.get_edges().dst)))))

    gb = DistGraph(e, mesh, seg_align=8, build_in_edges=False)
    out["bfs_depth"], out["bfs_parent"], out["bfs_iters"] = run_bfs(gb, 1)

    # a generic ⊕: min-plus, its partials folded after one all_to_all
    # along 'c', and a gcd map-reduce
    out["generic_iters"], out["generic_dist"], out["generic_gcd"] = \
        run_generic(gb)

    er = gt.load_edgelist(ratings)
    gs = DistGraph(er, mesh, seg_align=8)
    out["sgd_lv"], out["sgd_r0"], out["sgd_r1"] = run_sgd(gs, k=8,
                                                          iterations=5)

    # the CLI's graph under GRAPHMAT_MESH=2x2 and torchrun's environment
    os.environ["GRAPHMAT_MESH"] = "2x2"
    os.environ["GRAPHMAT_PLATFORM"] = "cpu"
    gc = build_graph(e, seg_align=8)
    assert isinstance(gc, DistGraph) and gc.mesh.shape == (2, 2)
    out["cli_pr"], out["cli_iters"] = run_pagerank(gc)

    if rank == 0:
        np.savez(os.path.join(outdir, "results.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
