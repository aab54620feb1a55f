"""The port's twin of the repository's entry points (``__graft_entry__.py``).

* :func:`entry`: one PageRank iteration (send, generalized SpMV, apply)
  on the RMAT-10 x 8, seed 1 graph, as a step function and its tensors.
  The step computes what the JAX package's step computes
  (``__graft_entry__.py:16-44``); its sum is K1's dense sum
  (:func:`graphmat_tpu_torch.ops.spmv2u.spmv`) on the card and K1's
  plain version on the CPU, and a vertex with an in-edge takes the new
  value.
* :func:`dryrun_multichip`: the checks of the JAX package's multi-chip dry
  run (``__graft_entry__.py:96-263``) on ``factor2d(n)`` tiles of a
  :class:`~graphmat_tpu_torch.parallel.mesh.LocalMesh`, all on one
  device: the degree pass and a PageRank step, BFS to convergence (on K1
  and on the push), SGD at K = 8 and K = 40, a checkpoint saved on the
  n-tile mesh and loaded onto an n/2-tile one, K1 on a compacted CSR
  bitwise the uncompacted one, and BFS on a compacted DistGraph in the
  uncompacted run's steps and depths.  The JAX dry run's segmented v2u
  plan is a layout of the TPU's scalar memory and has no counterpart.
  On the card the run launches K1, K2, K3 and the push.

Both run on the card unless the caller asks for the CPU::

    python -m graphmat_tpu_torch.graft_entry
    GRAPHMAT_PLATFORM=cpu python -m graphmat_tpu_torch.graft_entry
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np
import torch

__all__ = ["entry", "pagerank_step", "pagerank_step_reference",
           "dryrun_multichip"]

ALPHA = 0.3


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for the default "
                           "device='cuda'; pass device=\"cpu\" to run on "
                           "the CPU")
    return dev


def _step(pagerank, degree, csr, spmv_fn):
    msg = torch.where(degree == 0, torch.zeros_like(pagerank),
                      pagerank / degree.clamp(min=1))
    s = spmv_fn(csr, msg, "sum", "x")
    return torch.where(csr.got_static, ALPHA + (1 - ALPHA) * s, pagerank)


def pagerank_step(pagerank, degree, csr):
    """One PageRank iteration over the receiver CSR ``csr``: K1's dense
    sum of ``pagerank / degree`` (0 where the degree is 0), then
    ``0.3 + 0.7 * sum`` where a receiver has an in-edge."""
    from .ops.spmv2u import spmv
    return _step(pagerank, degree, csr, spmv)


def pagerank_step_reference(pagerank, degree, csr):
    """:func:`pagerank_step` through K1's plain version."""
    from .ops.spmv2u import spmv_reference
    return _step(pagerank, degree, csr, spmv_reference)


def entry(device="cuda"):
    """``(pagerank_step, (pagerank, degree, csr))`` on the RMAT-10 x 8,
    seed 1 graph (the JAX entry's), on ``device``: pagerank 0.3 at every
    padded vertex, each vertex's out-degree as float32, the receiver=dst
    CSR."""
    from .core.graph import Graph
    from .utils.generators import rmat_edgelist
    dev = _device(device)
    e = rmat_edgelist(10, 8, seed=1, device=dev)
    g = Graph(e, build_in_edges=False, device=dev)
    deg = torch.bincount(e.src.long() - 1, minlength=g.n_pad)[:g.n_pad]
    args = (torch.full((g.n_pad,), 0.3, dtype=torch.float32, device=dev),
            deg.to(torch.float32), g.csr("dst"))
    return pagerank_step, args


@contextlib.contextmanager
def _kernel_route(route: str):
    """Engines built inside take ``GRAPHMAT_KERNEL=route``."""
    old = os.environ.get("GRAPHMAT_KERNEL")
    os.environ["GRAPHMAT_KERNEL"] = route
    try:
        yield
    finally:
        if old is None:
            del os.environ["GRAPHMAT_KERNEL"]
        else:
            os.environ["GRAPHMAT_KERNEL"] = old


# compaction parameters that divert edges on these tiny graphs, on one
# device and on tiles of 64 senders (the JAX dry run shrinks its windows
# likewise)
_COMPACT_KW = dict(wr=256, hub=16, divert_min=40, bpsb=2, w_div=1)
_TILE_COMPACT_KW = dict(wr=256, hub=8, divert_min=10_000, bpsb=2, w_div=1)


def _bfs(graph, route="v2u"):
    """BFS from vertex 1 to convergence: (steps, depths in original
    order)."""
    from .apps.bfs import BFSProgram, init_bfs_graph
    from .parallel.dist_runtime import DistEngine
    init_bfs_graph(graph, 1)
    with _kernel_route(route):
        eng = DistEngine(BFSProgram(), graph)
    return eng.run(), graph.vp_numpy()["depth"]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The JAX dry run's checks on ``n_devices`` tiles of a LocalMesh on
    ``device`` (the card by default); raises AssertionError on the first
    that fails."""
    from .apps.pagerank import DegreeProgram, PageRankProgram
    from .apps.sgd import SGDProgram
    from .core.graph import Graph
    from .ops.spmv2u import spmv
    from .parallel.dist_graph import DistGraph
    from .parallel.dist_runtime import DistEngine
    from .parallel.mesh import LocalMesh, factor2d
    from .utils.checkpoint import load_graph_state, save_graph_state
    from .utils.generators import rmat_edgelist
    from .utils.reference_rng import rand_r_uniform_np

    dev = _device(device)
    shape = factor2d(n_devices)
    mesh = LocalMesh([dev] * n_devices, shape)
    e = rmat_edgelist(7, 4, seed=2, weight_range=5, device=dev)

    # PageRank: the degree pass and one step, 2D-sharded
    g = DistGraph(e, mesh, seg_align=8)
    g.init_vertexproperty(pagerank=np.float32(0.3), degree=np.int32(0))
    g.set_all_active()
    DistEngine(DegreeProgram(), g).run(iterations=1)
    DistEngine(PageRankProgram(), g).run(iterations=1)
    assert np.isfinite(g.vp_numpy()["pagerank"]).all()

    # BFS: the min route with its frontier, to convergence, on K1 and on
    # the push (GRAPHMAT_KERNEL=v2): the same steps and depths
    gb = DistGraph(e, mesh, seg_align=8, build_in_edges=False)
    it, depth = _bfs(gb)
    assert it >= 1 and depth[0] == 0
    it_push, depth_push = _bfs(gb, "v2")
    assert it_push == it and (depth_push == depth).all()

    # SGD: the K-wide step (ALL_EDGES, the receivers' factors gathered
    # along 'c') at K = 8 and K = 40
    for k in (8, 40):
        g2 = DistGraph(e, mesh, seg_align=8)
        lv = rand_r_uniform_np(np.arange(1, g2.n + 1, dtype=np.uint32),
                               k).astype(np.float32)
        g2.init_vertexproperty(lv=lv, sqerr=np.float32(0))
        DistEngine(SGDProgram(step=0.001, k=k), g2).run(iterations=1)
        assert np.isfinite(g2.vp_numpy()["lv"]).all()

    # a checkpoint saved on this mesh and loaded onto one of half the
    # tiles
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "state")
        save_graph_state(gb, path)
        half = max(n_devices // 2, 1)
        alt = LocalMesh([dev] * half, factor2d(half))
        gb2 = DistGraph(e, alt, seg_align=8, build_in_edges=False)
        load_graph_state(gb2, path)
        assert (gb2.vp_numpy()["depth"] == depth).all()

    # K1 on a compacted CSR: bitwise the uncompacted one
    eb = rmat_edgelist(9, 4, seed=3, device=dev)
    on, off = (Graph(eb, build_in_edges=False, device=dev, compact=c,
                     compact_kw=_COMPACT_KW if c else None).csr("dst")
               for c in (True, False))
    assert on.src_of_pos is not None, "compaction diverted no edge"
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    xs = torch.rand(on.n_send, generator=gen, device=dev)
    assert torch.equal(spmv(on, xs, "sum", "x").view(torch.int32),
                       spmv(off, xs, "sum", "x").view(torch.int32))

    # BFS on a compacted DistGraph: the uncompacted run's steps and depths
    gd = DistGraph(e, mesh, seg_align=8, build_in_edges=False,
                   compact=True, compact_kw=_TILE_COMPACT_KW)
    assert any(c.src_of_pos is not None for c in gd.csrs("dst")), \
        "per-tile compaction diverted no edge"
    itc, depth_c = _bfs(gd)
    assert itc == it and (depth_c == depth).all(), \
        "compacted dist BFS diverges from the uncompacted run"
    print(f"dryrun_multichip OK on a {shape[0]}x{shape[1]} mesh of {dev} "
          "tiles (PageRank sum + BFS min until convergence on K1 and the "
          "push + SGD K=8 and K=40 + cross-mesh checkpoint + K1 compacted "
          "single-device and per tile on the mesh)")


if __name__ == "__main__":
    from .apps._cli import device_from_env
    device = device_from_env()
    fn, args = entry(device)
    out = fn(*args)
    print("entry() ran:", tuple(out.shape), out.dtype, out.device)
    dryrun_multichip(8, device)
