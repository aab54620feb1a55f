"""Breadth-first search with parent tracking (reference: ``src/BFS.cpp``),
as in ``graphmat_tpu/apps/bfs.py``.

Level-synchronous BFS: active vertices whose depth equals
``current_depth - 1`` send their own id (``src/BFS.cpp:83-88``); an
unvisited receiver takes depth = current_depth and records the sender as
parent (``src/BFS.cpp:89-93``).  The reference's overwrite-reduce picks an
arbitrary parent; ⊕ = min makes the smallest sender id win, so depths are
the reference's and parents deterministic.  Ids travel as float32, exact
below 2^24 = 16,777,216 vertices.

Vertex property: ``depth`` (int32, INF sentinel), ``parent`` (int32, -1),
``id`` (int32, 1-based).  Program state: ``current_depth`` from 1.

``run_bfs_fast`` (whisker shortcuts and packed (depth, parent) keys; see
the comment above :func:`build_bfs_shortcuts`) runs the min kernel on
int32 key patterns with the ``key_add_val`` ⊗; it needs ``n_pad <= 2^21``.

Run as ``python -m graphmat_tpu_torch.apps.bfs A.mtx source``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import Graph
from ..core.program import GraphProgram, Semiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, ANY, UNTIL_CONVERGENCE
from ..io.edgelist import EdgeList
from ..ops.spmv2u import KEY_BIAS, KEY_SPAN
from ..utils.timing import traced

__all__ = ["BFSProgram", "BFSFastProgram", "run_bfs", "run_bfs_fast",
           "build_bfs_shortcuts", "init_bfs_graph", "init_bfs_fast_graph",
           "reachable_count", "INF_DEPTH", "INF_KEY", "KEY_BIAS"]

INF_DEPTH = np.iinfo(np.int32).max  # MAX_DIST analog (src/BFS.cpp:38)
# bit pattern 0x7F000000: a large positive float (~1.7e38) whose int value
# exceeds every valid key and stays below the NaN region
INF_KEY = 0x7F000000


class BFSProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = ANY  # overwrite-reduce; deterministic min-id winner
    process_requires_vertexprop = False

    def init_state(self, graph):
        return 1  # current_depth (src/BFS.cpp:70)

    def send_message(self, state, vp):
        return vp["id"], vp["depth"] == state - 1

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        unvisited = vp["depth"] == INF_DEPTH
        out = dict(vp)
        out["depth"] = torch.where(unvisited, state, vp["depth"])
        out["parent"] = torch.where(unvisited, reduced, vp["parent"])
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["depth"] != new_vp["depth"]

    def do_every_iteration(self, state, vp, it, ctx):
        return state + 1

    def receiver_final(self, state, vp, it):
        # apply() only ever touches unvisited vertices, so every visited
        # vertex is final
        return vp["depth"] != INF_DEPTH

    def semiring(self):
        # overwrite-reduce as min over sender ids (ids < 2^24)
        return Semiring(
            "min",
            encode=lambda msg: msg.to(torch.float32),
            decode=lambda y: torch.where(torch.isfinite(y), y,
                                         0.0).to(torch.int32),
            uses_edge_value=False)


@traced("app.init")
def init_bfs_graph(graph: Graph, source1: int) -> None:
    """Ids, infinite depths, then the 1-based source at depth 0; the ids
    are made on the graph's device."""
    graph.init_vertexproperty(
        depth=torch.tensor(INF_DEPTH, dtype=torch.int32),
        parent=torch.tensor(-1, dtype=torch.int32),
        id=torch.arange(1, graph.n + 1, dtype=torch.int32,
                        device=graph.device),
    )
    graph.set_all_inactive()
    graph.set_vertexproperty(source1, depth=0)
    graph.set_active(source1)


@traced("app.bfs")
def run_bfs(graph: Graph, source1: int,
            iterations: int = UNTIL_CONVERGENCE):
    """Returns ``(depth[n], parent[n], niter)`` as numpy in original
    order; an unreached depth is INF_DEPTH."""
    init_bfs_graph(graph, source1)
    niter = engine_for(BFSProgram(), graph).run(iterations=iterations)
    vp = graph.vp_numpy()
    return vp["depth"], vp["parent"], niter


def reachable_count(graph: Graph) -> int:
    """``applyReduceAllVertices(reachable_or_not)`` (src/BFS.cpp:100-106)."""
    return int((graph.vp_numpy()["depth"] < INF_DEPTH).sum())


# --------------------------------------------------------------- fast BFS
#
# The level loop takes ECCENTRICITY iterations, most of them walking
# low-degree whisker chains with tiny frontiers.  The fast path cuts the
# iteration count instead (graphmat_tpu/apps/bfs.py:104-130):
#
# * preprocessing (source-independent): every in-degree-1 vertex v has a
#   forced depth = depth(pred) + 1, so a weighted SHORTCUT edge
#   (a -> v, w = chain distance) from v's nearest in-degree != 1 ancestor
#   a reaches v the iteration after a;
# * one int32 key per vertex carries depth and parent:
#   ``key = KEY_BIAS + (depth << bits | parent_internal_id)``.
#   Non-negative int32 patterns order as float32, so the min kernel
#   performs the lexicographic (depth, parent) reduce; the ``key_add_val``
#   ⊗ adds the edge weight onto the depth field.  Requires
#   bits + log2(max depth) <= 28;
# * post-pass: a shortcut winner's recorded parent may be the chain's
#   anchor, but every shortcut target has in-degree 1, so its parent is
#   its unique predecessor, computed on the host.

def build_bfs_shortcuts(e: EdgeList, max_rounds: int = 64):
    """Returns ``(e_aug, pred0, is_indeg1)``: the original edges (weight 1)
    plus shortcut edges (a -> v, weight d) for in-degree-1 vertices v whose
    predecessor chain reaches an anchor (in-degree != 1) within
    ``max_rounds`` pointer-doubling rounds; ``pred0`` the 0-based unique
    predecessor (or -1).  Pure in-degree-1 cycles get no shortcut.  Numpy,
    on the host, as in the JAX package."""
    n = max(e.m, e.n)
    src0 = np.asarray(e.src.cpu() if isinstance(e.src, torch.Tensor)
                      else e.src, np.int64) - 1
    dst0 = np.asarray(e.dst.cpu() if isinstance(e.dst, torch.Tensor)
                      else e.dst, np.int64) - 1
    indeg = np.bincount(dst0, minlength=n)
    ind1 = indeg == 1
    pred0 = np.full(n, -1, np.int64)
    m1 = ind1[dst0]
    pred0[dst0[m1]] = src0[m1]    # unique, so the last write is THE pred

    # pointer doubling to the nearest anchor, path length accumulated;
    # pure in-degree-1 cycles never leave the interior and their doubled
    # distances blow past n, which excludes them below
    anchor = np.where(ind1, pred0, np.arange(n, dtype=np.int64))
    dist = np.where(ind1, 1, 0).astype(np.int64)
    for _ in range(max_rounds):
        interior = ind1 & ind1[anchor]
        if not interior.any():
            break
        dist = dist + np.where(interior, dist[anchor], 0)
        anchor = np.where(interior, anchor[anchor], anchor)
    ok = ind1 & ~ind1[anchor] & (dist >= 2) & (dist <= n)
    aug_src = np.concatenate([src0 + 1, anchor[ok] + 1])
    aug_dst = np.concatenate([dst0 + 1, np.flatnonzero(ok) + 1])
    aug_val = np.concatenate([np.ones(len(src0)),
                              dist[ok].astype(np.float64)])
    e_aug = EdgeList(src=aug_src, dst=aug_dst, val=aug_val, m=n, n=n)
    return e_aug, pred0, ind1


class BFSFastProgram(GraphProgram):
    """Weighted min-plus value iteration over packed (depth, parent)
    keys.  ``bits`` is the parent-id field width (>= ceil(log2 n_pad))."""
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = ANY
    process_requires_vertexprop = False

    def __init__(self, bits: int):
        # keys stay below KEY_BIAS + 2^28: depth_cap = 2^(28 - bits);
        # bits <= 21 keeps >= 128 levels of headroom
        if not 1 <= bits <= 21:
            raise ValueError(f"packed-key BFS supports n_pad <= 2^21 (got "
                             f"bits={bits}); use run_bfs for larger graphs")
        self.bits = bits
        self.depth_cap = (1 << (28 - bits)) - 2

    def init_state(self, graph):
        return 0

    def send_message(self, state, vp):
        key = vp["key"]
        # candidate for a weight-1 edge: depth + 1, parent := own id
        iota = torch.arange(key.shape[0], dtype=torch.int32,
                            device=key.device)
        return (((key >> self.bits) + 1) << self.bits) | iota, None

    def process_message(self, state, msg, edge_vals, vp_r):
        w = edge_vals.to(torch.int32) - 1
        ok = (msg >= KEY_BIAS) & (msg < KEY_BIAS + KEY_SPAN)
        return torch.where(ok, msg + (w << self.bits), msg)

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["key"] = torch.minimum(vp["key"], reduced)
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["key"] != new_vp["key"]

    def receiver_final(self, state, vp, it):
        # every message of sweep t carries a depth field >= t + 1, so a
        # key whose depth is <= it can neither improve its depth nor
        # refine its parent at sweep it ("visited" would NOT be exact:
        # shortcut edges can deliver early keys that a later, shorter
        # plain path still improves)
        key = vp["key"]
        depth = (key - KEY_BIAS) >> self.bits
        return (key < INF_KEY) & (depth <= it)

    def semiring(self):
        return Semiring(
            "min", process_op="key_add_val", bits=self.bits,
            encode=lambda msg: msg.to(torch.int32).view(torch.float32),
            decode=lambda y: torch.where(
                torch.isfinite(y) & (y < 5e29), y.view(torch.int32),
                torch.tensor(INF_KEY, dtype=torch.int32, device=y.device)),
            uses_edge_value=True)


def init_bfs_fast_graph(graph: Graph, source1: int) -> None:
    graph.init_vertexproperty(key=np.int32(INF_KEY))
    graph.set_all_inactive()
    # source key: depth 0, parent = own internal id
    i = graph._idx(source1)
    graph.set_vertexproperty(source1, key=KEY_BIAS + i)
    graph.set_active(source1)


def run_bfs_fast(graph: Graph, source1: int, pred0, ind1,
                 iterations: int = UNTIL_CONVERGENCE):
    """BFS by shortcut-augmented min-plus value iteration; ``graph`` must
    be built from :func:`build_bfs_shortcuts`'s ``e_aug``.  Returns
    ``(depth[n], parent[n], niter)`` in original order: depths equal
    :func:`run_bfs`'s, parents a valid (generally different) BFS tree."""
    if not isinstance(graph, Graph):
        # the parent field holds the sender's row in its vertex tensor,
        # which on a DistGraph is a segment-local offset
        raise TypeError("run_bfs_fast takes a one-device Graph; use "
                        "run_bfs on a DistGraph")
    bits = max(int(np.ceil(np.log2(graph.n_pad))), 1)
    prog = BFSFastProgram(bits)
    init_bfs_fast_graph(graph, source1)
    niter = engine_for(prog, graph).run(iterations=iterations)
    key = graph.vp_numpy()["key"].astype(np.int64)   # [n], original order
    reached = key < INF_KEY
    kz = np.where(reached, key - KEY_BIAS, 0)
    depth = np.where(reached, kz >> bits, INF_DEPTH).astype(np.int64)
    par_int = np.where(reached, kz & ((1 << bits) - 1), 0)
    # the parent field holds internal ids: map them to 1-based originals
    if graph.perm is not None:
        inv = np.zeros(graph.n_pad, np.int64)
        inv[graph.perm.cpu().numpy()] = np.arange(graph.n)
        par_ext = np.where(reached, inv[par_int] + 1, -1)
    else:
        par_ext = np.where(reached, par_int + 1, -1)
    # a shortcut target has in-degree 1: its parent is its predecessor
    fix = reached & ind1[: graph.n]
    par_ext = np.where(fix, pred0[: graph.n] + 1, par_ext)
    par_ext[~reached] = -1
    par_ext[source1 - 1] = -1
    return depth, par_ext.astype(np.int64), niter


def _main(argv=None):
    """CLI parity with ``src/BFS.cpp``: <A.mtx> <source 1-based>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 2:
        print("Correct format: bfs A.mtx source_vertex (1-based index)")
        return 0
    g = build_graph(load_graph_file(args[0]), build_in_edges=False)
    t0 = time.time()
    depth, parent, niter = run_bfs(g, int(args[1]))
    print(f"Completed {niter} iterations")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Reachable vertices = {int((depth < INF_DEPTH).sum())}")
    for i in range(min(10, g.n)):
        if depth[i] < INF_DEPTH:
            print(f"Depth {i + 1} : {depth[i]} parent: {parent[i]}")
        else:
            print(f"Depth {i + 1} : INF")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
