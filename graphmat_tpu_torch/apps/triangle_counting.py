"""Triangle counting (reference: ``src/TriangleCounting.cpp``).

Counterpart of ``graphmat_tpu/apps/triangle_counting.py``.  The input is
meant to be an upper-triangular DAG (each undirected edge once, low id to
high id).  Two routes:

* ``"engine"``, the reference's program structure: every vertex learns
  its sorted out-neighbour list (GetNeighbors, ``:80-111``; here a padded
  ``[n_pad, max_degree]`` matrix, :func:`~graphmat_tpu_torch.ops.
  neighbors.collect_neighbors`), then CountTriangles (``:114-156``) runs
  on the Engine's segment path: each edge s -> r adds ``|N(s) ∩ N(r)|``
  to r, the intersection a batched binary search.  Per-vertex counts
  attribute each triangle to its id-middle vertex.
* ``"bucketed"``, the scalable route (:mod:`graphmat_tpu_torch.ops.
  triangles`): degree orientation, core bitmaps and tail lists, with its
  two hot loops as kernels on the card.  Per-vertex counts attribute each
  triangle to its degree-minimum vertex.

Both return per-vertex counts in ORIGINAL vertex order.  The JAX
package's bucketed route returns them in the graph's internal order on a
permuted graph (ROADMAP R5); the port does not copy that.
"""

from __future__ import annotations

import numpy as np

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM
from ..ops.neighbors import (collect_neighbors, intersect_sorted_counts,
                             max_degree)
from ..ops.triangles import count_triangles_bucketed
from ..utils.timing import span, traced

__all__ = ["CountTrianglesProgram", "run_triangle_counting"]

AUTO_MAX_DEGREE = 1024   # "auto" takes the engine route up to this degree


class CountTrianglesProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = True

    def send_message(self, state, vp):
        return vp["neighbors"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return intersect_sorted_counts(msg, vp_r["neighbors"])

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["triangles"] = vp["triangles"] + reduced
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["triangles"] != new_vp["triangles"]


@traced("app.tc")
def run_triangle_counting(graph: Graph, max_degree_pad: int | None = None,
                          method: str = "auto"):
    """Returns ``(triangles[n], total)``, the counts in original vertex
    order and their exact sum.

    ``method="engine"`` runs CountTrianglesProgram over a ``[n_pad,
    max_degree]`` neighbour matrix (``max_degree_pad`` widens it);
    ``"bucketed"`` counts the dst direction's edges (internal ids) with
    :func:`~graphmat_tpu_torch.ops.triangles.count_triangles_bucketed`;
    ``"auto"`` takes the engine up to an out-degree of 1024 and the
    bucketed route above.  Both read a one-device Graph: the JAX package
    has no sharded route for TriangleCounting either."""
    if not isinstance(graph, Graph):
        raise TypeError("run_triangle_counting takes a one-device Graph "
                        f"(got {type(graph).__name__}); unset "
                        "GRAPHMAT_MESH")
    if method == "auto":
        method = ("engine" if max_degree(graph, "src") <= AUTO_MAX_DEGREE
                  else "bucketed")
    if method == "bucketed":
        c = graph.csr("dst")
        with span("tc.count"):
            tri, total = count_triangles_bucketed(c.col, c.row, graph.n,
                                                  n_pad=graph.n_pad)
        graph.init_vertexproperty(triangles=np.int32(0))
        graph.vp = {**graph.vp, "triangles": tri}
        return graph.vp_numpy()["triangles"], total
    if method != "engine":
        raise ValueError(f"method={method!r}: use 'auto', 'engine' or "
                         "'bucketed'")
    with span("tc.count"):
        neighbors = collect_neighbors(graph, receiver="src",
                                      pad_to=max_degree_pad)
        graph.init_vertexproperty(triangles=np.int32(0))
        graph.vp = {**graph.vp, "neighbors": neighbors}
        engine_for(CountTrianglesProgram(), graph).run(iterations=1)
    tri = graph.vp_numpy()["triangles"]
    return tri, int(tri.sum())


def _main(argv=None):
    """CLI parity with ``src/TriangleCounting.cpp``: <A.mtx>
    (upper-triangular)."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("Correct format: triangle_counting A.mtx")
        return 0
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    tri, total = run_triangle_counting(g)
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Total triangles = {total}")
    for i in range(min(10, g.n)):
        print(f"{i + 1} : {tri[i]}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
