"""Single-source shortest paths, Bellman-Ford style (reference:
``src/SSSP.cpp``), as in ``graphmat_tpu/apps/sssp.py``.

OUT_EDGES; ⊕ = min, ⊗ = message + edge weight (``src/SSSP.cpp:73-79``);
apply: ``distance = min(distance, reduced)``.  Distances are int32 with an
INF sentinel; the kernel carries them as float32 with INF_DIST as +inf,
exact below 2^24 (integer weights).

Run as ``python -m graphmat_tpu_torch.apps.sssp A.mtx source``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import Graph
from ..core.program import GraphProgram, Semiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, MIN, UNTIL_CONVERGENCE

__all__ = ["SSSPProgram", "run_sssp", "init_sssp_graph", "reachable_count",
           "INF_DIST", "distance_semiring"]

INF_DIST = np.iinfo(np.int32).max


def saturating_add(msg, edge_vals):
    """INF + w stays INF (the reference relies on unsigned wrap being
    filtered by the min-apply; saturate instead)."""
    ev = edge_vals.to(torch.int32)
    return torch.where(msg >= INF_DIST - ev,
                       torch.full_like(msg, INF_DIST), msg + ev)


def distance_semiring() -> Semiring:
    """min, x + val, INF_DIST <-> +inf: distances exact below 2^24."""
    return Semiring(
        "min", process_op="x_add_val",
        encode=lambda msg: torch.where(msg == INF_DIST,
                                       float("inf"), msg.to(torch.float32)),
        decode=lambda y: torch.where(torch.isfinite(y), y,
                                     float(INF_DIST)).to(torch.int32))


class SSSPProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = MIN
    process_requires_vertexprop = False

    def send_message(self, state, vp):
        return vp["distance"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return saturating_add(msg, edge_vals)

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["distance"] = torch.minimum(vp["distance"], reduced)
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["distance"] != new_vp["distance"]

    def semiring(self):
        return distance_semiring()


def init_sssp_graph(graph: Graph, source1: int) -> None:
    graph.init_vertexproperty(distance=np.int32(INF_DIST))
    graph.set_all_inactive()
    graph.set_vertexproperty(source1, distance=0)
    graph.set_active(source1)


def run_sssp(graph: Graph, source1: int,
             iterations: int = UNTIL_CONVERGENCE):
    """Returns ``(distance[n], niter)``; unreachable = INF_DIST."""
    init_sssp_graph(graph, source1)
    niter = engine_for(SSSPProgram(), graph).run(iterations=iterations)
    return graph.vp_numpy()["distance"], niter


def reachable_count(graph: Graph) -> int:
    return int((graph.vp_numpy()["distance"] < INF_DIST).sum())


def _main(argv=None):
    """CLI parity with ``src/SSSP.cpp``: <A.mtx> <source 1-based>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 2:
        print("Correct format: sssp A.mtx source_vertex (1-based index)")
        return 0
    g = build_graph(load_graph_file(args[0]), build_in_edges=False)
    t0 = time.time()
    dist, niter = run_sssp(g, int(args[1]))
    print(f"Completed {niter} iterations")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Reachable vertices = {int((dist < INF_DIST).sum())}")
    for i in range(min(25, g.n)):
        d = "INF" if dist[i] >= INF_DIST else str(dist[i])
        print(f"{i + 1} : distance = {d}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
