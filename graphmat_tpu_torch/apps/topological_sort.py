"""Topological sort, Kahn's algorithm (reference:
``src/TopologicalSort.cpp``), as in
``graphmat_tpu/apps/topological_sort.py``.

Pass 1, in-degree (:60-85): OUT_EDGES, ALL_VERTICES, one iteration; every
vertex sends 1, receivers sum.  Pass 2, TopSort (:89-127): ACTIVE_ONLY,
OUT_EDGES; a vertex with ``in_degree == 0`` sends 1 (others send 0),
apply subtracts the count received and gives ``topsort_order =
current_order`` when the in-degree reaches 0.  Only the newly ordered
vertices change, so they are the next frontier.  Counts are exact in
float32 below 2^24.  A cycle leaves its vertices at INF_ORDER (:177-184).

Run as ``python -m graphmat_tpu_torch.apps.topological_sort A.mtx``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import Graph
from ..core.program import GraphProgram, Semiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM, UNTIL_CONVERGENCE

__all__ = ["InDegreeProgram", "TopSortProgram", "run_topological_sort",
           "INF_ORDER"]

INF_ORDER = np.iinfo(np.int32).max


def _count_semiring() -> Semiring:
    return Semiring(
        "sum",
        encode=lambda msg: msg.to(torch.float32),
        decode=lambda y: torch.round(y).to(torch.int32),
        uses_edge_value=False)


class InDegreeProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = False

    def send_message(self, state, vp):
        some = next(iter(vp.values()))
        return torch.ones(some.shape[0], dtype=torch.int32,
                          device=some.device), None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["in_degree"] = reduced
        return out

    def semiring(self):
        return _count_semiring()


class TopSortProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = SUM
    process_requires_vertexprop = False

    def init_state(self, graph):
        return 1  # current_topsort_order (:97)

    def send_message(self, state, vp):
        return (vp["in_degree"] == 0).to(torch.int32), None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        new_indeg = vp["in_degree"] - reduced
        done = (new_indeg == 0) & (vp["in_degree"] > 0)
        out = dict(vp)
        out["in_degree"] = new_indeg
        out["topsort_order"] = torch.where(done, state, vp["topsort_order"])
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["topsort_order"] != new_vp["topsort_order"]

    def do_every_iteration(self, state, vp, it, ctx):
        return state + 1

    def receiver_final(self, state, vp, it):
        # each predecessor sends once (the iteration after its own
        # ordering) and a vertex orders when the last such message lands:
        # an ordered receiver never hears again (cycle members never order)
        return vp["topsort_order"] != INF_ORDER

    def semiring(self):
        return _count_semiring()


def _seed_sources(vp, valid):
    """Order 0 and the frontier: the valid vertices of in-degree 0."""
    seeds = (vp["in_degree"] == 0) & valid
    return ({**vp, "topsort_order": torch.where(seeds, 0,
                                                 vp["topsort_order"])},
            seeds)


def run_topological_sort(graph: Graph,
                         iterations: int = UNTIL_CONVERGENCE):
    """Returns ``(order[n], has_cycle, niter)``: 0 for sources, increasing
    along edges; INF_ORDER marks vertices on or behind a cycle."""
    graph.init_vertexproperty(topsort_order=np.int32(INF_ORDER),
                              in_degree=np.int32(0))
    engine_for(InDegreeProgram(), graph).run(iterations=1)

    if isinstance(graph, Graph):
        graph.vp, graph.active = _seed_sources(graph.vp, graph.valid_vertex)
    else:   # a DistGraph: one property dict per local segment
        seeded = [_seed_sources(vp, valid) for vp, valid in
                  zip(graph.vp, graph.valid_vertex)]
        graph.vp = [vp for vp, _ in seeded]
        graph.active = [act for _, act in seeded]
    niter = engine_for(TopSortProgram(), graph).run(iterations=iterations)
    order = graph.vp_numpy()["topsort_order"]
    return order, bool((order == INF_ORDER).any()), niter


def _main(argv=None):
    """CLI parity with ``src/TopologicalSort.cpp``: <A.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("Correct format: topological_sort A.mtx")
        return 0
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    order, has_cycle, niter = run_topological_sort(g)
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    if has_cycle:
        print("Topological Sort not possible. Graph has cycles.")
        return 0
    for i in range(min(10, g.n)):
        print(f"Top Sort order {i + 1} : {order[i]}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
