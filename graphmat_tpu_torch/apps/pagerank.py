"""PageRank (reference: ``src/PageRank.cpp``), as in
``graphmat_tpu/apps/pagerank.py``.

1. **Degree** (``src/PageRank.cpp:55-79``): IN_EDGES, one iteration, every
   vertex sends 1 against edge direction; ⊕ = sum gives the out-degree.
   It runs the SpMV kernel in sparse mode with the got count.
2. **PageRank** (``src/PageRank.cpp:82-112``): OUT_EDGES, ALL_VERTICES,
   until convergence: message pr/degree, ⊕ = sum,
   ``pr = alpha + (1-alpha)·Σ``; a vertex stays unconverged while
   ``|Δpr| > 1e-5``.  It runs the SpMV kernel in dense mode.

Initial pagerank is 0.3 (the PR() default ctor).

Run as ``python -m graphmat_tpu_torch.apps.pagerank A.mtx``; the device
comes from ``GRAPHMAT_PLATFORM`` (see :mod:`._cli`).
"""

from __future__ import annotations

import torch

from ..core.graph import Graph
from ..core.program import GraphProgram, Semiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM, UNTIL_CONVERGENCE
from ..utils.timing import traced

__all__ = ["DegreeProgram", "PageRankProgram", "init_pagerank_graph",
           "run_pagerank"]


class DegreeProgram(GraphProgram):
    """Out-degree via IN_EDGES sum of unit messages."""

    order = Direction.IN_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, field: str = "degree"):
        self.field = field

    def send_message(self, state, vp):
        some = next(iter(vp.values()))
        return torch.ones(some.shape[0], dtype=torch.int32,
                          device=some.device), None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out[self.field] = reduced
        return out

    def semiring(self):
        return Semiring(
            "sum",
            encode=lambda msg: msg.to(torch.float32),
            decode=lambda y: torch.round(y).to(torch.int32),
            uses_edge_value=False)


class PageRankProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ALL_VERTICES
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, alpha: float = 0.3, tol: float = 1e-5,
                 dtype=torch.float32):
        self.alpha = alpha
        self.tol = tol
        self.dtype = dtype

    def send_message(self, state, vp):
        deg = vp["degree"].to(self.dtype)
        msg = torch.where(deg == 0, torch.zeros_like(deg),
                          vp["pagerank"] / torch.clamp(deg, min=1))
        return msg, None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["pagerank"] = self.alpha + (1.0 - self.alpha) * reduced
        return out

    def changed(self, old_vp, new_vp):
        return (old_vp["pagerank"] - new_vp["pagerank"]).abs() > self.tol

    def semiring(self):
        return Semiring(
            "sum",
            encode=lambda msg: msg.to(torch.float32),
            decode=lambda y: y.to(self.dtype),
            uses_edge_value=False)


@traced("app.init")
def init_pagerank_graph(graph: Graph, dtype=torch.float32) -> None:
    """PR() default ctor state: pagerank=0.3, degree=0
    (``src/PageRank.cpp:39-42``)."""
    graph.init_vertexproperty(
        pagerank=torch.tensor(0.3, dtype=dtype),
        degree=torch.tensor(0, dtype=torch.int32),
    )


@traced("app.pagerank")
def run_pagerank(graph: Graph, alpha: float = 0.3,
                 iterations: int = UNTIL_CONVERGENCE, dtype=torch.float32):
    """Degree pass, then PageRank to convergence (or ``iterations``).

    Returns ``(pagerank[n] as numpy in original order, niter)``.
    """
    init_pagerank_graph(graph, dtype)

    graph.set_all_active()
    engine_for(DegreeProgram(), graph).run(iterations=1)

    eng = engine_for(PageRankProgram(alpha=alpha, dtype=dtype), graph)
    niter = eng.run(iterations=iterations)
    return graph.vp_numpy()["pagerank"], niter


def _main(argv=None):
    """CLI parity with ``src/PageRank.cpp`` usage: <A.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("Correct format: pagerank A.mtx")
        return 0
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    pr, niter = run_pagerank(g)
    print(f"Completed {niter} iterations")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    for i in range(min(25, g.n)):
        print(f"{i + 1} : {pr[i]:.6f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
