"""Incremental (delta) PageRank (reference:
``src/IncrementalPageRank.cpp``), as in
``graphmat_tpu/apps/incremental_pagerank.py``.

Vertices carry ``(delta, pagerank, degree)`` with defaults (0.3, 0.3, 0)
(:38-43).  After a degree pass, the ACTIVE_ONLY delta program runs until
no vertex's pagerank moves by more than 1e-8: only vertices whose rank
changed stay active, so work shrinks as ranks settle.  apply (:112-117):
reset delta if it was significant, accumulate ``(1-alpha)·Σ msg``, and
fold it into pagerank when significant.  Both passes are sparse sums with
the got count.

Run as ``python -m graphmat_tpu_torch.apps.incremental_pagerank A.mtx``.
"""

from __future__ import annotations

import torch

from ..core.graph import Graph
from ..core.program import GraphProgram, Semiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, SUM, UNTIL_CONVERGENCE
from .pagerank import DegreeProgram

__all__ = ["DeltaPageRankProgram", "run_incremental_pagerank"]


class DeltaPageRankProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = SUM
    process_requires_vertexprop = False

    def __init__(self, alpha: float = 0.3, tol: float = 1e-8,
                 dtype=torch.float32):
        self.alpha = alpha
        self.tol = tol
        self.dtype = dtype

    def send_message(self, state, vp):
        deg = vp["degree"].to(self.dtype)
        msg = torch.where(deg == 0, torch.zeros_like(deg),
                          vp["delta"] / torch.clamp(deg, min=1))
        return msg, None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        delta = torch.where(vp["delta"].abs() > self.tol,
                            torch.zeros_like(vp["delta"]), vp["delta"])
        delta = delta + (1.0 - self.alpha) * reduced.to(self.dtype)
        significant = delta.abs() > self.tol
        out = dict(vp)
        out["delta"] = delta
        out["pagerank"] = torch.where(significant, vp["pagerank"] + delta,
                                      vp["pagerank"])
        return out

    def changed(self, old_vp, new_vp):
        return (old_vp["pagerank"] - new_vp["pagerank"]).abs() > self.tol

    def semiring(self):
        return Semiring(
            "sum",
            encode=lambda msg: msg.to(torch.float32),
            decode=lambda y: y.to(self.dtype),
            uses_edge_value=False)


def run_incremental_pagerank(graph: Graph, alpha: float = 0.3,
                             iterations: int = UNTIL_CONVERGENCE,
                             dtype=torch.float32,
                             max_iterations: int = 10_000):
    """The reference flow (:128-160); returns ``(pagerank[n], niter)``."""
    graph.init_vertexproperty(
        delta=torch.tensor(0.3, dtype=dtype),
        pagerank=torch.tensor(0.3, dtype=dtype),
        degree=torch.tensor(0, dtype=torch.int32),
    )
    graph.set_all_active()
    engine_for(DegreeProgram(), graph).run(iterations=1)

    graph.set_all_active()
    niter = engine_for(DeltaPageRankProgram(alpha=alpha, dtype=dtype),
                       graph).run(iterations=iterations,
                                  max_iterations=max_iterations)
    return graph.vp_numpy()["pagerank"], niter


def _main(argv=None):
    """CLI parity with ``src/IncrementalPageRank.cpp``: <A.mtx>."""
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("Correct format: incremental_pagerank A.mtx")
        return 0
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    pr, niter = run_incremental_pagerank(g)
    print(f"PR Time = {(time.time() - t0) * 1e3:.3f} ms "
          f"({niter} iterations)")
    deg = g.vp_numpy()["degree"]
    for i in range(min(25, g.n)):
        print(f"{i + 1} : {deg[i]} {pr[i]:.6f}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
