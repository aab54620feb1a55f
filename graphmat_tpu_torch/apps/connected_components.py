"""Connected components by min-label propagation, as in
``graphmat_tpu/apps/connected_components.py``: every vertex repeatedly
adopts the smallest label among itself and its neighbours until no label
changes.  ALL_EDGES, so weak components of a directed edge list emerge.
Labels are 1-based vertex ids, exact as float32 below 2^24.

Run as ``python -m graphmat_tpu_torch.apps.connected_components A.mtx``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import Graph
from ..core.program import GraphProgram, Semiring
from ..core.runtime import engine_for
from ..core.types import Activity, Direction, MIN, UNTIL_CONVERGENCE

__all__ = ["ConnectedComponentsProgram", "run_connected_components"]


class ConnectedComponentsProgram(GraphProgram):
    order = Direction.ALL_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = MIN
    process_requires_vertexprop = False

    def send_message(self, state, vp):
        return vp["label"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        out = dict(vp)
        out["label"] = torch.minimum(vp["label"], reduced)
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["label"] != new_vp["label"]

    def semiring(self):
        return Semiring(
            "min",
            encode=lambda msg: msg.to(torch.float32),
            decode=lambda y: torch.where(torch.isfinite(y), y,
                                         0.0).to(torch.int32),
            uses_edge_value=False)


def run_connected_components(graph: Graph,
                             iterations: int = UNTIL_CONVERGENCE):
    """Returns ``(labels[n], ncomponents, niter)``; a label is the
    smallest 1-based vertex id of its component."""
    graph.init_vertexproperty(label=np.arange(1, graph.n + 1,
                                              dtype=np.int32))
    graph.set_all_active()
    niter = engine_for(ConnectedComponentsProgram(), graph).run(
        iterations=iterations)
    labels = graph.vp_numpy()["label"]
    return labels, int(np.unique(labels).size), niter


def _main(argv=None):
    import sys
    import time
    from ._cli import build_graph, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("Correct format: connected_components A.mtx")
        return 0
    g = build_graph(load_graph_file(args[0]))
    t0 = time.time()
    labels, ncomp, niter = run_connected_components(g)
    print(f"Completed {niter} iterations")
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Connected components = {ncomp}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
