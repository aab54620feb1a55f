"""Delta-stepping SSSP (reference: ``src/DeltaStepping.cpp``), as in
``graphmat_tpu/apps/delta_stepping.py``.

The edge list is split by weight into a light graph (w <= delta) and a
heavy graph (w > delta) (``src/DeltaStepping.cpp:119-137``); the two
graphs share one vertex-property store (``G2.shareVertexProperty(G)``,
:142).  The host loop per bucket (:160-178): the light graph until
convergence, the heavy graph for one iteration, ``bid += 1``; go on while
any vertex sits in a bucket >= bid.

Program (:78-98): message = distance if the vertex is in the current
bucket, else INF; ⊗ = saturating msg + w; ⊕ = min; apply relaxes and
re-buckets ``bucket = distance // delta``.  Unlike the JAX file, whose
``pallas_semiring`` became unreachable code (ROADMAP R1), the program
declares its min semiring (``x_add_val``, INF_DIST <-> +inf), so it runs
the kernel, and its receiver-finality mask takes effect there.

Run as ``python -m graphmat_tpu_torch.apps.delta_stepping A.mtx delta
source``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import Graph
from ..core.program import GraphProgram
from ..core.runtime import Engine
from ..core.types import Activity, Direction, MIN, UNTIL_CONVERGENCE
from ..io.edgelist import EdgeList
from ..io.transforms import filter_edges
from .sssp import INF_DIST, distance_semiring, saturating_add

__all__ = ["DeltaSteppingProgram", "run_delta_stepping", "INF_DIST",
           "INF_BUCKET"]

INF_BUCKET = np.iinfo(np.int32).max


class DeltaSteppingProgram(GraphProgram):
    order = Direction.OUT_EDGES
    activity = Activity.ACTIVE_ONLY
    reduce = MIN
    process_requires_vertexprop = False

    def __init__(self, delta: int):
        self.delta = int(delta)

    def init_state(self, graph):
        return 0  # bid

    def send_message(self, state, vp):
        msg = torch.where(vp["bucket"] == state, vp["distance"],
                          torch.full_like(vp["distance"], INF_DIST))
        return msg, None

    def process_message(self, state, msg, edge_vals, vp_r):
        return saturating_add(msg, edge_vals)

    def apply(self, state, reduced, vp):
        better = vp["distance"] > reduced
        out = dict(vp)
        out["distance"] = torch.where(better, reduced, vp["distance"])
        out["bucket"] = torch.where(better, reduced // self.delta,
                                    vp["bucket"])
        return out

    def changed(self, old_vp, new_vp):
        return old_vp["distance"] != new_vp["distance"]

    def receiver_final(self, state, vp, it):
        # settled-bucket invariant (non-negative weights): every phase-bid
        # message is >= bid * delta, so a vertex in a bucket below bid can
        # never improve; its distance is final for the whole phase
        return vp["bucket"] < state

    def semiring(self):
        return distance_semiring()


def run_delta_stepping(edges: EdgeList, delta: int, source1: int,
                       max_buckets: int = 1_000_000, device="cuda"):
    """The reference flow on ``device`` (the card unless the caller asks
    for the CPU); returns ``(distance[n], nbuckets)``."""
    light = filter_edges(edges, lambda s, d, v: v <= delta)
    heavy = filter_edges(edges, lambda s, d, v: v > delta)

    g = Graph(light, build_in_edges=False, device=device)
    g2 = Graph(heavy, build_in_edges=False, device=device)
    g.init_vertexproperty(distance=np.int32(INF_DIST),
                          bucket=np.int32(INF_BUCKET))
    g2.share_vertex_property(g)

    g.set_vertexproperty(source1, distance=0, bucket=0)
    g.set_active(source1)

    prog = DeltaSteppingProgram(delta)
    eng_light = Engine(prog, g)
    eng_heavy = Engine(prog, g2)

    bid = 0
    while True:
        g.set_all_active()
        eng_light.run(iterations=UNTIL_CONVERGENCE, state=bid)
        g2.set_all_active()
        eng_heavy.run(iterations=1, state=bid)
        bid += 1
        bucket = g.vp["bucket"]
        if not bool(((bucket >= bid) & (bucket < INF_BUCKET)).any()):
            break
        if bid >= max_buckets:
            raise RuntimeError("delta-stepping did not terminate")
    return g.vp_numpy()["distance"], bid


def _main(argv=None):
    """CLI parity with ``src/DeltaStepping.cpp``: <A.mtx> <delta> <source>."""
    import sys
    import time
    from ._cli import device_from_env, load_graph_file
    args = argv if argv is not None else sys.argv[1:]
    if len(args) < 3:
        print("Correct format: delta_stepping A.mtx delta source")
        return 0
    e = load_graph_file(args[0])
    t0 = time.time()
    dist, nbuckets = run_delta_stepping(e, int(args[1]), int(args[2]),
                                        device=device_from_env())
    print(f"Time = {(time.time() - t0) * 1e3:.3f} ms")
    print(f"Number of buckets processed = {nbuckets}")
    print(f"Reachable vertices = {int((dist < INF_DIST).sum())}")
    for i in range(min(25, len(dist))):
        d = "INF" if dist[i] >= INF_DIST else str(dist[i])
        print(f"{i + 1} : distance = {d}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_main())
