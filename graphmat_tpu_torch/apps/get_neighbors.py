"""GetNeighbors: the vector-message program.

Counterpart of ``graphmat_tpu/apps/get_neighbors.py``, after the
reference's test of its SERIALIZED wire format
(``test/test_get_neighbors.cpp:64-137``): every vertex sends its id, ⊕
is a list concat (``reduce_function`` appends vectors, ``:74-77``), and
``apply`` stores the sorted neighbour list.  The concat rides the
Engine's ``vector_message`` route: each receiver collects its
contributions into a padded row of static width (pad ``INT32_MAX``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.program import GraphProgram
from ..core.runtime import engine_for
from ..core.types import Activity, Direction
from ..ops.neighbors import PAD_ID

__all__ = ["GetNeighborsProgram", "run_get_neighbors", "PAD_ID"]


class GetNeighborsProgram(GraphProgram):
    """Collect, per vertex, the ids of its out-neighbours.

    IN_EDGES and ALL_VERTICES, as the reference (``test_get_neighbors.
    cpp:67-72``): messages travel against the edges, so vertex v receives
    the id of every w with an edge v -> w."""

    order = Direction.IN_EDGES
    activity = Activity.ALL_VERTICES
    process_requires_vertexprop = False
    vector_message = True
    vector_pad = PAD_ID

    def send_message(self, state, vp):
        return vp["id"], None

    def process_message(self, state, msg, edge_vals, vp_r):
        return msg

    def apply(self, state, reduced, vp):
        # the reference sorts in apply (:91-94); pads sort last
        return {"id": vp["id"], "neighbors": torch.sort(reduced, 1).values}

    def changed(self, old_vp, new_vp):
        # the reference's operator!= compares the id only (:47-49)
        return old_vp["id"] != new_vp["id"]


def run_get_neighbors(graph):
    """One iteration of GetNeighbors; returns the ``[n, D]`` sorted
    neighbour-id matrix (padded with ``PAD_ID``) in ORIGINAL vertex
    order."""
    eng = engine_for(GetNeighborsProgram(), graph)
    D = eng.vector_reduced_width
    graph.init_vertexproperty(
        id=np.arange(1, graph.n + 1, dtype=np.int32),
        neighbors=np.full((graph.n, D), PAD_ID, np.int32))
    eng.run(iterations=1)
    return graph.vp_numpy()["neighbors"]
