"""Megabytes the tiles received from other tiles per engine step, as the
mesh counts them in its collectives (``mesh.bytes``, the collective's
own count: what the ranks of a process mesh would send each other) over
the steps the engine counts (``engine.steps``), in the profiled jobs."""

from perfbench import spans

UNIT, BETTER, SOURCE = "MB", "lower", "host_clock"
LAYER = "parallel/mesh.py: the tile exchange"
MOVES = "pagerank_gteps"


def read(tr, ctx):
    v = spans.view(tr)
    if v is None:
        return None
    steps = v.counters.get("engine.steps", 0.0)
    if not steps or "mesh.bytes" not in v.counters:
        return None
    return v.counters["mesh.bytes"] / steps / 1e6
