"""The share of ``Graph``'s readback destinations that PyTorch's caching
host allocator served from a page-locked block it already held, over the
profiled jobs: 100 × (1 − ``copy.pinned.new`` / ``copy.pinned.n``), as the
program counts them where it reads back.  ``None`` where the program
counts no pinned destination.  One reader for every
``pinned_hit_share.<cell kind>``."""

from perfbench import spans

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER = "core/graph.py: Graph.vp_numpy"


def read(tr, ctx):
    v = spans.view(tr)
    n = 0.0 if v is None else v.counters.get("copy.pinned.n", 0.0)
    if not n:
        return None
    return 100.0 * (1.0 - v.counters.get("copy.pinned.new", 0.0) / n)
