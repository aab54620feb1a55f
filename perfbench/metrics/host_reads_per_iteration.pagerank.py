"""Device-to-host copies per PageRank iteration over the profiled jobs,
as the program counts them (``copy.dtoh.n``: one convergence read a step
and each job's readback), over the iterations the jobs report: the
inside twin of ``dtoh_copies_per_iteration.pagerank``."""

from perfbench import spans

UNIT, BETTER, SOURCE = "reads", "lower", "host_clock"
LAYER = "core/runtime.py: Engine.run"
MOVES = "pagerank_gteps"


def read(tr, ctx):
    v = spans.view(tr)
    iters = sum(i.get("iterations", 0) for i in tr.info)
    if v is None or not iters:
        return None
    return v.counters.get("copy.dtoh.n", 0.0) / iters
