"""Device-to-host copies per PageRank iteration over the profiled jobs:
the per-step convergence read of ``Engine.run`` and each job's result."""

UNIT, BETTER, SOURCE = "copies", "lower", "device_trace"
LAYER = "core/runtime.py: Engine.run"
MOVES = "pagerank_gteps"


def read(tr, ctx):
    iters = sum(i.get("iterations", 0) for i in tr.info)
    if not tr.jobs or not tr.device or not iters:
        return None
    return tr.count(lambda n: "DtoH" in n) / iters
