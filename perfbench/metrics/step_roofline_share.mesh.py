"""The profiled PageRank jobs' share of the whole mesh's bytes bound: the
bytes of one dense iteration of the whole graph
(``roofline.pagerank_step_bytes``) at the peak bandwidth of all the
mesh's cards together, times the iterations run, over the jobs' time
(their ``perfbench.job`` spans)."""

import math

from perfbench import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: ops/spmv2u.py, csrc/spmv2u.cu, csrc/compact.cu"
MOVES = "pagerank_gteps"


def read(tr, ctx):
    iters = sum(i.get("iterations", 0) for i in tr.info)
    if not tr.jobs or not tr.device or not iters:
        return None
    wall = sum(e - s for s, e in tr.jobs)
    if wall <= 0:
        return None
    cards = math.prod(ctx.get("mesh", (1,)))
    need = roofline.pagerank_step_bytes(ctx["n"], ctx["nnz"]) * iters / (
        cards * roofline.HBM_BYTES_PER_S)
    return 100.0 * need / wall
