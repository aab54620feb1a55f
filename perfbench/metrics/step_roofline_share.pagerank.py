"""The profiled PageRank jobs' share of the bytes bound: the bytes of one
dense iteration (``roofline.pagerank_step_bytes``) at the card's peak
bandwidth, times the iterations run, over the jobs' device busy time."""

from perfbench import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: ops/spmv2u.py, csrc/spmv2u.cu, csrc/compact.cu"
MOVES = "pagerank_gteps"


def read(tr, ctx):
    iters = sum(i.get("iterations", 0) for i in tr.info)
    if not tr.jobs or not iters:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    need = roofline.bound_s(roofline.pagerank_step_bytes(
        ctx["n"], ctx["nnz"])) * iters
    return 100.0 * need / busy
