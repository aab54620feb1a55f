"""The profiled SGD jobs' share of the bytes bound: one sweep's bytes in
both directions (``roofline.sgd_sweep_bytes``) at the card's peak
bandwidth, times the sweeps, over the jobs' device busy time."""

from perfbench import roofline

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "kernels: ops/spmv_vec2.py, csrc/spmv_vec2.cu"
MOVES = "sgd_updates_per_s"


def read(tr, ctx):
    sweeps = sum(i.get("iterations", 0) for i in tr.info)
    if not tr.jobs or not sweeps:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    need = roofline.bound_s(roofline.sgd_sweep_bytes(
        ctx["n"], ctx["nnz"], ctx["k"])) * sweeps
    return 100.0 * need / busy
