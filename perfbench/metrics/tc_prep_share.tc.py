"""The share of the profiled counts' device busy time outside the two
counting kernels (T1 ``core_count``, T2 ``tail_count``): the prep of
``ops/triangles.py`` and the copies."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "ops/triangles.py: the prep"
MOVES = "tc_edges_per_s"


def read(tr, ctx):
    if not tr.jobs:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    kernels = tr.device_time(lambda n: "core_count" in n
                             or "tail_count" in n)
    if kernels <= 0:
        return None
    return 100.0 * (1.0 - kernels / busy)
