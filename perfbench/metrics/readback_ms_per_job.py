"""Milliseconds of ``Graph``'s downloads of vertex state to the host
(the program's ``graph.readback`` spans: ``vp_numpy``, ``active_numpy``,
``get_vertexproperty``) per profiled job.  One reader for every
``readback_ms_per_job.<cell kind>``."""

from perfbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "core/graph.py: Graph.vp_numpy"


def read(tr, ctx):
    v = spans.view(tr)
    return None if v is None else v.seconds("graph.readback") * 1e3 / v.jobs
