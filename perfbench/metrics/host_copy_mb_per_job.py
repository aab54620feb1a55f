"""Megabytes copied between the host and the device per profiled job, as
the program counts them where it copies (``copy.dtoh.bytes``: ``Graph``'s
readbacks, the convergence reads, TC's total; ``copy.htod.bytes``: the
host arrays ``Graph`` uploads).  One reader for every
``host_copy_mb_per_job.<cell kind>``."""

from perfbench import spans

UNIT, BETTER, SOURCE = "MB", "lower", "host_clock"
LAYER = "core/graph.py: the host boundary"


def read(tr, ctx):
    v = spans.view(tr)
    if v is None:
        return None
    c = v.counters
    return (c.get("copy.dtoh.bytes", 0.0)
            + c.get("copy.htod.bytes", 0.0)) / v.jobs / 1e6
