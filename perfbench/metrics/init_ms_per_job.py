"""Milliseconds of the app's ``init_*_graph`` (the program's ``app.init``
span: the vertex state made on the host and uploaded) per profiled job.
One reader for every ``init_ms_per_job.<cell kind>``; each moves its own
cell's end-to-end metric, as ``BENCHMARK.json`` says."""

from perfbench import spans

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "apps/*.py: init_*_graph"


def read(tr, ctx):
    v = spans.view(tr)
    return None if v is None else v.seconds("app.init") * 1e3 / v.jobs
