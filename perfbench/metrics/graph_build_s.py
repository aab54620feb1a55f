"""Seconds of the port's ``Graph(...)`` build in set-up, host clock with
the device synchronised at both ends."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER, MOVES = "core/graph.py: Graph", "setup_s"


def read(tr, ctx):
    return ctx["graph_build_s"]
