"""The share of the profiled jobs' summed device time spent in copies
between cards (``Memcpy PtoP`` events): the mesh's collectives, the only
place a job moves data from card to card."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "parallel/mesh.py: the tile exchange"
MOVES = "pagerank_gteps"


def read(tr, ctx):
    if not tr.jobs or not tr.device:
        return None
    total = tr.device_time(lambda n: True)
    if total <= 0:
        return None
    return 100.0 * tr.device_time(lambda n: "PtoP" in n) / total
