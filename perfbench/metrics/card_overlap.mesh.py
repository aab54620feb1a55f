"""How many cards work at once inside the engine's runs: the summed
time of the device events inside the program's ``engine.run`` spans over
the union of that time.  It reads 1 where the cards take turns and the
number of cards where all work all the time."""

from perfbench import spans
from perfbench.trace import union_length

UNIT, BETTER, SOURCE = "cards", "higher", "device_trace"
LAYER = "parallel/dist_runtime.py: DistEngine._step"
MOVES = "pagerank_gteps"


def read(tr, ctx):
    v = spans.view(tr)
    if v is None or not tr.device:
        return None
    runs = spans.merge(v.intervals("engine.run"))
    inside = [(max(s, rs), min(e, re)) for _, s, e in tr.device
              for rs, re in runs if s < re and e > rs]
    busy = union_length(inside)
    if busy <= 0:
        return None
    return sum(e - s for s, e in inside) / busy
