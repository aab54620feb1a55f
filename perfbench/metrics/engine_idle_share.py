"""The share of ``Engine.run``'s wall time (the program's ``engine.run``
spans) in which no device event ran: 1 - (device busy inside the runs) /
(the runs' time).  What a loop kept on the device could gain.  One
reader for every ``engine_idle_share.<cell kind>``."""

from perfbench import spans

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "core/runtime.py: Engine.run"


def read(tr, ctx):
    v = spans.view(tr)
    if v is None or not tr.device:
        return None
    runs = spans.merge(v.intervals("engine.run"))
    wall = sum(e - s for s, e in runs)
    if wall <= 0:
        return None
    busy = spans.overlap(runs, spans.merge((s, e) for _, s, e in tr.device))
    return 100.0 * (1.0 - busy / wall)
