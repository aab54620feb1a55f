"""The share of the profiled jobs' wall time in which no device event
ran: 1 - (union of the device events) / (the jobs' span).  One reader for
every ``device_idle_share.<cell kind>`` metric; each moves its own cell's
end-to-end metric, as ``BENCHMARK.json`` says."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"


def read(tr, ctx):
    if not tr.jobs or not tr.device:
        return None
    return 100.0 * tr.idle_share()
