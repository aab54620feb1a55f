"""Device milliseconds of host-to-device copies per profiled BFS search:
``init_bfs_graph``'s upload of the id array and the vertex properties."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "apps/bfs.py: init_bfs_graph"
MOVES = "bfs_search_ms_p95"


def read(tr, ctx):
    searches = sum(i.get("searches", 0) for i in tr.info)
    if not tr.jobs or not tr.device or not searches:
        return None
    return tr.device_time(lambda n: "HtoD" in n) * 1e3 / searches
