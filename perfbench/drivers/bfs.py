"""BFS searches back to back on one graph, each from the next of a list
of sources drawn in set-up from the seed among the vertices of
out-degree at least 1 (as Graph500 picks its search keys): one
``run_bfs(graph, source)`` a search, timed from the call to its depths
and parents on the host."""

from __future__ import annotations

import numpy as np
import torch

from .. import harness, port
from ..reference.bfs import bfs


# the control's precision: the step below the float32 that carries ids
CONTROL_DTYPE = "bfloat16"


def inputs(cfg, traffic, seed, device):
    inp = harness.generator(cfg).make(cfg, seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    deg = torch.bincount(inp["src"].long(), minlength=inp["n"])
    cand = torch.nonzero(deg >= traffic["min_out_degree"]).flatten()
    pick = torch.randint(0, cand.numel(), (traffic["sources"],),
                         generator=gen, device=device)
    inp["sources"] = (cand[pick] + 1).tolist()     # 1-based
    return inp


def build(inp, traffic, device):
    return port.graph(inp, device)


def _source(inp, i):
    return inp["sources"][i % len(inp["sources"])]


def job(g, inp, traffic, i):
    source = _source(inp, i)
    depth, parent, _ = port.run_bfs(g, source)
    return harness.Out(work=1.0, info={"searches": 1},
                       answer=(source, depth, parent))


def end_to_end(jobs, window_s):
    ms = [j.latency_s * 1e3 for j in jobs]
    return {"bfs_search_ms_p95": (harness.percentile(ms, 95), "ms")}


def _readings(inp, answers, id_dtype):
    """``bfs_mismatch``: vertices whose depth or parent differ from the
    reference's search from the same source (ids carried as ``id_dtype``
    there)."""
    src, dst = inp["src"].long(), inp["dst"].long()
    out = []
    for idx, (source, depth, parent) in answers:
        rd, rp = bfs(src, dst, inp["n"], source - 1, id_dtype)
        d = torch.as_tensor(np.asarray(depth, np.int64), device=rd.device)
        p = torch.as_tensor(np.asarray(parent, np.int64), device=rd.device)
        bad = (d != rd) | (p != rp)
        out.append((idx, "bfs_mismatch", float(bad.sum())))
    return out


def check(inp, kept, traffic, seed, device):
    return _readings(inp, kept, torch.float64)


def control(inp, traffic, seed, device, dtype):
    """The reference with its ids in ``dtype`` in the program's place,
    judged by the float64 reference, on the first few sources."""
    src, dst = inp["src"].long(), inp["dst"].long()
    out = []
    for i in range(traffic["control_sources"]):
        s = _source(inp, i)
        d, p = bfs(src, dst, inp["n"], s - 1, dtype)
        out += _readings(inp, [(i, (s, d.cpu().numpy(),
                                    p.cpu().numpy()))], torch.float64)
    return out
