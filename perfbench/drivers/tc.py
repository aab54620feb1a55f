"""Triangle counts back to back on one undirected graph: the configured
edges made undirected, each unordered pair once with i < j, as GraphMat's
TriangleCounting takes them; one ``run_triangle_counting(graph,
method)`` a count.  Work: the undirected pairs."""

from __future__ import annotations

import numpy as np
import torch

from .. import harness, port
from ..reference import tc


# the control's precision: the step below the program's int32 counts
CONTROL_DTYPE = "int16"


def inputs(cfg, traffic, seed, device):
    e = harness.generator(cfg).make(cfg, seed, device)
    n = e["n"]
    a, b = e["src"].long(), e["dst"].long()
    key = torch.unique(torch.minimum(a, b) * n + torch.maximum(a, b))
    del a, b
    return {"src": (key // n).to(torch.int32),
            "dst": (key % n).to(torch.int32), "n": n}


def build(inp, traffic, device):
    return port.graph(inp, device)


def job(g, inp, traffic, i):
    tri, total = port.run_triangle_counting(g, traffic["method"])
    return harness.Out(work=float(g.nnz), info={},
                       answer=(tri, int(total)))


def end_to_end(jobs, window_s):
    return {"tc_edges_per_s": (harness.rate(jobs, window_s, 1e6),
                               "Medges/s")}


def sample(o, traffic, seed):
    """The vertices checked: the heaviest by out-degree, and from each
    power-of-two class of out-degree (1, 2-3, 4-7, ...) up to
    ``check_per_class`` drawn from the seed, so that every class of list
    lengths that the counting kernels pair is seen."""
    d = tc.out_degree(o)
    heavy = torch.argsort(d, descending=True)[:traffic["check_heaviest"]]
    gen = torch.Generator(device=d.device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    cls = torch.where(d > 0, torch.log2(d.clamp(min=1).double()).floor(),
                      -1.0)
    # a random key per vertex; the smallest keys of each class are drawn
    key = torch.rand(d.numel(), generator=gen, device=d.device,
                     dtype=torch.float64)
    order = torch.argsort(cls + 0.5 * key, stable=True)
    cls = cls[order]
    start = torch.searchsorted(cls, cls, right=False)
    rank = torch.arange(cls.numel(), device=d.device) - start
    pick = order[(cls >= 0) & (rank < traffic["check_per_class"])]
    return sorted(set(heavy.tolist()) | set(pick.tolist()))


def _readings(inp, answers, traffic, seed, acc_dtype):
    """``tc_mismatch``: sampled vertices whose count differs from the
    reference's; ``tc_total_gap``: how far the total lies from the sum
    of the per-vertex counts."""
    o = tc.orient(inp["src"], inp["dst"], inp["n"])
    verts = sample(o, traffic, seed)
    ref = {v: tc.count_at(o, v, acc_dtype) for v in verts}
    out = []
    for idx, (tri, total) in answers:
        tri = np.asarray(tri, np.int64)
        out.append((idx, "tc_mismatch",
                    float(sum(int(tri[v]) != ref[v] for v in verts))))
        out.append((idx, "tc_total_gap", float(abs(int(tri.sum())
                                                   - total))))
    return out


def check(inp, kept, traffic, seed, device):
    return _readings(inp, kept, traffic, seed, torch.int64)


def control(inp, traffic, seed, device, dtype):
    """The reference's counts, held in ``dtype`` (an integer narrower
    than the program's int32), in the program's place."""
    o = tc.orient(inp["src"], inp["dst"], inp["n"])
    tri = np.zeros(inp["n"], np.int64)
    for v in sample(o, traffic, seed):
        tri[v] = tc.count_at(o, v, dtype)
    answer = (tri, int(tri.sum()))
    return _readings(inp, [(0, answer)], traffic, seed, torch.int64)
