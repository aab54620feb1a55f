"""PageRank jobs to convergence, back to back, on one graph laid over a
mesh of cards: one ``run_pagerank(graph)`` a job on a ``DistGraph``
(alpha 0.3, tol 1e-5, the port's defaults), which runs the 2D-sharded
engine.  Work: edges times the iterations run; the degree pass is not
counted.

The edge list is held 1-based, as the port's ``EdgeList`` takes it, so
that the build reads the harness's input where it lies; the reference
reads it chunk by chunk (``reference/pagerank_chunked.py``), beside the
input on the first card once the graph is gone."""

from __future__ import annotations

import numpy as np
import torch

from .. import harness, port, port_mesh
from ..reference.pagerank_chunked import pagerank

# the control's precision: the step below the configured float32
CONTROL_DTYPE = "bfloat16"
BASE = 1


def inputs(cfg, traffic, seed, device):
    inp = harness.generator(cfg).make(cfg, seed, device)
    inp["src"] += BASE
    inp["dst"] += BASE
    return inp


def build(inp, traffic, device):
    g = port_mesh.graph(inp, traffic["mesh"], device)
    if torch.device(device).type == "cuda":
        harness.log("build peaks, GB a card: " + ", ".join(
            f"{d} {torch.cuda.max_memory_allocated(d) / 1e9:.2f}"
            for d in g.devices))
    return g


def job(g, inp, traffic, i):
    pr, niter = port.run_pagerank(g)
    return harness.Out(work=float(g.nnz) * niter,
                       info={"iterations": int(niter)},
                       answer=(pr, int(niter)))


def end_to_end(jobs, window_s):
    return {"pagerank_gteps": (harness.rate(jobs, window_s, 1e9), "GTEPS")}


def _readings(inp, answers, traffic, device):
    """``pr_gap``, ``steps_early`` and ``steps_late`` as
    ``drivers/pagerank.py`` reads them, against the float64 reference."""
    ref_pr, ref_steps, snaps = pagerank(
        inp["src"], inp["dst"], inp["n"], traffic["alpha"], traffic["tol"],
        torch.float64, snapshots={s for _, (_, s) in answers}, base=BASE)
    del ref_pr
    out = []
    for idx, (pr, steps) in answers:
        ref = snaps[steps]
        got = torch.as_tensor(np.asarray(pr, np.float64), device=ref.device)
        gap = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max()
        out.append((idx, "pr_gap", float(gap)))
        out.append((idx, "steps_early", float(max(0, ref_steps - steps))))
        out.append((idx, "steps_late", float(max(0, steps - ref_steps))))
    return out


def check(inp, kept, traffic, seed, device):
    return _readings(inp, kept, traffic, device)


def control(inp, traffic, seed, device, dtype):
    pr, steps, _ = pagerank(inp["src"], inp["dst"], inp["n"],
                            traffic["alpha"], traffic["tol"], dtype,
                            base=BASE)
    return _readings(inp, [(0, (pr.double().cpu().numpy(), steps))],
                     traffic, device)


def faults(inp, traffic, seed, device):
    """A run that stops early: the float64 reference with its convergence
    test 100 times looser, in the program's place."""
    pr, steps, _ = pagerank(inp["src"], inp["dst"], inp["n"],
                            traffic["alpha"], 100 * traffic["tol"],
                            torch.float64, base=BASE)
    return {"tol_100x_looser": _readings(
        inp, [(0, (pr.cpu().numpy(), steps))], traffic, device)}
