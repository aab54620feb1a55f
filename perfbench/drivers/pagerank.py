"""PageRank jobs to convergence, back to back, on one graph: one
``run_pagerank(graph)`` a job (alpha 0.3, tol 1e-5, the port's
defaults).  Work: edges times the iterations run; the degree pass is not
counted."""

from __future__ import annotations

import numpy as np
import torch

from .. import harness, port
from ..reference.pagerank import pagerank


# the control's precision: the step below the configured float32
CONTROL_DTYPE = "bfloat16"


def inputs(cfg, traffic, seed, device):
    return harness.generator(cfg).make(cfg, seed, device)


def build(inp, traffic, device):
    return port.graph(inp, device)


def job(g, inp, traffic, i):
    pr, niter = port.run_pagerank(g)
    return harness.Out(work=float(g.nnz) * niter,
                       info={"iterations": int(niter)},
                       answer=(pr, int(niter)))


def end_to_end(jobs, window_s):
    return {"pagerank_gteps": (harness.rate(jobs, window_s, 1e9), "GTEPS")}


def _readings(inp, answers, traffic, device):
    """``pr_gap``: the largest |pr - ref| / max(1, |ref|) against the
    float64 reference after as many steps as the answer ran;
    ``steps_early``: how many steps before the float64 run's own stop the
    answer stopped; ``steps_late``: how many after (float32 stops some
    steps after float64, never before)."""
    ref_pr, ref_steps, snaps = pagerank(
        inp["src"], inp["dst"], inp["n"], traffic["alpha"], traffic["tol"],
        torch.float64, snapshots={s for _, (_, s) in answers})
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
                            traffic["alpha"], traffic["tol"], dtype)
    return _readings(inp, [(0, (pr.double().cpu().numpy(), steps))],
                     traffic, device)


def faults(inp, traffic, seed, device):
    """A run that stops early: the float64 reference with its convergence
    test 100 times looser, in the program's place."""
    pr, steps, _ = pagerank(inp["src"], inp["dst"], inp["n"],
                            traffic["alpha"], 100 * traffic["tol"],
                            torch.float64)
    return {"tol_100x_looser": _readings(
        inp, [(0, (pr.cpu().numpy(), steps))], traffic, device)}
