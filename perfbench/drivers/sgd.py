"""SGD factorisation jobs back to back on one rating graph: one
``run_sgd(graph, k, iterations)`` a job (init, RMSE, the sweeps, RMSE,
factors returned).  Work: 2 x ratings x sweeps."""

from __future__ import annotations

import numpy as np
import torch

from .. import harness, port
from ..reference.sgd import sgd


# the control's precision: the step below the configured float32
CONTROL_DTYPE = "bfloat16"


def inputs(cfg, traffic, seed, device):
    return harness.generator(cfg).make(cfg, seed, device)


def build(inp, traffic, device):
    return port.graph(inp, device, val=inp["val"])


def job(g, inp, traffic, i):
    lv, r0, r1 = port.run_sgd(g, traffic["k"], traffic["iterations"])
    return harness.Out(work=2.0 * g.nnz * traffic["iterations"],
                       info={"iterations": traffic["iterations"]},
                       answer=(lv, r0, r1))


def end_to_end(jobs, window_s):
    return {"sgd_updates_per_s": (harness.rate(jobs, window_s, 1e9),
                                  "Gupdates/s")}


def _reference(inp, traffic, dtype):
    return sgd(inp["src"], inp["dst"], inp["val"], inp["n"], traffic["k"],
               traffic["iterations"], traffic["lambda"], traffic["step"],
               dtype)


def _readings(inp, answers, traffic):
    """``lv_gap``: the largest |lv - ref| / max(1, |ref|) against the
    float64 reference; ``rmse_gap``: the larger relative gap of the two
    RMSEs."""
    _, ref, r0, r1 = _reference(inp, traffic, torch.float64)
    out = []
    for idx, (lv, a0, a1) in answers:
        got = torch.as_tensor(np.asarray(lv, np.float64), device=ref.device)
        gap = ((got - ref).abs() / ref.abs().clamp(min=1.0)).max()
        out.append((idx, "lv_gap", float(gap)))
        out.append((idx, "rmse_gap", max(abs(a0 - r0) / r0,
                                         abs(a1 - r1) / r1)))
    return out


def check(inp, kept, traffic, seed, device):
    return _readings(inp, kept, traffic)


def control(inp, traffic, seed, device, dtype):
    _, lv, r0, r1 = _reference(inp, traffic, dtype)
    return _readings(inp, [(0, (lv.cpu().numpy(), r0, r1))], traffic)
