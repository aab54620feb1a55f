"""One run of one cell: set-up, a measured window of whole jobs back to
back, the check of what the window produced against the plain
reference, and one JSON result line.

Everything a cell is made of is found by name, so that a later change
adds a cell, a configuration, a traffic mix or a per-layer metric as new
files:

* ``workloads/<cell>.json``: the configuration and traffic it pairs, its
  chips, its end-to-end metrics, the jobs its traced run profiles and the
  limits of its checks;
* ``configs/<config>.json``: one deployment's sizes; its ``generator``
  names ``gen/<generator>.py``;
* ``traffic/<traffic>.json``: the jobs' parameters; its ``driver`` names
  ``drivers/<driver>.py``, the code that drives the program's app entry
  and checks its answers with ``reference/``;
* ``metrics/<metric>.py``: one per-layer reader of the traced window,
  read in the cells that ``BENCHMARK.json`` lists for it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that may not be loaded in a measured process:
# the JAX package beside the port, and JAX itself
BANNED = ("jax", "jaxlib", "flax", "graphmat_tpu")
_M64 = (1 << 64) - 1


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    trace_jobs: int
    limits: dict


@dataclass
class Out:
    """What a driver's job gives back: its work in the cell's units, what
    the traced readers may use (``info``), and the answer to check."""
    work: float
    info: dict
    answer: object


@dataclass
class Record:
    latency_s: float
    work: float


NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def read_json(kind: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a name of the benchmark")
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def load_cell(name: str) -> Cell:
    w = read_json("workloads", name)
    return Cell(name=name, config=read_json("configs", w["config"]),
                traffic=read_json("traffic", w["traffic"]),
                chips=int(w["chips"]), end_to_end=list(w["end_to_end"]),
                trace_jobs=int(w["trace_jobs"]), limits=dict(w["limits"]))


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py``, imported by its file name (a
    metric's name holds dots).  A metric ``<base>.<part>`` without a file
    of its own is read by ``<base>.py``."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file() and kind == "metrics" and "." in name:
        path = ROOT / kind / f"{name.rsplit('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    if kind in ("drivers", "gen", "reference"):
        return importlib.import_module(f"perfbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(cfg: dict):
    return module("gen", cfg["generator"])


def driver(cell: Cell):
    return module("drivers", cell.traffic["driver"])


def per_layer_names(cell_name: str) -> list:
    """The per-layer metrics ``BENCHMARK.json`` asks of this cell."""
    with open(REPO / "BENCHMARK.json") as f:
        doc = json.load(f)
    return [m["name"] for m in doc["per_layer"]
            if cell_name in m.get("workloads", [cell_name])]


def mix(seed: int, i: int) -> int:
    """splitmix64 of (seed, i): the seeded choice of answers to check."""
    x = (seed * 0x9E3779B97F4A7C15 + i + 0x632BE59BD9B4E019) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def rate(jobs, window_s: float, scale: float) -> float:
    """All the window's work over all of its time."""
    return sum(j.work for j in jobs) / window_s / scale


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of every value, linear between ranks."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    x = (len(v) - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (x - lo))


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """Set up, measure, check.  Returns the result line's object, with
    the checks (name, value, limit) under ``checks``."""
    import torch
    from .trace import Profiler, breakdown
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    drv = driver(cell)
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    inp = drv.inputs(cell.config, cell.traffic, seed, device)
    _sync(device)
    t1 = time.perf_counter()
    system = drv.build(inp, cell.traffic, device)
    _sync(device)
    t2 = time.perf_counter()
    graph_build_s = t2 - t1
    drv.job(system, inp, cell.traffic, -1)      # warms the cell's shapes
    _sync(device)
    log(f"set-up: start {t0 - t_start:.3f} s, inputs {t1 - t0:.3f} s, "
        f"build {graph_build_s:.3f} s, warm-up job "
        f"{time.perf_counter() - t2:.3f} s")

    prof = Profiler(cell.trace_jobs) if trace else None
    every = int(cell.traffic.get("check_every", 1))
    jobs, kept, last = [], [], None
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    i = 0
    while True:
        profiled = prof is not None and prof.active
        t0 = time.perf_counter()
        with prof.job() if profiled else nullcontext():
            out = drv.job(system, inp, cell.traffic, i)
        t1 = time.perf_counter()
        jobs.append(Record(t1 - t0, out.work))
        if profiled:
            prof.info.append(out.info)
        if mix(seed, i) % every == 0:
            kept.append((i, out.answer))
        last = (i, out.answer)
        i += 1
        if t1 - t_window >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t_window
    if not kept or kept[-1][0] != last[0]:
        kept.append(last)
    del out, last

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": (torch.cuda.get_device_name(0) if cuda
                         else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                      if cuda else 0)}
    result = {"correct": False, "attempted": len(jobs), "failed": 0,
              "metrics": {}, "device": dev_info}
    if trace:
        tr = prof.finish()
        ctx = dict(cell.traffic, n=inp["n"], nnz=int(inp["src"].numel()),
                   graph_build_s=graph_build_s)
        for name in per_layer_names(cell.name):
            m = module("metrics", name)
            v = m.read(tr, ctx)
            if v is not None:
                result["metrics"][name] = {"value": v, "unit": m.UNIT}
        if tr.jobs and tr.device:
            dev_info["busy_s"] = tr.busy_s()
            dev_info["window_s"] = tr.window_s
            result["breakdown"] = breakdown(tr)
        if cuda:
            dev_info["power_limit"] = power_limit()
    else:
        e2e = drv.end_to_end(jobs, window_s)
        e2e["setup_s"] = (setup_s, "s")
        for name in cell.end_to_end:
            v, unit = e2e[name]
            result["metrics"][name] = {"value": v, "unit": unit}

    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ms = sorted(j.latency_s * 1e3 for j in jobs)
    log(f"window: {len(jobs)} jobs in {window_s:.3f} s; job ms min "
        f"{ms[0]:.1f} median {percentile(ms, 50):.1f} p95 "
        f"{percentile(ms, 95):.1f} max {ms[-1]:.1f}; {len(kept)} answers "
        "kept")
    t0 = time.perf_counter()
    readings = drv.check(inp, kept, cell.traffic, seed, device)
    log(f"check: {time.perf_counter() - t0:.3f} s")
    judge(result, readings, cell.limits)
    return result


def log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def judge(result: dict, readings, limits: dict) -> None:
    """Fill ``correct``, ``failed`` and ``checks`` from the readings
    ``(answer, name, value)``: an answer fails where one of its numbers
    passes its limit; ``checks`` holds each number's worst reading."""
    worst, bad = {}, set()
    for idx, name, v in readings:
        worst[name] = max(v, worst.get(name, float("-inf")))
        if not v <= limits[name]:      # NaN fails too
            bad.add(idx)
    result["failed"] = len(bad)
    result["correct"] = not bad and bool(readings) and set(worst) == set(
        limits)
    result["checks"] = {name: {"value": worst[name], "limit": limits[name]}
                        for name in sorted(worst)}
