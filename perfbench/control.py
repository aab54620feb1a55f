"""The control of a cell's check: the plain reference, computed in a
precision below the configured one, put in the program's place and
judged by the same comparison, which it has to fail.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed: each number's worst reading beside the
cell's limit, and whether the control failed; where the driver plants
faults of its own (``faults``), the same for each.  The benchmark's own runs
never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

def control_readings(cell, seed: int, device) -> dict:
    import torch
    from perfbench import harness
    drv = harness.driver(cell)
    name = drv.CONTROL_DTYPE
    inp = drv.inputs(cell.config, cell.traffic, seed, device)
    readings = drv.control(inp, cell.traffic, seed, device,
                           getattr(torch, name))
    res = {"failed": 0}
    harness.judge(res, readings, cell.limits)
    out = {"seed": seed, "dtype": name,
           "control_failed": res["failed"] > 0, "checks": res["checks"]}
    # planted faults that a driver can read without the program
    for fault, fr in getattr(drv, "faults", lambda *a: {})(
            inp, cell.traffic, seed, device).items():
        res = {"failed": 0}
        harness.judge(res, fr, cell.limits)
        out[fault] = {"failed": res["failed"] > 0, "checks": res["checks"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(cell, seed, "cuda")
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
