"""How many steps PageRank takes to converge on each scalar kernel route,
one device and sharded, on one GPU.

PageRank stops when no vertex moves by more than its tolerance (1e-5),
which is below the float32 ulp of a value above 128.  So a route whose
sums change their last bits from launch to launch (a push that summed by
atomics, ROADMAP P6) may never stop.  This script runs ``run_pagerank``
to convergence (at most ``--max`` steps) ``--reps`` times on an RMAT
graph from a seed, on K1 and on the push (``GRAPHMAT_KERNEL=v2``), on one
device and on a 2x4 LocalMesh of the card, and prints one JSON line: the
iteration counts, the largest PageRank value, the card and its power
limit.  With ``--check`` it exits 1 when a run reached the cap or the
push took another count of steps than K1 on the same graph.  Run from
the repository root::

    python3 scripts/torch_push_convergence.py --scale 16 --reps 4 --check
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--max", type=int, default=3000)
    ap.add_argument("--check", action="store_true",
                    help="exit 1 at the cap, or when the push's count of "
                         "steps differs from K1's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    from graphmat_tpu_torch import Graph
    from graphmat_tpu_torch.apps.pagerank import (DegreeProgram,
                                                  PageRankProgram,
                                                  init_pagerank_graph)
    from graphmat_tpu_torch.core.runtime import engine_for
    from graphmat_tpu_torch.parallel.dist_graph import DistGraph
    from graphmat_tpu_torch.parallel.mesh import LocalMesh
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    e = rmat_edgelist(args.scale, 16, seed=7, device="cuda")
    graphs = {"one_device": Graph(e, permute="degree"),
              "2x4": DistGraph(e, LocalMesh(["cuda"] * 8, (2, 4)))}
    out = {"card": card, "scale": args.scale, "max": args.max,
           "iterations": {}}
    for route in ("v2u", "v2"):
        os.environ["GRAPHMAT_KERNEL"] = route
        for name, g in graphs.items():
            its = []
            for _ in range(args.reps):
                init_pagerank_graph(g)
                g.set_all_active()
                engine_for(DegreeProgram(), g).run(iterations=1)
                its.append(engine_for(PageRankProgram(), g).run(
                    max_iterations=args.max))
            out["iterations"][f"{route} {name}"] = its
            out[f"max_pagerank {name}"] = float(
                g.vp_numpy()["pagerank"].max())
    its = out["iterations"]
    bad = [f"{k}: {v}" for k, v in its.items() if max(v) >= args.max]
    bad += [f"{name}: push {its['v2 ' + name]}, K1 {its['v2u ' + name]}"
            for name in graphs if its[f"v2 {name}"] != its[f"v2u {name}"]]
    if args.check:
        out["check"] = "failed: " + "; ".join(bad) if bad else "passed"
    print(json.dumps(out))
    return 1 if args.check and bad else 0


if __name__ == "__main__":
    sys.exit(main())
