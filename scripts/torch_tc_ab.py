"""Time TriangleCounting's two kernels, T1 (the core count) and T2 (the
tail count), against their parent's, in one process on one GPU, on the
arguments each version's own prep gives for the same graph: RMAT-20 and
RMAT-22 x 16, seed 1 (the JAX package's stream), upper-triangular,
counted with ``assume_canonical=True`` at the default core size.

The parent is commit aa85b24 (before T1 read a two-level bitmap and T2
staged its lists in shared memory).  Its kernel source and its
``ops/triangles.py`` are taken from git and handed to this script::

    mkdir -p build
    git show aa85b24:graphmat_tpu_torch/csrc/triangles.cu > build/tc_parent.cu
    git show aa85b24:graphmat_tpu_torch/ops/triangles.py > build/tc_parent.py
    python3 scripts/torch_tc_ab.py --parent-cu build/tc_parent.cu \\
        --parent-py build/tc_parent.py [--scales 20 22] [--rounds 4]

Both sources are built with ``nvcc`` (the package's flags) into
``build/tc_ab/`` and called through ``ctypes``: ``parent`` from the
parent's source on the parent prep's arguments, ``cur`` from the
package's source on the current prep's.  The two preps' common
arguments (the bitmap, the edge planes, the tail lists and the probes,
which the current prep lists with the narrow class pairs first) must be
equal, so both versions count the same inputs.  Rounds
alternate the order (forward, then backward); each time is the median of
10 launches after 2 warm-up ones (CUDA events).  The current kernels'
per-vertex counts must equal the parent's exactly.  One JSON line a scale, on
stdout and in ``build/tc_ab/tc_ab.json``: medians over the rounds, each
round's time, the bounds (bytes read once at 3.35 TB/s: T1 the bitmap
and three planes, the parent's reads, and the new design's summaries,
the bitmap's nonzero words and three planes; T2 the tail lists and four
planes) and each median's share of them, and the card's name and power
limit; and both versions' T2 time on the probes of each of the
``--pairs`` class pairs with the most probes.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from graphmat_tpu_torch.io.transforms import \
    convert_to_upper_triangular  # noqa: E402
from graphmat_tpu_torch.ops import _lib  # noqa: E402
from graphmat_tpu_torch.ops import triangles as tri  # noqa: E402
from graphmat_tpu_torch.utils.generators import rmat_edgelist  # noqa: E402
from perfbench.roofline import bound_s  # noqa: E402

OUT = os.path.join(ROOT, "build", "tc_ab")
SRC = os.path.join(ROOT, "graphmat_tpu_torch", "csrc", "triangles.cu")
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(sources):
    """Compile both sources at once: name -> source -> name -> library."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = subprocess.Popen(
            [_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        with open(os.path.join(OUT, f"{name}.log"), "w") as f:
            f.write(log)
        if p.returncode:
            raise SystemExit(f"{name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        if name == "parent":
            lib.gm_tc_core_count.argtypes = [P, I, I, P, P, P, LL, P, P]
            lib.gm_tc_tail_count.argtypes = [P, ctypes.POINTER(I), I, P, P,
                                             P, P, LL, P, P]
        else:   # T1 takes the summaries, T2 the wide pairs' threshold
            lib.gm_tc_core_count.argtypes = [P, I, P, I, I, P, P, P, LL, P,
                                             P]
            lib.gm_tc_tail_count.argtypes = [P, ctypes.POINTER(I), I, I, P,
                                             P, P, P, LL, P, P]
        lib.gm_tc_core_count.restype = I
        lib.gm_tc_tail_count.restype = I
        libs[name] = lib
    return libs


def parent_module(path):
    """The parent's ops/triangles.py, imported beside the package's (its
    relative imports resolve to the package's _lib and neighbors)."""
    spec = importlib.util.spec_from_file_location(
        "graphmat_tpu_torch.ops._tc_parent", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stream():
    return torch.cuda.current_stream().cuda_stream


def t1_call(lib, name, t1, pv):
    if name == "parent":
        bm, iu, iv, s = t1
        rc = lib.gm_tc_core_count(bm.data_ptr(), bm.shape[1] // 4,
                                  bm.shape[0] - 1, iu.data_ptr(),
                                  iv.data_ptr(), s.data_ptr(), iu.numel(),
                                  pv.data_ptr(), stream())
    else:
        bm, sm, iu, iv, s = t1
        rc = lib.gm_tc_core_count(bm.data_ptr(), bm.shape[1], sm.data_ptr(),
                                  sm.shape[1], bm.shape[0] - 1,
                                  iu.data_ptr(), iv.data_ptr(), s.data_ptr(),
                                  iu.numel(), pv.data_ptr(), stream())
    if rc:
        raise RuntimeError(f"{name}: T1 returned CUDA error {rc}")


def t2_call(lib, name, t2, pv):
    mats, ladder, gk, fa, fb, sp = t2
    lad = (I * len(ladder))(*ladder)
    wide = () if name == "parent" else (tri._TAIL_WIDE_FROM,)
    rc = lib.gm_tc_tail_count(mats.data_ptr(), lad, len(ladder), *wide,
                              gk.data_ptr(), fa.data_ptr(), fb.data_ptr(),
                              sp.data_ptr(), gk.numel(), pv.data_ptr(),
                              stream())
    if rc:
        raise RuntimeError(f"{name}: T2 returned CUDA error {rc}")


def rounds_ms(libs, args, call, nacc, rounds):
    """name -> per-round median ms, and name -> the last launch's counts
    (a fresh zero each launch)."""
    names = list(libs)
    out = {n: [] for n in names}
    pv = {n: torch.zeros(nacc, dtype=torch.int32, device="cuda")
          for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            out[n].append(cs.event_ms(
                lambda: call(libs[n], n, args[n], pv[n].zero_()), 10))
    return out, pv


def summarize(times, bound):
    return {n: {"median_ms": statistics.median(ts), "rounds_ms": ts,
                "spread_ms": [min(ts), max(ts)],
                "share_of_bound": bound / statistics.median(ts)}
            for n, ts in times.items()}


def pair_span(gk, g):
    """[start, end) of class pair ``g``'s probes, a run of each prep's
    planes."""
    at = torch.nonzero(gk == g).flatten()
    s, e = int(at[0]), int(at[-1]) + 1
    if e - s != at.numel():
        raise AssertionError(f"class pair {g}'s probes are not one run")
    return s, e


def pair_ms(libs, args2, nacc, top):
    """Each version's T2 time on the probes of each of the ``top`` class
    pairs with the most probes (their run of each version's planes)."""
    counts = torch.bincount(args2["cur"][2].long()).tolist()
    spans = sorted(((c, g) for g, c in enumerate(counts) if c),
                   reverse=True)[:top]
    ncls = len(args2["cur"][1])
    out = []
    for cnt, g in spans:
        sl = {}
        for n, a in args2.items():
            s, e = pair_span(a[2], g)
            sl[n] = (*a[:2], *(x[s:e] for x in a[2:]))
        pv = torch.zeros(nacc, dtype=torch.int32, device="cuda")
        out.append({"pair": [args2["cur"][1][g // ncls],
                             args2["cur"][1][g % ncls]], "probes": cnt,
                    "ms": {n: cs.event_ms(lambda: t2_call(
                        libs[n], n, sl[n], pv.zero_()), 5)
                        for n in libs}})
    return out


def probe_rows(t2):
    """T2's probes ``(gk, fa, fb, sp)`` as the rows of a [4, P] tensor in
    one order (the current prep lists the narrow class pairs first)."""
    rows = torch.stack([x.long() for x in t2[2:]])
    idx = torch.arange(rows.shape[1], device=rows.device)
    for k in (3, 2, 1, 0):   # stable sorts, the last key first
        idx = idx[torch.sort(rows[k, idx], stable=True).indices]
    return rows[:, idx]


def one_scale(scale, libs, parent, rounds, pairs):
    e = convert_to_upper_triangular(rmat_edgelist(scale, 16, seed=1,
                                                  device="cuda"))
    u, v = cs.tc_pairs(e)
    n = e.n
    del e
    p1, *p2 = parent._kernel_args(u, v, n, canonical=True)
    c1, *c2 = tri._kernel_args(u, v, n, canonical=True)
    bm, sm, iu, iv, s = c1
    same = (all(torch.equal(a, b) for a, b in zip(p1, (bm, iu, iv, s)))
            and len(p2) == len(c2) == 1
            and torch.equal(p2[0][0], c2[0][0])
            and list(p2[0][1]) == list(c2[0][1])
            and torch.equal(probe_rows(p2[0]), probe_rows(c2[0])))
    if not same:
        raise AssertionError(f"RMAT-{scale}: the two preps' common "
                             "arguments differ")
    nacc = n + 1
    res = {"scale": scale, "edges": iu.numel(), "bitmap_rows": bm.shape[0],
           "same_inputs": same}
    args1 = {name: (p1 if name == "parent" else c1) for name in libs}
    t1, pv1 = rounds_ms(libs, args1, t1_call, nacc, rounds)
    planes = 3 * iu.numel() * 4 + nacc * 4
    nonzero = int((bm != 0).sum())
    b_old = bound_s(bm.numel() * 4 + planes) * 1e3
    b_new = bound_s(sm.numel() * 4 + nonzero * 4 + planes) * 1e3
    res["t1"] = {"bound_ms_parent_reads": b_old, "bound_ms": b_new,
                 "bitmap_nonzero_words": nonzero,
                 "by_version": summarize(t1, b_new)}
    for name, pv in pv1.items():
        cs.exact_err(f"RMAT-{scale} T1 {name}", pv, pv1["parent"])
    del pv1
    args2 = {name: (p2[0] if name == "parent" else c2[0]) for name in libs}
    mats, gk = c2[0][0], c2[0][2]
    t2, pv2 = rounds_ms(libs, args2, t2_call, nacc, rounds)
    b2 = bound_s(mats.numel() * 4 + 4 * gk.numel() * 4 + nacc * 4) * 1e3
    res["t2"] = {"probes": gk.numel(), "bound_ms": b2,
                 "by_version": summarize(t2, b2)}
    for name, pv in pv2.items():
        cs.exact_err(f"RMAT-{scale} T2 {name}", pv, pv2["parent"])
    res["t2"]["by_pair"] = pair_ms(libs, args2, nacc, pairs)
    for part in ("t1", "t2"):
        med = {k: v["median_ms"]
               for k, v in res[part]["by_version"].items()}
        res[part]["speedup_cur_over_parent"] = med["parent"] / med["cur"]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-cu", required=True)
    ap.add_argument("--parent-py", required=True)
    ap.add_argument("--scales", type=int, nargs="+", default=[20, 22])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=6,
                    help="T2's class pairs timed apart, most probes first")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_tc_ab: needs a CUDA GPU")
    card = cs.card_line()
    libs = build({"parent": args.parent_cu, "cur": SRC})
    parent = parent_module(args.parent_py)
    out = []
    for scale in args.scales:
        res = one_scale(scale, libs, parent, args.rounds, args.pairs)
        res["card"] = card
        print(json.dumps(res), flush=True)
        out.append(res)
        torch.cuda.empty_cache()
    with open(os.path.join(OUT, "tc_ab.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
