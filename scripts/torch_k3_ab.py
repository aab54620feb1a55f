"""Time the port's K3 kernel against other copies of its source, in one
process on one GPU: the dense mode (``sgd`` on MovieLens-25M's item rows
at K = 20, 96 and 128; ``lda`` on NYTimes' term rows at K = 20, and again
with x's 21-float rows left unpadded for the copies), the sparse mode
(``sgd`` at 100%, 10%, 1% and 0.01% of senders sent, at K = 20 and 4), on
random operands from a seed, and ``skewed_*``: ``sgd`` and ``sgd_sqerr``
at K = 20 on the benchmark's own skewed MovieLens-25M draw
(``perfbench/gen/ratings.py`` with ``perfbench/configs/movielens25m-k20.json``,
seed ``--seed``), each direction (``dst``: film rows, ``src``: user
rows).  ``--only a,b`` keeps the cases whose names start with a or b.

Each copy is built with ``nvcc`` into ``build/k3_ab/`` and called through
``ctypes``.  The package's own build is timed as ``pkg``, through its
wrapper, whose host-side checks the CUDA events include (10-20 us a
call); name the package's source as a copy to compare kernels alone.  A
copy is a whole ``.cu`` file (``name=path``), or the package's source with
text replaced (``name=path.json``, a list of [old, new] pairs), or a
whole file with text replaced (``name=file.cu+path.json``).  A source
whose ``gm_spmv_vec2`` has no ``ldx`` argument (K3 before its redesign)
is called without one and given x unpadded; the other copies get x
unpadded in the ``lda_k20_unpadded`` case (4-byte loads).  A source whose
entry takes the work split (``chunk_row``) gets the CSR's
``ops/spmv2u.py: k1_plan`` and its scratch.  Each line tells, beside the
largest difference, whether a copy's output equals ``pkg``'s bit for bit
(``_equal``).  Run from the repository root::

    git show 1c7c5cf:graphmat_tpu_torch/csrc/spmv_vec2.cu > build/parent.cu
    python3 scripts/torch_k3_ab.py parent=build/parent.cu \
        nodiv=build/parent.cu+scripts/k3_nodiv.json \
        cur=graphmat_tpu_torch/csrc/spmv_vec2.cu

(Commit 1c7c5cf holds K3 before its redesign, one warp a row and one
component a lane; ``scripts/k3_nodiv.json`` applies to that source only
and turns its two divisions a component an edge in ``lda`` into
multiplications by reciprocals: the step-0 probe of the redesign.)

Copies are timed in turns, forward then backward (CUDA events, median of
10 after 2 warm-up calls); each line gives both times and the largest
difference from ``pkg``'s output.  A time is a call's share of a burst of
``BURST`` calls between two events, so that the host's part of a call
(the wrapper, ``ctypes``) hides behind the queued kernels: it is the
kernel's time, not the caller's.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from graphmat_tpu_torch import Graph  # noqa: E402
from graphmat_tpu_torch.ops import spmv2u  # noqa: E402
from graphmat_tpu_torch.ops import spmv_vec as ss  # noqa: E402
from graphmat_tpu_torch.ops import spmv_vec2 as sv  # noqa: E402

OUT = os.path.join(ROOT, "build", "k3_ab")
BURST = 10   # calls a timing event pair brackets
SRC = os.path.join(ROOT, "graphmat_tpu_torch", "csrc", "spmv_vec2.cu")


def sources(args):
    """name -> source text of each copy named on the command line."""
    base = open(SRC).read()
    out = {}
    for arg in args:
        name, path = arg.split("=", 1)
        if path.endswith(".json"):
            cu, _, path = path.rpartition("+")
            text = open(cu).read() if cu else base
            for old, new in json.load(open(path)):
                if old not in text:
                    raise SystemExit(f"{name}: {old[:60]!r} not in source")
                text = text.replace(old, new)
        else:
            text = open(path).read()
        out[name] = text.replace("gm_spmv_vec2(", "gm_copy(")
    return out


def build(texts):
    """Compile every copy at once; name -> (library, has ldx, takes the
    split)."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu = os.path.join(OUT, f"{name}.cu")
        open(cu, "w").write(text)
        procs[name] = subprocess.Popen(
            [sv._lib._nvcc(), *sv._lib.NVCC_FLAGS, "-shared", "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        open(os.path.join(OUT, f"{name}.log"), "w").write(log)
        if p.returncode:
            raise SystemExit(f"{name} did not build:\n{log[-3000:]}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        ldx = "int ldx" in texts[name]
        split = "chunk_row" in texts[name]
        pp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gm_copy.argtypes = (
            [pp] * (15 if split else 9)
            + [i] * ((4 if ldx else 3) + (2 if split else 0)) + [f] * 3
            + [pp])
        lib.gm_copy.restype = i
        libs[name] = (lib, ldx, split)
    return libs


def call(libs, name, csr, x, op, vp, extra, params, sent=None, pad=True):
    if name == "pkg":
        if sent is None:
            return sv.spmv_vec(csr, x, op, vp, extra, params)
        return ss.spmv_vec_sparse(csr, x, op, sent, vp, extra, params)[0]
    lib, ldx, split = libs[name]
    k = x.shape[1]
    if ldx and k % 4 and pad:
        x = torch.nn.functional.pad(x, (0, -k % 4))
    w = sv.out_width(op, k)
    y = torch.empty((csr.n_rows, w), device=x.device)
    got = (torch.empty(csr.n_rows, dtype=torch.int32, device=x.device)
           if sent is not None else None)
    plan_args = [None] * 6 if split else []
    plan, n_chunks = spmv2u.plan_for(csr), 0
    if split and plan.chunk_row.numel():
        n_chunks = plan.chunk_row.numel()
        part = torch.empty((n_chunks, w), device=x.device, dtype=(
            torch.float64 if op == "lda_init" else torch.float32))
        part_cnt = torch.empty(n_chunks, dtype=torch.int32, device=x.device)
        plan_args = [plan.chunk_row.data_ptr(), plan.chunk_start.data_ptr(),
                     plan.long_rows.data_ptr(), plan.long_first.data_ptr(),
                     part.data_ptr(), part_cnt.data_ptr()]
    dims = ([csr.n_rows]
            + ([n_chunks, plan.long_rows.numel() if n_chunks else 0]
               if split else [])
            + [k] + ([x.shape[1]] if ldx else []) + [sv._OP_CODE[op]])
    rc = lib.gm_copy(
        csr.rowptr.data_ptr(), csr.col.data_ptr(), csr.val_f32.data_ptr(),
        x.data_ptr(), vp.data_ptr() if vp is not None else None,
        extra.data_ptr() if extra is not None else None,
        sent.data_ptr() if sent is not None else None, y.data_ptr(),
        got.data_ptr() if got is not None else None, *plan_args, *dims,
        *sv._scalars(op, params), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return y


def skewed_graph(seed, dev):
    """The benchmark's skewed MovieLens-25M draw, as the benchmark builds
    it (``perfbench/port.py: graph``)."""
    from perfbench import harness, port
    cfg = json.load(open(os.path.join(ROOT, "perfbench", "configs",
                                      "movielens25m-k20.json")))
    inp = harness.generator(cfg).make(cfg, seed, dev)
    return port.graph(inp, dev, val=inp["val"])


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_ab: needs a CUDA GPU")
    ap = argparse.ArgumentParser()
    ap.add_argument("copies", nargs="*")
    ap.add_argument("--only", default="")
    ap.add_argument("--seed", type=int, default=7400000019)
    args = ap.parse_args()
    keep = [c for c in args.only.split(",") if c]
    libs = build(sources(args.copies))
    dev = "cuda"
    ml, nt = cs.MOVIELENS_25M, cs.NYTIMES
    g_ml = Graph(cs.ratings_edgelist(ml["users"], ml["items"], ml["ratings"],
                                     25, dev), device=dev, permute=False)
    g_nt = (Graph(cs.nytimes_edgelist(nt["docs"], nt["terms"],
                                      nt["entries"], 29, dev), device=dev,
                  permute=False)
            if not keep or any(c.startswith("lda") for c in keep) else None)
    g_sk = skewed_graph(args.seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = {"alpha": 1.0, "eta": 5.0, "vocab_size": nt["terms"]}
    c_ml = g_ml.csr("dst")
    cases = []
    for k in (20, 96, 128):
        x, vp, _ = cs.k3_inputs("sgd", k, g_ml.n_pad, gen, dev)
        cases.append((f"sgd_k{k}", c_ml, x, "sgd", vp, None, None, True))
    if g_nt is not None:
        xl, vpl, exl = cs.k3_inputs("lda", 20, g_nt.n_pad, gen, dev)
        for pad in (True, False):
            cases.append(("lda_k20" + ("" if pad else "_unpadded"),
                          g_nt.csr("dst"), xl, "lda", vpl, exl, None, pad))
        x0, _, _ = cs.k3_inputs("lda_init", 20, g_nt.n_pad, gen, dev)
        cases.append(("lda_init_k20", g_nt.csr("dst"), x0, "lda_init", None,
                      None, None, True))
    for k in (20, 4):
        x, vp, _ = cs.k3_inputs("sgd", k, g_ml.n_pad, gen, dev)
        for p in (1.0, 0.1, 0.01, 1e-4):
            sent = (torch.rand(g_ml.n_pad, generator=gen, device=dev)
                    < p).to(torch.uint8)
            cases.append((f"sparse_k{k}_{p:g}", c_ml, x, "sgd", vp, None,
                          sent, True))
    x, vp, _ = cs.k3_inputs("sgd", 20, g_sk.n_pad, gen, dev)
    for recv in ("dst", "src"):
        for op in ("sgd", "sgd_sqerr"):
            cases.append((f"skewed_{op}_{recv}", g_sk.csr(recv), x, op, vp,
                          None, None, True))
    if keep:
        cases = [c for c in cases if any(c[0].startswith(p) for p in keep)]
    names = ["pkg"] + list(libs)
    res = {"card": cs.card_line()}
    for case, csr, x, op, vp, extra, sent, pad in cases:
        ref = call(libs, "pkg", csr, x, op, vp, extra, params, sent)
        row = {}
        for n in names + names[::-1]:
            out = call(libs, n, csr, x, op, vp, extra, params, sent, pad)
            row[n + "_max_abs_diff"] = float((out - ref).abs().max())
            row[n + "_equal"] = bool(torch.equal(out, ref))
            ms = cs.event_ms(lambda: [call(libs, n, csr, x, op, vp, extra,
                                           params, sent, pad)
                                      for _ in range(BURST)], 10)
            row.setdefault(n, []).append(ms / BURST)
        res[case] = row
        print(case, json.dumps(row), flush=True)
    print("torch_k3_ab: " + json.dumps(res))


if __name__ == "__main__":
    main()
