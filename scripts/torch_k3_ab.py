"""Time the port's K3 kernel against other copies of its source, in one
process on one GPU: the dense mode (``sgd`` on MovieLens-25M's item rows
at K = 20, 96 and 128; ``lda`` on NYTimes' term rows at K = 20, and again
with x's 21-float rows left unpadded for the copies) and the sparse mode
(``sgd`` at 100%, 10%, 1% and 0.01% of senders sent, at K = 20 and 4), on
random operands from a seed.

Each copy is built with ``nvcc`` into ``build/k3_ab/`` and called through
``ctypes``.  The package's own build is timed as ``pkg``, through its
wrapper, whose host-side checks the CUDA events include (10-20 us a
call); name the package's source as a copy to compare kernels alone.  A
copy is a whole ``.cu`` file (``name=path``), or the package's source with
text replaced (``name=path.json``, a list of [old, new] pairs), or a
whole file with text replaced (``name=file.cu+path.json``).  A source
whose ``gm_spmv_vec2`` has no ``ldx`` argument (K3 before its redesign)
is called without one and given x unpadded; the other copies get x
unpadded in the ``lda_k20_unpadded`` case (4-byte loads).  Run from the
repository root::

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
difference from ``pkg``'s output.
"""

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
from graphmat_tpu_torch.ops import spmv_vec as ss  # noqa: E402
from graphmat_tpu_torch.ops import spmv_vec2 as sv  # noqa: E402

OUT = os.path.join(ROOT, "build", "k3_ab")
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
    """Compile every copy at once; name -> (library, has ldx)."""
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
        pp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gm_copy.argtypes = [pp] * 9 + [i] * (4 if ldx else 3) + [f] * 3 \
            + [pp]
        lib.gm_copy.restype = i
        libs[name] = (lib, ldx)
    return libs


def call(libs, name, csr, x, op, vp, extra, params, sent=None, pad=True):
    if name == "pkg":
        if sent is None:
            return sv.spmv_vec_csr(csr.rowptr, csr.col, csr.val_f32, x, op,
                                   vp, extra, params)
        return ss.spmv_vec_sparse_csr(csr.rowptr, csr.col, csr.val_f32, x,
                                      op, sent, vp, extra, params)[0]
    lib, ldx = libs[name]
    k = x.shape[1]
    if ldx and k % 4 and pad:
        x = torch.nn.functional.pad(x, (0, -k % 4))
    y = torch.empty((csr.n_rows, sv.out_width(op, k)), device=x.device)
    got = (torch.empty(csr.n_rows, dtype=torch.int32, device=x.device)
           if sent is not None else None)
    dims = [csr.n_rows, k] + ([x.shape[1]] if ldx else []) + [sv._OP_CODE[op]]
    rc = lib.gm_copy(
        csr.rowptr.data_ptr(), csr.col.data_ptr(), csr.val_f32.data_ptr(),
        x.data_ptr(), vp.data_ptr() if vp is not None else None,
        extra.data_ptr() if extra is not None else None,
        sent.data_ptr() if sent is not None else None, y.data_ptr(),
        got.data_ptr() if got is not None else None, *dims,
        *sv._scalars(op, params), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    return y


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_ab: needs a CUDA GPU")
    libs = build(sources(sys.argv[1:]))
    dev = "cuda"
    ml, nt = cs.MOVIELENS_25M, cs.NYTIMES
    g_ml = Graph(cs.ratings_edgelist(ml["users"], ml["items"], ml["ratings"],
                                     25, dev), device=dev, permute=False)
    g_nt = Graph(cs.nytimes_edgelist(nt["docs"], nt["terms"], nt["entries"],
                                     29, dev), device=dev, permute=False)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    params = {"alpha": 1.0, "eta": 5.0, "vocab_size": nt["terms"]}
    c_ml = g_ml.csr("dst")
    cases = []
    for k in (20, 96, 128):
        x, vp, _ = cs.k3_inputs("sgd", k, g_ml.n_pad, gen, dev)
        cases.append((f"sgd_k{k}", c_ml, x, "sgd", vp, None, None, True))
    xl, vpl, exl = cs.k3_inputs("lda", 20, g_nt.n_pad, gen, dev)
    for pad in (True, False):
        cases.append(("lda_k20" + ("" if pad else "_unpadded"),
                      g_nt.csr("dst"), xl, "lda", vpl, exl, None, pad))
    for k in (20, 4):
        x, vp, _ = cs.k3_inputs("sgd", k, g_ml.n_pad, gen, dev)
        for p in (1.0, 0.1, 0.01, 1e-4):
            sent = (torch.rand(g_ml.n_pad, generator=gen, device=dev)
                    < p).to(torch.uint8)
            cases.append((f"sparse_k{k}_{p:g}", c_ml, x, "sgd", vp, None,
                          sent, True))
    names = ["pkg"] + list(libs)
    res = {"card": cs.card_line()}
    for case, csr, x, op, vp, extra, sent, pad in cases:
        ref = call(libs, "pkg", csr, x, op, vp, extra, params, sent)
        row = {}
        for n in names + names[::-1]:
            err = float((call(libs, n, csr, x, op, vp, extra, params, sent,
                              pad) - ref).abs().max())
            ms = cs.event_ms(lambda: call(libs, n, csr, x, op, vp, extra,
                                          params, sent, pad), 10)
            row.setdefault(n, []).append(ms)
            row[n + "_max_abs_diff"] = err
        res[case] = row
        print(case, json.dumps(row), flush=True)
    print("torch_k3_ab: " + json.dumps(res))


if __name__ == "__main__":
    main()
