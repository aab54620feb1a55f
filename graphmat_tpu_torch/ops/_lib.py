"""Build and load the package's CUDA kernels.

The kernels live in ``graphmat_tpu_torch/csrc/*.cu`` with a plain C
interface.  At first use, ``nvcc`` compiles them for Hopper (``sm_90a``)
into one shared library under ``build/graphmat_tpu_torch/`` beside the
package, named by a hash of the sources and flags, and ``ctypes`` loads it.
Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "load", "check", "launch"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("spmv2u.cu", "compact.cu", "spmv_vec2.cu", "spmv2.cu",
           "triangles.cu", "rmat.cu", "rand_r.cu")
BUILD_DIR = _PKG.parent / "build" / "graphmat_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 900


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                       "CUDA kernels cannot be built")


def _run_all(cmds):
    """Run the commands at once; returns (log text, all succeeded)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, ok = [], True
    for c, p in zip(cmds, procs):
        try:
            text, _ = p.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise
        ok = ok and p.returncode == 0
        log.append(f"$ {' '.join(c)}\n{text}exit {p.returncode}\n")
    log.append(f"{len(cmds)} command(s) in "
               f"{time.perf_counter() - t0:.1f} s\n")
    return "".join(log), ok


def build() -> Path:
    """Compile the kernels if this exact source set has not been built;
    returns the library's path.  One ``nvcc`` per source, all started
    together, then one link.  The compiler's output (``-Xptxas -v``:
    registers and spills per kernel) is kept beside the library as
    ``.log``."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libgmtorch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    log, ok = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)])
    tmp = out.with_name(f"{tag}.so.tmp")
    if ok:
        link_log, ok = _run_all([[nvcc, "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        log += link_log
    for o in objs:
        o.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    if not ok:
        raise RuntimeError(f"nvcc failed building {out.name}:\n{log}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built first if needed; loaded once per process
    (every launch calls this, so it must cost nothing after the first)."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_spmv.argtypes = [p] * 17 + [i] * 11 + [p]
    lib.gm_spmv.restype = i
    lib.gm_spmv_push.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.gm_spmv_push.restype = i
    lib.gm_push_mark.argtypes = [p] * 6 + [i] * 2 + [p]
    lib.gm_push_mark.restype = i
    lib.gm_aux_gather.argtypes = [p] * 5 + [ctypes.c_longlong, p]
    lib.gm_aux_gather.restype = i
    f = ctypes.c_float
    lib.gm_spmv_vec2.argtypes = [p] * 15 + [i] * 6 + [f] * 3 + [p]
    lib.gm_spmv_vec2.restype = i
    ll = ctypes.c_longlong
    lib.gm_tc_core_count.argtypes = [p, i, p, i, i, p, p, p, ll, p, p]
    lib.gm_tc_core_count.restype = i
    lib.gm_tc_tail_count.argtypes = [p, ctypes.POINTER(i), i, i, p, p, p,
                                     p, ll, p, p]
    lib.gm_tc_tail_count.restype = i
    d, ull = ctypes.c_double, ctypes.c_ulonglong
    lib.gm_rmat_keys.argtypes = [i, ll, d, d, d, ull, p, p]
    lib.gm_rmat_keys.restype = i
    lib.gm_rmat_weights.argtypes = [p, ll, ull, i, p, p]
    lib.gm_rmat_weights.restype = i
    lib.gm_rand_r_uniform.argtypes = [ctypes.c_uint, ll, i, i, p, p]
    lib.gm_rand_r_uniform.restype = i
    lib.gm_error_string.argtypes = [i]
    lib.gm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if rc != 0:
        msg = lib.gm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def launch(entry: str, device, *args) -> None:
    """Call the library's ``entry`` for tensors on ``device`` with that
    card current, its current stream appended as the last argument, and
    raise on a CUDA error.  Every kernel wrapper launches through here:
    the stream, the launch and each ``cudaGetDevice`` inside an entry then
    name the tensors' card, whichever card the calling thread had current
    (a tile of a mesh on cuda:1 driven from a thread on cuda:0)."""
    import torch
    lib = load()
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, rc, entry)
