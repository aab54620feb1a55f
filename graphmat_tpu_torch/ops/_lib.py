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

__all__ = ["build", "load", "check"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("spmv2u.cu", "compact.cu", "spmv_vec2.cu", "spmv2.cu")
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
    lib.gm_spmv.argtypes = [p] * 15 + [i] * 10 + [p]
    lib.gm_spmv.restype = i
    lib.gm_spmv_push.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.gm_spmv_push.restype = i
    lib.gm_aux_gather.argtypes = [p, p, p, ctypes.c_longlong, i, p]
    lib.gm_aux_gather.restype = i
    f = ctypes.c_float
    lib.gm_spmv_vec2.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, f,
                                 f, p]
    lib.gm_spmv_vec2.restype = i
    lib.gm_error_string.argtypes = [i]
    lib.gm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if rc != 0:
        msg = lib.gm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
