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
SOURCES = ("spmv2u.cu", "compact.cu")
BUILD_DIR = _PKG.parent / "build" / "graphmat_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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


def build() -> Path:
    """Compile the kernels if this exact source set has not been built;
    returns the library's path.  The compiler's output (``-Xptxas -v``:
    registers and spills per kernel) is kept beside it as ``.log``."""
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libgmtorch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=BUILD_TIMEOUT_S)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"\nexit {proc.returncode} after "
           f"{time.perf_counter() - t0:.1f} s\n")
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {out.name}:\n{log}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built first if needed; loaded once per process
    (every launch calls this, so it must cost nothing after the first)."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gm_spmv.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.gm_spmv.restype = i
    lib.gm_aux_gather.argtypes = [p, p, p, ctypes.c_longlong, i, p]
    lib.gm_aux_gather.restype = i
    lib.gm_error_string.argtypes = [i]
    lib.gm_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if rc != 0:
        msg = lib.gm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
