"""The port's host C++ library, built with ``g++`` and loaded with ctypes.

``glibc.cpp`` holds the port's own copy of the one native function of the
JAX package (``graphmat_tpu/native/planner.cpp``) that a ported module
calls: ``gm_glibc_square_mapping``, the reference converter's seeded
vertex-id permutation (:func:`graphmat_tpu_torch.utils.reference_rng.
glibc_square_mapping`).  At first use ``g++ -O3 -shared -fPIC`` compiles
it into ``build/graphmat_tpu_torch/`` beside the package, named by a hash
of the source and flags.  Several processes may build at once (the test
suite runs in parallel workers): the build holds a file lock, writes a
temporary name and renames it into place.  A failed build raises; nothing
falls back to numpy unless the caller asks (``native=False``).  Nothing
here runs at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

__all__ = ["build", "load"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "glibc.cpp"
BUILD_DIR = _HERE.parents[1] / "build" / "graphmat_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300


def build() -> Path:
    """Compile the library if this source and these flags have not been
    built; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libgmhost_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libgmhost.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # another process built it while we waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(
                f"g++ could not build {out.name} ({exc}); pass "
                "native=False to take the numpy mapping") from exc
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed building {out.name} (exit {res.returncode}); "
                f"pass native=False to take the numpy mapping:\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The host library, built first if needed; loaded once per
    process."""
    lib = ctypes.CDLL(str(build()))
    lib.gm_glibc_square_mapping.argtypes = [
        ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p]
    lib.gm_glibc_square_mapping.restype = None
    return lib
