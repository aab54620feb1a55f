"""The port's host C++ library, built with ``g++`` and loaded with ctypes.

Its sources are the port's own copies of the native functions of the JAX
package (``graphmat_tpu/native/planner.cpp``) that ported modules call:

* ``glibc.cpp``: ``gm_glibc_square_mapping``, the reference converter's
  seeded vertex-id permutation (:func:`graphmat_tpu_torch.utils.
  reference_rng.glibc_square_mapping`);
* ``text.cpp``: ``gm_parse_text_edges``, the text edge-list parser
  (:func:`graphmat_tpu_torch.io.edgelist.load_edgelist` with
  ``binaryformat=False``);
* ``tc_prep.cpp``: ``gm_tc_create``/``gm_tc_fill``/``gm_tc_destroy``,
  TriangleCounting's host prep
  (:func:`graphmat_tpu_torch.ops.triangles.count_triangles_bucketed` with
  ``impl="host"``).

At first use ``g++ -O3 -fopenmp -shared -fPIC`` compiles them into one
library in ``build/graphmat_tpu_torch/`` beside the package, named by a
hash of the sources and flags.  Several processes may build at once (the
test suite runs in parallel workers): the build holds a file lock, writes
a temporary name and renames it into place.  A failed build raises;
nothing falls back to numpy unless the caller asks (``native=False``).
Nothing here runs at import.
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
SOURCES = tuple(_HERE / f for f in ("glibc.cpp", "text.cpp", "tc_prep.cpp"))
BUILD_DIR = _HERE.parents[1] / "build" / "graphmat_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fopenmp", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300


def build() -> Path:
    """Compile the library if these sources and flags have not been
    built; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libgmhost_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libgmhost.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():   # another process built it while we waited
            return out
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(
                f"g++ could not build {out.name} ({exc}); the id "
                "mapping takes native=False for its numpy form") from exc
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed building {out.name} (exit {res.returncode}); "
                f"the id mapping takes native=False for its numpy form:\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The host library, built first if needed; loaded once per
    process."""
    lib = ctypes.CDLL(str(build()))
    p = ctypes.c_void_p
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.gm_glibc_square_mapping.argtypes = [i64, ctypes.c_uint32, p]
    lib.gm_glibc_square_mapping.restype = None
    lib.gm_parse_text_edges.argtypes = [ctypes.c_char_p, i64, i32, p, p, p]
    lib.gm_parse_text_edges.restype = i64
    lib.gm_tc_create.argtypes = [p, p, i64, i32, i32, i32,
                                 ctypes.POINTER(i64), ctypes.POINTER(i64),
                                 ctypes.POINTER(i32)]
    lib.gm_tc_create.restype = p
    lib.gm_tc_fill.argtypes = [p] * 11
    lib.gm_tc_fill.restype = None
    lib.gm_tc_destroy.argtypes = [p]
    lib.gm_tc_destroy.restype = None
    return lib
