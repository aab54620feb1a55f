"""The port's text loader (``load_edgelist(binaryformat=False)``, through
its copy of ``gm_parse_text_edges`` in ``native/text.cpp``) against the JAX
package's, on crafted files: blank lines, CRLF, tabs, signs and no
trailing newline, with a header and without, int32, float32 and float64
weights (a fractional weight into int32 is truncated by the parser) and
no weights, a malformed row (both take ``np.loadtxt``, which raises);
and the library built by four processes at once.  Everything is exact:
the same arrays, dtypes and dims, or the same exception.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import graphmat_tpu as gj

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.io import edgelist as tedgelist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BODIES = {
    "plain": "1 2 3\n2 3 4\n3 4 5\n4 1 6\n",
    "blank_lines": "\n1 2 3\n\n   \n2 3 4\n\t\n3 4 5\n\n",
    "crlf": "1 2 3\r\n2 3 4\r\n\r\n3 4 5\r\n",
    "tabs": "1\t2\t3\n2 \t 3\t\t4\n  3 4  5  \n",
    "signs": "+1 2 +3\n2 +3 -4\n3 4 0\n",
    "no_trailing_newline": "1 2 3\n2 3 4\n3 4 5",
    "fractional": "1 2 3.75\n2 3 -4.5\n3 4 1e2\n4 1 2.5e-1\n",
    "malformed": "1 2 3\n2 x 4\n3 4 5\n",
}


def write(tmp_path, name, body, header):
    p = tmp_path / f"{name}_{int(header)}.txt"
    rows = [r for r in body.split("\n") if r.strip()]
    text = (f"5 5 {len(rows)}\n" if header else "") + body
    p.write_bytes(text.encode())
    return str(p)


def load(pkg, path, **kw):
    try:
        return pkg.load_edgelist(path, binaryformat=False, **kw)
    except ValueError as exc:
        return exc


@pytest.mark.parametrize("weights", ["int32", "float32", "float64", "none"])
@pytest.mark.parametrize("header", [True, False])
@pytest.mark.parametrize("name", sorted(BODIES))
def test_text_loader_matches_jax(tmp_path, name, header, weights):
    path = write(tmp_path, name, BODIES[name], header)
    kw = (dict(edgeweights=False) if weights == "none"
          else dict(wdtype=np.dtype(weights)))
    kw["header"] = header
    got, want = load(gt, path, **kw), load(gj, path, **kw)
    if isinstance(want, Exception):
        assert type(got) is type(want) and str(got) == str(want)
        assert name == "malformed"
        return
    assert (got.m, got.n) == (want.m, want.n)
    for a, b in zip(got.astuple(), want.astuple()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if name == "fractional" and weights == "int32":
        np.testing.assert_array_equal(got.val, [3, -4, 100, 0])


def test_text_loader_parses_natively(tmp_path, monkeypatch):
    """The rows go through the host library, not np.loadtxt."""
    path = write(tmp_path, "plain", BODIES["plain"], True)

    def no_loadtxt(*a, **k):
        raise AssertionError("np.loadtxt was called")
    monkeypatch.setattr(np, "loadtxt", no_loadtxt)
    e = gt.load_edgelist(path, binaryformat=False)
    np.testing.assert_array_equal(e.val, [3, 4, 5, 6])
    assert tedgelist._parse_text_native(b"", True, np.int32) is None
    assert tedgelist._parse_text_native(b"1 2 3\n", True, np.int64) is None


def test_text_parser_built_by_several_processes(tmp_path):
    """Four processes build the host library into an empty build
    directory at once and parse with it: each reads the same edges, and
    one library is left, no temporaries."""
    src = tmp_path / "edges.txt"
    src.write_text("3 3 2\n1 2 7\n3 1 9\n")
    build = tmp_path / "build"
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import graphmat_tpu_torch as gt\n"
        "import graphmat_tpu_torch.native as nat\n"
        "nat.BUILD_DIR = Path(sys.argv[1])\n"
        "e = gt.load_edgelist(sys.argv[2], binaryformat=False)\n"
        "print(e.src.tolist(), e.dst.tolist(), e.val.tolist())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build),
                               str(src)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "[1, 3] [2, 1] [7, 9]"
    libs = sorted(f.name for f in build.iterdir())
    assert len([n for n in libs if n.endswith(".so")]) == 1
    assert all(n.endswith((".so", ".lock")) for n in libs), libs
