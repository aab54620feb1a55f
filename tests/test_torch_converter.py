"""The port's converter (``graphmat_tpu_torch.io.converter``) against the
JAX package's, on the option sets of tests/test_converter_checkpoint.py
and the vertex-id shuffle, on each ``data/*.bin.mtx``.  Each case runs
both packages' ``run(argv)`` into two temporary directories: the return
codes, the printed lines and every output file's bytes must be equal
(exact).  A format-2 file (an npz checkpoint, whose zip entries carry
their write time) is compared by its arrays instead, each package's file
loaded by the other package.
"""

import os

import numpy as np
import pytest

from graphmat_tpu.io.converter import run as jax_run
from graphmat_tpu.utils.checkpoint import (
    load_edgelist_checkpoint as jax_load_checkpoint)

from graphmat_tpu_torch.io.converter import run as port_run
from graphmat_tpu_torch.utils.checkpoint import (
    load_edgelist_checkpoint as port_load_checkpoint)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
FILES = ["test.bin.mtx", "ratings7.bin.mtx", "2_10_upper_triangle.bin.mtx"]

# the option sets of tests/test_converter_checkpoint.py, on binary input,
# and the shuffle of ids
CASES = {
    "binary_to_text": ["--outputformat", "1", "--selfloops", "1",
                       "--duplicatededges", "1"],
    "uppertriangular_dedup": ["--uppertriangular"],
    "random_weights_split": ["--outputedgeweights", "3", "--r", "16",
                             "--split", "3"],
    "conflicting_flags": ["--uppertriangular", "--bidirectional"],
    "no_input_weights": ["--inputedgeweights", "0"],
    "checkpoint_format": ["--outputformat", "2"],
    "randomize_ids": ["--randomizeID"],
    "bidirectional_randomize_ids": ["--bidirectional", "--randomizeID"],
    "randomize_ids_seed0_text": ["--randomizeID", "--seed", "0",
                                 "--outputformat", "1"],
}


def _convert(run, argv, out_dir, capsys):
    """(return code, stdout) of ``run(argv)``, writing under out_dir."""
    os.makedirs(out_dir)
    capsys.readouterr()
    rc = run(argv)
    return rc, capsys.readouterr().out


def _both(tmp_path, capsys, inp, opts):
    """Run both converters on ``inp`` with ``opts``; returns the two
    output directories after checking codes and printed lines."""
    outs = []
    for name, run in (("jax", jax_run), ("port", port_run)):
        d = tmp_path / name
        outs.append((d, *_convert(run, [inp, str(d / "out"), *opts], d,
                                  capsys)))
    (dj, rc_j, out_j), (dp, rc_p, out_p) = outs
    assert rc_p == rc_j
    assert out_p == out_j
    return dj, dp, rc_j


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fname", FILES)
def test_converter_matches_jax(tmp_path, capsys, fname, case):
    inp = os.path.join(DATA, fname)
    dj, dp, rc = _both(tmp_path, capsys, inp,
                       ["--inputformat", "0", *CASES[case]])
    names = sorted(os.listdir(dj))
    assert sorted(os.listdir(dp)) == names
    if case == "conflicting_flags" or case == "no_input_weights":
        assert rc == 1 and names == []
        return
    assert rc == 0 and names
    for n in names:
        if n.endswith(".npz"):
            # each package's checkpoint loads in the other
            for a, b in ((jax_load_checkpoint(str(dj / n)),
                          port_load_checkpoint(str(dp / n))),
                         (port_load_checkpoint(str(dj / n)),
                          jax_load_checkpoint(str(dp / n)))):
                assert (a.m, a.n) == (b.m, b.n)
                for x, y in zip(a.astuple(), b.astuple()):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            continue
        assert (dp / n).read_bytes() == (dj / n).read_bytes(), n


def test_converter_text_input_uppertriangular_dedup(tmp_path, capsys):
    """tests/test_converter_checkpoint.py's text file: a self loop and a
    duplicate pair removed, the rest oriented low to high."""
    src = tmp_path / "in.txt"
    src.write_text("5 5 5\n3 2 1\n2 3 9\n1 1 4\n4 5 2\n4 5 7\n")
    dj, dp, rc = _both(tmp_path, capsys, str(src), ["--uppertriangular"])
    assert rc == 0
    assert (dp / "out").read_bytes() == (dj / "out").read_bytes()
    from graphmat_tpu_torch.io.edgelist import load_edgelist
    r = load_edgelist(str(dp / "out"))
    assert set(zip(r.src.tolist(), r.dst.tolist())) == {(2, 3), (4, 5)}


def test_converter_cli_runs_as_a_module(tmp_path):
    """``python -m graphmat_tpu_torch.io.converter`` prints the lines and
    writes the file that ``run`` does."""
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(__file__), "..")
    out = tmp_path / "out.bin"
    res = subprocess.run(
        [sys.executable, "-m", "graphmat_tpu_torch.io.converter",
         os.path.join(DATA, "test.bin.mtx"), str(out), "--inputformat",
         "0", "--bidirectional", "--randomizeID"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout == "Read 13 edges, 8 vertices\nWriting 26 edges\n"
    ref = tmp_path / "ref.bin"
    assert jax_run([os.path.join(DATA, "test.bin.mtx"), str(ref),
                    "--inputformat", "0", "--bidirectional",
                    "--randomizeID"]) == 0
    assert out.read_bytes() == ref.read_bytes()
