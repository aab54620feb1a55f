"""The port's glibc id shuffle, randomize transforms, EdgeList record
helpers, fixture generators and ``read_mtx`` against the JAX package's,
and the port's native build from several processes at once.  Every
comparison is exact: the functions move integers and copy values.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphmat_tpu as gm
from graphmat_tpu.io import transforms as jtf
from graphmat_tpu.utils import generators as jgen
from graphmat_tpu.utils.reference_rng import (
    glibc_rand_np as jax_glibc_rand_np,
    glibc_square_mapping_np as jax_mapping_np)

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.io import transforms as ttf
from graphmat_tpu_torch.utils import generators as tgen
from graphmat_tpu_torch.utils.reference_rng import (
    glibc_rand_np, glibc_square_mapping, glibc_square_mapping_np)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_glibc_rand_equals_jax(seed):
    np.testing.assert_array_equal(glibc_rand_np(seed, 2000),
                                  jax_glibc_rand_np(seed, 2000))


@pytest.mark.parametrize("m", [1, 7, 1000, 1 << 16])
@pytest.mark.parametrize("seed", [5, 0])
def test_mappings_equal_jax_numpy(m, seed):
    want = jax_mapping_np(m, seed)
    np.testing.assert_array_equal(glibc_square_mapping_np(m, seed), want)
    c = glibc_square_mapping(m, seed)
    assert c.dtype == np.int32
    np.testing.assert_array_equal(c, want)
    np.testing.assert_array_equal(glibc_square_mapping(m, seed,
                                                       native=False), want)


def test_glibc_golden():
    """tests/test_transforms.py's ground truth, from C code calling the
    real glibc srand/rand: the raw sequence after srand(5), the m = 8
    mapping and the m = 1000 mapping's FNV-1a hash, on both forms."""
    np.testing.assert_array_equal(
        glibc_rand_np(5, 10),
        [590011675, 99788765, 2131925610, 171864072, 317159276,
         171035632, 602511920, 963050649, 1069979073, 1919854381])
    for native in (True, False):
        np.testing.assert_array_equal(
            glibc_square_mapping(8, native=native), [6, 7, 2, 3, 4, 0, 1, 5])
        m1000 = glibc_square_mapping(1000, native=native)
        h = 1469598103934665603
        for v in m1000:
            h = ((h ^ int(v)) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
        assert h == 10847347724954123681
        assert m1000[:5].tolist() == [228, 765, 249, 998, 276]


def _edges(seed=11):
    return jgen.random_edgelist(300, 4, seed=seed, weight_range=9)


def _port_copy(e, as_torch):
    if as_torch:
        return gt.EdgeList(e.m, e.n, torch.from_numpy(e.src.copy()),
                           torch.from_numpy(e.dst.copy()),
                           torch.from_numpy(e.val.copy()))
    return gt.EdgeList(e.m, e.n, e.src.copy(), e.dst.copy(), e.val.copy())


def _arrays(e):
    return [a.numpy() if isinstance(a, torch.Tensor) else a
            for a in (e.src, e.dst, e.val)]


@pytest.mark.parametrize("as_torch", [False, True])
@pytest.mark.parametrize("seed", [0, 13])
def test_randomize_edge_direction_equals_jax(as_torch, seed):
    e = _edges()
    want = jtf.randomize_edge_direction(e, seed=seed)
    got = ttf.randomize_edge_direction(_port_copy(e, as_torch), seed=seed)
    assert isinstance(got.src, torch.Tensor) == as_torch
    assert (got.m, got.n) == (want.m, want.n)
    for a, b in zip(_arrays(got), (want.src, want.dst, want.val)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("native", [None, False])
@pytest.mark.parametrize("as_torch", [False, True])
@pytest.mark.parametrize("seed", [5, 0])
def test_randomize_vertex_ids_equals_jax(as_torch, native, seed):
    e = _edges(3)
    want, want_perm = jtf.randomize_vertex_ids(e, seed=seed)
    got, perm = ttf.randomize_vertex_ids(_port_copy(e, as_torch), seed=seed,
                                         native=native)
    assert isinstance(perm, torch.Tensor) == as_torch
    np.testing.assert_array_equal(np.asarray(perm), want_perm)
    for a, b in zip(_arrays(got), (want.src, want.dst, want.val)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="square"):
        ttf.randomize_vertex_ids(gt.EdgeList(3, 4, e.src[:0], e.dst[:0],
                                             e.val[:0]))


@pytest.mark.parametrize("as_torch", [False, True])
def test_astuple_and_as_records(as_torch):
    e = _edges(5)
    p = _port_copy(e, as_torch)
    s, d, v = p.astuple()
    assert s is p.src and d is p.dst and v is p.val
    recs = p.as_records()
    assert recs == e.as_records()
    assert all(type(x) is int for r in list(recs)[:10] for x in r)


@pytest.mark.parametrize("n", [1, 2, 9])
def test_identity_and_circular_chain_equal_jax(n):
    for name in ("identity_edgelist", "circular_chain_edgelist"):
        a, b = getattr(tgen, name)(n), getattr(jgen, name)(n)
        assert (a.m, a.n) == (b.m, b.n)
        for x, y in zip(a.astuple(), b.astuple()):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fname", ["test.bin.mtx", "ratings7.bin.mtx",
                                   "2_10_upper_triangle.bin.mtx"])
def test_read_mtx_on_cpu_equals_jax(fname):
    path = os.path.join(DATA, fname)
    g = gt.read_mtx(path, device="cpu")
    gj = gm.read_mtx(path)
    assert g.device.type == "cpu"
    assert g.nvertices == gj.nvertices
    assert g.get_edges().as_records() == gj.get_edges().as_records()


def test_read_mtx_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is taken")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gt.read_mtx(os.path.join(DATA, "test.bin.mtx"))


def test_native_build_from_several_processes(tmp_path):
    """Four processes build the host library into an empty build
    directory at once: each loads a working library, and one file is
    left, no temporaries."""
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "import graphmat_tpu_torch.native as nat\n"
        "nat.BUILD_DIR = Path(sys.argv[1])\n"
        "from graphmat_tpu_torch.utils.reference_rng import "
        "glibc_square_mapping\n"
        "print(glibc_square_mapping(8).tolist())\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "[6, 7, 2, 3, 4, 0, 1, 5]"
    libs = sorted(f.name for f in tmp_path.iterdir())
    assert [n for n in libs if n.endswith(".so")] and all(
        n.endswith((".so", ".lock")) for n in libs), libs
    assert len([n for n in libs if n.endswith(".so")]) == 1


def test_failed_native_build_raises_and_names_the_numpy_path(
        tmp_path, monkeypatch):
    import graphmat_tpu_torch.native as nat
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(nat, "SOURCES", (bad,))
    monkeypatch.setattr(nat, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native=False"):
        nat.build()
    assert not any(f.name.endswith(".so")
                   for f in (tmp_path / "build").iterdir())
