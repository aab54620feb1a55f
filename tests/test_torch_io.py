"""Edge-list I/O and generators of the PyTorch port against the JAX
package's, on the same files and arguments."""

import os

import numpy as np
import pytest
import torch

import graphmat_tpu.io.edgelist as jio
from graphmat_tpu.utils import generators as jgen

import graphmat_tpu_torch.io.edgelist as tio
from graphmat_tpu_torch.io.transforms import remove_duplicate_edges
from graphmat_tpu_torch.utils import generators as tgen

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _same(a, b):
    assert (a.m, a.n, a.nnz) == (b.m, b.n, b.nnz)
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.val, b.val)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", ["test.bin.mtx", "ratings7.bin.mtx",
                                  "2_10_upper_triangle.bin.mtx"])
def test_load_edgelist_matches_jax(name):
    path = os.path.join(DATA, name)
    _same(tio.load_edgelist(path), jio.load_edgelist(path))


@pytest.mark.parametrize("binary", [True, False])
def test_write_then_load_shards_matches_jax(tmp_path, binary):
    e = jgen.random_edgelist(50, 4, seed=3, weight_range=9)
    prefix = str(tmp_path / "g.mtx")
    written = tio.write_edgelist(e, prefix, binaryformat=binary, nshards=3)
    assert written == [f"{prefix}{i}" for i in range(3)]
    _same(tio.load_edgelist(prefix, binaryformat=binary),
          jio.load_edgelist(prefix, binaryformat=binary))
    _same(tio.load_edgelist(prefix, binaryformat=binary), e)


def test_numpy_generators_match_jax():
    _same(tgen.chain_edgelist(17), jgen.chain_edgelist(17))
    _same(tgen.random_edgelist(300, 6, seed=4, weight_range=5),
          jgen.random_edgelist(300, 6, seed=4, weight_range=5))


def test_rmat_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tgen.rmat_edgelist(6, 4, seed=1)
    assert tgen.rmat_edgelist(6, 4, seed=1, device="cpu").src.device.type \
        == "cpu"


def test_rmat_no_selfedges_no_duplicates_deterministic():
    e = tgen.rmat_edgelist(10, 8, seed=11, device="cpu")
    assert isinstance(e.src, torch.Tensor) and e.src.dtype == torch.int32
    n = 1 << 10
    assert (e.m, e.n) == (n, n)
    assert 0.75 * 8 * n < e.nnz <= 8 * n   # duplicates dropped
    assert bool((e.src != e.dst).all())
    key = e.src.long() * (n + 1) + e.dst.long()
    assert torch.unique(key).numel() == e.nnz
    assert int(e.src.min()) >= 1 and int(e.dst.max()) <= n
    again = tgen.rmat_edgelist(10, 8, seed=11, device="cpu")
    assert torch.equal(e.src, again.src) and torch.equal(e.dst, again.dst)
    other = tgen.rmat_edgelist(10, 8, seed=12, device="cpu")
    assert e.nnz != other.nnz or not torch.equal(e.dst, other.dst)


def test_rmat_quadrant_skew():
    """a=0.57 puts most edges in the low-id quadrant at every level: the
    top bit of both endpoints is clear for about a fraction 0.57."""
    e = tgen.rmat_edgelist(12, 16, seed=2, dedup=False,
                             device="cpu")
    half = 1 << 11
    both_low = ((e.src <= half) & (e.dst <= half)).double().mean()
    assert abs(float(both_low) - 0.57) < 0.02


def test_remove_duplicate_edges_torch_matches_numpy():
    rng = np.random.default_rng(0)
    src = rng.integers(1, 30, 500).astype(np.int32)
    dst = rng.integers(1, 30, 500).astype(np.int32)
    val = np.arange(500, dtype=np.int32)
    e_np = tio.EdgeList(29, 29, src, dst, val)
    e_t = tio.EdgeList(29, 29, torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(val))
    _same(remove_duplicate_edges(e_t), remove_duplicate_edges(e_np))
