"""The generators against their sources at tiny sizes."""

import torch

from perfbench.gen import kron, ratings
from graphmat_tpu_torch.utils.generators import rmat_edgelist

KRON = {"scale": 10, "edge_factor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
ML = {"users": 3000, "items": 1000, "ratings": 60000,
      "assumed": {"user_floor": 5, "user_top": 600, "film_q": 20.0,
                  "film_exponent": 1.5}}


def test_kron_is_the_ports_stream_with_a_large_seed():
    seed = 2 ** 33 + 12345
    e = kron.make(KRON, seed, "cpu")
    ref = rmat_edgelist(10, 16, 0.57, 0.19, 0.19, seed=seed, device="cpu")
    assert e["n"] == 1024 and e["src"].numel() == ref.nnz
    # the same edges, relabelled by the seed's permutation
    perm = kron.label_permutation(1024, seed, "cpu")
    want = torch.sort(perm[ref.src - 1] * 1024 + perm[ref.dst - 1]).values
    assert torch.equal(e["src"].long() * 1024 + e["dst"], want)
    assert not torch.equal(perm, torch.arange(1024))


def test_kron_chunks_do_not_change_the_stream(monkeypatch):
    whole = kron.make(KRON, 7, "cpu")
    monkeypatch.setattr(kron, "CHUNK", 1000)
    parts = kron.make(KRON, 7, "cpu")
    assert torch.equal(whole["src"], parts["src"])
    assert torch.equal(whole["dst"], parts["dst"])


def test_kron_edges_simple_and_skewed():
    e = kron.make(KRON, 3, "cpu")
    src, dst = e["src"].long(), e["dst"].long()
    assert bool((src != dst).all())
    key = src * e["n"] + dst
    assert torch.unique(key).numel() == key.numel()
    # dedup keeps most of the 16 * 2^10 drawn pairs
    assert 0.7 * 16 * 1024 < key.numel() <= 16 * 1024
    deg = torch.bincount(src, minlength=e["n"]).float()
    assert float(deg.max()) > 10 * float(deg.mean())


def test_kron_seeds_differ_and_repeat():
    a, b = kron.make(KRON, 1, "cpu"), kron.make(KRON, 2, "cpu")
    assert a["src"].numel() != b["src"].numel() or not torch.equal(
        a["dst"], b["dst"])
    assert torch.equal(a["dst"], kron.make(KRON, 1, "cpu")["dst"])


def test_ratings_shape_and_skew():
    r = ratings.make(ML, 2 ** 40 + 3, "cpu")
    src, dst, val = r["src"].long(), r["dst"].long(), r["val"]
    assert r["n"] == 4000 and src.numel() == 60000
    assert int(src.min()) >= 0 and int(src.max()) < 3000
    assert int(dst.min()) >= 3000 and int(dst.max()) < 4000
    assert torch.unique(src * 4000 + dst).numel() == 60000
    assert torch.equal(src, torch.sort(src).values)
    assert set((val * 2).long().unique().tolist()) <= set(range(1, 11))
    items = torch.bincount(dst - 3000, minlength=1000)
    users = torch.bincount(src, minlength=3000)
    # every user rates exactly its degree of the law; every film is rated
    want = ratings.user_degrees(3000, 60000, 5, 600)
    assert sorted(users.tolist(), reverse=True) == want.tolist()
    assert int(users.max()) == 600 and int(users.min()) == 5
    assert int(items.min()) >= 1
    assert float(items.max()) > 5 * float(items.float().mean())


def test_user_degrees_sum_to_the_ratings():
    d = ratings.user_degrees(162541, 25000095, 20, 32202)
    assert int(d.sum()) == 25000095
    assert (int(d[0]), int(d[-1])) == (32202, 20)
    assert bool((d[:-1] >= d[1:]).all())


def test_heavy_users_by_clocks_are_the_first_distinct_draws():
    """The exponential clocks and the rounds of draws give one law: a
    user's share of the most popular film is the same either way."""
    items, du = 50, 10
    w = ratings.film_weights(items, 2.0, 1.5, "cpu")
    gen = torch.Generator().manual_seed(3)
    reps = 4000
    d = torch.full((reps,), du)
    none = torch.zeros(0, dtype=torch.int64)
    top = int(torch.argmax(w))
    by_draws = ratings._light(d, w, none, items, gen) % items
    by_clock = ratings._heavy(d, w, none, items, gen) % items
    a = float((by_draws == top).sum()) / reps
    b = float((by_clock == top).sum()) / reps
    assert 0.3 < a < 1.0 and abs(a - b) < 0.05
    rare = int(torch.argmin(w))
    assert abs(float((by_draws == rare).sum() - (by_clock == rare).sum())
               ) / reps < 0.05


def test_ratings_repeat_for_a_seed():
    a, b = ratings.make(ML, 5, "cpu"), ratings.make(ML, 5, "cpu")
    assert torch.equal(a["src"], b["src"]) and torch.equal(a["val"],
                                                           b["val"])
