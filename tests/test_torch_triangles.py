"""TriangleCounting in the port against the JAX package on the CPU, with
the same numpy inputs: ``count_triangles_bucketed`` on both preps (the
device prep's edge planes, stats vector and group shapes too, and the
host prep's metadata), the plain versions of the two kernels (T1, the
core count; T2, the tail count) against brute-force numpy counts, and
``run_triangle_counting`` on its three routes, its CLI and the golden
fixture; the native host prep (``native/tc_prep.cpp``) against the numpy
prep and the JAX package's native prep.  The JAX side runs XLA only (no Pallas kernel reaches a
triangle count).  Counts are integers: every comparison is exact.
"""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphmat_tpu as gj
from graphmat_tpu.apps import triangle_counting as jtc
from graphmat_tpu.io.transforms import convert_to_upper_triangular
from graphmat_tpu.ops import triangles as jtri
from graphmat_tpu.utils.generators import (random_edgelist, rmat_edgelist,
                                           upper_triangular_edgelist)

import graphmat_tpu_torch as gt
from graphmat_tpu_torch.apps import triangle_counting as ttc
from graphmat_tpu_torch.ops import triangles as ttri
from graphmat_tpu_torch.ops.neighbors import PAD_ID

from test_golden import fixture, gold

_JAX = {}


def _random(seed, n, m, loops=0):
    rng = np.random.default_rng(seed)
    s, r = rng.integers(0, n, m), rng.integers(0, n, m)
    return np.r_[s, np.arange(loops)], np.r_[r, np.arange(loops)]


def _hubs(n=1500, m=60000):
    """Power-law receivers, duplicates and self loops (the JAX test's)."""
    rng = np.random.default_rng(5)
    s = rng.integers(0, n, m)
    r = (rng.zipf(1.4, m) - 1) % n
    return np.r_[s, s[:500], np.arange(50)], np.r_[r, r[:500], np.arange(50)]


def _canonical(s, r, n):
    key = np.unique(np.minimum(s, r) * n + np.maximum(s, r))
    key = key[key // n != key % n]
    return key // n, key % n


def _tail_hub(L=120, k=5):
    """K_{Y,Z} on L + L vertices and a k-clique S joined to all of Y: at a
    small core the clique's senders carry tail lists of about L ids."""
    Y, Z, S = np.arange(L), L + np.arange(L), 2 * L + np.arange(k)
    i, j = np.triu_indices(k, 1)
    return (np.r_[np.repeat(Y, L), np.repeat(S, L), S[i]],
            np.r_[np.tile(Z, L), np.tile(Y, k), S[j]])


def _case(name):
    """(s, r, n, h, canonical) of a named case."""
    if name.startswith("random"):   # duplicates and self loops
        s, r = _random(3, 900, 12000, loops=30)
        h = {"random": None, "random_h64": 64, "random_h128": 128,
             "random_h0_all_tail": 0}[name]
        return s, r, 900, h, False
    if name == "canonical_h64":
        s, r = _random(3, 900, 12000, loops=30)
        return (*_canonical(s, r, 900), 900, 64, True)
    if name.startswith("hubs"):
        return (*_hubs(), 1500, 64 if name == "hubs_h64" else None, False)
    if name == "h4096_n6000":   # a core smaller than the graph
        rng = np.random.default_rng(4)
        s = rng.integers(0, 6000, 40000)
        r = (rng.zipf(1.3, 40000) - 1) % 6000
        return s, r, 6000, 4096, False
    if name == "tail_hub_h16":
        return (*_tail_hub(), 245, 16, True)
    if name == "n90_w3":   # W = 3 words, padded to 4
        return (*_random(6, 90, 700), 90, None, False)
    assert name == "empty"
    return np.zeros(0, np.int64), np.zeros(0, np.int64), 10, None, False


CASES = ["random", "random_h64", "random_h128", "random_h0_all_tail",
         "canonical_h64", "hubs", "hubs_h64", "h4096_n6000",
         "tail_hub_h16", "n90_w3", "empty"]


def _jax_counts(name):
    if name not in _JAX:
        s, r, n, h, canon = _case(name)
        out = {}
        for impl in ("device", "host"):
            pv, total = jtri.count_triangles_bucketed(
                s, r, n, h=h, assume_canonical=canon, impl=impl)
            out[impl] = (np.asarray(pv), total)
        _JAX[name] = out
    return _JAX[name]


@pytest.mark.parametrize("impl", ["device", "host"])
@pytest.mark.parametrize("name", CASES)
def test_count_matches_jax(name, impl):
    s, r, n, h, canon = _case(name)
    want_pv, want = _jax_counts(name)[impl]
    pv, total = ttri.count_triangles_bucketed(
        torch.as_tensor(s), torch.as_tensor(r), n, h=h,
        assume_canonical=canon, impl=impl)
    assert total == want
    assert pv.dtype == torch.int32 and pv.shape == (n,)
    np.testing.assert_array_equal(pv.numpy(), want_pv)
    # both preps give the same counts, in both packages
    np.testing.assert_array_equal(pv.numpy(),
                                  _jax_counts(name)["device"][0])


@pytest.mark.parametrize("name", ["random", "random_h64", "canonical_h64",
                                  "hubs_h64", "tail_hub_h16",
                                  "random_h0_all_tail"])
def test_device_prep_planes_stats_and_groups_match_jax(name):
    """The first half of the device prep gives JAX's edge planes and stats
    vector bit for bit, and the host seam the same static shapes."""
    s, r, n, h, canon = _case(name)
    h = ttri.CORE_H if h is None else h
    uv = jnp.asarray(np.stack([s, r]).astype(np.int32))
    want = jtri._tc_stats(uv, n, h, canon)
    got = ttri._tc_stats(torch.as_tensor(s).long(),
                         torch.as_tensor(r).long(), n, h, canon)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ncr, mats_size, _, groups = jtri._group_cfg(want[-1], h, n)
    assert ttri._group_cfg(got[-1]) == (ncr, mats_size,
                                        sum(g[3] for g in groups))


@pytest.mark.parametrize("name", ["random_h64", "hubs_h64", "tail_hub_h16"])
def test_host_prep_matches_jax(name):
    s, r, n, h, canon = _case(name)
    _, want = jtri._prep(s, r, n, h=h, assume_canonical=canon)
    host = ttri._prep(s, r, n, h=h, assume_canonical=canon)
    got = ttri._tc_prep_numpy(s, r, n, ttri.CORE_H if h is None else h,
                              canon)
    assert len(host["groups"]) == want["n_groups"] >= 1
    for k in ("m", "ncr", "W"):
        assert got[k] == want[k]
    for k in ("odeg", "t_of"):
        np.testing.assert_array_equal(got[k], want[k])
    for mat in host["mats"]:   # T2 searches sorted lists
        assert (np.diff(mat.astype(np.int64), axis=1) >= 0).all()


def _native_case(graph, canon):
    """(s, r, n) 0-based: RMAT-10 or RMAT-12 (duplicates and both
    orientations), or the golden fixture; canonical pairs in a seeded
    order with ``canon``."""
    if graph == "golden":
        e = gj.load_edgelist(fixture("2_10_upper_triangle.bin.mtx"))
    else:
        e = rmat_edgelist(int(graph[4:]), 16, seed=8, dedup=False)
    s, r = e.src.astype(np.int64) - 1, e.dst.astype(np.int64) - 1
    n = max(e.m, e.n)
    if canon:
        s, r = _canonical(s, r, n)
        order = np.random.default_rng(2).permutation(len(s))
        s, r = s[order], r[order]
    return s, r, n


_EDGE_ROWS = (("s_all", "r_all", "iu_row", "iv_row"), ("s2", "r2"))


def _by_edge(d):
    """The prep's per-edge arrays in (sender, receiver) order, and each
    tail entry's rank counted again in that order: its form that does not
    depend on the order of a sender's edges."""
    out = dict(d)
    for cols in _EDGE_ROWS:
        order = np.lexsort((d[cols[1]], d[cols[0]]))
        for c in cols:
            out[c] = d[c][order]
    s2 = out["s2"]
    first = np.r_[0, np.flatnonzero(s2[1:] != s2[:-1]) + 1]
    start = np.repeat(first, np.diff(np.r_[first, len(s2)]))
    out["t2rank"] = (np.arange(len(s2)) - start).astype(np.int32)
    return out


@pytest.mark.parametrize("h", [64, ttri.CORE_H])
@pytest.mark.parametrize("canon", [False, True])
@pytest.mark.parametrize("graph", ["rmat10", "rmat12", "golden"])
def test_native_host_prep_matches_numpy_and_jax(graph, canon, h):
    """The port's gm_tc_* (``native/tc_prep.cpp``) gives the numpy prep's
    arrays, array for array, and the JAX package's native prep's: array
    for array from raw edges; from canonical pairs, where the JAX copy
    orders a sender's edges as its threads finish, once each sender's
    edges are in (sender, receiver) order."""
    s, r, n = _native_case(graph, canon)
    got = ttri._tc_prep_native(s, r, n, h, canon)
    want = ttri._tc_prep_numpy(s, r, n, h, canon)
    jax_native = jtri._tc_prep_native(s, r, n, h, canon)
    assert got.keys() == want.keys() == jax_native.keys()
    assert got["m"] > 0 and got["ncr"] > 0
    assert (len(got["s2"]) > 0) == (h < n)   # tail lists below the core
    mine = got
    if canon:
        mine, jax_native = _by_edge(got), _by_edge(jax_native)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(mine[k]),
                                      np.asarray(jax_native[k]), err_msg=k)


def test_host_route_preps_natively(monkeypatch):
    """``impl="host"`` takes the native prep; the numpy prep only for an
    empty edge list."""
    s, r, n = _native_case("rmat10", False)
    want = ttri.count_triangles_bucketed(torch.as_tensor(s),
                                         torch.as_tensor(r), n)[1]

    def no_numpy(*a, **k):
        raise AssertionError("the numpy prep ran")
    monkeypatch.setattr(ttri, "_tc_prep_numpy", no_numpy)
    got = ttri.count_triangles_bucketed(torch.as_tensor(s),
                                        torch.as_tensor(r), n, impl="host")
    assert got[1] == want > 0
    assert ttri._tc_prep_native(s[:0], r[:0], n, 64, False) is None


def test_kernel_args_give_the_count():
    """T1 and T2 on ``_kernel_args`` (what the card's checks hold against
    the plain versions) add up to the count."""
    s, r, n, h, canon = _case("random_h64")
    u, v = torch.as_tensor(s).long(), torch.as_tensor(r).long()
    t1, t2 = ttri._kernel_args(u, v, n, h, canon)
    pv = ttri.core_count(*t1, torch.zeros(n + 1, dtype=torch.int32))
    ttri.tail_count(*t2, pv)
    want, total = ttri.count_triangles_bucketed(u, v, n, h=h)
    np.testing.assert_array_equal(pv[:n].numpy(), want.numpy())
    assert int(pv.sum()) == total


def test_preps_give_t2_the_narrow_pairs_first():
    """Both preps hand T2 its probes by class pair, the pairs with a list
    narrower than _TAIL_WIDE_FROM before the others (T2 runs those with
    4 lanes a probe and the rest with 8), and the count stays JAX's, on
    an upper-triangular RMAT-11 at h = 16, which has both kinds."""
    from graphmat_tpu_torch.io.transforms import convert_to_upper_triangular
    from graphmat_tpu_torch.utils.generators import rmat_edgelist
    e = convert_to_upper_triangular(rmat_edgelist(11, 16, seed=1,
                                                  device="cpu"))
    s, r = np.asarray(e.src) - 1, np.asarray(e.dst) - 1
    n, h = e.n, 16
    u, v = torch.as_tensor(s).long(), torch.as_tensor(r).long()
    _, (mats, ladder, gk, *_) = ttri._kernel_args(u, v, n, h, True)
    nc = len(ladder)
    host = ttri._prep(s, r, n, h=h, assume_canonical=True)
    kinds = []
    for lad, pairs in ((ladder, [(g // nc, g % nc) for g in gk.tolist()]),
                       (host["ladder"], [(cs, cr) for cs, cr, *_ in sorted(
                           host["groups"], key=lambda g: ttri._tail_order(
                               host["ladder"], g[0], g[1]))])):
        rank = [ttri._tail_order(lad, cs, cr) for cs, cr in pairs]
        assert rank == sorted(rank)
        kinds.append({min(lad[cs], lad[cr]) >= ttri._TAIL_WIDE_FROM
                      for cs, cr in pairs})
    assert kinds[0] == {False, True}
    want_pv, want_total = jtri.count_triangles_bucketed(
        s, r, n, h=h, assume_canonical=True)
    for impl in ("device", "host"):
        pv, total = ttri.count_triangles_bucketed(
            u, v, n, h=h, assume_canonical=True, impl=impl)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(want_pv))
        assert total == want_total


def _popcount_and(a, b):
    x = (a & b).astype(np.uint32).view(np.uint8)
    return np.unpackbits(x, axis=1).sum(1)


def _summary_np(bm):
    """Bit j of a row's summary words: word j of its bitmap row is not 0."""
    rows, w4 = bm.shape
    sw = -(-w4 // 32)
    nz = np.zeros((rows, sw * 32), bool)
    nz[:, :w4] = bm != 0
    return (nz.reshape(rows, sw, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(2).astype(
                np.uint32).view(np.int32)


def _core_brute(bm, sm, iu, iv, s, nacc):
    """T1's function word by word in numpy: the words marked in both
    summaries, each AND's popcount."""
    want = np.zeros(nacc, np.int64)
    smu = sm.view(np.uint32)
    for e in range(len(iu)):
        a, b = iu[e], iv[e]
        c = 0
        for j in range(bm.shape[1]):
            if (smu[a, j // 32] & smu[b, j // 32]) >> np.uint32(j % 32) & 1:
                c += bin(int(bm[a, j] & bm[b, j])).count("1")
        want[s[e]] += c
    return want


def _core_call(bm, sm, iu, iv, s, nacc):
    return ttri.core_count(torch.as_tensor(bm.view(np.int32)),
                           torch.as_tensor(sm), torch.as_tensor(iu),
                           torch.as_tensor(iv), torch.as_tensor(s),
                           torch.zeros(nacc, dtype=torch.int32)).numpy()


@pytest.mark.parametrize("w4", [4, 8, 128])
def test_core_count_plain_version_against_brute_force(w4):
    rng = np.random.default_rng(w4)
    rows, e, nacc = 40, 3000, 25
    bm = rng.integers(0, 2 ** 32, (rows, w4), dtype=np.uint64)
    bm = bm.astype(np.uint32)
    bm[:, 0] |= np.uint32(1 << 31)   # bit 31 in every row
    bm[-1] = 0                        # the zero row
    iu = rng.integers(0, rows, e).astype(np.int32)
    iv = rng.integers(0, rows, e).astype(np.int32)
    s = rng.integers(0, nacc, e).astype(np.int32)
    want = np.zeros(nacc, np.int64)
    np.add.at(want, s, _popcount_and(bm[iu], bm[iv]))
    np.testing.assert_array_equal(
        _core_call(bm, _summary_np(bm), iu, iv, s, nacc), want)


@pytest.mark.parametrize("w4", [4, 36, 128, 132])
def test_core_count_two_level_against_brute_force(w4):
    """Sparse rows (a few set bits: the summary's case), empty rows, a
    hub row with every bit set, summaries of one word and of several, a
    last summary word that covers fewer than 32 words; then the same
    rows under all-zero summaries (the kernel reads no word: 0) and
    under summaries that mark only some nonzero words (those count)."""
    rng = np.random.default_rng(100 + w4)
    rows, e, nacc = 30, 800, 11
    bm = np.zeros((rows, w4), np.uint32)
    for r in range(rows - 1):
        k = int(rng.integers(0, 6))     # 0-5 bits: empty and sparse rows
        bits = rng.choice(32 * w4, k, replace=False)
        np.bitwise_or.at(bm[r], bits >> 5,
                         np.uint32(1) << (bits & 31).astype(np.uint32))
    bm[3] = 0xFFFFFFFF                  # a hub row
    bm[4, -1] = np.uint32(1 << 31)      # only the row's last word
    iu = rng.integers(0, rows, e).astype(np.int32)
    iv = rng.integers(0, rows, e).astype(np.int32)
    iu[:40], iv[:40] = 3, np.arange(40) % rows   # the hub against all
    iu[40:60], iv[40:60] = 4, 3
    s = rng.integers(0, nacc, e).astype(np.int32)
    sm = _summary_np(bm)
    want = np.zeros(nacc, np.int64)
    np.add.at(want, s, _popcount_and(bm[iu], bm[iv]))
    np.testing.assert_array_equal(_core_brute(bm, sm, iu, iv, s, nacc), want)
    np.testing.assert_array_equal(_core_call(bm, sm, iu, iv, s, nacc), want)
    zero = np.zeros_like(sm)
    np.testing.assert_array_equal(_core_call(bm, zero, iu, iv, s, nacc), 0)
    part = sm & rng.integers(0, 2 ** 31, sm.shape).astype(np.int32)
    np.testing.assert_array_equal(
        _core_call(bm, part, iu, iv, s, nacc),
        _core_brute(bm, part, iu, iv, s, nacc))


@pytest.mark.parametrize("name", ["random", "random_h64", "hubs_h64",
                                  "h4096_n6000", "n90_w3",
                                  "random_h0_all_tail"])
def test_device_prep_summaries_equal_the_host_preps(name):
    """T1's summaries from the device prep (marked from the core edges'
    words) equal the host prep's (packed from its bitmap), and mark
    exactly the bitmap's nonzero words."""
    s, r, n, h, canon = _case(name)
    h = ttri.CORE_H if h is None else h
    bm, sm, *_ = next(ttri._kernel_args(torch.as_tensor(s).long(),
                                        torch.as_tensor(r).long(), n, h,
                                        canon))
    host = ttri._prep(s, r, n, h=h, assume_canonical=canon)["bitmap"]
    hb = np.zeros((host.shape[0], bm.shape[1]), np.uint32)
    hb[:, :host.shape[1]] = host
    np.testing.assert_array_equal(bm.numpy().view(np.uint32), hb)
    np.testing.assert_array_equal(sm.numpy(), ttri._tc_summary_host(hb))
    np.testing.assert_array_equal(sm.numpy(), _summary_np(hb))


@pytest.mark.parametrize("ordered", [True, False])
def test_tail_count_plain_version_against_brute_force(ordered):
    """Duplicate-free lists padded to their class width, sorted (as T2
    takes them) or not (the plain version takes any)."""
    rng = np.random.default_rng(7 + ordered)
    ladder = (8, 32, 256)
    lists, starts, cls = [], [], []
    flat = []
    for _ in range(60):
        c = rng.integers(0, 3)
        k = rng.integers(0, ladder[c] + 1)
        ids = rng.choice(300, k, replace=False).astype(np.int32)
        if ordered:
            ids = np.sort(ids)
        row = np.full(ladder[c], PAD_ID, np.int32)
        row[:k] = ids
        starts.append(sum(len(x) for x in flat))
        flat.append(row)
        lists.append(set(ids.tolist()))
        cls.append(c)
    mats = np.concatenate(flat)
    p = 400
    a, b = rng.integers(0, 60, p), rng.integers(0, 60, p)
    gk = np.array([cls[i] * 3 + cls[j] for i, j in zip(a, b)], np.int32)
    sp = rng.integers(0, 20, p).astype(np.int32)
    want = np.zeros(20, np.int64)
    np.add.at(want, sp, [len(lists[i] & lists[j]) for i, j in zip(a, b)])
    order = np.argsort(gk, kind="stable")   # probes come sorted by pair
    starts = np.asarray(starts, np.int32)
    pv = ttri.tail_count(torch.as_tensor(mats), ladder,
                         *(torch.as_tensor(x[order]) for x in
                           (gk, starts[a], starts[b], sp)),
                         torch.zeros(20, dtype=torch.int32))
    np.testing.assert_array_equal(pv.numpy(), want)


@pytest.mark.parametrize("ladder", [(1, 2, 8, 16), (8, 64, 256, 512, 4096)])
def test_tail_count_edge_lists_against_brute_force(ladder):
    """Lists at their full class width (no pad), empty lists (all pad),
    hub lists of the widest class, runs of probes that share one list
    (as T2 keeps a staged list for the next probe), and widths that are
    not multiples of 4 (the host ladder's smallest classes)."""
    rng = np.random.default_rng(len(ladder))
    L = len(ladder)
    flat, starts, cls, lists = [], [], [], []
    off = 0
    for i in range(40):
        c = i % L
        k = (ladder[c] if i % 3 == 0 else 0 if i % 7 == 1
             else int(rng.integers(1, ladder[c] + 1)))
        ids = np.sort(rng.choice(3 * ladder[-1], k, replace=False))
        row = np.full(ladder[c], PAD_ID, np.int32)
        row[:k] = ids
        flat.append(row)
        starts.append(off)
        off += ladder[c]
        cls.append(c)
        lists.append(set(ids.tolist()))
    mats = np.concatenate(flat)
    a = rng.integers(0, 40, 300)
    b = np.repeat(rng.integers(0, 40, 30), 10)   # runs of one list
    gk = np.array([cls[i] * L + cls[j] for i, j in zip(a, b)], np.int32)
    sp = rng.integers(0, 9, 300).astype(np.int32)
    want = np.zeros(9, np.int64)
    np.add.at(want, sp, [len(lists[i] & lists[j]) for i, j in zip(a, b)])
    starts = np.asarray(starts, np.int32)
    pv = ttri.tail_count(torch.as_tensor(mats), ladder,
                         *(torch.as_tensor(x) for x in
                           (gk, starts[a], starts[b], sp)),
                         torch.zeros(9, dtype=torch.int32))
    np.testing.assert_array_equal(pv.numpy(), want)


def test_kernel_wrappers_check_their_arguments():
    z = torch.zeros(4, dtype=torch.int32)
    bm = torch.zeros((2, 4), dtype=torch.int32)
    sm = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        ttri.core_count(bm.long(), sm, z, z, z, z)
    with pytest.raises(ValueError, match="multiple of 4"):
        ttri.core_count(torch.zeros((2, 3), dtype=torch.int32), sm, z, z, z,
                        z)
    with pytest.raises(ValueError, match="ceil"):
        ttri.core_count(bm, torch.zeros((2, 2), dtype=torch.int32), z, z, z,
                        z)
    with pytest.raises(ValueError, match="one length"):
        ttri.core_count(bm, sm, z, z[:3], z, z)
    with pytest.raises(ValueError, match="ladder"):
        ttri.tail_count(z, [], z, z, z, z, z)
    with pytest.raises(ValueError, match="impl"):
        ttri.count_triangles_bucketed(z, z, 4, impl="native")


def test_count_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass CPU tensors"):
        ttri.count_triangles_bucketed(np.zeros(1), np.ones(1), 2)


def _tc_graph(name):
    if name == "complete10":
        return upper_triangular_edgelist(10)
    if name == "fixture_2_10":
        return gj.load_edgelist(fixture("2_10_upper_triangle.bin.mtx"))
    seed, n, deg = {"random25": (13, 25, 5), "random40_13": (13, 40, 6),
                    "random40_99": (99, 40, 6)}[name]
    return convert_to_upper_triangular(random_edgelist(n, deg, seed=seed))


@pytest.mark.parametrize("method", ["engine", "bucketed", "auto"])
@pytest.mark.parametrize("name", ["complete10", "random25", "random40_13",
                                  "random40_99", "fixture_2_10"])
def test_run_triangle_counting_matches_jax(name, method):
    e = _tc_graph(name)
    want_tri, want = jtc.run_triangle_counting(gj.Graph(e), method=method)
    tri, total = ttc.run_triangle_counting(gt.Graph(e, device="cpu"),
                                           method=method)
    assert total == want
    n = max(e.m, e.n)
    assert tri.shape == (n,)
    np.testing.assert_array_equal(tri, np.asarray(want_tri)[:n])
    if name == "complete10":
        assert total == 10 * 9 * 8 // 6
    if name == "fixture_2_10":
        golden = re.search(r"Total triangles = (\d+)", gold("tc_2_10.txt"))
        assert total == int(golden[1])


@pytest.mark.parametrize("method", ["engine", "bucketed"])
def test_per_vertex_counts_in_original_order_on_a_permuted_graph(method):
    """ROADMAP R5: the JAX bucketed route returns its counts in internal
    order; the port returns original order on every route.  A degree-
    permuted port run equals JAX's bucketed run on the same permuted graph
    mapped through ``perm``, and every route's total is the same."""
    e = convert_to_upper_triangular(random_edgelist(150, 8, seed=3))
    gj_ = gj.Graph(e, permute="degree")
    want_internal, want = jtc.run_triangle_counting(gj_, method="bucketed")
    g = gt.Graph(e, permute="degree", device="cpu")
    tri, total = ttc.run_triangle_counting(g, method=method)
    assert total == want
    _, t_eng = jtc.run_triangle_counting(gj.Graph(e, permute="degree"),
                                         method="engine")
    assert t_eng == want
    if method == "bucketed":
        perm = g.perm.numpy()
        np.testing.assert_array_equal(perm, gj_.perm)
        np.testing.assert_array_equal(tri, np.asarray(want_internal)[perm])
        assert not np.array_equal(tri, np.asarray(want_internal)[:150])
    else:
        want_tri, _ = jtc.run_triangle_counting(
            gj.Graph(e, permute="degree"), method="engine")
        np.testing.assert_array_equal(tri, want_tri)


def test_unknown_method_raises():
    g = gt.Graph(upper_triangular_edgelist(4), device="cpu")
    with pytest.raises(ValueError, match="method"):
        ttc.run_triangle_counting(g, method="bucket")


def _cli_lines(module, args, monkeypatch):
    monkeypatch.setenv("GRAPHMAT_PLATFORM", "cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        module._main(args)
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith(("Time =", "Read "))]


def test_cli_prints_the_jax_lines_and_the_golden_total(monkeypatch):
    args = [fixture("2_10_upper_triangle.bin.mtx")]
    got = _cli_lines(ttc, args, monkeypatch)
    assert got == _cli_lines(jtc, args, monkeypatch)
    golden = re.search(r"Total triangles = (\d+)", gold("tc_2_10.txt"))
    assert f"Total triangles = {golden[1]}" in got
    assert _cli_lines(ttc, [], monkeypatch) == [
        "Correct format: triangle_counting A.mtx"]
