"""The plain references against brute force on tiny graphs."""

import itertools

import numpy as np
import pytest
import torch

from perfbench.reference import bfs, pagerank, sgd, tc


def _graph(n, m, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    key = np.unique(src[src != dst] * n + dst[src != dst])
    return torch.as_tensor(key // n), torch.as_tensor(key % n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pagerank_is_the_dense_power_iteration(seed):
    n = 40
    src, dst = _graph(n, 150, seed)
    a = np.zeros((n, n))
    a[dst.numpy(), src.numpy()] = 1.0
    deg = a.sum(0)
    has_in = a.sum(1) > 0
    pr = np.full(n, 0.3)
    steps = 0
    while True:
        y = a @ np.where(deg > 0, pr / np.maximum(deg, 1), 0.0)
        new = np.where(has_in, 0.3 + 0.7 * y, pr)
        steps += 1
        done = not (np.abs(new - pr)[has_in] > 1e-5).any()
        pr = new
        if done:
            break
    got, got_steps, snaps = pagerank.pagerank(src, dst, n,
                                              snapshots={steps + 2})
    assert got_steps == steps
    np.testing.assert_allclose(got.numpy(), pr, rtol=1e-12)
    assert steps + 2 in snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bfs_depths_and_min_parents(seed):
    n = 60
    src, dst = _graph(n, 120, seed)
    adj = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        adj.setdefault(d, []).append(s)
    depth = {0: 0}
    level = [0]
    while level:
        nxt = set()
        for v in range(n):
            if v not in depth and any(u in level for u in adj.get(v, [])):
                nxt.add(v)
        for v in nxt:
            depth[v] = depth[level[0]] + 1
        level = sorted(nxt)
    d, p = bfs.bfs(src, dst, n, 0)
    for v in range(n):
        if v in depth:
            assert int(d[v]) == depth[v]
            if v:
                par = min(u for u in adj[v] if depth.get(u) == depth[v] - 1)
                assert int(p[v]) == par + 1
        else:
            assert int(d[v]) == bfs.INF and int(p[v]) == -1
    assert int(p[0]) == -1


def test_bfs_ids_in_bfloat16_lose_parents():
    n = 2000
    src = torch.arange(1, n)            # a star: 0 reached from every id
    dst = torch.zeros(n - 1, dtype=torch.int64)
    src = torch.cat([torch.tensor([0] * 3 + [1500]), src])
    dst = torch.cat([torch.tensor([1500, 1501, 1502, 0]), dst])
    _, p64 = bfs.bfs(src, dst, n, 1500)
    _, p16 = bfs.bfs(src, dst, n, 1500, torch.bfloat16)
    assert int(p64[0]) == 1501 and int(p16[0]) != 1501


def test_rand_r_is_the_programs_init():
    from graphmat_tpu_torch.utils.reference_rng import rand_r_uniform_np
    np.testing.assert_array_equal(
        sgd.rand_r_uniform(300, 20),
        rand_r_uniform_np(np.arange(1, 301, dtype=np.uint32), 20))


def test_sgd_is_the_per_edge_loop():
    n, k = 12, 3
    src = torch.tensor([0, 0, 1, 2, 3, 3, 4])
    dst = torch.tensor([5, 6, 5, 7, 8, 5, 9])
    val = torch.tensor([1.0, 4.5, 3.0, 2.5, 5.0, 0.5, 2.0])
    lv0, lv, r0, r1 = sgd.sgd(src, dst, val, n, k, iterations=3,
                              lambda_=0.01, step=0.05)
    x = lv0.numpy().copy()
    has = np.zeros(n, bool)
    has[src.numpy()] = has[dst.numpy()] = True

    def err(x):
        return sum((r - x[u] @ x[v]) ** 2 for u, v, r in
                   zip(src.tolist(), dst.tolist(), val.tolist()))
    e0 = err(x)
    for _ in range(3):
        acc = np.zeros_like(x)
        for u, v, r in zip(src.tolist(), dst.tolist(), val.tolist()):
            e = r - x[u] @ x[v]
            acc[v] += x[u] * e
            acc[u] += x[v] * e
        x = np.where(has[:, None], x + 0.05 * (-0.01 * x + acc), x)
    np.testing.assert_allclose(lv.numpy(), x, rtol=1e-12)
    assert r0 == pytest.approx(np.sqrt(e0 / 7), rel=1e-12)
    assert r1 == pytest.approx(np.sqrt(err(x) / 7), rel=1e-12)
    assert lv0.dtype == torch.float64
    assert np.array_equal(lv0.numpy(), lv0.numpy().astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tc_counts_at_the_degree_minimum_vertex(seed):
    n = 30
    src, dst = _graph(n, 200, seed)
    edges = {(min(a, b), max(a, b)) for a, b in zip(src.tolist(),
                                                     dst.tolist())}
    deg = np.zeros(n, int)
    for a, b in edges:
        deg[a] += 1
        deg[b] += 1
    count = np.zeros(n, int)
    for a, b, c in itertools.combinations(range(n), 3):
        if {(a, b), (a, c), (b, c)} <= edges:
            count[min((a, b, c), key=lambda v: (deg[v], v))] += 1
    o = tc.orient(src, dst, n)
    assert [tc.count_at(o, v) for v in range(n)] == count.tolist()
    assert tc.total(o) == count.sum()


def test_tc_int16_counts_wrap():
    n = 400                       # a clique's first vertex counts C(399, 2)
    a, b = torch.triu_indices(n, n, 1)
    o = tc.orient(a, b, n)
    v = int(torch.argmax(tc.out_degree(o)))
    assert tc.count_at(o, v) == 399 * 398 // 2
    assert tc.count_at(o, v, torch.int16) != 399 * 398 // 2
