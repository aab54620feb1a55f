"""A rating matrix of a published shape, drawn on the device from a seed.

Users are ranked by activity and films by popularity; ranks are shuffled
onto ids.  User rank ``r`` (from 1) rates exactly

    d(r) = floor + (top - floor) * (r ** -e - users ** -e) / (1 - users ** -e)

films (rounded to whole ratings, the remainders given to the largest
fractions), with ``e`` solved so that the degrees sum to the published
ratings: the most active user rates ``top`` films, the least ``floor``.
Each user's films are the first ``d`` distinct ones of a sequence of
draws from the film law ``(rank + q) ** -g``, so no user rates a film
twice, as in MovieLens.  Every film is first given one rating by a user
drawn in proportion to ``d``, so that every film is rated.  Ratings are
half stars 0.5 .. 5.0, drawn uniformly.

The first ``d`` distinct films of such draws are the ``d`` smallest of
independent exponential clocks ``Exp(1) / weight``, one a film; users
who rate more than ``items / HEAVY`` films are drawn that way, the rest
by rounds of draws, which need far fewer numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

HEAVY = 32        # clocks for users who rate more than items / HEAVY films
FIRST = 1.25      # draws per missing rating in the first round


def _law(users: int, floor: int, top: int, e: float):
    r = np.arange(1, users + 1, dtype=np.float64)
    tail = float(users) ** -e
    return floor + (top - floor) * (r ** -e - tail) / (1.0 - tail)


def user_exponent(users: int, ratings: int, floor: int, top: int) -> float:
    """``e`` with the law's degrees summing to ``ratings``."""
    lo, hi = 1e-3, 8.0
    for _ in range(100):
        e = 0.5 * (lo + hi)
        if _law(users, floor, top, e).sum() > ratings:
            lo = e
        else:
            hi = e
    return 0.5 * (lo + hi)


def user_degrees(users: int, ratings: int, floor: int, top: int):
    """Ratings of each user rank, int64, summing to ``ratings``."""
    d = _law(users, floor, top, user_exponent(users, ratings, floor, top))
    whole = np.floor(d).astype(np.int64)
    rest = ratings - int(whole.sum())
    whole[np.argsort(whole - d, kind="stable")[:rest]] += 1
    return whole


def film_weights(items: int, q: float, g: float, device):
    return (torch.arange(1, items + 1, dtype=torch.float64, device=device)
            + q) ** -g


def _first_distinct(key, order, du, items):
    """Of pairs ``key = user * items + film`` drawn at ``order``, each
    user's first ``du[user]`` distinct films: (kept keys, their orders)."""
    perm = torch.argsort(order, stable=True)
    key, order = key[perm], order[perm]
    perm = torch.argsort(key, stable=True)
    key, order = key[perm], order[perm]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key, order = key[first], order[first]
    user = key // items
    perm = torch.argsort(order, stable=True)
    key, order, user = key[perm], order[perm], user[perm]
    perm = torch.argsort(user, stable=True)
    key, order, user = key[perm], order[perm], user[perm]
    start = torch.zeros(du.numel() + 1, dtype=torch.int64, device=key.device)
    start[1:] = torch.cumsum(torch.bincount(user, minlength=du.numel()), 0)
    rank = torch.arange(key.numel(), device=key.device) - start[user]
    keep = rank < du[user]
    return key[keep], order[keep]


def _light(du, w, gkey, items, gen):
    """Rounds of draws for the users ``du > 0``: each round draws
    ``FIRST * 2**round`` films a missing rating, until every user has its
    ``du`` distinct films."""
    dev = du.device
    key = gkey
    order = torch.full_like(gkey, -1)
    t0, factor = 0, FIRST
    while True:
        key, order = _first_distinct(key, order, du, items)
        short = du - torch.bincount(key // items, minlength=du.numel())
        if int(short.max()) <= 0:
            return key
        m = torch.ceil(short.clamp(min=0).double() * factor).long()
        total = int(m.sum())
        user = torch.repeat_interleave(torch.arange(du.numel(), device=dev),
                                       m)
        film = torch.multinomial(w.float(), total, replacement=True,
                                 generator=gen)
        key = torch.cat([key, user * items + film])
        order = torch.cat([order, t0 + torch.arange(total, device=dev)])
        t0 += total
        factor *= 2


def _heavy(du, w, gkey, items, gen):
    """Exponential clocks for the users ``du > 0``: each takes its ``du``
    films of smallest ``Exp(1) / weight``, its guaranteed films first."""
    users = torch.nonzero(du).flatten()
    clock = torch.empty((users.numel(), items), dtype=torch.float64,
                        device=du.device).exponential_(generator=gen) / w
    row = torch.full((du.numel(),), -1, dtype=torch.int64, device=du.device)
    row[users] = torch.arange(users.numel(), device=du.device)
    gu, gf = gkey // items, gkey % items
    mine = row[gu] >= 0
    clock[row[gu[mine]], gf[mine]] = -1.0
    films = torch.argsort(clock, dim=1)
    take = torch.arange(items, device=du.device)[None, :] < du[users][:, None]
    return (users[:, None] * items + films)[take]


def make(cfg: dict, seed: int, device) -> dict:
    """``src`` (users 0 .. users-1), ``dst`` (films users .. n-1), int32,
    0-based, sorted; ``val`` float32 half stars; ``n = users + items``."""
    users, items = int(cfg["users"]), int(cfg["items"])
    ratings = int(cfg["ratings"])
    law = cfg["assumed"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    d_rank = torch.as_tensor(user_degrees(users, ratings, law["user_floor"],
                                          law["user_top"]), device=device)
    du = torch.empty_like(d_rank)
    du[torch.randperm(users, generator=gen, device=device)] = d_rank
    w = torch.empty(items, dtype=torch.float64, device=device)
    w[torch.randperm(items, generator=gen, device=device)] = film_weights(
        items, law["film_q"], law["film_exponent"], device)
    # every film's guaranteed rating, from a user drawn in proportion to d
    gu = torch.multinomial(du.float(), items, replacement=True,
                           generator=gen)
    gkey = gu * items + torch.arange(items, device=device)
    heavy = du > math.ceil(items / HEAVY)
    hv = heavy[gu]
    key = torch.cat([
        _light(torch.where(heavy, 0, du), w, gkey[~hv], items, gen),
        _heavy(torch.where(heavy, du, 0), w, gkey[hv], items, gen)])
    key = torch.sort(key).values
    val = 0.5 * torch.randint(1, 11, (ratings,), generator=gen,
                              device=device).float()
    return {"src": (key // items).to(torch.int32),
            "dst": (users + key % items).to(torch.int32),
            "val": val, "n": users + items}
