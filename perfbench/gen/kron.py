"""The Graph500 Kronecker (R-MAT) generator, drawn on the device from a
seed.

A plain PyTorch copy of the counter-based splitmix64 stream that the
port's ``rmat_edgelist`` draws by default (its plain version, int64
arithmetic): edge ``i`` starts from ``splitmix64(seed * STREAM + i)`` and
each of ``scale`` levels takes one more splitmix64 step, whose high and
low 32 bits pick the quadrant with probabilities ``(a, b, c, 1-a-b-c)``.
Then, as Graph500's generator does, the vertex labels are permuted at
random (a permutation drawn from the seed), so that no locality is left
in them: without it vertex 0 and the ids with few set bits are the hubs.
Self loops and duplicate pairs are dropped.  It is kept here so that no
change to the program can change the benchmark's inputs.
"""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
_LO32 = (1 << 32) - 1
_STREAM = 0xD1342543DE82EF95
CHUNK = 1 << 26          # edges drawn at once: bounds the draw's memory


def _i64(x: int) -> int:
    """The int64 whose bits are those of ``x mod 2^64``."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` read as uint64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _i64(0x9E3779B97F4A7C15)
    x = (x ^ _shr(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def kron_keys(scale: int, nnz: int, a: float, b: float, c: float,
              seed: int, device, start: int = 0) -> torch.Tensor:
    """Keys ``(s << 32) | d`` (0-based ids) of edges ``start ..
    start + nnz - 1`` of the stream, in generation order."""
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    state = splitmix64(torch.arange(start, start + nnz, dtype=torch.int64,
                                    device=device) + _i64(seed * _STREAM))
    s = torch.zeros(nnz, dtype=torch.int64, device=device)
    d = torch.zeros_like(s)
    for _ in range(scale):
        state = splitmix64(state)
        r1 = _shr(state, 32).double() * 2.0 ** -32
        r2 = (state & _LO32).double() * 2.0 ** -32
        sb = r1 > ab
        db = torch.where(sb, r2 > c_norm, r2 > a_norm)
        s = (s << 1) | sb
        d = (d << 1) | db
    return (s << 32) | d


def label_permutation(n: int, seed: int, device) -> torch.Tensor:
    """The seeded random relabelling: vertex ``v`` of the stream becomes
    ``perm[v]``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    return torch.randperm(n, generator=gen, device=device)


def make(cfg: dict, seed: int, device) -> dict:
    """The configuration's directed edge list, labels permuted: ``src``,
    ``dst`` (int32, 0-based, sorted by (src, dst), no self loops, no
    duplicates) and ``n``."""
    scale = int(cfg["scale"])
    n = 1 << scale
    total = n * int(cfg["edge_factor"])
    parts = []
    for start in range(0, total, CHUNK):
        parts.append(kron_keys(scale, min(CHUNK, total - start), cfg["a"],
                               cfg["b"], cfg["c"], seed, device, start))
    keys = torch.cat(parts)
    del parts
    perm = label_permutation(n, seed, device)
    keys = (perm[keys >> 32] << 32) | perm[keys & _LO32]
    del perm
    keys = torch.sort(keys).values
    keep = (keys >> 32) != (keys & _LO32)
    keep[1:] &= keys[1:] != keys[:-1]
    keys = keys[keep]
    del keep
    return {"src": (keys >> 32).to(torch.int32),
            "dst": (keys & _LO32).to(torch.int32), "n": n}
