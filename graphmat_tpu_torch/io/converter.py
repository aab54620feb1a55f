"""graph_converter CLI: dataset preparation (the reference's
``src/graph_converter.cpp``).

Counterpart of ``graphmat_tpu/io/converter.py``, with its options, integer
codes, printed lines, return codes and output files, as
``python -m graphmat_tpu_torch.io.converter``.  Formats: 0 = binary mtx,
1 = text mtx, 2 = checkpoint (the npz of
:mod:`graphmat_tpu_torch.utils.checkpoint`, which either package loads).
``--split N`` writes N output shards (``prefix0..prefixN-1``).  The
conversion is host data preparation, in numpy, as in the JAX package; the
vertex-id shuffle (``--randomizeID``) takes the port's C copy of the
reference's glibc permutation.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import transforms as tf
from .edgelist import load_edgelist, write_edgelist

__all__ = ["build_parser", "run", "WEIGHT_TYPES"]

WEIGHT_TYPES = {0: np.int32, 1: np.float64, 2: np.float32}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graphmat_tpu_torch.io.converter",
        description="Convert/prepare graph datasets (GraphMat "
                    "graph_converter parity)")
    p.add_argument("input", help="input file or shard prefix")
    p.add_argument("output", help="output file or shard prefix")
    p.add_argument("--selfloops", type=int, default=0, choices=(0, 1),
                   help="0: remove self loops (default), 1: retain")
    p.add_argument("--duplicatededges", type=int, default=0, choices=(0, 1),
                   help="0: remove duplicated edges (default), 1: retain")
    p.add_argument("--uppertriangular", action="store_true",
                   help="orient each edge (u,v) so u <= v")
    p.add_argument("--bidirectional", action="store_true",
                   help="for all edges (u,v) add (v,u)")
    p.add_argument("--inputformat", type=int, default=1, choices=(0, 1, 2),
                   help="0: binary mtx, 1: text mtx (default), 2: checkpoint")
    p.add_argument("--outputformat", type=int, default=0, choices=(0, 1, 2),
                   help="0: binary mtx (default), 1: text mtx, 2: checkpoint")
    p.add_argument("--inputheader", type=int, default=1, choices=(0, 1))
    p.add_argument("--outputheader", type=int, default=1, choices=(0, 1))
    p.add_argument("--inputedgeweights", type=int, default=1, choices=(0, 1))
    p.add_argument("--outputedgeweights", type=int, default=1,
                   choices=(0, 1, 2, 3),
                   help="0: none, 1: keep (default), 2: unit, 3: random in "
                        "[1,r)")
    p.add_argument("--edgeweighttype", type=int, default=0, choices=(0, 1, 2),
                   help="0: int (default), 1: double, 2: float")
    p.add_argument("--r", dest="random_range", type=int, default=128)
    p.add_argument("--nvertices", type=int, default=0)
    p.add_argument("--split", type=int, default=1,
                   help="number of output shards")
    p.add_argument("--randomizeID", action="store_true")
    p.add_argument("--seed", type=int, default=5,
                   help="seed for random weights / id permutation")
    return p


def run(argv=None) -> int:
    """Convert as the options say; returns the exit code (1 for
    conflicting options, else 0)."""
    args = build_parser().parse_args(argv)
    if args.uppertriangular and args.bidirectional:
        print("Cannot be both uppertriangular and bidirectional")
        return 1
    if args.inputedgeweights == 0 and args.outputedgeweights == 1:
        print("No input edge weights and want output edge weights")
        return 1
    wdtype = WEIGHT_TYPES[args.edgeweighttype]

    if args.inputformat == 2:
        from ..utils.checkpoint import load_edgelist_checkpoint
        e = load_edgelist_checkpoint(args.input)
    else:
        e = load_edgelist(args.input, binaryformat=(args.inputformat == 0),
                          header=(args.inputheader == 1),
                          edgeweights=(args.inputedgeweights == 1),
                          wdtype=wdtype)
    if args.nvertices:
        e.m = max(e.m, args.nvertices)
        e.n = max(e.n, args.nvertices)
    print(f"Read {e.nnz} edges, {max(e.m, e.n)} vertices")

    if args.outputedgeweights == 3:
        e = tf.random_edge_weights(e, args.random_range, seed=args.seed,
                                   wdtype=wdtype)
    elif args.outputedgeweights == 2:
        e = tf.unit_edge_weights(e, wdtype=wdtype)

    if args.selfloops == 0:
        e = tf.remove_selfedges(e)
    if args.bidirectional:
        e = tf.create_bidirectional_edges(e)
    if args.uppertriangular:
        e = tf.convert_to_dag(e)
    if args.duplicatededges == 0:
        e = tf.remove_duplicate_edges(e)
    if args.randomizeID:
        n = max(e.m, e.n)
        e.m = e.n = n
        e, _perm = tf.randomize_vertex_ids(e, seed=args.seed)

    print(f"Writing {e.nnz} edges")
    if args.outputformat == 2:
        from ..utils.checkpoint import save_edgelist_checkpoint
        save_edgelist_checkpoint(e, args.output)
    else:
        write_edgelist(e, args.output,
                       binaryformat=(args.outputformat == 0),
                       header=(args.outputheader == 1),
                       edgeweights=(args.outputedgeweights != 0),
                       nshards=None if args.split == 1 else args.split)
    return 0


if __name__ == "__main__":
    sys.exit(run())
