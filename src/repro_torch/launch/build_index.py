"""Index-build CLI (the paper's offline indexing stage), on the card.

Builds a UG index over a synthetic corpus and reports build time, memory
and self-test recall.

Example::

    PYTHONPATH=src python -m repro_torch.launch.build_index --n 4000 --dim 32 \
        --out /tmp/ug_index
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core import Semantics, UGConfig, UGIndex, recall
from repro_torch.data import CorpusConfig, make_corpus, make_queries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ef-spatial", type=int, default=32)
    ap.add_argument("--ef-attribute", type=int, default=64)
    ap.add_argument("--max-edges", type=int, default=32)
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--interval-mode", default="uniform", choices=["uniform", "point"])
    ap.add_argument("--prune-backend", default="auto", choices=["auto", "cuda", "torch"],
                    help="pruning-sweep backend (auto = the CUDA kernel on the card, the "
                         "plain PyTorch version on the CPU); both build bit-identical graphs")
    ap.add_argument("--dtype", default="f32", choices=["f32"],
                    help="vector scan plane (only f32 is ported)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--out", default=None, help="directory to save the index")
    ap.add_argument("--selftest", action=argparse.BooleanOptionalAction, default=True)
    args = ap.parse_args(argv)

    ccfg = CorpusConfig(n=args.n, dim=args.dim, seed=args.seed,
                        interval_mode=args.interval_mode)
    x, ints = make_corpus(ccfg, device=args.device)
    cfg = UGConfig(
        ef_spatial=args.ef_spatial, ef_attribute=args.ef_attribute,
        max_edges_if=args.max_edges, max_edges_is=args.max_edges,
        iterations=args.iterations, exact_spatial=args.n <= 8192,
        prune_backend=None if args.prune_backend == "auto" else args.prune_backend,
    )
    idx = UGIndex.build(x, ints, cfg, seed=args.seed,
                        progress=lambda m: print(f"[build] {m}"),
                        dtype=args.dtype, device=args.device)
    vm = idx.vector_memory_bytes()
    print(f"[build] done in {idx.build_seconds:.1f}s; "
          f"{idx.memory_bytes():,} graph bytes; "
          f"{args.dtype} plane {vm['plane']:,} bytes "
          f"({vm['plane_bytes_per_vector']:.1f} B/vec); "
          f"degrees {idx.degree_stats()}")
    if args.out:
        idx.save(args.out)
        print(f"[build] saved to {args.out}")
    if args.selftest:
        qv, qi = make_queries(ccfg, 32, device=args.device)
        for sem in (Semantics.IF, Semantics.IS):
            res = idx.search(qv, qi, sem=sem, ef=64, k=10)
            gt = idx.ground_truth(qv, qi, sem=sem, k=10)
            print(f"[selftest] {sem.value} recall@10 = {recall(res, gt):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
