"""The port's bench entry point: one function per paper table, on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.bench.run --only ifann,indexing,kernels \\
        [--n N] [--nq NQ] [--dim D] [--device cpu] [--json PATH]

Prints ``name,us_per_call,derived`` CSV with the reference's row names;
``--only`` takes bench-name prefixes; ``--json`` also writes the device and
the rows, with their unrounded metrics.  A CPU run times PyTorch's CPU
kernels and says nothing of the card: its rows name the device they ran on.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch.bench import common, tables


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=None, help="comma-separated bench-name prefixes")
    ap.add_argument("--n", type=int, default=common.N_DEFAULT, help="corpus rows")
    ap.add_argument("--dim", type=int, default=common.DIM, help="vector width")
    ap.add_argument("--nq", type=int, default=common.NQ, help="queries per batch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the device and the rows to PATH")
    args = ap.parse_args(argv)

    b = common.Bench(n=args.n, dim=args.dim, nq=args.nq, device=args.device)
    dev = b.device
    benches = [
        ("ifann", lambda: tables.bench_ifann(b)),
        ("query_types", lambda: tables.bench_query_types(b)),
        ("workloads", lambda: tables.bench_workloads(b)),
        ("indexing", lambda: tables.bench_indexing(b)),
        ("vary_k", lambda: tables.bench_k(b)),
        ("updates", lambda: tables.bench_updates(b)),
        ("serve", lambda: tables.bench_serve(b)),
        ("kernels", lambda: tables.bench_kernels(device=dev)),
    ]
    only = args.only.split(",") if args.only else None
    info = device_info(dev)
    print(f"# device: {info['kind']}", file=sys.stderr)
    print("name,us_per_call,derived")
    failures = 0
    all_rows = []
    for name, fn in benches:
        if only and not any(name.startswith(p) for p in only):
            continue
        t0 = time.time()
        try:
            for r in fn():
                all_rows.append(r)
                print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}", flush=True)
            print(f"# {name} done in {time.time() - t0:.0f}s", file=sys.stderr)
        except Exception:  # noqa: BLE001  (report every table, fail at the end)
            failures += 1
            print(f"# {name} FAILED:\n{traceback.format_exc()}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": info, "rows": all_rows}, f, indent=2)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
