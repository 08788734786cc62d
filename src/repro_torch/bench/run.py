"""The port's bench entry point: one function per paper table, on the card
unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.bench.run --only ifann,indexing,kernels \\
        [--n N] [--nq NQ] [--dim D] [--device cpu] [--json PATH]
    PYTHONPATH=src python -m repro_torch.bench.run --smoke \\
        --check src/repro_torch/bench/baseline_smoke.json

Prints ``name,us_per_call,derived`` CSV with the reference's row names;
``--only`` takes bench-name prefixes; ``--json`` also writes the device and
the rows, with their unrounded metrics.  A CPU run times PyTorch's CPU
kernels and says nothing of the card: its rows name the device they ran on.

``--quick`` and ``--smoke`` (which implies ``--quick``) take the reference's
smaller sizes, and ``--smoke`` turns on the tables' own gates (the mixed
schedule's iteration speedup, the churn recall gap, the int8 byte
reduction, the async serve QPS ratio).  ``--check BASELINE`` is the perf
gate: it fails on a recall below its committed floor, a byte count above
its committed ceiling, or a committed row or metric that this run lacks;
``--write-baseline PATH`` derives those bars from this run (floor = recall
− 0.03, ceiling = bytes × 1.25; QPS and times are not gated).  With
``--only``, the gate holds the rows of the selected benches.  The port's
baseline is ``src/repro_torch/bench/baseline_smoke.json``, written by
``--smoke --device cpu --write-baseline``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback

import torch

from repro_torch.bench import common, tables

_METRIC = re.compile(r"(\w+)=([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\b")

RECALL_SLACK = 0.03     # committed floor = measured recall − slack
BYTES_HEADROOM = 1.25   # committed ceiling = measured bytes × headroom


def parse_metrics(derived: str) -> dict[str, float]:
    """The ``key=value`` numbers of a row's derived column."""
    return {k: float(v) for k, v in _METRIC.findall(derived)}


def gated_metrics(derived: str) -> tuple[dict, dict]:
    """``(floors, ceilings)`` of one row: recalls are floors, byte counts
    ceilings.  QPS and times stay ungated (noisy); a yardstick recall
    (``recall_fresh_rebuild``) measures the baseline builder, not the code
    under test, and is not gated."""
    m = parse_metrics(derived)
    mins = {k: v for k, v in m.items() if k.startswith("recall") and "fresh" not in k}
    maxs = {k: v for k, v in m.items() if k.endswith("bytes")}
    return mins, maxs


def write_baseline(rows: list[dict], path: str, benches: dict | None = None) -> None:
    """The gate's bars from this run's rows.  ``benches`` (bench name → its
    row names), where given, is kept for ``--only``: the gated rows of each
    bench are listed under ``benches``."""
    base = {}
    for r in rows:
        mins, maxs = gated_metrics(r["derived"])
        if not mins and not maxs:
            continue
        base[r["name"]] = {
            "min": {k: round(max(v - RECALL_SLACK, 0.0), 3) for k, v in mins.items()},
            "max": {k: int(v * BYTES_HEADROOM) for k, v in maxs.items()},
        }
    out = {"schema": 1, "rows": base}
    gated = {bench: [n for n in names if n in base] for bench, names in (benches or {}).items()}
    if any(gated.values()):
        out["benches"] = {bench: names for bench, names in gated.items() if names}
    with open(path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
        f.write("\n")


def check_baseline(rows: list[dict], path: str, only=None) -> list[str]:
    """This run's rows against a committed baseline: one message a
    violation.  ``only`` (bench-name prefixes) keeps the baseline's rows of
    those benches, where the baseline lists them."""
    try:
        with open(path) as f:
            saved = json.load(f)
    except FileNotFoundError:
        return [f"baseline {path} not found: commit it "
                f"(python -m repro_torch.bench.run --smoke --write-baseline {path})"]
    base = saved["rows"]
    if only and "benches" in saved:
        keep = {name for bench, names in saved["benches"].items()
                if any(bench.startswith(p) for p in only) for name in names}
        base = {name: gate for name, gate in base.items() if name in keep}
    by_name = {r["name"]: r for r in rows}
    problems = []
    for name, gate in base.items():
        row = by_name.get(name)
        if row is None:
            problems.append(f"{name}: row missing from this run (bench removed or crashed)")
            continue
        m = parse_metrics(row["derived"])
        for key, floor in gate.get("min", {}).items():
            if key not in m:
                problems.append(f"{name}: metric {key} disappeared")
            elif m[key] < floor:
                problems.append(f"{name}: {key}={m[key]:.3f} below baseline floor {floor}")
        for key, ceil in gate.get("max", {}).items():
            if key not in m:
                problems.append(f"{name}: metric {key} disappeared")
            elif m[key] > ceil:
                problems.append(f"{name}: {key}={m[key]:.0f} above baseline ceiling {ceil}")
    return problems


def device_info(dev: torch.device) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=None, help="comma-separated bench-name prefixes")
    ap.add_argument("--n", type=int, default=None,
                    help=f"corpus rows of every n-sized table and the one build size "
                         f"(default {common.N_DEFAULT}, or the --quick/--smoke size)")
    ap.add_argument("--dim", type=int, default=common.DIM, help="vector width")
    ap.add_argument("--nq", type=int, default=common.NQ, help="queries per batch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--quick", action="store_true", help="the reference's smaller sizes")
    ap.add_argument("--smoke", action="store_true",
                    help="the smallest sizes and the tables' gates (implies --quick)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the device and the rows to PATH")
    ap.add_argument("--check", default=None, metavar="BASELINE",
                    help="fail on a recall or byte regression against a committed baseline")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write the gate's bars from this run to PATH")
    args = ap.parse_args(argv)

    quick = args.quick or args.smoke
    smoke = args.smoke
    n = args.n or (common.SMOKE_N if smoke else common.QUICK_N if quick else common.N_DEFAULT)
    if args.n:
        build_sizes = (args.n,)
    else:
        build_sizes = (common.SMOKE_BUILD_SIZES if smoke else
                       common.QUICK_BUILD_SIZES if quick else common.BUILD_SIZES)
    sens_n = common.QUICK_SENSITIVITY_N if quick else common.SENSITIVITY_N
    scale_sizes = common.QUICK_SCALABILITY_SIZES if quick else common.SCALABILITY_SIZES

    b = common.Bench(n=n, dim=args.dim, nq=args.nq, device=args.device)
    dev = b.device
    benches = [
        ("ifann", lambda: tables.bench_ifann(b)),
        ("query_types", lambda: tables.bench_query_types(b)),
        ("workloads", lambda: tables.bench_workloads(b)),
        ("indexing", lambda: tables.bench_indexing(b)),
        ("vary_k", lambda: tables.bench_k(b)),
        ("sensitivity", lambda: tables.bench_sensitivity(b.resized(sens_n))),
        ("scalability", lambda: tables.bench_scalability(b, sizes=scale_sizes)),
        ("beam_sweep", lambda: tables.bench_beam_sweep(b)),
        ("mixed_workload", lambda: tables.bench_mixed_workload(
            b, require_speedup=2.0 if smoke else None)),
        ("build", lambda: tables.bench_build(build_sizes, dim=args.dim, device=dev)),
        ("updates", lambda: tables.bench_updates(b, require_recall_gap=0.05 if smoke else None)),
        ("memory", lambda: tables.bench_memory(b, require_reduction=3.0 if smoke else None)),
        ("serve", lambda: tables.bench_serve(b, require_qps_ratio=0.85 if smoke else None)),
        ("kernels", lambda: tables.bench_kernels(device=dev)),
    ]
    only = args.only.split(",") if args.only else None
    info = device_info(dev)
    print(f"# device: {info['kind']}", file=sys.stderr)
    print("name,us_per_call,derived")
    failures = 0
    all_rows, rows_of = [], {}
    for name, fn in benches:
        if only and not any(name.startswith(p) for p in only):
            continue
        t0 = time.time()
        try:
            for r in fn():
                all_rows.append(r)
                rows_of.setdefault(name, []).append(r["name"])
                print(f"{r['name']},{r['us_per_call']:.1f},{r['derived']}", flush=True)
            print(f"# {name} done in {time.time() - t0:.0f}s", file=sys.stderr)
        except Exception:  # noqa: BLE001  (report every table, fail at the end)
            failures += 1
            print(f"# {name} FAILED:\n{traceback.format_exc()}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"device": info, "rows": all_rows}, f, indent=2)
    if args.write_baseline:
        write_baseline(all_rows, args.write_baseline, benches=rows_of)
        print(f"# baseline written to {args.write_baseline}", file=sys.stderr)
    if args.check:
        problems = check_baseline(all_rows, args.check, only=only)
        for p in problems:
            print(f"# REGRESSION {p}", file=sys.stderr)
        if problems:
            print(f"# perf gate: {len(problems)} regression(s) against {args.check}",
                  file=sys.stderr)
            failures += 1
        else:
            print(f"# perf gate: clean against {args.check}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
