"""Profile one batch of ``ServeEngine.embed`` on one card: where the
tower's time goes.

    python -m repro_torch.bench.embed_trace [--arch qwen1.5-4b] [--trace FILE]

Initialises the arch's full-width config from a seeded generator (bf16 for
the dense towers), embeds one warm-up batch of ``EMBED_BATCH`` documents of
``--doc-len`` random tokens, then traces one more with ``torch.profiler``.
Prints one JSON object: the batch's traced wall, device busy time and idle
share, its kernel launches, the kernel time split between the library's
matrix products and the other kernels, and the kernels that took the most
time.  ``--trace`` keeps the chrome trace.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import tempfile

import torch

from repro_torch.configs import get_arch
from repro_torch.launch.serve import EMBED_BATCH
from repro_torch.models import get_model
from repro_torch.serve import ServeEngine

PRODUCT_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")     # names of cuBLAS's product kernels


def trace_split(trace: dict, window: str, *, last: bool = True) -> dict:
    """Device busy time and idle share of a chrome trace over the span of
    the ``window`` annotation (stretched to the last kernel's end), its
    kernel time split into the library's matrix products and the rest,
    and the kernels that took the most time.  ``last=False`` keeps only
    the kernels that start inside the span (a window that ends in a
    synchronize, with other windows after it)."""
    events = trace["traceEvents"]
    span = next(e for e in events if e.get("name") == window and e.get("cat") == "user_annotation")
    t0 = span["ts"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e["ts"] + e["dur"] >= t0
               and (last or e["ts"] <= t0 + span["dur"])]
    t1 = max([t0 + span["dur"]] + [e["ts"] + e["dur"] for e in kernels])
    busy, end = 0.0, t0
    for e in sorted(kernels, key=lambda e: e["ts"]):
        s, f = max(e["ts"], end), e["ts"] + e["dur"]
        if f > s:
            busy += f - s
            end = f
    by_name = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    products = sum(v for k, v in by_name.items() if any(s in k.lower() for s in PRODUCT_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(wall_ms=(t1 - t0) / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1 - busy / (t1 - t0), launches=len(kernels),
                products_ms=products / 1e3,
                other_kernels_ms=(sum(by_name.values()) - products) / 1e3,
                top_kernels_ms=[(k[:90], v / 1e3) for k, v in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--doc-len", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", type=pathlib.Path, default=None,
                    help="keep the batch's chrome trace in this file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("embed_trace: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile, record_function

    dev = torch.device("cuda")
    cfg = get_arch(args.arch).config
    model = get_model(cfg)
    engine = ServeEngine(model, model.init(torch.Generator(device=dev).manual_seed(args.seed)))
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    docs = torch.randint(0, cfg.vocab, (EMBED_BATCH, args.doc_len), generator=g, device=dev)
    engine.embed(docs)                                       # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or pathlib.Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("embed_batch"):
                engine.embed(docs)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=smi, arch=args.arch, dtype=str(cfg.dtype), batch=EMBED_BATCH,
                          doc_len=args.doc_len, trace=str(args.trace) if args.trace else None,
                          **trace_split(trace, "embed_batch"))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
